"""Workflow-DAG serving on the port: the RAG pipeline as a compound network.

    PYTHONPATH=src python -m repro_torch.dag_run [--device cpu] [--smoke]

The counterpart of ``benchmarks/dag_bench.py``'s run (its parts 1-3 and
its pipeline-sweep cell), with every pipeline sweep on the device:

1. **rag_tandem**: COMPASS-V and ``Planner.plan`` on the RAG surrogate; each
   admitted rung is split into retrieve -> rerank -> generate stage ladders
   and ``Planner.plan_pipeline`` derives the pipeline ladder;
   ``Planner.validate_pipeline`` replays every rung against a load grid
   (chained Lindley kernel, one launch for the three c = 1 stages).
2. **diurnal**: the pipeline-level Elastico controller against the two
   static rungs on a diurnal trace, in the event-heap ``DagSimulator``.
3. **fork_join**: two retrieve branches joining at rerank, then generate:
   the ``DagSimulator`` run of dag_bench's part 3, then ``plan_pipeline``
   and ``validate_pipeline`` over the rungs ``(r, r, r, r)`` (chained
   Lindley launches for the branches and the fused tail, a device join).
4. **agentic_8stage**: dag_bench's 8-stage agentic pipeline, every stage
   pooled, swept over its rungs and loads (one Kiefer-Wolfowitz completion
   launch per stage).

``--device cpu`` runs the kernels' plain versions; without it the sweeps
run on the CUDA card and raise when there is none.  ``--smoke`` cuts the
depth (diurnal periods, replications, durations); the widths stay.
"""

from __future__ import annotations

import argparse
import math
import random
import time
import zlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

from .core.compass_v import CompassV
from .core.elastico import ElasticoController
from .core.planner import Planner
from .device import resolve_device
from .kernels.chained_lindley import chained_lindley_scan
from .kernels.lindley_scan import kw_chain
from .serving.dag import (
    DagSimulator,
    PipelinePlan,
    PipelineSweep,
    StageSpec,
    WorkflowDAG,
    fork_join_sojourn,
    pipeline_sojourn,
    sweep_pipeline,
)
from .serving.workload import diurnal_pattern, generate_arrivals
from .workflows.surrogate import RagSurrogate

TAU = 0.75          # relative-accuracy floor (table1/fig7 setting)
SLO_S = 1.0         # 1000 ms end-to-end p95, the paper's serving SLO
PERIOD_S = 300.0    # compressed diurnal cycle for the event-heap runs
AMPLITUDE = 0.8
RAG_BUDGET = (10, 25, 50, 100)
LOAD_FRACTIONS = (0.4, 0.6, 0.75)
_Z95 = 1.6448536269514722

STAGE_ORDER = ("retrieve", "rerank", "generate")

# the 8-stage agentic-RAG tandem of dag_bench's pipeline-sweep cell: name,
# pool size, mean ladder, p95 ladder; rungs pin the generate/verify configs
SWEEP_STAGES = [
    ("plan",      2, [0.010], [0.025]),
    ("retrieve1", 8, [0.120], [0.300]),
    ("rerank1",   4, [0.060], [0.150]),
    ("retrieve2", 8, [0.120], [0.300]),
    ("rerank2",   4, [0.060], [0.150]),
    ("generate",  2, [0.035, 0.028, 0.022, 0.017, 0.013],
                     [0.090, 0.070, 0.055, 0.042, 0.032]),
    ("verify",    2, [0.024, 0.020, 0.018, 0.016, 0.014],
                     [0.070, 0.056, 0.048, 0.042, 0.036]),
    ("moderate",  2, [0.010], [0.030]),
]
SWEEP_RATES = (10.0, 14.0, 18.0, 22.0, 26.0, 30.0, 35.0, 40.0)
SWEEP_SLO_S = 1.5
SWEEP_SEED = 11


@dataclass(frozen=True)
class Size:
    """Depth of a run; every width (stages, rungs, loads) stays full."""

    periods: int                 # diurnal cycles of PERIOD_S
    replications: int            # validation replications
    validate_duration_s: float   # validation trace length
    sweep_duration_s: float      # agentic sweep trace length
    sweep_replications: int


FULL = Size(periods=12, replications=4, validate_duration_s=300.0,
            sweep_duration_s=150.0, sweep_replications=4)
SMOKE = Size(periods=1, replications=2, validate_duration_s=60.0,
             sweep_duration_s=10.0, sweep_replications=1)


@dataclass(frozen=True)
class SweepCell:
    """One pipeline sweep: what :func:`sweep_cell` replays."""

    dag: WorkflowDAG
    rungs: Tuple[Tuple[int, ...], ...]
    arrival_rates_qps: Tuple[float, ...]
    duration_s: float
    replications: int
    slo_s: float
    seed: int


@dataclass
class DagRun:
    """What one run produced, with the host seconds of each phase and the
    kernel launches of each sweep."""

    device: str
    plan: PipelinePlan
    fork_join_plan: PipelinePlan
    cells: Dict[str, SweepCell]
    sweeps: Dict[str, PipelineSweep]
    diurnal: Dict[str, dict]
    fork_join: dict
    seconds: Dict[str, float] = field(default_factory=dict)
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)


KERNELS = (chained_lindley_scan, kw_chain)


def _launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def _stable_seed(config) -> int:
    return zlib.crc32(repr(config).encode()) & 0xFFFF


def make_profiler(surrogate):
    """The benchmarks' profiler: Gaussian service at the surrogate's mean
    and its own latency cv, seeded by the config."""
    def profiler(config, n):
        rng = random.Random(_stable_seed(config))
        m = surrogate.mean_latency_s(config)
        cv = surrogate.latency_cv(config)
        return [max(1e-4, rng.gauss(m, m * cv)) for _ in range(n)]

    return profiler


def _p95_from_cv(mean: float, cv: float) -> float:
    """p95 of the lognormal with the given mean and coefficient of
    variation — the tail model the surrogate profiler samples from."""
    sigma = math.sqrt(math.log(1.0 + cv * cv))
    return mean * math.exp(_Z95 * sigma - sigma * sigma / 2.0)


def build_pipeline() -> Tuple[Planner, PipelinePlan]:
    """The RAG plan's admitted ladder, decomposed into its 3 stages.

    The single-stage planner picks the rungs; each rung's config is split
    into per-stage means by the surrogate, so pipeline rung r is plan rung
    r.  Rung accuracy rides on the generate stage."""
    sur = RagSurrogate()
    res = CompassV(space=sur.space, evaluator=sur, tau=TAU,
                   budget_schedule=RAG_BUDGET, seed=0).run()
    planner = Planner(profiler=make_profiler(sur))
    plan = planner.plan(res.feasible, slo_p95_s=SLO_S)
    cv = sur.latency_cv(plan.table.policies[0].point.config)
    stage_means: Dict[str, List[float]] = {name: [] for name in STAGE_ORDER}
    accs = []
    for pol in plan.table.policies:
        parts = sur.stage_latencies_s(pol.point.config)
        for name in STAGE_ORDER:
            stage_means[name].append(parts[name])
        accs.append(pol.point.accuracy)
    stages = [
        StageSpec(
            name=name,
            mean_s=tuple(stage_means[name]),
            p95_s=tuple(_p95_from_cv(m, cv) for m in stage_means[name]),
            accuracy=(tuple(accs) if name == "generate"
                      else (1.0,) * len(accs)),
        )
        for name in STAGE_ORDER
    ]
    dag = WorkflowDAG.tandem(stages)
    rungs = [(r,) * len(STAGE_ORDER) for r in range(len(accs))]
    return planner, planner.plan_pipeline(dag, slo_p95_s=SLO_S, rungs=rungs)


def fork_join_dag(dag: WorkflowDAG) -> WorkflowDAG:
    """Two copies of the tandem's retrieve stage joining at its rerank,
    followed by its generate stage."""
    ret = dag.stages[0]
    return WorkflowDAG.fork_join(
        [StageSpec("ret_a", ret.mean_s, ret.p95_s),
         StageSpec("ret_b", ret.mean_s, ret.p95_s)],
        dag.stages[1], tail=[dag.stages[2]])


def agentic_dag() -> WorkflowDAG:
    return WorkflowDAG.tandem([
        StageSpec(name=n, mean_s=tuple(m), p95_s=tuple(p), num_servers=c)
        for n, c, m, p in SWEEP_STAGES])


def sweep_cell(cell: SweepCell, *, backend: str = "torch",
               device=None) -> PipelineSweep:
    """Replay one sweep cell on either engine."""
    return sweep_pipeline(
        cell.dag, cell.rungs, arrival_rates_qps=cell.arrival_rates_qps,
        duration_s=cell.duration_s, replications=cell.replications,
        slo_s=cell.slo_s, seed=cell.seed, backend=backend, device=device)


def _validation_cell(plan: PipelinePlan, sweep: PipelineSweep) -> SweepCell:
    return SweepCell(
        dag=plan.dag,
        rungs=tuple(pol.stage_indices for pol in plan.table.policies),
        arrival_rates_qps=sweep.arrival_rates_qps,
        duration_s=sweep.duration_s, replications=sweep.replications,
        slo_s=plan.table.slo_p95_s, seed=0)


def _capacity(dag: WorkflowDAG, pol) -> float:
    """Bottleneck drain rate c_b / s_b of one pipeline rung."""
    b = pol.bottleneck_stage
    return (dag.stages[b].num_servers
            / dag.stages[b].mean_s[pol.stage_indices[b]])


def _serve_metrics(result) -> dict:
    return {
        "completed": result.num_completed,
        "slo_compliance": result.slo_compliance(SLO_S),
        "mean_accuracy": result.mean_pipeline_accuracy(),
        "p95_latency_s": result.p95_latency(),
        "mean_wait_s": result.mean_wait(),
        "switches": len(result.switch_events),
    }


def diurnal_runs(plan: PipelinePlan, periods: int) -> Dict[str, dict]:
    """Pipeline-level Elastico against the fastest and the most accurate
    static rung on one diurnal trace, in the event-heap ``DagSimulator``."""
    dag, table = plan.dag, plan.table
    cap_fast = _capacity(dag, table.policies[0])
    cap_slow = _capacity(dag, table.policies[-1])
    peak = min(1.35 * cap_slow, 0.85 * cap_fast)
    base = peak / (1.0 + AMPLITUDE)
    duration = periods * PERIOD_S
    pattern = diurnal_pattern(base, period_s=PERIOD_S, amplitude=AMPLITUDE)
    arrivals = generate_arrivals(pattern, duration, seed=21)

    def serve(controller, static_rung=0):
        sim = DagSimulator(
            dag, controller=controller, static_rung=static_rung,
            rungs=[pol.stage_indices for pol in table.policies], seed=17)
        return _serve_metrics(sim.run(arrivals, duration))

    return {
        "dynamic": serve(ElasticoController(table)),
        "static_fast": serve(None, static_rung=0),
        "static_accurate": serve(None, static_rung=table.ladder_size - 1),
        "requests": len(arrivals),
        "base_qps": base,
        "peak_qps": peak,
    }


def fork_join_run(plan: PipelinePlan, fj: WorkflowDAG,
                  periods: int) -> dict:
    """dag_bench's fork-join synchronization run: half the fastest rung's
    capacity for half the diurnal duration, against the network model."""
    dag, table = plan.dag, plan.table
    cap_fast = _capacity(dag, table.policies[0])
    fj_cfg = tuple(table.policies[0].stage_indices[j] for j in (0, 0, 1, 2))
    rate = 0.5 * cap_fast
    duration = periods * PERIOD_S / 2.0
    arrivals = generate_arrivals(lambda _t: rate, duration, seed=23)
    res = DagSimulator(fj, static_stage_indices=fj_cfg, seed=29).run(
        arrivals, duration)
    sim_mean = (sum(r.latency_s for r in res.completed)
                / max(len(res.completed), 1))
    branch = dag.stages[0].mean_s[fj_cfg[0]]
    return {
        "rate_qps": rate,
        "requests": len(res.completed),
        "sim_mean_sojourn_s": sim_mean,
        "model_mean_sojourn_s": pipeline_sojourn(fj, fj_cfg, rate),
        "sync_penalty": fork_join_sojourn([branch, branch]) / branch,
    }


def run(*, device=None, size: Size = FULL) -> DagRun:
    """All four phases; the sweeps run on ``device`` (None is the CUDA
    card, and raises without one)."""
    dev = resolve_device(device)
    seconds: Dict[str, float] = {}
    launches: Dict[str, Dict[str, int]] = {}
    cells: Dict[str, SweepCell] = {}
    sweeps: Dict[str, PipelineSweep] = {}
    before: Dict[str, int] = {}

    def start():
        before.update(_launch_counts())
        return time.perf_counter()

    def stop(name, t):
        seconds[name] = time.perf_counter() - t
        launches[name] = {k: v - before[k]
                          for k, v in _launch_counts().items()}

    t = time.perf_counter()
    planner, plan = build_pipeline()
    seconds["search_plan"] = time.perf_counter() - t

    t = start()
    val = planner.validate_pipeline(
        plan, load_fractions=LOAD_FRACTIONS,
        duration_s=size.validate_duration_s,
        replications=size.replications, seed=0, device=dev)
    stop("rag_tandem", t)
    cells["rag_tandem"], sweeps["rag_tandem"] = _validation_cell(plan, val), val

    t = time.perf_counter()
    diurnal = diurnal_runs(plan, size.periods)
    seconds["diurnal"] = time.perf_counter() - t

    fj = fork_join_dag(plan.dag)
    t = time.perf_counter()
    fork_join = fork_join_run(plan, fj, size.periods)
    seconds["fork_join_sim"] = time.perf_counter() - t
    t = start()
    fj_plan = planner.plan_pipeline(
        fj, slo_p95_s=SLO_S,
        rungs=[(r,) * fj.num_stages for r in range(plan.table.ladder_size)])
    fj_val = planner.validate_pipeline(
        fj_plan, load_fractions=LOAD_FRACTIONS,
        duration_s=size.validate_duration_s,
        replications=size.replications, seed=0, device=dev)
    stop("fork_join", t)
    cells["fork_join"], sweeps["fork_join"] = (
        _validation_cell(fj_plan, fj_val), fj_val)

    cell = SweepCell(
        dag=agentic_dag(),
        rungs=tuple((0, 0, 0, 0, 0, k, k, 0) for k in range(5)),
        arrival_rates_qps=SWEEP_RATES, duration_s=size.sweep_duration_s,
        replications=size.sweep_replications, slo_s=SWEEP_SLO_S,
        seed=SWEEP_SEED)
    t = start()
    sweeps["agentic_8stage"] = sweep_cell(cell, device=dev)
    stop("agentic_8stage", t)
    cells["agentic_8stage"] = cell

    return DagRun(device=str(dev), plan=plan, fork_join_plan=fj_plan,
                  cells=cells, sweeps=sweeps, diurnal=diurnal,
                  fork_join=fork_join, seconds=seconds, launches=launches)


def report(out: DagRun) -> str:
    lines = [out.plan.describe(), ""]
    for name, sw in out.sweeps.items():
        comp = [min(row) for row in sw.slo_compliance]
        lines.append(
            f"{name:15s} {len(sw.mean_latency_s)} rungs x "
            f"{len(sw.arrival_rates_qps)} loads x {sw.replications} reps, "
            f"{sw.num_requests} requests, model err "
            f"{sw.sojourn_model_error():.3f}, worst compliance per rung "
            f"{['%.3f' % c for c in comp]}, {out.seconds[name]:.2f} s, "
            f"launches {out.launches[name]}")
    d = out.diurnal
    lines.append(f"diurnal: {d['requests']} requests, base "
                 f"{d['base_qps']:.2f} qps, peak {d['peak_qps']:.2f} qps")
    for name in ("dynamic", "static_fast", "static_accurate"):
        m = d[name]
        lines.append(f"  {name:16s} compliance {m['slo_compliance']:.5f} "
                     f"accuracy {m['mean_accuracy']:.5f} p95 "
                     f"{m['p95_latency_s'] * 1e3:.0f} ms switches "
                     f"{m['switches']}")
    f = out.fork_join
    lines.append(f"fork-join sim: {f['requests']} requests at "
                 f"{f['rate_qps']:.2f} qps, sojourn "
                 f"{f['sim_mean_sojourn_s'] * 1e3:.1f} ms (model "
                 f"{f['model_mean_sojourn_s'] * 1e3:.1f} ms), sync penalty "
                 f"{f['sync_penalty']:.2f}x")
    lines.append(f"device {out.device}; phase seconds "
                 + ", ".join(f"{k} {v:.2f}" for k, v in out.seconds.items()))
    return "\n".join(lines)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device for the sweeps (default: the CUDA "
                         "card; 'cpu' runs the kernels' plain versions)")
    ap.add_argument("--smoke", action="store_true",
                    help="cut depth (periods, replications, durations)")
    args = ap.parse_args(argv)
    print(report(run(device=args.device, size=SMOKE if args.smoke
                     else FULL)))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
