"""The port's workflow-DAG slice on the CPU, against the JAX package:
``chained_lindley``, the batched pipeline sweep, ``plan_pipeline`` /
``validate_pipeline``, the ``DagSimulator`` diurnal run, the plan carried
across by ``convert.py``, and ``repro_torch.dag_run``.

The JAX package's own engine functions run here under
``jax.enable_x64(True)``: ``_jax_pipeline_grid`` with the sequential scan
is the device engine's counterpart.  An event-heap oracle written from the
queueing definition alone keeps the two production engines from
certifying each other.  Draws are continuous, so exact arrival ties occur
with probability zero.
"""

import ast
import heapq
import random
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from proptest import given, settings, st

from benchmarks.dag_bench import SWEEP_CFG, SWEEP_STAGES
from benchmarks.dag_bench import build_pipeline as jax_build_pipeline
from repro.core.elastico import ElasticoController as JaxElastico
from repro.serving import dag as jax_dag
from repro.serving import fastsim as jax_fastsim
from repro_torch import dag_run
from repro_torch.convert import pipeline_plan_from_numpy, plan_to_numpy
from repro_torch.serving import dag
from repro_torch.serving import fastsim

ROOT = Path(__file__).resolve().parents[1]

# the port's dag.py replaces these; every other top-level class and
# function is the reference's text
REPLACED = {"sweep_pipeline", "_chain_dag", "_sweep_pipeline_torch",
            "_pipeline_traces", "_pipeline_draws"}
DROPPED = {"_sweep_pipeline_jax"}      # the JAX engine, replaced by torch's


def top_level(path):
    text = path.read_text()
    tree = ast.parse(text)
    out = {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            out[node.name] = ast.get_source_segment(text, node)
        elif isinstance(node, ast.Assign):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = ast.get_source_segment(text, node)
    return out


def test_dag_module_keeps_the_reference_text():
    ref = top_level(ROOT / "src" / "repro" / "serving" / "dag.py")
    port = top_level(ROOT / "src" / "repro_torch" / "serving" / "dag.py")
    assert set(port) - REPLACED == set(ref) - REPLACED - DROPPED
    for name in sorted(set(port) - REPLACED):
        assert port[name] == ref[name], f"{name} drifted from the reference"


# --------------------------------------------------------------------------
# the from-scratch event-heap oracle
# --------------------------------------------------------------------------


def heap_stage(arrivals, services, c):
    """One FIFO stage of ``c`` servers: dispatch in arrival order (stable
    by request index), each request on the earliest-free server;
    ``services`` in dispatch order.  Completions in request order."""
    order = np.argsort(arrivals, kind="stable")
    free = [0.0] * c
    comp = np.empty(len(arrivals))
    for s, i in zip(services, order):
        t = heapq.heappop(free)
        comp[i] = max(arrivals[i], t) + s
        heapq.heappush(free, comp[i])
    return comp


def heap_tandem(A, stage_services, servers):
    cur, out = np.asarray(A, dtype=float), []
    for S, c in zip(stage_services, servers):
        cur = heap_stage(cur, S, c)
        out.append(cur)
    return np.stack(out)


def draw_chain(seed, *, n_stages, max_c):
    gen = np.random.Generator(np.random.PCG64(seed))
    n = int(gen.poisson(40.0)) + 5
    A = gen.uniform(0.0, 10.0, size=n)          # any order
    servers = [int(gen.integers(1, max_c + 1)) for _ in range(n_stages)]
    services = [gen.lognormal(mean=np.log(0.05), sigma=0.6, size=n)
                for _ in range(n_stages)]
    return A, services, servers


@given(st.integers(1, 5), st.integers(1, 3), st.integers(0, 10**6))
@settings(max_examples=15, deadline=None)
def test_chained_lindley_bit_equal_to_numpy_and_close_to_the_oracle(
        n_stages, max_c, seed):
    A, services, servers = draw_chain(seed, n_stages=n_stages, max_c=max_c)
    ref = jax_fastsim.chained_lindley(A, services, num_servers=servers,
                                      backend="numpy")
    got = fastsim.chained_lindley(A, services, num_servers=servers,
                                  device="cpu")
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(
        fastsim.chained_lindley(A, services, num_servers=servers,
                                backend="numpy"), ref)
    np.testing.assert_allclose(got, heap_tandem(A, services, servers),
                               rtol=1e-9, atol=1e-12)


def test_chained_lindley_long_all_c1_chain():
    A, services, _ = draw_chain(7, n_stages=18, max_c=1)
    ref = jax_fastsim.chained_lindley(A, services, backend="numpy")
    np.testing.assert_array_equal(
        fastsim.chained_lindley(A, services, device="cpu"), ref)


# --------------------------------------------------------------------------
# the pipeline sweep
# --------------------------------------------------------------------------


def random_stage(mod, rng, name, *, max_c=3):
    m = rng.uniform(0.02, 0.12)
    return mod.StageSpec(name=name, mean_s=(m,),
                         p95_s=(m * rng.uniform(1.3, 2.0),),
                         num_servers=rng.randint(1, max_c))


def random_dag(mod, kind, width, topo_seed):
    rng = random.Random(topo_seed)
    if kind == 0:
        return mod.WorkflowDAG.tandem(
            [random_stage(mod, rng, f"s{j}") for j in range(width + 1)])
    branches = [random_stage(mod, rng, f"b{j}") for j in range(max(2, width))]
    join = random_stage(mod, rng, "join")
    tail = [random_stage(mod, rng, "tail")] if rng.random() < 0.5 else []
    return mod.WorkflowDAG.fork_join(branches, join, tail=tail)


@given(st.integers(0, 1), st.integers(1, 3), st.integers(0, 10**6),
       st.floats(3.0, 8.0))
@settings(max_examples=10, deadline=None)
def test_sweep_pipeline_equals_the_reference_numpy_loop(kind, width,
                                                        topo_seed, rate):
    kw = dict(arrival_rates_qps=(rate, rate * 1.6), duration_s=15.0,
              replications=2, slo_s=0.8, seed=topo_seed % 1000)
    ref_dag = random_dag(jax_dag, kind, width, topo_seed)
    port_dag = random_dag(dag, kind, width, topo_seed)
    ref = jax_dag.sweep_pipeline(ref_dag, [(0,) * ref_dag.num_stages],
                                 backend="numpy", **kw)
    got = dag.sweep_pipeline(port_dag, [(0,) * port_dag.num_stages],
                             device="cpu", **kw)
    host = dag.sweep_pipeline(port_dag, [(0,) * port_dag.num_stages],
                              backend="numpy", **kw)
    assert got == host
    assert got.num_requests == ref.num_requests > 0
    for field in ("mean_latency_s", "p95_latency_s", "slo_compliance",
                  "predicted_sojourn_s"):
        assert getattr(got, field) == getattr(ref, field), field


@pytest.mark.parametrize("kind,width,topo_seed", [
    (0, 2, 3), (0, 3, 8), (1, 2, 4), (1, 3, 21), (1, 2, 77)])
def test_pipeline_grid_sink_equals_jax_pipeline_grid(kind, width, topo_seed):
    port_dag = random_dag(dag, kind, width, topo_seed)
    topo = port_dag.topological_order()
    rungs = [(0,) * port_dag.num_stages]
    rates = [4.0, 6.5]
    traces = dag._pipeline_traces(rates, 20.0, 2, topo_seed)
    A, S, counts = dag._pipeline_draws(port_dag, topo, rungs, rates, traces,
                                       seed=topo_seed)
    meta = dag._pipeline_topo_meta(port_dag, topo)
    assert meta == jax_dag._pipeline_topo_meta(
        random_dag(jax_dag, kind, width, topo_seed), topo)
    S_nb = np.ascontiguousarray(S.transpose(0, 2, 1))
    with jax.enable_x64(True):
        ref = jax_fastsim._jax_pipeline_grid(A, S_nb, meta, "sequential")
    got = fastsim._pipeline_grid(
        torch.from_numpy(np.ascontiguousarray(A.T)), torch.from_numpy(S_nb),
        torch.from_numpy(counts), meta)
    for j in range(len(topo)):
        np.testing.assert_array_equal(got[j].t().numpy(), ref[j])


# --------------------------------------------------------------------------
# the planner and the dag_bench pipeline
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pipeline():
    sur, planner, jdag, table = jax_build_pipeline()
    return planner, jax_dag.PipelinePlan(dag=jdag, table=table)


@pytest.fixture(scope="module")
def port_pipeline():
    return dag_run.build_pipeline()


def ladder_rows(table):
    return [(p.index, p.stage_indices, p.mean_latency_s, p.p95_latency_s,
             p.accuracy, p.queuing_slack_s, p.upscale_threshold,
             p.downscale_threshold, p.bottleneck_stage, p.stage_weights)
            for p in table.policies]


def test_plan_pipeline_thresholds_equal(jax_pipeline, port_pipeline):
    (_, ref), (_, port) = jax_pipeline, port_pipeline
    assert port.table.ladder_size == 7
    assert ladder_rows(port.table) == ladder_rows(ref.table)
    assert port.describe() == ref.describe()
    assert plan_to_numpy(port) == plan_to_numpy(ref)


def test_fork_join_plan_pipeline_thresholds_equal(jax_pipeline,
                                                  port_pipeline):
    (jplanner, ref), (planner, port) = jax_pipeline, port_pipeline
    rungs = [(r,) * 4 for r in range(7)]
    fj = dag_run.fork_join_dag(port.dag)
    ret = ref.dag.stages[0]
    jfj = jax_dag.WorkflowDAG.fork_join(
        [jax_dag.StageSpec("ret_a", ret.mean_s, ret.p95_s),
         jax_dag.StageSpec("ret_b", ret.mean_s, ret.p95_s)],
        ref.dag.stages[1], tail=[ref.dag.stages[2]])
    got = planner.plan_pipeline(fj, slo_p95_s=dag_run.SLO_S, rungs=rungs)
    want = jplanner.plan_pipeline(jfj, slo_p95_s=dag_run.SLO_S, rungs=rungs)
    assert got.table.ladder_size == 7
    assert ladder_rows(got.table) == ladder_rows(want.table)


@pytest.mark.parametrize("which", ["tandem", "fork_join"])
def test_validate_pipeline_grids_equal(jax_pipeline, port_pipeline, which):
    (jplanner, ref), (planner, port) = jax_pipeline, port_pipeline
    if which == "fork_join":
        rungs = [(r,) * 4 for r in range(7)]
        port = planner.plan_pipeline(dag_run.fork_join_dag(port.dag),
                                     slo_p95_s=dag_run.SLO_S, rungs=rungs)
        ref = jplanner.plan_pipeline(
            jax_dag.WorkflowDAG.fork_join(
                [jax_dag.StageSpec("ret_a", ref.dag.stages[0].mean_s,
                                   ref.dag.stages[0].p95_s),
                 jax_dag.StageSpec("ret_b", ref.dag.stages[0].mean_s,
                                   ref.dag.stages[0].p95_s)],
                ref.dag.stages[1], tail=[ref.dag.stages[2]]),
            slo_p95_s=dag_run.SLO_S, rungs=rungs)
    kw = dict(load_fractions=dag_run.LOAD_FRACTIONS, duration_s=40.0,
              replications=2, seed=0)
    want = jplanner.validate_pipeline(ref, backend="numpy", **kw)
    got = planner.validate_pipeline(port, device="cpu", **kw)
    assert got.num_requests == want.num_requests > 5000
    assert got == planner.validate_pipeline(port, backend="numpy", **kw)
    for field in ("arrival_rates_qps", "mean_latency_s", "p95_latency_s",
                  "slo_compliance", "predicted_sojourn_s"):
        assert getattr(got, field) == getattr(want, field), field


def test_agentic_sweep_constants_match_dag_bench():
    assert dag_run.SWEEP_STAGES == SWEEP_STAGES
    assert (dag_run.SWEEP_RATES, dag_run.SWEEP_SLO_S, dag_run.SWEEP_SEED) \
        == (SWEEP_CFG["arrival_rates_qps"], SWEEP_CFG["slo_s"],
            SWEEP_CFG["seed"])
    assert (dag_run.FULL.sweep_duration_s, dag_run.FULL.sweep_replications) \
        == (SWEEP_CFG["duration_s"], SWEEP_CFG["replications"])


def test_agentic_sweep_at_reduced_depth_equals_the_reference():
    cell = dag_run.SweepCell(
        dag=dag_run.agentic_dag(),
        rungs=tuple((0, 0, 0, 0, 0, k, k, 0) for k in range(5)),
        arrival_rates_qps=dag_run.SWEEP_RATES, duration_s=8.0,
        replications=1, slo_s=dag_run.SWEEP_SLO_S, seed=dag_run.SWEEP_SEED)
    jdag = jax_dag.WorkflowDAG.tandem([
        jax_dag.StageSpec(name=n, mean_s=tuple(m), p95_s=tuple(p),
                          num_servers=c) for n, c, m, p in SWEEP_STAGES])
    want = jax_dag.sweep_pipeline(
        jdag, cell.rungs, arrival_rates_qps=cell.arrival_rates_qps,
        duration_s=8.0, replications=1, slo_s=cell.slo_s, seed=cell.seed,
        backend="numpy")
    got = dag_run.sweep_cell(cell, device="cpu")
    assert got.num_requests == want.num_requests
    for field in ("mean_latency_s", "p95_latency_s", "slo_compliance"):
        assert getattr(got, field) == getattr(want, field), field


# --------------------------------------------------------------------------
# Elastico on the DAG simulator
# --------------------------------------------------------------------------


def jax_diurnal(plan, periods):
    """dag_bench's part 2 on the JAX package."""
    from benchmarks.dag_bench import AMPLITUDE, PERIOD_S, _capacity
    from repro.serving.workload import diurnal_pattern, generate_arrivals

    table = plan.table
    peak = min(1.35 * _capacity(plan.dag, table.policies[-1]),
               0.85 * _capacity(plan.dag, table.policies[0]))
    base = peak / (1.0 + AMPLITUDE)
    duration = periods * PERIOD_S
    arrivals = generate_arrivals(
        diurnal_pattern(base, period_s=PERIOD_S, amplitude=AMPLITUDE),
        duration, seed=21)
    out = {}
    for name, ctrl, rung in [("dynamic", JaxElastico(table), 0),
                             ("static_fast", None, 0),
                             ("static_accurate", None,
                              table.ladder_size - 1)]:
        res = jax_dag.DagSimulator(
            plan.dag, controller=ctrl, static_rung=rung,
            rungs=[p.stage_indices for p in table.policies],
            seed=17).run(arrivals, duration)
        out[name] = (res.slo_compliance(dag_run.SLO_S),
                     res.mean_pipeline_accuracy(), res.p95_latency(),
                     [(e.time_s, e.from_index, e.to_index)
                      for e in res.switch_events])
    return out


def port_rows(runs):
    return {name: (m["slo_compliance"], m["mean_accuracy"],
                   m["p95_latency_s"], m["switches"])
            for name, m in runs.items() if isinstance(m, dict)}


@pytest.fixture(scope="module")
def jax_diurnal_rows(jax_pipeline):
    return jax_diurnal(jax_pipeline[1], 1)


def test_diurnal_run_equals_the_jax_package(port_pipeline, jax_diurnal_rows):
    got = port_rows(dag_run.diurnal_runs(port_pipeline[1], 1))
    want = {k: (*v[:3], len(v[3])) for k, v in jax_diurnal_rows.items()}
    assert got == want
    assert got["dynamic"][3] > 0
    assert got["dynamic"][0] > got["static_accurate"][0]
    assert got["dynamic"][1] > got["static_fast"][1]


def test_carried_jax_plan_drives_the_port_dag_simulator(jax_pipeline,
                                                        jax_diurnal_rows):
    port_plan = pipeline_plan_from_numpy(plan_to_numpy(jax_pipeline[1]))
    assert isinstance(port_plan, dag.PipelinePlan)
    assert isinstance(port_plan.dag, dag.WorkflowDAG)
    assert port_plan.describe() == jax_pipeline[1].describe()
    got = port_rows(dag_run.diurnal_runs(port_plan, 1))
    assert got == {k: (*v[:3], len(v[3]))
                   for k, v in jax_diurnal_rows.items()}


def test_pipeline_plan_from_numpy_rejects_a_deployment_plan():
    from repro_torch.quickstart import make_profiler, search
    from repro_torch.core.planner import Planner
    from repro_torch.workflows.surrogate import RagSurrogate

    sur = RagSurrogate(seed=0)
    plan = Planner(profiler=make_profiler(sur)).plan(
        search(sur).feasible, slo_p95_s=1.0)
    with pytest.raises(TypeError, match="not a PipelinePlan"):
        pipeline_plan_from_numpy(plan_to_numpy(plan))


# --------------------------------------------------------------------------
# dag_run and the default device
# --------------------------------------------------------------------------


def test_dag_run_smoke_on_the_cpu(capsys):
    assert dag_run.main(["--device", "cpu", "--smoke"]) == 0
    text = capsys.readouterr().out
    for name in ("rag_tandem", "fork_join", "agentic_8stage", "dynamic",
                 "fork-join sim"):
        assert name in text


def no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks hosts without one")


def test_default_device_without_a_card_raises(port_pipeline):
    no_card()
    planner, plan = port_pipeline
    A, services, servers = draw_chain(1, n_stages=2, max_c=2)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fastsim.chained_lindley(A, services, num_servers=servers)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dag.sweep_pipeline(plan.dag, [(0, 0, 0)], arrival_rates_qps=[2.0])
    with pytest.raises(RuntimeError, match="no CUDA card"):
        planner.validate_pipeline(plan)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dag_run.run()
    with pytest.raises(RuntimeError, match="no CUDA card"):
        dag_run.main([])


def test_unknown_backend_is_refused(port_pipeline):
    plan = port_pipeline[1]
    with pytest.raises(ValueError, match="unknown backend"):
        dag.sweep_pipeline(plan.dag, [(0, 0, 0)], arrival_rates_qps=[2.0],
                           backend="auto")
    with pytest.raises(ValueError, match="unknown backend"):
        fastsim.chained_lindley([0.0, 1.0], [[0.1, 0.1]], backend="jax")
