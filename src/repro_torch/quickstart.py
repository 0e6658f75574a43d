"""Quickstart on the port: the complete Compass pipeline.

    PYTHONPATH=src python -m repro_torch.quickstart [--device cpu]

1. COMPASS-V searches the paper's RAG configuration space (360 configs) for
   everything meeting the accuracy threshold tau.
2. The Planner profiles the feasible set, builds the Pareto ladder and
   derives AQM switching thresholds for a P95 latency SLO, then validates
   every rung against a grid of loads in the batched sweep, whose
   recursion runs in the port's CUDA kernel (``--device cpu`` runs its
   plain version instead).
3. Elastico serves a 3-minute spike workload in the discrete-event server,
   switching configurations to hold the SLO, and is compared against the
   static baselines.

The counterpart of ``examples/quickstart.py``; it prints the same table.
"""

from __future__ import annotations

import argparse
import random
import statistics
import zlib
from dataclasses import dataclass
from typing import List, Optional

from .core.compass_v import CompassV, SearchResult
from .core.elastico import ElasticoController
from .core.planner import DeploymentPlan, PlanValidation, Planner
from .device import resolve_device
from .serving.simulator import ServingSimulator
from .serving.workload import generate_arrivals, spike_pattern
from .workflows.surrogate import RagSurrogate

TAU = 0.75          # minimum acceptable F1
SLO_S = 1.0         # P95 latency SLO (seconds)
SPIKE_S = 180.0     # length of the online-phase spike run (seconds)


@dataclass(frozen=True)
class VariantRow:
    """One line of the spike-run table."""

    name: str
    compliance: float
    accuracy: float
    p95_s: float
    switches: int


def search(surrogate: RagSurrogate) -> SearchResult:
    """Offline phase 1: COMPASS-V task optimization (paper §IV)."""
    return CompassV(
        space=surrogate.space,
        evaluator=surrogate,
        tau=TAU,
        budget_schedule=(10, 25, 50, 100),
        seed=0,
    ).run()


def make_profiler(surrogate: RagSurrogate):
    """The quickstart's deterministic latency profiler."""
    def profiler(config, n):
        rng = random.Random(zlib.crc32(repr(config).encode()) & 0xFFFF)
        m = surrogate.mean_latency_s(config)
        return [max(1e-4, rng.gauss(m, 0.25 * m)) for _ in range(n)]

    return profiler


def spike_arrivals() -> List[float]:
    """The 3-minute, 4x spike workload of the online phase."""
    return generate_arrivals(spike_pattern(1.5, factor=4.0), SPIKE_S, seed=1)


def spike_run(surrogate: RagSurrogate, plan: DeploymentPlan,
              arrivals: List[float]) -> List[VariantRow]:
    """Online phase: Elastico under a 4x load spike (paper §VI-C), against
    the static-fast and static-accurate baselines."""
    ladder = plan.table.policies

    def sampler(idx, rng):
        m = surrogate.mean_latency_s(ladder[idx].point.config)
        return max(1e-4, rng.gauss(m, 0.25 * m))

    rows = []
    for name, ctrl, static in [
        ("elastico", ElasticoController(plan.table), 0),
        ("static-fast", None, 0),
        ("static-accurate", None, len(ladder) - 1),
    ]:
        sim = ServingSimulator(sampler, controller=ctrl, static_index=static,
                               seed=2)
        out = sim.run(arrivals, SPIKE_S)
        acc = statistics.mean(ladder[r.config_index].point.accuracy
                              for r in out.completed)
        rows.append(VariantRow(name, out.slo_compliance(SLO_S), acc,
                               out.p95_latency(), len(out.switch_events)))
    return rows


@dataclass(frozen=True)
class QuickstartResult:
    surrogate: RagSurrogate
    search: SearchResult
    plan: DeploymentPlan
    validation: PlanValidation
    spike_requests: int
    rows: List[VariantRow]


def run(device=None) -> QuickstartResult:
    """Search, plan, validate on ``device`` (None is the CUDA card), and
    serve the spike run."""
    dev = resolve_device(device)
    surrogate = RagSurrogate(seed=0)
    result = search(surrogate)
    planner = Planner(profiler=make_profiler(surrogate))
    plan = planner.plan(result.feasible, slo_p95_s=SLO_S)
    validation = planner.validate(plan, device=dev)
    arrivals = spike_arrivals()
    return QuickstartResult(surrogate, result, plan, validation,
                            len(arrivals), spike_run(surrogate, plan, arrivals))


def main(argv: Optional[List[str]] = None) -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="cuda (the default) or cpu")
    args = parser.parse_args(argv)
    out = run(args.device)
    space = out.surrogate.space
    print(
        f"COMPASS-V: {len(out.search.feasible)} feasible configs "
        f"({out.search.num_evaluations}/{space.cardinality} evaluated, "
        f"{out.search.savings_vs_exhaustive(space, 100) * 100:.1f}"
        f"% sample savings)")
    print("\nDeployment plan:")
    print(out.plan.describe())
    print("\nPlan validation:")
    print(out.validation.describe())
    print(f"\nServing {out.spike_requests} requests (spike pattern, {SLO_S * 1e3:.0f}ms SLO):")
    print(f"{'variant':18s} {'compliance':>10s} {'accuracy':>9s} "
          f"{'p95 ms':>8s} {'switches':>8s}")
    for row in out.rows:
        print(f"{row.name:18s} {row.compliance * 100:9.1f}% "
              f"{row.accuracy:9.3f} {row.p95_s * 1e3:8.0f} "
              f"{row.switches:8d}")


if __name__ == "__main__":
    main()
