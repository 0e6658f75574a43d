"""The port's main path as a whole, on the CPU, against the JAX package:
COMPASS-V search -> Planner.plan -> Planner.validate -> Elastico in the
event-heap simulator, as in ``examples/quickstart.py``.  Also checks that
the port stands alone: nothing under ``src/repro_torch/`` and nothing in
``chip_smoke.py`` imports ``jax`` or ``repro``.
"""

import ast
import random
import statistics
import zlib
from pathlib import Path

import jax  # noqa: F401  (both frameworks in one process, as the port's tests run)
import numpy as np
import pytest
import torch

from repro.core.compass_v import CompassV as JaxCompassV
from repro.core.elastico import ElasticoController as JaxElastico
from repro.core.planner import Planner as JaxPlanner
from repro.serving.simulator import ServingSimulator as JaxSimulator
from repro.workflows.surrogate import RagSurrogate as JaxRagSurrogate
from repro_torch import quickstart
from repro_torch.convert import plan_from_numpy, plan_to_numpy
from repro_torch.core.elastico import ElasticoController
from repro_torch.core.planner import DeploymentPlan, Planner
from repro_torch.serving.simulator import ServingSimulator

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MEAN_RTOL = 1e-12

# modules the port keeps as verbatim copies of the JAX package's
COPIES = [
    "core/__init__.py", "core/space.py", "core/wilson.py",
    "core/gradient.py", "core/evaluate.py", "core/compass_v.py",
    "core/pareto.py", "core/aqm.py", "core/elastico.py",
    "workflows/surrogate.py", "serving/workload.py", "serving/faults.py",
    "serving/scheduler.py", "serving/simulator.py",
]


def jax_profiler(surrogate):
    def profiler(config, n):
        rng = random.Random(zlib.crc32(repr(config).encode()) & 0xFFFF)
        m = surrogate.mean_latency_s(config)
        return [max(1e-4, rng.gauss(m, 0.25 * m)) for _ in range(n)]

    return profiler


def jax_spike_run(surrogate, plan, arrivals, table=None):
    """examples/quickstart.py's online phase, on the JAX package."""
    ladder = plan.table.policies

    def sampler(idx, rng):
        m = surrogate.mean_latency_s(ladder[idx].point.config)
        return max(1e-4, rng.gauss(m, 0.25 * m))

    rows = []
    for name, ctrl, static in [
        ("elastico", JaxElastico(table or plan.table), 0),
        ("static-fast", None, 0),
        ("static-accurate", None, len(ladder) - 1),
    ]:
        out = JaxSimulator(sampler, controller=ctrl, static_index=static,
                           seed=2).run(arrivals, quickstart.SPIKE_S)
        acc = statistics.mean(ladder[r.config_index].point.accuracy
                              for r in out.completed)
        rows.append((name, out.slo_compliance(quickstart.SLO_S), acc,
                     out.p95_latency(), out.switch_events))
    return rows


@pytest.fixture(scope="module")
def jax_side():
    surrogate = JaxRagSurrogate(seed=0)
    search = JaxCompassV(space=surrogate.space, evaluator=surrogate,
                         tau=quickstart.TAU,
                         budget_schedule=(10, 25, 50, 100), seed=0).run()
    planner = JaxPlanner(profiler=jax_profiler(surrogate))
    plan = planner.plan(search.feasible, slo_p95_s=quickstart.SLO_S)
    validation = planner.validate(plan, backend="numpy")
    rows = jax_spike_run(surrogate, plan, quickstart.spike_arrivals())
    return surrogate, search, plan, validation, rows


@pytest.fixture(scope="module")
def port_side():
    return quickstart.run(device="cpu")


def policy_rows(table):
    return [(p.index, p.point.config, p.point.accuracy, p.point.profile.mean,
             p.point.profile.p95, p.queuing_slack, p.upscale_threshold,
             p.downscale_threshold) for p in table.policies]


def test_same_feasible_set(jax_side, port_side):
    search = jax_side[1]
    assert port_side.search.feasible == search.feasible
    assert port_side.search.num_evaluations == search.num_evaluations


def test_same_plan_thresholds(jax_side, port_side):
    plan = jax_side[2]
    assert len(plan.table.policies) == 7
    assert policy_rows(port_side.plan.table) == policy_rows(plan.table)
    assert port_side.plan.describe() == plan.describe()


def test_equal_validation_grids(jax_side, port_side):
    ref, port = jax_side[3], port_side.validation
    assert ref.num_requests == port.num_requests > 100_000
    assert len(port.slo_compliance) * len(port.arrival_rates_qps) \
        * port.replications == 168
    assert port.arrival_rates_qps == ref.arrival_rates_qps
    assert port.p95_latency_s == ref.p95_latency_s
    assert port.slo_compliance == ref.slo_compliance
    assert port.predicted_wait_s == ref.predicted_wait_s
    np.testing.assert_allclose(np.asarray(port.mean_wait_s),
                               np.asarray(ref.mean_wait_s),
                               rtol=MEAN_RTOL, atol=0)


def test_same_spike_run(jax_side, port_side):
    ref_rows = jax_side[4]
    assert [r.name for r in port_side.rows] == [r[0] for r in ref_rows]
    for row, (_, comp, acc, p95, switches) in zip(port_side.rows, ref_rows):
        assert (row.compliance, row.accuracy, row.p95_s, row.switches) \
            == (comp, acc, p95, len(switches))
    assert port_side.rows[0].switches > 0


def switch_log(events):
    return [(e.time_s, e.from_index, e.to_index, e.queue_depth, e.direction,
             e.reason) for e in events]


def test_converted_plan_drives_port_elastico_through_same_switches(jax_side):
    surrogate, _, plan, _, rows = jax_side
    data = plan_to_numpy(plan)
    port_plan = plan_from_numpy(data)
    assert isinstance(port_plan, DeploymentPlan)
    assert policy_rows(port_plan.table) == policy_rows(plan.table)
    assert port_plan.table.slo_p95_s == plan.table.slo_p95_s
    assert port_plan.table.num_servers == plan.table.num_servers
    ladder = port_plan.table.policies

    def sampler(idx, rng):
        m = surrogate.mean_latency_s(ladder[idx].point.config)
        return max(1e-4, rng.gauss(m, 0.25 * m))

    out = ServingSimulator(sampler, controller=ElasticoController(
        port_plan.table), seed=2).run(quickstart.spike_arrivals(),
                                      quickstart.SPIKE_S)
    assert switch_log(out.switch_events) == switch_log(rows[0][4])
    assert len(out.switch_events) > 0


def test_converted_c4_plan_keeps_degraded_and_mix_tables(jax_side):
    surrogate, search = jax_side[0], jax_side[1]
    plan = JaxPlanner(profiler=jax_profiler(surrogate), num_servers=4).plan(
        search.feasible, slo_p95_s=quickstart.SLO_S)
    assert plan.degraded_tables and plan.mix_table is not None
    port_plan = plan_from_numpy(plan_to_numpy(plan))
    assert sorted(port_plan.degraded_tables) == sorted(plan.degraded_tables)
    for c, table in plan.degraded_tables.items():
        assert policy_rows(port_plan.degraded_tables[c]) == policy_rows(table)
    assert [(m.assignment, m.upscale_threshold, m.downscale_threshold)
            for m in port_plan.mix_table.policies] == \
        [(m.assignment, m.upscale_threshold, m.downscale_threshold)
         for m in plan.mix_table.policies]
    assert port_plan.describe() == plan.describe()
    # the controller re-anchors on capacity loss with the carried tables
    ctrl = port_plan.controller()
    ref = plan.controller()
    assert ctrl.on_capacity_change(2, 8, 1.0) == ref.on_capacity_change(
        2, 8, 1.0)


def test_validate_on_the_default_device_without_a_card_raises(port_side):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks hosts without one")
    planner = Planner(profiler=quickstart.make_profiler(port_side.surrogate))
    with pytest.raises(RuntimeError, match="no CUDA card"):
        planner.validate(port_side.plan)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        quickstart.run()


def imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


PORT_FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(ROOT)) for p in PORT_FILES])
def test_port_imports_neither_jax_nor_repro(path):
    bad = [m for m in imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


@pytest.mark.parametrize("rel", COPIES)
def test_copied_modules_match_the_reference(rel):
    assert (PORT / rel).read_text() == \
        (ROOT / "src" / "repro" / rel).read_text()
