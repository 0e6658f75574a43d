"""Workflow DAGs: multi-stage compound pipelines as first-class scenarios.

The port of ``repro/serving/dag.py``.  The paper's subject is *compound*
AI workflows — retrieve -> rerank -> generate, detect -> verify — and this
module makes their stage structure explicit:

- :class:`StageSpec` / :class:`WorkflowDAG`: named stages with per-stage
  latency ladders, per-stage worker pools, tandem or fork-join topology.
- :func:`derive_pipeline_policies` / :class:`PipelinePlan`: the pipeline
  ladder, thresholds stated at each rung's bottleneck stage.
- :class:`DagSimulator`: the event-heap exact oracle for DAG serving, with
  the pipeline-level Elastico controller; :func:`simulate_dag`, its
  bit-identical chained fast path for static scenarios.
- :func:`sweep_pipeline`: the rungs x loads x replications validation grid
  behind :meth:`repro_torch.core.planner.Planner.validate_pipeline`, and
  :func:`pipeline_sojourn`, the queueing-network prediction it is held
  against.

Everything but the sweep's engine is the reference text unchanged (a test
holds each class and function to it).  :func:`sweep_pipeline` evaluates
the grid with ``backend="torch"`` (the default) on the device:
:func:`_sweep_pipeline_torch` makes the reference's content-keyed numpy
draws on the host, pushes one padded grid to the device, and runs the stage
network through :func:`repro_torch.serving.fastsim._pipeline_grid` (the
chained Lindley and Kiefer-Wolfowitz completion kernels, device sorts and
joins); only the sink's completions come back, and the per-cell statistics
are taken on the host with the reference's numpy calls, so the grids are
bit-equal to ``backend="numpy"``, the reference's per-cell loop.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.aqm import (
    HysteresisSpec,
    allen_cunneen_mean_wait,
    departure_scv,
    fork_join_sojourn,
)
from ..core.elastico import ElasticoController
from ..device import resolve_device
from .faults import FaultSchedule
from .scheduler import Dispatch, Scheduler
from .simulator import (
    CompletedRequest,
    ServiceSampler,
    SimulationResult,
    deterministic_sampler,
    lognormal_sampler_from_profile,
)

_Z95 = 1.6448536269514722


def _lognormal_sigma(mean: float, p95: float) -> float:
    """The sigma the lognormal sampler fits to (mean, p95) — same solve as
    :func:`repro.serving.simulator.lognormal_sampler_from_profile`."""
    ratio = max(p95 / mean, 1.001)
    c = math.log(ratio)
    disc = _Z95 * _Z95 - 2.0 * c
    return _Z95 - math.sqrt(disc) if disc > 0 else _Z95


def stage_service_variance(mean: float, p95: Optional[float]) -> float:
    """Variance of the fitted lognormal service time (0 when the stage is
    deterministic, i.e. no p95 given)."""
    if p95 is None:
        return 0.0
    sigma = _lognormal_sigma(mean, p95)
    return (math.exp(sigma * sigma) - 1.0) * mean * mean


def stage_service_scv(mean: float, p95: Optional[float]) -> float:
    """Squared coefficient of variation of the fitted lognormal."""
    if p95 is None:
        return 0.0
    sigma = _lognormal_sigma(mean, p95)
    return math.exp(sigma * sigma) - 1.0


# --------------------------------------------------------------------------
# the DAG itself
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StageSpec:
    """One named stage: a latency ladder (one entry per configuration the
    stage can run), its worker-pool size, and optional per-config accuracy
    factors (pipeline accuracy composes multiplicatively — the compound-
    workflow coupling the paper's surrogate models) and admission bound."""

    name: str
    mean_s: Tuple[float, ...]
    p95_s: Optional[Tuple[float, ...]] = None
    num_servers: int = 1
    accuracy: Optional[Tuple[float, ...]] = None
    max_queue_depth: Optional[int] = None

    def __post_init__(self) -> None:
        object.__setattr__(self, "mean_s", tuple(float(m) for m in self.mean_s))
        if self.p95_s is not None:
            object.__setattr__(self, "p95_s",
                               tuple(float(p) for p in self.p95_s))
        if self.accuracy is not None:
            object.__setattr__(self, "accuracy",
                               tuple(float(a) for a in self.accuracy))
        if not self.name:
            raise ValueError("stage needs a name")
        if not self.mean_s:
            raise ValueError(f"stage {self.name!r}: empty config ladder")
        if any(m <= 0 for m in self.mean_s):
            raise ValueError(f"stage {self.name!r}: means must be positive")
        if self.p95_s is not None and len(self.p95_s) != len(self.mean_s):
            raise ValueError(f"stage {self.name!r}: p95 ladder length "
                             "must match the mean ladder")
        if self.accuracy is not None and len(self.accuracy) != len(self.mean_s):
            raise ValueError(f"stage {self.name!r}: accuracy ladder length "
                             "must match the mean ladder")
        if self.num_servers < 1:
            raise ValueError(f"stage {self.name!r}: num_servers must be >= 1")
        if self.max_queue_depth is not None and self.max_queue_depth < 1:
            raise ValueError(f"stage {self.name!r}: max_queue_depth "
                             "must be >= 1 (or None)")

    @property
    def num_configs(self) -> int:
        return len(self.mean_s)

    def sampler(self) -> ServiceSampler:
        """The stage's service-time sampler: lognormal tails fitted to
        (mean, p95) per config, or deterministic without a p95 ladder."""
        if self.p95_s is not None:
            return lognormal_sampler_from_profile(self.mean_s, self.p95_s)
        return deterministic_sampler(self.mean_s)

    def accuracy_of(self, config_index: int) -> float:
        return 1.0 if self.accuracy is None else self.accuracy[config_index]


@dataclass(frozen=True)
class WorkflowDAG:
    """Stages plus directed edges ``(from_index, to_index)``.

    Must be acyclic with exactly one sink.  Stages without predecessors
    are *sources* — every external arrival is offered to each of them
    (so a fork at the very entry is just multiple sources).  A stage with
    several predecessors is a *join*: a request becomes eligible there
    only once all of its predecessor copies have completed."""

    stages: Tuple[StageSpec, ...]
    edges: Tuple[Tuple[int, int], ...] = ()

    def __post_init__(self) -> None:
        object.__setattr__(self, "stages", tuple(self.stages))
        object.__setattr__(
            self, "edges",
            tuple((int(a), int(b)) for a, b in self.edges))
        if not self.stages:
            raise ValueError("a workflow needs at least one stage")
        names = [s.name for s in self.stages]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate stage names in {names}")
        n = len(self.stages)
        seen = set()
        for a, b in self.edges:
            if not (0 <= a < n and 0 <= b < n):
                raise ValueError(f"edge ({a}, {b}) out of range")
            if a == b:
                raise ValueError(f"self-loop at stage {a}")
            if (a, b) in seen:
                raise ValueError(f"duplicate edge ({a}, {b})")
            seen.add((a, b))
        order = self.topological_order()   # raises on cycles
        sinks = [j for j in range(n) if not self.successors(j)]
        if len(sinks) != 1:
            raise ValueError(
                f"workflow must have exactly one sink stage, got "
                f"{[self.stages[j].name for j in sinks]}")
        assert order[-1] in sinks or n == 1 or True

    # -- topology ----------------------------------------------------------

    @property
    def num_stages(self) -> int:
        return len(self.stages)

    def predecessors(self, j: int) -> Tuple[int, ...]:
        return tuple(a for a, b in self.edges if b == j)

    def successors(self, j: int) -> Tuple[int, ...]:
        return tuple(b for a, b in self.edges if a == j)

    def sources(self) -> Tuple[int, ...]:
        return tuple(j for j in range(len(self.stages))
                     if not self.predecessors(j))

    def sink(self) -> int:
        (s,) = [j for j in range(len(self.stages))
                if not self.successors(j)]
        return s

    def topological_order(self) -> Tuple[int, ...]:
        """Kahn's algorithm with the lowest-index tie-break (deterministic
        processing order for the simulator and the fast path)."""
        n = len(self.stages)
        indeg = [len(self.predecessors(j)) for j in range(n)]
        ready = [j for j in range(n) if indeg[j] == 0]
        heapq.heapify(ready)
        out: List[int] = []
        while ready:
            j = heapq.heappop(ready)
            out.append(j)
            for s in self.successors(j):
                indeg[s] -= 1
                if indeg[s] == 0:
                    heapq.heappush(ready, s)
        if len(out) != n:
            raise ValueError("workflow graph has a cycle")
        return tuple(out)

    def is_tandem(self) -> bool:
        """True when the DAG is a simple chain (every stage has at most one
        predecessor and one successor)."""
        return all(len(self.predecessors(j)) <= 1
                   and len(self.successors(j)) <= 1
                   for j in range(len(self.stages)))

    def stage_index(self, name: str) -> int:
        for j, s in enumerate(self.stages):
            if s.name == name:
                return j
        raise KeyError(name)

    # -- constructors ------------------------------------------------------

    @classmethod
    def single(cls, stage: StageSpec) -> "WorkflowDAG":
        """The degenerate one-stage workflow (collapse-contract anchor)."""
        return cls(stages=(stage,), edges=())

    @classmethod
    def tandem(cls, stages: Sequence[StageSpec]) -> "WorkflowDAG":
        sts = tuple(stages)
        return cls(stages=sts,
                   edges=tuple((j, j + 1) for j in range(len(sts) - 1)))

    @classmethod
    def fork_join(cls, branches: Sequence[StageSpec], join: StageSpec, *,
                  tail: Sequence[StageSpec] = ()) -> "WorkflowDAG":
        """Parallel single-stage branches joining at ``join`` (e.g. two
        retrieve branches joining at rerank), followed by an optional
        tandem ``tail`` (e.g. generate)."""
        if len(branches) < 2:
            raise ValueError("fork-join needs at least two branches")
        sts = tuple(branches) + (join,) + tuple(tail)
        jidx = len(branches)
        edges = [(b, jidx) for b in range(len(branches))]
        for t in range(len(tail)):
            edges.append((jidx + t, jidx + t + 1))
        return cls(stages=sts, edges=tuple(edges))

    def validate_stage_indices(self, stage_indices: Sequence[int]) -> Tuple[int, ...]:
        cfg = tuple(int(k) for k in stage_indices)
        if len(cfg) != len(self.stages):
            raise ValueError(f"need one config index per stage "
                             f"({len(self.stages)}), got {len(cfg)}")
        for j, k in enumerate(cfg):
            if not 0 <= k < self.stages[j].num_configs:
                raise IndexError(
                    f"stage {self.stages[j].name!r}: config {k} out of "
                    f"range [0, {self.stages[j].num_configs})")
        return cfg


# --------------------------------------------------------------------------
# pipeline-level service profile and queueing model
# --------------------------------------------------------------------------


def pipeline_service_profile(dag: WorkflowDAG,
                             stage_indices: Sequence[int]
                             ) -> Tuple[float, float]:
    """(mean, p95) of the end-to-end *service* time (no queueing) of one
    pipeline rung.

    Tandem segments add; a join's segment mean is the fork-join
    critical path over its predecessors' cumulative means
    (:func:`repro.core.aqm.fork_join_sojourn` — m * H_k for identical
    branches).  The p95 is the critical-path normal-tail estimate
    ``mean + z95 * sqrt(sum of stage variances along the max-mean path)``
    — except for a single-stage workflow, where the stage's own fitted
    p95 is returned unchanged so the degenerate DAG's thresholds collapse
    exactly to the single-stage AQM values.
    """
    cfg = dag.validate_stage_indices(stage_indices)
    if dag.num_stages == 1:
        st = dag.stages[0]
        p95 = (st.p95_s[cfg[0]] if st.p95_s is not None else st.mean_s[cfg[0]])
        return st.mean_s[cfg[0]], p95
    cum_mean: Dict[int, float] = {}
    cum_var: Dict[int, float] = {}
    for j in dag.topological_order():
        st = dag.stages[j]
        m = st.mean_s[cfg[j]]
        v = stage_service_variance(
            m, None if st.p95_s is None else st.p95_s[cfg[j]])
        preds = dag.predecessors(j)
        if not preds:
            base_m, base_v = 0.0, 0.0
        elif len(preds) == 1:
            base_m, base_v = cum_mean[preds[0]], cum_var[preds[0]]
        else:
            base_m = fork_join_sojourn([cum_mean[p] for p in preds])
            base_v = max(cum_var[p] for p in preds)
        cum_mean[j] = base_m + m
        cum_var[j] = base_v + v
    sink = dag.sink()
    mean = cum_mean[sink]
    return mean, mean + _Z95 * math.sqrt(cum_var[sink])


def pipeline_sojourn(dag: WorkflowDAG, stage_indices: Sequence[int],
                     arrival_rate_qps: float, *,
                     scv_arrival: float = 1.0) -> float:
    """Stationary mean end-to-end sojourn (queueing + service) of one
    pipeline rung under Poisson-ish external load — the queueing-network
    prediction :func:`sweep_pipeline` grids are validated against.

    Every stage sees the full external rate (a fork duplicates each
    request down every branch).  Per stage: Allen-Cunneen G/G/c wait with
    the arrival SCV chained from the predecessor's departure process
    (:func:`repro.core.aqm.departure_scv`); a join averages its
    predecessors' departure SCVs and takes the fork-join critical path
    over the branches' cumulative sojourns.  Saturated stages propagate
    ``inf``."""
    cfg = dag.validate_stage_indices(stage_indices)
    if arrival_rate_qps < 0:
        raise ValueError("arrival rate must be >= 0")
    cum: Dict[int, float] = {}
    out_scv: Dict[int, float] = {}
    for j in dag.topological_order():
        st = dag.stages[j]
        m = st.mean_s[cfg[j]]
        cs2 = stage_service_scv(
            m, None if st.p95_s is None else st.p95_s[cfg[j]])
        preds = dag.predecessors(j)
        if not preds:
            base, ca2 = 0.0, float(scv_arrival)
        elif len(preds) == 1:
            base, ca2 = cum[preds[0]], out_scv[preds[0]]
        else:
            branches = [cum[p] for p in preds]
            base = (float("inf") if any(math.isinf(b) for b in branches)
                    else fork_join_sojourn(branches))
            ca2 = sum(out_scv[p] for p in preds) / len(preds)
        c = st.num_servers
        wait = allen_cunneen_mean_wait(c, arrival_rate_qps, m,
                                       scv_service=cs2, scv_arrival=ca2)
        rho = arrival_rate_qps * m / c
        cum[j] = base + wait + m
        out_scv[j] = departure_scv(c, rho, scv_arrival=ca2, scv_service=cs2)
    return cum[dag.sink()]


# --------------------------------------------------------------------------
# the pipeline ladder: rungs + switching thresholds
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelinePolicy:
    """One pipeline rung: a per-stage configuration choice plus the
    switching thresholds stated at the rung's bottleneck stage.

    Duck-type compatible with :class:`repro.core.aqm.SwitchingPolicy` as
    far as :class:`repro.core.elastico.ElasticoController` reads it
    (``upscale_threshold`` / ``downscale_threshold``); ``stage_weights``
    additionally lets :meth:`~repro.core.elastico.ElasticoController.observe_stages`
    collapse per-stage depths into bottleneck-equivalent units."""

    index: int
    stage_indices: Tuple[int, ...]
    mean_latency_s: float            # end-to-end service mean (no queueing)
    p95_latency_s: float             # end-to-end service p95 estimate
    accuracy: float                  # product of stage accuracy factors
    queuing_slack_s: float           # Delta_r = L - p95_e2e  (Eq. 7 lifted)
    upscale_threshold: int           # N_r(up), bottleneck-equivalent depth
    downscale_threshold: Optional[int]
    bottleneck_stage: int            # argmax_j s_j / c_j at this rung
    stage_weights: Tuple[float, ...]  # (s_j / c_j) / (s_b / c_b)


@dataclass(frozen=True)
class PipelinePolicyTable:
    """The pipeline ladder — duck-type compatible with
    :class:`repro.core.aqm.AQMPolicyTable` so the unmodified
    :class:`repro.core.elastico.ElasticoController` can walk it."""

    slo_p95_s: float
    slack_buffer_s: float
    policies: Tuple[PipelinePolicy, ...]
    hysteresis: HysteresisSpec
    excluded: Tuple[Tuple[int, ...], ...] = ()   # rungs with Delta <= 0
    num_servers: int = 1       # bottleneck pool size of the fastest rung
    max_batch_size: int = 1    # pipeline ladders are unbatched (B = 1)

    @property
    def ladder_size(self) -> int:
        return len(self.policies)

    def policy(self, k: int) -> PipelinePolicy:
        return self.policies[k]

    def stage_indices(self, k: int) -> Tuple[int, ...]:
        return self.policies[k].stage_indices


def _greedy_rung_walk(dag: WorkflowDAG) -> List[Tuple[int, ...]]:
    """Default pipeline ladder: start all-fastest and repeatedly upgrade
    the single stage with the best accuracy-gain per added end-to-end
    mean latency (ties break toward the lowest stage index) until every
    stage is at its most accurate configuration.  Produces a ladder of
    ``sum_j (K_j - 1) + 1`` rungs with strictly non-decreasing mean."""
    cur = [0] * dag.num_stages
    rungs = [tuple(cur)]
    while True:
        best: Optional[Tuple[float, float, int]] = None
        base_mean, _ = pipeline_service_profile(dag, cur)
        base_acc = 1.0
        for j, st in enumerate(dag.stages):
            base_acc *= st.accuracy_of(cur[j])
        for j, st in enumerate(dag.stages):
            if cur[j] + 1 >= st.num_configs:
                continue
            trial = list(cur)
            trial[j] += 1
            mean, _ = pipeline_service_profile(dag, trial)
            dm = mean - base_mean
            acc = 1.0
            for i, s2 in enumerate(dag.stages):
                acc *= s2.accuracy_of(trial[i])
            da = acc - base_acc
            score = da / dm if dm > 1e-12 else float("inf")
            # max score, ties toward the lowest stage index
            key = (score, -j)
            if best is None or key > (best[0], -best[2]):
                best = (score, dm, j)
        if best is None:
            return rungs
        cur[best[2]] += 1
        rungs.append(tuple(cur))


def derive_pipeline_policies(
    dag: WorkflowDAG,
    *,
    slo_p95_s: float,
    slack_buffer_s: float = 0.050,
    hysteresis: HysteresisSpec = HysteresisSpec(),
    rungs: Optional[Sequence[Sequence[int]]] = None,
) -> PipelinePolicyTable:
    """Derive the pipeline-level switching ladder from stage-level models.

    Each rung r fixes one configuration per stage.  The thresholds lift
    Eq. 10/13 to the pipeline: with queuing slack ``Delta_r = L -
    p95_e2e(r)`` (end-to-end service p95,
    :func:`pipeline_service_profile`) and bottleneck stage ``b`` (largest
    per-request drain time ``s_j / c_j``),

      N_r(up) = floor(c_b * Delta_r / s_b)
      N_r(dn) = floor(c_b' * (Delta_{r+1} - h_s) / s_b')   (next rung's b')

    — the deepest bottleneck-equivalent backlog the rung can drain inside
    its slack.  The controller compares these against the weighted
    per-stage depth (:attr:`PipelinePolicy.stage_weights`,
    :meth:`repro.core.elastico.ElasticoController.observe_stages`).  For
    a single-stage DAG every formula collapses to
    :func:`repro.core.aqm.derive_policies` exactly.

    ``rungs`` overrides the ladder (must be strictly increasing in
    end-to-end mean); the default is the greedy accuracy-per-latency walk
    from all-fastest to all-most-accurate.  Rungs whose end-to-end p95
    already exceeds the SLO are excluded (cannot meet it even unloaded).
    """
    if slo_p95_s <= 0:
        raise ValueError("SLO must be positive")
    if rungs is None:
        walk = _greedy_rung_walk(dag)
    else:
        walk = [dag.validate_stage_indices(r) for r in rungs]
        means = [pipeline_service_profile(dag, r)[0] for r in walk]
        for a, b in zip(means, means[1:]):
            if not b > a:
                raise ValueError("pipeline rungs must be ordered by "
                                 "strictly increasing end-to-end mean")
    admitted: List[Tuple[Tuple[int, ...], float, float]] = []
    excluded: List[Tuple[int, ...]] = []
    for cfg in walk:
        mean, p95 = pipeline_service_profile(dag, cfg)
        if slo_p95_s - p95 > 0:
            admitted.append((tuple(cfg), mean, p95))
        else:
            excluded.append(tuple(cfg))

    def bottleneck(cfg: Sequence[int]) -> Tuple[int, float, Tuple[float, ...]]:
        per = [dag.stages[j].mean_s[cfg[j]] / dag.stages[j].num_servers
               for j in range(dag.num_stages)]
        b = max(range(len(per)), key=lambda j: (per[j], -j))
        weights = tuple(p / per[b] for p in per)
        return b, per[b], weights

    policies: List[PipelinePolicy] = []
    n = len(admitted)
    for r, (cfg, mean, p95) in enumerate(admitted):
        delta = slo_p95_s - p95
        b, drain_b, weights = bottleneck(cfg)
        c_b = dag.stages[b].num_servers
        s_b = dag.stages[b].mean_s[cfg[b]]
        up = int(math.floor(c_b * delta / s_b))
        down: Optional[int] = None
        if r + 1 < n:
            nxt_cfg, _, nxt_p95 = admitted[r + 1]
            delta_next = slo_p95_s - nxt_p95
            budget = max(0.0, delta_next - slack_buffer_s)
            nb, _, _ = bottleneck(nxt_cfg)
            down = int(math.floor(
                dag.stages[nb].num_servers * budget
                / dag.stages[nb].mean_s[nxt_cfg[nb]]))
        acc = 1.0
        for j, st in enumerate(dag.stages):
            acc *= st.accuracy_of(cfg[j])
        policies.append(PipelinePolicy(
            index=r,
            stage_indices=cfg,
            mean_latency_s=mean,
            p95_latency_s=p95,
            accuracy=acc,
            queuing_slack_s=delta,
            upscale_threshold=max(0, up),
            downscale_threshold=down,
            bottleneck_stage=b,
            stage_weights=weights,
        ))
    fastest_c = (dag.stages[policies[0].bottleneck_stage].num_servers
                 if policies else 1)
    return PipelinePolicyTable(
        slo_p95_s=slo_p95_s,
        slack_buffer_s=slack_buffer_s,
        policies=tuple(policies),
        hysteresis=hysteresis,
        excluded=tuple(excluded),
        num_servers=fastest_c,
    )


@dataclass
class PipelinePlan:
    """Planner output for a workflow DAG: the DAG plus its pipeline
    ladder (:meth:`repro.core.planner.Planner.plan_pipeline`)."""

    dag: WorkflowDAG
    table: PipelinePolicyTable

    def describe(self) -> str:
        topo = " -> ".join(self.dag.stages[j].name
                           for j in self.dag.topological_order())
        lines = [
            f"pipeline SLO p95 = {self.table.slo_p95_s * 1e3:.0f} ms, "
            f"{self.dag.num_stages} stages [{topo}], ladder of "
            f"{self.table.ladder_size} rungs "
            f"({len(self.table.excluded)} infeasible for SLO)"
        ]
        for pol in self.table.policies:
            lines.append(
                f"  [{pol.index}] cfg={list(pol.stage_indices)} "
                f"acc={pol.accuracy:.3f} mean={pol.mean_latency_s * 1e3:.1f}ms "
                f"p95~{pol.p95_latency_s * 1e3:.1f}ms "
                f"bottleneck={self.dag.stages[pol.bottleneck_stage].name} "
                f"N_up={pol.upscale_threshold} N_dn={pol.downscale_threshold}")
        return "\n".join(lines)


# --------------------------------------------------------------------------
# the event-heap oracle
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class StageStats:
    """Per-stage accounting of one :class:`DagSimulator` run.  The
    conservation invariant the property tests pin:
    ``admitted == completed + in_flight + failed`` at every stage, where
    ``in_flight`` counts buffered plus in-service requests at the moment
    the run stopped (always 0 for drained fault-free runs) and ``failed``
    counts requests whose crash-retry budget was exhausted at this stage
    (always 0 without a fault schedule)."""

    name: str
    offered: int
    dropped: int
    completed: int
    in_flight: int
    busy_s: Tuple[float, ...]
    depth_samples: Tuple[Tuple[float, int], ...]
    config_timeline: Tuple[Tuple[float, int], ...]
    failed: int = 0
    retried: int = 0

    @property
    def admitted(self) -> int:
        return self.offered - self.dropped


@dataclass
class DagSimulationResult(SimulationResult):
    """DAG run result.  The inherited surface reads end-to-end: each
    ``completed`` record is the *sink* dispatch (``arrival_s`` is the
    original external arrival, so ``latency_s`` is the end-to-end sojourn
    and ``wait_s`` the time before sink service started);
    ``config_timeline`` is the *pipeline rung* timeline;
    ``queue_depth_samples`` totals buffered depth across stages;
    ``per_server_busy_s`` concatenates the stage pools in stage order —
    all of which makes a single-stage run bit-identical to
    :class:`repro.serving.simulator.ServingSimulator`."""

    stage_stats: Tuple[StageStats, ...] = ()
    request_accuracy: Dict[int, float] = field(default_factory=dict)

    def mean_pipeline_accuracy(self) -> float:
        """Mean over completed requests of the product of the stage
        accuracy factors each request was actually served under (a
        request can traverse different rungs at different stages)."""
        if not self.completed:
            return 0.0
        return sum(self.request_accuracy[r.request_id]
                   for r in self.completed) / len(self.completed)


def _stage_seed(seed: int, j: int) -> int:
    """Stage j's RNG seed.  Stage 0 uses ``seed`` itself — the degenerate
    single-stage DAG must replay ``ServingSimulator``'s exact
    ``random.Random(seed)`` stream — and later stages use independent
    derived streams."""
    return seed if j == 0 else (seed * 1_000_003 + j) & 0x7FFFFFFF


@dataclass
class DagSimulator:
    """Event-heap simulator routing requests stage-to-stage through a
    :class:`WorkflowDAG` — the exact oracle for compound pipelines.

    One shared-FIFO :class:`repro.serving.scheduler.Scheduler` per stage
    (per-stage worker pools and admission bounds from the
    :class:`StageSpec`); completions forward the batch's requests to the
    successor stages (joins wait for every predecessor), and sink
    dispatches produce the end-to-end completion records.  ``controller``
    (optional) is a pipeline-level
    :class:`repro.core.elastico.ElasticoController` over a
    :class:`PipelinePolicyTable`: it consumes per-stage buffered depths
    (:meth:`~repro.core.elastico.ElasticoController.observe_stages`) at
    every event and control tick, and its rung switches are applied to
    each stage via
    :meth:`repro.serving.scheduler.Scheduler.set_active_index` (stages
    whose config the new rung leaves unchanged are untouched).  Without a
    controller the run is pinned to ``static_rung`` of ``rungs`` — or to
    an explicit ``static_stage_indices`` vector.

    ``run(..., drain=False)`` stops processing at ``duration_s`` and
    reports the in-flight population per stage instead of draining the
    backlog — the mode the conservation property tests use.

    Degenerate collapse: a one-stage DAG reproduces
    :class:`repro.serving.simulator.ServingSimulator` bit-for-bit (see
    module docstring)."""

    dag: WorkflowDAG
    controller: Optional[ElasticoController] = None
    static_rung: int = 0
    rungs: Optional[Sequence[Sequence[int]]] = None
    static_stage_indices: Optional[Sequence[int]] = None
    control_tick_s: float = 0.25
    switch_latency_s: float = 0.010
    seed: int = 0
    # fault plane (beyond-paper): per-stage worker crashes/recoveries,
    # straggler windows, and stage-wide brownouts
    # (:mod:`repro.serving.faults` — every fault here must carry a stage
    # index).  Crash semantics mirror the flat simulator: the in-flight
    # batch on a crashed stage worker is cancelled and requeued at that
    # stage's queue head, retrying up to ``retry_budget`` times before
    # counting as ``failed`` at that stage.  An empty schedule (or None)
    # reproduces the fault-free run bit-for-bit.
    faults: Optional[FaultSchedule] = None
    retry_budget: int = 3

    def _resolve_rungs(self) -> List[Tuple[int, ...]]:
        if self.static_stage_indices is not None:
            if self.controller is not None:
                raise ValueError("static_stage_indices is for controller-"
                                 "free runs")
            return [self.dag.validate_stage_indices(self.static_stage_indices)]
        if self.rungs is not None:
            return [self.dag.validate_stage_indices(r) for r in self.rungs]
        if self.controller is not None:
            table = self.controller.table
            if hasattr(table, "stage_indices"):
                return [self.dag.validate_stage_indices(table.stage_indices(k))
                        for k in range(table.ladder_size)]
            # a single-stage AQM table: rung k is config k on the only stage
            if self.dag.num_stages != 1:
                raise ValueError(
                    "a multi-stage DAG needs pipeline rungs: pass rungs=, "
                    "or a controller over a PipelinePolicyTable")
            return [self.dag.validate_stage_indices((k,))
                    for k in range(table.ladder_size)]
        # static run without explicit rungs: diagonal over the shortest
        # stage ladder
        depth = min(st.num_configs for st in self.dag.stages)
        return [self.dag.validate_stage_indices((k,) * self.dag.num_stages)
                for k in range(depth)]

    def run(self, arrivals: Sequence[float], duration_s: float, *,
            drain: bool = True) -> DagSimulationResult:
        dag = self.dag
        topo = dag.topological_order()
        sources = dag.sources()
        sink = dag.sink()
        preds = [dag.predecessors(j) for j in range(dag.num_stages)]
        succs = [dag.successors(j) for j in range(dag.num_stages)]
        rungs = self._resolve_rungs()

        faults = (self.faults
                  if self.faults is not None and not self.faults.is_empty()
                  else None)
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if faults is not None:
            scoped = ([(c.stage, c.worker_id) for c in faults.crashes]
                      + [(s.stage, s.worker_id) for s in faults.stragglers]
                      + [(b.stage, 0) for b in faults.brownouts])
            for j, w in scoped:
                if j is None or not 0 <= j < dag.num_stages:
                    raise ValueError(
                        f"DAG faults must carry a stage index in "
                        f"[0, {dag.num_stages}); got {j!r}")
                if w >= dag.stages[j].num_servers:
                    raise ValueError(
                        f"fault addresses worker {w} of stage "
                        f"{dag.stages[j].name!r} "
                        f"(c={dag.stages[j].num_servers})")

        ctrl = self.controller
        if ctrl is not None:
            ctrl.reset()
            rung = ctrl.current_index
            if rung >= len(rungs):
                raise ValueError("controller ladder larger than rung list")
        else:
            if not 0 <= self.static_rung < len(rungs):
                raise ValueError(f"static_rung {self.static_rung} out of "
                                 f"range [0, {len(rungs)})")
            rung = self.static_rung
        cfg = rungs[rung]

        rngs = [random.Random(_stage_seed(self.seed, j))
                for j in range(dag.num_stages)]
        samplers = [st.sampler() for st in dag.stages]
        scheds = [Scheduler(
            num_workers=st.num_servers,
            max_queue_depth=st.max_queue_depth,
            static_index=cfg[j],
            num_configs=st.num_configs,
            switch_latency_s=self.switch_latency_s,
            record_initial_config=True,
        ) for j, st in enumerate(dag.stages)]

        # event heap: (time, order, kind, payload) — the flat simulator's
        # exact structure, with completion payloads carrying the stage
        events: List[Tuple[float, int, str, object]] = []
        order = 0
        for i, t in enumerate(arrivals):
            heapq.heappush(events, (t, order, "arrival", i))
            order += 1
        t = 0.0
        while t < duration_s:
            heapq.heappush(events, (t, order, "tick", None))
            order += 1
            t += self.control_tick_s
        if faults is not None:
            # capacity events are seeded after arrivals and ticks, so at
            # equal times they process after same-time ticks/arrivals
            for j in range(dag.num_stages):
                for ft, fkind, fworker in faults.capacity_events(j):
                    heapq.heappush(events, (ft, order, fkind, (j, fworker)))
                    order += 1

        arrival_time: Dict[int, float] = {i: a for i, a in enumerate(arrivals)}
        busy: List[List[float]] = [[0.0] * st.num_servers
                                   for st in dag.stages]
        completed: List[CompletedRequest] = []
        depth_samples: List[Tuple[float, int]] = []
        stage_depth_samples: List[List[Tuple[float, int]]] = [
            [] for _ in dag.stages]
        pending: Dict[Tuple[int, int], Tuple[object, ...]] = {}
        join_count: Dict[Tuple[int, int], int] = {}
        stage_completed = [0] * dag.num_stages
        acc: Dict[int, float] = {}
        rung_timeline: List[Tuple[float, int]] = [(0.0, rung)]
        # fault-tracking state, all untouched when faults is None: worker
        # epochs (a crash bumps the epoch so the stale completion event is
        # skipped), dispatch metadata needed to unwind a crashed batch,
        # and per-(stage, request) crash-retry attempts
        epoch: Dict[Tuple[int, int], int] = {}
        meta: Dict[Tuple[int, int], Tuple[int, float, float, int, float]] = {}
        attempts: Dict[Tuple[int, int], int] = {}

        def execute_stage(j: int, polled) -> None:
            nonlocal order
            dispatches, lingers = polled
            assert not lingers     # B = 1: no linger is ever scheduled
            for d in dispatches:
                svc = samplers[j](d.config_index, rngs[j])
                if faults is not None:
                    svc *= faults.inflation(d.worker_id, d.start_s, stage=j)
                comp = d.start_s + svc
                busy[j][d.worker_id] += comp - d.start_s
                a_factor = dag.stages[j].accuracy_of(d.config_index)
                for rid in d.items:
                    if a_factor != 1.0 or rid in acc:
                        acc[rid] = acc.get(rid, 1.0) * a_factor
                rec_lo = len(completed)
                if j == sink:
                    for rid in d.items:
                        completed.append(CompletedRequest(
                            request_id=rid,
                            arrival_s=arrival_time[rid],
                            start_s=d.start_s,
                            completion_s=comp,
                            config_index=d.config_index,
                            server_id=d.worker_id,
                            batch_size=d.batch_size,
                        ))
                pending[(j, d.worker_id)] = d.items
                ep = 0
                if faults is not None:
                    key = (j, d.worker_id)
                    ep = epoch.get(key, 0)
                    meta[key] = (ep, d.start_s, comp, rec_lo, a_factor)
                heapq.heappush(events, (comp, order, "completion",
                                        (j, d.worker_id, ep)))
                order += 1

        def poll_all(now: float) -> None:
            for j in topo:
                execute_stage(j, scheds[j].poll(now))

        def forward(j: int, items, now: float) -> None:
            for s in succs[j]:
                need = len(preds[s])
                for rid in items:
                    if need > 1:
                        key = (s, rid)
                        got = join_count.get(key, 0) + 1
                        if got < need:
                            join_count[key] = got
                            continue
                        join_count.pop(key, None)
                    scheds[s].offer(rid, now)

        def observe_ctrl(now: float) -> None:
            nonlocal rung, cfg
            if ctrl is None:
                return
            depths = [scheds[j].buffered() for j in range(dag.num_stages)]
            ev = ctrl.observe_stages(depths, now)
            if ev is not None:
                rung = ev.to_index
                cfg = rungs[rung]
                for j in range(dag.num_stages):
                    scheds[j].set_active_index(cfg[j], now)
                rung_timeline.append((now, rung))

        stopped_early = False
        while events:
            now, _, kind, payload = heapq.heappop(events)
            if now > duration_s and kind == "tick":
                continue
            if not drain and now > duration_s:
                heapq.heappush(events, (now, 0, kind, payload))
                stopped_early = True
                break
            if kind == "arrival":
                for s in sources:
                    scheds[s].offer(int(payload), now)  # type: ignore[arg-type]
                poll_all(now)
                observe_ctrl(now)
            elif kind == "completion":
                j, worker, ep = payload  # type: ignore[misc]
                if faults is not None:
                    if ep != epoch.get((j, worker), 0):
                        continue    # stale: the worker crashed mid-batch
                    meta.pop((j, worker), None)
                scheds[j].release(worker, now)
                items = pending.pop((j, worker))
                stage_completed[j] += len(items)
                forward(j, items, now)
                poll_all(now)
                observe_ctrl(now)
            elif kind == "crash":
                j, w = payload  # type: ignore[misc]
                scheds[j].mark_worker_down(w, now)
                requeue: List[object] = []
                key = (j, w)
                if key in meta:
                    # cancel the in-flight batch: refund the unserved busy
                    # time, undo the accuracy factor, null the sink
                    # records, and requeue survivors at the queue head
                    ep, start_s, comp_s, rec_lo, a_factor = meta.pop(key)
                    epoch[key] = ep + 1
                    items = pending.pop(key)
                    busy[j][w] -= comp_s - max(start_s, min(now, comp_s))
                    if a_factor != 1.0:
                        for rid in items:
                            acc[rid] = acc.get(rid, 1.0) / a_factor
                    if j == sink:
                        for i in range(rec_lo, rec_lo + len(items)):
                            completed[i] = None  # type: ignore[call-overload]
                    for rid in items:
                        a = attempts.get((j, rid), 0) + 1
                        attempts[(j, rid)] = a
                        if a > self.retry_budget:
                            scheds[j].record_failed(1)
                        else:
                            requeue.append(rid)
                    scheds[j].worker_idle_while_down(w)
                requeue.extend(scheds[j].drain_worker_backlog(w))
                scheds[j].requeue_front(requeue)
                poll_all(now)
                observe_ctrl(now)
            elif kind == "recover":
                j, w = payload  # type: ignore[misc]
                scheds[j].mark_worker_up(w, now)
                poll_all(now)
                observe_ctrl(now)
            else:   # control tick
                observe_ctrl(now)
                poll_all(now)
                total = sum(sched.buffered() for sched in scheds)
                depth_samples.append((now, total))
                for j in range(dag.num_stages):
                    stage_depth_samples[j].append((now, scheds[j].buffered()))

        if faults is not None:
            # crashed sink dispatches left None placeholders (so earlier
            # record indices stayed stable); drop them now
            completed = [r for r in completed if r is not None]
        in_service = [0] * dag.num_stages
        for (j, _w), items in pending.items():
            in_service[j] += len(items)
        stats = tuple(StageStats(
            name=dag.stages[j].name,
            offered=scheds[j].offered,
            dropped=scheds[j].dropped,
            completed=stage_completed[j],
            in_flight=scheds[j].buffered() + in_service[j],
            busy_s=tuple(busy[j]),
            depth_samples=tuple(stage_depth_samples[j]),
            config_timeline=tuple(scheds[j].config_timeline),
            failed=scheds[j].failed,
            retried=scheds[j].retried,
        ) for j in range(dag.num_stages))
        assert drain or stopped_early or not events

        flat_busy: List[float] = []
        for row in busy:
            flat_busy.extend(row)
        return DagSimulationResult(
            completed=completed,
            switch_events=list(ctrl.events) if ctrl is not None else [],
            config_timeline=rung_timeline,
            queue_depth_samples=depth_samples,
            duration_s=duration_s,
            num_servers=sum(st.num_servers for st in dag.stages),
            per_server_busy_s=flat_busy,
            num_batches=sum(s.num_batches for s in scheds),
            offered=scheds[sources[0]].offered,
            dropped=sum(s.dropped for s in scheds),
            failed=sum(s.failed for s in scheds),
            retried=sum(s.retried for s in scheds),
            in_flight=sum(s.in_flight for s in stats),
            stage_stats=stats,
            request_accuracy={r.request_id: acc.get(r.request_id, 1.0)
                              for r in completed},
        )


# --------------------------------------------------------------------------
# the chained-recursion fast path (exact for static runs)
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class DagFastResult:
    """Result of :func:`simulate_dag`: sink completion records in sink
    dispatch order (bit-identical to the oracle's), plus the per-stage
    completion grid aligned to the original arrival order."""

    completed: Tuple[CompletedRequest, ...]
    stage_completions: np.ndarray       # (num_stages, n), original order
    arrivals: np.ndarray

    def latencies(self) -> np.ndarray:
        return self.stage_completions[-1] - self.arrivals

    def slo_compliance(self, slo_s: float) -> float:
        lats = self.latencies()
        return float((lats <= slo_s).mean()) if lats.size else 1.0


def simulate_dag(dag: WorkflowDAG, arrivals: Sequence[float], *,
                 stage_indices: Sequence[int],
                 seed: int = 0) -> DagFastResult:
    """Chained-Lindley replay of a *static* DAG scenario — stage n's
    departures are stage n+1's arrivals; a join's arrival is the
    element-wise max over its predecessors' completions.

    Exactness contract (the eligibility mirror of
    :func:`repro.serving.fastsim.simulate`): no controller, no admission
    bounds, B = 1 — then each stage's FIFO dispatch order is its arrival
    order, service draws come from the same per-stage ``random.Random``
    streams in the same order as :class:`DagSimulator`, and the start /
    completion floats are computed by the identical ``max`` + one-add
    ops, so the sink records are **bit-for-bit** the oracle's (property-
    tested in ``tests/test_dag.py``).  Stages with ``c > 1`` run the
    sorted-workload Kiefer-Wolfowitz recursion, exact for the same
    reason.  Ordering between equal-time stage arrivals follows the
    stable sort by original request id; continuous (lognormal) service
    makes ties measure-zero."""
    cfg = dag.validate_stage_indices(stage_indices)
    if any(st.max_queue_depth is not None for st in dag.stages):
        raise ValueError("fast path requires unbounded stage queues "
                         "(admission drops need the event-heap oracle)")
    A = np.asarray(list(arrivals), dtype=float)
    n = A.size
    topo = dag.topological_order()
    sink = dag.sink()
    comp = np.zeros((dag.num_stages, n), dtype=float)
    sink_records: List[CompletedRequest] = []
    for j in topo:
        st = dag.stages[j]
        pr = dag.predecessors(j)
        if not pr:
            arr_j = A
        elif len(pr) == 1:
            arr_j = comp[pr[0]]
        else:
            arr_j = np.max(np.stack([comp[p] for p in pr]), axis=0)
        order = np.argsort(arr_j, kind="stable")
        rng = random.Random(_stage_seed(seed, j))
        sampler = st.sampler()
        k = cfg[j]
        c = st.num_servers
        out = np.empty(n, dtype=float)
        if c == 1:
            prev = 0.0
            first = True
            for rid in order:
                a = float(arr_j[rid])
                svc = sampler(k, rng)
                start = a if first or a > prev else prev
                first = False
                done = start + svc
                prev = done
                out[rid] = done
                if j == sink:
                    sink_records.append(CompletedRequest(
                        request_id=int(rid), arrival_s=float(A[rid]),
                        start_s=start, completion_s=done, config_index=k))
        else:
            free = [0.0] * c
            for rid in order:
                a = float(arr_j[rid])
                svc = sampler(k, rng)
                f0 = free[0]
                start = a if a > f0 else f0
                done = start + svc
                free[0] = done
                free.sort()
                out[rid] = done
                if j == sink:
                    sink_records.append(CompletedRequest(
                        request_id=int(rid), arrival_s=float(A[rid]),
                        start_s=start, completion_s=done, config_index=k))
        comp[j] = out
    return DagFastResult(completed=tuple(sink_records),
                         stage_completions=comp, arrivals=A)


# --------------------------------------------------------------------------
# the vectorized validation grid
# --------------------------------------------------------------------------


@dataclass(frozen=True)
class PipelineSweep:
    """Rungs x loads grids, replication-averaged, from
    :func:`sweep_pipeline`; ``predicted_sojourn_s`` is the queueing-
    network prediction (:func:`pipeline_sojourn`) for each cell."""

    arrival_rates_qps: Tuple[float, ...]
    replications: int
    duration_s: float
    mean_latency_s: Tuple[Tuple[float, ...], ...]       # (K, L)
    p95_latency_s: Tuple[Tuple[float, ...], ...]
    slo_compliance: Tuple[Tuple[float, ...], ...]
    predicted_sojourn_s: Tuple[Tuple[float, ...], ...]
    num_requests: int

    def sojourn_model_error(self) -> float:
        """Max relative error of the network model over cells with a
        finite prediction and a meaningful sojourn (> 1 ms)."""
        worst = 0.0
        for sim_row, pred_row in zip(self.mean_latency_s,
                                     self.predicted_sojourn_s):
            for sim, pred in zip(sim_row, pred_row):
                if math.isfinite(pred) and pred > 1e-3:
                    worst = max(worst, abs(sim - pred) / pred)
        return worst


def sweep_pipeline(dag: WorkflowDAG,
                   rungs: Sequence[Sequence[int]], *,
                   arrival_rates_qps: Sequence[float],
                   duration_s: float = 120.0,
                   replications: int = 4,
                   slo_s: float = 1.0,
                   seed: int = 0,
                   backend: str = "torch",
                   device=None) -> PipelineSweep:
    """Replay every pipeline rung against a grid of Poisson arrival rates
    with R replications via the chained recursion (per topological stage,
    element-wise max at joins) — the DAG analogue of
    :func:`repro_torch.serving.fastsim.simulate_batch`, used by
    :meth:`repro_torch.core.planner.Planner.validate_pipeline`.

    Streams are content-keyed (rate / stage-config fingerprints), so each
    (replication, rung, load) cell is a pure function of its inputs —
    lanes share arrival traces (common random numbers across rungs).

    ``backend="torch"`` (the default) evaluates the whole (R, K, L) grid on
    ``device`` (:func:`_sweep_pipeline_torch`; None is the CUDA card and
    raises without one, ``"cpu"`` runs the kernels' plain versions);
    ``"numpy"`` is the reference's per-cell loop.  Both take the same draws
    and give equal grids."""
    from .fastsim import BACKENDS, _fingerprint, lognormal_params

    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    rung_cfgs = [dag.validate_stage_indices(r) for r in rungs]
    rates = [float(r) for r in arrival_rates_qps]
    if not rates or not rung_cfgs:
        raise ValueError("need at least one rung and one arrival rate")
    if duration_s <= 0 or replications < 1:
        raise ValueError("duration must be positive, replications >= 1")
    dev = resolve_device(device) if backend == "torch" else None
    K, L, R = len(rung_cfgs), len(rates), int(replications)
    topo = dag.topological_order()
    sink = dag.sink()

    traces = _pipeline_traces(rates, duration_s, R, seed)
    n_max = max((t.size for row in traces for t in row), default=0)

    if dev is not None and n_max > 0:
        lat_sum, p95_acc, ok, total = _sweep_pipeline_torch(
            dag, topo, sink, rung_cfgs, rates, traces,
            slo_s=slo_s, seed=seed, device=dev)
        predicted = tuple(
            tuple(pipeline_sojourn(dag, cfg, rate) for rate in rates)
            for cfg in rung_cfgs)
        return PipelineSweep(
            arrival_rates_qps=tuple(rates),
            replications=R,
            duration_s=duration_s,
            mean_latency_s=tuple(map(tuple, lat_sum / R)),
            p95_latency_s=tuple(map(tuple, p95_acc / R)),
            slo_compliance=tuple(map(tuple, ok / R)),
            predicted_sojourn_s=predicted,
            num_requests=total,
        )

    lat_sum = np.zeros((K, L))
    p95_acc = np.zeros((K, L))
    ok = np.zeros((K, L))
    total = 0
    for r in range(R):
        for l, rate in enumerate(rates):
            A = traces[r][l]
            n = A.size
            if n == 0:
                ok[:, l] += 1.0
                continue
            for k, cfg in enumerate(rung_cfgs):
                services = []
                servers = []
                for j in topo:
                    st = dag.stages[j]
                    m = st.mean_s[cfg[j]]
                    p95 = None if st.p95_s is None else st.p95_s[cfg[j]]
                    skey = [seed & 0x7FFFFFFF, 12, r, j,
                            _fingerprint(np.float64(m).tobytes()
                                         + np.float64(p95 or 0.0).tobytes()),
                            _fingerprint(np.float64(rate).tobytes())]
                    sgen = np.random.Generator(np.random.PCG64(
                        np.random.SeedSequence(skey)))
                    if p95 is not None:
                        mu, sigma = lognormal_params(m, p95)
                        services.append(sgen.lognormal(mu, sigma, size=n))
                    else:
                        services.append(np.full(n, m))
                    servers.append(st.num_servers)
                comp = _chain_dag(dag, topo, A, services, servers)
                lats = comp[sink] - A
                lat_sum[k, l] += lats.mean()
                idx = int(0.95 * (n - 1))
                p95_acc[k, l] += np.partition(lats, idx)[idx]
                ok[k, l] += (lats <= slo_s).mean()
                total += n
    predicted = tuple(
        tuple(pipeline_sojourn(dag, cfg, rate) for rate in rates)
        for cfg in rung_cfgs)
    return PipelineSweep(
        arrival_rates_qps=tuple(rates),
        replications=R,
        duration_s=duration_s,
        mean_latency_s=tuple(map(tuple, lat_sum / R)),
        p95_latency_s=tuple(map(tuple, p95_acc / R)),
        slo_compliance=tuple(map(tuple, ok / R)),
        predicted_sojourn_s=predicted,
        num_requests=total,
    )


def _pipeline_topo_meta(dag: WorkflowDAG,
                        topo: Sequence[int]) -> Tuple[Tuple, ...]:
    """Static topology descriptor for the batched jax DAG evaluator:
    per topological position, ``(predecessor positions, num_servers,
    needs_sort)``.  ``needs_sort`` propagates sortedness statically:
    sorted external arrivals stay sorted through c = 1 stages (FIFO
    completions are non-decreasing in dispatch order, and the stable
    argsort of a sorted vector is the identity — even under ties) and
    through joins of sorted branches (element-wise max preserves
    monotonicity); only stages downstream of a c > 1 stage pay a
    device-side stable argsort."""
    pos = {j: i for i, j in enumerate(topo)}
    sorted_out: List[bool] = []
    meta = []
    for i, j in enumerate(topo):
        preds = tuple(pos[p] for p in dag.predecessors(j))
        in_sorted = all(sorted_out[p] for p in preds) if preds else True
        c = dag.stages[j].num_servers
        sorted_out.append(in_sorted and c == 1)
        meta.append((preds, c, not in_sorted))
    return tuple(meta)


def _pipeline_traces(rates: Sequence[float], duration_s: float,
                     replications: int, seed: int) -> List[List[np.ndarray]]:
    """The per-(replication, load) Poisson arrival traces of a pipeline
    sweep: each has its own content-keyed generator, so drawing them ahead
    of the sweep loop is byte-identical to drawing them inline."""
    from .fastsim import _fingerprint

    traces: List[List[np.ndarray]] = []
    for r in range(replications):
        row = []
        for rate in rates:
            trace_key = [seed & 0x7FFFFFFF, 11, r,
                         _fingerprint(np.float64(rate).tobytes()),
                         _fingerprint(np.float64(duration_s).tobytes())]
            gen = np.random.Generator(np.random.PCG64(
                np.random.SeedSequence(trace_key)))
            n = gen.poisson(rate * duration_s)
            row.append(np.sort(gen.uniform(0.0, duration_s, size=n))
                       if n > 0 else np.empty(0, dtype=float))
        traces.append(row)
    return traces


def _pipeline_draws(dag: WorkflowDAG, topo: Sequence[int],
                    rung_cfgs: Sequence[Tuple[int, ...]],
                    rates: Sequence[float],
                    traces: Sequence[Sequence[np.ndarray]], *, seed: int):
    """The host draws of a pipeline sweep as one padded grid: arrivals
    ``A`` (B, N_max) with ``+inf`` padding, services ``S`` (J, B, N_max)
    by topological position with 0 padding, and each lane's request count,
    B = R*K*L with cell (r, k, l) at ``(r*K + k)*L + l``.

    The draws reuse the reference loop's content-keyed streams byte for
    byte; because service streams are keyed by (replication, stage, config
    content, rate) — not by rung — rungs that pin the same config for a
    stage share one draw (the common-random-numbers contract), which the
    cache below exploits instead of re-drawing per rung."""
    from .fastsim import _fingerprint, lognormal_params

    R, L, K = len(traces), len(rates), len(rung_cfgs)
    J = len(topo)
    n_max = max(t.size for row in traces for t in row)
    B = R * K * L
    base = seed & 0x7FFFFFFF

    A = np.full((B, n_max), np.inf, dtype=float)
    S = np.zeros((J, B, n_max), dtype=float)
    cell_counts = np.zeros(B, dtype=np.int64)

    svc_cache: dict = {}
    for r in range(R):
        for l, rate in enumerate(rates):
            trace = traces[r][l]
            n = trace.size
            for k, cfg in enumerate(rung_cfgs):
                b = (r * K + k) * L + l
                cell_counts[b] = n
                if n == 0:
                    continue
                A[b, :n] = trace
                for i, j in enumerate(topo):
                    st = dag.stages[j]
                    m = st.mean_s[cfg[j]]
                    p95 = None if st.p95_s is None else st.p95_s[cfg[j]]
                    ck = (r, l, j, m, p95)
                    svc = svc_cache.get(ck)
                    if svc is None:
                        skey = [base, 12, r, j,
                                _fingerprint(np.float64(m).tobytes()
                                             + np.float64(p95 or 0.0)
                                             .tobytes()),
                                _fingerprint(np.float64(rate).tobytes())]
                        sgen = np.random.Generator(np.random.PCG64(
                            np.random.SeedSequence(skey)))
                        if p95 is not None:
                            mu, sigma = lognormal_params(m, p95)
                            svc = sgen.lognormal(mu, sigma, size=n)
                        else:
                            svc = np.full(n, m)
                        svc_cache[ck] = svc
                    S[i, b, :n] = svc
    return A, S, cell_counts


def _sweep_pipeline_torch(dag: WorkflowDAG, topo: Sequence[int], sink: int,
                          rung_cfgs: Sequence[Tuple[int, ...]],
                          rates: Sequence[float],
                          traces: Sequence[Sequence[np.ndarray]], *,
                          slo_s: float, seed: int, device: torch.device):
    """Batched device evaluation of the pipeline sweep.

    The host draws (:func:`_pipeline_draws`) go to ``device`` once, in the
    kernels' (N, B) and (J, N, B) layouts; the whole stage network runs
    there (:func:`repro_torch.serving.fastsim._pipeline_grid`); only the
    sink's completions come back.  Per-cell statistics are taken on the
    host with the reference loop's exact numpy calls and accumulation order
    (non-interpolated p95 via ``np.partition``), so the grids are bit-equal
    to ``backend="numpy"``."""
    from .fastsim import _pipeline_grid

    R, L, K = len(traces), len(rates), len(rung_cfgs)
    A, S, cell_counts = _pipeline_draws(dag, topo, rung_cfgs, rates, traces,
                                        seed=seed)
    At = torch.from_numpy(A).to(device).t().contiguous()
    St = torch.from_numpy(S).to(device).transpose(1, 2).contiguous()
    sink_pos = list(topo).index(sink)
    sink_comp = _pipeline_grid(
        At, St, torch.from_numpy(cell_counts),
        _pipeline_topo_meta(dag, topo),
        out_pos=(sink_pos,))[sink_pos].t().cpu().numpy()   # (B, N_max)

    lat_sum = np.zeros((K, L))
    p95_acc = np.zeros((K, L))
    ok = np.zeros((K, L))
    total = 0
    for r in range(R):
        for l in range(L):
            n = traces[r][l].size
            for k in range(K):
                if n == 0:
                    ok[k, l] += 1.0
                    continue
                b = (r * K + k) * L + l
                lats = sink_comp[b, :n] - traces[r][l]
                lat_sum[k, l] += lats.mean()
                idx = int(0.95 * (n - 1))
                p95_acc[k, l] += np.partition(lats, idx)[idx]
                ok[k, l] += (lats <= slo_s).mean()
                total += n
    return lat_sum, p95_acc, ok, total


def _chain_dag(dag: WorkflowDAG, topo: Sequence[int], A: np.ndarray,
               services: Sequence[np.ndarray],
               servers: Sequence[int], *,
               backend: str = "numpy",
               device=None) -> np.ndarray:
    """Vectorized DAG chaining: run each topological stage through
    :func:`repro_torch.serving.fastsim.chained_lindley` (one stage at a
    time so joins can max their predecessors' completions).
    ``services[i]`` is the service stream of the i-th *topological* stage,
    consumed in that stage's dispatch order.  ``backend`` / ``device``
    forward to :func:`repro_torch.serving.fastsim.chained_lindley` per
    stage."""
    from .fastsim import chained_lindley

    comp = np.zeros((dag.num_stages, A.size))
    for i, j in enumerate(topo):
        pr = dag.predecessors(j)
        if not pr:
            arr_j = A
        elif len(pr) == 1:
            arr_j = comp[pr[0]]
        else:
            arr_j = np.max(np.stack([comp[p] for p in pr]), axis=0)
        comp[j] = chained_lindley(arr_j, [services[i]],
                                  num_servers=[servers[i]],
                                  backend=backend, device=device)[-1]
    return comp
