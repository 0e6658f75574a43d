"""Planner: deployment planning for a feasible set (paper §III-A, §V).

The Planner takes the feasible set F from COMPASS-V, profiles each
configuration's end-to-end latency on the target hardware H using
representative inputs from the dataset, constructs the Pareto front over
(accuracy, latency), and derives AQM switching policies for the latency SLO.
Task optimization is hardware-independent and reusable; only this stage
re-runs when the deployment target changes.

Switching-policy validation (§V): :meth:`Planner.validate` stress-tests a
derived plan by replaying every ladder rung against a grid of arrival
rates via the batched sweep
(:func:`repro_torch.serving.fastsim.simulate_batch` — R replications x K
rungs x L loads as one grid, whose recursion runs in the port's CUDA
kernel), comparing simulated waits against the
Allen-Cunneen M/G/c prediction each threshold was derived from and
reporting the per-rung SLO-compliance surface.  At fast-path throughput
this makes thousands of validation scenarios per plan affordable.

The port of ``repro/core/planner.py``: :meth:`Planner.plan`,
:meth:`Planner.validate`, :class:`DeploymentPlan` and
:class:`PlanValidation`.  The pipeline planner (``plan_pipeline``,
``validate_pipeline``) needs the workflow-DAG sweep and is not ported yet.
"""

from __future__ import annotations

import dataclasses
import math
import statistics
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .aqm import (
    AQMPolicyTable,
    HysteresisSpec,
    MixPolicyTable,
    derive_degraded_tables,
    derive_mix_policies,
    derive_policies,
)
from .pareto import (
    BatchProfile,
    LatencyProfile,
    ParetoPoint,
    fit_batch_profile,
    pareto_front,
    thin_front,
)
from .space import Config


class LatencyProfiler:
    """Protocol-ish: callable returning per-request service-time samples (s)
    for a configuration on the target hardware."""

    def __call__(self, config: Config, num_samples: int) -> Sequence[float]:  # pragma: no cover
        raise NotImplementedError


def summarize_latencies(samples: Sequence[float]) -> LatencyProfile:
    xs = sorted(float(s) for s in samples)
    if not xs:
        raise ValueError("no latency samples")
    if any(x <= 0 for x in xs):
        raise ValueError("latency samples must be positive")

    def pct(q: float) -> float:
        if len(xs) == 1:
            return xs[0]
        pos = q * (len(xs) - 1)
        lo = int(math.floor(pos))
        hi = min(lo + 1, len(xs) - 1)
        frac = pos - lo
        return xs[lo] * (1 - frac) + xs[hi] * frac

    return LatencyProfile(
        mean=sum(xs) / len(xs),
        p95=pct(0.95),
        p50=pct(0.50),
        std=statistics.pstdev(xs) if len(xs) > 1 else 0.0,
        samples=len(xs),
    )


@dataclass
class DeploymentPlan:
    """Planner output: the Pareto front plus switching policies (the 'ordered
    set of configurations with their accuracy, latency profiles, and switching
    policies' of §III-A)."""

    front: Tuple[ParetoPoint, ...]
    table: AQMPolicyTable
    profiled: Dict[Config, LatencyProfile]
    dominated: Tuple[ParetoPoint, ...]
    mix_table: Optional[MixPolicyTable] = None
    # degradation-aware adaptation (beyond-paper): {c': table} for every
    # surviving capacity c' in 1..num_servers, pre-derived so the runtime
    # can re-anchor thresholds the instant a worker is lost
    # (:func:`repro.core.aqm.derive_degraded_tables`).  None for c = 1
    # plans — there is no smaller capacity to degrade to.
    degraded_tables: Optional[Dict[int, AQMPolicyTable]] = None

    def controller(self, **kwargs) -> "ElasticoController":  # noqa: F821
        """Build the runtime controller for this plan, degradation-aware
        whenever the plan carries degraded tables."""
        from .elastico import ElasticoController

        return ElasticoController(self.table,
                                  degraded_tables=self.degraded_tables,
                                  **kwargs)

    def describe(self) -> str:
        batch = (f", in-worker batching B = {self.table.max_batch_size}"
                 if self.table.max_batch_size > 1 else "")
        lines = [
            f"SLO p95 = {self.table.slo_p95_s * 1e3:.0f} ms, "
            f"c = {self.table.num_servers} server(s){batch}, "
            f"ladder of {self.table.ladder_size} configs "
            f"({len(self.dominated)} dominated, {len(self.table.excluded)} infeasible for SLO)"
        ]
        for pol in self.table.policies:
            p = pol.point
            lines.append(
                f"  [{pol.index}] acc={p.accuracy:.3f} mean={p.profile.mean * 1e3:.1f}ms "
                f"p95={p.profile.p95 * 1e3:.1f}ms N_up={pol.upscale_threshold} "
                f"N_dn={pol.downscale_threshold}"
            )
        if self.mix_table is not None:
            lines.append(
                f"  mix ladder: {self.mix_table.ladder_size} states "
                f"(one-worker shifts, Allen-Cunneen M/G/c thresholds; "
                f"admission re-route cap N={self.mix_table.reroute_threshold})"
            )
            for mp in self.mix_table.policies:
                lines.append(
                    f"    [{mp.index}] {list(mp.assignment)} "
                    f"mu={mp.drain_rate_qps:.1f}/s scv={mp.scv:.2f} "
                    f"acc~{mp.expected_accuracy:.3f} N_up={mp.upscale_threshold} "
                    f"N_dn={mp.downscale_threshold} N_steal={mp.steal_threshold}"
                )
        if self.degraded_tables is not None:
            lines.append(
                f"  degraded ladders: thresholds pre-derived for "
                f"c' = 1..{self.table.num_servers} (capacity-loss "
                f"re-anchoring via on_capacity_change)"
            )
        return "\n".join(lines)


@dataclass(frozen=True)
class PlanValidation:
    """Result of :meth:`Planner.validate`: replication-averaged metric
    grids, one row per ladder rung (K) and one column per arrival rate
    (L).  ``predicted_wait_s`` is the Allen-Cunneen M/G/c wait the
    switching thresholds were derived from; ``wait_model_error`` is the
    relative |simulated - predicted| / predicted where the prediction is
    finite and positive (unstable cells report ``inf`` prediction and are
    excluded from the summary)."""

    arrival_rates_qps: Tuple[float, ...]
    replications: int
    duration_s: float
    slo_p95_s: float
    mean_wait_s: Tuple[Tuple[float, ...], ...]          # (K, L)
    p95_latency_s: Tuple[Tuple[float, ...], ...]
    slo_compliance: Tuple[Tuple[float, ...], ...]
    predicted_wait_s: Tuple[Tuple[float, ...], ...]
    num_requests: int

    def wait_model_error(self) -> float:
        """Max relative error of the Allen-Cunneen wait model over stable
        cells with a meaningful predicted wait (> 1 ms)."""
        worst = 0.0
        for sim_row, pred_row in zip(self.mean_wait_s, self.predicted_wait_s):
            for sim, pred in zip(sim_row, pred_row):
                if math.isfinite(pred) and pred > 1e-3:
                    worst = max(worst, abs(sim - pred) / pred)
        return worst

    def compliant_rungs(self, rate_qps: float, *,
                        target: float = 0.95) -> List[int]:
        """Ladder rungs whose replication-mean compliance meets ``target``
        at the given arrival rate (must be one of the validated rates)."""
        l = self.arrival_rates_qps.index(rate_qps)
        return [k for k, row in enumerate(self.slo_compliance)
                if row[l] >= target]

    def describe(self) -> str:
        lines = [
            f"validated {len(self.mean_wait_s)} rungs x "
            f"{len(self.arrival_rates_qps)} rates x "
            f"{self.replications} replications "
            f"({self.num_requests} simulated requests, "
            f"wait-model max rel err {self.wait_model_error():.2f})"
        ]
        for k, comp_row in enumerate(self.slo_compliance):
            cells = " ".join(
                f"{rate:g}/s:{comp:.2f}"
                for rate, comp in zip(self.arrival_rates_qps, comp_row))
            lines.append(f"  rung {k}: compliance {cells}")
        return "\n".join(lines)


@dataclass
class Planner:
    """Profiles feasible configurations and derives the switching plan.

    Parameters
    ----------
    profiler: measures per-request service times for a config on hardware H.
    profile_samples: number of representative requests per configuration.
    slack_buffer_s: h_s in Eq. 13.
    hysteresis: asymmetric cooldown spec (§V-F).
    num_servers: worker-pool size c the deployment will run with; switching
        thresholds are derived for the M/G/c drain rate (c = 1 reproduces
        the paper's single-server plan exactly).
    heterogeneous: also derive the per-worker mix ladder
        (:func:`repro.core.aqm.derive_mix_policies`) into
        ``DeploymentPlan.mix_table``, feeding the Allen-Cunneen M/G/c model
        with the service-time SCV the profiler measured per configuration.
        Defaults to deriving mixes whenever the pool has more than one
        worker (a c = 1 mix ladder is just the homogeneous ladder).
    max_batch_size: per-worker batch cap B the deployment will serve with;
        B > 1 makes every derived threshold batch-aware
        (:func:`repro.core.aqm.batch_expected_wait`).  1 (the default)
        reproduces the unbatched plan bit-for-bit.
    batch_profiler: measures the batch-service law on hardware H —
        ``(config, batch_size, num_samples) -> per-batch total service
        times`` (seconds).  When given (and B > 1), the Planner measures
        each kept configuration at batch sizes 1, 2, 4, ... up to B, fits
        ``alpha + beta * b`` by least squares
        (:func:`repro.core.pareto.fit_batch_profile`), and attaches the
        law to the configuration's profile
        (:attr:`repro.core.pareto.LatencyProfile.batch_profile`).  Without
        it, unmeasured configs fall back to the no-amortization law and
        batching changes no threshold.
    """

    profiler: Callable[[Config, int], Sequence[float]]
    profile_samples: int = 40
    slack_buffer_s: float = 0.050
    min_accuracy_gap: float = 0.01
    hysteresis: HysteresisSpec = field(default_factory=HysteresisSpec)
    num_servers: int = 1
    heterogeneous: Optional[bool] = None
    max_batch_size: int = 1
    batch_profiler: Optional[Callable[[Config, int, int], Sequence[float]]] = None
    batch_profile_samples: int = 8

    def _measure_batch_profile(self, config: Config) -> BatchProfile:
        """Fit the alpha + beta * b law from measured batch service times at
        doubling batch sizes 1, 2, 4, ... capped at ``max_batch_size``."""
        assert self.batch_profiler is not None
        sizes: List[int] = []
        b = 1
        while b < self.max_batch_size:
            sizes.append(b)
            b *= 2
        sizes.append(self.max_batch_size)
        obs_sizes: List[int] = []
        obs_times: List[float] = []
        for b in sizes:
            samples = self.batch_profiler(config, b, self.batch_profile_samples)
            for t in samples:
                obs_sizes.append(b)
                obs_times.append(float(t))
        return fit_batch_profile(obs_sizes, obs_times)

    def plan(
        self,
        feasible: Dict[Config, float],
        *,
        slo_p95_s: float,
    ) -> DeploymentPlan:
        if not feasible:
            raise ValueError("empty feasible set: nothing to plan")
        profiled: Dict[Config, LatencyProfile] = {}
        points: List[ParetoPoint] = []
        for config, acc in feasible.items():
            prof = summarize_latencies(self.profiler(config, self.profile_samples))
            profiled[config] = prof
            points.append(ParetoPoint(config=config, accuracy=acc, profile=prof))

        front = thin_front(pareto_front(points), min_accuracy_gap=self.min_accuracy_gap)
        # identify dominated/thinned points for reporting
        front_keys = {(p.config) for p in front}
        dominated = tuple(p for p in points if p.config not in front_keys)

        # batch laws are consumed only by threshold derivation, so they are
        # measured only for the kept rungs — after Pareto/thinning has
        # discarded the dominated configs (each measurement is a run of real
        # batch executions on hardware H; don't pay for losers).
        if self.batch_profiler is not None and self.max_batch_size > 1:
            measured: List[ParetoPoint] = []
            for p in front:
                prof = dataclasses.replace(
                    p.profile,
                    batch_profile=self._measure_batch_profile(p.config))
                profiled[p.config] = prof
                measured.append(dataclasses.replace(p, profile=prof))
            front = measured

        table = derive_policies(
            front,
            slo_p95_s=slo_p95_s,
            slack_buffer_s=self.slack_buffer_s,
            hysteresis=self.hysteresis,
            num_servers=self.num_servers,
            max_batch_size=self.max_batch_size,
        )
        want_mixes = (
            self.heterogeneous
            if self.heterogeneous is not None
            else self.num_servers > 1
        )
        mix_table: Optional[MixPolicyTable] = None
        if want_mixes:
            mix_table = derive_mix_policies(
                front,
                slo_p95_s=slo_p95_s,
                slack_buffer_s=self.slack_buffer_s,
                hysteresis=self.hysteresis,
                num_servers=self.num_servers,
                max_batch_size=self.max_batch_size,
            )
        degraded: Optional[Dict[int, AQMPolicyTable]] = None
        if self.num_servers > 1:
            # pre-derive the degraded-capacity family so the runtime can
            # re-anchor thresholds the instant a worker is lost; c' == c
            # repeats the derive_policies call above (identical thresholds
            # by construction — full capacity behaves exactly as planned)
            degraded = derive_degraded_tables(
                front,
                slo_p95_s=slo_p95_s,
                slack_buffer_s=self.slack_buffer_s,
                hysteresis=self.hysteresis,
                num_servers=self.num_servers,
                max_batch_size=self.max_batch_size,
            )
        return DeploymentPlan(
            front=tuple(front),
            table=table,
            profiled=profiled,
            dominated=dominated,
            mix_table=mix_table,
            degraded_tables=degraded,
        )

    def validate(
        self,
        plan: DeploymentPlan,
        *,
        arrival_rates_qps: Optional[Sequence[float]] = None,
        load_fractions: Sequence[float] = (0.5, 0.75, 0.9),
        duration_s: float = 120.0,
        replications: int = 8,
        seed: int = 0,
        backend: str = "torch",
        device=None,
    ) -> PlanValidation:
        """Validate a derived plan's switching ladder against simulation.

        Replays every admitted rung (statically pinned, the regime each
        AQM threshold is stated in) against a grid of Poisson arrival
        rates — by default ``load_fractions`` of the *fastest* rung's pool
        drain rate ``c / s-bar_0``, the range the switching ladder is
        supposed to cover — with R stochastic replications, evaluated in
        one vectorized batched sweep
        (:func:`repro.serving.fastsim.simulate_batch`).  Returns the
        replication-averaged wait / p95 / compliance grids next to the
        Allen-Cunneen predictions, so a plan whose queueing model is off
        (or whose SLO is infeasible at the loads it claims to cover) is
        caught *offline*, before deployment.

        ``backend`` and ``device`` are forwarded to the sweep engine:
        ``"torch"`` (default) runs the recursion in the port's kernel on
        ``device`` (None is the CUDA card, and raises without one);
        ``"numpy"`` runs the reference loop on the host.  The latency
        grids agree bit for bit across the two.
        """
        from ..serving.fastsim import simulate_batch
        from .aqm import allen_cunneen_mean_wait

        ladder = plan.table.policies
        if not ladder:
            raise ValueError("plan has no admitted rungs to validate")
        means = [pol.point.profile.mean for pol in ladder]
        p95s = [pol.point.profile.p95 for pol in ladder]
        scvs = [pol.point.profile.scv for pol in ladder]
        c = self.num_servers
        if arrival_rates_qps is None:
            cap = c / means[0]
            arrival_rates_qps = [f * cap for f in load_fractions]
        rates = [float(r) for r in arrival_rates_qps]

        sweep = simulate_batch(
            means,
            p95s,
            arrival_rates_qps=rates,
            duration_s=duration_s,
            num_servers=c,
            replications=replications,
            slo_s=plan.table.slo_p95_s,
            seed=seed,
            backend=backend,
            device=device,
        )
        grids = sweep.over_replications()
        predicted = tuple(
            tuple(
                allen_cunneen_mean_wait(c, rate, m, scv_service=scv)
                for rate in rates
            )
            for m, scv in zip(means, scvs)
        )
        return PlanValidation(
            arrival_rates_qps=tuple(rates),
            replications=replications,
            duration_s=duration_s,
            slo_p95_s=plan.table.slo_p95_s,
            mean_wait_s=tuple(map(tuple, grids["mean_wait_s"])),
            p95_latency_s=tuple(map(tuple, grids["p95_latency_s"])),
            slo_compliance=tuple(map(tuple, grids["slo_compliance"])),
            predicted_wait_s=predicted,
            num_requests=sweep.total_requests,
        )
