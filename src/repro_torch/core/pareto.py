"""Pareto-front construction over (accuracy, latency) (paper §III-A, §V-A).

The Planner profiles each feasible configuration on target hardware and keeps
only configurations that are not dominated on both dimensions; the resulting
front is ordered by increasing service time, which by Pareto-optimality implies
increasing accuracy (Eq. 4: s0 < s1 < ... < sn  =>  a0 < a1 < ... < an).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .space import Config


@dataclass(frozen=True)
class BatchProfile:
    """Measured batch-service law: a batch of ``b`` requests takes

        S(b) = alpha + beta * b        seconds

    where ``alpha`` is the fixed per-dispatch overhead (kernel launches,
    prefill setup, scheduling) amortized across the batch and ``beta`` the
    marginal per-request service time.  Batching pays off exactly when
    ``alpha`` is a large fraction of the single-request time: per-request
    service falls from ``alpha + beta`` at b = 1 toward ``beta`` as b grows.
    Fit from measurements with :func:`fit_batch_profile`; consumed by the
    batch-aware queueing model (:func:`repro.core.aqm.batch_expected_wait`,
    :func:`repro.core.aqm.batch_mean_wait`).
    """

    alpha: float       # fixed per-dispatch overhead (seconds)
    beta: float        # marginal per-request service time (seconds)

    def __post_init__(self) -> None:
        if self.alpha < 0 or self.beta < 0:
            raise ValueError(f"batch profile terms must be >= 0, got {self}")
        if self.alpha + self.beta <= 0:
            raise ValueError("degenerate batch profile: S(1) must be positive")

    def service_time(self, batch_size: int) -> float:
        """Total service time of one batch of ``batch_size`` requests.
        (b = 1 is bit-identical to ``alpha + beta``: multiplying by the
        exact integer 1 is exact, so unbatched paths collapse exactly.)"""
        if batch_size < 1:
            raise ValueError("batch size must be >= 1")
        return self.alpha + self.beta * batch_size

    def per_request_time(self, batch_size: int) -> float:
        """Amortized per-request service time S(b) / b."""
        return self.service_time(batch_size) / batch_size

    def speedup(self, batch_size: int) -> float:
        """Throughput gain of batch size b over unbatched service:
        ``b * S(1) / S(b)``."""
        return batch_size * self.service_time(1) / self.service_time(batch_size)


def fit_batch_profile(batch_sizes: Sequence[int],
                      batch_times: Sequence[float]) -> BatchProfile:
    """Least-squares fit of the ``alpha + beta * b`` law to measured
    (batch size, total batch service time) pairs.

    Negative intercepts/slopes (measurement noise on a nearly flat law) are
    clamped to zero so the fitted profile stays physically meaningful.
    """
    if len(batch_sizes) != len(batch_times) or not batch_sizes:
        raise ValueError("need matching, non-empty batch sizes and times")
    if any(b < 1 for b in batch_sizes):
        raise ValueError("batch sizes must be >= 1")
    if any(t <= 0 for t in batch_times):
        raise ValueError("batch service times must be positive")
    n = len(batch_sizes)
    if n == 1 or len(set(batch_sizes)) == 1:
        # one size observed: attribute everything to the marginal term
        b0 = batch_sizes[0]
        return BatchProfile(alpha=0.0, beta=sum(batch_times) / n / b0)
    mean_b = sum(batch_sizes) / n
    mean_t = sum(batch_times) / n
    sxx = sum((b - mean_b) ** 2 for b in batch_sizes)
    sxy = sum((b - mean_b) * (t - mean_t)
              for b, t in zip(batch_sizes, batch_times))
    beta = max(0.0, sxy / sxx)
    alpha = max(0.0, mean_t - beta * mean_b)
    # alpha + beta > 0 always: times are validated positive, so mean_t > 0,
    # and alpha = 0 can only happen when beta >= mean_t / mean_b > 0.
    return BatchProfile(alpha=alpha, beta=beta)


@dataclass(frozen=True)
class LatencyProfile:
    """Per-configuration latency statistics measured on target hardware H.

    The paper records percentile-based profiles for LLM components (latency
    varies with input/output length) and means for traditional components; at
    the workflow level we keep mean and P95 of end-to-end service time.

    ``batch_profile`` optionally carries the measured batch-service law
    (:class:`BatchProfile`, service time ``alpha + beta * b`` for a batch of
    ``b``) for configurations profiled under in-worker batching; ``None``
    means unmeasured, in which case the queueing model assumes batching buys
    nothing (``alpha = 0``, ``beta = mean`` — see
    :meth:`effective_batch_profile`).
    """

    mean: float        # s-bar_k: mean service time (seconds)
    p95: float         # s_95,k: tail service time (seconds)
    p50: float = 0.0
    std: float = 0.0
    samples: int = 0
    batch_profile: Optional[BatchProfile] = None

    def __post_init__(self) -> None:
        if self.mean <= 0 or self.p95 <= 0:
            raise ValueError(f"latency profile must be positive, got {self}")
        if self.p95 + 1e-12 < self.mean * 0.5:
            raise ValueError("implausible profile: p95 far below mean/2")

    def effective_batch_profile(self) -> BatchProfile:
        """The measured batch law, or the no-amortization fallback
        ``BatchProfile(alpha=0, beta=mean)`` when batching was never
        profiled.  The fallback makes every batch-aware formula collapse to
        its unbatched counterpart: ``S(b) = mean * b`` drains at the same
        per-request rate for every ``b``."""
        if self.batch_profile is not None:
            return self.batch_profile
        return BatchProfile(alpha=0.0, beta=self.mean)

    @property
    def scv(self) -> float:
        """Squared coefficient of variation C_s^2 = (std / mean)^2 of the
        measured service times — the dispersion input of the Allen-Cunneen
        M/G/c wait approximation (:func:`repro.core.aqm.allen_cunneen_mean_wait`).

        Profiles built without samples (synthetic ladders, ``samples == 0``)
        fall back to 1.0, the exponential/M-service assumption, under which
        Allen-Cunneen collapses exactly to Erlang-C.
        """
        if self.samples > 1:
            return (self.std / self.mean) ** 2
        return 1.0


@dataclass(frozen=True)
class ParetoPoint:
    config: Config
    accuracy: float
    profile: LatencyProfile
    meta: Tuple[Tuple[str, Any], ...] = ()

    @property
    def mean_latency(self) -> float:
        return self.profile.mean

    @property
    def p95_latency(self) -> float:
        return self.profile.p95


def pareto_front(points: Sequence[ParetoPoint]) -> List[ParetoPoint]:
    """Keep non-dominated points (maximize accuracy, minimize mean latency),
    returned ordered by increasing service time (Eq. 4).

    A point is dominated if some other point has (accuracy >=, latency <=)
    with at least one strict inequality.  Ties on both axes keep the first.
    """
    ordered = sorted(points, key=lambda p: (p.profile.mean, -p.accuracy))
    front: List[ParetoPoint] = []
    best_acc = float("-inf")
    seen: set = set()
    for p in ordered:
        key = (round(p.profile.mean, 12), round(p.accuracy, 12))
        if key in seen:
            continue
        if p.accuracy > best_acc:
            front.append(p)
            best_acc = p.accuracy
            seen.add(key)
    return front


def thin_front(
    front: Sequence[ParetoPoint],
    *,
    min_accuracy_gap: float = 0.0,
) -> List[ParetoPoint]:
    """Thin a dense Pareto front to operationally distinct rungs.

    Real fronts contain near-duplicate points (accuracy within noise at
    nearly identical latency).  Switching between them buys nothing and
    bloats the policy ladder, so the Planner keeps a point only when it
    improves accuracy by at least ``min_accuracy_gap`` over the previous kept
    rung.  The fastest point is always kept; the most accurate point is
    always kept so the ladder's top rung remains the true quality optimum.
    """
    if not front:
        return []
    kept: List[ParetoPoint] = [front[0]]
    for p in front[1:-1]:
        if p.accuracy - kept[-1].accuracy >= min_accuracy_gap:
            kept.append(p)
    if len(front) > 1:
        top = front[-1]
        if top.accuracy > kept[-1].accuracy:
            kept.append(top)
        elif len(kept) > 1 and top.accuracy <= kept[-1].accuracy:
            pass
    return kept


def validate_front(front: Sequence[ParetoPoint]) -> None:
    """Assert the paper's ladder invariants (Eq. 4 and the implied accuracy
    ordering): strictly increasing service time and accuracy."""
    for a, b in zip(front, front[1:]):
        if not b.profile.mean > a.profile.mean:
            raise AssertionError("front not strictly increasing in mean latency")
        if not b.accuracy > a.accuracy:
            raise AssertionError("front not strictly increasing in accuracy")
