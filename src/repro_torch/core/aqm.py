"""AQM: analytical queuing-theory model for switching policies (paper §V).

The inference server bank is modeled as an M/G/c FIFO queue with ``c >= 1``
identical servers (workers); ``c = 1`` is the paper's M/G/1 and the default.
Pareto-front configurations are ordered by increasing service time (Eq. 4).
For a P95 latency SLO ``L``:

  queuing slack      Delta_k = L - s95_k                          (Eq. 7)
  upscale threshold  N_k(up) = floor(c * Delta_k / s-bar_k)       (Eq. 10)
  downscale thresh.  N_k(dn) = floor(c * (Delta_{k+1} - h_s) / s-bar_{k+1})
                                                                  (Eq. 13)

The ``c`` factor generalizes Eq. 8: with every server busy, departures occur
at aggregate rate c / s-bar_k, so a buffered depth of N implies an expected
wait of E[W] = N * s-bar_k / c.  For c = 1 all thresholds collapse exactly
to the paper's M/G/1 values.  The Erlang-C formula (:func:`erlang_c`,
:func:`erlang_c_mean_wait`) supplies the stationary M/M/c waiting-time
prediction used for capacity reporting and validation of the simulator;
:func:`allen_cunneen_mean_wait` extends it to general (heavy-tailed) service
via the squared coefficient of variation measured by the profiler, with
SCV = 1 (exponential service) reproducing Erlang-C exactly.

Heterogeneous pools (beyond-paper): instead of one globally active
configuration, each of the c workers can be *pinned* to its own Pareto rung.
:func:`mix_ladder` enumerates assignment vectors that differ by one worker
between adjacent states, :func:`derive_mix_policies` derives queue-depth
thresholds per mix state (Allen-Cunneen-corrected aggregate drain), and
:func:`mix_mean_wait` predicts the stationary wait of a mix under a given
arrival rate.  An all-same-config mix with SCV = 1 reproduces the
homogeneous Eq. 10 thresholds exactly.

In-worker batching (beyond-paper): workers may drain up to ``B`` requests
per dequeue and serve them as one batch whose service time follows the
measured law S(b) = alpha + beta * b
(:class:`repro.core.pareto.BatchProfile`).  Deeper queues then *increase*
the effective drain rate — a backlog of N lets each worker form batches of
b(N) = min(B, ceil(N / c)) — so :func:`batch_expected_wait` generalizes
Eq. 8 and the thresholds of :func:`derive_policies` /
:func:`derive_mix_policies` shift outward when ``max_batch_size > 1``.
:func:`batch_mean_wait` is the stationary companion (batch-service M/G/c);
at B = 1 every batch-aware formula collapses to its unbatched counterpart
bit-for-bit.

Configurations with Delta_k <= 0 cannot satisfy the SLO and are excluded.
Asymmetric temporal hysteresis (§V-F): upscale cooldown ~0 (react to spikes
immediately), downscale cooldown ~seconds (require sustained low load).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, Optional, Sequence, Tuple

from .pareto import BatchProfile, ParetoPoint


@dataclass(frozen=True)
class SwitchingPolicy:
    """Per-configuration switching thresholds on the Pareto ladder.

    Index k runs from 0 (fastest, least accurate) to n (slowest, most
    accurate), matching the paper's ordering s_0 < s_1 < ... < s_n.
    ``upscale_threshold[k]`` is N_k(up): max safe queue depth under config k;
    when queue depth exceeds it the controller must move *down* the ladder to
    the faster config k-1 ("upscale" in the paper = scale capacity up by
    choosing a faster configuration).
    ``downscale_threshold[k]`` is N_k(dn): when depth falls below it, config
    k+1 (slower, more accurate) can absorb the current queue, so the
    controller may move up the accuracy ladder.
    """

    point: ParetoPoint
    index: int
    queuing_slack: float            # Delta_k (seconds)
    upscale_threshold: int          # N_k(up)
    downscale_threshold: Optional[int]   # N_k(dn); None for the most accurate config


@dataclass(frozen=True)
class HysteresisSpec:
    """Asymmetric temporal hysteresis (paper §V-F)."""

    upscale_cooldown_s: float = 0.0      # t(up): react immediately to spikes
    downscale_cooldown_s: float = 5.0    # t(dn): sustained low load required

    def __post_init__(self) -> None:
        if self.upscale_cooldown_s < 0 or self.downscale_cooldown_s < 0:
            raise ValueError("cooldowns must be non-negative")


@dataclass(frozen=True)
class AQMPolicyTable:
    """Complete switching policy for a Pareto front under one latency SLO.

    ``num_servers`` is the server count c the thresholds were derived for;
    the controller's observed queue depth must be the *buffered* depth
    (requests waiting for service, excluding the up-to-c in service) for the
    thresholds to mean what Eq. 10/13 say.
    """

    slo_p95_s: float                 # L
    slack_buffer_s: float            # h_s
    policies: Tuple[SwitchingPolicy, ...]   # index 0 = fastest
    hysteresis: HysteresisSpec
    excluded: Tuple[ParetoPoint, ...] = ()  # Delta_k <= 0 (cannot meet SLO)
    num_servers: int = 1             # c
    max_batch_size: int = 1          # B the thresholds were derived for

    @property
    def ladder_size(self) -> int:
        return len(self.policies)

    def policy(self, k: int) -> SwitchingPolicy:
        return self.policies[k]


def _batch_drain_threshold(budget_s: float, batch: BatchProfile,
                           num_servers: int, max_batch_size: int) -> int:
    """Largest buffered depth N such that *every* depth n <= N drains within
    ``budget_s`` under the batch-aware wait (:func:`batch_expected_wait`).

    The wait n * S(b(n)) / (c * b(n)) with b(n) = min(B, ceil(n / c)) is
    piecewise linear: segment b covers c*(b-1) < n <= c*b, and within it
    the wait rises linearly to S(b) at the segment end.  The scan walks the
    segments upward; the first segment that is not safe all the way to its
    end bounds the threshold.  Deeper segments can drain faster again
    (batch formation needs backlog), but an upscale threshold must
    guarantee the whole region at or below it — otherwise Elastico would
    hold at a shallow depth whose modeled wait already blows the slack.
    At B = 1 this is exactly Eq. 10's floor(c * Delta / s-bar).
    """
    if budget_s <= 0:
        return 0
    c = num_servers
    for b in range(1, max_batch_size + 1):
        n_b = int(math.floor(budget_s * c * b / batch.service_time(b)))
        if b == max_batch_size or n_b < c * b:
            return max(0, n_b)
    return 0


def derive_policies(
    front: Sequence[ParetoPoint],
    *,
    slo_p95_s: float,
    slack_buffer_s: float = 0.050,
    hysteresis: HysteresisSpec = HysteresisSpec(),
    num_servers: int = 1,
    max_batch_size: int = 1,
    batch_profiles: Optional[Sequence[Optional[BatchProfile]]] = None,
) -> AQMPolicyTable:
    """Build the AQM policy table for a Pareto front (paper §V-C..F).

    ``front`` must be ordered by increasing mean service time (the Planner
    guarantees this via :func:`repro.core.pareto.pareto_front`).

    ``num_servers`` is the server count c of the worker pool the policies
    will drive.  Thresholds scale linearly with c (Eq. 10/13 with aggregate
    drain rate c / s-bar); ``num_servers=1`` reproduces the paper's M/G/1
    thresholds exactly.

    ``max_batch_size`` is the per-worker batch cap B of the serving runtime.
    With B > 1 the drain estimate becomes batch-aware
    (:func:`batch_expected_wait`): a deeper queue lets workers form larger
    batches and drain *faster* per request, so every threshold shifts
    outward relative to the unbatched Eq. 10/13 values.  ``batch_profiles``
    optionally overrides the per-config batch-service law (default: each
    profile's measured :attr:`repro.core.pareto.LatencyProfile.batch_profile`,
    falling back to the no-amortization law ``S(b) = s-bar * b`` — under
    which batching changes no threshold).  ``max_batch_size=1`` evaluates
    the identical floating-point expressions as the unbatched derivation and
    reproduces it bit-for-bit.
    """
    if slo_p95_s <= 0:
        raise ValueError("SLO must be positive")
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    for a, b in zip(front, front[1:]):
        if not b.profile.mean > a.profile.mean:
            raise ValueError("front must be ordered by increasing mean latency")

    # Eq. 7: exclude configurations whose tail service time alone breaks the SLO.
    admitted: List[ParetoPoint] = []
    excluded: List[ParetoPoint] = []
    for p in front:
        slack = slo_p95_s - p.profile.p95
        (admitted if slack > 0 else excluded).append(p)

    if batch_profiles is not None and len(batch_profiles) != len(front):
        raise ValueError("need one batch profile (or None) per front config")
    laws: dict = {}
    for i, p in enumerate(front):
        override = batch_profiles[i] if batch_profiles is not None else None
        laws[id(p)] = (override if override is not None
                       else p.profile.effective_batch_profile())

    def batch_for(p: ParetoPoint) -> BatchProfile:
        return laws[id(p)]

    c = num_servers
    policies: List[SwitchingPolicy] = []
    n = len(admitted)
    for k, p in enumerate(admitted):
        delta_k = slo_p95_s - p.profile.p95                       # Eq. 7
        if max_batch_size == 1:
            up = int(math.floor(c * delta_k / p.profile.mean))    # Eq. 10
        else:
            up = _batch_drain_threshold(delta_k, batch_for(p), c, max_batch_size)
        down: Optional[int] = None
        if k + 1 < n:
            nxt = admitted[k + 1]
            delta_next = slo_p95_s - nxt.profile.p95
            budget = max(0.0, delta_next - slack_buffer_s)
            if max_batch_size == 1:
                down = int(math.floor(c * budget / nxt.profile.mean))  # Eq. 13
            else:
                down = _batch_drain_threshold(budget, batch_for(nxt), c,
                                              max_batch_size)
        policies.append(
            SwitchingPolicy(
                point=p,
                index=k,
                queuing_slack=delta_k,
                upscale_threshold=max(0, up),
                downscale_threshold=down,
            )
        )

    # Eq. 11 sanity: faster configurations tolerate larger queues.  This holds
    # whenever mean service times dominate the p95 spread; warn-level check
    # only (real profiles can mildly violate it when p95/mean ratios differ).
    return AQMPolicyTable(
        slo_p95_s=slo_p95_s,
        slack_buffer_s=slack_buffer_s,
        policies=tuple(policies),
        hysteresis=hysteresis,
        excluded=tuple(excluded),
        num_servers=num_servers,
        max_batch_size=max_batch_size,
    )


def ladder_is_monotone(table: AQMPolicyTable) -> bool:
    """Check Eq. 11: N_0(up) > N_1(up) > ... > N_n(up)."""
    ups = [p.upscale_threshold for p in table.policies]
    return all(a > b for a, b in zip(ups, ups[1:]))


def expected_wait(queue_depth: int, mean_service_s: float,
                  num_servers: int = 1) -> float:
    """Eq. 8 generalized to c servers: E[W] = N * s-bar_k / c — with every
    server busy, departures free slots at aggregate rate c / s-bar_k (exact
    for deterministic service, mean as a proxy for the P95 otherwise)."""
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    return queue_depth * mean_service_s / num_servers


def max_sustainable_rate(policy: SwitchingPolicy, num_servers: int = 1,
                         max_batch_size: int = 1,
                         batch_profile: Optional[BatchProfile] = None) -> float:
    """Utilization bound for config k: the M/G/c queue is stable only when
    lambda < c / s-bar_k; beyond it the queue grows without bound and the
    upscale threshold will trip.  Used by the Planner for reporting.

    With in-worker batching (``max_batch_size = B > 1``) each worker drains
    B requests per S(B) seconds at full batch, so the bound rises to
    ``c * B / S(B)`` — roughly ``S(1)/beta``-fold when alpha dominates.
    ``batch_profile`` overrides the service law, mirroring the
    ``batch_profiles`` argument of :func:`derive_policies` (pass the same
    override you derived the table with, or the reported capacity will
    reflect the profile-attached/fallback law instead)."""
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    if max_batch_size == 1:
        return num_servers / policy.point.profile.mean
    batch = (batch_profile if batch_profile is not None
             else policy.point.profile.effective_batch_profile())
    return num_servers * max_batch_size / batch.service_time(max_batch_size)


# -- in-worker batching: batch-aware drain and stationary waits ----------------


def batch_expected_wait(queue_depth: int, batch: BatchProfile,
                        num_servers: int = 1,
                        max_batch_size: int = 1) -> float:
    """Eq. 8 generalized to batched service: at buffered depth N each of the
    c workers forms batches of b(N) = min(B, ceil(N / c)) from the backlog,
    so the queue drains at aggregate rate c * b(N) / S(b(N)) and

        E[W | N] ~= N * S(b(N)) / (c * b(N)).

    Deeper queues unlock larger batches, so the *per-request* drain time
    falls with depth until the cap B — the effect that shifts batch-aware
    switch-up thresholds outward.  ``max_batch_size = 1`` reproduces
    :func:`expected_wait` exactly (S(1) = s-bar for a profile-derived law).
    """
    if queue_depth < 0:
        raise ValueError("negative queue depth")
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    if queue_depth == 0:
        return 0.0
    b = min(max_batch_size,
            max(1, int(math.ceil(queue_depth / num_servers))))
    return queue_depth * batch.service_time(b) / (num_servers * b)


def batch_mean_wait(num_servers: int, arrival_rate_qps: float,
                    batch: BatchProfile, *,
                    max_batch_size: int = 1,
                    batch_timeout_s: float = 0.0,
                    scv_service: float = 1.0,
                    scv_arrival: float = 1.0) -> float:
    """Stationary mean wait of a batch-service M/G/c queue.

    The pool is modeled at its *equilibrium batch size* b_eq: the smallest
    b <= B at which the offered load is stable, ``lambda * S(b) / (c * b)
    < 1`` (light load serves singletons; overload pushes the system to the
    batch size that restores stability — full batches at worst).  Batches
    are then treated as the queue's customers — arrival rate ``lambda /
    b_eq``, service time ``S(b_eq)`` — and the batch-level wait is the
    Allen-Cunneen M/G/c approximation at those parameters, plus a
    batch-forming delay bounded by the linger window:

        E[W] ~= AC(c, lambda / b_eq, S(b_eq)) + min(t_linger, (B - 1) / (2 lambda))

    (a lingering worker holds a partial batch until it fills toward the cap
    B or the timeout ``batch_timeout_s`` expires, whichever first; a request
    lands uniformly within its forming batch, so it waits on average half
    the fill time).  With ``batch_timeout_s = 0`` the runtime dispatches
    greedily — batches form only from backlog — and the forming term is
    zero.  Returns ``inf`` when even full batches cannot absorb the load
    (lambda >= c * B / S(B)).

    Collapse: ``max_batch_size = 1`` evaluates
    :func:`allen_cunneen_mean_wait` at (c, lambda, S(1)) exactly — the
    unbatched M/G/c model, which itself equals Erlang-C at SCV = 1.
    """
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    if batch_timeout_s < 0:
        raise ValueError("batch_timeout_s must be >= 0")
    if arrival_rate_qps < 0:
        raise ValueError("arrival rate must be >= 0")
    if max_batch_size == 1:
        return allen_cunneen_mean_wait(
            num_servers, arrival_rate_qps, batch.service_time(1),
            scv_service=scv_service, scv_arrival=scv_arrival)
    if arrival_rate_qps == 0.0:
        return 0.0
    b_star = None
    for b in range(1, max_batch_size + 1):
        if arrival_rate_qps * batch.service_time(b) < num_servers * b:
            b_star = b
            break
    if b_star is None:
        return float("inf")
    base = allen_cunneen_mean_wait(
        num_servers, arrival_rate_qps / b_star, batch.service_time(b_star),
        scv_service=scv_service, scv_arrival=scv_arrival)
    if math.isinf(base):
        return base
    forming = 0.0
    if batch_timeout_s > 0.0:
        forming = min(batch_timeout_s,
                      (max_batch_size - 1) / (2.0 * arrival_rate_qps))
    return base + forming


# -- M/M/c stationary analysis (Erlang C) -------------------------------------


def erlang_c(num_servers: int, offered_load: float) -> float:
    """Erlang-C probability that an arrival must wait in an M/M/c queue.

    ``offered_load`` is a = lambda * s-bar (erlangs).  Computed via the
    numerically stable Erlang-B recursion B(k, a) = a B(k-1, a) / (k + a
    B(k-1, a)) and the standard B->C conversion.  Returns 1.0 when the
    system is saturated (a >= c: every arrival waits, queue unstable).
    """
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if offered_load < 0:
        raise ValueError("offered load must be non-negative")
    a = offered_load
    c = num_servers
    if a == 0.0:
        return 0.0
    if a >= c:
        return 1.0
    b = 1.0  # Erlang B with 0 servers
    for k in range(1, c + 1):
        b = a * b / (k + a * b)
    rho = a / c
    return b / (1.0 - rho + rho * b)


def erlang_c_mean_wait(num_servers: int, arrival_rate_qps: float,
                       mean_service_s: float) -> float:
    """Stationary mean queueing delay E[W] of an M/M/c queue.

    E[W] = C(c, a) * s-bar / (c - a) with a = lambda * s-bar.  Returns
    ``inf`` for a saturated system.  For c = 1 this is the familiar M/M/1
    result rho * s-bar / (1 - rho).
    """
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if arrival_rate_qps < 0 or mean_service_s <= 0:
        raise ValueError("rate must be >= 0 and mean service > 0")
    a = arrival_rate_qps * mean_service_s
    if a >= num_servers:
        return float("inf")
    pw = erlang_c(num_servers, a)
    return pw * mean_service_s / (num_servers - a)


# -- M/G/c stationary analysis (Allen-Cunneen) --------------------------------


def allen_cunneen_mean_wait(num_servers: int, arrival_rate_qps: float,
                            mean_service_s: float, *,
                            scv_service: float = 1.0,
                            scv_arrival: float = 1.0) -> float:
    """Allen-Cunneen approximation of the mean wait of a G/G/c queue.

      E[W_{G/G/c}] ~= (C_a^2 + C_s^2) / 2 * E[W_{M/M/c}]

    where ``scv_service`` is the squared coefficient of variation of service
    time (C_s^2 = Var[S] / E[S]^2, :attr:`repro.core.pareto.LatencyProfile.scv`
    as measured by the Planner's profiler) and ``scv_arrival`` the SCV of
    inter-arrival times (1.0 for the Poisson arrivals the AQM assumes, giving
    the M/G/c case).  The approximation is exact for M/M/c (both SCVs 1,
    where it *equals* :func:`erlang_c_mean_wait`) and for M/G/1 (where it
    reduces to Pollaczek-Khinchine).  LLM service times are heavy-tailed
    (SCV > 1), so the exponential model underestimates waits — this factor
    is what makes heterogeneous mix thresholds honest about the tail.
    """
    if scv_service < 0 or scv_arrival < 0:
        raise ValueError("squared coefficients of variation must be >= 0")
    base = erlang_c_mean_wait(num_servers, arrival_rate_qps, mean_service_s)
    if math.isinf(base):
        return base
    return 0.5 * (scv_arrival + scv_service) * base


# -- queueing networks: tandem stages and fork-join (workflow DAGs) -----------


def departure_scv(num_servers: int, utilization: float, *,
                  scv_arrival: float = 1.0,
                  scv_service: float = 1.0) -> float:
    """SCV of the departure (inter-departure-time) process of a G/G/c stage.

    Whitt's QNA stationary-interval approximation:

      C_d^2 = 1 + (1 - rho^2) (C_a^2 - 1) + (rho^2 / sqrt(c)) (C_s^2 - 1)

    This is what lets tandem stages chain: stage n's departures are stage
    n+1's arrivals, so C_d^2 of stage n is the ``scv_arrival`` fed to
    stage n+1's :func:`allen_cunneen_mean_wait`.  Sanity anchors: at
    rho -> 0 departures look like the arrivals (C_d^2 -> C_a^2); at
    rho -> 1 with c = 1 they look like the services (C_d^2 -> C_s^2);
    and for M/M/c (both SCVs 1) C_d^2 = 1 exactly — Burke's theorem, the
    Poisson departure stream that makes Jackson networks product-form.
    ``utilization`` is clamped to [0, 1]: an overloaded stage departs at
    its service process's rate.
    """
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if utilization < 0:
        raise ValueError("utilization must be >= 0")
    if scv_arrival < 0 or scv_service < 0:
        raise ValueError("squared coefficients of variation must be >= 0")
    rho2 = min(utilization, 1.0) ** 2
    return (1.0
            + (1.0 - rho2) * (scv_arrival - 1.0)
            + (rho2 / math.sqrt(num_servers)) * (scv_service - 1.0))


@dataclass(frozen=True)
class StageWait:
    """Per-stage prediction of :func:`tandem_waits`: the stage's mean queue
    wait, its utilization, and the arrival/departure SCVs chaining through
    it (``scv_departure`` is the next stage's ``scv_arrival``)."""

    mean_wait_s: float
    utilization: float
    scv_arrival: float
    scv_departure: float


def tandem_waits(arrival_rate_qps: float,
                 mean_service_s: Sequence[float], *,
                 num_servers: Optional[Sequence[int]] = None,
                 scv_service: Optional[Sequence[float]] = None,
                 scv_arrival: float = 1.0) -> List[StageWait]:
    """Stationary mean waits of a tandem line of G/G/c stages (QNA-style).

    Stage k is predicted with :func:`allen_cunneen_mean_wait` under the
    arrival SCV produced by stage k-1's departure process
    (:func:`departure_scv`) — the decomposition approximation: each stage
    treated as an independent G/G/c queue coupled only through the first
    two moments of the flow.  For exponential service everywhere
    (SCVs = 1) every departure stream is Poisson again and each stage
    collapses to its own Erlang-C wait — the Jackson-network anchor the
    tests pin.  A saturated stage (rho >= 1) reports ``inf`` wait and
    passes its service SCV downstream at utilization 1.
    """
    means = [float(m) for m in mean_service_s]
    if not means:
        raise ValueError("tandem line needs at least one stage")
    if any(m <= 0 for m in means):
        raise ValueError("mean service times must be positive")
    if arrival_rate_qps < 0:
        raise ValueError("arrival rate must be >= 0")
    servers = ([1] * len(means) if num_servers is None
               else [int(c) for c in num_servers])
    scvs = ([1.0] * len(means) if scv_service is None
            else [float(s) for s in scv_service])
    if len(servers) != len(means) or len(scvs) != len(means):
        raise ValueError("per-stage parameter lengths must match")
    out: List[StageWait] = []
    ca2 = float(scv_arrival)
    for m, c, cs2 in zip(means, servers, scvs):
        rho = arrival_rate_qps * m / c
        wait = allen_cunneen_mean_wait(c, arrival_rate_qps, m,
                                       scv_service=cs2, scv_arrival=ca2)
        cd2 = departure_scv(c, rho, scv_arrival=ca2, scv_service=cs2)
        out.append(StageWait(mean_wait_s=wait, utilization=rho,
                             scv_arrival=ca2, scv_departure=cd2))
        ca2 = cd2
    return out


def fork_join_sojourn(branch_sojourn_s: Sequence[float]) -> float:
    """Mean of the *critical path* — max over parallel branches — of a
    fork-join, modeling each branch's sojourn as an independent
    exponential with the given mean.

    Exact under that model via inclusion-exclusion:

      E[max_i X_i] = sum_S (-1)^(|S|+1) / sum_{i in S} lambda_i

    over non-empty branch subsets S.  For k identical branches of mean m
    this is the classic m * H_k (harmonic-number) fork-join
    synchronization penalty; a single branch returns its mean unchanged,
    which is the degenerate-tandem collapse.  Exponential branch sojourns
    are the conservative closed-form choice: heavier-tailed branches only
    push the true join wait further toward the slowest branch, which the
    max already tracks.
    """
    means = [float(m) for m in branch_sojourn_s]
    if not means:
        raise ValueError("fork-join needs at least one branch")
    if any(m <= 0 for m in means):
        raise ValueError("branch sojourns must be positive")
    if len(means) > 16:
        raise ValueError("inclusion-exclusion over >16 branches is "
                         "intractable; aggregate branches first")
    rates = [1.0 / m for m in means]
    total = 0.0
    n = len(rates)
    for mask in range(1, 1 << n):
        lam = 0.0
        bits = 0
        for i in range(n):
            if mask & (1 << i):
                lam += rates[i]
                bits += 1
        total += (1.0 if bits % 2 else -1.0) / lam
    return total


def _mix_batch_drain_threshold(budget_s: float, assignment: Sequence[int],
                               batch_laws: Sequence[BatchProfile], phi: float,
                               num_servers: int, max_batch_size: int) -> int:
    """Heterogeneous analogue of :func:`_batch_drain_threshold`: largest
    depth N such that every depth n <= N keeps the batch-aware drain wait
    phi * n / mu_agg(b(n)) within ``budget_s``, where
    mu_agg(b) = sum_w b / S_w(b) is the pool's aggregate drain rate when
    every worker forms batches of b from the backlog.  Same upward segment
    scan (and the same downward-closure guarantee) as the homogeneous
    helper."""
    if budget_s <= 0:
        return 0
    c = num_servers
    for b in range(1, max_batch_size + 1):
        mu_b = sum(b / batch_laws[a].service_time(b) for a in assignment)
        n_b = int(math.floor(budget_s * mu_b / phi))
        if b == max_batch_size or n_b < c * b:
            return max(0, n_b)
    return 0


# -- heterogeneous pools: per-worker config pinning ---------------------------


@dataclass(frozen=True)
class MixPolicy:
    """One state of the heterogeneous mix ladder: an assignment vector plus
    its aggregate queueing characteristics and switching thresholds.

    ``assignment[w]`` is the Pareto-ladder config index pinned to worker
    ``w``, sorted ascending (fastest rungs first).  Faster workers absorb
    the larger share of requests simply by completing and re-polling the
    shared FIFO queue more often — their drain share is mu_w / mu_agg in
    saturation, which is what the aggregate model weights by.  (The
    discrete-event simulator additionally breaks dispatch ties toward the
    lowest-numbered server for determinism; the threaded pool has no such
    preference, and none is needed.)  ``index`` is this state's rung on the mix
    ladder: 0 = all workers on the fastest config, the top state = all
    workers on the most accurate config; adjacent states differ by exactly
    one worker.
    """

    assignment: Tuple[int, ...]
    index: int
    drain_rate_qps: float       # mu_agg = sum_w 1 / s-bar_{a_w}
    mean_service_s: float       # s_eff = c / mu_agg (harmonic blend)
    scv: float                  # C_s^2 of the service mixture seen by requests
    worst_p95_s: float          # max_w s95_{a_w}: tail of the slowest pinned rung
    queuing_slack: float        # Delta_m = L - worst_p95
    expected_accuracy: float    # drain-share-weighted accuracy of the mix
    upscale_threshold: int      # depth above which to shift one worker faster
    downscale_threshold: Optional[int]  # depth below which to shift one worker
                                        # more accurate; None at the top state
    steal_threshold: int = 1    # min victim-backlog depth that justifies a
                                # steal under this mix (see steal_threshold())

    @property
    def num_servers(self) -> int:
        return len(self.assignment)


@dataclass(frozen=True)
class MixPolicyTable:
    """Switching policy over the heterogeneous mix ladder.

    Duck-type compatible with :class:`AQMPolicyTable` (``ladder_size``,
    ``policy(k)``, ``hysteresis``, ``num_servers``) so the Elastico
    threshold-walking logic drives either table unchanged; the mix-aware
    runtime maps a state index back to its assignment vector via
    ``policy(k).assignment``.
    """

    slo_p95_s: float
    slack_buffer_s: float
    policies: Tuple[MixPolicy, ...]       # index 0 = all-fastest
    hysteresis: HysteresisSpec
    num_servers: int
    excluded: Tuple[ParetoPoint, ...] = ()
    max_batch_size: int = 1               # B the thresholds were derived for
    # mix-aware admission: the deepest buffered depth even the all-fastest
    # mix can drain inside its slack — N_0(up).  Beyond it, re-routing to
    # the fast rung cannot save the SLO and admission control should drop.
    reroute_threshold: Optional[int] = None

    @property
    def ladder_size(self) -> int:
        return len(self.policies)

    def policy(self, k: int) -> MixPolicy:
        return self.policies[k]

    def assignment(self, k: int) -> Tuple[int, ...]:
        return self.policies[k].assignment


def mix_ladder(num_configs: int, num_servers: int) -> List[Tuple[int, ...]]:
    """Enumerate the mix ladder: assignment vectors from all-fastest to
    all-most-accurate, shifting exactly one worker per step.

    For n configs and c workers the ladder has (n - 1) * c + 1 states:

      [0,0,..,0] -> [0,..,0,1] -> ... -> [1,1,..,1] -> [1,..,1,2] -> ...

    Each vector is sorted ascending (fastest rungs in the low worker slots).
    ``num_configs = 1`` degenerates to the single all-zero state and
    ``num_servers = 1`` to the plain homogeneous ladder.
    """
    if num_configs < 1 or num_servers < 1:
        raise ValueError("need at least one config and one server")
    states: List[Tuple[int, ...]] = []
    for k in range(num_configs - 1):
        for i in range(num_servers):
            states.append(tuple([k] * (num_servers - i) + [k + 1] * i))
    states.append(tuple([num_configs - 1] * num_servers))
    return states


def mix_aggregates(front: Sequence[ParetoPoint], assignment: Sequence[int],
                   scv: Optional[Sequence[float]] = None,
                   ) -> Tuple[float, float, float, float, float]:
    """Aggregate queueing characteristics of one assignment vector.

    Returns ``(drain_rate_qps, mean_service_s, scv_eff, worst_p95_s,
    expected_accuracy)``.  The pool drains at the sum of per-worker service
    rates; the *service mixture* a random request sees weights each pinned
    config by its drain share (in saturation worker w completes a fraction
    mu_w / mu_agg of all requests), so the mixture mean equals the harmonic
    blend c / mu_agg exactly and the mixture SCV folds in both each config's
    own dispersion and the between-config spread of means.
    """
    if not assignment:
        raise ValueError("empty assignment")
    scvs = [p.profile.scv for p in front] if scv is None else list(scv)
    if len(scvs) != len(front):
        raise ValueError("need one SCV per front configuration")
    for a in assignment:
        if not 0 <= a < len(front):
            raise IndexError(f"config index {a} outside the front")
    if len(set(assignment)) == 1:
        # uniform state: exact (no accumulated float error), so the all-same
        # mix collapses to the homogeneous model bit-for-bit.
        p = front[assignment[0]]
        mu_agg = len(assignment) / p.profile.mean
        return (mu_agg, p.profile.mean, scvs[assignment[0]], p.profile.p95,
                p.accuracy)
    mu_agg = 0.0
    for a in assignment:
        mu_agg += 1.0 / front[a].profile.mean
    s_eff = len(assignment) / mu_agg
    # share-weighted mixture moments: E[S] and E[S^2] with
    # E[S_w^2] = s-bar_w^2 * (1 + C_s,w^2)
    m1 = 0.0
    m2 = 0.0
    acc = 0.0
    for a in assignment:
        p = front[a]
        share = (1.0 / p.profile.mean) / mu_agg
        m1 += share * p.profile.mean
        m2 += share * p.profile.mean ** 2 * (1.0 + scvs[a])
        acc += share * p.accuracy
    scv_eff = max(0.0, m2 / (m1 * m1) - 1.0)
    worst_p95 = max(front[a].profile.p95 for a in assignment)
    return mu_agg, s_eff, scv_eff, worst_p95, acc


def steal_threshold(front: Sequence[ParetoPoint], assignment: Sequence[int],
                    *, slo_p95_s: float) -> int:
    """Minimum victim-backlog depth at which an idle worker should steal —
    emitted per mix state by :func:`derive_mix_policies` and consumed by
    the serving scheduler's per-worker-queue discipline.

    Per-worker backlogs exist for locality (resident KV/cache state), so a
    steal is justified only once leaving the backlog in place *threatens
    the SLO*: worker w pinned to rung a_w drains its own backlog of depth
    n in about n * s-bar_{a_w}, inside the SLO while that stays within the
    rung's queuing slack Delta_{a_w} = L - s95_{a_w} (Eq. 7/8 applied to a
    single server).  The first worker to drown is the slowest pinned rung,
    so the state's threshold is its last safe depth:

        N(steal) = max(1, floor(Delta_slowest / s-bar_slowest))

    A skewed mix under partitioned routing hits this almost immediately
    (the slow rung's slack buys less than a handful of requests), which is
    exactly when the fast workers' idle capacity should absorb the
    backlog; a homogeneous all-fast mix tolerates a deeper local backlog
    before rebalancing is worth breaking locality for.
    """
    if not assignment:
        raise ValueError("empty assignment")
    if slo_p95_s <= 0:
        raise ValueError("SLO must be positive")
    slowest = None
    for a in assignment:
        if not 0 <= a < len(front):
            raise IndexError(f"config index {a} outside the front")
        p = front[a].profile
        if slowest is None or p.mean > slowest.mean:
            slowest = p
    assert slowest is not None
    slack = slo_p95_s - slowest.p95
    return max(1, int(math.floor(slack / slowest.mean)))


def derive_mix_policies(
    front: Sequence[ParetoPoint],
    *,
    slo_p95_s: float,
    slack_buffer_s: float = 0.050,
    hysteresis: HysteresisSpec = HysteresisSpec(),
    num_servers: int = 1,
    scv: Optional[Sequence[float]] = None,
    max_batch_size: int = 1,
    batch_profiles: Optional[Sequence[Optional[BatchProfile]]] = None,
) -> MixPolicyTable:
    """Derive queue-depth switching thresholds for the heterogeneous mix
    ladder of a Pareto front (the beyond-paper analogue of
    :func:`derive_policies`).

    For mix state m with aggregate drain rate mu_agg(m), slack
    Delta_m = L - max_w s95 (a buffered request may be served by the slowest
    pinned rung) and Allen-Cunneen variability factor
    phi_m = (1 + C_s,eff^2(m)) / 2, a buffered depth of N implies an
    expected wait of about  E[W | N] ~= phi_m * N / mu_agg(m), so

      N_m(up) = floor(Delta_m * mu_agg(m) / phi_m)
      N_m(dn) = floor((Delta_{m+1} - h_s) * mu_agg(m+1) / phi_{m+1})

    mirroring Eq. 10/13 with the heterogeneous drain rate in place of
    c / s-bar and the SCV correction for heavy-tailed service.  For an
    all-same-config state with SCV = 1 (exponential / unprofiled), phi = 1
    and mu_agg = c / s-bar, so N_m(up) equals the homogeneous Eq. 10
    threshold exactly.

    ``scv`` overrides the per-config service-time SCVs (default: taken from
    each profile via :attr:`repro.core.pareto.LatencyProfile.scv`, i.e.
    measured by the Planner's profiler, with an exponential fallback of 1.0
    for synthetic profiles).

    ``max_batch_size`` makes the drain estimate batch-aware, as in
    :func:`derive_policies`: at depth N each worker w forms batches of
    b(N) = min(B, ceil(N / c)) and drains at rate b / S_w(b), so
    mu_agg grows with depth and every threshold shifts outward.
    ``batch_profiles`` overrides the per-config batch law (default: each
    admitted profile's :attr:`repro.core.pareto.LatencyProfile.batch_profile`
    or the no-amortization fallback).  ``max_batch_size=1`` reproduces the
    unbatched mix thresholds bit-for-bit.
    """
    if slo_p95_s <= 0:
        raise ValueError("SLO must be positive")
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    if max_batch_size < 1:
        raise ValueError("max_batch_size must be >= 1")
    for a, b in zip(front, front[1:]):
        if not b.profile.mean > a.profile.mean:
            raise ValueError("front must be ordered by increasing mean latency")
    if batch_profiles is not None and len(batch_profiles) != len(front):
        raise ValueError("need one batch profile (or None) per front config")

    admitted: List[ParetoPoint] = []
    excluded: List[ParetoPoint] = []
    admitted_batch: List[BatchProfile] = []
    for i, p in enumerate(front):
        if slo_p95_s - p.profile.p95 > 0:
            admitted.append(p)
            override = batch_profiles[i] if batch_profiles is not None else None
            admitted_batch.append(override if override is not None
                                  else p.profile.effective_batch_profile())
        else:
            excluded.append(p)
    if not admitted:
        return MixPolicyTable(
            slo_p95_s=slo_p95_s, slack_buffer_s=slack_buffer_s, policies=(),
            hysteresis=hysteresis, num_servers=num_servers,
            excluded=tuple(excluded), max_batch_size=max_batch_size,
        )
    scvs = [p.profile.scv for p in admitted] if scv is None else list(scv)
    if len(scvs) != len(admitted):
        raise ValueError("need one SCV per admitted configuration")

    states = mix_ladder(len(admitted), num_servers)

    def stats(assignment: Tuple[int, ...]):
        mu, s_eff, scv_eff, p95, acc = mix_aggregates(admitted, assignment, scvs)
        delta = slo_p95_s - p95
        phi = max(0.5 * (1.0 + scv_eff), 1e-9)
        return mu, s_eff, scv_eff, p95, acc, delta, phi

    def drain_threshold(assignment: Tuple[int, ...], budget_s: float,
                        mu: float, phi: float) -> int:
        # depth whose drain wait phi * N / mu still fits the budget.  A
        # uniform state with phi = 1 evaluates the identical floating-point
        # expression as Eq. 10/13 in derive_policies, so the all-same mix
        # reproduces the homogeneous thresholds exactly.
        if max_batch_size > 1:
            return _mix_batch_drain_threshold(
                budget_s, assignment, admitted_batch, phi,
                num_servers, max_batch_size)
        if phi == 1.0 and len(set(assignment)) == 1:
            mean = admitted[assignment[0]].profile.mean
            return int(math.floor(num_servers * budget_s / mean))
        return int(math.floor(budget_s * mu / phi))

    policies: List[MixPolicy] = []
    for m, assignment in enumerate(states):
        mu, s_eff, scv_eff, p95, acc, delta, phi = stats(assignment)
        up = max(0, drain_threshold(assignment, delta, mu, phi))
        down: Optional[int] = None
        if m + 1 < len(states):
            nxt = states[m + 1]
            mu_n, _, _, _, _, delta_n, phi_n = stats(nxt)
            down = max(0, drain_threshold(
                nxt, max(0.0, delta_n - slack_buffer_s), mu_n, phi_n))
        policies.append(MixPolicy(
            assignment=assignment,
            index=m,
            drain_rate_qps=mu,
            mean_service_s=s_eff,
            scv=scv_eff,
            worst_p95_s=p95,
            queuing_slack=delta,
            expected_accuracy=acc,
            upscale_threshold=up,
            downscale_threshold=down,
            steal_threshold=steal_threshold(admitted, assignment,
                                            slo_p95_s=slo_p95_s),
        ))
    return MixPolicyTable(
        slo_p95_s=slo_p95_s,
        slack_buffer_s=slack_buffer_s,
        policies=tuple(policies),
        hysteresis=hysteresis,
        num_servers=num_servers,
        excluded=tuple(excluded),
        max_batch_size=max_batch_size,
        reroute_threshold=policies[0].upscale_threshold if policies else None,
    )


def derive_degraded_tables(
    front: Sequence[ParetoPoint],
    *,
    slo_p95_s: float,
    slack_buffer_s: float = 0.050,
    hysteresis: HysteresisSpec = HysteresisSpec(),
    num_servers: int,
    max_batch_size: int = 1,
    batch_profiles: Optional[Sequence[Optional[BatchProfile]]] = None,
    heterogeneous: bool = False,
):
    """Pre-derive one threshold table per surviving capacity c' in 1..c.

    The degradation-aware analogue of re-running :func:`derive_policies`
    offline when the deployment shrinks: losing a worker changes the
    aggregate drain rate c/s-bar that every threshold is stated in
    (Eq. 10/13 scale linearly with c), so a ladder derived for c servers
    is silently wrong at c - 1 — its N_up tolerates queues the surviving
    pool can no longer drain inside the SLO.  This helper derives the
    whole family up front so the runtime can swap tables at the instant a
    crash is detected (:meth:`repro.core.elastico.ElasticoController.\
on_capacity_change`) instead of thrashing on stale thresholds.

    Returns ``{c': table}`` for every c' in 1..``num_servers`` (the full-
    capacity table is included at key ``num_servers``, derived by the
    identical call :meth:`repro.core.planner.Planner.plan` makes, so the
    runtime's full-capacity behavior is unchanged by construction).
    ``heterogeneous=True`` derives mix ladders
    (:func:`derive_mix_policies`) instead — for offline capacity planning
    only; the runtime capacity swap is homogeneous-only because a degraded
    mix table's assignment vectors are sized for the surviving pool.
    """
    if num_servers < 1:
        raise ValueError("num_servers must be >= 1")
    derive = derive_mix_policies if heterogeneous else derive_policies
    return {
        c: derive(
            front,
            slo_p95_s=slo_p95_s,
            slack_buffer_s=slack_buffer_s,
            hysteresis=hysteresis,
            num_servers=c,
            max_batch_size=max_batch_size,
            batch_profiles=batch_profiles,
        )
        for c in range(1, num_servers + 1)
    }


def mix_mean_wait(mix: MixPolicy, arrival_rate_qps: float) -> float:
    """Predicted stationary mean wait of a heterogeneous mix under Poisson
    arrivals at ``arrival_rate_qps`` — Allen-Cunneen M/G/c with the mix's
    effective mean service time and mixture SCV, treating the pool as c
    interchangeable servers at the harmonic-blend rate (the standard
    effective-capacity reduction for nearly-balanced heterogeneous pools)."""
    return allen_cunneen_mean_wait(
        mix.num_servers, arrival_rate_qps, mix.mean_service_s,
        scv_service=mix.scv,
    )


def mix_ladder_is_monotone(table: MixPolicyTable) -> bool:
    """Eq. 11 analogue for mixes: faster states tolerate deeper queues,
    N_0(up) >= N_1(up) >= ... (non-strict: adjacent states differ by one
    worker, so consecutive thresholds can tie after the floor)."""
    ups = [p.upscale_threshold for p in table.policies]
    return all(a >= b for a, b in zip(ups, ups[1:]))
