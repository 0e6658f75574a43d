"""Discrete-event simulation of the Compass serving system (paper §VI-C).

A bank of ``num_servers`` identical servers draining one FIFO queue (the
M/G/c generalization of the paper's M/G/1, §V-A; ``num_servers=1`` is the
paper-faithful default and reproduces the old single-server event loop
bit-for-bit) with:
  - non-homogeneous Poisson arrivals (spike / bursty / diurnal / flash-crowd
    / sustained-overload patterns),
  - per-configuration stochastic service times (pluggable samplers, e.g.
    lognormal fitted to a profile's mean/p95 — LLM-like tails),
  - the Elastico controller observing *buffered* queue depth (excluding the
    up-to-c requests in service) at every event and at periodic control
    ticks,
  - configuration switches that take effect for subsequent requests while
    in-flight requests finish under the old configuration (no drops, §III-B),
  - optional per-server config pinning (heterogeneous pools): a static
    ``assignment`` vector or a dynamic
    :class:`repro.core.elastico.ElasticoMixController` that repins one
    server per switch event,
  - optional in-worker batching (``max_batch_size``, ``batch_timeout_s``):
    a free server drains up to B buffered requests as one batch; a short
    batch *lingers* up to the batch timeout for arrivals to fill it — the
    same dequeue-up-to-B / linger-window rules the threaded
    :class:`repro.serving.executor.WorkerPool` implements.  One detail is
    necessarily a deterministic idealization: the threaded pool resolves
    which thread wakes first by a race, while the shared core holds ONE
    forming batch at a time (the lowest free server's) that absorbs all
    arrivals — a fixed resolution of that race, so agreement with the
    threaded runtime is at the level of batch caps, linger windows, and
    buffered-depth accounting, not per-thread interleavings.  Batch service
    time scales the per-request draw by the measured amortization law
    S(b) / S(1) (:class:`repro.core.pareto.BatchProfile`; without profiles
    the fallback S(b) = b * S(1) makes batching service-neutral),
  - optional admission control (``max_queue_depth``) with *mix-aware
    admission* (``admission_reroute``): an arrival over the bound first
    forces the controller to the fastest rung and is admitted, dropping
    only when already all-fast or past the table's re-route threshold,
  - optional per-server backlogs with **work stealing**
    (``queue_discipline="per_worker"``, ``steal=True``): arrivals are
    routed round-robin to per-server queues (the static partition of a
    sharded frontend) and an idle server pulls from the globally deepest
    backlog once it reaches the steal threshold
    (:func:`repro.core.aqm.steal_threshold`), always serving stolen work
    under its *own* pinned configuration.

Since PR 4 every scheduling decision above lives in ONE place —
:class:`repro.serving.scheduler.Scheduler` — and this module is a thin
*virtual-time driver*: it owns the event heap, the RNG, and the
service-time model, feeds events to the scheduler in deterministic order,
and turns each returned :class:`~repro.serving.scheduler.Dispatch` into a
sampled service time plus a future completion event.  The threaded
:class:`repro.serving.engine.ServingEngine` drives the *same* scheduler
from real threads, so policy fixes and features land once.

Requests are dispatched to the lowest-numbered free server, so per-server
utilization (``SimulationResult.per_server_busy_s``) is deterministic too.
Deterministic given seeds, which is what lets EXPERIMENTS.md reproduce the
paper's Figures 5-7 bit-for-bit across runs; ``max_batch_size=1`` (the
default) draws service times in the exact pre-batching order and
reproduces the unbatched schedule bit-for-bit.

Role since the fast-path PR: this event-heap simulator is the **exact
oracle**.  Static shared-FIFO scenarios (no controller, B = 1, no
stealing, no admission bound) are served by the vectorized
:mod:`repro.serving.fastsim` engine instead — dispatched via
:func:`repro.serving.fastsim.simulate`, which reproduces this simulator
bit-for-bit at c = 1 and draws from the identical RNG sequence at any c —
while every dynamic-policy scenario, and every agreement test, still runs
here.
"""

from __future__ import annotations

import heapq
import math
import random
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from ..core.elastico import ElasticoController
from ..core.pareto import BatchProfile
from .faults import FaultSchedule
from .scheduler import Dispatch, Linger, Scheduler
from .workload import RateFn, generate_arrivals

ServiceSampler = Callable[[int, random.Random], float]
"""(config_index, rng) -> service time in seconds."""


def lognormal_sampler_from_profile(mean_s: Sequence[float], p95_s: Sequence[float]) -> ServiceSampler:
    """Service-time sampler with lognormal tails matched to (mean, p95) per
    configuration — mirrors the paper's percentile-based LLM profiles.

    For lognormal(mu, sigma): mean = exp(mu + sigma^2/2) and
    p95 = exp(mu + 1.6449 * sigma); solve for (mu, sigma) per config.
    """
    params: List[Tuple[float, float]] = []
    z95 = 1.6448536269514722
    for m, p in zip(mean_s, p95_s):
        if not (p > 0 and m > 0):
            raise ValueError("profile stats must be positive")
        ratio = max(p / m, 1.001)
        # solve sigma from: ln(p) - ln(m) = z*sigma - sigma^2/2
        c = math.log(ratio)
        disc = z95 * z95 - 2.0 * c
        sigma = z95 - math.sqrt(disc) if disc > 0 else z95  # smaller root
        mu = math.log(m) - sigma * sigma / 2.0
        params.append((mu, sigma))

    def sample(k: int, rng: random.Random) -> float:
        mu, sigma = params[k]
        return math.exp(rng.gauss(mu, sigma))

    return sample


def deterministic_sampler(mean_s: Sequence[float]) -> ServiceSampler:
    means = [float(m) for m in mean_s]

    def sample(k: int, rng: random.Random) -> float:
        return means[k]

    return sample


def exponential_sampler(mean_s: Sequence[float]) -> ServiceSampler:
    """Memoryless service times — the 'M' service of M/M/c.  Used to validate
    the simulator's multi-server wait against the Erlang-C prediction
    (:func:`repro.core.aqm.erlang_c_mean_wait`)."""
    means = [float(m) for m in mean_s]
    if any(m <= 0 for m in means):
        raise ValueError("mean service times must be positive")

    def sample(k: int, rng: random.Random) -> float:
        return rng.expovariate(1.0 / means[k])

    return sample


@dataclass
class CompletedRequest:
    request_id: int
    arrival_s: float
    start_s: float
    completion_s: float
    config_index: int
    server_id: int = 0
    batch_size: int = 1   # size of the batch this request was served in

    @property
    def latency_s(self) -> float:
        return self.completion_s - self.arrival_s

    @property
    def wait_s(self) -> float:
        return self.start_s - self.arrival_s


@dataclass
class SimulationResult:
    completed: List[CompletedRequest]
    switch_events: List                       # List[SwitchEvent]
    config_timeline: List[Tuple[float, int]]  # (time, active or mix index)
    queue_depth_samples: List[Tuple[float, int]]
    duration_s: float
    num_servers: int = 1
    per_server_busy_s: List[float] = field(default_factory=lambda: [0.0])
    # (time, per-server config pinning) repin events for heterogeneous runs;
    # empty when the pool ran homogeneously.
    assignment_timeline: List[Tuple[float, Tuple[int, ...]]] = field(
        default_factory=list)
    num_batches: int = 0        # dispatches; == len(completed) when unbatched
    offered: int = 0            # arrivals offered (== completed when no drops)
    dropped: int = 0            # admission-control rejections
    rerouted: int = 0           # admissions saved by the mix-aware re-route
    stolen_batches: int = 0     # dispatches pulled from another backlog
    # fault plane: retry budget exhausted (distinct from dropped), requeues
    # after crashes / deadline expiries, and requests still buffered or in
    # service when the run stopped (> 0 only when every worker died with
    # work outstanding).  Conservation invariant (property-tested):
    # offered == completed + dropped + failed + in_flight.
    failed: int = 0
    retried: int = 0
    in_flight: int = 0

    def mean_batch_size(self) -> float:
        """Realized requests per dispatch; 1.0 for unbatched runs."""
        if self.num_batches == 0:
            return 1.0
        return len(self.completed) / self.num_batches

    @property
    def num_completed(self) -> int:
        """Served-request count — part of the metric surface shared with
        :class:`repro.serving.fastsim.FastSimulationResult` (which computes
        it without materializing per-request records)."""
        return len(self.completed)

    def config_counts(self) -> Dict[int, int]:
        """{config_index: served count} — the per-rung usage histogram."""
        counts: Dict[int, int] = {}
        for r in self.completed:
            counts[r.config_index] = counts.get(r.config_index, 0) + 1
        return counts

    def per_server_utilization(self) -> List[float]:
        """Busy fraction of each server over the horizon (index = server id).

        The simulator completes every arrival (no drops), so under overload
        the backlog drains *past* ``duration_s`` and values exceed 1.0 —
        a utilization above 1 reads as "this server owes that multiple of
        the horizon in work", which is the overload signal itself."""
        horizon = max(self.duration_s, 1e-12)
        return [b / horizon for b in self.per_server_busy_s]

    def mean_wait(self) -> float:
        if not self.completed:
            return 0.0
        return sum(r.wait_s for r in self.completed) / len(self.completed)

    def slo_compliance(self, slo_s: float) -> float:
        if not self.completed:
            return 1.0
        ok = sum(1 for r in self.completed if r.latency_s <= slo_s)
        return ok / len(self.completed)

    def goodput(self, slo_s: float) -> float:
        """Fraction of *offered* arrivals served within the SLO — unlike
        ``slo_compliance`` this charges admission-control drops."""
        if self.offered == 0:
            return 1.0
        ok = sum(1 for r in self.completed if r.latency_s <= slo_s)
        return ok / self.offered

    def mean_accuracy(self, accuracies: Sequence[float]) -> float:
        """Average task accuracy over served requests, where request r served
        under config k scores accuracies[k] in expectation."""
        if not self.completed:
            return 0.0
        return sum(accuracies[r.config_index] for r in self.completed) / len(self.completed)

    def latencies(self) -> List[float]:
        return [r.latency_s for r in self.completed]

    def p95_latency(self) -> float:
        xs = sorted(self.latencies())
        if not xs:
            return 0.0
        pos = 0.95 * (len(xs) - 1)
        lo = int(pos)
        hi = min(lo + 1, len(xs) - 1)
        return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


@dataclass
class ServingSimulator:
    """Event-driven M/G/c + Elastico simulator: a virtual-time driver over
    the shared :class:`repro.serving.scheduler.Scheduler`.

    ``controller=None`` simulates a static baseline pinned to
    ``static_index`` — the paper's Static-Fast / Medium / Accurate baselines.
    ``switch_latency_s`` models the (small) pipeline-rerouting cost; the
    paper measures <10 ms since all configs stay resident in memory.
    ``num_servers`` is the server count c; the default 1 reproduces the
    paper's single-server results exactly (same seeds -> same completions,
    the pool draws service times in the same order).

    Heterogeneous pools (beyond-paper): ``assignment`` statically pins
    server i to config ``assignment[i]``, and passing an
    :class:`repro.core.elastico.ElasticoMixController` as ``controller``
    makes the pinning dynamic — each switch event repins exactly one server
    (``assignment_timeline`` records the trajectory).  An all-same
    ``assignment`` vector takes the same code path as the homogeneous
    simulator and reproduces ``static_index`` runs exactly (same seeds ->
    same completions: service times are drawn per dispatch in the same
    order).

    In-worker batching (beyond-paper): ``max_batch_size = B > 1`` lets a
    free server take up to B buffered requests as one batch, whose service
    time is the per-request draw scaled by the config's batch-amortization
    factor S(b)/S(1) (``batch_profiles``; fallback S(b) = b * S(1)).
    ``batch_profiles`` must be indexed by the same config-index space as
    ``service_sampler`` — one entry per config index the controller (or
    ``static_index`` / ``assignment``) can emit.  Note that controllers
    emit *admitted-ladder* indices: if ``derive_policies`` excluded
    SLO-infeasible configs from the front, build the sampler and
    ``batch_profiles`` from the admitted ladder, not the raw front.  When
    fewer than B requests are buffered and ``batch_timeout_s > 0``, the
    forming batch *lingers*: a dispatch event fires at the timeout — or
    immediately once arrivals fill the batch — mirroring the threaded
    pool's linger.  Every member of a batch shares the batch's
    start/completion times.  ``max_batch_size=1`` reproduces the unbatched
    schedule bit-for-bit (identical rng sequence and event order; no
    linger events are ever scheduled).

    Admission control (beyond-paper): ``max_queue_depth`` bounds the
    buffered depth; rejected arrivals are counted in
    ``SimulationResult.dropped`` and never complete.
    ``admission_reroute=True`` (requires a controller and the bound) turns
    on mix-aware admission: force the fastest rung before rejecting.

    Work stealing (beyond-paper): ``queue_discipline="per_worker"`` routes
    arrivals round-robin to per-server backlogs; ``steal=True`` lets idle
    servers pull from the globally deepest backlog at or past
    ``steal_threshold`` (default: the controller's mix-state threshold, or
    1).  Stolen work runs under the thief's pinned configuration.
    """

    service_sampler: ServiceSampler
    controller: Optional[ElasticoController] = None
    static_index: int = 0
    control_tick_s: float = 0.25
    switch_latency_s: float = 0.010
    seed: int = 0
    num_servers: int = 1
    assignment: Optional[Sequence[int]] = None
    max_batch_size: int = 1
    batch_timeout_s: float = 0.0
    batch_profiles: Optional[Sequence[BatchProfile]] = None
    max_queue_depth: Optional[int] = None
    admission_reroute: bool = False
    queue_discipline: str = "shared"
    steal: bool = False
    steal_threshold: Optional[int] = None
    # fault plane (beyond-paper): a deterministic FaultSchedule of worker
    # crash/recover events and straggler service-inflation windows
    # (:mod:`repro.serving.faults`).  A crashed worker's in-flight batch is
    # cancelled and requeued at the queue head; each request retries up to
    # ``retry_budget`` times before counting as ``failed``.
    # ``request_timeout_s`` adds a queue-wait deadline: a request buffered
    # past it is pulled from the queue and re-offered at the tail after an
    # exponential backoff (retry_backoff_s * 2^(attempt-1)), sharing the
    # same retry budget.  faults=None (or an empty schedule) and
    # request_timeout_s=None reproduce the fault-free schedules
    # bit-for-bit: no extra heap events, no extra RNG draws.
    faults: Optional[FaultSchedule] = None
    retry_budget: int = 3
    request_timeout_s: Optional[float] = None
    retry_backoff_s: float = 0.05

    def run(self, arrivals: Sequence[float], duration_s: float) -> SimulationResult:
        if self.num_servers < 1:
            raise ValueError("num_servers must be >= 1")
        faults = (self.faults
                  if self.faults is not None and not self.faults.is_empty()
                  else None)
        timeout_s = self.request_timeout_s
        if faults is not None and faults.max_worker(None) >= self.num_servers:
            raise ValueError(
                f"fault schedule addresses worker {faults.max_worker(None)} "
                f"but the pool has {self.num_servers} server(s)")
        if self.retry_budget < 0:
            raise ValueError("retry_budget must be >= 0")
        if timeout_s is not None and timeout_s <= 0:
            raise ValueError("request_timeout_s must be > 0 (or None)")
        if self.retry_backoff_s < 0:
            raise ValueError("retry_backoff_s must be >= 0")
        # track per-request fault state only when something can go wrong —
        # the fault-free path must stay bit-for-bit the pre-fault loop
        track = faults is not None or timeout_s is not None
        rng = random.Random(self.seed)
        sched = Scheduler(
            num_workers=self.num_servers,
            max_batch_size=self.max_batch_size,
            batch_timeout_s=self.batch_timeout_s,
            max_queue_depth=self.max_queue_depth,
            controller=self.controller,
            static_index=self.static_index,
            assignment=self.assignment,
            switch_latency_s=self.switch_latency_s,
            queue_discipline=self.queue_discipline,
            steal=self.steal,
            steal_threshold=self.steal_threshold,
            admission_reroute=self.admission_reroute,
            record_initial_config=True,
        )

        # event heap: (time, order, kind, payload)
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
            # capacity events enter the heap after arrivals and ticks, so
            # at equal timestamps a crash resolves after the tick/arrival
            # already scheduled there — a fixed, documented tie-break
            for ft, fkind, fworker in faults.capacity_events(None):
                heapq.heappush(events, (ft, order, fkind, fworker))
                order += 1

        arrival_time: Dict[int, float] = {i: a for i, a in enumerate(arrivals)}
        busy_s: List[float] = [0.0] * self.num_servers
        completed: List[Optional[CompletedRequest]] = []
        depth_samples: List[Tuple[float, int]] = []
        # fault-tracking state (inert when track is False)
        epoch: List[int] = [0] * self.num_servers
        active: Dict[int, Tuple[int, Tuple, float, float, int]] = {}
        attempts: Dict[int, int] = {}
        tokens: Dict[int, int] = {}
        queued: set = set()

        def arm_timeout(rid: int, now: float) -> None:
            nonlocal order
            tokens[rid] = tokens.get(rid, 0) + 1
            heapq.heappush(events, (now + timeout_s, order, "timeout",
                                    (rid, tokens[rid])))
            order += 1

        def retry_or_fail(rid: int, now: float, *, backoff: bool) -> bool:
            """Charge one attempt; schedule a backoff retry (timeout path)
            or report survivorship (crash path).  Returns True when the
            request stays alive."""
            nonlocal order
            a = attempts.get(rid, 0) + 1
            attempts[rid] = a
            if a > self.retry_budget:
                sched.record_failed(1)
                return False
            if backoff:
                delay = self.retry_backoff_s * (2 ** (a - 1))
                heapq.heappush(events, (now + delay, order, "retry", rid))
                order += 1
            return True

        def batch_service_time(cfg: int, b: int) -> float:
            # one rng draw per dispatch, same order as the unbatched
            # simulator; b == 1 returns the raw draw so B = 1 runs are
            # bit-for-bit identical to the pre-batching event loop.
            draw = self.service_sampler(cfg, rng)
            if b == 1:
                return draw
            if self.batch_profiles is not None:
                law = self.batch_profiles[cfg]
                return draw * (law.service_time(b) / law.service_time(1))
            return draw * b   # unprofiled: batching is service-neutral

        def execute(polled: Tuple[List[Dispatch], List[Linger]]) -> None:
            # Turn each scheduler decision into simulated service: draw the
            # batch's service time, record the members, and schedule the
            # completion (and any linger expiry) on the event heap — in the
            # same push order the pre-refactor loop used, so event
            # tie-breaks are unchanged.
            nonlocal order
            dispatches, lingers = polled
            for d in dispatches:
                svc = batch_service_time(d.config_index, d.batch_size)
                if faults is not None:
                    svc *= faults.inflation(d.worker_id, d.start_s)
                comp = d.start_s + svc
                busy_s[d.worker_id] += comp - d.start_s
                rec_lo = len(completed)
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
                ep = 0
                if track:
                    queued.difference_update(d.items)
                    ep = epoch[d.worker_id]
                    active[d.worker_id] = (ep, d.items, d.start_s, comp,
                                           rec_lo)
                heapq.heappush(events, (comp, order, "completion",
                                        (d.worker_id, ep)))
                order += 1
            for lg in lingers:
                heapq.heappush(events, (lg.deadline_s, order, "linger",
                                        lg.token))
                order += 1

        while events:
            now, _, kind, payload = heapq.heappop(events)
            if now > duration_s and kind == "tick":
                continue
            if kind == "arrival":
                adm = sched.offer(int(payload), now)  # type: ignore[arg-type]
                if track and adm.admitted:
                    queued.add(int(payload))  # type: ignore[arg-type]
                    if timeout_s is not None:
                        arm_timeout(int(payload), now)  # type: ignore[arg-type]
                execute(sched.poll(now))
                sched.observe(now)
            elif kind == "completion":
                worker, ep = payload  # type: ignore[misc]
                if track:
                    if ep != epoch[worker]:
                        continue   # stale: the serving worker crashed
                    active.pop(worker, None)
                sched.release(worker, now)
                execute(sched.poll(now))
                sched.observe(now)
            elif kind == "linger":
                res = sched.on_linger_expired(int(payload), now)  # type: ignore[arg-type]
                if res is not None:
                    execute(res)
                    sched.observe(now)
                # else: stale timeout for a batch that already dispatched
            elif kind == "crash":
                w = int(payload)  # type: ignore[arg-type]
                sched.mark_worker_down(w, now)
                requeue: List[int] = []
                if w in active:
                    # cancel the in-flight batch: invalidate its pending
                    # completion, refund the unserved busy time, and null
                    # its prematurely-appended records
                    ep, items, start_s, comp, rec_lo = active.pop(w)
                    epoch[w] += 1
                    busy_s[w] -= comp - max(start_s, min(now, comp))
                    for i in range(rec_lo, rec_lo + len(items)):
                        completed[i] = None
                    for rid in items:
                        if retry_or_fail(rid, now, backoff=False):
                            requeue.append(rid)
                    sched.worker_idle_while_down(w)
                # orphaned per-worker backlog moves (no attempt charged:
                # those requests never started service)
                requeue.extend(sched.drain_worker_backlog(w))
                sched.requeue_front(requeue)
                for rid in requeue:
                    queued.add(rid)
                    if timeout_s is not None:
                        arm_timeout(rid, now)   # fresh deadline per attempt
                execute(sched.poll(now))
                sched.observe(now)
            elif kind == "recover":
                sched.mark_worker_up(int(payload), now)  # type: ignore[arg-type]
                execute(sched.poll(now))
                sched.observe(now)
            elif kind == "timeout":
                rid, token = payload  # type: ignore[misc]
                if tokens.get(rid) != token or rid not in queued:
                    continue   # stale deadline: dispatched or re-armed
                if not sched.cancel_waiting(rid):
                    continue
                queued.discard(rid)
                retry_or_fail(rid, now, backoff=True)
                sched.observe(now)
            elif kind == "retry":
                rid = int(payload)  # type: ignore[arg-type]
                sched.requeue_tail(rid)
                queued.add(rid)
                if timeout_s is not None:
                    arm_timeout(rid, now)
                execute(sched.poll(now))
                sched.observe(now)
            else:  # control tick
                sched.observe(now)
                execute(sched.poll(now))
                depth_samples.append((now, sched.buffered()))

        if track:
            completed = [r for r in completed if r is not None]
        in_service = sum(len(entry[1]) for entry in active.values())
        ctrl = self.controller
        return SimulationResult(
            completed=completed,
            switch_events=list(ctrl.events) if ctrl is not None else [],
            config_timeline=list(sched.config_timeline),
            queue_depth_samples=depth_samples,
            duration_s=duration_s,
            num_servers=self.num_servers,
            per_server_busy_s=busy_s,
            assignment_timeline=list(sched.assignment_timeline),
            num_batches=sched.num_batches,
            offered=sched.offered,
            dropped=sched.dropped,
            rerouted=sched.rerouted,
            stolen_batches=sched.stolen_batches,
            failed=sched.failed,
            retried=sched.retried,
            in_flight=sched.buffered() + in_service,
        )
