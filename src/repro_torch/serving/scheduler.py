"""One scheduling core: the dispatch policy shared by engine and simulator.

Compass's serving controller is defined by *decisions* — admit or drop,
which worker serves next, under which configuration, how large a batch —
and this repo used to implement those decisions twice: once inside the
threaded ``ServingEngine``/``WorkerPool`` and once inside the
discrete-event ``ServingSimulator``.  :class:`Scheduler` extracts the
policy into a single pure state machine expressed over an injected clock:
every method takes ``now`` as an argument, no method blocks, sleeps, or
reads wall time, and the caller (the *driver*) owns event delivery.

Drivers
-------

- :class:`repro.serving.simulator.ServingSimulator` feeds the scheduler
  from a virtual-time event heap (arrival / completion / linger-expiry /
  control-tick events) and turns each returned :class:`Dispatch` into a
  sampled service time and a future completion event.  Determinism and the
  bit-for-bit golden schedules live here.
- :class:`repro.serving.executor.WorkerPool` (driven by
  :class:`repro.serving.engine.ServingEngine`) feeds the scheduler from
  real threads under one lock: ingress calls :meth:`offer`, worker threads
  call :meth:`release` and receive their :class:`Dispatch` via a mailbox,
  and linger expiries fire from timed condition waits.

Policy owned here (and nowhere else)
------------------------------------

- **FIFO order and batch draining**: a free worker takes up to
  ``max_batch_size`` buffered requests per dispatch; a short batch
  *lingers* up to ``batch_timeout_s`` for arrivals to fill it (one forming
  batch at a time, absorbed into the waiting set so ``buffered()`` counts
  it — both runtimes show the controller the same depth for the same
  state).
- **Admission control**: ``max_queue_depth`` bounds the buffered depth;
  arrivals beyond it are rejected at :meth:`offer` — unless *mix-aware
  admission* (``admission_reroute=True``) can first re-route the pool to
  the fastest rung of the ladder (see below).
- **Per-worker assignment**: an assignment vector pins worker ``w`` to
  Pareto rung ``assignment[w]``; :meth:`observe` applies
  :class:`repro.core.elastico.ElasticoMixController` repins one worker at
  a time.  Homogeneous operation follows a single active index.
- **The Elastico switch hook**: :meth:`observe` passes the buffered depth
  to the controller and applies the resulting switch (index flip or
  repin), recording ``config_timeline`` / ``assignment_timeline`` and
  honoring the simulator's ``switch_latency_s`` via per-dispatch
  ``start_s``.
- **Work stealing** (``queue_discipline="per_worker"``, ``steal=True``):
  with per-worker backlogs (arrivals routed round-robin, the static
  partition real sharded frontends produce), an idle worker whose own
  backlog is empty pulls a batch from the globally deepest backlog once
  that backlog is at least ``steal_threshold`` deep.  A stolen request is
  served under the *thief's* pinned configuration — stealing moves work,
  never violates assignment pinning.  The threshold comes from
  :func:`repro.core.aqm.steal_threshold` (emitted per mix state by
  :func:`repro.core.aqm.derive_mix_policies`).
- **Mix-aware admission** (``admission_reroute=True``): when an arrival
  finds the buffer at ``max_queue_depth``, the scheduler first forces the
  controller to the fastest rung (mix state 0 / config 0) via
  :meth:`repro.core.elastico.ElasticoController.force_fastest` and admits
  the request — dropping only when the pool is already all-fast or the
  depth exceeds the table's ``reroute_threshold`` (the deepest backlog
  even the all-fastest mix can drain inside the SLO,
  :func:`repro.core.aqm.derive_mix_policies`).

Determinism contract: given the same sequence of method calls with the
same ``now`` values, the scheduler makes the identical decisions — ties
always break toward the lowest-numbered worker and FIFO arrival order.
That is what lets the simulator stay bit-for-bit reproducible (the c=1
seed golden in ``tests/test_multi_server.py``, the B=1 goldens in
``tests/test_batching.py``) while the threaded runtime reuses the exact
same policy code.
"""

from __future__ import annotations

import heapq
from collections import deque
from dataclasses import dataclass
from typing import Any, Callable, Deque, Dict, List, Optional, Sequence, Tuple

from ..core.elastico import ElasticoController, ElasticoMixController, SwitchEvent


@dataclass(frozen=True)
class Dispatch:
    """One batch handed to one worker.

    ``items`` are the driver's request handles in FIFO order (integer ids
    for the simulator, :class:`repro.serving.workload.Request` objects for
    the engine).  ``config_index`` is the configuration resolved at
    dispatch time; ``pinned`` says it came from the assignment vector
    (the threaded executor uses its own default active index when False,
    preserving ``set_active`` semantics).  ``start_s`` is the earliest
    service start — ``max(now, switch_ready)`` — which virtual-time
    drivers honor to model the switch latency.  ``stolen`` marks a batch
    pulled from another worker's backlog by work stealing.
    """

    worker_id: int
    items: Tuple[Any, ...]
    config_index: int
    start_s: float
    pinned: bool = False
    stolen: bool = False

    @property
    def batch_size(self) -> int:
        return len(self.items)


@dataclass(frozen=True)
class Linger:
    """Instruction to the driver: schedule a linger expiry.

    A short batch is being held open; call
    :meth:`Scheduler.on_linger_expired` with ``token`` at ``deadline_s``
    (the token invalidates stale expiries for batches that dispatched
    early)."""

    deadline_s: float
    token: int


@dataclass(frozen=True)
class AdmissionDecision:
    """Outcome of :meth:`Scheduler.offer`.  ``rerouted`` means mix-aware
    admission forced the pool to the fastest rung to admit this request;
    ``event`` is the forced switch, when one happened."""

    admitted: bool
    rerouted: bool = False
    event: Optional[SwitchEvent] = None


PollResult = Tuple[List[Dispatch], List[Linger]]


class Scheduler:
    """Pure, deterministic dispatch-policy core (see module docstring).

    Not thread-safe: a threaded driver must serialize all calls behind one
    lock (the simulator is single-threaded by construction).  Construction
    validates the configuration; :meth:`reset` initializes runtime state
    (and resets the controller), so a driver can validate eagerly and
    start lazily.
    """

    def __init__(
        self,
        *,
        num_workers: int = 1,
        max_batch_size: int = 1,
        batch_timeout_s: float = 0.0,
        max_queue_depth: Optional[int] = None,
        controller: Optional[ElasticoController] = None,
        static_index: int = 0,
        assignment: Optional[Sequence[int]] = None,
        num_configs: Optional[int] = None,
        switch_latency_s: float = 0.0,
        queue_discipline: str = "shared",
        steal: bool = False,
        steal_threshold: Optional[int] = None,
        admission_reroute: bool = False,
        record_initial_config: bool = True,
        on_switch: Optional[Callable[[SwitchEvent], None]] = None,
    ) -> None:
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        if max_batch_size < 1:
            raise ValueError("max_batch_size must be >= 1")
        if batch_timeout_s < 0:
            raise ValueError("batch_timeout_s must be >= 0")
        if max_queue_depth is not None and max_queue_depth < 1:
            raise ValueError("max_queue_depth must be >= 1 (or None)")
        if queue_discipline not in ("shared", "per_worker"):
            raise ValueError(
                f"unknown queue_discipline {queue_discipline!r} "
                "(expected 'shared' or 'per_worker')")
        if steal and queue_discipline != "per_worker":
            raise ValueError("work stealing requires per-worker queues "
                             "(queue_discipline='per_worker')")
        if queue_discipline == "per_worker" and batch_timeout_s > 0:
            raise ValueError(
                "linger (batch_timeout_s > 0) is defined for the shared "
                "queue only; per-worker queues dispatch greedily")
        if steal_threshold is not None and steal_threshold < 1:
            raise ValueError("steal_threshold must be >= 1 (or None)")
        if assignment is not None and controller is not None:
            # a static pinning under any controller would be silently dead:
            # a mix controller repins from its own ladder immediately, and a
            # homogeneous controller's switches would never reach pinned
            # workers while still being recorded as events.
            raise ValueError(
                "assignment is for static runs (controller=None); use "
                "ElasticoMixController for dynamic per-worker pinning")
        if admission_reroute and (controller is None or max_queue_depth is None):
            raise ValueError("admission_reroute needs a controller and "
                             "max_queue_depth")
        if assignment is not None:
            vec = [int(a) for a in assignment]
            if len(vec) != num_workers:
                raise ValueError(
                    f"assignment length {len(vec)} != num_servers "
                    f"{num_workers}")
            for a in vec:
                if a < 0 or (num_configs is not None and a >= num_configs):
                    raise IndexError(
                        f"assignment {vec} has config index out of range")

        self.num_workers = num_workers
        self.max_batch_size = max_batch_size
        self.batch_timeout_s = batch_timeout_s
        self.max_queue_depth = max_queue_depth
        self.controller = controller
        self.static_index = static_index
        self.num_configs = num_configs
        self.switch_latency_s = switch_latency_s
        self.queue_discipline = queue_discipline
        self.steal = steal
        self.admission_reroute = admission_reroute
        self._steal_threshold_param = steal_threshold
        self._record_initial_config = record_initial_config
        # invoked synchronously inside _apply_switch, under whatever
        # serialization the driver provides — the threaded engine uses it
        # to mirror homogeneous switches into the executor's default index
        # in the same critical section that updates the scheduler, so two
        # racing switch events can never reach the executor out of order.
        self._on_switch = on_switch
        self._mix_ctrl = (controller
                          if isinstance(controller, ElasticoMixController)
                          else None)
        self._initial_assignment = (None if assignment is None
                                    else tuple(int(a) for a in assignment))
        self.reset()

    # -- lifecycle -----------------------------------------------------------

    def reset(self) -> None:
        """Initialize (or re-initialize) runtime state; resets the
        controller and seeds the timelines exactly as the pre-refactor
        runtimes did."""
        ctrl = self.controller
        if ctrl is not None:
            ctrl.reset()
        self._active = (ctrl.current_index if ctrl is not None
                        else self.static_index)
        self._assign: Optional[List[int]] = None
        if self._mix_ctrl is not None:
            self._assign = list(self._mix_ctrl.current_assignment)
        elif self._initial_assignment is not None:
            self._assign = list(self._initial_assignment)
        self._switch_ready_s = 0.0
        self._closed = False
        # shared FIFO or per-worker backlogs (deques: dequeueing the head
        # with list.pop(0) is O(n) and turns sustained-overload runs —
        # thousands of buffered requests — quadratic)
        self._waiting: Deque[Any] = deque()
        self._queues: List[Deque[Any]] = [deque()
                                          for _ in range(self.num_workers)]
        self._rr = 0                      # round-robin routing cursor
        self._free: List[int] = list(range(self.num_workers))  # min-heap
        # worker liveness (fault plane): down workers never appear in
        # _free, so neither poll path can dispatch to them.  _down_idle
        # remembers whether a down worker owes a release — a worker that
        # crashed mid-dispatch (virtual drivers cancel the batch; the
        # threaded pool lets it finish) must not rejoin _free twice.
        self._down: set = set()
        self._down_idle: Dict[int, bool] = {}
        # one forming batch lingers at a time (shared discipline); the token
        # invalidates a scheduled expiry once its batch dispatched early.
        self._linger_pending = False
        self._linger_token = 0
        self._linger_deadline_s: Optional[float] = None
        # accounting / observability
        self.num_batches = 0
        self.dispatched = 0
        self.offered = 0
        self.dropped = 0
        self.failed = 0       # retry budget exhausted (distinct from dropped)
        self.retried = 0      # requeues after a crash / deadline expiry
        self.rerouted = 0
        self.stolen_batches = 0
        self.config_timeline: List[Tuple[float, int]] = (
            [(0.0, self._active)] if self._record_initial_config else [])
        self.assignment_timeline: List[Tuple[float, Tuple[int, ...]]] = (
            [(0.0, tuple(self._assign))] if self._assign is not None else [])

    def close(self) -> None:
        """Close ingress: further :meth:`offer` calls raise."""
        self._closed = True

    # -- accessors -----------------------------------------------------------

    @property
    def active_index(self) -> int:
        return self._active

    def assignment(self) -> Optional[Tuple[int, ...]]:
        """Current per-worker pinning; None = homogeneous."""
        return None if self._assign is None else tuple(self._assign)

    def set_assignment(self, assignment: Optional[Sequence[int]]) -> None:
        """Repin every worker atomically (None clears pinning).  Dynamic
        repins normally arrive via :meth:`observe`; this hook exists for
        static drivers and direct :class:`WorkerPool` use."""
        if assignment is None:
            self._assign = None
            return
        vec = [int(a) for a in assignment]
        if len(vec) != self.num_workers:
            raise ValueError(
                f"assignment length {len(vec)} != pool size {self.num_workers}")
        for a in vec:
            if a < 0 or (self.num_configs is not None and a >= self.num_configs):
                raise IndexError(
                    f"assignment {vec} has config index out of range")
        self._assign = vec

    def config_for_worker(self, worker_id: int) -> Optional[int]:
        """Pinned config index for a worker, or None when homogeneous."""
        return None if self._assign is None else self._assign[worker_id]

    def set_active_index(self, index: int, now: float) -> None:
        """Externally-driven switch of the homogeneous active index.

        This is the *pipeline-level* switching hook: a workflow-DAG driver
        (:class:`repro.serving.dag.DagSimulator`) runs one scheduler per
        stage with no per-stage controller and applies the pipeline
        controller's rung decision here, stage by stage.  Semantics mirror
        a controller switch exactly — the new configuration becomes usable
        after ``switch_latency_s`` while in-flight work finishes under the
        old one, and ``config_timeline`` records the flip.  A no-op when
        the index is unchanged (a pipeline rung change need not touch
        every stage).  Not valid under a controller (two writers to the
        active index) or a static assignment (pinning ignores it).
        """
        if self.controller is not None:
            raise ValueError("set_active_index conflicts with a controller; "
                             "pipeline drivers run per-stage schedulers "
                             "controller-free")
        if self._assign is not None:
            raise ValueError("set_active_index is meaningless under a "
                             "per-worker assignment")
        idx = int(index)
        if idx < 0 or (self.num_configs is not None
                       and idx >= self.num_configs):
            raise IndexError(f"config index {idx} out of range")
        if idx == self._active:
            return
        self._switch_ready_s = now + self.switch_latency_s
        self._active = idx
        self.config_timeline.append((now, idx))

    def buffered(self) -> int:
        """Requests buffered but not dispatched — waiting in the shared
        queue (including any forming batch held by a linger) or spread
        across the per-worker backlogs.  This is the depth the AQM
        thresholds are stated in and the depth :meth:`observe` feeds the
        controller."""
        if self.queue_discipline == "shared":
            return len(self._waiting)
        return sum(len(q) for q in self._queues)

    def backlog_depths(self) -> List[int]:
        """Per-worker backlog depths (all zeros under the shared queue)."""
        if self.queue_discipline == "shared":
            return [0] * self.num_workers
        return [len(q) for q in self._queues]

    def free_workers(self) -> int:
        return len(self._free)

    def current_steal_threshold(self) -> int:
        """Minimum victim-backlog depth that justifies a steal: the
        explicit parameter when given, else the controller's current mix
        state's emitted threshold, else 1 (homogeneous pools always profit
        from balancing)."""
        if self._steal_threshold_param is not None:
            return self._steal_threshold_param
        if self._mix_ctrl is not None:
            thr = getattr(self._mix_ctrl.current_mix, "steal_threshold", None)
            if thr is not None:
                return int(thr)
        return 1

    def _reroute_threshold(self) -> Optional[int]:
        if self.controller is None:
            return None
        return getattr(self.controller.table, "reroute_threshold", None)

    # -- ingress -------------------------------------------------------------

    def offer(self, item: Any, now: float) -> AdmissionDecision:
        """Admit (and enqueue) or reject one arrival.

        Admission bounds the *buffered* depth.  With mix-aware admission
        enabled, an arrival over the bound first forces the controller to
        the fastest rung (recorded as a ``SwitchEvent`` with an
        ``admission reroute`` reason) and is admitted, provided the pool is
        not already all-fast and the depth does not exceed the table's
        ``reroute_threshold``."""
        if self._closed:
            raise RuntimeError("scheduler closed to ingress")
        self.offered += 1
        depth = self.buffered()
        if self.max_queue_depth is not None and depth >= self.max_queue_depth:
            ev = self._try_admission_reroute(depth, now)
            if ev is None:
                self.dropped += 1
                return AdmissionDecision(admitted=False)
            self._enqueue(item)
            self.rerouted += 1
            return AdmissionDecision(admitted=True, rerouted=True, event=ev)
        self._enqueue(item)
        return AdmissionDecision(admitted=True)

    def _enqueue(self, item: Any) -> None:
        if self.queue_discipline == "shared":
            self._waiting.append(item)
        else:
            self._queues[self._rr % self.num_workers].append(item)
            self._rr += 1

    def _try_admission_reroute(self, depth: int,
                               now: float) -> Optional[SwitchEvent]:
        if not self.admission_reroute:
            return None
        assert self.controller is not None
        cap = self._reroute_threshold()
        if cap is not None and depth > cap:
            # even the all-fastest mix cannot drain this backlog inside the
            # SLO: re-routing would just serve a doomed request — drop.
            return None
        ev = self.controller.force_fastest(depth, now)
        if ev is None:
            return None      # already all-fast: the bound stands, drop
        self._apply_switch(ev, now)
        return ev

    # -- control -------------------------------------------------------------

    def observe(self, now: float) -> Optional[SwitchEvent]:
        """One controller decision over the current buffered depth; applies
        the switch (index flip or one-worker repin) when one fires."""
        if self.controller is None:
            return None
        ev = self.controller.observe(self.buffered(), now)
        if ev is not None:
            self._apply_switch(ev, now)
        return ev

    def _apply_switch(self, ev: SwitchEvent, now: float) -> None:
        # the new configuration becomes usable after the switch latency;
        # workers keep draining with the old one until then.
        self._switch_ready_s = now + self.switch_latency_s
        self._active = ev.to_index
        if self._mix_ctrl is not None:
            self._assign = list(self._mix_ctrl.assignment_for(ev.to_index))
            self.assignment_timeline.append((now, tuple(self._assign)))
        self.config_timeline.append((now, self._active))
        if self._on_switch is not None:
            self._on_switch(ev)

    # -- workers -------------------------------------------------------------

    def release(self, worker_id: int, now: float) -> None:
        """Mark a worker free (its previous dispatch completed).  A worker
        that was marked down while serving stays out of the free heap; the
        release is remembered so a later :meth:`mark_worker_up` restores
        it exactly once."""
        if worker_id in self._down:
            self._down_idle[worker_id] = True
            return
        heapq.heappush(self._free, worker_id)

    # -- worker liveness (fault plane) ---------------------------------------

    def live_workers(self) -> int:
        """Workers currently up (down workers never receive dispatches)."""
        return self.num_workers - len(self._down)

    def is_down(self, worker_id: int) -> bool:
        return worker_id in self._down

    def mark_worker_down(self, worker_id: int, now: float):
        """Take a worker out of service.  Idempotent.  Frees nothing the
        worker holds — the driver owns cancelling/finishing the in-flight
        dispatch (simulators cancel and call
        :meth:`worker_idle_while_down`; the threaded pool lets the batch
        finish, and :meth:`release` records the idle state).  Invokes the
        controller's capacity-change hook (degradation-aware adaptation)
        and returns the resulting switch event, if any."""
        if not 0 <= worker_id < self.num_workers:
            raise IndexError(f"worker {worker_id} out of range")
        if worker_id in self._down:
            return None
        was_free = worker_id in self._free
        if was_free:
            self._free.remove(worker_id)
            heapq.heapify(self._free)
        self._down.add(worker_id)
        self._down_idle[worker_id] = was_free
        return self._on_capacity_change(now)

    def worker_idle_while_down(self, worker_id: int) -> None:
        """Driver note: the down worker's in-flight dispatch was cancelled
        (or finished), so recovery should return it to the free heap."""
        if worker_id in self._down:
            self._down_idle[worker_id] = True

    def mark_worker_up(self, worker_id: int, now: float):
        """Return a worker to service.  Idempotent.  Rejoins the free heap
        only when the worker is idle (its last dispatch was cancelled or
        released while down).  Invokes the capacity-change hook and
        returns the resulting switch event, if any."""
        if worker_id not in self._down:
            return None
        self._down.discard(worker_id)
        if self._down_idle.pop(worker_id, False):
            heapq.heappush(self._free, worker_id)
        return self._on_capacity_change(now)

    def _on_capacity_change(self, now: float):
        """Re-anchor the controller on the surviving capacity.  Only the
        homogeneous controller participates: a mix controller's degraded
        tables carry assignment vectors sized for the *surviving* pool,
        which cannot be applied to this scheduler's fixed worker indexing
        at runtime (derive them offline via
        :func:`repro.core.aqm.derive_degraded_tables` for capacity
        planning instead)."""
        if self.controller is None or self._mix_ctrl is not None:
            return None
        hook = getattr(self.controller, "on_capacity_change", None)
        if hook is None:
            return None
        ev = hook(self.live_workers(), self.buffered(), now)
        if ev is not None:
            self._apply_switch(ev, now)
        return ev

    # -- retry / requeue (fault plane) ---------------------------------------

    def record_failed(self, n: int = 1) -> None:
        """Count requests whose retry budget is exhausted — conservation
        accounting distinguishes ``failed`` (gave up after faults) from
        ``dropped`` (rejected at admission)."""
        self.failed += n

    def requeue_front(self, items: Sequence[Any]) -> None:
        """Put recovered requests back at the *head* of the queue in their
        original FIFO order (they already waited their turn once).  Not
        counted in ``offered`` — requeues move admitted work, they are not
        new arrivals.  Under per-worker queues the batch goes to the head
        of the lowest-numbered live worker's backlog (the crashed owner is
        down; any live backlog preserves FIFO-per-queue semantics)."""
        if not items:
            return
        self.retried += len(items)
        if self.queue_discipline == "shared":
            self._waiting.extendleft(reversed(items))
            return
        target = 0
        for w in range(self.num_workers):
            if w not in self._down:
                target = w
                break
        self._queues[target].extendleft(reversed(items))

    def requeue_tail(self, item: Any) -> None:
        """Re-enqueue one request at the tail (deadline-expiry retries
        rejoin the back of the line).  Not counted in ``offered``."""
        self.retried += 1
        self._enqueue(item)

    def cancel_waiting(self, item: Any) -> bool:
        """Remove a buffered request (deadline expiry).  Returns False when
        the item is no longer buffered (already dispatched)."""
        try:
            self._waiting.remove(item)
            return True
        except ValueError:
            pass
        for q in self._queues:
            try:
                q.remove(item)
                return True
            except ValueError:
                continue
        return False

    def drain_worker_backlog(self, worker_id: int) -> List[Any]:
        """Empty and return a worker's own backlog (crash recovery under
        per-worker queues re-routes the orphaned backlog).  Always empty
        under the shared discipline."""
        q = self._queues[worker_id]
        items = list(q)
        q.clear()
        return items

    def next_linger_deadline(self) -> Optional[Tuple[float, int]]:
        """(deadline, token) of the pending forming batch, if any — the
        threaded driver bounds its condition waits with this."""
        if self._linger_pending:
            assert self._linger_deadline_s is not None
            return self._linger_deadline_s, self._linger_token
        return None

    def on_linger_expired(self, token: int, now: float) -> Optional[PollResult]:
        """Linger window hit its deadline: flush the forming batch.

        Returns None for a stale token (the batch already dispatched —
        filled by arrivals or flushed by an earlier expiry); otherwise the
        dispatches (and any new linger) from the flush."""
        if not self._linger_pending or token != self._linger_token:
            return None
        self._linger_pending = False
        self._linger_deadline_s = None
        return self.poll(now, flush=True)

    def poll(self, now: float, flush: bool = False) -> PollResult:
        """Drain buffered work onto free workers.

        Dispatches as many batches as free workers and backlog allow,
        lowest-numbered worker first (the deterministic tie-break both
        runtimes share).  With batching, each dispatch takes up to
        ``max_batch_size`` requests; under the shared discipline a short
        batch lingers until ``batch_timeout_s`` (``flush=True`` dispatches
        it — the expired window covers one batch only) or until arrivals
        fill it.  Under per-worker queues each worker drains its own
        backlog greedily, stealing from the deepest backlog when idle and
        stealing is enabled."""
        if self.queue_discipline == "shared":
            return self._poll_shared(now, flush)
        return self._poll_per_worker(now)

    def _poll_shared(self, now: float, flush: bool) -> PollResult:
        dispatches: List[Dispatch] = []
        lingers: List[Linger] = []
        B = self.max_batch_size
        linger_s = self.batch_timeout_s
        while self._free and self._waiting:
            avail = len(self._waiting)
            if avail < B and not flush and linger_s > 0.0:
                # hold the short batch open; dispatch at the timeout or
                # when the backlog reaches a full batch.
                if not self._linger_pending:
                    self._linger_pending = True
                    self._linger_token += 1
                    self._linger_deadline_s = now + linger_s
                    lingers.append(Linger(deadline_s=now + linger_s,
                                          token=self._linger_token))
                return dispatches, lingers
            b = min(B, avail)
            worker = heapq.heappop(self._free)
            batch = tuple(self._waiting.popleft() for _ in range(b))
            if self._linger_pending:
                # whatever was lingering just dispatched (filled or
                # flushed); invalidate the scheduled timeout event.
                self._linger_pending = False
                self._linger_token += 1
                self._linger_deadline_s = None
            dispatches.append(self._dispatch(worker, batch, now, stolen=False))
            flush = False   # the expired window covered one batch only
        return dispatches, lingers

    def _poll_per_worker(self, now: float) -> PollResult:
        dispatches: List[Dispatch] = []
        still_free: List[int] = []
        thr = self.current_steal_threshold()
        for worker in sorted(self._free):
            source = self._queues[worker]
            stolen = False
            if not source and self.steal:
                victim = self._deepest_victim(worker)
                if victim is not None and len(self._queues[victim]) >= thr:
                    source = self._queues[victim]
                    stolen = True
            if not source:
                still_free.append(worker)
                continue
            b = min(self.max_batch_size, len(source))
            batch = tuple(source.popleft() for _ in range(b))
            dispatches.append(self._dispatch(worker, batch, now, stolen=stolen))
        if dispatches:
            self._free = still_free
            heapq.heapify(self._free)
        return dispatches, []

    def _deepest_victim(self, thief: int) -> Optional[int]:
        """The worker with the globally deepest backlog (ties break toward
        the lowest id), or None when every other backlog is empty."""
        best: Optional[int] = None
        best_depth = 0
        for w, q in enumerate(self._queues):
            if w == thief:
                continue
            if len(q) > best_depth:
                best, best_depth = w, len(q)
        return best

    def _dispatch(self, worker: int, batch: Tuple[Any, ...], now: float,
                  stolen: bool) -> Dispatch:
        start = max(now, self._switch_ready_s) if now < self._switch_ready_s else now
        cfg = self._active if self._assign is None else self._assign[worker]
        self.num_batches += 1
        self.dispatched += len(batch)
        if stolen:
            self.stolen_batches += 1
        return Dispatch(
            worker_id=worker,
            items=batch,
            config_index=cfg,
            start_s=start,
            pinned=self._assign is not None,
            stolen=stolen,
        )

    def mean_batch_size(self) -> float:
        """Realized requests per dispatch so far; 1.0 before any dispatch."""
        if self.num_batches == 0:
            return 1.0
        return self.dispatched / self.num_batches
