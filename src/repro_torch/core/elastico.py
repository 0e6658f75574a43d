"""Elastico: runtime adaptation controller (paper §III-B, §V-F).

Elastico monitors queue depth and walks the Pareto ladder using the
AQM-derived thresholds:

  - queue depth N > N_k(up)  ->  switch to the faster configuration c_{k-1}
    (immediately — upscale cooldown ~0, load spikes cause instant SLO risk);
  - queue depth N < N_k(dn) *sustained* for the downscale cooldown  ->
    switch to the slower, more accurate configuration c_{k+1}.

The asymmetric hysteresis prevents oscillation under fluctuating load and
guarantees convergence to the highest-accuracy configuration under low load.
During a switch the executor keeps serving with the old configuration until
the new one is ready, so no requests are dropped (§III-B).

:class:`ElasticoMixController` (beyond-paper) walks the *heterogeneous mix
ladder* instead: each rung is an assignment vector pinning one configuration
per worker (:func:`repro.core.aqm.derive_mix_policies`), so a threshold
crossing shifts exactly one worker to an adjacent Pareto rung rather than
flipping the whole pool.  The threshold/hysteresis mechanics are identical —
the mix table is duck-type compatible with the homogeneous one.

Both controllers are oblivious to *how* their thresholds were derived: a
table built with ``max_batch_size > 1`` bakes the batch-aware drain model
(deeper queues drain faster per request, so switch-up thresholds sit
further out — :func:`repro.core.aqm.batch_expected_wait`) into the same
integer thresholds, and the walking logic here is unchanged.  The table's
``max_batch_size`` field records which runtime the thresholds are honest
for; drive a batching pool with an unbatched table and Elastico will
switch down the accuracy ladder earlier than the pool's true drain rate
requires.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Callable, List, Mapping, Optional, Sequence, Tuple

from .aqm import AQMPolicyTable, MixPolicy, MixPolicyTable, SwitchingPolicy


@dataclass(frozen=True)
class SwitchEvent:
    time_s: float
    from_index: int
    to_index: int
    queue_depth: int
    direction: str      # "faster" | "more_accurate"
    reason: str


@dataclass
class ElasticoController:
    """Queue-depth driven configuration selector.

    Pure decision logic — time is injected (``now_s``) so the controller runs
    identically under the discrete-event simulator and the real-time engine.

    ``observe`` expects the *buffered* queue depth: requests waiting for
    service, excluding the up-to-``table.num_servers`` requests in service.
    That is the depth the AQM thresholds are stated in (Eq. 10/13) for any
    server count c; counting in-flight requests would make N_up = 0 rungs
    unreachable and would double-count the pool's own concurrency.  The
    controller itself is not thread-safe — under a multi-worker engine the
    caller must serialize ``observe`` (the engine holds a lock), which also
    guarantees every decision sees one consistent depth sample.

    ``aggressive_descent`` is a beyond-paper option: instead of stepping one
    ladder rung per decision, jump directly to the slowest configuration whose
    upscale threshold tolerates the current depth.  The paper's Elastico steps
    rung-by-rung (default False = paper-faithful).
    """

    table: AQMPolicyTable
    initial_index: Optional[int] = None
    aggressive_descent: bool = False
    # degradation-aware adaptation (beyond-paper): one threshold table per
    # surviving capacity c' (:func:`repro.core.aqm.derive_degraded_tables`).
    # When the runtime loses or regains workers it calls
    # :meth:`on_capacity_change` and the controller swaps the active table,
    # instantly re-anchoring N_up/N_dn to the surviving drain rate instead
    # of thrashing on thresholds derived for a pool that no longer exists.
    degraded_tables: Optional[Mapping[int, AQMPolicyTable]] = None

    current_index: int = field(init=False)
    last_upscale_s: float = field(init=False, default=float("-inf"))
    last_downscale_s: float = field(init=False, default=float("-inf"))
    _low_since_s: Optional[float] = field(init=False, default=None)
    events: List[SwitchEvent] = field(init=False, default_factory=list)
    # (time_s, live_servers) table swaps applied by on_capacity_change
    capacity_timeline: List[Tuple[float, int]] = field(init=False,
                                                       default_factory=list)

    def __post_init__(self) -> None:
        if self.table.ladder_size == 0:
            raise ValueError("empty policy table: no configuration can meet the SLO")
        # Start at the most accurate configuration (paper Fig. 7 starts at
        # Accurate and descends when the spike arrives).
        self.current_index = (
            self.initial_index
            if self.initial_index is not None
            else self.table.ladder_size - 1
        )
        if not 0 <= self.current_index < self.table.ladder_size:
            raise ValueError("initial index out of range")
        # the table the controller was built with is the full-capacity
        # table; capacity recoveries restore it
        self._full_table = self.table
        if self.degraded_tables is not None:
            for c, tab in self.degraded_tables.items():
                if int(c) < 1:
                    raise ValueError("degraded_tables keys are live server "
                                     "counts (>= 1)")
                if tab.ladder_size == 0:
                    raise ValueError(
                        f"degraded table for c'={c} admits no configuration")

    # -- accessors ------------------------------------------------------------

    @property
    def current_policy(self) -> SwitchingPolicy:
        return self.table.policy(self.current_index)

    @property
    def num_servers(self) -> int:
        """Server count c the driving policy table was derived for."""
        return self.table.num_servers

    # -- control --------------------------------------------------------------

    def observe(self, queue_depth: int, now_s: float) -> Optional[SwitchEvent]:
        """One control decision.  Returns a SwitchEvent when the active
        configuration changes, else None."""
        if queue_depth < 0:
            raise ValueError("negative queue depth")
        hyst = self.table.hysteresis
        k = self.current_index
        policy = self.table.policy(k)

        # ---- upscale path: queue exceeds what config k can absorb ----------
        if queue_depth > policy.upscale_threshold and k > 0:
            if now_s - self.last_upscale_s >= hyst.upscale_cooldown_s:
                target = k - 1
                if self.aggressive_descent:
                    # jump to the slowest (most accurate) config that still
                    # tolerates the current depth; fall back to the fastest.
                    target = 0
                    for j in range(k - 1, -1, -1):
                        if queue_depth <= self.table.policy(j).upscale_threshold:
                            target = j
                            break
                event = SwitchEvent(
                    time_s=now_s,
                    from_index=k,
                    to_index=target,
                    queue_depth=queue_depth,
                    direction="faster",
                    reason=f"depth {queue_depth} > N_up[{k}]={policy.upscale_threshold}",
                )
                self.current_index = target
                self.last_upscale_s = now_s
                self._low_since_s = None
                self.events.append(event)
                return event
            return None

        # ---- downscale path: sustained low load -> recover accuracy --------
        # Condition: the slower configuration can absorb the current queue,
        # N * s-bar_{k+1} <= Delta_{k+1} - h_s (Eq. 12), i.e. N <= N_k(dn).
        # The paper states this as strict N < N_k(dn) (Eq. 13); with the
        # floor that deadlocks the ladder whenever Delta_{k+1} - h_s is below
        # one mean service time (N_dn = 0 would require depth < 0), which is
        # exactly the regime of the most accurate rungs under tight SLOs —
        # so we apply Eq. 12 directly (<=).
        down = policy.downscale_threshold
        if down is not None and k + 1 < self.table.ladder_size and queue_depth <= down:
            if self._low_since_s is None:
                self._low_since_s = now_s
            sustained = now_s - self._low_since_s
            cooled = now_s - self.last_downscale_s >= hyst.downscale_cooldown_s
            if sustained >= hyst.downscale_cooldown_s and cooled:
                event = SwitchEvent(
                    time_s=now_s,
                    from_index=k,
                    to_index=k + 1,
                    queue_depth=queue_depth,
                    direction="more_accurate",
                    reason=(
                        f"depth {queue_depth} < N_dn[{k}]={down} sustained "
                        f"{sustained:.2f}s"
                    ),
                )
                self.current_index = k + 1
                self.last_downscale_s = now_s
                self._low_since_s = now_s  # restart the sustain window per rung
                self.events.append(event)
                return event
        else:
            self._low_since_s = None
        return None

    def observe_stages(self, stage_depths: Sequence[int],
                       now_s: float) -> Optional[SwitchEvent]:
        """One control decision over *per-stage* buffered depths (workflow
        DAGs): collapse the stage depths to one bottleneck-equivalent
        depth and walk the ladder with it.

        A request buffered at stage j costs the pipeline ``s_j / c_j``
        seconds of bottleneck drain budget, so the effective depth is

          N_eff = floor( sum_j N_j * (s_j / c_j) / (s_b / c_b) )

        with b the bottleneck stage — the depths are weighted by each
        stage's per-request drain time relative to the bottleneck's, which
        is exactly the depth the pipeline thresholds (Eq. 10/13 stated at
        the bottleneck) are calibrated in.  The weights come from the
        current rung's policy (``stage_weights`` on
        :class:`repro.serving.dag.PipelinePolicy`); a table without them —
        e.g. a single-stage :class:`repro.core.aqm.AQMPolicyTable` driving
        a degenerate DAG — falls back to the plain sum, which for one
        stage IS the buffered depth, so the degenerate pipeline makes
        bit-identical decisions to :meth:`observe`.
        """
        depths = [int(n) for n in stage_depths]
        if not depths:
            raise ValueError("need at least one stage depth")
        if any(n < 0 for n in depths):
            raise ValueError("negative queue depth")
        weights = getattr(self.table.policy(self.current_index),
                          "stage_weights", None)
        if weights is None:
            effective = sum(depths)
        else:
            if len(weights) != len(depths):
                raise ValueError(
                    f"{len(depths)} stage depths for a table with "
                    f"{len(weights)} stage weights")
            # epsilon guards the floor against 1.0 * N landing at N - ulp
            effective = int(math.floor(
                sum(n * w for n, w in zip(depths, weights)) + 1e-9))
        return self.observe(effective, now_s)

    def force_fastest(self, queue_depth: int, now_s: float,
                      reason: str = "admission reroute") -> Optional[SwitchEvent]:
        """Emergency jump to the fastest rung (index 0), bypassing the
        threshold walk and the upscale cooldown.

        This is the *mix-aware admission* hook: when an arrival finds the
        bounded buffer full, the scheduler re-routes the pool to the
        fastest rung of the ladder before rejecting (ROADMAP: "drop to the
        fast rung instead of rejecting").  Returns None when already at
        the fastest rung — the caller should then actually drop.  The
        event is recorded in ``events`` like any threshold-driven switch,
        with a ``reason`` naming the admission path.
        """
        if queue_depth < 0:
            raise ValueError("negative queue depth")
        if self.current_index == 0:
            return None
        event = SwitchEvent(
            time_s=now_s,
            from_index=self.current_index,
            to_index=0,
            queue_depth=queue_depth,
            direction="faster",
            reason=f"{reason}: depth {queue_depth} at admission bound",
        )
        self.current_index = 0
        self.last_upscale_s = now_s
        self._low_since_s = None
        self.events.append(event)
        return event

    def on_capacity_change(self, live_servers: int, queue_depth: int,
                           now_s: float) -> Optional[SwitchEvent]:
        """Swap the active threshold table to the one derived for the
        surviving capacity (degradation-aware adaptation).

        Called by the scheduler when a worker is marked down or up
        (:meth:`repro.serving.scheduler.Scheduler.mark_worker_down`).  At
        full capacity (or above any derived table) the full table is
        restored.  The active ladder *index* is preserved — the admitted
        ladder is capacity-independent (Eq. 7 excludes on p95 vs SLO
        alone), so rung k names the same configuration in every table —
        and only clamped when a degraded table is shorter; a clamp emits a
        :class:`SwitchEvent` so the runtime actually changes rung.  Either
        way the sustain window resets: thresholds just moved, so a
        downscale decision pending against the old ones is stale.  A
        no-op (returns None) without ``degraded_tables`` or when no table
        is derived for this capacity.
        """
        if live_servers < 1:
            raise ValueError("live_servers must be >= 1")
        if queue_depth < 0:
            raise ValueError("negative queue depth")
        if self.degraded_tables is None:
            return None
        if live_servers >= self._full_table.num_servers:
            new_table = self._full_table
        else:
            new_table = self.degraded_tables.get(live_servers)
            if new_table is None:
                return None
        if new_table is self.table:
            return None
        self.table = new_table
        self._low_since_s = None
        self.capacity_timeline.append((now_s, live_servers))
        k = self.current_index
        if k < new_table.ladder_size:
            return None
        event = SwitchEvent(
            time_s=now_s,
            from_index=k,
            to_index=new_table.ladder_size - 1,
            queue_depth=queue_depth,
            direction="faster",
            reason=(f"capacity change: {live_servers} live server(s), "
                    f"ladder clamped from rung {k}"),
        )
        self.current_index = event.to_index
        self.events.append(event)
        return event

    def reset(self) -> None:
        self.table = self._full_table
        self.current_index = (
            self.initial_index
            if self.initial_index is not None
            else self.table.ladder_size - 1
        )
        self.last_upscale_s = float("-inf")
        self.last_downscale_s = float("-inf")
        self._low_since_s = None
        self.events.clear()
        self.capacity_timeline.clear()


@dataclass
class ElasticoMixController(ElasticoController):
    """Queue-depth driven *mix* selector for heterogeneous worker pools.

    Drives a :class:`repro.core.aqm.MixPolicyTable`: the ladder indices the
    inherited threshold logic walks are mix states (assignment vectors), so
    each switch event moves exactly one worker to an adjacent Pareto rung —
    ``[slow,slow,slow,slow] -> [slow,slow,slow,fast] -> ...`` — instead of
    flipping every worker at once.  The event's ``from_index``/``to_index``
    are mix-ladder indices; the runtime resolves them to assignment vectors
    via :meth:`assignment_for` (the engine repins the pool, the simulator
    repins its server bank).  Thresholds, asymmetric hysteresis, and the
    ``aggressive_descent`` option behave exactly as in the homogeneous
    controller.

    Like the base controller this is pure decision logic: not thread-safe,
    time injected, caller serializes ``observe``.
    """

    table: MixPolicyTable

    def __post_init__(self) -> None:
        if not isinstance(self.table, MixPolicyTable):
            raise TypeError("ElasticoMixController needs a MixPolicyTable "
                            "(see repro.core.aqm.derive_mix_policies)")
        super().__post_init__()

    @property
    def current_mix(self) -> MixPolicy:
        return self.table.policy(self.current_index)

    @property
    def current_assignment(self) -> Tuple[int, ...]:
        """Config index pinned to each worker under the current mix state."""
        return self.table.assignment(self.current_index)

    def assignment_for(self, index: int) -> Tuple[int, ...]:
        return self.table.assignment(index)

    def on_capacity_change(self, live_servers: int, queue_depth: int,
                           now_s: float) -> Optional[SwitchEvent]:
        raise NotImplementedError(
            "runtime capacity swap is homogeneous-only: a degraded mix "
            "table's assignment vectors are sized for the surviving pool "
            "and cannot repin a pool with fixed worker indices; use "
            "derive_degraded_tables(..., heterogeneous=True) for offline "
            "capacity planning instead")
