"""Deterministic fault injection for the serving runtimes.

Compass targets fixed-infrastructure deployments (§II): capacity cannot be
scaled out, so *losing* capacity — a worker crash, a straggling replica, a
browned-out pipeline stage — is the most dangerous runtime event the
ladder can face.  This module defines the fault model every runtime
shares: a :class:`FaultSchedule` is a declarative, deterministic script of
capacity events, injectable into the virtual-time drivers
(:class:`repro.serving.simulator.ServingSimulator`,
:class:`repro.serving.dag.DagSimulator`) and — at control-tick granularity
— into the wall-clock :class:`repro.serving.engine.ServingEngine`.

Three fault kinds:

- :class:`WorkerCrash`: worker ``worker_id`` (of stage ``stage`` in a DAG;
  ``stage=None`` addresses the flat simulator / engine pool) goes down at
  ``time_s`` and optionally recovers at ``recover_s``.  In the simulators
  the in-flight batch on a crashed worker is *cancelled* and its requests
  are requeued at the queue head under a per-request retry budget
  (exhausted -> counted as ``failed``, distinct from admission-control
  ``dropped``); in the threaded engine a crash stops new dispatches at the
  next control tick while the already-running batch finishes (threads
  cannot be preempted — the boundary is documented, not hidden).
- :class:`Straggler`: worker ``worker_id`` serves every request ``factor``
  times slower inside ``[start_s, end_s)`` — the slow-replica failure mode
  that silently eats queueing slack without tripping any liveness check.
- :class:`Brownout`: every worker of DAG stage ``stage`` is inflated by
  ``factor`` inside ``[start_s, end_s)`` — a stage-wide dependency
  degradation (an overloaded retrieval index, a throttled downstream API).

Determinism contract: the schedule is data, not callbacks — the same
schedule against the same seed yields the identical simulated run.  The
**empty schedule is inert**: drivers normalize ``FaultSchedule()`` (or
``faults=None``) to the no-fault code path, which pushes no extra heap
events, draws no extra randomness, and reproduces today's golden schedules
bit-for-bit (property-tested in ``tests/test_faults.py``).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional, Tuple

__all__ = [
    "WorkerCrash",
    "Straggler",
    "Brownout",
    "FaultSchedule",
]


@dataclass(frozen=True)
class WorkerCrash:
    """Worker ``worker_id`` crashes at ``time_s``; ``recover_s`` (optional,
    must be > ``time_s``) brings it back.  ``stage`` scopes the crash to
    one DAG stage; ``None`` addresses the flat pool."""

    time_s: float
    worker_id: int
    recover_s: Optional[float] = None
    stage: Optional[int] = None

    def __post_init__(self) -> None:
        if self.time_s < 0:
            raise ValueError("crash time must be >= 0")
        if self.worker_id < 0:
            raise ValueError("worker_id must be >= 0")
        if self.recover_s is not None and self.recover_s <= self.time_s:
            raise ValueError("recover_s must be after the crash time")
        if self.stage is not None and self.stage < 0:
            raise ValueError("stage must be >= 0 (or None)")


@dataclass(frozen=True)
class Straggler:
    """Worker ``worker_id`` serves ``factor``x slower in [start_s, end_s).
    The window is evaluated at dispatch ``start_s`` — a batch dispatched
    inside the window pays the full inflation even if it completes after
    the window closes (the slow replica was slow when it took the work)."""

    worker_id: int
    start_s: float
    end_s: float
    factor: float
    stage: Optional[int] = None

    def __post_init__(self) -> None:
        if self.worker_id < 0:
            raise ValueError("worker_id must be >= 0")
        if not self.end_s > self.start_s >= 0:
            raise ValueError("need 0 <= start_s < end_s")
        if self.factor <= 1.0:
            raise ValueError("straggler factor must be > 1")
        if self.stage is not None and self.stage < 0:
            raise ValueError("stage must be >= 0 (or None)")


@dataclass(frozen=True)
class Brownout:
    """Every worker of DAG stage ``stage`` is ``factor``x slower in
    [start_s, end_s) — a stage-wide dependency degradation."""

    stage: int
    start_s: float
    end_s: float
    factor: float

    def __post_init__(self) -> None:
        if self.stage < 0:
            raise ValueError("stage must be >= 0")
        if not self.end_s > self.start_s >= 0:
            raise ValueError("need 0 <= start_s < end_s")
        if self.factor <= 1.0:
            raise ValueError("brownout factor must be > 1")


@dataclass(frozen=True)
class FaultSchedule:
    """A deterministic script of capacity faults (see module docstring).

    ``crashes`` may not schedule two overlapping down-windows for the same
    (stage, worker): a crash of an already-down worker is a schedule bug,
    not a runtime condition, and is rejected at construction.
    """

    crashes: Tuple[WorkerCrash, ...] = ()
    stragglers: Tuple[Straggler, ...] = ()
    brownouts: Tuple[Brownout, ...] = ()

    def __post_init__(self) -> None:
        # dataclass(frozen) + tuple coercion for list-passing callers
        object.__setattr__(self, "crashes", tuple(self.crashes))
        object.__setattr__(self, "stragglers", tuple(self.stragglers))
        object.__setattr__(self, "brownouts", tuple(self.brownouts))
        by_worker: dict = {}
        for c in self.crashes:
            by_worker.setdefault((c.stage, c.worker_id), []).append(c)
        for key, cs in by_worker.items():
            cs.sort(key=lambda c: c.time_s)
            for a, b in zip(cs, cs[1:]):
                if a.recover_s is None or b.time_s < a.recover_s:
                    raise ValueError(
                        f"overlapping crash windows for stage/worker {key}: "
                        f"crash at {b.time_s} while down since {a.time_s}")

    def is_empty(self) -> bool:
        """True when the schedule injects nothing — drivers treat an empty
        schedule exactly like ``faults=None`` (the bit-for-bit golden
        invariant)."""
        return not (self.crashes or self.stragglers or self.brownouts)

    def capacity_events(self, stage: Optional[int] = None
                        ) -> List[Tuple[float, str, int]]:
        """Flatten the crash/recover pairs addressed to ``stage`` into
        ``(time_s, kind, worker_id)`` tuples (kind in {"crash",
        "recover"}), sorted by time with crashes before recoveries at
        ties.  Virtual-time drivers push these onto their event heap;
        the engine's control loop pops them as wall time passes."""
        out: List[Tuple[float, str, int]] = []
        for c in self.crashes:
            if c.stage != stage:
                continue
            out.append((c.time_s, "crash", c.worker_id))
            if c.recover_s is not None:
                out.append((c.recover_s, "recover", c.worker_id))
        out.sort(key=lambda e: (e[0], 0 if e[1] == "crash" else 1, e[2]))
        return out

    def inflation(self, worker_id: int, now: float,
                  stage: Optional[int] = None) -> float:
        """Combined service-time multiplier for a dispatch taken by
        ``worker_id`` (of ``stage``) at time ``now``: the product of every
        straggler window covering the worker and every brownout covering
        the stage.  1.0 outside all windows."""
        m = 1.0
        for s in self.stragglers:
            if (s.stage == stage and s.worker_id == worker_id
                    and s.start_s <= now < s.end_s):
                m *= s.factor
        if stage is not None:
            for b in self.brownouts:
                if b.stage == stage and b.start_s <= now < b.end_s:
                    m *= b.factor
        return m

    def max_worker(self, stage: Optional[int] = None) -> int:
        """Largest worker id the schedule addresses at ``stage`` (-1 when
        none) — drivers validate it against their pool size."""
        ids = [c.worker_id for c in self.crashes if c.stage == stage]
        ids += [s.worker_id for s in self.stragglers if s.stage == stage]
        return max(ids) if ids else -1
