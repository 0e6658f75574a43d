"""Workload generators for serving experiments (paper §VI-C).

Arrival processes are Poisson with a time-varying rate function.  The AQM
assumes Poisson arrivals whatever the serving substrate behind the queue —
the paper's single M/G/1 server, a c-worker M/G/c pool, a heterogeneous
per-worker mix, or a batching pool — so every trace generated here replays
unchanged against any of them (and against both the discrete-event
simulator and the threaded engine).  The paper's two stress patterns:

- **Spike**: sustained 4x load increase during the middle third of the run.
- **Bursty**: random short 2-5x bursts lasting 5-15 s throughout the run.

Base rate 1.5 QPS, 180 s duration — the paper's setup, kept as defaults.

Beyond-paper patterns sized to stress pool- and batch-level capacity:

- **Flash crowd**: a near-instant ramp to ``peak_factor`` x base (default
  10x), a short hold, and a symmetric decay — the load shape a viral link
  produces.  Even a fast single server saturates at the peak; pools with
  c >= 2 ride it out.
- **Sustained overload**: after a warmup at a fraction of one server's
  capacity, the rate steps to ``overload_factor`` x the *single-server*
  capacity for the rest of the run.  With overload_factor between 1 and c
  the trace overloads small pools while staying stable for larger ones —
  and past c, only pools that batch (raising per-worker capacity toward
  ``B / S(B)``) stay ahead of it, the regime
  ``benchmarks/multi_server_bench.py`` compares.
"""

from __future__ import annotations

import math
import random
from dataclasses import dataclass, field
from typing import Callable, List, Sequence, Tuple

RateFn = Callable[[float], float]


def constant_rate(qps: float) -> RateFn:
    return lambda t: qps


def spike_pattern(base_qps: float = 1.5, *, factor: float = 4.0,
                  duration_s: float = 180.0) -> RateFn:
    """Sustained ``factor``x increase during the middle third (paper §VI-C)."""
    lo, hi = duration_s / 3.0, 2.0 * duration_s / 3.0

    def rate(t: float) -> float:
        return base_qps * factor if lo <= t < hi else base_qps

    return rate


def bursty_pattern(base_qps: float = 1.5, *, duration_s: float = 180.0,
                   seed: int = 0, burst_factor_range: Tuple[float, float] = (2.0, 5.0),
                   burst_len_range_s: Tuple[float, float] = (5.0, 15.0),
                   mean_gap_s: float = 25.0) -> RateFn:
    """Random short bursts of high load throughout the run (paper §VI-C)."""
    rng = random.Random(seed)
    bursts: List[Tuple[float, float, float]] = []  # (start, end, factor)
    t = rng.uniform(0.0, mean_gap_s)
    while t < duration_s:
        length = rng.uniform(*burst_len_range_s)
        factor = rng.uniform(*burst_factor_range)
        bursts.append((t, min(t + length, duration_s), factor))
        t += length + rng.expovariate(1.0 / mean_gap_s)

    def rate(tt: float) -> float:
        for s, e, f in bursts:
            if s <= tt < e:
                return base_qps * f
        return base_qps

    return rate


def diurnal_pattern(base_qps: float = 1.5, *, period_s: float = 120.0,
                    amplitude: float = 0.8) -> RateFn:
    """Smooth diurnal-style cycle (listed in §II-B as a common pattern;
    extra coverage beyond the paper's two stress patterns)."""

    def rate(t: float) -> float:
        return base_qps * (1.0 + amplitude * math.sin(2.0 * math.pi * t / period_s))

    return rate


def flash_crowd_pattern(base_qps: float = 1.5, *, peak_factor: float = 10.0,
                        crowd_start_s: float = 60.0, ramp_s: float = 5.0,
                        hold_s: float = 20.0) -> RateFn:
    """Flash crowd: base load, then a steep linear ramp (``ramp_s``) to
    ``peak_factor`` x base, a ``hold_s`` plateau, and a symmetric ramp back
    down.  Sized so a single server saturates at the peak while a pool of a
    few workers keeps the queue bounded."""
    if peak_factor < 1.0:
        raise ValueError("peak_factor must be >= 1")
    if ramp_s < 0 or hold_s < 0:
        raise ValueError("ramp and hold must be non-negative")
    up0, up1 = crowd_start_s, crowd_start_s + ramp_s
    dn0 = up1 + hold_s
    dn1 = dn0 + ramp_s
    peak = base_qps * peak_factor

    def rate(t: float) -> float:
        if t < up0 or t >= dn1:
            return base_qps
        if t < up1:                        # ramp up
            frac = (t - up0) / max(ramp_s, 1e-12)
            return base_qps + (peak - base_qps) * frac
        if t < dn0:                        # hold at the peak
            return peak
        frac = (t - dn0) / max(ramp_s, 1e-12)   # ramp down
        return peak - (peak - base_qps) * frac

    return rate


def sustained_overload_pattern(capacity_qps: float, *,
                               overload_factor: float = 2.5,
                               warmup_s: float = 30.0,
                               warmup_fraction: float = 0.5) -> RateFn:
    """Sustained overload relative to *one* server's capacity.

    ``capacity_qps`` is 1 / s-bar of the serving configuration (the
    single-server, unbatched stability limit).  The rate starts at
    ``warmup_fraction`` x capacity, then steps to ``overload_factor`` x
    capacity and stays there: any unbatched pool with c <= overload_factor
    servers is unstable for the rest of the run, any pool with
    c > overload_factor drains it — and a pool whose workers batch raises
    its effective c by the amortization factor b * S(1) / S(b), which is
    how the batching benchmark survives overloads past its worker count.
    """
    if capacity_qps <= 0:
        raise ValueError("capacity must be positive")
    if overload_factor <= 0 or warmup_fraction <= 0:
        raise ValueError("factors must be positive")

    def rate(t: float) -> float:
        if t < warmup_s:
            return capacity_qps * warmup_fraction
        return capacity_qps * overload_factor

    return rate


def generate_arrivals(rate_fn: RateFn, duration_s: float, *, seed: int = 0,
                      max_rate_hint: float | None = None) -> List[float]:
    """Sample arrival times from a non-homogeneous Poisson process by
    thinning (Lewis & Shedler).  Deterministic given the seed."""
    rng = random.Random(seed)
    if max_rate_hint is None:
        # probe the rate function for an envelope
        probes = [rate_fn(duration_s * i / 1000.0) for i in range(1001)]
        max_rate_hint = max(probes) * 1.05 + 1e-9
    lam = max_rate_hint
    t = 0.0
    out: List[float] = []
    while True:
        t += rng.expovariate(lam)
        if t >= duration_s:
            break
        if rng.random() <= rate_fn(t) / lam:
            out.append(t)
    return out


@dataclass(frozen=True)
class Request:
    """One inference request."""

    request_id: int
    arrival_s: float
    payload: object = None
