"""Batched Lindley / Kiefer-Wolfowitz sweeps: the port of
``repro/serving/fastsim.py``'s :func:`simulate_batch`.

For a static shared-FIFO M/G/c system, per-request waits follow directly
from the pre-drawn arrival and service sequences:

    c = 1:   C_i = max(A_i, C_{i-1}) + S_i            (Lindley)
    c > 1:   start_i = max(A_i, min_s F[s]);  F[s*] = start_i + S_i
             (the Kiefer-Wolfowitz workload-vector recursion)

:func:`simulate_batch` sweeps R replications x K configurations x L loads
as one padded (N, B) request grid.  The draws are numpy ``PCG64`` streams
made on the host with the same content-derived ``SeedSequence`` keys as
the JAX package, so both packages consume identical grids.  Two engines
evaluate the grid:

- ``"torch"`` (the default): the hand-written kernel
  (:func:`repro_torch.kernels.lindley_scan.lindley_scan`) runs the
  recursion, the masked sums and the compliance counts on the device;
  p95 is taken on the host (:func:`_p95_cells`).
- ``"numpy"``: the reference loop, kept so the card's results can be held
  against it on the card's own machine.

Latency grids agree bit for bit between the two, so p95, compliance and
counts do too; means agree to 1e-12 relative (the sums may run in
another order).  Nothing chooses the host by grid size: ``"torch"`` runs
on the device it is given (``device=None`` is the CUDA card, and raises
without one).
"""

from __future__ import annotations

import hashlib
import math
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.lindley_scan import MAX_SERVERS, lindley_scan

__all__ = ["simulate_batch", "SweepResult", "lognormal_params", "BACKENDS"]

BACKENDS = ("torch", "numpy")

_Z95 = 1.6448536269514722


def lognormal_params(mean_s: float, p95_s: float) -> Tuple[float, float]:
    """(mu, sigma) of the lognormal matched to (mean, p95) — the same solve
    :func:`repro_torch.serving.simulator.lognormal_sampler_from_profile`
    uses, so batched sweeps and the event-heap oracle share one service
    model."""
    if not (p95_s > 0 and mean_s > 0):
        raise ValueError("profile stats must be positive")
    ratio = max(p95_s / mean_s, 1.001)
    c = math.log(ratio)
    disc = _Z95 * _Z95 - 2.0 * c
    sigma = _Z95 - math.sqrt(disc) if disc > 0 else _Z95
    mu = math.log(mean_s) - sigma * sigma / 2.0
    return mu, sigma


@dataclass(frozen=True)
class SweepResult:
    """One metric grid per statistic, all shaped (R, K, L) =
    (replications, configs, loads)."""

    mean_wait_s: np.ndarray
    mean_latency_s: np.ndarray
    p95_latency_s: np.ndarray
    slo_compliance: np.ndarray
    throughput_qps: np.ndarray
    num_requests: np.ndarray          # arrivals simulated per cell
    duration_s: float
    slo_s: Optional[float]

    @property
    def total_requests(self) -> int:
        return int(self.num_requests.sum())

    def over_replications(self) -> dict:
        """Replication-averaged (K, L) grids — the Planner's view."""
        return {
            "mean_wait_s": self.mean_wait_s.mean(axis=0),
            "mean_latency_s": self.mean_latency_s.mean(axis=0),
            "p95_latency_s": self.p95_latency_s.mean(axis=0),
            "slo_compliance": self.slo_compliance.mean(axis=0),
            "throughput_qps": self.throughput_qps.mean(axis=0),
        }


def _fingerprint(payload: bytes) -> int:
    """64-bit content fingerprint — the RNG-stream key material.  Streams
    are keyed by cell content, never by batch position, so every sweep cell
    is a pure function of its inputs."""
    h = hashlib.blake2b(payload, digest_size=8).digest()
    return int.from_bytes(h, "little")


def _poisson_trace(rng: np.random.Generator, rate_qps: float,
                   duration_s: float) -> np.ndarray:
    """One homogeneous-Poisson arrival trace: N ~ Poisson(rate * T), times
    are the order statistics of N uniforms on [0, T)."""
    n = int(rng.poisson(rate_qps * duration_s))
    return np.sort(rng.uniform(0.0, duration_s, size=n))


def _p95_cells(lats: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """Per-cell p95 with the repo-wide interpolation convention, via an
    O(n) two-point partition.  ``lats`` is (B, N) with each cell's
    ``counts[b]`` latencies leading the row; the partition yields exactly
    the order statistics a full sort would, so engines whose latency grids
    agree bit for bit agree here too."""
    p95 = np.zeros(len(counts), dtype=float)
    for b, n in enumerate(counts):
        n = int(n)
        if n == 0:
            continue
        pos = 0.95 * (n - 1)
        lo = int(pos)
        hi = min(lo + 1, n - 1)
        part = np.partition(lats[b, :n], (lo, hi))
        p95[b] = part[lo] + (part[hi] - part[lo]) * (pos - lo)
    return p95


def _sweep_numpy(A: np.ndarray, S: np.ndarray, cell_counts: np.ndarray,
                 c: int, slo_s: Optional[float]):
    """The reference loop on the host: sequential in the request index,
    batched over scenarios.  ``A``/``S`` are the (B, N) grids."""
    B, n_max = A.shape
    A = np.ascontiguousarray(A.T)      # (N, B)
    S = np.ascontiguousarray(S.T)
    waits = np.empty((n_max, B), dtype=float)
    lats = np.empty((n_max, B), dtype=float)
    if c == 1:
        comp = np.zeros(B, dtype=float)
        for i in range(n_max):
            a = A[i]
            st = np.maximum(a, comp)                # Lindley step
            comp = st + S[i]
            waits[i] = st - a
            lats[i] = comp - a
    else:
        # Kiefer-Wolfowitz sorted-workload form: keep the server free
        # times sorted ascending, serve on the earliest-free, re-sort.
        F = np.zeros((B, c), dtype=float)
        for i in range(n_max):
            a = A[i]
            st = np.maximum(a, F[:, 0])
            ct = st + S[i]
            F[:, 0] = ct
            F.sort(axis=1)
            waits[i] = st - a
            lats[i] = ct - a

    active = np.arange(n_max)[:, None] < cell_counts[None, :]   # (N, B)
    if n_max > 0:
        waits *= active
        lats *= active

    n_eff = np.maximum(cell_counts, 1).astype(float)
    mean_wait = waits.sum(axis=0) / n_eff
    mean_lat = lats.sum(axis=0) / n_eff
    if slo_s is not None and n_max > 0:
        ok = np.count_nonzero((lats <= slo_s) & active, axis=0)
        compliance = np.where(cell_counts > 0, ok / n_eff, 1.0)
    else:
        compliance = np.ones(B, dtype=float)

    # p95: sort each column (inf padding sinks to the tail), index
    # pos = 0.95 * (n - 1)
    p95 = np.zeros(B, dtype=float)
    if n_max > 0:
        padded = np.where(active, lats, np.inf)
        srt = np.sort(padded, axis=0)
        nz = cell_counts > 0
        pos = 0.95 * (cell_counts[nz] - 1)
        lo = pos.astype(np.int64)
        hi = np.minimum(lo + 1, cell_counts[nz] - 1)
        cols_nz = np.flatnonzero(nz)
        xlo = srt[lo, cols_nz]
        xhi = srt[hi, cols_nz]
        p95[cols_nz] = xlo + (xhi - xlo) * (pos - lo)
    return mean_wait, mean_lat, compliance, p95


def _sweep_torch(A: np.ndarray, S: np.ndarray, cell_counts: np.ndarray,
                 c: int, slo_s: Optional[float], device: torch.device):
    """The kernel's engine: the (B, N) host grids go to ``device`` in the
    kernel's (N, B) layout; the recursion, sums and compliance counts run
    there; the latency grid comes back for the host p95."""
    At = torch.from_numpy(A).to(device).t().contiguous()
    St = torch.from_numpy(S).to(device).t().contiguous()
    counts = torch.from_numpy(cell_counts)
    out = lindley_scan(At, St, counts, num_servers=c,
                       slo=math.inf if slo_s is None else float(slo_s))
    counts = counts.to(device)
    n_eff = counts.clamp(min=1).to(torch.float64)
    mean_wait = out.wait_sum / n_eff
    mean_lat = out.lat_sum / n_eff
    if slo_s is not None:
        compliance = torch.where(counts > 0, out.ok / n_eff, 1.0)
    else:
        compliance = torch.ones_like(n_eff)
    lats = out.lats.t().contiguous().cpu().numpy()      # (B, N)
    return (mean_wait.cpu().numpy(), mean_lat.cpu().numpy(),
            compliance.cpu().numpy(), _p95_cells(lats, cell_counts))


def _build_grid(means: np.ndarray, p95s: Optional[np.ndarray], *,
                arrival_rates_qps, arrival_traces, duration_s: float,
                replications: int, seed: int):
    """The padded (B, N_max) arrival and service grids of a sweep and each
    cell's request count, B = R*K*L scenarios with cell (r, k, l) at
    ``(r*K + k)*L + l``.  Padding is zeros (arrival 0, service 0) at the
    tail of each cell: a padded slot leaves every workload register
    unchanged, and both engines zero padded waits/latencies.  Service
    times are lognormal matched to (mean, p95) where ``p95s`` is given,
    exponential otherwise."""
    K, R = means.size, replications
    ln_params = (None if p95s is None else
                 [lognormal_params(m, p) for m, p in zip(means, p95s)])

    # -- per-(r, l) arrival traces ------------------------------------------
    base_seed = seed & 0x7FFFFFFF
    if arrival_traces is not None:
        fixed = [np.asarray(t, dtype=float) for t in arrival_traces]
        L = len(fixed)
        traces = [[fixed[l] for l in range(L)] for _ in range(R)]
    else:
        rates = [float(x) for x in arrival_rates_qps]
        L = len(rates)
        traces = []
        for r in range(R):
            row = []
            for rate in rates:
                rate_fp = _fingerprint(np.float64(rate).tobytes()
                                       + np.float64(duration_s).tobytes())
                g = np.random.Generator(np.random.PCG64(
                    np.random.SeedSequence([base_seed, 1, r, rate_fp])))
                row.append(_poisson_trace(g, rate, duration_s))
            traces.append(row)
    if L == 0:
        raise ValueError("need at least one load pattern")

    # config content fingerprints (service-stream keys)
    if ln_params is not None:
        cfg_fps = [_fingerprint(b"ln" + np.float64(m).tobytes()
                                + np.float64(p).tobytes())
                   for m, p in zip(means, p95s)]
    else:
        cfg_fps = [_fingerprint(b"exp" + np.float64(m).tobytes())
                   for m in means]

    counts = np.array([[traces[r][l].size for l in range(L)]
                       for r in range(R)], dtype=np.int64)
    n_max = int(counts.max()) if counts.size else 0

    B = R * K * L
    A = np.zeros((B, n_max), dtype=float)
    S = np.zeros((B, n_max), dtype=float)
    cell_counts = np.zeros(B, dtype=np.int64)

    for r in range(R):
        for l in range(L):
            trace = traces[r][l]
            n = trace.size
            trace_fp = _fingerprint(trace.tobytes())
            for k in range(K):
                b = (r * K + k) * L + l
                cell_counts[b] = n
                if n == 0:
                    continue
                A[b, :n] = trace
                g = np.random.Generator(np.random.PCG64(np.random.SeedSequence(
                    [base_seed, 2, r, cfg_fps[k], trace_fp])))
                if ln_params is not None:
                    mu, sigma = ln_params[k]
                    S[b, :n] = g.lognormal(mean=mu, sigma=sigma, size=n)
                else:
                    S[b, :n] = g.exponential(scale=means[k], size=n)

    return A, S, cell_counts


def simulate_batch(
    service_mean_s: Sequence[float],
    service_p95_s: Optional[Sequence[float]] = None,
    *,
    arrival_rates_qps: Optional[Sequence[float]] = None,
    arrival_traces: Optional[Sequence[Sequence[float]]] = None,
    duration_s: float,
    num_servers: int = 1,
    replications: int = 1,
    slo_s: Optional[float] = None,
    seed: int = 0,
    backend: str = "torch",
    device=None,
) -> SweepResult:
    """Batched Lindley / Kiefer-Wolfowitz sweep: R replications x K configs
    x L load patterns evaluated as one array program, one result grid out.

    Parameters
    ----------
    service_mean_s: per-config mean service time (the K axis).
    service_p95_s: per-config p95; when given, service times are lognormal
        matched to (mean, p95); when None, exponential with the given mean.
    arrival_rates_qps: the L axis as homogeneous Poisson rates — each
        (replication r, load l) cell draws its own trace.  Mutually
        exclusive with ``arrival_traces``.
    arrival_traces: the L axis as explicit arrival-time traces, replayed
        identically across replications and configs.
    num_servers: pool size c (1..32 on the torch engine).
    replications: independent stochastic repeats R.
    slo_s: latency SLO for the compliance grid (1.0 where None).
    backend: ``"torch"`` (the kernel, on ``device``) or ``"numpy"`` (the
        reference loop on the host; ``device`` is not used).
    device: where the torch engine runs: None means the CUDA card and
        raises :class:`RuntimeError` without one; ``"cpu"`` runs the
        kernel's plain version.

    Determinism: cell (r, k, l) depends only on ``seed``, r, and its
    coordinates' inputs (rate or trace content, config stats, duration) —
    never on the batch composition; arrival streams are keyed ``(seed, r,
    rate-bits)`` and service streams ``(seed, r, config-fingerprint,
    trace-fingerprint)``, exactly as in the JAX package.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r} "
                         f"(expected one of {BACKENDS})")
    means = np.asarray(service_mean_s, dtype=float)
    if means.ndim != 1 or means.size == 0:
        raise ValueError("service_mean_s must be a non-empty 1-D sequence")
    if np.any(means <= 0):
        raise ValueError("service means must be positive")
    p95s = None
    if service_p95_s is not None:
        p95s = np.asarray(service_p95_s, dtype=float)
        if p95s.shape != means.shape:
            raise ValueError("service_p95_s must match service_mean_s")
    if (arrival_rates_qps is None) == (arrival_traces is None):
        raise ValueError(
            "exactly one of arrival_rates_qps / arrival_traces is required")
    if duration_s <= 0:
        raise ValueError("duration_s must be positive")
    if replications < 1 or num_servers < 1:
        raise ValueError("replications and num_servers must be >= 1")
    R, c = int(replications), int(num_servers)
    if backend == "torch":
        if c > MAX_SERVERS:
            raise ValueError(f"the torch engine supports num_servers <= "
                             f"{MAX_SERVERS} (got {c}); use backend='numpy'")
        dev = resolve_device(device)
    A, S, cell_counts = _build_grid(
        means, p95s, arrival_rates_qps=arrival_rates_qps,
        arrival_traces=arrival_traces, duration_s=duration_s,
        replications=R, seed=seed)
    shape = (R, means.size, cell_counts.size // (R * means.size))
    if backend == "torch":
        mean_wait, mean_lat, compliance, p95 = _sweep_torch(
            A, S, cell_counts, c, slo_s, dev)
    else:
        mean_wait, mean_lat, compliance, p95 = _sweep_numpy(
            A, S, cell_counts, c, slo_s)
    return SweepResult(
        mean_wait_s=mean_wait.reshape(shape),
        mean_latency_s=mean_lat.reshape(shape),
        p95_latency_s=p95.reshape(shape),
        slo_compliance=compliance.reshape(shape),
        throughput_qps=(cell_counts / duration_s).reshape(shape),
        num_requests=cell_counts.reshape(shape),
        duration_s=duration_s,
        slo_s=slo_s,
    )
