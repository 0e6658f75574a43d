"""Plain PyTorch version of the Lindley / Kiefer-Wolfowitz sweep kernel.

The same recursion as ``csrc/lindley_scan.cu``, as a Python loop over rows
on torch B-vectors, in the kernel's op order: every value it returns is
bit-equal to the kernel's (not the cumsum/cummax closed form, which rounds
differently).  The tests hold it against the JAX package's ``lindley_scan``
and ``_jax_kw``; ``chip_smoke.py`` holds the kernel against it on the card.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch


class LindleyOut(NamedTuple):
    """What one sweep returns.  ``waits``/``lats`` are (N, B), zero at and
    past each lane's count; the per-lane sums run in time order; ``ok``
    counts the lane's rows with ``lat <= slo``."""

    waits: torch.Tensor
    lats: torch.Tensor
    wait_sum: torch.Tensor
    lat_sum: torch.Tensor
    ok: torch.Tensor


def lindley_scan_ref(arrivals: torch.Tensor, services: torch.Tensor,
                     counts: torch.Tensor, *, num_servers: int = 1,
                     slo: float = math.inf) -> LindleyOut:
    """Waits and latencies of the FIFO M/G/c recursion over (N, B) grids.

    Lane b runs rows ``0 .. counts[b] - 1`` of ``arrivals``/``services``
    from an idle pool (``counts`` is a host int64 tensor); ``num_servers = 1`` is the Lindley recursion,
    larger pools the Kiefer-Wolfowitz one, keeping the ascending free-time
    vector with the comparator chain of the JAX package's ``_jax_kw``."""
    n, b = arrivals.shape
    c = int(num_servers)
    zeros = torch.zeros(b, dtype=arrivals.dtype, device=arrivals.device)
    free = [zeros] * c
    waits = torch.zeros_like(arrivals)
    lats = torch.zeros_like(arrivals)
    wait_sum, lat_sum = zeros, zeros
    ok = torch.zeros(b, dtype=torch.int64, device=arrivals.device)
    rows = min(int(counts.max()), n) if b and n else 0
    counts = counts.to(arrivals.device)
    for i in range(rows):
        active = counts > i
        a = arrivals[i]
        st = torch.maximum(a, free[0])
        ct = st + services[i]
        if c == 1:
            free = [ct]
        else:
            cur, nxt = ct, []
            for j in range(1, c):
                nxt.append(torch.minimum(free[j], cur))
                cur = torch.maximum(free[j], cur)
            nxt.append(cur)
            free = nxt
        w = torch.where(active, st - a, 0.0)
        lat = torch.where(active, ct - a, 0.0)
        waits[i] = w
        lats[i] = lat
        wait_sum = wait_sum + w
        lat_sum = lat_sum + lat
        ok = ok + ((lat <= slo) & active)
    return LindleyOut(waits, lats, wait_sum, lat_sum, ok)
