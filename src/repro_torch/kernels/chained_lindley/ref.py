"""Plain PyTorch version of the chained Lindley scan kernel.

The same recursion as ``csrc/chained_lindley.cu``, as a Python loop over
rows on torch B-vectors, in the kernel's op order (the P/M order of the
JAX package's ``_jax_chained_seq``): every completion it returns is
bit-equal to the kernel's.  The tests hold it against ``_jax_chained_seq``
and the Pallas ``chained_lindley_scan``; ``chip_smoke.py`` holds the kernel
against it on the card.
"""

from __future__ import annotations

import math

import torch


def chained_lindley_scan_ref(arrivals: torch.Tensor, services: torch.Tensor,
                             counts: torch.Tensor) -> torch.Tensor:
    """Per-stage completion times (J, N, B) of a tandem of c = 1 stages.

    ``arrivals`` (N, B) are each lane's external arrivals in FIFO order,
    ``services`` (J, N, B) the stages' service times in that order, and
    ``counts`` a host int64 tensor: lane b runs rows ``0 .. counts[b] - 1``
    and comes out ``+inf`` past them.  Stage j carries ``p = cumsum(s)``
    and ``m = cummax(arr - (p - s))``; its completion ``p + m`` is stage
    j+1's arrival."""
    stages, n, b = services.shape
    comps = torch.full_like(services, math.inf)
    p = [torch.zeros(b, dtype=services.dtype, device=services.device)] * stages
    m = [torch.full((b,), -math.inf, dtype=services.dtype,
                    device=services.device)] * stages
    rows = min(int(counts.max()), n) if b and n else 0
    counts = counts.to(services.device)
    for i in range(rows):
        active = counts > i
        arr = arrivals[i]
        for j in range(stages):
            s = services[j, i]
            p[j] = p[j] + s
            m[j] = torch.maximum(m[j], arr - (p[j] - s))
            arr = p[j] + m[j]
            comps[j, i] = torch.where(active, arr, math.inf)
    return comps
