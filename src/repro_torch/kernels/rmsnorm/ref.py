"""Plain PyTorch version of the RMSNorm kernel (K3): the function the Pallas
``rmsnorm`` (``repro/kernels/rmsnorm/kernel.py``) computes, statistics in
fp32, output in x's dtype."""

from __future__ import annotations

import torch


def rmsnorm_ref(x: torch.Tensor, weight: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * weight`` over the last dim."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * weight.float()).to(x.dtype)
