"""Plain PyTorch version of the prefill attention kernel (K4): the function
the Pallas ``flash_attention`` (``repro/kernels/flash_attention``) computes,
in fp32, with its masking constant; fully masked rows give zeros."""

from __future__ import annotations

import math
from typing import Optional

import torch

NEG_INF = -1.0e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, S, hd); k, v: (B, KV, S, hd) -> (B, H, S, hd), q's dtype.
    Query head h reads kv head ``h // (H // KV)``."""
    b, h, s, hd = q.shape
    kv = k.shape[1]
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    group = h // kv
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    scores = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf) * scale
    q_pos = torch.arange(s, device=q.device)[:, None]
    k_pos = torch.arange(s, device=q.device)[None, :]
    mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
    if causal:
        mask &= k_pos <= q_pos
    if window > 0:
        mask &= k_pos > q_pos - window
    scores = torch.where(mask, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    # fully masked rows -> zeros
    probs = torch.where(mask.any(-1)[None, None, :, None], probs,
                        torch.zeros_like(probs))
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf)
    return out.to(q.dtype)
