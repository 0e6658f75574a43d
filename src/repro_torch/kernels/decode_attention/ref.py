"""Plain PyTorch version of the decode attention kernel (K5): the function
the Pallas ``decode_attention`` (``repro/kernels/decode_attention``)
computes, in fp32, with its masking constant."""

from __future__ import annotations

import math
from typing import Optional, Union

import torch

NEG_INF = -1.0e30


def decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         length: Union[int, torch.Tensor], *,
                         scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, H, hd), one token per sequence; k, v: (B, S, KV, hd), a ring
    cache whose slots at or past ``length`` (a () int32) are masked.
    Returns (B, H, hd) in q's dtype."""
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    qg = q.reshape(b, kv, g, hd).float()
    kt = k.transpose(1, 2).float()                     # (B, KV, S, hd)
    vt = v.transpose(1, 2).float()
    scores = torch.einsum("bjgd,bjsd->bjgs", qg, kt) * scale
    length = torch.as_tensor(length, dtype=torch.int32, device=q.device)
    valid = torch.arange(s, device=q.device)[None, None, None, :] < length
    scores = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bjgs,bjsd->bjgd", probs, vt)
    return out.reshape(b, h, hd).to(q.dtype)
