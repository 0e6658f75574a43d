"""Shared neural-net layers: RMSNorm, RoPE, gated MLPs, embeddings.

The port's counterpart of ``repro/models/layers.py``.  :func:`rmsnorm` runs
the RMSNorm kernel (K3) on CUDA tensors and its plain version on CPU ones.
The cross-entropy loss waits for the training slice.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..kernels.rmsnorm import rmsnorm as _rmsnorm_kernel
from .common import ModelConfig, ParamSpec

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# normalization
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> ParamSpec:
    return ParamSpec(shape=(d,), axes=(None,), init="ones")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim, statistics in fp32, output in x's dtype
    (kernel K3 on the card)."""
    return _rmsnorm_kernel(x.contiguous(), weight.to(x.dtype), eps=eps)


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float,
                     device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Apply RoPE.  x: (..., seq, heads, head_dim); positions: (..., seq).
    The two halves of the head dim rotate together; angles in fp32."""
    head_dim = x.shape[-1]
    freqs = rope_frequencies(head_dim, theta, x.device)           # (hd/2,)
    angles = positions[..., :, None].float() * freqs              # (..., seq, hd/2)
    cos = torch.cos(angles)[..., :, None, :]                      # (..., seq, 1, hd/2)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_specs(cfg: ModelConfig, d_ff: Optional[int] = None) -> Dict[str, ParamSpec]:
    f = d_ff if d_ff is not None else cfg.d_ff
    d = cfg.d_model
    if cfg.act in ("swiglu", "geglu"):
        return {
            "wi": ParamSpec((d, f), ("embed", "mlp"), "scaled"),
            "wg": ParamSpec((d, f), ("embed", "mlp"), "scaled"),
            "wo": ParamSpec((f, d), ("mlp", "embed"), "scaled"),
        }
    return {
        "wi": ParamSpec((d, f), ("embed", "mlp"), "scaled"),
        "wo": ParamSpec((f, d), ("mlp", "embed"), "scaled"),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.gelu's default is the tanh approximation
    return F.gelu(x, approximate="tanh")


def mlp_apply(params: Params, x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = F.silu(x @ params["wg"]) * (x @ params["wi"])
    elif act == "geglu":
        h = _gelu(x @ params["wg"]) * (x @ params["wi"])
    else:
        h = _gelu(x @ params["wi"])
    return h @ params["wo"]


# ---------------------------------------------------------------------------
# embeddings / unembedding
# ---------------------------------------------------------------------------


def embed_specs(cfg: ModelConfig) -> Dict[str, ParamSpec]:
    specs: Dict[str, ParamSpec] = {
        "embedding": ParamSpec(
            (cfg.vocab_size, cfg.d_model), ("vocab", "embed"), "normal", 1.0
        ),
        "final_norm": rmsnorm_spec(cfg.d_model),
    }
    if not cfg.tied_embeddings:
        specs["unembed"] = ParamSpec(
            (cfg.d_model, cfg.vocab_size), ("embed", "vocab"), "scaled"
        )
    return specs


def embed_tokens(params: Params, tokens: torch.Tensor,
                 dtype: torch.dtype) -> torch.Tensor:
    return params["embedding"].to(dtype)[tokens]


def unembed(params: Params, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Final RMSNorm and the vocab projection.  The reference pins layouts
    here for its sharded mesh (``act_hints``); on one card there is nothing
    to pin."""
    x = rmsnorm(x, params["final_norm"], cfg.norm_eps)
    if cfg.tied_embeddings:
        logits = x @ params["embedding"].to(x.dtype).T
    else:
        logits = x @ params["unembed"].to(x.dtype)
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits
