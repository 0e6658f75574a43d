"""Transformer blocks: one spec/apply/decode interface over block types.

The port's counterpart of ``repro/models/blocks.py``.  The port has the
``dense`` block (pre-norm attention + MLP, with residuals), the block of the
dense family's serving path.  The other block types of the reference come
with their slices (``ROADMAP.md`` §1) and raise here.
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import torch

from . import attention as attn
from .common import ModelConfig
from .layers import mlp_apply, mlp_specs, rmsnorm, rmsnorm_spec

BLOCK_TYPES = ("dense", "moe", "hybrid", "mlstm", "slstm", "encoder", "cross")

# the ROADMAP slice that brings each block type the port does not have yet
_LATER = {
    "hybrid": "the hybrid family's serving path (hymba-1.5b, models/ssm.py, K7)",
    "moe": "the remaining families (moe)",
    "mlstm": "the remaining families (xlstm)",
    "slstm": "the remaining families (xlstm)",
    "encoder": "the remaining families (encdec)",
    "cross": "the remaining families (encdec)",
}


def _unported(block_type: str) -> NotImplementedError:
    if block_type not in BLOCK_TYPES:
        return NotImplementedError(f"unknown block type {block_type!r}")
    return NotImplementedError(
        f"block type {block_type!r} is not ported yet; it comes with "
        f"{_LATER[block_type]} (ROADMAP.md, slices)")


def block_specs(cfg: ModelConfig, block_type: str, *,
                d_ff: Optional[int] = None) -> Dict:
    if block_type == "dense":
        return {
            "attn_norm": rmsnorm_spec(cfg.d_model),
            "attn": attn.attention_specs(cfg),
            "mlp_norm": rmsnorm_spec(cfg.d_model),
            "mlp": mlp_specs(cfg, d_ff=d_ff),
        }
    raise _unported(block_type)


def block_apply_seq(
    params: Dict,
    x: torch.Tensor,
    cfg: ModelConfig,
    block_type: str,
    *,
    positions: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
    cache_len: int = 0,       # > 0: also build+return decode state (prefill)
) -> Tuple[torch.Tensor, torch.Tensor, Any]:
    """Apply one block to (B, S, D).  Returns (y, aux_loss, state|None).

    ``cache_len > 0`` marks the prefill path: the block's attention builds
    a KVCache of that size.
    """
    if block_type != "dense":
        raise _unported(block_type)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    state: Any = None
    h = rmsnorm(x, params["attn_norm"], cfg.norm_eps)
    res = attn.full_attention(
        params["attn"], h, cfg,
        positions=positions, causal=True, window=cfg.sliding_window,
        prefix_len=prefix_len, return_kv=cache_len > 0,
    )
    if cache_len > 0:
        h, (k, v) = res
        state = attn.cache_from_prefill(k, v, cache_len, cfg=cfg)
    else:
        h = res
    x = x + h
    h = rmsnorm(x, params["mlp_norm"], cfg.norm_eps)
    h = mlp_apply(params["mlp"], h, cfg.act)
    return x + h, aux, state


def block_init_state(cfg: ModelConfig, block_type: str, batch: int,
                     cache_len: int, dtype: torch.dtype,
                     device: Optional[torch.device] = None) -> Any:
    if block_type != "dense":
        raise _unported(block_type)
    return attn.init_cache(cfg, batch, cache_len, dtype, device)


def block_apply_decode(
    params: Dict,
    x: torch.Tensor,
    state: Any,
    cfg: ModelConfig,
    block_type: str,
    *,
    position: torch.Tensor,
) -> Tuple[torch.Tensor, Any]:
    """One-token decode through one block.  x: (B, 1, D)."""
    if block_type != "dense":
        raise _unported(block_type)
    h = rmsnorm(x, params["attn_norm"], cfg.norm_eps)
    h, new_state = attn.decode_attention(params["attn"], h, state, cfg,
                                         position=position)
    x = x + h
    h = rmsnorm(x, params["mlp_norm"], cfg.norm_eps)
    h = mlp_apply(params["mlp"], h, cfg.act)
    return x + h, new_state
