"""Attention: GQA with RoPE, causal / prefix-LM / sliding-window masks,
full-sequence (prefill) and single-token KV-cache decode paths.

The port's counterpart of ``repro/models/attention.py``.  The causal and
sliding-window self-attention of :func:`full_attention` runs the prefill
attention kernel (K4) and :func:`decode_attention` the decode attention
kernel (K5) on CUDA tensors, their plain versions on CPU ones.
:func:`attend` is the reference's plain masked softmax, kept for the masks
the kernels do not take (a prefix-LM prefix, cross-attention) and for the
tests.

:func:`decode_attention` writes the new token's key and value into the
cache tensors in place (the reference returns updated copies): a step
costs one slot's write, not a copy of the cache.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..kernels.decode_attention import decode_attention as _decode_kernel
from ..kernels.flash_attention import flash_attention as _flash_kernel
from .common import ModelConfig, ParamSpec
from .layers import apply_rope

Params = Dict[str, torch.Tensor]


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


def attention_specs(cfg: ModelConfig, *, cross: bool = False) -> Dict[str, ParamSpec]:
    d, h, kv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((d, h, hd), ("embed", "heads", "head"), "scaled"),
        "wk": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head"), "scaled"),
        "wv": ParamSpec((d, kv, hd), ("embed", "kv_heads", "head"), "scaled"),
        "wo": ParamSpec((h, hd, d), ("heads", "head", "embed"), "scaled"),
    }


# ---------------------------------------------------------------------------
# masks
# ---------------------------------------------------------------------------


def make_mask(q_len: int, kv_len: int, *, causal: bool = True,
              window: int = 0, prefix_len: int = 0, q_offset: int = 0,
              device: Optional[torch.device] = None) -> torch.Tensor:
    """Boolean (q_len, kv_len) mask.  True = attend.

    ``window > 0`` restricts to the last ``window`` positions (inclusive of
    self).  ``prefix_len > 0`` makes the first ``prefix_len`` kv positions
    visible to everyone (PaliGemma-style prefix-LM).  ``q_offset`` shifts
    query positions (decode / chunked prefill).
    """
    q_pos = torch.arange(q_len, device=device)[:, None] + q_offset
    kv_pos = torch.arange(kv_len, device=device)[None, :]
    if causal:
        mask = kv_pos <= q_pos
    else:
        mask = torch.ones((q_len, kv_len), dtype=torch.bool, device=device)
    if window > 0:
        mask = mask & (kv_pos > q_pos - window)
    if prefix_len > 0:
        mask = mask | (kv_pos < prefix_len)
    return mask


# ---------------------------------------------------------------------------
# core attention math
# ---------------------------------------------------------------------------


def _gqa_scores(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """q: (B, Sq, H, hd), k: (B, Skv, KV, hd) -> (B, H, Sq, Skv) with
    grouped-query head sharing."""
    b, sq, h, hd = q.shape
    kv = k.shape[2]
    group = h // kv
    qg = q.reshape(b, sq, kv, group, hd)
    scores = torch.einsum("bqkgd,bskd->bkgqs", qg, k)
    return scores.reshape(b, kv * group, sq, k.shape[1])


def _gqa_values(probs: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """probs: (B, H, Sq, Skv), v: (B, Skv, KV, hd) -> (B, Sq, H, hd)."""
    b, h, sq, skv = probs.shape
    kv = v.shape[2]
    group = h // kv
    pg = probs.reshape(b, kv, group, sq, skv)
    out = torch.einsum("bkgqs,bskd->bqkgd", pg, v)
    return out.reshape(b, sq, h, v.shape[3])


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           mask: Optional[torch.Tensor], *,
           scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention with fp32 scores (the reference's plain
    path).  q: (B, Sq, H, hd); k, v: (B, Skv, KV, hd); mask: (Sq, Skv) or
    broadcastable.  Returns (B, Sq, H, hd)."""
    hd = q.shape[-1]
    scale = scale if scale is not None else hd ** -0.5
    scores = _gqa_scores(q, k).float() * scale
    if mask is not None:
        scores = torch.where(mask, scores, torch.finfo(torch.float32).min)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return _gqa_values(probs, v)


# ---------------------------------------------------------------------------
# module-level forward paths
# ---------------------------------------------------------------------------


class KVCache(NamedTuple):
    """Decode-time key/value cache for one attention module.

    k, v: (B, S_cache, KV, hd).  ``index`` is the write position (ring buffer
    for sliding-window archs, linear for full attention).  ``length`` is the
    number of valid positions (<= S_cache).  Both are () int32 tensors on
    the cache's device, so a decode step never reads them on the host.

    With ``cfg.kv_cache_dtype == "int8"``, k/v are stored int8 with
    per-(token, kv-head) absmax scales in ``k_scale``/``v_scale``
    ((B, S_cache, KV), fp32).
    """

    k: torch.Tensor
    v: torch.Tensor
    index: torch.Tensor      # () int32 — next write slot
    length: torch.Tensor     # () int32 — valid entries
    k_scale: Optional[torch.Tensor] = None   # (B, S_cache, KV) fp32, int8 mode
    v_scale: Optional[torch.Tensor] = None


def _quantize_kv(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (..., hd) float -> (int8 values, (...,) fp32 absmax scales).
    ``torch.round`` rounds half to even, as ``jnp.round`` does."""
    xf = x.float()
    scale = torch.amax(torch.abs(xf), dim=-1) / 127.0
    scale = torch.clamp_min(scale, 1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor,
                   dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale[..., None].float()).to(dtype)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bsd,dhk->bshk"): (B, S, D) @ (D, H, hd) -> (B, S, H, hd)."""
    d, h, hd = w.shape
    return (x @ w.reshape(d, h * hd)).view(*x.shape[:-1], h, hd)


def _out_project(out: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """einsum("bshk,hkd->bsd"): (B, S, H, hd) @ (H, hd, D) -> (B, S, D)."""
    h, hd, d = w.shape
    return out.reshape(*out.shape[:-2], h * hd) @ w.reshape(h * hd, d)


def full_attention(
    params: Params,
    x: torch.Tensor,
    cfg: ModelConfig,
    *,
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    window: int = 0,
    prefix_len: int = 0,
    kv_source: Optional[torch.Tensor] = None,
    return_kv: bool = False,
):
    """Full-sequence attention (prefill).  x: (B, S, D).

    Self-attention without a prefix runs kernel K4, which reads the
    (B, S, H, hd) projections in place.  ``kv_source`` switches to
    cross-attention (no RoPE), which goes through :func:`attend`, as does
    a prefix-LM mask.  ``return_kv`` also returns the post-RoPE keys and
    values (B, S, KV, hd) for the decode cache.
    """
    b, s, _ = x.shape
    kv_in = kv_source if kv_source is not None else x
    q = _project(x, params["wq"])
    k = _project(kv_in, params["wk"])
    v = _project(kv_in, params["wv"])
    if kv_source is None:
        pos = (positions if positions is not None
               else torch.arange(s, device=x.device)[None, :])
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    if kv_source is None and prefix_len == 0:
        out = _flash_kernel(q.transpose(1, 2), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal,
                            window=window).transpose(1, 2)
    else:
        mask = None
        if kv_source is None:
            mask = make_mask(s, s, causal=causal, window=window,
                             prefix_len=prefix_len, device=x.device)
        out = attend(q, k, v, mask)
    y = _out_project(out, params["wo"])
    if return_kv:
        return y, (k, v)
    return y


def cache_from_prefill(k: torch.Tensor, v: torch.Tensor, cache_len: int,
                       *, cfg: Optional[ModelConfig] = None) -> KVCache:
    """Build a decode KVCache from prefill keys/values (B, S, KV, hd).

    If ``cache_len >= S`` the entries are written linearly and padded.  If
    ``cache_len < S`` (sliding-window archs) the last ``cache_len`` entries
    are kept and rolled so that position p sits in ring slot ``p % W``,
    matching :func:`decode_attention`'s write pattern.
    """
    b, s, kvh, hd = k.shape
    if cache_len >= s:
        pad = (0, 0, 0, 0, 0, cache_len - s)
        kc = torch.nn.functional.pad(k, pad)
        vc = torch.nn.functional.pad(v, pad)
        length = s
    else:
        w = cache_len
        kc = torch.roll(k[:, s - w:], shifts=s % w, dims=1)
        vc = torch.roll(v[:, s - w:], shifts=s % w, dims=1)
        length = w
    k_scale = v_scale = None
    if cfg is not None and cfg.kv_cache_dtype == "int8":
        kc, k_scale = _quantize_kv(kc)
        vc, v_scale = _quantize_kv(vc)
    return KVCache(
        k=kc.contiguous(),
        v=vc.contiguous(),
        index=torch.tensor(s, dtype=torch.int32, device=k.device),
        length=torch.tensor(length, dtype=torch.int32, device=k.device),
        k_scale=k_scale,
        v_scale=v_scale,
    )


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype: torch.dtype,
               device: Optional[torch.device] = None) -> KVCache:
    shape = (batch, max_len, cfg.num_kv_heads, cfg.head_dim)
    zero = torch.zeros((), dtype=torch.int32, device=device)
    if cfg.kv_cache_dtype == "int8":
        return KVCache(
            k=torch.zeros(shape, dtype=torch.int8, device=device),
            v=torch.zeros(shape, dtype=torch.int8, device=device),
            index=zero,
            length=zero.clone(),
            k_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
            v_scale=torch.zeros(shape[:3], dtype=torch.float32, device=device),
        )
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        index=zero,
        length=zero.clone(),
    )


def decode_attention(
    params: Params,
    x: torch.Tensor,
    cache: KVCache,
    cfg: ModelConfig,
    *,
    position: torch.Tensor,
) -> Tuple[torch.Tensor, KVCache]:
    """Single-token decode.  x: (B, 1, D); position: () int32 tensor — the
    absolute position of the new token (RoPE).  Returns (B, 1, D) and the
    cache, updated in place.

    The cache is a ring buffer of size S_cache; for full-attention archs
    S_cache = max context and ``index`` never wraps within a run, for
    sliding-window archs S_cache = window and writes wrap.  Slots at or
    past the new ``length`` are masked by kernel K5.  An int8 cache is
    dequantized whole to the activation dtype first, as in the reference.
    """
    b = x.shape[0]
    s_cache = cache.k.shape[1]
    q = _project(x, params["wq"])
    k_new = _project(x, params["wk"])
    v_new = _project(x, params["wv"])
    pos = position.reshape(1, 1)
    q = apply_rope(q, pos, cfg.rope_theta)
    k_new = apply_rope(k_new, pos, cfg.rope_theta)

    slot = torch.remainder(cache.index, s_cache).reshape(1).long()
    quantized = cache.k_scale is not None
    if quantized:
        kq, ks = _quantize_kv(k_new)
        vq, vs = _quantize_kv(v_new)
        cache.k.index_copy_(1, slot, kq)
        cache.v.index_copy_(1, slot, vq)
        cache.k_scale.index_copy_(1, slot, ks)
        cache.v_scale.index_copy_(1, slot, vs)
        k = _dequantize_kv(cache.k, cache.k_scale, x.dtype)
        v = _dequantize_kv(cache.v, cache.v_scale, x.dtype)
    else:
        cache.k.index_copy_(1, slot, k_new.to(cache.k.dtype))
        cache.v.index_copy_(1, slot, v_new.to(cache.v.dtype))
        k, v = cache.k, cache.v
    new_len = torch.clamp_max(cache.length + 1, s_cache)

    out = _decode_kernel(q.reshape(b, q.shape[2], q.shape[3]), k, v, new_len)
    y = _out_project(out.reshape(b, 1, *out.shape[1:]), params["wo"])
    return y, KVCache(k=cache.k, v=cache.v, index=cache.index + 1,
                      length=new_len, k_scale=cache.k_scale,
                      v_scale=cache.v_scale)
