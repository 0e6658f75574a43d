"""Wrapper of the prefill attention kernel (K4).

On CUDA tensors it launches ``csrc/flash_attention.cu`` on PyTorch's
current stream, or raises; on CPU tensors it runs the plain version
(:func:`.ref.attention_ref`).  ``flash_attention.launches`` counts kernel
launches, and ``flash_attention.record`` (a dict, or None: see
:mod:`..record`) keeps the inputs of the first launch at each shape, dtype
and mask.
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional

import torch

from .. import build
from ..record import remember
from .ref import attention_ref

HEAD_DIMS = (32, 64, 128, 256)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    if lib.flash_attention_launch.argtypes is None:
        lib.flash_attention_launch.argtypes = (
            [_int, _int, _vp, _vp, _vp, _vp] + [_int] * 7 + [_i64] * 12
            + [ctypes.c_float, _vp])
        lib.flash_attention_launch.restype = ctypes.c_int
        lib.flash_attention_error_string.argtypes = [ctypes.c_int]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if (q.dim() != 4 or k.dim() != 4 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[2:] != q.shape[2:]):
        raise ValueError(f"q must be (B, H, S, hd) and k, v (B, KV, S, hd), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[1] % k.shape[1]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[1]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError("q, k and v must share a device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride on the head dim")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    scale: Optional[float] = None) -> torch.Tensor:
    """Masked softmax attention.  q: (B, H, S, hd); k, v: (B, KV, S, hd),
    any strides with a unit stride on hd (a (B, S, H, hd) projection
    transposed is read in place).  The output has q's shape, dtype and
    strides.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    _check(q, k, v)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, window=window,
                             scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, s, hd = q.shape
    g = h // k.shape[1]
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim {hd} must be one of {HEAD_DIMS}")
    lib = _library()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty_like(q)
    if o.numel() == 0:
        return o
    remember(flash_attention.record,
             (tuple(q.shape), tuple(k.shape), q.dtype, causal, window),
             lambda: (q, k, v))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.flash_attention_launch(
        q.device.index, DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), o.data_ptr(), b, h, s, g, hd, int(causal), int(window),
        q.stride(0), q.stride(1), q.stride(2), k.stride(0), k.stride(1),
        k.stride(2), v.stride(0), v.stride(1), v.stride(2), o.stride(0),
        o.stride(1), o.stride(2), scale, stream)
    if err != 0:
        msg = lib.flash_attention_error_string(err).decode()
        raise RuntimeError(f"flash_attention kernel launch failed: {msg} "
                           f"(cuda error {err})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
flash_attention.record = None
