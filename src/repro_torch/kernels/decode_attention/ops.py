"""Wrapper of the decode attention kernel (K5).

On CUDA tensors it launches ``csrc/decode_attention.cu`` on PyTorch's
current stream, or raises; on CPU tensors it runs the plain version
(:func:`.ref.decode_attention_ref`).  ``decode_attention.launches`` counts
kernel launches, and ``decode_attention.record`` (a dict, or None: see
:mod:`..record`) keeps copies of the inputs of the first launch at each
shape and dtype (copies, because decoding writes the cache in place).
"""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Union

import torch

from .. import build
from ..record import remember
from .ref import decode_attention_ref

HEAD_DIMS = (32, 64, 128, 256)
MAX_GROUP_ELEMS = 64 * 32      # G * hd a block keeps in registers
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _i64, _int = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _library() -> ctypes.CDLL:
    lib = build.load("decode_attention")
    if lib.decode_attention_launch.argtypes is None:
        lib.decode_attention_launch.argtypes = (
            [_int, _int, _vp, _vp, _vp, _vp, _vp] + [_int] * 5
            + [_i64] * 10 + [ctypes.c_float, _vp])
        lib.decode_attention_launch.restype = ctypes.c_int
        lib.decode_attention_error_string.argtypes = [ctypes.c_int]
        lib.decode_attention_error_string.restype = ctypes.c_char_p
    return lib


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: torch.Tensor) -> None:
    if (q.dim() != 3 or k.dim() != 4 or v.shape != k.shape
            or k.shape[0] != q.shape[0] or k.shape[3] != q.shape[2]):
        raise ValueError(f"q must be (B, H, hd) and k, v (B, S, KV, hd), got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if q.shape[1] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[1]} not a multiple of kv heads "
                         f"{k.shape[2]}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k and v must share a dtype, float32 or bfloat16, "
                        f"got {q.dtype}, {k.dtype}, {v.dtype}")
    if length.dtype != torch.int32 or length.numel() != 1:
        raise TypeError(f"length must be one int32, got {length.dtype} "
                        f"{tuple(length.shape)}")
    if not (q.device == k.device == v.device == length.device):
        raise ValueError("q, k, v and length must share a device")
    if q.stride(-1) != 1 or k.stride(-1) != 1 or v.stride(-1) != 1:
        raise ValueError("q, k and v need unit stride on the head dim")


def decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     length: Union[int, torch.Tensor], *,
                     scale: Optional[float] = None) -> torch.Tensor:
    """One-token GQA decode.  q: (B, H, hd); cache k, v: (B, S, KV, hd),
    read in place; slots at or past ``length`` (a () int32 tensor on q's
    device, never read on the host) are masked.  CUDA tensors go to the
    kernel, CPU tensors to the plain version."""
    if not isinstance(length, torch.Tensor):
        length = torch.tensor(length, dtype=torch.int32, device=q.device)
    _check(q, k, v, length)
    if q.device.type == "cpu":
        return decode_attention_ref(q, k, v, length, scale=scale)
    if q.device.type != "cuda":
        raise ValueError(f"unsupported device {q.device}")
    b, h, hd = q.shape
    s, kv = k.shape[1], k.shape[2]
    g = h // kv
    if hd not in HEAD_DIMS or g * hd > MAX_GROUP_ELEMS:
        raise ValueError(f"head dim {hd} must be one of {HEAD_DIMS} and "
                         f"G * hd ({g} * {hd}) at most {MAX_GROUP_ELEMS}")
    lib = _library()
    scale = scale if scale is not None else 1.0 / math.sqrt(hd)
    o = torch.empty((b, h, hd), dtype=q.dtype, device=q.device)
    remember(decode_attention.record,
             (tuple(q.shape), tuple(k.shape), q.dtype),
             lambda: (q.clone(), k.clone(), v.clone(), length.clone()))
    stream = torch.cuda.current_stream(q.device).cuda_stream
    err = lib.decode_attention_launch(
        q.device.index, DTYPES[q.dtype], q.data_ptr(), k.data_ptr(),
        v.data_ptr(), length.data_ptr(), o.data_ptr(), b, s, kv, g, hd,
        q.stride(0), q.stride(1), k.stride(0), k.stride(1), k.stride(2),
        v.stride(0), v.stride(1), v.stride(2), o.stride(0), o.stride(1),
        scale, stream)
    if err != 0:
        msg = lib.decode_attention_error_string(err).decode()
        raise RuntimeError(f"decode_attention kernel launch failed: {msg} "
                           f"(cuda error {err})")
    decode_attention.launches += 1
    return o


decode_attention.launches = 0
decode_attention.record = None
