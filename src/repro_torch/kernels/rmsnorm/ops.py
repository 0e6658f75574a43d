"""Wrapper of the RMSNorm kernel (K3).

On a CUDA tensor it launches ``csrc/rmsnorm.cu`` on PyTorch's current
stream, or raises; on a CPU tensor it runs the plain version
(:func:`.ref.rmsnorm_ref`).  ``rmsnorm.launches`` counts kernel launches,
and ``rmsnorm.record`` (a dict, or None: see :mod:`..record`) keeps the
inputs of the first launch at each shape and dtype.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from ..record import remember
from .ref import rmsnorm_ref

MAX_D = 16384
DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


def _library() -> ctypes.CDLL:
    lib = build.load("rmsnorm")
    if lib.rmsnorm_launch.argtypes is None:
        lib.rmsnorm_launch.argtypes = [
            ctypes.c_int, ctypes.c_int, _vp, _vp, _vp, _i64, ctypes.c_int,
            _i64, _i64, ctypes.c_float, _vp]
        lib.rmsnorm_launch.restype = ctypes.c_int
        lib.rmsnorm_error_string.argtypes = [ctypes.c_int]
        lib.rmsnorm_error_string.restype = ctypes.c_char_p
    return lib


def _check(x: torch.Tensor, weight: torch.Tensor) -> None:
    if x.dim() < 1 or weight.shape != (x.shape[-1],):
        raise ValueError(f"x must be (..., D) and weight (D,), got "
                         f"{tuple(x.shape)} and {tuple(weight.shape)}")
    if x.dtype not in DTYPES or weight.dtype != x.dtype:
        raise TypeError(f"x and weight must share a dtype, float32 or "
                        f"bfloat16, got {x.dtype} and {weight.dtype}")
    if x.device != weight.device:
        raise ValueError("x and weight must share a device")
    if not (x.is_contiguous() and weight.is_contiguous()):
        raise ValueError("x and weight must be contiguous")
    if not 1 <= x.shape[-1] <= MAX_D:
        raise ValueError(f"D must lie in 1..{MAX_D}, got {x.shape[-1]}")


def rmsnorm(x: torch.Tensor, weight: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm over the last dim of x (..., D), statistics in fp32, output
    in x's dtype.  CUDA tensors go to the kernel, CPU tensors to the plain
    version."""
    _check(x, weight)
    if x.device.type == "cpu":
        return rmsnorm_ref(x, weight, eps=eps)
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    lib = _library()
    d = x.shape[-1]
    rows = x.numel() // d
    y = torch.empty_like(x)
    if rows == 0:
        return y
    remember(rmsnorm.record, (tuple(x.shape), x.dtype),
             lambda: (x, weight, eps))
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = lib.rmsnorm_launch(x.device.index, DTYPES[x.dtype], x.data_ptr(),
                             weight.data_ptr(), y.data_ptr(), rows, d, d, d,
                             eps, stream)
    if err != 0:
        msg = lib.rmsnorm_error_string(err).decode()
        raise RuntimeError(f"rmsnorm kernel launch failed: {msg} "
                           f"(cuda error {err})")
    rmsnorm.launches += 1
    return y


rmsnorm.launches = 0
rmsnorm.record = None
