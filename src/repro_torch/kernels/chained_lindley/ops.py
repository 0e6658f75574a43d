"""Wrapper of the chained Lindley scan kernel (K2).

On a CUDA tensor it launches ``csrc/chained_lindley.cu`` on PyTorch's
current stream, or raises; on a CPU tensor it runs the plain version
(:func:`.ref.chained_lindley_scan_ref`).  ``chained_lindley_scan.launches``
counts kernel launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes

import torch

from .. import build
from .ref import chained_lindley_scan_ref

MAX_STAGES = 16    # the kernel is instantiated for 1..16 stages a launch

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


def _library() -> ctypes.CDLL:
    lib = build.load("chained_lindley")
    if lib.chained_lindley_f64.argtypes is None:
        lib.chained_lindley_f64.argtypes = [
            ctypes.c_int, _vp, _vp, _vp, _i64, _i64, ctypes.c_int, _vp, _vp]
        lib.chained_lindley_f64.restype = ctypes.c_int
        lib.chained_lindley_error_string.argtypes = [ctypes.c_int]
        lib.chained_lindley_error_string.restype = ctypes.c_char_p
    return lib


def _check(arrivals: torch.Tensor, services: torch.Tensor,
           counts: torch.Tensor) -> None:
    if (arrivals.dim() != 2 or services.dim() != 3
            or services.shape[1:] != arrivals.shape
            or services.shape[0] < 1):
        raise ValueError(f"arrivals must be (N, B) and services (J, N, B) "
                         f"with J >= 1, got {tuple(arrivals.shape)} and "
                         f"{tuple(services.shape)}")
    if arrivals.dtype != torch.float64 or services.dtype != torch.float64:
        raise TypeError(f"arrivals and services must be float64, got "
                        f"{arrivals.dtype} and {services.dtype}")
    if arrivals.device != services.device:
        raise ValueError("arrivals and services must share a device")
    if not (arrivals.is_contiguous() and services.is_contiguous()):
        raise ValueError("arrivals and services must be contiguous")
    if arrivals.shape[1] < 1:
        raise ValueError("need at least one lane (B >= 1)")
    if (counts.dtype != torch.int64 or counts.device.type != "cpu"
            or counts.shape != (arrivals.shape[1],)):
        raise ValueError(f"counts must be an int64 host tensor of shape "
                         f"({arrivals.shape[1]},), got {counts.dtype} "
                         f"{tuple(counts.shape)} on {counts.device}")
    n = arrivals.shape[0]
    if bool(((counts < 0) | (counts > n)).any()):
        raise ValueError(f"counts must lie in 0..{n}")


def chained_lindley_scan(arrivals: torch.Tensor, services: torch.Tensor,
                         counts: torch.Tensor) -> torch.Tensor:
    """Per-stage completions (J, N, B) of a c = 1 tandem over fp64 grids.

    ``arrivals`` (N, B) in FIFO order, ``services`` (J, N, B); ``counts``
    is a host int64 tensor: ``counts[b]`` rows of lane b are live, the rest
    come out ``+inf``.  It is checked on the host, so a launch never waits
    for the device.  More than :data:`MAX_STAGES` stages run as consecutive
    launches, each fed the last stored completion of the one before.  CUDA
    grids go to the kernel, CPU grids to the plain version."""
    _check(arrivals, services, counts)
    if arrivals.device.type == "cpu":
        return chained_lindley_scan_ref(arrivals, services, counts)
    if arrivals.device.type != "cuda":
        raise ValueError(f"unsupported device {arrivals.device}")
    lib = _library()
    stages, n, b = services.shape
    dev_counts = counts.to(arrivals.device).contiguous()
    comps = torch.empty_like(services)
    stream = torch.cuda.current_stream(arrivals.device).cuda_stream
    arr = arrivals
    for j0 in range(0, stages, MAX_STAGES):
        j1 = min(stages, j0 + MAX_STAGES)
        err = lib.chained_lindley_f64(
            arrivals.device.index, arr.data_ptr(), services[j0].data_ptr(),
            dev_counts.data_ptr(), n, b, j1 - j0, comps[j0].data_ptr(),
            stream)
        if err != 0:
            msg = lib.chained_lindley_error_string(err).decode()
            raise RuntimeError(f"chained_lindley_scan kernel launch failed: "
                               f"{msg} (cuda error {err})")
        chained_lindley_scan.launches += 1
        arr = comps[j1 - 1]
    return comps


chained_lindley_scan.launches = 0
