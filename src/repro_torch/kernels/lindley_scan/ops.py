"""Wrapper of the Lindley / Kiefer-Wolfowitz sweep kernel.

On a CUDA tensor it launches ``csrc/lindley_scan.cu`` on PyTorch's current
stream, or raises; on a CPU tensor it runs the plain version
(:func:`.ref.lindley_scan_ref`).  ``lindley_scan.launches`` counts kernel
launches, so a run can show that it went through the kernel.
"""

from __future__ import annotations

import ctypes
import math

import torch

from .. import build
from .ref import LindleyOut, lindley_scan_ref

MAX_SERVERS = 32   # the kernel's comparator chain is instantiated for 1..32

_vp, _i64 = ctypes.c_void_p, ctypes.c_int64


def _library() -> ctypes.CDLL:
    lib = build.load("lindley_scan")
    if lib.lindley_scan_f64.argtypes is None:
        lib.lindley_scan_f64.argtypes = [
            ctypes.c_int, _vp, _vp, _vp, ctypes.c_double, _i64, _i64,
            ctypes.c_int, _vp, _vp, _vp, _vp, _vp, _vp]
        lib.lindley_scan_f64.restype = ctypes.c_int
        lib.lindley_scan_error_string.argtypes = [ctypes.c_int]
        lib.lindley_scan_error_string.restype = ctypes.c_char_p
    return lib


def _check(arrivals: torch.Tensor, services: torch.Tensor,
           counts: torch.Tensor, num_servers: int) -> None:
    if arrivals.dim() != 2 or services.shape != arrivals.shape:
        raise ValueError(f"arrivals and services must be (N, B) of one "
                         f"shape, got {tuple(arrivals.shape)} and "
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
    if not 1 <= int(num_servers) <= MAX_SERVERS:
        raise ValueError(f"num_servers must be in 1..{MAX_SERVERS}, "
                         f"got {num_servers}")


def lindley_scan(arrivals: torch.Tensor, services: torch.Tensor,
                 counts: torch.Tensor, *, num_servers: int = 1,
                 slo: float = math.inf) -> LindleyOut:
    """FIFO M/G/c waits and latencies of B lanes over (N, B) fp64 grids.

    ``counts`` is a host int64 tensor: ``counts[b]`` rows of lane b are
    live, the rest come out 0.  It is checked on the host, so a launch
    never waits for the device.  Returns (waits, lats, wait_sum, lat_sum,
    ok) as :class:`.ref.LindleyOut`, on the grids' device.  CUDA grids go
    to the kernel, CPU grids to the plain version."""
    _check(arrivals, services, counts, num_servers)
    if arrivals.device.type == "cpu":
        return lindley_scan_ref(arrivals, services, counts,
                                num_servers=num_servers, slo=slo)
    if arrivals.device.type != "cuda":
        raise ValueError(f"unsupported device {arrivals.device}")
    lib = _library()
    n, b = arrivals.shape
    counts = counts.to(arrivals.device).contiguous()
    waits = torch.empty_like(arrivals)
    lats = torch.empty_like(arrivals)
    wait_sum = torch.empty(b, dtype=torch.float64, device=arrivals.device)
    lat_sum = torch.empty_like(wait_sum)
    ok = torch.empty(b, dtype=torch.int64, device=arrivals.device)
    stream = torch.cuda.current_stream(arrivals.device).cuda_stream
    err = lib.lindley_scan_f64(
        arrivals.device.index, arrivals.data_ptr(), services.data_ptr(),
        counts.data_ptr(), float(slo), n, b, int(num_servers),
        waits.data_ptr(), lats.data_ptr(), wait_sum.data_ptr(),
        lat_sum.data_ptr(), ok.data_ptr(), stream)
    if err != 0:
        msg = lib.lindley_scan_error_string(err).decode()
        raise RuntimeError(f"lindley_scan kernel launch failed: {msg} "
                           f"(cuda error {err})")
    lindley_scan.launches += 1
    return LindleyOut(waits, lats, wait_sum, lat_sum, ok)


lindley_scan.launches = 0
