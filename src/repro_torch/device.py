"""Device selection for the port's entry points.

``device=None`` means the CUDA card.  Nothing falls back to the host: a
missing card is an error, and the CPU runs only when a caller names it.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Union

import torch


@dataclass(frozen=True)
class CudaStatus:
    """Whether a CUDA card is usable, and why not when it is not."""

    ok: bool
    reason: str

    def __bool__(self) -> bool:
        return self.ok


def cuda_available() -> CudaStatus:
    """Probe for a usable CUDA card; the reason names what is missing."""
    if torch.version.cuda is None:
        return CudaStatus(False, f"torch {torch.__version__} is built "
                                 f"without CUDA")
    if not torch.cuda.is_available():
        return CudaStatus(False, "torch.cuda.is_available() is False "
                                 "(no card visible to this process)")
    return CudaStatus(True, torch.cuda.get_device_name(0))


def resolve_device(device: Optional[Union[str, torch.device]] = None
                   ) -> torch.device:
    """The device an entry point runs on.

    ``None`` and ``"cuda"`` resolve to the current CUDA card and raise
    :class:`RuntimeError` when there is none; ``"cpu"`` is returned as
    asked.  Any other device type is rejected."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return dev
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev} (expected cuda or cpu)")
    status = cuda_available()
    if not status:
        raise RuntimeError(f"device {dev} requested but no CUDA card is "
                           f"usable: {status.reason}")
    if dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
