"""Compass on PyTorch and CUDA: the port of the JAX package ``repro``.

Same module paths and names as ``repro``: every counterpart of
``repro/x/y.py`` lives at ``repro_torch/x/y.py``.  The framework-neutral
modules (search, planning, queueing models, the event-heap simulator) are
kept as copies, so this package imports nothing of ``repro``; the sweep
engine (:mod:`repro_torch.serving.fastsim`) runs its recursion in a
hand-written Hopper kernel (:mod:`repro_torch.kernels.lindley_scan`).

Entry points take ``device=None``, meaning the CUDA card; they raise
:class:`RuntimeError` when there is none (:func:`resolve_device`).  The CPU
runs only when the caller asks for it with ``device="cpu"``.
"""

from .device import CudaStatus, cuda_available, resolve_device

__all__ = ["CudaStatus", "cuda_available", "resolve_device"]
