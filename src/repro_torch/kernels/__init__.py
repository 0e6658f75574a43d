"""Hand-written Hopper kernels of the port, one package per kernel:
``ops.py`` (the wrapper: checks, launch, launch count), ``ref.py`` (the
plain PyTorch version the tests and ``chip_smoke.py`` compare against),
CUDA sources under ``repro_torch/csrc/``, built by :mod:`.build`."""
