"""Model substrate of the port: the dense family's serving path in PyTorch.

``Model`` (``model.py``) runs prefill and decode with RMSNorm, prefill
attention and decode attention in the port's CUDA kernels
(``repro_torch.kernels.rmsnorm``, ``flash_attention``, ``decode_attention``).
"""

from .common import ModelConfig, ParamSpec
from .model import Model
from .registry import arch_ids, build_model, get_config, get_model, register_arch

__all__ = [
    "ModelConfig",
    "ParamSpec",
    "Model",
    "arch_ids",
    "build_model",
    "get_config",
    "get_model",
    "register_arch",
]
