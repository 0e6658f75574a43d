"""internlm2-1.8b [dense]: 24L d_model=2048 16H (GQA kv=8) d_ff=8192
vocab=92544.  [arXiv:2403.17297]
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "internlm2-1.8b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=24,
        d_model=2048,
        num_heads=16,
        num_kv_heads=8,
        head_dim=128,
        d_ff=8192,
        vocab_size=92544,
        rope_theta=1.0e6,          # internlm2 uses a large rope base
    )


register_arch(ARCH_ID, config)
