"""stablelm-3b [dense]: 32L d_model=2560 32H (kv=32, MHA) d_ff=6912
vocab=50304.  [hf:stabilityai/stablelm-2-1_6b family / stablelm-3b-4e1t]
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "stablelm-3b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=2560,
        num_heads=32,
        num_kv_heads=32,
        head_dim=80,
        d_ff=6912,
        vocab_size=50304,
        rope_theta=1.0e4,
    )


register_arch(ARCH_ID, config)
