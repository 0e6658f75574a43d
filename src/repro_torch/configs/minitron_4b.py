"""minitron-4b [dense]: 32L d_model=3072 24H (GQA kv=8) d_ff=9216
vocab=256000 — pruned nemotron.  [arXiv:2407.14679]
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "minitron-4b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=32,
        d_model=3072,
        num_heads=24,
        num_kv_heads=8,
        head_dim=128,
        d_ff=9216,
        vocab_size=256000,
        act="gelu",                # nemotron uses squared-relu/gelu MLp
        rope_theta=1.0e4,
    )


register_arch(ARCH_ID, config)
