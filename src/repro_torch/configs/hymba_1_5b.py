"""hymba-1.5b [hybrid]: 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16 — parallel attention + Mamba heads in every layer.
[arXiv:2411.13676]

Note: 25 heads is NOT divisible by a 16-way tensor-parallel axis; the
sharding planner replicates the attention head dim for this arch (divisibility
fallback) while still sharding d_ff (5504 = 16 x 344) and the SSM inner dim.
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="hybrid",
        num_layers=32,
        d_model=1600,
        num_heads=25,
        num_kv_heads=5,
        head_dim=64,
        d_ff=5504,
        vocab_size=32001,
        ssm_state=16,
        ssm_expand=2,
        rope_theta=1.0e4,
    )


register_arch(ARCH_ID, config)
