"""granite-moe-3b-a800m [moe]: 32L d_model=1536 24H (GQA kv=8) d_ff=512
vocab=49155, MoE 40 experts top-8.
[hf:ibm-granite/granite-3.0-1b-a400m-base / granite-3.0-3b-a800m family]
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "granite-moe-3b-a800m"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="moe",
        num_layers=32,
        d_model=1536,
        num_heads=24,
        num_kv_heads=8,
        head_dim=64,
        d_ff=512,                  # per-expert FFN hidden
        vocab_size=49155,
        num_experts=40,
        moe_top_k=8,
        rope_theta=1.0e4,
        tied_embeddings=True,      # granite MoE ties embeddings
    )


register_arch(ARCH_ID, config)
