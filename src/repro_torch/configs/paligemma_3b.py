"""paligemma-3b [vlm]: 18L d_model=2048 8H (GQA kv=1, MQA) d_ff=16384
vocab=257216; SigLIP vision tower + gemma decoder.  [arXiv:2407.07726]

The SigLIP vision encoder is STUBBED per the brief: ``input_specs`` provides
precomputed patch embeddings (B, 256, 1152); the linear projector into the
gemma embedding space and the full language decoder are implemented.
PaliGemma uses prefix-LM attention: bidirectional over image+prompt prefix,
causal over the generated suffix.
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "paligemma-3b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="vlm",
        num_layers=18,
        d_model=2048,
        num_heads=8,
        num_kv_heads=1,            # multi-query attention
        head_dim=256,              # gemma head dim
        d_ff=16384,
        vocab_size=257216,
        prefix_tokens=256,         # 224x224 / 14x14 SigLIP patches
        prefix_dim=1152,           # SigLIP-So400m embedding width
        prefix_lm=True,
        act="geglu",               # gemma GeGLU
        tied_embeddings=True,      # gemma ties embeddings
        rope_theta=1.0e4,
    )


register_arch(ARCH_ID, config)
