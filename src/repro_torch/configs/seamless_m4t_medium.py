"""seamless-m4t-medium [audio]: enc-dec, 12L d_model=1024 16H (kv=16)
d_ff=4096 vocab=256206.  [arXiv:2308.11596]

The speech frontend (mel-spectrogram + conv feature extractor) is STUBBED per
the brief: ``input_specs`` provides precomputed frame embeddings
(B, S, prefix_dim) consumed by a learned projection into the encoder.  The
transformer backbone (12 encoder + 12 decoder layers with cross-attention) is
fully implemented.  Train/prefill decoder length is seq_len / 4 (speech frames
outnumber text tokens).
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "seamless-m4t-medium"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="audio",
        num_layers=12,             # decoder layers
        encoder_layers=12,
        cross_attention=True,
        d_model=1024,
        num_heads=16,
        num_kv_heads=16,
        head_dim=64,
        d_ff=4096,
        vocab_size=256206,
        prefix_dim=1024,           # stubbed frame-embedding dim
        decoder_len_ratio=4,
        act="gelu",                # m4t uses standard transformer FFN
        rope_theta=1.0e4,
    )


register_arch(ARCH_ID, config)
