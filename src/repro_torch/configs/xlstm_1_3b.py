"""xlstm-1.3b [ssm]: 48L d_model=2048 4H d_ff=0 vocab=50304 — sLSTM + mLSTM
blocks (one sLSTM per 8 layers; the rest mLSTM with matrix memory).
[arXiv:2405.04517]

Attention-free: decode state is O(1) per layer (head_dim^2 matrix memory),
so long_500k runs natively.  The Compass serving ladder for this arch uses
chunk-size / quantization knobs — attention-window parameters do not exist
(see DESIGN.md §Arch-applicability).
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "xlstm-1.3b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="ssm",
        num_layers=48,
        d_model=2048,
        num_heads=4,
        num_kv_heads=4,
        head_dim=512,
        d_ff=0,                    # xLSTM blocks have no separate FFN
        vocab_size=50304,
        slstm_every=8,
        rope_theta=1.0e4,          # unused (no attention) but kept for API
    )


register_arch(ARCH_ID, config)
