"""llama3-405b [dense]: 126L d_model=16384 128H (GQA kv=8) d_ff=53248
vocab=128256.  [arXiv:2407.21783]

The capacity-bound architecture of the pool: fp32 params + Adam state exceed
a single 256-chip v5e pod's HBM (see EXPERIMENTS.md §Dry-run), so training
defaults to full activation remat and relies on 2-pod FSDP; this is also the
arch where Compass-style configuration switching matters most in serving
(largest service-time spread across its serving ladder).
"""

from ..models.common import ModelConfig
from ..models.registry import register_arch

ARCH_ID = "llama3-405b"


def config() -> ModelConfig:
    return ModelConfig(
        arch_id=ARCH_ID,
        family="dense",
        num_layers=126,
        d_model=16384,
        num_heads=128,
        num_kv_heads=8,
        head_dim=128,
        d_ff=53248,
        vocab_size=128256,
        rope_theta=5.0e5,
        remat="full",
    )


register_arch(ARCH_ID, config)
