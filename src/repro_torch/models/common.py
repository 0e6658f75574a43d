"""Model substrate: configuration, parameter specs, initialization.

The port's counterpart of ``repro/models/common.py``.  :class:`ModelConfig`
has the reference's fields and defaults, so a config made by either package
describes the same architecture; its dtypes are :class:`torch.dtype`.
Parameters are described by :class:`ParamSpec` trees (nested dicts), as in
the reference, and :func:`init_params` draws them with an explicit
:class:`torch.Generator`.  The numbers differ from ``jax.random``'s: tests
carry the JAX package's weights across (``repro_torch.convert``) instead of
comparing initialisations.
"""

from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass
from typing import Any, Dict, Iterator, Optional, Tuple

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype name (``"bfloat16"`` ...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype {name!r}; expected one of "
                         f"{sorted(_DTYPES)}") from None


# ---------------------------------------------------------------------------
# configuration
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ModelConfig:
    """Complete architectural description (one per assigned architecture)."""

    arch_id: str
    family: str                  # dense | moe | ssm | hybrid | encdec | vlm | audio
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0            # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    num_shared_experts: int = 0
    moe_top_k: int = 0
    first_dense_layers: int = 0  # leading dense-FFN layers (DeepSeek-MoE)
    dense_ff: int = 0            # their hidden size
    moe_impl: str = "dense"      # dense | gshard   (dispatch implementation)
    capacity_factor: float = 1.25

    # --- SSM / hybrid (Mamba-style selective scan) ---
    ssm_state: int = 0
    ssm_conv: int = 4
    ssm_expand: int = 2

    # --- xLSTM ---
    slstm_every: int = 0         # one sLSTM block every N layers (0 = all mLSTM)

    # --- encoder-decoder ---
    encoder_layers: int = 0
    cross_attention: bool = False
    decoder_len_ratio: int = 1   # train/prefill decoder length = seq // ratio

    # --- stubbed modality frontend (VLM patch / audio frame embeddings) ---
    prefix_tokens: int = 0
    prefix_dim: int = 0          # frontend output dim (projector -> d_model)
    prefix_lm: bool = False      # bidirectional attention over the prefix

    # --- attention ---
    sliding_window: int = 0      # 0 = full; >0 = sliding-window causal
    rope_theta: float = 1.0e4

    # --- numerics / misc ---
    sharded_ce: bool = True      # GSPMD-friendly cross-entropy (reference only)
    act_hints: bool = True       # activation layout hints (a no-op on one card)
    kv_cache_dtype: str = ""     # "" = activation dtype; "int8" = quantized KV
    norm_eps: float = 1.0e-5
    act: str = "swiglu"          # swiglu | gelu
    tied_embeddings: bool = False
    dtype: str = "bfloat16"      # activation dtype
    param_dtype: str = "float32"
    remat: str = "none"          # none | full | dots_saveable
    scan_layers: bool = True
    logit_softcap: float = 0.0

    def __post_init__(self) -> None:
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.num_heads)
        if self.num_heads % max(1, self.num_kv_heads) != 0:
            raise ValueError(
                f"{self.arch_id}: num_heads {self.num_heads} not divisible by "
                f"kv heads {self.num_kv_heads}"
            )
        if self.family in ("moe",) and (self.num_experts <= 0 or self.moe_top_k <= 0):
            raise ValueError(f"{self.arch_id}: moe family needs experts/top_k")

    # -- derived ------------------------------------------------------------

    @property
    def q_dim(self) -> int:
        return self.num_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.num_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def activation_dtype(self) -> torch.dtype:
        return torch_dtype(self.dtype)

    @property
    def parameter_dtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    def param_count(self) -> int:
        """Exact parameter count from the spec tree (no allocation)."""
        from .model import model_param_specs  # late import to avoid cycle

        return sum(math.prod(s.shape)
                   for _, s in iter_specs(model_param_specs(self)))

    def reduced(self, **overrides: Any) -> "ModelConfig":
        """A smoke-test variant of the same family (2 layers, narrow dims,
        few experts) that runs a real forward step on the CPU."""
        small: Dict[str, Any] = dict(
            num_layers=2,
            d_model=min(self.d_model, 128),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=min(self.num_kv_heads, 2),
            head_dim=32,
            d_ff=min(self.d_ff, 256) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            dtype="float32",
            param_dtype="float32",
            remat="none",
        )
        if self.num_heads % min(self.num_heads, 4) != 0:
            small["num_heads"] = 1
        if small["num_heads"] % max(1, small["num_kv_heads"]) != 0:
            small["num_kv_heads"] = 1
        if self.num_experts:
            small.update(
                num_experts=min(self.num_experts, 4),
                moe_top_k=min(self.moe_top_k, 2),
                num_shared_experts=min(self.num_shared_experts, 1),
                first_dense_layers=min(self.first_dense_layers, 1),
                dense_ff=min(self.dense_ff, 256) if self.dense_ff else 0,
            )
        if self.encoder_layers:
            small["encoder_layers"] = 2
        if self.prefix_tokens:
            small.update(prefix_tokens=8, prefix_dim=min(self.prefix_dim, 64))
        if self.sliding_window:
            small["sliding_window"] = min(self.sliding_window, 64)
        if self.slstm_every:
            small["slstm_every"] = 2
        small.update(overrides)
        return dataclasses.replace(self, **small)


# ---------------------------------------------------------------------------
# parameter specs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ParamSpec:
    """Shape + logical sharding axes + initializer scale for one parameter."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]     # logical axis name per dim (None = replicated)
    init: str = "normal"                # normal | zeros | ones | scaled
    scale: float = 1.0

    def __post_init__(self) -> None:
        if len(self.shape) != len(self.axes):
            raise ValueError(f"spec rank mismatch: {self.shape} vs {self.axes}")


def stacked(spec: ParamSpec, layers: int) -> ParamSpec:
    """Stack a per-layer spec on a leading 'layers' axis."""
    return ParamSpec(
        shape=(layers,) + spec.shape,
        axes=("layers",) + spec.axes,
        init=spec.init,
        scale=spec.scale,
    )


def iter_specs(tree: Any, path: Tuple = ()) -> Iterator[Tuple[Tuple, ParamSpec]]:
    """``(path, spec)`` for every :class:`ParamSpec` of a tree of dicts and
    lists, dict keys in sorted order (the order ``jax.tree_util`` flattens
    a dict in)."""
    if isinstance(tree, ParamSpec):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from iter_specs(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from iter_specs(sub, path + (i,))
    else:
        raise TypeError(f"not a spec tree: {type(tree).__name__}")


def init_param(spec: ParamSpec, generator: torch.Generator,
               dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """One parameter, drawn as the reference's ``init_param`` draws it:
    zeros, ones, or a standard normal in fp32 times ``scale / sqrt(fan_in)``
    ("scaled") or ``scale * 0.02`` ("normal"), then cast to ``dtype``."""
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[0] if len(spec.shape) > 1 else max(1, spec.shape[0])
    if spec.init == "scaled":
        std = spec.scale / math.sqrt(fan_in)
    else:
        std = spec.scale * 0.02
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=device)
    return (x * std).to(dtype)


def init_params(specs: Any, generator: torch.Generator, dtype: torch.dtype,
                device: torch.device) -> Any:
    """A tree of real tensors of the same structure as ``specs`` (nested
    dicts and lists of :class:`ParamSpec`), drawn leaf by leaf in
    :func:`iter_specs` order from ``generator``, which must live on
    ``device``."""
    if isinstance(specs, ParamSpec):
        return init_param(specs, generator, dtype, device)
    if isinstance(specs, dict):
        return {k: init_params(specs[k], generator, dtype, device)
                for k in sorted(specs)}
    if isinstance(specs, (list, tuple)):
        return [init_params(s, generator, dtype, device) for s in specs]
    raise TypeError(f"not a spec tree: {type(specs).__name__}")
