"""Architecture registry: ModelConfig -> Model, and the --arch lookup.

The port's counterpart of ``repro/models/registry.py``; the config modules
under ``repro_torch.configs`` (copies of the reference's) register here.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Union

import torch

from .common import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register_arch(arch_id: str, factory: Callable[[], ModelConfig]) -> None:
    if arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {arch_id!r}")
    _REGISTRY[arch_id] = factory


def arch_ids() -> list:
    _ensure_configs_loaded()
    return sorted(_REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    _ensure_configs_loaded()
    try:
        return _REGISTRY[arch_id]()
    except KeyError:
        raise KeyError(
            f"unknown arch {arch_id!r}; available: {', '.join(sorted(_REGISTRY))}"
        )


def build_model(cfg: ModelConfig,
                device: Optional[Union[str, torch.device]] = None):
    """The port's :class:`~repro_torch.models.model.Model` of ``cfg``, its
    weights allocated (not yet drawn) on ``device`` (``None``: the card)."""
    from .model import Model

    return Model(cfg, device=device)


def get_model(arch_id: str, device: Optional[Union[str, torch.device]] = None):
    return build_model(get_config(arch_id), device=device)


def _ensure_configs_loaded() -> None:
    # configs register themselves on import
    import repro_torch.configs  # noqa: F401
