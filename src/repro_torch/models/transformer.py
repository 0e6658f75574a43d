"""Backbone: periodic layer layout and the layer loops.

The port's counterpart of ``repro/models/transformer.py``.  A backbone is
described by a *layout*: ``(repeat, [(block_type, count), ...])`` — the
block pattern of one period and how many times it repeats.  The reference
stacks each segment's parameters ``(repeat, count, *param_shape)`` and
scans over them; the port keeps one parameter tree per layer, in the order
the scans visit them (:func:`layer_types`), and loops in Python.
:func:`_segment_specs` still gives the reference's stacked spec tree, which
``repro_torch.convert`` reads JAX parameters against.  Rematerialisation
(``cfg.remat``) is training-only and comes with the training slice.
"""

from __future__ import annotations

from typing import Any, List, Optional, Sequence, Tuple

import torch

from . import blocks
from .common import ModelConfig, ParamSpec

Layout = Tuple[int, List[Tuple[str, int]]]


def derive_layout(cfg: ModelConfig) -> Layout:
    """Layer layout for the config's family (decoder stack)."""
    l = cfg.num_layers
    if cfg.family in ("dense", "vlm"):
        return (1, [("dense", l)])
    if cfg.family == "moe":
        n_moe = l - cfg.first_dense_layers
        return (1, [("moe", n_moe)])
    if cfg.family == "hybrid":
        return (1, [("hybrid", l)])
    if cfg.family == "ssm":
        if cfg.slstm_every and cfg.slstm_every > 1:
            period = cfg.slstm_every
            if l % period != 0:
                raise ValueError(f"{cfg.arch_id}: layers {l} not divisible by period {period}")
            return (l // period, [("mlstm", period - 1), ("slstm", 1)])
        return (1, [("mlstm", l)])
    if cfg.family in ("encdec", "audio"):
        return (1, [("cross", l)])       # decoder stack; encoder built separately
    raise ValueError(f"unknown family {cfg.family!r}")


def _stack_spec(spec: ParamSpec, repeat: int, count: int) -> ParamSpec:
    return ParamSpec(
        shape=(repeat, count) + spec.shape,
        axes=("layers", "layers") + spec.axes,
        init=spec.init,
        scale=spec.scale,
    )


def _stack_tree(tree: Any, repeat: int, count: int) -> Any:
    if isinstance(tree, ParamSpec):
        return _stack_spec(tree, repeat, count)
    return {k: _stack_tree(v, repeat, count) for k, v in tree.items()}


def _segment_specs(cfg: ModelConfig, layout: Layout, *,
                   d_ff: Optional[int] = None) -> List[dict]:
    """The reference's stacked spec tree: one dict a pattern entry, leaves
    ``(repeat, count, *shape)``."""
    repeat, pattern = layout
    return [_stack_tree(blocks.block_specs(cfg, block_type, d_ff=d_ff),
                        repeat, count)
            for block_type, count in pattern]


def layer_types(layout: Layout) -> List[Tuple[str, int, int, int]]:
    """``(block_type, segment, r, c)`` for every layer, in the order the
    reference's scans visit them: periods ``r`` outside, then the
    pattern's segments, then ``c`` within a segment."""
    repeat, pattern = layout
    return [(block_type, seg, r, c)
            for r in range(repeat)
            for seg, (block_type, count) in enumerate(pattern)
            for c in range(count)]


# ---------------------------------------------------------------------------
# stack execution
# ---------------------------------------------------------------------------


def run_stack_seq(
    layers: Sequence[Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    layout: Layout,
    *,
    positions: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence pass through the whole stack.  Returns (y, aux_sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for (block_type, *_), p in zip(layer_types(layout), layers, strict=True):
        x, a, _ = blocks.block_apply_seq(p, x, cfg, block_type,
                                         positions=positions,
                                         prefix_len=prefix_len)
        aux = aux + a
    return x, aux


def run_stack_prefill(
    layers: Sequence[Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    layout: Layout,
    *,
    cache_len: int,
    positions: Optional[torch.Tensor] = None,
    prefix_len: int = 0,
) -> Tuple[torch.Tensor, List[Any]]:
    """Full-sequence pass that also builds the decode state of every layer.
    Returns (y, one state a layer)."""
    states = []
    for (block_type, *_), p in zip(layer_types(layout), layers, strict=True):
        x, _, st = blocks.block_apply_seq(p, x, cfg, block_type,
                                          positions=positions,
                                          prefix_len=prefix_len,
                                          cache_len=cache_len)
        states.append(st)
    return x, states


def run_stack_decode(
    layers: Sequence[Any],
    states: Sequence[Any],
    x: torch.Tensor,
    cfg: ModelConfig,
    layout: Layout,
    *,
    position: torch.Tensor,
) -> Tuple[torch.Tensor, List[Any]]:
    """One-token decode through the stack.  Returns (y, new states)."""
    new_states = []
    for (block_type, *_), p, s in zip(layer_types(layout), layers, states,
                                      strict=True):
        x, ns = blocks.block_apply_decode(p, x, s, cfg, block_type,
                                          position=position)
        new_states.append(ns)
    return x, new_states
