"""The Model facade: init / forward / prefill / decode, built from a
:class:`ModelConfig`.

The port's counterpart of ``repro/models/model.py``, for the dense family.
:class:`Model` is an :class:`torch.nn.Module` that holds its weights: one
:class:`ParamTree` for the embedding (``embedding``, ``final_norm``,
``unembed``) and one a layer in ``layers``, in the order the reference's
scans visit its stacked ``(repeat, count, ...)`` parameters.  The methods
keep the reference's names, arguments and batch conventions, without the
``params`` argument the module now holds:

  prefill:  ``prefill({"tokens": (B, S) int}, cache_len=...)``
  decode:   ``decode_step(state, (B,) int token)``; the state holds one
            KVCache a layer and ``position``, a () int32 on the device

Weights are stored in the activation dtype: float parameters are cast once
when they are loaded (:meth:`Model.load_params`), where the reference casts
its ``param_dtype`` masters on every call.  The rounding is the same.
Families other than dense raise at construction; they come with later
slices (``ROADMAP.md``).
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from . import blocks
from .common import ModelConfig, ParamSpec, init_params
from .layers import embed_specs, embed_tokens, unembed
from .transformer import (
    Layout,
    _segment_specs,
    derive_layout,
    layer_types,
    run_stack_decode,
    run_stack_prefill,
    run_stack_seq,
)


def model_param_specs(cfg: ModelConfig) -> Dict[str, Any]:
    """The reference's parameter spec tree of ``cfg`` (``embed``,
    ``decoder`` stacked ``(repeat, count, ...)``, and ``first_dense``,
    ``encoder``, ``frontend`` where the family has them)."""
    specs: Dict[str, Any] = {"embed": embed_specs(cfg)}
    if cfg.family == "moe" and cfg.first_dense_layers > 0:
        d_ff = cfg.dense_ff or cfg.d_ff
        specs["first_dense"] = _segment_specs(
            cfg, (1, [("dense", cfg.first_dense_layers)]), d_ff=d_ff)
    specs["decoder"] = _segment_specs(cfg, derive_layout(cfg))
    if cfg.encoder_layers > 0:
        specs["encoder"] = _segment_specs(
            cfg, (1, [("encoder", cfg.encoder_layers)]))
    if cfg.prefix_dim > 0:
        specs["frontend"] = {
            "proj": ParamSpec(
                (cfg.prefix_dim, cfg.d_model), ("frontend", "embed"), "scaled"
            )
        }
    return specs


class ParamTree(nn.Module):
    """The parameters of one dict of :class:`ParamSpec` (nested dicts become
    sub-trees), read as ``tree["wq"]``, like the reference's dicts.  The
    parameters are allocated, not drawn, and need no gradient."""

    def __init__(self, specs: Dict[str, Any], dtype: torch.dtype,
                 device: torch.device) -> None:
        super().__init__()
        for key in sorted(specs):
            spec = specs[key]
            if isinstance(spec, ParamSpec):
                self.register_parameter(key, nn.Parameter(
                    torch.empty(spec.shape, dtype=dtype, device=device),
                    requires_grad=False))
            else:
                self.add_module(key, ParamTree(spec, dtype, device))

    def __getitem__(self, key: str) -> Any:
        return getattr(self, key)

    def keys(self) -> Iterator[str]:
        yield from self._parameters
        yield from self._modules

    @torch.no_grad()
    def load(self, tree: Any, index: Tuple[int, ...] = ()) -> None:
        """Copy ``tree`` (dicts of tensors or numpy arrays, leaves indexed
        by ``index`` first) into the parameters, cast to their dtype."""
        for key in self.keys():
            if key not in tree:
                raise KeyError(f"parameter {key!r} missing from the tree")
            sub = self[key]
            if isinstance(sub, ParamTree):
                sub.load(tree[key], index)
            else:
                sub.copy_(_as_tensor(tree[key])[index])


def _as_tensor(a: Any) -> torch.Tensor:
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":       # numpy holds it through ml_dtypes
        a = a.astype(np.float32)
    return torch.from_numpy(np.array(a))


class Model(nn.Module):
    """A dense-family language model on one device (``None``: the card)."""

    def __init__(self, cfg: ModelConfig,
                 device: Optional[Union[str, torch.device]] = None) -> None:
        super().__init__()
        if cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.arch_id}: family {cfg.family!r} is not ported yet; "
                f"the port serves the dense family (ROADMAP.md, slices)")
        self.cfg = cfg
        self.device = resolve_device(device)
        dtype = cfg.activation_dtype
        self.embed = ParamTree(embed_specs(cfg), dtype, self.device)
        self.layers = nn.ModuleList(
            ParamTree(blocks.block_specs(cfg, block_type), dtype, self.device)
            for block_type, *_ in layer_types(self.decoder_layout))

    def rung(self, cfg: ModelConfig) -> "Model":
        """A model of ``cfg`` that shares this one's weights (a serving
        rung: same parameters, another window or KV cache dtype)."""
        if (model_param_specs(cfg) != self.param_specs()
                or cfg.activation_dtype != self.cfg.activation_dtype):
            raise ValueError(f"{cfg.arch_id}: a rung must have the same "
                             f"parameters and activation dtype")
        other = Model.__new__(Model)
        nn.Module.__init__(other)
        other.cfg, other.device = cfg, self.device
        other.embed, other.layers = self.embed, self.layers
        return other

    # -- structure -----------------------------------------------------------

    @property
    def decoder_layout(self) -> Layout:
        return derive_layout(self.cfg)

    def param_specs(self) -> Dict[str, Any]:
        return model_param_specs(self.cfg)

    # -- params ---------------------------------------------------------------

    @torch.no_grad()
    def load_params(self, tree: Dict[str, Any]) -> "Model":
        """Load a parameter tree in the reference's layout (``embed`` and
        ``decoder``, segment leaves stacked ``(repeat, count, ...)``; torch
        tensors or numpy arrays), cast once to the activation dtype."""
        self.embed.load(tree["embed"])
        for (_, seg, r, c), layer in zip(layer_types(self.decoder_layout),
                                         self.layers, strict=True):
            layer.load(tree["decoder"][seg], (r, c))
        return self

    def init(self, generator: Union[int, torch.Generator]) -> "Model":
        """Draw the weights (``int``: a seed) in ``param_dtype``, as the
        reference's ``init`` does with a key, and load them."""
        if not isinstance(generator, torch.Generator):
            seed = generator
            generator = torch.Generator(device=self.device)
            generator.manual_seed(seed)
        tree = init_params(self.param_specs(), generator,
                           self.cfg.parameter_dtype, self.device)
        return self.load_params(tree)

    # -- helpers ---------------------------------------------------------------

    def _tokens(self, tokens: Any) -> torch.Tensor:
        return torch.as_tensor(tokens, device=self.device).long()

    # -- forward ---------------------------------------------------------------

    @torch.no_grad()
    def forward(self, batch: Dict[str, Any]) -> Tuple[torch.Tensor, torch.Tensor]:
        """Full-sequence forward.  Returns ((B, S, V) logits, aux_loss)."""
        cfg = self.cfg
        x = embed_tokens(self.embed, self._tokens(batch["tokens"]),
                         cfg.activation_dtype)
        x, aux = run_stack_seq(self.layers, x, cfg, self.decoder_layout)
        return unembed(self.embed, x, cfg), aux

    # -- serving paths ------------------------------------------------------------

    def cache_len_for(self, max_len: int) -> int:
        cfg = self.cfg
        if cfg.sliding_window > 0:
            return min(cfg.sliding_window, max_len)
        return max_len

    @torch.no_grad()
    def prefill(self, batch: Dict[str, Any], *,
                cache_len: Optional[int] = None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """Prefill: forward over the prompt, build the decode state, return
        the last-position logits (B, V) and the state."""
        cfg = self.cfg
        x = embed_tokens(self.embed, self._tokens(batch["tokens"]),
                         cfg.activation_dtype)
        seq_len = x.shape[1]
        c_len = cache_len if cache_len is not None else self.cache_len_for(seq_len)
        y, states = run_stack_prefill(self.layers, x, cfg,
                                      self.decoder_layout, cache_len=c_len)
        logits = unembed(self.embed, y[:, -1:, :], cfg)[:, 0, :]
        state = {
            "segments": states,
            "first_dense": None,
            "position": torch.tensor(seq_len, dtype=torch.int32,
                                     device=self.device),
        }
        return logits, state

    def init_decode_state(self, batch_size: int, cache_len: int, *,
                          position: int = 0) -> Dict[str, Any]:
        """A fresh decode state: empty caches, ``position`` as given."""
        cfg = self.cfg
        states = [blocks.block_init_state(cfg, block_type, batch_size,
                                          cache_len, cfg.activation_dtype,
                                          self.device)
                  for block_type, *_ in layer_types(self.decoder_layout)]
        return {
            "segments": states,
            "first_dense": None,
            "position": torch.tensor(position, dtype=torch.int32,
                                     device=self.device),
        }

    @torch.no_grad()
    def decode_step(self, state: Dict[str, Any], token: Any
                    ) -> Tuple[torch.Tensor, Dict[str, Any]]:
        """One decode step.  token: (B,) int.  Returns ((B, V) logits, new
        state); the caches are updated in place."""
        cfg = self.cfg
        x = embed_tokens(self.embed, self._tokens(token)[:, None],
                         cfg.activation_dtype)                   # (B, 1, D)
        y, new_states = run_stack_decode(
            self.layers, state["segments"], x, cfg, self.decoder_layout,
            position=state["position"])
        logits = unembed(self.embed, y, cfg)[:, 0, :]
        return logits, {
            "segments": new_states,
            "first_dense": None,
            "position": state["position"] + 1,
        }
