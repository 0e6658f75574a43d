"""Serving launcher with Compass configuration switching, on one device.

    PYTHONPATH=src python -m repro_torch.launch.serve            # the card
    PYTHONPATH=src python -m repro_torch.launch.serve --reduced --device cpu

The port's counterpart of ``repro/launch/serve.py``: two serving rungs of
one architecture share the same weights ("accurate": full attention with a
KV cache in the activation dtype; "fast": a sliding window of ``--window``
with an int8 KV cache), both prefill the same batch of prompts, and the
decode loop switches the active rung on a synthetic queue depth (deep in
the middle third of the tokens), greedy tokens throughout.  That is the
paper's configuration switching at the model level: the weights stay, only
the step changes.

The loop keeps two habits of the reference launcher, for parity:
the first decode token comes from the *last* rung prefilled, and each rung
decodes from its own cache and position, so after a switch the new rung's
cache has not seen the other rung's tokens.  ``--reduced`` is off by
default here (the reference's flag is always on), so the default serves
internlm2-1.8b at full size.  Sharding (``--devices``, ``--mesh``) comes
with a later slice; the port serves on one card.
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..kernels.decode_attention import decode_attention
from ..kernels.flash_attention import flash_attention
from ..kernels.rmsnorm import rmsnorm
from ..models.common import ModelConfig
from ..models.model import Model
from ..models.registry import get_config

KERNELS = (rmsnorm, flash_attention, decode_attention)
RUNGS = ("accurate", "fast")


def launch_counts() -> Dict[str, int]:
    return {k.__name__: k.launches for k in KERNELS}


def _delta(before: Dict[str, int]) -> Dict[str, int]:
    now = launch_counts()
    return {k: now[k] - before[k] for k in now}


def rung_configs(base: ModelConfig, window: int) -> Dict[str, ModelConfig]:
    """The two serving rungs, as the reference builds them."""
    variants = {
        "accurate": base,
        "fast": dataclasses.replace(
            base, sliding_window=window,
            kv_cache_dtype="int8" if base.family in ("dense", "hybrid") else "",
        ),
    }
    if base.family == "ssm":
        variants["fast"] = base
    return variants


def queue_depth(i: int, tokens: int) -> int:
    """The synthetic queue pressure: a spike in the middle third."""
    return 10 if tokens // 3 <= i < 2 * tokens // 3 else 0


@dataclass
class ServeResult:
    device: str
    config: ModelConfig
    rungs: Dict[str, ModelConfig]
    prompt: torch.Tensor                    # (B, S) token ids, on device
    first_token: np.ndarray                 # (B,), from the last rung prefilled
    tokens: np.ndarray                      # (T, B), greedy after each step
    active: List[str]                       # the rung of each step
    switches: List[Tuple[int, str, str, int]]   # (step, from, to, depth)
    logits: List[torch.Tensor]              # (B, V) of each step, on device
    prefill_logits: Dict[str, torch.Tensor]
    prefill_s: Dict[str, float]
    step_s: List[float]                     # each decode step, host clock
    launches: Dict[str, Dict[str, int]] = field(default_factory=dict)
    models: Dict[str, Model] = field(default_factory=dict)

    def decode_ms_per_token(self, rung: Optional[str] = None) -> float:
        ts = [t for t, a in zip(self.step_s, self.active)
              if rung is None or a == rung]
        return float(np.mean(ts)) * 1e3 if ts else float("nan")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(base: ModelConfig, *, batch: int = 4, prompt_len: int = 32,
        tokens: int = 16, window: int = 16, seed: int = 0,
        device: Any = None, params: Optional[Dict[str, Any]] = None,
        prompt: Optional[np.ndarray] = None) -> ServeResult:
    """Serve ``base`` (the accurate rung's config): prefill both rungs,
    then decode ``tokens`` steps with switching.

    Weights are drawn from ``seed`` and the prompts from ``seed + 1``
    (uniform token ids), unless ``params`` (a parameter tree in the
    reference's layout, numpy or torch) and ``prompt`` ((B, S) ids) are
    given.  ``device=None`` is the card and raises without one."""
    dev = resolve_device(device)
    variants = rung_configs(base, window)
    accurate = Model(variants["accurate"], device=dev)
    if params is not None:
        accurate.load_params(params)
    else:
        accurate.init(seed)
    models = {"accurate": accurate, "fast": accurate.rung(variants["fast"])}
    if prompt is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed + 1)
        prompt_t = torch.randint(0, base.vocab_size, (batch, prompt_len),
                                 generator=gen, device=dev)
    else:
        prompt_t = torch.as_tensor(np.array(prompt), device=dev).long()

    cache_len = prompt_t.shape[1] + tokens
    states, prefill_s, prefill_logits, launches = {}, {}, {}, {}
    last = None
    for name in RUNGS:
        m = models[name]
        before = launch_counts()
        _sync(dev)
        t0 = time.perf_counter()
        last, states[name] = m.prefill({"tokens": prompt_t},
                                       cache_len=m.cache_len_for(cache_len))
        _sync(dev)
        prefill_s[name] = time.perf_counter() - t0
        launches[f"prefill/{name}"] = _delta(before)
        prefill_logits[name] = last

    active = "accurate"
    tok = torch.argmax(last, -1)
    first = tok.cpu().numpy()
    out_tokens, actives, switches, logits, step_s = [], [], [], [], []
    before = launch_counts()
    for i in range(tokens):
        depth = queue_depth(i, tokens)
        want = "fast" if depth > 5 else "accurate"
        if want != active:
            switches.append((i, active, want, depth))
            active = want
        t0 = time.perf_counter()
        step_logits, states[active] = models[active].decode_step(
            states[active], tok)
        tok = torch.argmax(step_logits, -1)
        out_tokens.append(tok.cpu().numpy())       # waits for the step
        step_s.append(time.perf_counter() - t0)
        actives.append(active)
        logits.append(step_logits)
    launches["decode"] = _delta(before)
    return ServeResult(
        device=str(dev), config=base, rungs=variants, prompt=prompt_t,
        first_token=first,
        tokens=np.stack(out_tokens) if out_tokens
        else np.zeros((0, prompt_t.shape[0]), np.int64),
        active=actives, switches=switches, logits=logits,
        prefill_logits=prefill_logits, prefill_s=prefill_s, step_s=step_s,
        launches=launches, models=models)


def report(res: ServeResult) -> str:
    cfg = res.config
    b = res.first_token.shape[0]
    lines = [f"{cfg.arch_id}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
             f"{cfg.num_heads}/{cfg.num_kv_heads} heads, vocab "
             f"{cfg.vocab_size}, {cfg.dtype}, on {res.device}"]
    for name in RUNGS:
        lines.append(f"prefill {name} (window "
                     f"{res.rungs[name].sliding_window or 'full'}, kv "
                     f"{res.rungs[name].kv_cache_dtype or cfg.dtype}): "
                     f"{res.prefill_s[name] * 1e3:.1f} ms, "
                     f"launches {res.launches[f'prefill/{name}']}")
    for i, frm, to, depth in res.switches:
        lines.append(f"token {i:3d}: switch {frm} -> {to} "
                     f"(queue depth {depth})")
    for name in RUNGS:
        ms = res.decode_ms_per_token(name)
        n = res.active.count(name)
        lines.append(f"decode {name}: {n} steps, {ms:.2f} ms/token, "
                     f"{b * 1e3 / ms:.1f} tokens/s at batch {b}")
    lines.append(f"decode: {len(res.step_s)} steps, "
                 f"{res.decode_ms_per_token():.2f} ms/token, launches "
                 f"{res.launches['decode']}")
    return "\n".join(lines)


def _parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description="serving launcher (one device)")
    ap.add_argument("--arch", default="internlm2-1.8b")
    ap.add_argument("--reduced", action="store_true",
                    help="serve the arch's reduced CPU-sized config")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--window", type=int, default=16,
                    help="sliding window of the fast serving config")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="trace the run with torch.profiler and print the "
                         "device time by kernel")
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> None:
    args = _parse_args(argv)
    from ..configs.reduced import reduced_config

    cfg = reduced_config(args.arch) if args.reduced else get_config(args.arch)
    kw = dict(batch=args.batch, prompt_len=args.prompt_len,
              tokens=args.tokens, window=args.window, seed=args.seed,
              device=args.device)
    if not args.profile:
        print(report(run(cfg, **kw)))
        return
    from torch.profiler import ProfilerActivity, profile

    run(cfg, **dict(kw, tokens=2))                       # warm-up
    activities = [ProfilerActivity.CPU]
    if resolve_device(args.device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        res = run(cfg, **kw)
    print(report(res))
    sort = ("self_device_time_total" if len(activities) > 1
            else "self_cpu_time_total")
    print(prof.key_averages().table(sort_by=sort, row_limit=25,
                                    max_name_column_width=60))


if __name__ == "__main__":
    main()
