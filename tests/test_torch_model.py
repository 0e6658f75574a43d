"""The port's serving path as a whole, on the CPU, against the JAX package:
reduced internlm2 (``ModelConfig.reduced()``: 2 layers, fp32), the JAX
parameters carried across by ``convert.model_params_from_numpy``, through
``forward``, ``prefill`` (logits and KV caches) and six ``decode_step``s,
on both serving rungs (full attention with an fp32 cache; a sliding window
with an int8 cache); then ``repro_torch.launch.serve.run`` against the
reference launcher's loop (``repro/launch/serve.py:83-109``) written out
here without the mesh.

Tolerance 1e-4 (absolute and relative): fp32 everywhere, and only the
kernels' summation order differs between the packages.  On the int8 rung a
value within an ulp of a rounding boundary may quantize one step apart in
the two packages, so the int8 caches are compared with |delta| <= 1; where
every int8 entry agrees (as on these inputs) the logits are held to the
same 1e-4, else to one quantization step's relative size, 1/127.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.configs  # noqa: F401  (registers the reference's archs)
from repro.configs.reduced import reduced_config as jax_reduced_config
from repro.models.registry import build_model as jax_build_model
from repro.models.registry import get_config as jax_get_config
from repro_torch.configs.reduced import reduced_config
from repro_torch.convert import (model_config_from_numpy,
                                 model_params_from_numpy, plan_to_numpy)
from repro_torch.launch import serve
from repro_torch.models.model import Model
from repro_torch.models.registry import get_config

TOL = dict(rtol=1e-4, atol=1e-4)
INT8_STEP_TOL = dict(rtol=1 / 127, atol=1 / 127)
WINDOW = 8
CACHE_LEN = 20
DECODE_STEPS = 6


def rungs(cfg):
    return {"accurate": cfg,
            "fast": dataclasses.replace(cfg, sliding_window=WINDOW,
                                        kv_cache_dtype="int8")}


@pytest.fixture(scope="module")
def models():
    jcfg = jax_get_config("internlm2-1.8b").reduced()
    tcfg = model_config_from_numpy(plan_to_numpy(jcfg))
    params = jax_build_model(jcfg).init(jax.random.PRNGKey(0))
    tree = jax.tree.map(np.asarray, params)
    out = {}
    for name in ("accurate", "fast"):
        jm = jax_build_model(rungs(jcfg)[name])
        tm = Model(rungs(tcfg)[name], device="cpu")
        model_params_from_numpy(tree, tm, "cpu")
        out[name] = (jm, params, tm)
    return out


def test_config_crosses_as_plain_data():
    jcfg = jax_get_config("internlm2-1.8b")
    tcfg = model_config_from_numpy(plan_to_numpy(jcfg))
    assert tcfg == get_config("internlm2-1.8b")
    assert tcfg.param_count() == jcfg.param_count()
    assert tcfg.reduced() == get_config("internlm2-1.8b").reduced()
    assert tcfg.activation_dtype == torch.bfloat16


def prompt(vocab, seed=0, shape=(2, 12)):
    return np.random.default_rng(seed).integers(0, vocab, size=shape,
                                                dtype=np.int32)


@pytest.mark.parametrize("rung", ["accurate", "fast"])
def test_forward_matches_the_jax_model(models, rung):
    jm, params, tm = models[rung]
    toks = prompt(jm.cfg.vocab_size)
    jl, _ = jm.forward(params, {"tokens": jnp.asarray(toks)})
    tl, aux = tm.forward({"tokens": torch.from_numpy(toks)})
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
    assert float(aux) == 0.0


def compare_caches(jax_state, port_state, quantized):
    """Layer l's port cache against the reference's stacked cache [0, l];
    returns how many int8 entries differ (by one step at most)."""
    stacked = jax_state["segments"][0]
    differ = 0
    for l, cache in enumerate(port_state["segments"]):
        assert int(cache.index) == int(stacked.index[0, l])
        assert int(cache.length) == int(stacked.length[0, l])
        for name in ("k", "v"):
            ref = np.asarray(getattr(stacked, name)[0, l])
            got = getattr(cache, name).numpy()
            if quantized:
                delta = np.abs(got.astype(np.int32) - ref.astype(np.int32))
                assert delta.max() <= 1, name
                differ += int((delta > 0).sum())
                np.testing.assert_allclose(
                    getattr(cache, f"{name}_scale").numpy(),
                    np.asarray(getattr(stacked, f"{name}_scale")[0, l]),
                    **TOL)
            else:
                np.testing.assert_allclose(got, ref, **TOL)
    return differ


@pytest.mark.parametrize("rung", ["accurate", "fast"])
def test_prefill_and_decode_match_the_jax_model(models, rung):
    jm, params, tm = models[rung]
    quantized = rung == "fast"
    toks = prompt(jm.cfg.vocab_size, seed=1)
    jlast, jst = jm.prefill(params, {"tokens": jnp.asarray(toks)},
                            cache_len=jm.cache_len_for(CACHE_LEN))
    tlast, tst = tm.prefill({"tokens": torch.from_numpy(toks)},
                            cache_len=tm.cache_len_for(CACHE_LEN))
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    differ = compare_caches(jst, tst, quantized)
    assert int(tst["position"]) == toks.shape[1]

    step = jax.jit(lambda p, s, t: jm.decode_step(p, s, t))
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    for _ in range(DECODE_STEPS):
        jlog, jst = step(params, jst, jnp.asarray(tok))
        tlog, tst = tm.decode_step(tst, torch.from_numpy(tok))
        differ += compare_caches(jst, tst, quantized)
        tol = TOL if differ == 0 else INT8_STEP_TOL
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), **tol)
        tok = np.asarray(jnp.argmax(jlog, -1)).astype(np.int32)
    assert int(tst["position"]) == toks.shape[1] + DECODE_STEPS


def test_the_fast_rung_wraps_its_ring_cache(models):
    """Prompt longer than the window: the cache keeps the last WINDOW
    positions rolled into ring order, and decode wraps it."""
    jm, params, tm = models["fast"]
    toks = prompt(jm.cfg.vocab_size, seed=2, shape=(2, WINDOW + 3))
    jlast, jst = jm.prefill(params, {"tokens": jnp.asarray(toks)})
    tlast, tst = tm.prefill({"tokens": torch.from_numpy(toks)})
    assert tst["segments"][0].k.shape[1] == WINDOW
    np.testing.assert_allclose(tlast.numpy(), np.asarray(jlast), **TOL)
    differ = compare_caches(jst, tst, quantized=True)
    tok = np.asarray(jnp.argmax(jlast, -1)).astype(np.int32)
    jlog, jst = jm.decode_step(params, jst, jnp.asarray(tok))
    tlog, tst = tm.decode_step(tst, torch.from_numpy(tok))
    differ += compare_caches(jst, tst, quantized=True)
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog),
                               **(TOL if differ == 0 else INT8_STEP_TOL))


@pytest.mark.parametrize("prefix_len,window", [(5, 0), (0, 4)])
def test_attend_and_its_masks_match_the_reference(prefix_len, window):
    """The plain ``attend`` path (the masks the kernels do not take, such
    as a prefix-LM prefix) against the reference's."""
    from repro.models import attention as jax_attn
    from repro_torch.models import attention as attn

    rng = np.random.default_rng(3)
    q = rng.standard_normal((2, 9, 4, 16), dtype=np.float32)
    k = rng.standard_normal((2, 9, 2, 16), dtype=np.float32)
    v = rng.standard_normal((2, 9, 2, 16), dtype=np.float32)
    jmask = jax_attn.make_mask(9, 9, window=window, prefix_len=prefix_len)
    tmask = attn.make_mask(9, 9, window=window, prefix_len=prefix_len)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    out = attn.attend(*map(torch.from_numpy, (q, k, v)), tmask)
    ref = jax_attn.attend(*map(jnp.asarray, (q, k, v)), jmask)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), **TOL)


def test_init_decode_state_matches_the_reference(models):
    jm, _, tm = models["fast"]
    jst = jm.init_decode_state(3, WINDOW, position=4)
    tst = tm.init_decode_state(3, WINDOW, position=4)
    stacked = jst["segments"][0]
    assert len(tst["segments"]) == jm.cfg.num_layers
    for cache in tst["segments"]:
        for name in ("k", "v", "k_scale", "v_scale"):
            got, ref = getattr(cache, name), getattr(stacked, name)[0, 0]
            assert tuple(got.shape) == ref.shape
            assert str(got.dtype).replace("torch.", "") == str(ref.dtype)
            assert not got.any()
    assert int(tst["position"]) == int(jst["position"]) == 4


def test_other_families_raise_at_construction():
    with pytest.raises(NotImplementedError, match="not ported"):
        Model(get_config("hymba-1.5b").reduced(), device="cpu")


# -- the launcher ---------------------------------------------------------------

SERVE = dict(batch=2, prompt_len=16, tokens=16, window=8)


def reference_loop(arch, *, batch, prompt_len, tokens, window):
    """``repro/launch/serve.py:60-109`` on the JAX package, without the mesh
    (its reduced config, in float32)."""
    base = dataclasses.replace(jax_reduced_config(arch), dtype="float32")
    variants = {
        "accurate": base,
        "fast": dataclasses.replace(base, sliding_window=window,
                                    kv_cache_dtype="int8"),
    }
    models = {k: jax_build_model(cfg) for k, cfg in variants.items()}
    params = models["accurate"].init(jax.random.PRNGKey(0))
    prompt_ids = jax.random.randint(jax.random.PRNGKey(1),
                                    (batch, prompt_len), 0, base.vocab_size)
    cache_len = prompt_len + tokens
    states, steps = {}, {}
    for name, m in models.items():
        last, states[name] = m.prefill(params, {"tokens": prompt_ids},
                                       cache_len=m.cache_len_for(cache_len))
        steps[name] = jax.jit(lambda p, s, t, m_=m: m_.decode_step(p, s, t))
    active = "accurate"
    tok = jnp.argmax(last, -1).astype(jnp.int32)
    first, out, switches = np.asarray(tok), [], []
    for i in range(tokens):
        depth = 10 if tokens // 3 <= i < 2 * tokens // 3 else 0
        want = "fast" if depth > 5 else "accurate"
        if want != active:
            switches.append((i, active, want, depth))
            active = want
        logits, states[active] = steps[active](params, states[active], tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        out.append(np.asarray(tok))
    return params, np.asarray(prompt_ids), first, np.stack(out), switches


def test_serve_run_matches_the_reference_loop():
    params, prompt_ids, first, toks, switches = reference_loop(
        "internlm2-1.8b", **SERVE)
    cfg = dataclasses.replace(reduced_config("internlm2-1.8b"),
                              dtype="float32")
    res = serve.run(cfg, device="cpu",
                    params=jax.tree.map(np.asarray, params),
                    prompt=prompt_ids, **SERVE)
    assert switches == [(5, "accurate", "fast", 10),
                        (10, "fast", "accurate", 0)]
    assert res.switches == switches
    np.testing.assert_array_equal(res.first_token, first)
    np.testing.assert_array_equal(res.tokens, toks)
    assert res.active == ["accurate"] * 5 + ["fast"] * 5 + ["accurate"] * 6
    assert all(np.isfinite(l.numpy()).all() for l in res.logits)
    # on the CPU the wrappers run their plain versions: no launches
    assert all(v == 0 for counts in res.launches.values()
               for v in counts.values())


def test_serve_run_on_the_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        serve.run(reduced_config("internlm2-1.8b"), **SERVE)


def test_serve_cli_runs_the_reduced_config_on_the_cpu(capsys):
    serve.main(["--reduced", "--device", "cpu", "--tokens", "6",
                "--prompt-len", "8", "--batch", "2"])
    out = capsys.readouterr().out
    assert "switch accurate -> fast" in out
    assert "decode: 6 steps" in out
