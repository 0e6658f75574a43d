"""The plain versions of the port's model kernels (K3 rmsnorm, K4 prefill
attention, K5 decode attention) against the JAX package's Pallas kernels
(interpret mode) and pure-jnp oracles, on the same numpy-seeded inputs.

These are what the wrappers run for CPU tensors, and what ``chip_smoke.py``
and ``tests/test_torch_cuda.py`` hold the CUDA kernels against on the card.
Tolerances are ``tests/test_kernels.py``'s: fp32 2e-5, bf16 2e-2.  Shapes
the Pallas kernels refuse (S not a multiple of the block) are held against
the jnp oracles only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.decode_attention import ops as da_ops, ref as da_ref
from repro.kernels.flash_attention import ops as fa_ops, ref as fa_ref
from repro.kernels.rmsnorm import ops as rn_ops, ref as rn_ref
from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def tol(name):
    return dict(rtol=2e-2, atol=2e-2) if name == "bfloat16" else \
        dict(rtol=2e-5, atol=2e-5)


def inputs(shapes, dtype, seed):
    """The same numpy normals as JAX arrays and torch tensors of one dtype
    (both round fp32 to bf16 to nearest even)."""
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dtype]
    xs = [rng.standard_normal(s, dtype=np.float32) for s in shapes]
    return ([jnp.asarray(x, jd) for x in xs],
            [torch.from_numpy(x).to(td) for x in xs])


def close(port, jax_out, dtype):
    np.testing.assert_allclose(port.float().numpy(),
                               np.asarray(jax_out, np.float32), **tol(dtype))


# -- K3 rmsnorm ----------------------------------------------------------------


@pytest.mark.parametrize("rows,dim", [(4, 256), (3, 1024), (16, 512)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm_plain_matches_pallas_and_ref(rows, dim, dtype):
    (x, w), (tx, tw) = inputs([(rows, dim), (dim,)], dtype, rows * dim)
    out = rmsnorm(tx, tw)
    assert rmsnorm.launches == 0          # CPU tensors: the plain version
    close(out, rn_ops.rmsnorm(x, w, interpret=True), dtype)
    close(out, rn_ref.rmsnorm_ref(x, w), dtype)
    close(rmsnorm_ref(tx, tw), rn_ref.rmsnorm_ref(x, w), dtype)


@pytest.mark.parametrize("shape", [(5, 100), (2, 3, 33)])
def test_rmsnorm_plain_ragged_matches_ref(shape):
    (x, w), (tx, tw) = inputs([shape, shape[-1:]], "float32", 9)
    close(rmsnorm(tx, tw), rn_ref.rmsnorm_ref(x, w), "float32")


# -- K4 prefill attention ----------------------------------------------------


@pytest.mark.parametrize("seq,block,causal", [(128, 128, True),
                                              (128, 128, False),
                                              (256, 128, True)])
@pytest.mark.parametrize("kv", [2, 1])                 # GQA 2:1 and MQA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_plain_matches_pallas_and_ref(seq, block, causal, kv, dtype):
    b, h, d = 2, 2, 64
    (q, k, v), (tq, tk, tv) = inputs(
        [(b, h, seq, d), (b, kv, seq, d), (b, kv, seq, d)], dtype, seq + kv)
    out = flash_attention(tq, tk, tv, causal=causal)
    pallas = fa_ops.flash_attention(q, k, v, causal=causal, block_q=block,
                                    block_k=block, interpret=True)
    close(out, pallas, dtype)
    close(out, fa_ref.attention_ref(q, k, v, causal=causal), dtype)


@pytest.mark.parametrize("window", [32, 128])
def test_flash_plain_sliding_window_matches_pallas(window):
    (q, k, v), (tq, tk, tv) = inputs([(1, 4, 256, 64), (1, 2, 256, 64),
                                      (1, 2, 256, 64)], "float32", window)
    out = flash_attention(tq, tk, tv, causal=True, window=window)
    pallas = fa_ops.flash_attention(q, k, v, causal=True, window=window,
                                    block_q=128, block_k=128, interpret=True)
    close(out, pallas, "float32")
    close(out, fa_ref.attention_ref(q, k, v, causal=True, window=window),
          "float32")


@pytest.mark.parametrize("seq", [1, 77, 190])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0), (True, 40),
                                           (False, 33)])
def test_flash_plain_ragged_matches_ref(seq, causal, window):
    (q, k, v), (tq, tk, tv) = inputs([(2, 4, seq, 32), (2, 2, seq, 32),
                                      (2, 2, seq, 32)], "float32", seq)
    close(attention_ref(tq, tk, tv, causal=causal, window=window),
          fa_ref.attention_ref(q, k, v, causal=causal, window=window),
          "float32")


def test_flash_plain_reads_strided_projections():
    # full_attention hands the kernel (B, S, H, hd) projections, transposed
    (q, k, v), (tq, tk, tv) = inputs([(2, 96, 4, 32), (2, 96, 2, 32),
                                      (2, 96, 2, 32)], "float32", 5)
    out = flash_attention(tq.transpose(1, 2), tk.transpose(1, 2),
                          tv.transpose(1, 2), causal=True, window=20)
    ref = fa_ref.attention_ref(q.swapaxes(1, 2), k.swapaxes(1, 2),
                               v.swapaxes(1, 2), causal=True, window=20)
    close(out, ref, "float32")


# -- K5 decode attention -----------------------------------------------------


@pytest.mark.parametrize("cache,block_k", [(256, 128), (512, 256)])
@pytest.mark.parametrize("kv", [2, 1])                 # GQA 2:1 and MQA
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_plain_matches_pallas_and_ref(cache, block_k, kv, dtype):
    b, h, d = 2, 4, 64
    (q, k, v), (tq, tk, tv) = inputs(
        [(b, h, d), (b, cache, kv, d), (b, cache, kv, d)], dtype, cache + kv)
    n = cache * 3 // 4
    out = decode_attention(tq, tk, tv, torch.tensor(n, dtype=torch.int32))
    length = jnp.asarray(n, jnp.int32)
    close(out, da_ops.decode_attention(q, k, v, length, block_k=block_k,
                                       interpret=True), dtype)
    close(out, da_ref.decode_attention_ref(q, k, v, length), dtype)


@pytest.mark.parametrize("s,n", [(512, 100), (300, 7), (2112, 2049)])
def test_decode_plain_respects_length_mask(s, n):
    """Slots at or past ``length`` (set to +-999 here) do not count."""
    (q, k, v), (tq, tk, tv) = inputs([(1, 2, 64), (1, s, 1, 64),
                                      (1, s, 1, 64)], "float32", s)
    length = torch.tensor(n, dtype=torch.int32)
    out1 = decode_attention(tq, tk, tv, length)
    tk2, tv2 = tk.clone(), tv.clone()
    tk2[:, n:] = 999.0
    tv2[:, n:] = -999.0
    out2 = decode_attention(tq, tk2, tv2, length)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-6)
    k2 = np.asarray(k).copy()
    v2 = np.asarray(v).copy()
    k2[:, n:], v2[:, n:] = 999.0, -999.0
    close(out2, da_ref.decode_attention_ref(q, jnp.asarray(k2),
                                            jnp.asarray(v2),
                                            jnp.asarray(n, jnp.int32)),
          "float32")
    if s % 128 == 0:                    # shapes the Pallas kernel takes
        close(out2, da_ops.decode_attention(
            q, jnp.asarray(k2), jnp.asarray(v2), jnp.asarray(n, jnp.int32),
            block_k=128, interpret=True), "float32")


@pytest.mark.parametrize("s", [1, 77, 2112])
def test_decode_plain_ragged_matches_ref(s):
    (q, k, v), (tq, tk, tv) = inputs([(3, 8, 32), (3, s, 4, 32),
                                      (3, s, 4, 32)], "float32", s)
    n = max(1, s - 5)
    close(decode_attention_ref(tq, tk, tv, n),
          da_ref.decode_attention_ref(q, k, v, jnp.asarray(n, jnp.int32)),
          "float32")


def test_cpu_wrappers_check_their_inputs():
    x = torch.zeros(4, 8)
    with pytest.raises(TypeError, match="dtype"):
        rmsnorm(x, torch.zeros(8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match=r"\(D,\)"):
        rmsnorm(x, torch.zeros(7))
    q = torch.zeros(1, 3, 16, 32)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        flash_attention(q, torch.zeros(1, 2, 16, 32), torch.zeros(1, 2, 16, 32))
    with pytest.raises(TypeError, match="int32"):
        decode_attention(torch.zeros(1, 2, 32), torch.zeros(1, 8, 1, 32),
                         torch.zeros(1, 8, 1, 32), torch.tensor(3))
