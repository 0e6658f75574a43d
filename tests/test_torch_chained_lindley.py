"""The port's chained Lindley kernel (K2) and the Kiefer-Wolfowitz
completion entry of its Lindley kernel, held against the JAX package's own
scans.

On this host the wrappers run their plain versions (CPU tensors); the
kernels themselves are held against the same plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Inputs are ragged
grids made from a numpy seed: sorted arrivals with ``+inf`` past each
lane's count (the pipeline sweep's padding), zero-padded services.  The
JAX side runs in float64 under ``jax.enable_x64(True)``, the Pallas kernel
in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lindley_scan import (
    chained_lindley_scan as pallas_chained_lindley_scan,
)
from repro.serving import fastsim as jax_fastsim
from repro_torch.kernels.chained_lindley import (
    MAX_STAGES,
    chained_lindley_scan,
    chained_lindley_scan_ref,
)
from repro_torch.kernels.lindley_scan import kw_chain

# the Pallas kernel adds in max/add order, the port in the P/M order that
# is bit-exact to numpy: the two differ by a few ulps of the completion
PALLAS_RTOL = 1e-12


def ragged_grid(n, b, stages, c, seed):
    """Lane j holds counts[j] sorted arrivals at load ~0.9 of c servers
    with unit-mean lognormal service, +inf (arrivals) and 0 (services)
    past the count."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, size=b)
    counts[0], counts[1] = n, 0
    A = np.full((n, b), np.inf)
    S = np.zeros((stages, n, b))
    for j, k in enumerate(counts):
        A[:k, j] = np.sort(rng.uniform(0.0, k * 1.1 / c, size=k))
        S[:, :k, j] = rng.lognormal(-0.18, 0.6, size=(stages, k))
    return A, S, counts


def run_chained(A, S, counts):
    return chained_lindley_scan(torch.from_numpy(A), torch.from_numpy(S),
                                torch.from_numpy(counts)).numpy()


@pytest.mark.parametrize("stages", [1, 2, 3, 8, 17])
def test_chained_bit_equal_to_jax_chained_seq(stages):
    A, S, counts = ragged_grid(300, 40, stages, 1, seed=stages)
    with jax.enable_x64(True):
        ref = np.asarray(jax_fastsim._jax_chained_seq(jnp.asarray(A),
                                                      jnp.asarray(S)))
    assert ref.dtype == np.float64
    got = run_chained(A, S, counts)
    np.testing.assert_array_equal(got, ref)
    live = np.arange(300)[:, None] < counts[None, :]
    assert np.isfinite(got[:, live]).all() and np.isinf(got[:, ~live]).all()
    # stage j+1 really queued behind stage j
    assert (got[1:] > got[:-1])[:, live].all()


def test_chained_allclose_to_pallas_chained_lindley_scan():
    A, S, counts = ragged_grid(512, 128, 3, 1, seed=11)
    with jax.enable_x64(True):
        ref = np.asarray(pallas_chained_lindley_scan(
            jnp.asarray(A), jnp.asarray(S), interpret=True))
    assert ref.dtype == np.float64
    got = run_chained(A, S, counts)
    live = np.arange(512)[:, None] < counts[None, :]
    np.testing.assert_allclose(got[:, live], ref[:, live],
                               rtol=PALLAS_RTOL, atol=0)
    assert np.isinf(ref[:, ~live]).all() and np.isinf(got[:, ~live]).all()


def test_splitting_long_chains_into_launches_is_bit_exact():
    """The wrapper runs J > MAX_STAGES as consecutive launches, each fed
    the last stored completion of the one before."""
    stages = MAX_STAGES + 3
    A, S, counts = ragged_grid(200, 24, stages, 1, seed=3)
    A, S, counts = (torch.from_numpy(x) for x in (A, S, counts))
    whole = chained_lindley_scan_ref(A, S, counts)
    head = chained_lindley_scan_ref(A, S[:MAX_STAGES].contiguous(), counts)
    tail = chained_lindley_scan_ref(head[-1], S[MAX_STAGES:].contiguous(),
                                    counts)
    assert torch.equal(whole, torch.cat([head, tail]))


@pytest.mark.parametrize("c", [2, 4, 32])
def test_kw_chain_bit_equal_to_jax_kw_chain(c):
    A, S, counts = ragged_grid(256, 48, 1, c, seed=c)
    with jax.enable_x64(True):
        ref = np.asarray(jax_fastsim._jax_kw_chain(
            jnp.asarray(A), jnp.asarray(S[0]), c=c))
    assert ref.dtype == np.float64
    got = kw_chain(torch.from_numpy(A), torch.from_numpy(S[0]),
                   torch.from_numpy(counts), num_servers=c).numpy()
    np.testing.assert_array_equal(got, ref)
    live = np.arange(256)[:, None] < counts[None, :]
    # the pool really queued: some requests started after they arrived
    assert (got - S[0] > A)[live].any()


def _bad_inputs():
    A, S, counts = (torch.from_numpy(x) for x in ragged_grid(16, 8, 2, 1, 3))
    return {
        "float32": ((A.float(), S.float(), counts), TypeError),
        "stage_shape": ((A, S[:, :, :4], counts), ValueError),
        "two_dim_services": ((A, S[0], counts), ValueError),
        "no_stages": ((A, S[:0], counts), ValueError),
        "counts_dtype": ((A, S, counts.int()), ValueError),
        "counts_range": ((A, S, counts + 17), ValueError),
        "counts_device": ((A, S, counts.to("meta")), ValueError),
        "mixed_devices": ((A, S.to("meta"), counts), ValueError),
        "contiguity": ((A.t().contiguous().t(), S, counts), ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        chained_lindley_scan(*args)


@pytest.mark.parametrize("c", [0, 33])
def test_kw_chain_rejects_pool_sizes_the_kernel_does_not_take(c):
    A, S, counts = (torch.from_numpy(x) for x in ragged_grid(16, 8, 1, 1, 4))
    with pytest.raises(ValueError):
        kw_chain(A, S[0], counts, num_servers=c)


def test_empty_lanes_come_out_inf():
    A, S, counts = (torch.from_numpy(x) for x in ragged_grid(8, 4, 2, 1, 5))
    zero = torch.zeros(4, dtype=torch.int64)
    assert torch.isinf(chained_lindley_scan(A, S, zero)).all()
    assert torch.isinf(kw_chain(A, S[0], zero, num_servers=3)).all()
