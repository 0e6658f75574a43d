"""The port's Lindley / Kiefer-Wolfowitz sweep kernel, held against the
JAX package's own scans.

On this host the wrapper runs its plain version (CPU tensors); the kernel
itself is held against the same plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.  Inputs are ragged,
zero-padded (N, B) grids made from a numpy seed; the JAX side runs in
float64 under ``jax.enable_x64(True)``, the Pallas kernel in interpret mode.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.lindley_scan import lindley_scan as pallas_lindley_scan
from repro.serving import fastsim as jax_fastsim
from repro_torch.device import resolve_device
from repro_torch.kernels.lindley_scan import MAX_SERVERS, lindley_scan

SLO = 1.5


def ragged_grid(n, b, c, seed):
    """Lane j holds counts[j] sorted arrivals at load ~0.9 of c servers
    with unit-mean exponential service, zero-padded to n rows."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, size=b)
    counts[0], counts[1] = n, 0
    A = np.zeros((n, b))
    S = np.zeros((n, b))
    for j, k in enumerate(counts):
        A[:k, j] = np.sort(rng.uniform(0.0, k * 1.1 / c, size=k))
        S[:k, j] = rng.exponential(1.0, size=k)
    return A, S, counts


def run_port(A, S, counts, c):
    out = lindley_scan(torch.from_numpy(A), torch.from_numpy(S),
                       torch.from_numpy(counts), num_servers=c, slo=SLO)
    return [t.numpy() for t in out]


def time_order_sum(grid):
    acc = np.zeros(grid.shape[1])
    for row in grid:
        acc = acc + row
    return acc


def check_reductions(waits, lats, wait_sum, lat_sum, ok, active):
    np.testing.assert_array_equal(wait_sum, time_order_sum(waits))
    np.testing.assert_array_equal(lat_sum, time_order_sum(lats))
    np.testing.assert_array_equal(ok, np.sum((lats <= SLO) & active, axis=0))


def test_c1_bit_equal_to_pallas_lindley_scan():
    n, b = 512, 256
    A, S, counts = ragged_grid(n, b, 1, seed=0)
    with jax.enable_x64(True):
        C = np.asarray(pallas_lindley_scan(jnp.asarray(A), jnp.asarray(S),
                                           interpret=True))
    assert C.dtype == np.float64
    active = np.arange(n)[:, None] < counts[None, :]
    prev = np.vstack([np.zeros((1, b)), C[:-1]])
    start = np.maximum(A, prev)
    waits, lats, wait_sum, lat_sum, ok = run_port(A, S, counts, 1)
    np.testing.assert_array_equal(lats, np.where(active, C - A, 0.0))
    np.testing.assert_array_equal(waits, np.where(active, start - A, 0.0))
    check_reductions(waits, lats, wait_sum, lat_sum, ok, active)


@pytest.mark.parametrize("c", [2, 3, 4, 32])
def test_kiefer_wolfowitz_bit_equal_to_jax_kw(c):
    n, b = 256, 48
    A, S, counts = ragged_grid(n, b, c, seed=c)
    with jax.enable_x64(True):
        jw, jl = jax_fastsim._jax_kw(jnp.asarray(A), jnp.asarray(S), c)
        jw, jl = np.asarray(jw), np.asarray(jl)
    assert jl.dtype == np.float64
    active = np.arange(n)[:, None] < counts[None, :]
    waits, lats, wait_sum, lat_sum, ok = run_port(A, S, counts, c)
    np.testing.assert_array_equal(waits, np.where(active, jw, 0.0))
    np.testing.assert_array_equal(lats, np.where(active, jl, 0.0))
    assert np.count_nonzero(waits) > 0      # the pool really queued
    check_reductions(waits, lats, wait_sum, lat_sum, ok, active)


def _bad_inputs():
    A, S, counts = (torch.from_numpy(x) for x in ragged_grid(16, 8, 1, 3))
    return {
        "float32": ((A.float(), S.float(), counts), {}, TypeError),
        "shape": ((A, S[:, :4], counts), {}, ValueError),
        "one_dim": ((A[:, 0], S[:, 0], counts[:1]), {}, ValueError),
        "counts_dtype": ((A, S, counts.int()), {}, ValueError),
        "counts_range": ((A, S, counts + 17), {}, ValueError),
        "counts_device": ((A, S, counts.to("meta")), {}, ValueError),
        "mixed_devices": ((A, S.to("meta"), counts), {}, ValueError),
        "contiguity": ((A.t().contiguous().t(), S, counts), {}, ValueError),
        "c_zero": ((A, S, counts), {"num_servers": 0}, ValueError),
        "c_too_big": ((A, S, counts), {"num_servers": MAX_SERVERS + 1},
                      ValueError),
    }


@pytest.mark.parametrize("case", sorted(_bad_inputs()))
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    args, kwargs, exc = _bad_inputs()[case]
    with pytest.raises(exc):
        lindley_scan(*args, **kwargs)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_cuda_request_without_a_card_raises(device):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        resolve_device(device)


def test_empty_rows_and_default_slo():
    A, S, counts = ragged_grid(8, 4, 1, seed=5)
    out = lindley_scan(torch.from_numpy(A), torch.from_numpy(S),
                       torch.zeros(4, dtype=torch.int64))
    assert not out.lats.any() and not out.waits.any()
    assert out.ok.tolist() == [0, 0, 0, 0]
    full = lindley_scan(torch.from_numpy(A), torch.from_numpy(S),
                        torch.from_numpy(counts))
    assert full.ok.tolist() == counts.tolist()      # slo = inf admits all
