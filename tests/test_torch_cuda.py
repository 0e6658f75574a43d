"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
On a machine with a card, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports only the port, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.lindley_scan import lindley_scan, lindley_scan_ref
from repro_torch.serving import fastsim

pytestmark = pytest.mark.cuda


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def ragged_grid(n, b, c, seed, device):
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, size=b)
    counts[0], counts[1] = n, 0
    A = np.zeros((n, b))
    S = np.zeros((n, b))
    for j, k in enumerate(counts):
        A[:k, j] = np.sort(rng.uniform(0.0, k * 1.1 / c, size=k))
        S[:k, j] = rng.exponential(1.0, size=k)
    return (torch.from_numpy(A).to(device), torch.from_numpy(S).to(device),
            torch.from_numpy(counts))


@pytest.mark.parametrize("c", [1, 2, 3, 4, 17, 32])
def test_kernel_equals_plain_version(card, c):
    A, S, counts = ragged_grid(600, 200, c, seed=c, device=card)
    before = lindley_scan.launches
    out = lindley_scan(A, S, counts, num_servers=c, slo=1.5)
    torch.cuda.synchronize()
    assert lindley_scan.launches == before + 1
    ref = lindley_scan_ref(A, S, counts, num_servers=c, slo=1.5)
    for name, x, y in zip(out._fields, out, ref):
        assert torch.equal(x, y), name


@pytest.mark.parametrize("c", [1, 4])
def test_sweep_on_the_card_matches_the_host_engine(card, c):
    kw = dict(arrival_rates_qps=[2.0, 5.0 * c], duration_s=300.0,
              num_servers=c, replications=4, slo_s=1.0, seed=2)
    dev = fastsim.simulate_batch([0.1, 0.25, 0.45], [0.14, 0.35, 0.63],
                                 device=card, **kw)
    host = fastsim.simulate_batch([0.1, 0.25, 0.45], [0.14, 0.35, 0.63],
                                  backend="numpy", **kw)
    for name in ("p95_latency_s", "slo_compliance", "num_requests"):
        np.testing.assert_array_equal(getattr(dev, name), getattr(host, name))
    np.testing.assert_allclose(dev.mean_wait_s, host.mean_wait_s,
                               rtol=1e-12, atol=0)


def test_wrapper_rejects_mixed_devices(card):
    A, S, counts = ragged_grid(16, 4, 1, seed=0, device=card)
    with pytest.raises(ValueError, match="share a device"):
        lindley_scan(A, S.cpu(), counts)
    with pytest.raises(ValueError, match="host tensor"):
        lindley_scan(A, S, counts.to(card))
