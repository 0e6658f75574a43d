"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs a CUDA card (marker ``cuda``) and skips without one.
On a machine with a card, run them with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports only the port, so it runs where JAX is not installed.
"""

import numpy as np
import pytest
import torch

from repro_torch.kernels.decode_attention import (decode_attention,
                                                  decode_attention_ref)
from repro_torch.kernels.flash_attention import attention_ref, flash_attention
from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
from repro_torch.kernels.chained_lindley import (chained_lindley_scan,
                                                 chained_lindley_scan_ref)
from repro_torch.kernels.lindley_scan import (kw_chain, kw_chain_ref,
                                              lindley_scan, lindley_scan_ref)
from repro_torch.serving import fastsim
from repro_torch.serving.dag import StageSpec, WorkflowDAG, sweep_pipeline

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


def pipeline_grid(n, b, stages, c, seed, device):
    """Ragged lanes of sorted arrivals at load ~0.9 of c servers, +inf past
    each lane's count, and (stages, N, B) unit-mean exponential services."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(0, n + 1, size=b)
    counts[0], counts[1] = n, 0
    A = np.full((n, b), np.inf)
    S = np.zeros((stages, n, b))
    for j, k in enumerate(counts):
        A[:k, j] = np.sort(rng.uniform(0.0, k * 1.1 / c, size=k))
        S[:, :k, j] = rng.exponential(1.0, size=(stages, k))
    return (torch.from_numpy(A).to(device), torch.from_numpy(S).to(device),
            torch.from_numpy(counts))


@pytest.mark.parametrize("stages", [1, 3, 8, 16, 17])
def test_chained_kernel_equals_plain_version(card, stages):
    A, S, counts = pipeline_grid(500, 150, stages, 1, seed=stages,
                                 device=card)
    before = chained_lindley_scan.launches
    out = chained_lindley_scan(A, S, counts)
    torch.cuda.synchronize()
    assert chained_lindley_scan.launches == before + (1 if stages <= 16
                                                      else 2)
    ref = chained_lindley_scan_ref(A, S, counts)
    assert torch.equal(out, ref)
    assert torch.isinf(out[:, :, 1]).all()          # the empty lane


@pytest.mark.parametrize("c", [1, 2, 4, 32])
def test_kw_chain_kernel_equals_plain_version(card, c):
    A, S, counts = pipeline_grid(600, 200, 1, c, seed=100 + c, device=card)
    before = kw_chain.launches
    out = kw_chain(A, S[0], counts, num_servers=c)
    torch.cuda.synchronize()
    assert kw_chain.launches == before + 1
    ref = kw_chain_ref(A, S[0], counts, num_servers=c)
    assert torch.equal(out, ref)


def _stage(name, m, c):
    return StageSpec(name=name, mean_s=(m, 0.7 * m), p95_s=(1.6 * m, m),
                     num_servers=c)


@pytest.mark.parametrize("kind", ["tandem", "fork_join"])
def test_pipeline_sweep_on_the_card_equals_the_host_engine(card, kind):
    if kind == "tandem":
        dag = WorkflowDAG.tandem([_stage("a", 0.05, 1), _stage("b", 0.08, 2),
                                  _stage("c", 0.04, 1), _stage("d", 0.06, 1)])
    else:
        dag = WorkflowDAG.fork_join(
            [_stage("x", 0.05, 1), _stage("y", 0.07, 3)],
            _stage("join", 0.06, 1), tail=[_stage("t", 0.04, 1)])
    rungs = [(0,) * dag.num_stages, (1,) * dag.num_stages]
    kw = dict(arrival_rates_qps=(6.0, 14.0), duration_s=200.0,
              replications=3, slo_s=0.5, seed=5)
    before = (chained_lindley_scan.launches, kw_chain.launches)
    dev = sweep_pipeline(dag, rungs, device=card, **kw)
    assert chained_lindley_scan.launches > before[0]
    host = sweep_pipeline(dag, rungs, backend="numpy", **kw)
    assert dev == host


# -- the model kernels (K3, K4, K5) ------------------------------------------
# tolerances of tests/test_kernels.py: bf16 2e-2, fp32 2e-5


def tol(dtype):
    if dtype == torch.bfloat16:
        return dict(rtol=2e-2, atol=2e-2)
    return dict(rtol=2e-5, atol=2e-5)


def randn(shape, dtype, device, seed):
    g = np.random.default_rng(seed)
    return torch.from_numpy(g.standard_normal(shape, dtype=np.float32)).to(
        device=device, dtype=dtype)


@pytest.mark.parametrize("rows,dim", [(1, 32), (7, 100), (16, 2048),
                                      (300, 4097), (5, 16384)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_kernel_matches_plain_version(card, rows, dim, dtype):
    x = randn((rows, dim), dtype, card, rows + dim)
    w = randn((dim,), dtype, card, 1)
    before = rmsnorm.launches
    out = rmsnorm(x, w)
    torch.cuda.synchronize()
    assert rmsnorm.launches == before + 1
    torch.testing.assert_close(out.float(), rmsnorm_ref(x, w).float(),
                               **tol(dtype))


@pytest.mark.parametrize("s", [64, 100, 257])
@pytest.mark.parametrize("heads,kv", [(4, 2), (4, 1), (2, 2)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window", [(True, 0), (False, 0),
                                           (True, 40), (False, 33)])
def test_flash_kernel_matches_plain_version(card, s, heads, kv, dtype,
                                            causal, window):
    b, hd = 2, 64
    q = randn((b, heads, s, hd), dtype, card, s)
    k = randn((b, kv, s, hd), dtype, card, s + 1)
    v = randn((b, kv, s, hd), dtype, card, s + 2)
    before = flash_attention.launches
    out = flash_attention(q, k, v, causal=causal, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(), **tol(dtype))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 512),
                                           (False, 0)])
def test_flash_kernel_matches_plain_version_at_serve_magnitudes(
        card, causal, window):
    # the serving path's q, k, v have entries of ~45 (its stacked weights
    # draw at unit scale), so softmax rows are nearly one-hot and a few
    # large values of v of opposite sign can nearly cancel
    b, h, kv, s, hd = 2, 4, 2, 1030, 128
    q, k, v = (45 * randn(shape, torch.float32, card, seed).to(torch.bfloat16)
               for seed, shape in ((7, (b, h, s, hd)), (8, (b, kv, s, hd)),
                                   (9, (b, kv, s, hd))))
    out = flash_attention(q, k, v, causal=causal, window=window)
    ref = attention_ref(q, k, v, causal=causal, window=window)
    torch.testing.assert_close(out.float(), ref.float(),
                               **tol(torch.bfloat16))


@pytest.mark.parametrize("hd", [32, 128, 256])
def test_flash_kernel_reads_strided_projections(card, hd):
    # the model's (B, S, H, hd) projections, transposed, read in place
    b, s, h, kv = 2, 190, 4, 2
    q = randn((b, s, h, hd), torch.bfloat16, card, 3).transpose(1, 2)
    k = randn((b, s, kv, hd), torch.bfloat16, card, 4).transpose(1, 2)
    v = randn((b, s, kv, hd), torch.bfloat16, card, 5).transpose(1, 2)
    out = flash_attention(q, k, v, causal=True, window=64)
    assert out.stride() == q.stride()
    ref = attention_ref(q, k, v, causal=True, window=64)
    torch.testing.assert_close(out.float(), ref.float(),
                               **tol(torch.bfloat16))


@pytest.mark.parametrize("s,length", [(64, 1), (100, 77), (2112, 2049),
                                      (512, 512), (513, 0)])
@pytest.mark.parametrize("heads,kv,hd", [(4, 2, 64), (4, 1, 64),
                                         (16, 8, 128), (8, 8, 32)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_kernel_matches_plain_version(card, s, length, heads, kv, hd,
                                             dtype):
    b = 3
    q = randn((b, heads, hd), dtype, card, s)
    k = randn((b, s, kv, hd), dtype, card, s + 1)
    v = randn((b, s, kv, hd), dtype, card, s + 2)
    if 0 < length < s:
        k[:, length:] = 999.0
        v[:, length:] = -999.0
    n = torch.tensor(length, dtype=torch.int32, device=card)
    before = decode_attention.launches
    out = decode_attention(q, k, v, n)
    torch.cuda.synchronize()
    assert decode_attention.launches == before + 1
    ref = decode_attention_ref(q, k, v, n)
    torch.testing.assert_close(out.float(), ref.float(), **tol(dtype))


def test_model_kernel_wrappers_reject_mixed_devices_and_dtypes(card):
    x = randn((4, 64), torch.bfloat16, card, 0)
    with pytest.raises(ValueError, match="share a device"):
        rmsnorm(x, x[0].cpu())
    with pytest.raises(TypeError, match="dtype"):
        rmsnorm(x.half(), x[0].half())
    q = randn((1, 2, 16, 64), torch.bfloat16, card, 1)
    with pytest.raises(ValueError, match="share a device"):
        flash_attention(q, q.cpu(), q.cpu())
    with pytest.raises(TypeError, match="dtype"):
        flash_attention(q, q.float(), q.float())
    qd = randn((1, 2, 64), torch.bfloat16, card, 2)
    cache = randn((1, 16, 2, 64), torch.bfloat16, card, 3)
    n = torch.tensor(5, dtype=torch.int32, device=card)
    with pytest.raises(ValueError, match="share a device"):
        decode_attention(qd, cache, cache, n.cpu())
    with pytest.raises(TypeError, match="dtype"):
        decode_attention(qd, cache.float(), cache.float(), n)
    with pytest.raises(TypeError, match="int32"):
        decode_attention(qd, cache, cache, n.long())
