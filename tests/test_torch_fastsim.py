"""The port's batched sweep against the JAX package's.

``repro_torch.serving.fastsim.simulate_batch(device="cpu")`` runs the
kernel's plain version on the same host-drawn grids that
``repro.serving.fastsim.simulate_batch(backend="numpy")`` consumes: p95,
compliance and request counts must be bit-equal, means within 1e-12
relative (their sums may run in another order).  At c = 1 the device
engine is also held against the JAX package's own device sweep,
``_jax_sweep(impl="pallas")``, under ``jax.enable_x64(True)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving import fastsim as jax_fastsim
from repro_torch.serving import fastsim

MEANS = [0.10, 0.25, 0.45]
P95S = [0.14, 0.35, 0.63]
SLO_S = 1.0
MEAN_RTOL = 1e-12


def traces():
    rng = np.random.default_rng(11)
    return [np.sort(rng.uniform(0.0, 120.0, size=n)) for n in (700, 240)]


def assert_sweeps_agree(port, ref):
    for name in ("p95_latency_s", "slo_compliance", "num_requests",
                 "throughput_qps"):
        np.testing.assert_array_equal(getattr(port, name),
                                      getattr(ref, name), err_msg=name)
    for name in ("mean_wait_s", "mean_latency_s"):
        np.testing.assert_allclose(getattr(port, name), getattr(ref, name),
                                   rtol=MEAN_RTOL, atol=0, err_msg=name)
    assert port.duration_s == ref.duration_s and port.slo_s == ref.slo_s


@pytest.mark.parametrize("c", [1, 4])
@pytest.mark.parametrize("arrivals", ["rates", "traces"])
@pytest.mark.parametrize("service", ["lognormal", "exponential"])
def test_simulate_batch_matches_reference_numpy(service, arrivals, c):
    kwargs = dict(duration_s=120.0, num_servers=c, replications=2,
                  slo_s=SLO_S, seed=3)
    if arrivals == "rates":
        kwargs["arrival_rates_qps"] = [2.0, 5.0 * c, 8.0 * c]
    else:
        kwargs["arrival_traces"] = traces()
    p95s = P95S if service == "lognormal" else None
    ref = jax_fastsim.simulate_batch(MEANS, p95s, backend="numpy", **kwargs)
    port = fastsim.simulate_batch(MEANS, p95s, device="cpu", **kwargs)
    assert_sweeps_agree(port, ref)
    assert ref.slo_compliance.min() < 1.0      # some cells miss the SLO
    # the port's numpy engine is the reference loop, bit for bit
    host = fastsim.simulate_batch(MEANS, p95s, backend="numpy", **kwargs)
    for name in ("mean_wait_s", "mean_latency_s", "p95_latency_s",
                 "slo_compliance", "num_requests"):
        np.testing.assert_array_equal(getattr(host, name),
                                      getattr(ref, name), err_msg=name)


def test_no_slo_gives_full_compliance():
    kwargs = dict(arrival_rates_qps=[3.0], duration_s=60.0, seed=1)
    ref = jax_fastsim.simulate_batch(MEANS, backend="numpy", **kwargs)
    port = fastsim.simulate_batch(MEANS, device="cpu", **kwargs)
    assert_sweeps_agree(port, ref)
    assert (port.slo_compliance == 1.0).all()


def test_c1_device_engine_matches_jax_pallas_sweep():
    A, S, counts = fastsim._build_grid(
        np.asarray(MEANS), np.asarray(P95S), arrival_rates_qps=[3.0, 7.0],
        arrival_traces=None, duration_s=90.0, replications=3, seed=5)
    with jax.enable_x64(True):
        j_wait, j_lat, j_comp, j_lats = (np.asarray(x) for x in
                                         jax_fastsim._jax_sweep(
            jnp.asarray(A), jnp.asarray(S), jnp.asarray(counts),
            jnp.asarray(SLO_S), impl="pallas", c=1, has_slo=True))
    assert j_lats.dtype == np.float64
    mean_wait, mean_lat, comp, p95 = fastsim._sweep_torch(
        A, S, counts, 1, SLO_S, torch.device("cpu"))
    np.testing.assert_array_equal(comp, j_comp)
    np.testing.assert_array_equal(p95, jax_fastsim._p95_cells(j_lats, counts))
    np.testing.assert_allclose(mean_wait, j_wait, rtol=MEAN_RTOL, atol=0)
    np.testing.assert_allclose(mean_lat, j_lat, rtol=MEAN_RTOL, atol=0)


@pytest.mark.parametrize("kwargs, exc", [
    (dict(backend="auto"), ValueError),
    (dict(backend="jax"), ValueError),
    (dict(num_servers=33), ValueError),
    (dict(device="cpu", num_servers=0), ValueError),
])
def test_simulate_batch_rejects_bad_arguments(kwargs, exc):
    args = dict(arrival_rates_qps=[1.0], duration_s=10.0, device="cpu")
    args.update(kwargs)
    with pytest.raises(exc):
        fastsim.simulate_batch(MEANS, **args)


def test_default_device_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks hosts without one")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fastsim.simulate_batch(MEANS, arrival_rates_qps=[1.0],
                               duration_s=10.0)
