#!/usr/bin/env python3
"""Run the PyTorch/CUDA port of Compass on one CUDA card and check it.

    python3 chip_smoke.py

Run from the root of a checkout; it needs one CUDA card, ``nvcc`` and
``nvidia-smi``, and imports only the port (``src/repro_torch``).  Phases:

1. the card's name and power limit, as ``nvidia-smi`` reports them;
2. build every kernel from the sources in the checkout (timed);
3. each kernel against its plain PyTorch version on random ragged grids,
   ``torch.equal`` required;
4. the main path, with every launch count set to 0 first: COMPASS-V search
   on the RAG surrogate, ``Planner.plan``, ``Planner.validate`` on the card,
   the Elastico spike run; then the ``fastsim_bench`` FULL grid at c = 1
   and c = 4, its LARGE 32 h cell and a c = 32 cell.  Every sweep is held
   against the port's host engine (``backend="numpy"``): p95, compliance
   and counts bit-equal, means within 1e-12 relative;
5. the pipeline path, with every launch count set to 0 first:
   ``repro_torch.dag_run`` at full size on the card — ``validate_pipeline``
   on the RAG tandem (chained Lindley kernel), ``plan_pipeline`` and
   ``validate_pipeline`` on its fork-join variant (chained Lindley launches
   and a device join), the 8-stage agentic sweep (Kiefer-Wolfowitz
   completion kernel), and the diurnal Elastico and static runs in the
   event-heap ``DagSimulator``.  Every sweep is held against the host
   engine (``backend="numpy"``): all grids equal; the diurnal run must give
   the JAX package's compliance, accuracy and switch count;
6. each kernel again at every shape either path gave it: timed, and held
   against its plain version on the same inputs;
7. the serving path, with every launch count set to 0 first:
   ``repro_torch.launch.serve.run`` serves internlm2-1.8b at full width
   and depth (bf16, weights drawn on the card from seed 0) to 8 requests
   of 2048-token prompts, prefilling both rungs (full attention with a bf16
   KV cache; a 512 window with an int8 cache) and decoding 64 tokens with
   the middle-third rung switch.  Checked: finite logits, the switch
   schedule, the exact launch counts of the RMSNorm, prefill attention and
   decode attention kernels; each of those kernels at every shape the path
   gave it, timed and held against its plain version on the same inputs;
   and the decode attention kernel against the prefill one through the
   model (prefill then one decode step against prefill of one more token);
8. one JSON line of kernel numbers, then the result line.

Any failure exits nonzero and prints no result line; so does a host
without a card, and a directory that holds this script but not the repo.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM data sheet: HBM3 rate and fp64 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP64_FLOPS = 34e12
# fewest cycles between two dependent arithmetic instructions on the card,
# the floor under one step of a lane's chain
DEPENDENT_CYCLES = 4
MEAN_RTOL = 1e-12

# fastsim_bench's synthetic three-rung ladder and its cells
MEANS = [0.10, 0.25, 0.45]
P95S = [0.14, 0.35, 0.63]
SLO_S = 1.0
FULL = dict(duration_s=600.0, rates=(2.0, 5.0, 8.0), replications=16)
LARGE = dict(duration_s=115200.0, rates=(8.0,), replications=2)
# c = 32 at FULL's per-server loads; 120 s bounds the host engine's time
C32 = dict(duration_s=120.0, rates=(64.0, 160.0, 256.0), replications=16)

K1_SOURCE = "src/repro_torch/csrc/lindley_scan.cu"
K1_REPLACES = "src/repro/kernels/lindley_scan/kernel.py:87"
KW_REPLACES = "src/repro/serving/fastsim.py:796"
K2_SOURCE = "src/repro_torch/csrc/chained_lindley.cu"
K2_REPLACES = "src/repro/kernels/lindley_scan/kernel.py:128"
KW_CHAIN_REPLACES = "src/repro/serving/fastsim.py:861"

K3_SOURCE = "src/repro_torch/csrc/rmsnorm.cu"
K3_REPLACES = "src/repro/kernels/rmsnorm/kernel.py:25"
K4_SOURCE = "src/repro_torch/csrc/flash_attention.cu"
K4_REPLACES = "src/repro/kernels/flash_attention/kernel.py:96"
K5_SOURCE = "src/repro_torch/csrc/decode_attention.cu"
K5_REPLACES = "src/repro/kernels/decode_attention/kernel.py:82"

# H100 SXM data sheet: dense bf16 tensor-core rate, fp32 rate outside them
BF16_FLOPS = 989e12
FP32_FLOPS = 67e12

# the serve cell: internlm2-1.8b at full size, eight concurrent requests of
# 2k-token (RAG-style) prompts, 64 tokens each, fast rung window 512 + int8
SERVE_ARCH = "internlm2-1.8b"
SERVE = dict(batch=8, prompt_len=2048, tokens=64, window=512, seed=0)
# the kernels against their plain versions: tests/test_kernels.py's
# tolerances (rtol = atol), by dtype name
MODEL_TOL = {"bfloat16": 2e-2, "float32": 2e-5}
# prefill(prompt + t) against prefill(prompt) then decode_step(t), last
# position's logits, RMS of the difference over RMS of the logits.  Both
# paths run bf16 activations (8 significant bits, 2^-8 ~ 0.4 % a rounding)
# and round at different places in every one of 24 layers: the projections
# of one row against 2049 rows (other GEMM tilings), K4's summation order
# against K5's; the differences add up like a random walk to ~1 %.  A
# wrong mask, position or cache slot would move the logits by about their
# own size (relative RMS ~1).
CONSISTENCY_REL_RMS = 3e-2
# the same check on an fp32 copy of the model (same seed, full width and
# depth): 24 significant bits instead of 8, so the same rounding
# differences stay near 1e-5 relative even if the random network amplifies
# them as much as the bf16 run suggests; a wrong mask, position or slot
# still moves the logits by about their own size.
CONSISTENCY_REL_RMS_FP32 = 1e-3

# the JAX package's diurnal pipeline run (benchmarks/dag_bench.py at full
# size): dynamic compliance and accuracy to 5 places, switch count
DIURNAL_EXPECTED = (0.99756, 0.83205, 470)


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def nvidia_smi(query: str) -> str:
    out = subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, repeats: int) -> float:
    """Mean milliseconds of ``fn`` on the card over ``repeats`` calls,
    after one warm call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / repeats


def k1_bound(counts, n: int, b: int, c: int, clock_hz: float):
    """Least time for one sweep on the card, and what bounds it.

    Bytes: a and s of each live row read once, counts read, waits and lats
    written for the whole (N, B) grid, the per-lane sums and counts
    written.  Operations: the larger of all fp64 operations over the fp64
    rate and the longest lane's chain of dependent steps (max then add for
    c = 1, plus the min that makes the next F[0] for c > 1), each step at
    least DEPENDENT_CYCLES per dependent instruction."""
    live = int(counts.sum())
    nbytes = 16 * live + 8 * b + 16 * n * b + 24 * b
    ops_per_row = 2 + 2 * (c - 1) + 5      # step, chain, 2 subs, 2 sums, <=
    chain = (2 if c == 1 else 3) * DEPENDENT_CYCLES / clock_hz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(live * ops_per_row / FP64_FLOPS, int(counts.max()) * chain)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def k2_bound(counts, n: int, b: int, stages: int, clock_hz: float):
    """Least time for one chained Lindley launch, and what bounds it.

    Bytes: the arrival and the J services of each live row read once,
    counts read, the (J, N, B) completions written.  Operations: the
    larger of all fp64 operations (5 a row and stage) over the fp64 rate
    and the longest dependency path through a lane, counted from the
    kernel's source: one max a row along a stage's m carry, plus a sub, a
    max and an add to pass one row down each stage, DEPENDENT_CYCLES each."""
    live = int(counts.sum())
    nbytes = 8 * live * (1 + stages) + 8 * b + 8 * stages * n * b
    chain = ((int(counts.max()) + 3 * stages) * DEPENDENT_CYCLES
             / clock_hz)
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(live * stages * 5 / FP64_FLOPS, chain)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def kw_chain_bound(counts, n: int, b: int, c: int, clock_hz: float):
    """Least time for one Kiefer-Wolfowitz completion launch: a and s of
    each live row read, counts read, the (N, B) completions written; the
    longest lane's chain of dependent steps (max, add, and the min that
    makes the next F[0] for c > 1) at DEPENDENT_CYCLES each, or all fp64
    operations over the fp64 rate if that is longer."""
    live = int(counts.sum())
    nbytes = 16 * live + 8 * b + 8 * n * b
    chain = (2 if c == 1 else 3) * DEPENDENT_CYCLES / clock_hz
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(live * (2 + 2 * (c - 1)) / FP64_FLOPS,
                int(counts.max()) * chain)
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def bound(nbytes: float, ops: float, flops: float):
    """Least time in ms for ``nbytes`` moved and ``ops`` done at ``flops``,
    and what bounds it."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / flops
    if t_bytes >= t_ops:
        return t_bytes * 1e3, "bytes"
    return t_ops * 1e3, "operations"


def compare_sweeps(name: str, dev, host) -> None:
    import numpy as np

    for field in ("p95_latency_s", "slo_compliance", "num_requests"):
        check(np.array_equal(getattr(dev, field), getattr(host, field)),
              f"{name}: {field} differs between the card and the host")
    for field in ("mean_wait_s", "mean_latency_s"):
        a, b = getattr(dev, field), getattr(host, field)
        check(bool(np.all(np.isfinite(a))), f"{name}: {field} not finite")
        rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
        check(float(rel.max()) <= MEAN_RTOL,
              f"{name}: {field} off by {float(rel.max()):.3e} relative")


def run(torch) -> dict:
    import numpy as np

    from repro_torch import dag_run
    from repro_torch.core.planner import Planner
    from repro_torch.kernels import build
    from repro_torch.kernels.chained_lindley import (chained_lindley_scan,
                                                     chained_lindley_scan_ref)
    from repro_torch.kernels.lindley_scan import (kw_chain, kw_chain_ref,
                                                  lindley_scan,
                                                  lindley_scan_ref)
    from repro_torch.quickstart import (SLO_S as QS_SLO, make_profiler,
                                        search, spike_arrivals, spike_run)
    from repro_torch.serving import dag as dag_mod
    from repro_torch.serving import fastsim
    from repro_torch.workflows.surrogate import RagSurrogate

    device = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)

    # -- 1. the card -----------------------------------------------------------
    card = nvidia_smi("name,power.limit")
    print(card)
    clock_hz = float(nvidia_smi("clocks.max.sm").split()[0]) * 1e6
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{kind}, max SM clock {clock_hz / 1e6:.0f} MHz")

    # -- 2. build --------------------------------------------------------------
    t0 = time.perf_counter()
    libs = build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s "
          f"({', '.join(p.name for p in libs.values())})")

    def kernel_vs_plain(A, S, counts, c, slo):
        """Max abs difference of the kernel from its plain version (which
        must be 0: torch.equal on every output) and the plain version's
        time in ms."""
        out = lindley_scan(A, S, counts, num_servers=c, slo=slo)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ref = lindley_scan_ref(A, S, counts, num_servers=c, slo=slo)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t) * 1e3
        for name, x, y in zip(out._fields, out, ref):
            check(torch.equal(x, y), f"kernel != plain version on {name} "
                                     f"(c={c}, shape {tuple(A.shape)})")
        err = max(float((out.waits - ref.waits).abs().max()),
                  float((out.lats - ref.lats).abs().max()))
        return err, plain_ms

    # -- 3. kernels against their plain versions, random ragged grids ---------
    rng = np.random.default_rng(0)
    for c in (1, 2, 4, 32):
        n, b = 1000, 300
        counts = rng.integers(0, n + 1, size=b)
        counts[0], counts[1] = n, 0
        A = np.zeros((n, b))
        S = np.zeros((n, b))
        for j, k in enumerate(counts):
            A[:k, j] = np.sort(rng.uniform(0.0, k * 1.1 / c, size=k))
            S[:k, j] = rng.exponential(1.0, size=k)
        err, _ = kernel_vs_plain(torch.from_numpy(A).to(device),
                                 torch.from_numpy(S).to(device),
                                 torch.from_numpy(counts), c, 1.5)
        print(f"random ragged grid ({n}, {b}) c={c}: kernel == plain "
              f"(max abs err {err})")

    def timed_plain(fn):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t) * 1e3

    def pipeline_grid(n, b, stages, c):
        """Sorted arrivals, +inf past each lane's count; zero-padded
        (stages, N, B) services."""
        counts = rng.integers(0, n + 1, size=b)
        counts[0], counts[1] = n, 0
        A = np.full((n, b), np.inf)
        S = np.zeros((stages, n, b))
        for j, k in enumerate(counts):
            A[:k, j] = np.sort(rng.uniform(0.0, k * 1.1 / c, size=k))
            S[:, :k, j] = rng.exponential(1.0, size=(stages, k))
        return (torch.from_numpy(A).to(device),
                torch.from_numpy(S).to(device), torch.from_numpy(counts))

    for stages in (1, 3, 16, 17):
        A, S, counts = pipeline_grid(600, 150, stages, 1)
        out = chained_lindley_scan(A, S, counts)
        check(torch.equal(out, chained_lindley_scan_ref(A, S, counts)),
              f"chained_lindley_scan != plain version (J={stages})")
        print(f"random ragged grid (600, 150) J={stages}: "
              f"chained_lindley_scan == plain")
    for c in (1, 2, 8, 32):
        A, S, counts = pipeline_grid(600, 150, 1, c)
        out = kw_chain(A, S[0], counts, num_servers=c)
        check(torch.equal(out, kw_chain_ref(A, S[0], counts,
                                            num_servers=c)),
              f"kw_chain != plain version (c={c})")
        print(f"random ragged grid (600, 150) c={c}: kw_chain == plain")

    # -- 4. the main path ------------------------------------------------------
    cells = {}          # cell -> (grid kwargs, c, launches in the main path)

    def sweep_cell(name, cfg, c, p95s):
        before = lindley_scan.launches
        kw = dict(arrival_rates_qps=list(cfg["rates"]),
                  duration_s=cfg["duration_s"], num_servers=c,
                  replications=cfg["replications"], slo_s=SLO_S, seed=0)
        t = time.perf_counter()
        dev = fastsim.simulate_batch(MEANS, p95s, **kw)
        t_dev = time.perf_counter() - t
        launches = lindley_scan.launches - before
        t = time.perf_counter()
        host = fastsim.simulate_batch(MEANS, p95s, backend="numpy", **kw)
        t_host = time.perf_counter() - t
        compare_sweeps(name, dev, host)
        cells[name] = (dict(means=MEANS, p95s=p95s, **kw), c, launches)
        print(f"{name}: B={dev.num_requests.size} lanes, "
              f"{dev.total_requests} requests, card {t_dev:.3f} s, "
              f"host {t_host:.3f} s, p95/compliance/counts bit-equal, "
              f"means within {MEAN_RTOL:g}")

    counted = (lindley_scan, chained_lindley_scan, kw_chain)

    def zero_counts():
        for k in counted:
            k.launches = 0

    zero_counts()
    t_main = time.perf_counter()

    surrogate = RagSurrogate(seed=0)
    t = time.perf_counter()
    found = search(surrogate)
    t_search = time.perf_counter() - t
    planner = Planner(profiler=make_profiler(surrogate))
    t = time.perf_counter()
    plan = planner.plan(found.feasible, slo_p95_s=QS_SLO)
    t_plan = time.perf_counter() - t
    before = lindley_scan.launches
    t = time.perf_counter()
    validation = planner.validate(plan)          # device=None: the card
    t_val = time.perf_counter() - t
    val_launches = lindley_scan.launches - before
    t = time.perf_counter()
    host_val = planner.validate(plan, backend="numpy")
    t_val_host = time.perf_counter() - t
    check(validation.p95_latency_s == host_val.p95_latency_s
          and validation.slo_compliance == host_val.slo_compliance
          and validation.num_requests == host_val.num_requests,
          "validation: card and host grids differ")
    rel = (np.abs(np.subtract(validation.mean_wait_s, host_val.mean_wait_s))
           / np.maximum(np.abs(host_val.mean_wait_s), 1e-300))
    check(float(rel.max()) <= MEAN_RTOL, "validation: mean waits differ")
    K, L = len(plan.table.policies), len(validation.arrival_rates_qps)
    check(np.isfinite(validation.mean_wait_s).all()
          and np.shape(validation.slo_compliance) == (K, L),
          "validation grid is not finite or has the wrong shape")
    means = [p.point.profile.mean for p in plan.table.policies]
    cells["validation"] = (dict(
        means=means, p95s=[p.point.profile.p95 for p in plan.table.policies],
        arrival_rates_qps=list(validation.arrival_rates_qps),
        duration_s=validation.duration_s, num_servers=1,
        replications=validation.replications, slo_s=QS_SLO, seed=0),
        1, val_launches)
    print(f"search: {len(found.feasible)} feasible configs, "
          f"{found.num_evaluations} evaluated, {t_search:.2f} s")
    print(f"plan: ladder of {K} rungs, {t_plan:.2f} s")
    print(f"validate: {K} rungs x {L} rates x {validation.replications} "
          f"replications = {K * L * validation.replications} lanes, "
          f"{validation.num_requests} requests, card {t_val:.3f} s, "
          f"host {t_val_host:.3f} s, bit-equal to the host engine")

    t = time.perf_counter()
    rows = spike_run(surrogate, plan, spike_arrivals())
    t_spike = time.perf_counter() - t
    by = {r.name: r for r in rows}
    for r in rows:
        print(f"spike {r.name:16s} compliance {r.compliance * 100:5.1f}% "
              f"accuracy {r.accuracy:.3f} p95 {r.p95_s * 1e3:.0f} ms "
              f"switches {r.switches}")
    check(by["elastico"].switches > 0, "Elastico never switched")
    check(by["elastico"].compliance > 0.8
          and by["elastico"].compliance > by["static-accurate"].compliance,
          "Elastico did not hold the SLO better than static-accurate")
    check(by["static-fast"].accuracy < by["elastico"].accuracy
          < by["static-accurate"].accuracy, "accuracy ordering broken")
    print(f"spike run: {t_spike:.2f} s")

    sweep_cell("full_c1", FULL, 1, P95S)
    sweep_cell("full_c4", FULL, 4, P95S)
    sweep_cell("large_c1", LARGE, 1, None)
    sweep_cell("c32", C32, 32, P95S)

    total = lindley_scan.launches
    t_main = time.perf_counter() - t_main
    print(f"main path: {t_main:.1f} s, lindley_scan launches {total}")
    check(total > 0, "the main path never launched lindley_scan")
    check(all(v[2] > 0 for v in cells.values()),
          "a main-path phase did not go through the kernel")

    # -- 5. the pipeline path ------------------------------------------------
    zero_counts()
    t = time.perf_counter()
    dag_out = dag_run.run()                      # device=None: the card
    t_dag = time.perf_counter() - t
    dag_totals = {k.__name__: k.launches for k in counted}
    print(f"pipeline path: {t_dag:.1f} s on {dag_out.device}, launches "
          f"{dag_totals}")
    print(dag_run.report(dag_out))
    check(dag_totals["chained_lindley_scan"] > 0,
          "the pipeline path never launched chained_lindley_scan")
    check(dag_totals["kw_chain"] > 0,
          "the pipeline path never launched kw_chain")
    check(dag_out.launches["rag_tandem"]["chained_lindley_scan"] == 1,
          "rag_tandem did not run as one chained_lindley_scan launch")
    check(dag_out.launches["fork_join"]["chained_lindley_scan"] == 3,
          "fork_join did not run as three chained_lindley_scan launches")
    check(dag_out.launches["agentic_8stage"]["kw_chain"] == 8,
          "agentic_8stage did not run as eight kw_chain launches")
    check(dag_out.fork_join_plan.table.ladder_size == 7,
          "the fork-join plan did not admit all 7 rungs")
    for name, cell in dag_out.cells.items():
        dev_sweep = dag_out.sweeps[name]
        t = time.perf_counter()
        host = dag_run.sweep_cell(cell, backend="numpy")
        t_host = time.perf_counter() - t
        check(dev_sweep == host,
              f"{name}: the card's sweep differs from the host engine's")
        K, L = len(cell.rungs), len(cell.arrival_rates_qps)
        check(np.shape(dev_sweep.mean_latency_s) == (K, L)
              and np.isfinite(dev_sweep.mean_latency_s).all()
              and np.isfinite(dev_sweep.p95_latency_s).all(),
              f"{name}: sweep grid not finite or of the wrong shape")
        print(f"{name}: {K * L * cell.replications} lanes, "
              f"{dev_sweep.num_requests} requests, card "
              f"{dag_out.seconds[name]:.3f} s, host {t_host:.3f} s, every "
              f"grid equal to the host engine's")
    dyn = dag_out.diurnal["dynamic"]
    got = (round(dyn["slo_compliance"], 5), round(dyn["mean_accuracy"], 5),
           dyn["switches"])
    check(got == DIURNAL_EXPECTED,
          f"diurnal run gave {got}, expected {DIURNAL_EXPECTED}")
    check(dyn["slo_compliance"]
          > dag_out.diurnal["static_accurate"]["slo_compliance"]
          and dyn["mean_accuracy"]
          > dag_out.diurnal["static_fast"]["mean_accuracy"],
          "pipeline switching acceptance failed")

    # -- 6. every main-path shape: timed, held against the plain version ------
    entries = []
    for name, (kw, c, launches) in cells.items():
        kw = dict(kw)
        means_ = np.asarray(kw.pop("means"))
        p95s_ = kw.pop("p95s")
        t = time.perf_counter()
        A, S, counts = fastsim._build_grid(
            means_, None if p95s_ is None else np.asarray(p95s_),
            arrival_rates_qps=kw["arrival_rates_qps"], arrival_traces=None,
            duration_s=kw["duration_s"], replications=kw["replications"],
            seed=kw["seed"])
        t_draws = time.perf_counter() - t
        slo = kw["slo_s"]
        # the device engine after the draws: copies in, kernel, device
        # reductions, copy back, host p95 (it ends in copies to the host)
        t = time.perf_counter()
        fastsim._sweep_torch(A, S, counts, c, slo, device)
        t_engine = time.perf_counter() - t
        At = torch.from_numpy(np.ascontiguousarray(A.T)).to(device)
        St = torch.from_numpy(np.ascontiguousarray(S.T)).to(device)
        ct = torch.from_numpy(counts)
        n, b = At.shape
        repeats = 5 if n * b > 10_000_000 else 20
        ms = cuda_ms(torch, lambda: lindley_scan(At, St, ct, num_servers=c,
                                                 slo=slo), repeats)
        err, plain_ms = kernel_vs_plain(At, St, ct, c, slo)
        bound_ms, bound_by = k1_bound(counts, n, b, c, clock_hz)
        entry = {
            "name": "lindley_scan", "cell": name,
            "shape": f"N={n} x B={b}", "num_servers": c,
            "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
            "launches": launches, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None,
        }
        if c > 1:
            entry["also_replaces"] = KW_REPLACES
        entries.append(entry)
        print(f"{name}: N={n} B={b} c={c}: kernel {ms:.3f} ms, plain "
              f"{plain_ms:.1f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
              f"{bound_ms / ms * 100:.2f}% of bound, kernel == plain; "
              f"host draws {t_draws:.3f} s, device engine {t_engine:.3f} s")

    for name, cell in dag_out.cells.items():
        topo = cell.dag.topological_order()
        rates = list(cell.arrival_rates_qps)
        t = time.perf_counter()
        traces = dag_mod._pipeline_traces(rates, cell.duration_s,
                                          cell.replications, cell.seed)
        A, S, counts = dag_mod._pipeline_draws(
            cell.dag, topo, [tuple(r) for r in cell.rungs], rates, traces,
            seed=cell.seed)
        t_draws = time.perf_counter() - t
        t = time.perf_counter()
        At = torch.from_numpy(A).to(device).t().contiguous()
        St = torch.from_numpy(S).to(device).transpose(1, 2).contiguous()
        ct = torch.from_numpy(counts)
        sink_pos = list(topo).index(cell.dag.sink())
        calls = []
        sink = fastsim._pipeline_grid(
            At, St, ct, dag_mod._pipeline_topo_meta(cell.dag, topo),
            out_pos=(sink_pos,), record=calls)[sink_pos].t().cpu()
        t_engine = time.perf_counter() - t
        live = torch.arange(sink.shape[1])[None, :] < ct[:, None]
        check(bool(torch.isfinite(sink[live]).all()
                   and torch.isinf(sink[~live]).all()),
              f"{name}: sink completions not finite where live, or not "
              f"+inf past the counts")
        per_kernel = {}
        for kname, arr, svc, c in calls:
            n, b = arr.shape
            if kname == "chained_lindley_scan":
                fn = lambda: chained_lindley_scan(arr, svc, ct)
                ref, plain_ms = timed_plain(
                    lambda: chained_lindley_scan_ref(arr, svc, ct))
                bound_ms, bound_by = k2_bound(counts, n, b, svc.shape[0],
                                              clock_hz)
                what = {"stages": int(svc.shape[0])}
            else:
                fn = lambda: kw_chain(arr, svc, ct, num_servers=c)
                ref, plain_ms = timed_plain(
                    lambda: kw_chain_ref(arr, svc, ct, num_servers=c))
                bound_ms, bound_by = kw_chain_bound(counts, n, b, c,
                                                    clock_hz)
                what = {"num_servers": int(c)}
            out = fn()
            check(torch.equal(out, ref),
                  f"{name}: {kname} != plain version at {what}")
            ms = cuda_ms(torch, fn, 20)
            live = ref.isfinite()
            err = float((out[live] - ref[live]).abs().max()) \
                if bool(live.any()) else 0.0
            agg = per_kernel.setdefault(kname, {
                "name": kname, "cell": name,
                "route": "cuda",
                "source": K2_SOURCE if kname == "chained_lindley_scan"
                else K1_SOURCE,
                "replaces": K2_REPLACES if kname == "chained_lindley_scan"
                else KW_CHAIN_REPLACES,
                "launches": dag_out.launches[name][kname],
                "max_abs_err": 0.0, "ms": 0.0, "plain_ms": 0.0,
                "bound_ms": 0.0, "bound_by": bound_by, "library_ms": None,
                "calls": []})
            agg["max_abs_err"] = max(agg["max_abs_err"], err)
            agg["ms"] += ms
            agg["plain_ms"] += plain_ms
            agg["bound_ms"] += bound_ms
            if bound_by == "bytes":
                agg["bound_by"] = "bytes"
            agg["calls"].append(dict(shape=f"N={n} x B={b}", **what,
                                     ms=ms, plain_ms=plain_ms,
                                     bound_ms=bound_ms, bound_by=bound_by))
            print(f"{name}: {kname} N={n} B={b} {what}: kernel {ms:.4f} ms, "
                  f"plain {plain_ms:.1f} ms, bound {bound_ms:.5f} ms "
                  f"({bound_by}), {bound_ms / ms * 100:.2f}% of bound, "
                  f"kernel == plain")
        for agg in per_kernel.values():
            agg["shape"] = agg["calls"][0]["shape"]
            key = ("stages" if agg["name"] == "chained_lindley_scan"
                   else "num_servers")
            agg[key] = [call[key] for call in agg["calls"]]
            check(agg["launches"] == len(agg["calls"]),
                  f"{name}: {agg['name']} launched {agg['launches']} times "
                  f"in the pipeline path, {len(agg['calls'])} in the replay")
        entries.extend(per_kernel.values())
        print(f"{name}: host draws {t_draws:.3f} s, device engine "
              f"{t_engine:.3f} s")

    # -- 7. the serving path ---------------------------------------------------
    entries.extend(serve_phase(torch, counted))
    return {"kind": kind, "entries": entries}


def timed_once(torch, fn):
    """Output and host-clock ms of one call that ends in a synchronise."""
    torch.cuda.synchronize()
    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t) * 1e3


def prefill_decode_gap(torch, model, prompt):
    """Last-position logits of ``prefill(prompt)`` then ``decode_step(t)``
    (K5 over the cache K4's prefill left) against ``prefill(prompt + t)``
    (K4), t the greedy token: relative RMS and max abs of the difference,
    and the share of the batch whose greedy next token agrees."""
    logits0, state = model.prefill({"tokens": prompt},
                                   cache_len=prompt.shape[1] + 1)
    tok = torch.argmax(logits0, -1)
    l_dec, _ = model.decode_step(state, tok)
    l_pre, _ = model.prefill({"tokens": torch.cat([prompt, tok[:, None]], 1)})
    diff = l_dec.float() - l_pre.float()
    rel = float(diff.pow(2).mean().sqrt() / l_pre.float().pow(2).mean().sqrt())
    agree = float((l_dec.argmax(-1) == l_pre.argmax(-1)).float().mean())
    return rel, float(diff.abs().max()), agree


def serve_phase(torch, counted) -> list:
    """Phase 7: the serving path at full size, its checks, and one kernel
    entry for every (kernel, shape) the path launched."""
    import torch.nn.functional as F

    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_ref)
    from repro_torch.kernels.flash_attention import (attention_ref,
                                                     flash_attention)
    from repro_torch.kernels.rmsnorm import rmsnorm, rmsnorm_ref
    from repro_torch.launch import serve
    from repro_torch.models.model import Model
    from repro_torch.models.registry import get_config

    model_kernels = (rmsnorm, flash_attention, decode_attention)
    # warm-up at full width on a small batch: GEMM handles, kernel libraries
    base = get_config(SERVE_ARCH)
    serve.run(base, **dict(SERVE, batch=1, prompt_len=64, tokens=3))
    for k in counted + model_kernels:
        k.launches = 0
    for k in model_kernels:
        k.record = {}
    t = time.perf_counter()
    res = serve.run(base, **SERVE)                # device=None: the card
    t_serve = time.perf_counter() - t
    records = {k.__name__: k.record for k in model_kernels}
    totals = {k.__name__: k.launches for k in model_kernels}
    for k in model_kernels:
        k.record = None
    print(serve.report(res))
    print(f"serve path: {t_serve:.1f} s (weights drawn on the card "
          f"included), launches {totals}")

    cfg = res.config
    n_tok, batch, n_layers = SERVE["tokens"], SERVE["batch"], cfg.num_layers
    check(cfg.num_layers == 24 and cfg.d_model == 2048
          and cfg.num_heads == 16 and cfg.num_kv_heads == 8
          and cfg.head_dim == 128 and cfg.d_ff == 8192
          and cfg.vocab_size == 92544 and cfg.dtype == "bfloat16",
          "the serve phase did not run internlm2-1.8b's full config")
    third = n_tok // 3
    check(res.switches == [(third, "accurate", "fast", 10),
                           (2 * third, "fast", "accurate", 0)],
          f"switch log {res.switches} is not the reference schedule")
    check(res.active == (["accurate"] * third + ["fast"] * third
                         + ["accurate"] * (n_tok - 2 * third)),
          "the active rung does not follow the switch schedule")
    check(res.tokens.shape == (n_tok, batch)
          and bool(((res.tokens >= 0)
                    & (res.tokens < cfg.vocab_size)).all()),
          "decoded tokens have the wrong shape or lie outside the vocab")
    check(all(bool(torch.isfinite(l).all()) for l in res.logits)
          and all(bool(torch.isfinite(l).all())
                  for l in res.prefill_logits.values()),
          "a logit is not finite")
    norms = 2 * n_layers + 1
    expected = {
        "prefill/accurate": {"rmsnorm": norms, "flash_attention": n_layers,
                             "decode_attention": 0},
        "prefill/fast": {"rmsnorm": norms, "flash_attention": n_layers,
                         "decode_attention": 0},
        "decode": {"rmsnorm": norms * n_tok, "flash_attention": 0,
                   "decode_attention": n_layers * n_tok},
    }
    check(res.launches == expected,
          f"serve launches {res.launches}, expected {expected}")
    check(totals == {"rmsnorm": norms * (2 + n_tok),
                     "flash_attention": 2 * n_layers,
                     "decode_attention": n_layers * n_tok},
          f"serve launch totals {totals}")
    for name, rung in res.rungs.items():
        ms = res.decode_ms_per_token(name)
        print(f"serve {name}: prefill {res.prefill_s[name] * 1e3:.1f} ms, "
              f"decode {ms:.2f} ms/token, {batch * 1e3 / ms:.1f} tokens/s "
              f"(batch {batch}, window {rung.sliding_window or 'full'}, kv "
              f"{rung.kv_cache_dtype or rung.dtype})")

    entries = []

    def entry(name, source, replaces, key_desc, rec, out, ref, plain_ms,
              fn, lib_fn, nbytes, ops, flops):
        dtype = str(out.dtype).replace("torch.", "")
        tol = MODEL_TOL[dtype]
        err = float((out.float() - ref.float()).abs().max())
        excess = float(((out.float() - ref.float()).abs()
                        - tol * (1 + ref.float().abs())).max())
        check(torch.allclose(out.float(), ref.float(), rtol=tol, atol=tol),
              f"{name} {key_desc}: kernel differs from its plain version "
              f"beyond {tol} (max abs err {err:.4g}, worst excess over "
              f"the tolerance {excess:.4g})")
        ms = cuda_ms(torch, fn, 20)
        library_ms = cuda_ms(torch, lib_fn, 20)
        bound_ms, bound_by = bound(nbytes, ops, flops)
        entries.append({
            "name": name, "cell": "serve", "shape": key_desc,
            "dtype": dtype, "route": "cuda", "source": source,
            "replaces": replaces, "launches": rec["launches"],
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms})
        print(f"serve: {name} {key_desc} x{rec['launches']}: kernel "
              f"{ms:.4f} ms, plain {plain_ms:.2f} ms, library "
              f"{library_ms:.4f} ms, bound {bound_ms:.5f} ms ({bound_by}), "
              f"{bound_ms / ms * 100:.2f}% of bound, max abs err {err:.3g} "
              f"(tolerance {tol})")

    for key, rec in records["rmsnorm"].items():
        x, w, eps = rec["inputs"]
        d = x.shape[-1]
        rows = x.numel() // d
        out = rmsnorm(x, w, eps=eps)
        ref, plain_ms = timed_once(torch, lambda: rmsnorm_ref(x, w, eps=eps))
        entry("rmsnorm", K3_SOURCE, K3_REPLACES, f"x {tuple(x.shape)}", rec,
              out, ref, plain_ms, lambda: rmsnorm(x, w, eps=eps),
              lambda: F.rms_norm(x, (d,), w, eps),
              (2 * rows * d + d) * x.element_size(), 4 * rows * d,
              FP32_FLOPS)

    for key, rec in records["flash_attention"].items():
        q, k, v = rec["inputs"]
        causal, window = key[3], key[4]
        b, h, s, hd = q.shape
        pos = torch.arange(s, device=q.device)
        mask = torch.ones((s, s), dtype=torch.bool, device=q.device)
        if causal:
            mask &= pos[None, :] <= pos[:, None]
        if window > 0:
            mask &= pos[None, :] > pos[:, None] - window
        visible = int(mask.sum())
        out = flash_attention(q, k, v, causal=causal, window=window)
        ref, plain_ms = timed_once(torch, lambda: attention_ref(
            q, k, v, causal=causal, window=window))
        if window > 0:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=mask, enable_gqa=True)
        else:
            lib = lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, enable_gqa=True)
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        entry("flash_attention", K4_SOURCE, K4_REPLACES,
              f"q {tuple(q.shape)} kv {tuple(k.shape)} "
              f"{'causal' if causal else 'full'} window {window}", rec,
              out, ref, plain_ms,
              lambda: flash_attention(q, k, v, causal=causal, window=window),
              lib, nbytes, 4 * b * h * visible * hd, BF16_FLOPS)

    for key, rec in records["decode_attention"].items():
        q, k, v, length = rec["inputs"]
        b, h, hd = q.shape
        s, kv = k.shape[1], k.shape[2]
        n = min(int(length), s)
        out = decode_attention(q, k, v, length)
        ref, plain_ms = timed_once(
            torch, lambda: decode_attention_ref(q, k, v, length))
        valid = (torch.arange(s, device=q.device) < length)[None, None, None]
        lib = lambda: F.scaled_dot_product_attention(
            q[:, :, None], k.transpose(1, 2), v.transpose(1, 2),
            attn_mask=valid, enable_gqa=True)
        nbytes = (2 * b * n * kv * hd + 2 * b * h * hd) * q.element_size()
        entry("decode_attention", K5_SOURCE, K5_REPLACES,
              f"q {tuple(q.shape)} cache {tuple(k.shape)} length {n}", rec,
              out, ref, plain_ms,
              lambda: decode_attention(q, k, v, length), lib, nbytes,
              4 * b * h * n * hd, BF16_FLOPS)

    for name, rec_by in records.items():
        check(len(rec_by) > 0 and sum(r["launches"] for r in rec_by.values())
              == totals[name], f"{name}: recorded launches do not add up")

    # K4 against K5 through the model, on the accurate rung, in bf16 and in
    # an fp32 copy
    torch.backends.cuda.matmul.allow_tf32 = False      # fp32 GEMMs in fp32
    m32 = Model(dataclasses.replace(cfg, dtype="float32")).init(SERVE["seed"])
    for model, limit in ((res.models["accurate"], CONSISTENCY_REL_RMS),
                         (m32, CONSISTENCY_REL_RMS_FP32)):
        rel, max_abs, agree = prefill_decode_gap(torch, model, res.prompt)
        print(f"serve: {model.cfg.dtype} prefill + decode_step against "
              f"prefill of one more token: relative RMS {rel:.4g} (limit "
              f"{limit}), max abs {max_abs:.4g}, greedy tokens agree on "
              f"{agree * 100:.0f}% of the batch")
        check(rel <= limit, f"{model.cfg.dtype}: decode after prefill "
                            f"differs from prefill by {rel:.4g} relative RMS")
    return entries


def main() -> int:
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke: no src/repro_torch beside this script; run it "
              "from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA card", file=sys.stderr)
        return 2
    try:
        out = run(torch)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": out["entries"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": out["kind"],
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
