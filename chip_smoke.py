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
5. each kernel again at every main-path shape: timed, and held against its
   plain version on the same inputs;
6. one JSON line of kernel numbers, then the result line.

Any failure exits nonzero and prints no result line; so does a host
without a card, and a directory that holds this script but not the repo.
"""

from __future__ import annotations

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

    from repro_torch.core.planner import Planner
    from repro_torch.kernels import build
    from repro_torch.kernels.lindley_scan import lindley_scan, lindley_scan_ref
    from repro_torch.quickstart import (SLO_S as QS_SLO, make_profiler,
                                        search, spike_arrivals, spike_run)
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

    lindley_scan.launches = 0
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

    # -- 5. every main-path shape: timed, held against the plain version ------
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
    return {"kind": kind, "entries": entries}


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
