// Lindley / Kiefer-Wolfowitz sweep: the FIFO M/G/c recursion over a batch
// of independent scenario lanes, in fp64, for Hopper (sm_90a).
//
// Replaces the TPU kernel `lindley_scan` (repro/kernels/lindley_scan/
// kernel.py, body `_lindley_kernel`, c = 1) and, as its c > 1 mode, the
// Kiefer-Wolfowitz comparator scan `_jax_kw` (repro/serving/fastsim.py),
// which the JAX package runs as a `lax.scan`.
//
// For lane b and row i < counts[b], with F the ascending vector of the c
// servers' free times (all 0 at the start):
//
//   st = max(a, F[0]);  ct = st + s;  wait = st - a;  lat = ct - a
//   c = 1:  F[0] = ct
//   c > 1:  cur = ct;  for j = 1..c-1: F[j-1] = min(F[j], cur),
//                                       cur    = max(F[j], cur);
//           F[c-1] = cur
//
// Rows at or past counts[b] come out 0.  The same pass sums waits and
// latencies per lane in time order and counts lat <= slo.
//
// What bounds it.  Each row of a lane depends on the row before it, so a
// lane is a chain of n dependent steps (max then add, plus one min for
// c > 1); the bytes are 32 per slot (a, s read; wait, lat written).  With
// many lanes the card is bound by those bytes; with few lanes (the 32 h
// trace has 6) it is bound by the chain, and lanes cannot fill 132 SMs.
//
// Design.  The TPU kernel walked time as a sequential grid axis carrying
// the state in VMEM; Hopper blocks run in no order, so here one thread owns
// one lane and loops over time itself, with F in registers (c is a
// template parameter, 1..32, so the comparator chain unrolls).  The (N, B)
// layout puts neighbouring lanes on neighbouring addresses, so a warp's
// loads of one row coalesce.  Loads of kTile rows are issued together
// before the tile's steps, so one memory latency is paid per tile rather
// than per row.  Build with --fmad=false: the step has no multiply, and the
// flag keeps any contraction from breaking bit-equality with the plain
// version.  A time-parallel max-plus scan for narrow batches is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kTile = 16;
constexpr int kMaxServers = 32;

template <int C>
__global__ void __launch_bounds__(kThreads)
lindley_kernel(const double* __restrict__ arrivals,
               const double* __restrict__ services,
               const int64_t* __restrict__ counts, double slo, int64_t n,
               int64_t b, double* __restrict__ waits,
               double* __restrict__ lats, double* __restrict__ wait_sum,
               double* __restrict__ lat_sum, int64_t* __restrict__ ok) {
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= b) return;
  int64_t cnt = counts[lane];
  cnt = cnt < 0 ? 0 : (cnt > n ? n : cnt);

  double F[C];
#pragma unroll
  for (int j = 0; j < C; ++j) F[j] = 0.0;
  double wsum = 0.0, lsum = 0.0;
  int64_t hits = 0;

  for (int64_t i0 = 0; i0 < cnt; i0 += kTile) {
    double a[kTile], s[kTile];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int64_t i = i0 + t;
      a[t] = 0.0;
      s[t] = 0.0;
      if (i < cnt) {
        a[t] = arrivals[i * b + lane];
        s[t] = services[i * b + lane];
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int64_t i = i0 + t;
      if (i < cnt) {
        const double st = fmax(a[t], F[0]);
        const double ct = st + s[t];
        if (C == 1) {
          F[0] = ct;
        } else {
          double cur = ct;
#pragma unroll
          for (int j = 1; j < C; ++j) {
            F[j - 1] = fmin(F[j], cur);
            cur = fmax(F[j], cur);
          }
          F[C - 1] = cur;
        }
        const double w = st - a[t];
        const double l = ct - a[t];
        waits[i * b + lane] = w;
        lats[i * b + lane] = l;
        wsum += w;
        lsum += l;
        hits += (l <= slo) ? 1 : 0;
      }
    }
  }
  for (int64_t i = cnt; i < n; ++i) {
    waits[i * b + lane] = 0.0;
    lats[i * b + lane] = 0.0;
  }
  wait_sum[lane] = wsum;
  lat_sum[lane] = lsum;
  ok[lane] = hits;
}

struct Args {
  const double* arrivals;
  const double* services;
  const int64_t* counts;
  double slo;
  int64_t n, b;
  double *waits, *lats, *wait_sum, *lat_sum;
  int64_t* ok;
};

template <int C>
cudaError_t launch(int c, const Args& x, cudaStream_t stream) {
  if (c != C) {
    if constexpr (C < kMaxServers) return launch<C + 1>(c, x, stream);
    return cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((x.b + kThreads - 1) / kThreads);
  lindley_kernel<C><<<grid, kThreads, 0, stream>>>(
      x.arrivals, x.services, x.counts, x.slo, x.n, x.b, x.waits, x.lats,
      x.wait_sum, x.lat_sum, x.ok);
  return cudaGetLastError();
}

}  // namespace

extern "C" int lindley_scan_f64(int device, const void* arrivals,
                                const void* services, const void* counts,
                                double slo, int64_t n, int64_t b, int c,
                                void* waits, void* lats, void* wait_sum,
                                void* lat_sum, void* ok, void* stream) {
  if (c < 1 || c > kMaxServers || n < 0 || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args x{(const double*)arrivals, (const double*)services,
               (const int64_t*)counts, slo, n, b, (double*)waits,
               (double*)lats, (double*)wait_sum, (double*)lat_sum,
               (int64_t*)ok};
  return (int)launch<1>(c, x, (cudaStream_t)stream);
}

extern "C" const char* lindley_scan_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
