// Chained Lindley scan: per-stage completion times of a tandem of c = 1
// FIFO stages over a batch of independent scenario lanes, in fp64, for
// Hopper (sm_90a).  Stage j+1's arrival is stage j's fresh completion.
//
// Replaces the TPU kernel `chained_lindley_scan` (repro/kernels/
// lindley_scan/kernel.py, body `_chained_lindley_kernel`), in the op order
// of the JAX package's `_jax_chained_seq` (repro/serving/fastsim.py), which
// is the numpy reference's `P = cumsum(S)`, `M = cummax(A - (P - S))`,
// `C = P + M` replayed one row at a time.  For lane b, row i < counts[b]
// and stage j, with carries p_j = 0 and m_j = -inf at the start and `arr`
// the row's external arrival:
//
//   p_j = p_j + s;  t = arr - (p_j - s);  m_j = max(m_j, t);
//   comp = p_j + m_j;  C[j, i, b] = comp;  arr = comp
//
// Rows at or past counts[b] come out +inf at every stage, so padded slots
// stay trailing through the sorts and joins that follow.
//
// What bounds it.  A lane is a chain: the carries make row i wait for row
// i-1 (one max for m_j, one add for p_j), and a row passes down the stages
// through a sub, a max and an add each.  The bytes are 8 per slot of A
// plus 16 per slot and stage (s read, comp written).  With the pipeline
// sweep's few lanes (B 84..160) the chain bounds it, and the lanes fill
// only a few SMs.
//
// Design.  The TPU kernel walked time as a sequential grid axis, carrying
// the J completions in VMEM.  Hopper blocks run in no order, so here one
// thread owns one lane and loops over time itself, with the 2J carries in
// registers (J, the number of stages, is a template parameter 1..16, so
// the stage loop unrolls; longer runs are split by the wrapper into
// launches of at most 16 stages, which stays bit-exact because a stage's
// input is the stored completion of the stage before).  The (N, B) and
// (J, N, B) layouts put neighbouring lanes on neighbouring addresses, so a
// warp's loads of one row coalesce.  Loads of a tile of rows are issued
// together before the tile's steps.  Build with --fmad=false: the step has
// no multiply, and the flag keeps any contraction from breaking
// bit-equality with the plain version.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxStages = 16;

template <int J>
__global__ void __launch_bounds__(kThreads)
chained_kernel(const double* __restrict__ arrivals,
               const double* __restrict__ services,
               const int64_t* __restrict__ counts, int64_t n, int64_t b,
               double* __restrict__ comps) {
  // rows loaded ahead per tile: J * kTile services stay in registers
  constexpr int kTile = J >= 8 ? 2 : (J >= 4 ? 4 : 8);
  const int64_t lane = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (lane >= b) return;
  int64_t cnt = counts[lane];
  cnt = cnt < 0 ? 0 : (cnt > n ? n : cnt);
  const int64_t plane = n * b;   // stride between stages

  double p[J], m[J];
#pragma unroll
  for (int j = 0; j < J; ++j) {
    p[j] = 0.0;
    m[j] = -CUDART_INF;
  }

  for (int64_t i0 = 0; i0 < cnt; i0 += kTile) {
    double a[kTile], s[kTile][J];
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int64_t i = i0 + t;
      a[t] = 0.0;
#pragma unroll
      for (int j = 0; j < J; ++j) s[t][j] = 0.0;
      if (i < cnt) {
        a[t] = arrivals[i * b + lane];
#pragma unroll
        for (int j = 0; j < J; ++j) s[t][j] = services[j * plane + i * b + lane];
      }
    }
#pragma unroll
    for (int t = 0; t < kTile; ++t) {
      const int64_t i = i0 + t;
      if (i < cnt) {
        double arr = a[t];
#pragma unroll
        for (int j = 0; j < J; ++j) {
          const double sv = s[t][j];
          const double pj = p[j] + sv;
          const double tj = arr - (pj - sv);
          const double mj = fmax(m[j], tj);
          const double comp = pj + mj;
          p[j] = pj;
          m[j] = mj;
          comps[j * plane + i * b + lane] = comp;
          arr = comp;
        }
      }
    }
  }
  for (int64_t i = cnt; i < n; ++i) {
#pragma unroll
    for (int j = 0; j < J; ++j) comps[j * plane + i * b + lane] = CUDART_INF;
  }
}

struct Args {
  const double* arrivals;
  const double* services;
  const int64_t* counts;
  int64_t n, b;
  double* comps;
};

template <int J>
cudaError_t launch(int stages, const Args& x, cudaStream_t stream) {
  if (stages != J) {
    if constexpr (J < kMaxStages) return launch<J + 1>(stages, x, stream);
    return cudaErrorInvalidValue;
  }
  const unsigned grid = (unsigned)((x.b + kThreads - 1) / kThreads);
  chained_kernel<J><<<grid, kThreads, 0, stream>>>(
      x.arrivals, x.services, x.counts, x.n, x.b, x.comps);
  return cudaGetLastError();
}

}  // namespace

// arrivals (N, B), services (J, N, B), counts (B,) int64, comps (J, N, B);
// all on `device`, contiguous.  Returns a cudaError_t code (0 on success).
extern "C" int chained_lindley_f64(int device, const void* arrivals,
                                   const void* services, const void* counts,
                                   int64_t n, int64_t b, int stages,
                                   void* comps, void* stream) {
  if (stages < 1 || stages > kMaxStages || n < 0 || b < 1)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const Args x{(const double*)arrivals, (const double*)services,
               (const int64_t*)counts, n, b, (double*)comps};
  return (int)launch<1>(stages, x, (cudaStream_t)stream);
}

extern "C" const char* chained_lindley_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
