// RMSNorm over the rows of a (rows, D) matrix, for Hopper (sm_90a):
//
//   y[r, :] = x[r, :] * rsqrt(mean(x[r, :]^2) + eps) * w
//
// statistics in fp32, output in x's dtype (bf16 or fp32, a template
// parameter).
//
// Replaces the TPU kernel `rmsnorm` (repro/kernels/rmsnorm/kernel.py,
// body `_rmsnorm_kernel`), which tiles (block_rows, D) into VMEM and needs
// rows % block_rows == 0.  Here any row count and any D <= 16384 go.
//
// What bounds it.  Memory: the row is read once and written once, w is
// read by every row but stays in L1/L2, so the least time is
// (2 * rows * D + D) * sizeof(T) / 3.35 TB/s.  Two FLOPs a reduced element
// and two a written one are far below the tensor-free fp32 rate.
//
// Design.  One block per row.  Each thread loads its part of the row into
// registers (CHUNKS loads of VEC elements, 16 bytes a load when D and the
// row pointers allow it, neighbouring threads on neighbouring addresses),
// sums its squares in fp32, and the block reduces the sum through warp
// shuffles and one word of shared memory a warp.  The row is then scaled
// from the registers, so device memory sees one read and one write of it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxD = 16384;
constexpr int kMaxThreads = 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// VEC elements of T in one load: 16 bytes when VEC * sizeof(T) == 16
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC, int CHUNKS>
__global__ void rmsnorm_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ y,
                               int d, int64_t x_stride, int64_t y_stride,
                               float eps) {
  __shared__ float warp_sums[kMaxThreads / 32];
  const T* xr = x + (int64_t)blockIdx.x * x_stride;
  T* yr = y + (int64_t)blockIdx.x * y_stride;

  float vals[CHUNKS][VEC];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i = (threadIdx.x + c * blockDim.x) * VEC;
    if (i < d) {
      Pack<T, VEC> p = *reinterpret_cast<const Pack<T, VEC>*>(xr + i);
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        vals[c][e] = to_f(p.v[e]);
        ss += vals[c][e] * vals[c][e];
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    ss += __shfl_xor_sync(0xffffffffu, ss, off);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) warp_sums[warp] = ss;
  __syncthreads();
  if (warp == 0) {
    const int nwarps = blockDim.x >> 5;
    float t = lane < nwarps ? warp_sums[lane] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      t += __shfl_xor_sync(0xffffffffu, t, off);
    if (lane == 0) warp_sums[0] = t;
  }
  __syncthreads();
  const float inv = rsqrtf(warp_sums[0] / (float)d + eps);

#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int i = (threadIdx.x + c * blockDim.x) * VEC;
    if (i < d) {
      Pack<T, VEC> wp = *reinterpret_cast<const Pack<T, VEC>*>(w + i);
      Pack<T, VEC> out;
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        out.v[e] = from_f<T>(vals[c][e] * inv * to_f(wp.v[e]));
      *reinterpret_cast<Pack<T, VEC>*>(yr + i) = out;
    }
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const T* x, const T* w, T* y, int64_t rows, int d,
                       int64_t xs, int64_t ys, float eps,
                       cudaStream_t stream) {
  const int packs = d / VEC;
  int threads = packs < kMaxThreads ? ((packs + 31) / 32) * 32 : kMaxThreads;
  const int chunks = (packs + threads - 1) / threads;
  const dim3 grid((unsigned)rows);
  switch (chunks) {
    case 1: rmsnorm_kernel<T, VEC, 1><<<grid, threads, 0, stream>>>(x, w, y, d, xs, ys, eps); break;
    case 2: rmsnorm_kernel<T, VEC, 2><<<grid, threads, 0, stream>>>(x, w, y, d, xs, ys, eps); break;
    case 3:
    case 4: rmsnorm_kernel<T, VEC, 4><<<grid, threads, 0, stream>>>(x, w, y, d, xs, ys, eps); break;
    case 5: case 6: case 7:
    case 8: rmsnorm_kernel<T, VEC, 8><<<grid, threads, 0, stream>>>(x, w, y, d, xs, ys, eps); break;
    default:
      if (chunks > 16) return cudaErrorInvalidValue;
      rmsnorm_kernel<T, VEC, 16><<<grid, threads, 0, stream>>>(x, w, y, d, xs, ys, eps);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const void* w, void* y, int64_t rows,
                   int d, int64_t xs, int64_t ys, float eps,
                   cudaStream_t stream) {
  constexpr int kVec = 16 / sizeof(T);
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* yp = static_cast<T*>(y);
  const bool aligned =
      d % kVec == 0 && xs % kVec == 0 && ys % kVec == 0 &&
      ((uintptr_t)x | (uintptr_t)w | (uintptr_t)y) % 16 == 0;
  if (aligned) return launch_vec<T, kVec>(xp, wp, yp, rows, d, xs, ys, eps, stream);
  return launch_vec<T, 1>(xp, wp, yp, rows, d, xs, ys, eps, stream);
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  x and y are (rows, d) with row strides xs and
// ys (elements) and unit column stride; w is (d,).
extern "C" int rmsnorm_launch(int device, int dtype, const void* x,
                              const void* w, void* y, int64_t rows, int d,
                              int64_t xs, int64_t ys, float eps,
                              void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || rows > 2147483647LL)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(x, w, y, rows, d, xs, ys, eps, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(x, w, y, rows, d, xs, ys, eps, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* rmsnorm_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
