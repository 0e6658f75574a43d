// Prefill attention (flash attention forward) with causal and
// sliding-window masks and grouped-query heads, for Hopper (sm_90a).  For
// batch row b, query head h and position i:
//
//   o[b, h, i, :] = softmax_j(q[b, h, i, :] . k[b, h // G, j, :] * scale)
//                   @ v[b, h // G, :, :]
//
// over the visible j (j <= i when causal; j > i - window when window > 0),
// with fp32 scores, softmax and sums, output in q's dtype (bf16 or fp32, a
// template parameter).  A row with no visible j comes out zero.
//
// Replaces the TPU kernel `flash_attention` (repro/kernels/
// flash_attention/kernel.py, body `_flash_kernel`).  That kernel walks
// every kv block as a sequential grid axis, masking the ones outside the
// window, and needs S % block == 0; q, k and v come in (B, H, S, hd).
// Here a block's loop runs only from the window's first kv block to the
// diagonal block, any S goes, and q, k, v and o are addressed through
// strides, so the model's (B, S, H, hd) projections are read in place.
//
// What bounds it.  The products: 4 * B * H * (visible pairs) * hd FLOPs.
// On the tensor cores (989 TFLOP/s bf16) that is ~0.14 ms for the serve
// prefill (B 8, H 16, S 2048, hd 128, causal), against ~0.06 ms for the
// bytes of q, k, v and o at 3.35 TB/s, so the operations bound it.  This
// version multiplies on the fp32 cores (67 TFLOP/s), from shared memory,
// so it runs far from that bound.  Moving the products to the tensor cores
// (wgmma, TMA-fed tiles) is a later PR's work, and it has to keep the
// scores as accurate as fp32 FMAs: on the serving path the scores are
// ~2000 in size and near-ties turn their rounding into output error.
//
// Design.  One block of 256 threads per (query block of kBQ rows, head,
// batch row).  The query tile is staged once in shared memory as fp32;
// for each visible kv block of kBK rows the k and v tiles are staged, each
// thread computes a 2 x 4 tile of scores (the mask applied there, masked
// entries -inf), each warp runs the online-softmax update of 8 rows (one
// lane a column: row max and sum by shuffles; masked entries give p = 0
// explicitly, so a row whose visited entries are all masked keeps l = 0
// and never takes exp(0) = 1 from the masking constant), and each thread
// rescales and accumulates a 4 x (hd / 16) tile of the output in
// registers.  Rows pad to hd + 1 floats so the score loop's shared-memory
// reads do not collide on banks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;
constexpr int kBK = 32;
constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

struct Args {
  const void* q; const void* k; const void* v; void* o;
  int s, g, causal, window;
  int64_t q_sb, q_sh, q_ss;     // (B, H, S, hd), unit stride on hd
  int64_t k_sb, k_sh, k_ss;     // (B, KV, S, hd)
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;     // (B, H, S, hd)
  float scale;
};

template <int HD>
constexpr size_t smem_floats() {
  return (size_t)kBQ * (HD + 1) + kBK * (HD + 1) + kBK * HD +
         kBQ * (kBK + 1) + 3 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_kernel(Args a) {
  constexpr int CW = HD / 16;                  // output columns a thread
  extern __shared__ float smem[];
  float* Qs = smem;                            // [kBQ][HD + 1]
  float* Ks = Qs + kBQ * (HD + 1);             // [kBK][HD + 1]
  float* Vs = Ks + kBK * (HD + 1);             // [kBK][HD]
  float* Ps = Vs + kBK * HD;                   // [kBQ][kBK + 1]
  float* row_m = Ps + kBQ * (kBK + 1);
  float* row_l = row_m + kBQ;
  float* row_alpha = row_l + kBQ;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / a.g, S = a.s;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  for (int e = tid; e < kBQ * HD; e += kThreads) {
    const int r = e / HD, d = e % HD, row = q0 + r;
    Qs[r * (HD + 1) + d] = row < S ? to_f(q[row * a.q_ss + d]) : 0.f;
  }
  if (tid < kBQ) {
    row_m[tid] = -INFINITY;
    row_l[tid] = 0.f;
  }

  float acc[4][CW];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[i][j] = 0.f;

  // the kv range any row of this block can see
  const int q_last = min(S, q0 + kBQ) - 1;
  const int lo = a.window > 0 ? max(0, q0 - a.window + 1) : 0;
  const int hi = a.causal ? q_last + 1 : S;

  const int srg = tid >> 3, scg = tid & 7;     // score tile: rows srg, srg + 32
  const int org = tid >> 4, ocg = tid & 15;    // output tile: rows org + 16 i

  for (int k0 = (lo / kBK) * kBK; k0 < hi; k0 += kBK) {
    __syncthreads();                           // last block's tiles are done
    for (int e = tid; e < kBK * HD; e += kThreads) {
      const int r = e / HD, d = e % HD, row = k0 + r;
      Ks[r * (HD + 1) + d] = row < S ? to_f(k[row * a.k_ss + d]) : 0.f;
      Vs[r * HD + d] = row < S ? to_f(v[row * a.v_ss + d]) : 0.f;
    }
    __syncthreads();

    float sc[2][4];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      const float qa = Qs[srg * (HD + 1) + d];
      const float qb = Qs[(srg + 32) * (HD + 1) + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float kk = Ks[(scg + 8 * j) * (HD + 1) + d];
        sc[0][j] += qa * kk;
        sc[1][j] += qb * kk;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = srg + 32 * i, qpos = q0 + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = scg + 8 * j, kpos = k0 + c;
        const bool ok = kpos < S && (!a.causal || kpos <= qpos) &&
                        (a.window <= 0 || kpos > qpos - a.window);
        Ps[r * (kBK + 1) + c] = ok ? sc[i][j] * a.scale : -INFINITY;
      }
    }
    __syncthreads();

    // online softmax: warp w owns rows 8w .. 8w + 7, lane = column
#pragma unroll
    for (int rr = 0; rr < kBQ / 8; ++rr) {
      const int r = warp * (kBQ / 8) + rr;
      const float x = Ps[r * (kBK + 1) + lane];
      float mx = x;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_old = row_m[r];
      const float m_new = fmaxf(m_old, mx);
      const float p = x == -INFINITY ? 0.f : expf(x - m_new);
      float sum = p;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      Ps[r * (kBK + 1) + lane] = p;
      if (lane == 0) {
        const float alpha = m_old == m_new ? 1.f : expf(m_old - m_new);
        row_l[r] = row_l[r] * alpha + sum;
        row_m[r] = m_new;
        row_alpha[r] = alpha;
      }
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float al = row_alpha[org + 16 * i];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[i][j] *= al;
    }
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float vv[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) vv[j] = Vs[kk * HD + ocg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = Ps[(org + 16 * i) * (kBK + 1) + kk];
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[i][j] += p * vv[j];
      }
    }
  }
  __syncthreads();

  T* o = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = org + 16 * i, row = q0 + r;
    if (row >= S) continue;
    const float l = row_l[r];
    const float inv = 1.f / (l == 0.f ? 1.f : l);
#pragma unroll
    for (int j = 0; j < CW; ++j)
      o[row * a.o_ss + ocg + 16 * j] = from_f<T>(acc[i][j] * inv);
  }
}

template <typename T, int HD>
cudaError_t launch_hd(const Args& a, int h, int b, cudaStream_t stream) {
  const size_t smem = smem_floats<HD>() * sizeof(float);
  auto kern = flash_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  const dim3 grid((a.s + kBQ - 1) / kBQ, h, b);
  kern<<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const Args& a, int hd, int h, int b, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch_hd<T, 32>(a, h, b, stream);
    case 64: return launch_hd<T, 64>(a, h, b, stream);
    case 128: return launch_hd<T, 128>(a, h, b, stream);
    case 256: return launch_hd<T, 256>(a, h, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  q, o: (b, h, s, hd); k, v: (b, h / g, s, hd);
// strides in elements, unit stride on hd.  causal: 0 or 1; window <= 0
// means none.
extern "C" int flash_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    void* o, int b, int h, int s, int g, int hd, int causal, int window,
    int64_t q_sb, int64_t q_sh, int64_t q_ss, int64_t k_sb, int64_t k_sh,
    int64_t k_ss, int64_t v_sb, int64_t v_sh, int64_t v_ss, int64_t o_sb,
    int64_t o_sh, int64_t o_ss, float scale, void* stream) {
  if (b <= 0 || h <= 0 || s <= 0 || g <= 0 || h % g || b > 65535 ||
      h > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, k, v, o, s, g, causal, window, q_sb, q_sh, q_ss, k_sb, k_sh,
         k_ss, v_sb, v_sh, v_ss, o_sb, o_sh, o_ss, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, hd, h, b, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, hd, h, b, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
