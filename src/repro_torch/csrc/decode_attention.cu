// One-token GQA decode attention over a ring KV cache, for Hopper
// (sm_90a).  For batch row b and query head h = j * G + g of kv group j:
//
//   o[b, h, :] = softmax_s(q[b, h, :] . k[b, s, j, :] * scale) @ v[b, :, j, :]
//
// over the slots s < length (a () int32 on the device), with fp32 scores,
// softmax and sums, output in q's dtype (bf16 or fp32, a template
// parameter).  With length <= 0 every slot gets the masking constant
// -1e30, as in the reference, and the output is the mean of v.
//
// Replaces the TPU kernel `decode_attention` (repro/kernels/
// decode_attention/kernel.py, body `_decode_kernel`), whose wrapper copies
// the cache to (B, KV, S, hd) with `swapaxes` and needs S % block_k == 0.
// Here the cache is read in place in its (B, S, KV, hd) layout through
// strides, any S goes, and `length` is read on the device, so the launch
// never waits for the host.
//
// What bounds it.  Memory: the `length` valid k and v slots of every
// (b, kv head) are read once, with q and o; the least time is
// (2 * B * min(length, S) * KV * hd + 2 * B * H * hd) * sizeof(T)
// / 3.35 TB/s.  Two FLOPs a cached element and query head are far below
// any compute rate.
//
// Design.  One block per (kv head, batch row) with kWarps warps.  The G
// query heads of the group sit in every warp's registers (lane l holds
// elements l, l + 32, ...), so each k/v slot a warp loads serves all G
// heads: warp w takes slots w, w + kWarps, ..., loads kSlots of them ahead
// (coalesced: a warp reads a slot's hd contiguous elements), reduces each
// dot product with shuffles and keeps a running max, sum and accumulator
// per head in fp32 (online softmax).  The warps' partial results meet in
// shared memory and are merged with the usual rescaling.  A later version
// would split the cache across more blocks (B * KV blocks fill only part
// of the card) and fuse the int8 dequantization.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kSlots = 4;        // slots a warp loads ahead
constexpr float kNegInf = -1.0e30f;

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
  const void* q; const void* k; const void* v; const int32_t* length;
  void* o;
  int s, g;
  int64_t q_sb, q_sh;           // q (B, H, hd)
  int64_t k_sb, k_ss, k_sh;     // k (B, S, KV, hd)
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_sh;           // o (B, H, hd)
  float scale;
};

// HDL = hd / 32 elements a lane; MAXG >= G heads a group
template <typename T, int HDL, int MAXG>
__global__ void __launch_bounds__(kWarps * 32)
decode_kernel(Args a) {
  extern __shared__ float smem[];
  constexpr int HD = HDL * 32;
  const int j = blockIdx.x, b = blockIdx.y, G = a.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const T* q = static_cast<const T*>(a.q) + b * a.q_sb + (int64_t)j * G * a.q_sh;
  const T* k = static_cast<const T*>(a.k) + b * a.k_sb + j * a.k_sh;
  const T* v = static_cast<const T*>(a.v) + b * a.v_sb + j * a.v_sh;

  float qv[MAXG][HDL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g)
#pragma unroll
    for (int e = 0; e < HDL; ++e)
      qv[g][e] = g < G ? to_f(q[g * a.q_sh + lane + 32 * e]) : 0.f;

  const int len = *a.length;
  const bool none = len <= 0;               // nothing valid: all masked
  const int n = none ? a.s : (len < a.s ? len : a.s);

  float m[MAXG], l[MAXG], acc[MAXG][HDL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = -INFINITY;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < HDL; ++e) acc[g][e] = 0.f;
  }

  for (int s0 = warp; s0 < n; s0 += kWarps * kSlots) {
    float kf[kSlots][HDL], vf[kSlots][HDL];
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int s = s0 + t * kWarps;
#pragma unroll
      for (int e = 0; e < HDL; ++e) {
        kf[t][e] = s < n ? to_f(k[s * a.k_ss + lane + 32 * e]) : 0.f;
        vf[t][e] = s < n ? to_f(v[s * a.v_ss + lane + 32 * e]) : 0.f;
      }
    }
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      if (s0 + t * kWarps >= n) break;
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        float dot = 0.f;
#pragma unroll
        for (int e = 0; e < HDL; ++e) dot += qv[g][e] * kf[t][e];
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          dot += __shfl_xor_sync(0xffffffffu, dot, off);
        const float score = none ? kNegInf : dot * a.scale;
        const float m_new = fmaxf(m[g], score);
        const float alpha = expf(m[g] - m_new);
        const float p = expf(score - m_new);
        l[g] = l[g] * alpha + p;
#pragma unroll
        for (int e = 0; e < HDL; ++e) acc[g][e] = acc[g][e] * alpha + p * vf[t][e];
        m[g] = m_new;
      }
    }
  }

  // merge the warps: smem holds m, l (kWarps x G each) then acc
  // (kWarps x G x HD)
  float* sm_m = smem;
  float* sm_l = smem + kWarps * G;
  float* sm_acc = smem + 2 * kWarps * G;
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      sm_m[warp * G + g] = m[g];
      sm_l[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < HDL; ++e)
      sm_acc[(warp * G + g) * HD + lane + 32 * e] = acc[g][e];
  }
  __syncthreads();
  T* o = static_cast<T*>(a.o) + b * a.o_sb + (int64_t)j * G * a.o_sh;
  for (int idx = threadIdx.x; idx < G * HD; idx += kWarps * 32) {
    const int g = idx / HD, d = idx - g * HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w * G + g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * G + g];
      const float f = mw == -INFINITY ? 0.f : expf(mw - mx);
      lsum += sm_l[w * G + g] * f;
      out += sm_acc[(w * G + g) * HD + d] * f;
    }
    o[g * a.o_sh + d] = from_f<T>(out / (lsum == 0.f ? 1.f : lsum));
  }
}

template <typename T, int HDL, int MAXG>
cudaError_t launch3(const Args& a, int kv, int b, cudaStream_t stream) {
  if constexpr (HDL * MAXG > 64) {
    return cudaErrorInvalidValue;
  } else {
    const size_t smem = (size_t)kWarps * a.g * (2 + HDL * 32) * sizeof(float);
    auto kern = decode_kernel<T, HDL, MAXG>;
    if (smem > 48 * 1024) {
      cudaError_t err = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return err;
    }
    kern<<<dim3(kv, b), kWarps * 32, smem, stream>>>(a);
    return cudaGetLastError();
  }
}

template <typename T, int HDL>
cudaError_t launch2(const Args& a, int kv, int b, cudaStream_t stream) {
  if (a.g <= 2) return launch3<T, HDL, 2>(a, kv, b, stream);
  if (a.g <= 8) return launch3<T, HDL, 8>(a, kv, b, stream);
  if (a.g <= 16) return launch3<T, HDL, 16>(a, kv, b, stream);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t launch(const Args& a, int hd, int kv, int b, cudaStream_t stream) {
  switch (hd) {
    case 32: return launch2<T, 1>(a, kv, b, stream);
    case 64: return launch2<T, 2>(a, kv, b, stream);
    case 128: return launch2<T, 4>(a, kv, b, stream);
    case 256: return launch2<T, 8>(a, kv, b, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = fp32, 1 = bf16.  q, o: (b, kv * g, hd) with strides (q_sb,
// q_sh, 1) and (o_sb, o_sh, 1); k, v: (b, s, kv, hd) with strides (sb, ss,
// sh, 1); length: one int32 on the device.  Strides in elements.
extern "C" int decode_attention_launch(
    int device, int dtype, const void* q, const void* k, const void* v,
    const void* length, void* o, int b, int s, int kv, int g, int hd,
    int64_t q_sb, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_sh,
    float scale, void* stream) {
  if (b <= 0 || s <= 0 || kv <= 0 || g <= 0 || b > 65535)
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Args a{q, k, v, static_cast<const int32_t*>(length), o, s, g,
         q_sb, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, scale};
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return (int)launch<float>(a, hd, kv, b, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(a, hd, kv, b, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
