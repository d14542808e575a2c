// Factorization-machine second-order term for Hopper (sm_90a), forward and
// backward.
//
// Replaces the TPU kernel recsys_tpu/ops/pallas_fm.py: _fm_kernel (behind
// fused_fm_interaction). For field embeddings v (B, F, K), contiguous, in
// fp32, bf16 or fp16, with all arithmetic in fp32:
//
//   forward   out[b]     = 0.5 * sum_k ((sum_f v[b,f,k])^2 - sum_f v[b,f,k]^2)
//   backward  dv[b,f,k]  = g[b] * (s[b,k] - v[b,f,k]),   s[b,k] = sum_f v[b,f,k]
//
// The TPU kernel had no backward (its trainer differentiated the plain
// form); a kernel in a trained model's forward needs one, so it is written
// here. What is kept from the TPU kernel is what stays out of device memory:
// neither the (B, K) sums nor the squared (B, F, K) array is ever stored.
// What is not kept is its tiling: it padded B to 128-row tiles for the
// (8, 128) vector layout; here the ragged edge is a bounds test.
//
// Bound on this card: device-memory bytes. The forward reads B*F*K values
// and writes 4*B bytes for about 3*B*F*K operations, under one operation a
// byte against the ~20 a byte the fp32 pipes could do; the backward reads v
// and g and writes dv. So the design is about bytes only:
//   * One warp per row. A row is F*K neighbouring values (1280 B at F = 20,
//     K = 16, fp32). When K divides 32 the warp covers 32/K fields at a time,
//     so every load is 32 neighbouring values (one 128-byte line in fp32),
//     lane l always meets the same k = l % K, and keeps its own partial
//     sum_f v and sum_f v^2 in registers. A butterfly over the lanes that
//     share a k finishes s[b,k]; a second one over the warp finishes the row.
//     Other K (not a divisor of 32) take the same loop with min(K, 32) lanes
//     over k and one field at a time: right, not tuned.
//   * The loads of a row do not depend on each other and are unrolled, so a
//     warp has several lines in flight; 8 warps a block and 8 blocks an SM
//     keep enough bytes in flight to cover the memory latency.
//   * v is read once from device memory in both kernels: the backward's
//     second pass over the row (to write dv) finds it in L1/L2.
//   * Sums are taken in a fixed order with no atomics: two calls give the
//     same bits.
//   * Offsets are computed in 64 bits.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as a tensor cast does
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half(x);
}

// How a warp lies over one row: `lanes_k` lanes side by side over k, and
// `groups` such runs side by side over fields. Lane l works on k = k0 + l %
// lanes_k for k0 = 0, lanes_k, ... and on the fields g, g + groups, ... with
// g = l / lanes_k; lanes with g >= groups have no work.
struct WarpLayout {
  int lanes_k, groups, kl, g;
  bool active;
};

__device__ __forceinline__ WarpLayout warp_layout(int K, int lane) {
  WarpLayout w;
  const bool packed = K <= 32 && 32 % K == 0;
  w.lanes_k = packed ? K : min(K, 32);
  w.groups = packed ? 32 / K : 1;
  w.kl = lane % w.lanes_k;
  w.g = lane / w.lanes_k;
  w.active = w.g < w.groups;
  return w;
}

// s[b,k] for this lane's k: the lane's own fields, then (when several field
// groups share the warp) a butterfly over the lanes with the same k. Every
// lane of the warp must call it. `q` receives the lane's own sum of squares.
template <typename T>
__device__ __forceinline__ float field_sum(const T* __restrict__ row, const WarpLayout& w,
                                           int k, int F, int K, float& q) {
  float s = 0.f;
  q = 0.f;
  if (w.active && k < K) {
#pragma unroll 4
    for (int f = w.g; f < F; f += w.groups) {
      const float x = to_f32(row[(int64_t)f * K + k]);
      s += x;
      q = fmaf(x, x, q);
    }
  }
  if (w.groups > 1) {  // lanes_k and groups are powers of two here
    for (int off = w.lanes_k; off < 32; off <<= 1) s += __shfl_xor_sync(kFull, s, off);
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_fwd_kernel(const T* __restrict__ v, float* __restrict__ out, int B, int F, int K) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const WarpLayout w = warp_layout(K, lane);
  const T* row = v + b * F * K;

  float t = 0.f;
  for (int k0 = 0; k0 < K; k0 += w.lanes_k) {
    const int k = k0 + w.kl;
    float q;
    const float s = field_sum(row, w, k, F, K, q);
    // s^2 once for each k (the first field group), every lane's own squares
    t += (w.g == 0 && k < K ? s * s : 0.f) - q;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) out[b] = 0.5f * t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_bwd_kernel(const T* __restrict__ v, const float* __restrict__ g_out,
              T* __restrict__ dv, int B, int F, int K) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (b >= B) return;
  const WarpLayout w = warp_layout(K, lane);
  const T* row = v + b * F * K;
  T* drow = dv + b * F * K;
  const float go = g_out[b];

  for (int k0 = 0; k0 < K; k0 += w.lanes_k) {
    const int k = k0 + w.kl;
    float q;
    const float s = field_sum(row, w, k, F, K, q);
    if (w.active && k < K) {
#pragma unroll 4
      for (int f = w.g; f < F; f += w.groups) {
        const int64_t at = (int64_t)f * K + k;
        drow[at] = from_f32<T>(go * (s - to_f32(row[at])));
      }
    }
  }
}

inline int blocks_for(int rows) { return (rows + kWarpsPerBlock - 1) / kWarpsPerBlock; }

template <typename T>
int launch_fwd(const void* v, float* out, int B, int F, int K, cudaStream_t s) {
  fm_fwd_kernel<T><<<blocks_for(B), kThreads, 0, s>>>(static_cast<const T*>(v), out, B, F, K);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* v, const float* g, void* dv, int B, int F, int K,
               cudaStream_t s) {
  fm_bwd_kernel<T><<<blocks_for(B), kThreads, 0, s>>>(static_cast<const T*>(v), g,
                                                       static_cast<T*>(dv), B, F, K);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype of v (and of dv): 0 = fp32, 1 = bf16, 2 = fp16. Returns the
// cudaError_t of the launch; a call with no rows launches nothing.

int fm_fwd(const void* v, float* out, int B, int F, int K, int dtype, void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (F < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_fwd<float>(v, out, B, F, K, s);
    case 1: return launch_fwd<__nv_bfloat16>(v, out, B, F, K, s);
    case 2: return launch_fwd<__half>(v, out, B, F, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

int fm_bwd(const void* v, const float* g, void* dv, int B, int F, int K, int dtype,
           void* stream) {
  if (B <= 0) return (int)cudaGetLastError();
  if (F < 1 || K < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return launch_bwd<float>(v, g, dv, B, F, K, s);
    case 1: return launch_bwd<__nv_bfloat16>(v, g, dv, B, F, K, s);
    case 2: return launch_bwd<__half>(v, g, dv, B, F, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
