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
// (8, 128) vector layout.
//
// Bound on this card: device-memory bytes. The forward reads B*F*K values
// and writes 4*B bytes for about 3*B*F*K operations, under one operation a
// byte against the ~20 a byte the fp32 pipes could do; the backward reads v
// and g and writes dv. So the design is about moving bytes, and it takes one
// of two kernels by what the input allows (``plan``), both with sums in a
// fixed order and no atomics (two calls give the same bits) and 64-bit
// offsets:
//   * vector (K a power-of-two number of 16-byte vectors, 16-byte aligned
//     bases; DeepFM's K = 16 in fp32 and bf16): a thread per (row, 16-byte
//     column of k) loads all of its row's fields (up to kBatch) as 16-byte
//     vectors before its first add, so a row costs one round trip and the
//     backward writes dv from the registers it summed; a persistent grid.
//   * direct (anything else): one warp a row straight from device memory,
//     one lane per k, 32/K fields side by side when K divides 32,
//     butterflies over the lanes that share a k and over the warp.
// A design that brought tiles of rows into a ring of shared-memory stages by
// 1-D bulk copies (cp.async.bulk + mbarrier) was written and measured beside
// the vector one; it was no faster at K = 16 and no width a model of the
// port runs needs it, so it went (PERF.md, "Findings").

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kBlocksPerSm = 2;
constexpr int kMaxDevices = 64;
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

// -- one row: one lane per k ---------------------------------------------------

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
__device__ __forceinline__ float field_sum(const T* row, const WarpLayout& w, int k, int F,
                                           int K, float& q) {
  float s = 0.f;
  q = 0.f;
  if (w.active && k < K) {
#pragma unroll 8
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

// The FM term of one row (every lane gets it); the whole warp calls it.
template <typename T>
__device__ __forceinline__ float row_fm(const T* row, const WarpLayout& w, int F, int K) {
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
  return 0.5f * t;
}

// dv of one row into `drow`.
template <typename T>
__device__ __forceinline__ void row_grad(const T* row, T* drow, float go, const WarpLayout& w,
                                         int F, int K) {
  for (int k0 = 0; k0 < K; k0 += w.lanes_k) {
    const int k = k0 + w.kl;
    float q;
    const float s = field_sum(row, w, k, F, K, q);
    if (w.active && k < K) {
#pragma unroll 8
      for (int f = w.g; f < F; f += w.groups) {
        const int64_t at = (int64_t)f * K + k;
        drow[at] = from_f32<T>(go * (s - to_f32(row[at])));
      }
    }
  }
}

// -- the direct kernels: one warp a row, straight from device memory ------------

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_fwd_direct(const T* __restrict__ v, float* __restrict__ out, int B, int F, int K) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;  // the whole warp leaves together
  const float y = row_fm(v + b * F * K, warp_layout(K, lane), F, K);
  if (lane == 0) out[b] = y;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_bwd_direct(const T* __restrict__ v, const float* __restrict__ g, T* __restrict__ dv, int B,
              int F, int K) {
  const int lane = threadIdx.x & 31;
  const int64_t b = (int64_t)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (b >= B) return;
  row_grad(v + b * F * K, dv + b * F * K, g[b], warp_layout(K, lane), F, K);
}

// -- the vector kernels: 16-byte loads straight from device memory ----------------
//
// A thread owns one (row, k-vector): the V = 16 / sizeof(T) values k in
// [kv*V, kv*V + V) of every field of its row, so it finishes s[b,k] for its
// k alone; the forward adds its share of the row over the K/V threads of the
// row (neighbouring lanes) with a butterfly. A thread starts the loads of up
// to kBatch fields before its first add and keeps them in registers, so a row
// of up to kBatch fields costs one round trip to memory and the backward
// writes dv from the registers it summed (no second read). The grid is
// persistent: a thread walks over (row, k-vector) items a grid apart.

constexpr int kBatch = 24;

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

template <typename T> struct Lanes;  // 16 bytes <-> V floats
template <> struct Lanes<float> {
  static constexpr int V = 4;
  __device__ static void unpack(const uint4& r, float* x) {
    x[0] = __uint_as_float(r.x); x[1] = __uint_as_float(r.y);
    x[2] = __uint_as_float(r.z); x[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* y) {
    return make_uint4(__float_as_uint(y[0]), __float_as_uint(y[1]), __float_as_uint(y[2]),
                      __float_as_uint(y[3]));
  }
};
template <> struct Lanes<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the top half of its float
      x[2 * i] = __uint_as_float(w[i] << 16);
      x[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
  __device__ static uint4 pack(const float* y) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};
template <> struct Lanes<__half> {
  static constexpr int V = 8;
  __device__ static void unpack(const uint4& r, float* x) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(*reinterpret_cast<const __half2*>(&w[i]));
      x[2 * i] = f.x;
      x[2 * i + 1] = f.y;
    }
  }
  __device__ static uint4 pack(const float* y) {
    unsigned w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const __half2 h = __floats2half2_rn(y[2 * i], y[2 * i + 1]);
      w[i] = *reinterpret_cast<const unsigned*>(&h);
    }
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
};

// Fields f0 .. f0 + kBatch - 1 (those below F) of this thread's k-vector;
// `p` points at field 0's, fields K values apart.
template <typename T>
__device__ __forceinline__ void load_batch(const T* p, int K, int f0, int F,
                                           uint4 (&r)[kBatch]) {
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (f0 + i < F) r[i] = load16(p + (int64_t)(f0 + i) * K);
  }
}

// s[j] += the batch's values at k = kv*V + j (and q += their squares)
template <typename T, bool kSquares>
__device__ __forceinline__ void add_batch(const uint4 (&r)[kBatch], int f0, int F, float* s,
                                          float& q) {
  constexpr int V = Lanes<T>::V;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (f0 + i < F) {
      float x[V];
      Lanes<T>::unpack(r[i], x);
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s[j] += x[j];
        if (kSquares) q = fmaf(x[j], x[j], q);
      }
    }
  }
}

// dv of the batch's fields: g * (s - v), stored as 16-byte vectors
template <typename T>
__device__ __forceinline__ void grad_batch(const uint4 (&r)[kBatch], T* d, int K, int f0,
                                           int F, const float* s, float go) {
  constexpr int V = Lanes<T>::V;
#pragma unroll
  for (int i = 0; i < kBatch; ++i) {
    if (f0 + i < F) {
      float x[V];
      Lanes<T>::unpack(r[i], x);
#pragma unroll
      for (int j = 0; j < V; ++j) x[j] = go * (s[j] - x[j]);
      *reinterpret_cast<uint4*>(d + (int64_t)(f0 + i) * K) = Lanes<T>::pack(x);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_fwd_vec(const T* __restrict__ v, float* __restrict__ out, int B, int F, int K,
           int tpr_log2) {
  constexpr int V = Lanes<T>::V;
  const int64_t total = (int64_t)B << tpr_log2;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  // the loop test is the block's first item, so every lane takes every turn
  for (int64_t first = (int64_t)blockIdx.x * blockDim.x; first < total; first += step) {
    const int64_t item = first + threadIdx.x;
    const int64_t b = item >> tpr_log2;
    const int kv = (int)(item & ((1 << tpr_log2) - 1));
    float t = 0.f;
    if (item < total) {
      const T* p = v + b * F * K + kv * V;
      float s[V], q = 0.f;
#pragma unroll
      for (int j = 0; j < V; ++j) s[j] = 0.f;
      uint4 r[kBatch];
      for (int f0 = 0; f0 < F; f0 += kBatch) {
        load_batch(p, K, f0, F, r);
        add_batch<T, true>(r, f0, F, s, q);
      }
#pragma unroll
      for (int j = 0; j < V; ++j) t = fmaf(s[j], s[j], t);
      t -= q;
    }
    for (int off = 1; off < (1 << tpr_log2); off <<= 1) t += __shfl_xor_sync(kFull, t, off);
    if (item < total && kv == 0) out[b] = 0.5f * t;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fm_bwd_vec(const T* __restrict__ v, const float* __restrict__ g, T* __restrict__ dv, int B,
           int F, int K, int tpr_log2) {
  constexpr int V = Lanes<T>::V;
  const int64_t total = (int64_t)B << tpr_log2;
  const int64_t step = (int64_t)gridDim.x * blockDim.x;
  for (int64_t item = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; item < total;
       item += step) {
    const int64_t b = item >> tpr_log2;
    const int64_t at = b * F * K + (item & ((1 << tpr_log2) - 1)) * V;
    float s[V], q = 0.f;
#pragma unroll
    for (int j = 0; j < V; ++j) s[j] = 0.f;
    uint4 r[kBatch];
    for (int f0 = 0; f0 < F; f0 += kBatch) {
      load_batch(v + at, K, f0, F, r);
      add_batch<T, false>(r, f0, F, s, q);
    }
    const float go = g[b];
    if (F <= kBatch) {  // the row is still in registers
      grad_batch(r, dv + at, K, 0, F, s, go);
    } else {            // read it again, from the caches
      for (int f0 = 0; f0 < F; f0 += kBatch) {
        load_batch(v + at, K, f0, F, r);
        grad_batch(r, dv + at, K, f0, F, s, go);
      }
    }
  }
}

// -- launch plans ---------------------------------------------------------------

int sm_count() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) return 0;
  if (cached[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    cached[dev] = n;
  }
  return cached[dev];
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The plan: log2 of the threads a row takes in the vector kernels, or -1
// where they cannot take the input and the direct kernel runs: K must hold
// whole 16-byte vectors, K / V of them a power of two up to 32 (a row's lanes
// in one warp), the bases 16-byte aligned.
int plan(const void* v, const void* dv, int K, int itemsize) {
  const int V = 16 / itemsize;
  if (K % V != 0 || !aligned16(v) || (dv != nullptr && !aligned16(dv))) return -1;
  const int tpr = K / V;
  if (tpr > 32 || (tpr & (tpr - 1)) != 0) return -1;
  return __builtin_ctz(tpr);
}

inline int direct_blocks(int rows) { return (rows + kWarps - 1) / kWarps; }

// Blocks of the vector kernels: one item a thread up to as many blocks as
// the SMs hold at once (the grid is persistent beyond that), 256 threads a
// block, or 64 where the input would leave most SMs idle.
template <typename Kernel>
void vector_grid(Kernel kernel, int* resident, int B, int tpr_log2, int* blocks, int* threads) {
  const int64_t total = (int64_t)B << tpr_log2;
  const int sms = sm_count();
  *threads = total < (int64_t)kThreads * kBlocksPerSm * sms ? 64 : kThreads;
  int dev = 0;
  cudaGetDevice(&dev);
  int per_sm = kBlocksPerSm;
  if (dev >= 0 && dev < kMaxDevices) {
    if (resident[dev] == 0 &&
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&resident[dev], kernel, kThreads, 0) !=
            cudaSuccess) {
      resident[dev] = kBlocksPerSm;
    }
    per_sm = resident[dev] * (kThreads / *threads);
  }
  const int64_t need = (total + *threads - 1) / *threads;
  const int64_t most = (int64_t)(per_sm > 0 ? per_sm : 1) * (sms > 0 ? sms : 1);
  *blocks = (int)(need < most ? need : most);
}

template <typename T>
int launch_fwd(const void* vp, float* out, int B, int F, int K, cudaStream_t s) {
  static int resident[kMaxDevices] = {0};
  const T* v = static_cast<const T*>(vp);
  const int tpr_log2 = plan(vp, nullptr, K, sizeof(T));
  if (tpr_log2 >= 0) {
    int blocks, threads;
    vector_grid(fm_fwd_vec<T>, resident, B, tpr_log2, &blocks, &threads);
    fm_fwd_vec<T><<<blocks, threads, 0, s>>>(v, out, B, F, K, tpr_log2);
  } else {
    fm_fwd_direct<T><<<direct_blocks(B), kThreads, 0, s>>>(v, out, B, F, K);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd(const void* vp, const float* g, void* dvp, int B, int F, int K, cudaStream_t s) {
  static int resident[kMaxDevices] = {0};
  const T* v = static_cast<const T*>(vp);
  T* dv = static_cast<T*>(dvp);
  const int tpr_log2 = plan(vp, dvp, K, sizeof(T));
  if (tpr_log2 >= 0) {
    int blocks, threads;
    vector_grid(fm_bwd_vec<T>, resident, B, tpr_log2, &blocks, &threads);
    fm_bwd_vec<T><<<blocks, threads, 0, s>>>(v, g, dv, B, F, K, tpr_log2);
  } else {
    fm_bwd_direct<T><<<direct_blocks(B), kThreads, 0, s>>>(v, g, dv, B, F, K);
  }
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

// 1 where a call on these pointers (dv null for the forward) takes the
// vector kernel, 0 where it takes the direct one; it launches nothing.
int fm_takes_vector(const void* v, const void* dv, int K, int itemsize) {
  return plan(v, dv, K, itemsize) >= 0 ? 1 : 0;
}

}  // extern "C"
