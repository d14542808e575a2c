// Sparse propagation out = A @ x for Hopper (sm_90a): x gathered in bf16 or
// fp32, weights and sums in fp32, out in fp32.
//
// Replaces the TPU kernels recsys_tpu/ops/pallas_spmm.py: _spmm_kernel and
// _spmm_kernel_packed, in both of their modes. A is the symmetric normalized
// user-item adjacency; the contract kept from the TPU kernel is
//
//   out[d] = sum over edges e with dst[e] == d of  w[e] * x[src[e]]
//
// with zero rows for nodes without edges, no (E, D) message array in device
// memory, and a backward that is the same product (A is symmetric, so the
// wrapper launches this kernel on the incoming gradient). The two modes are
// the TPU kernel's: "f32" reads x in fp32; "bf16" (the trainer's mode) reads
// a bf16 copy of x that the wrapper makes in one elementwise pass, as the
// JAX wrapper's astype does. In both modes the weight stays fp32 and the sum
// is taken in fp32 (the TPU kernel sums the bf16 mode in bf16; this one is
// the more exact of the two).
//
// What is not kept is the TPU layout. There a scatter is slow, so gather
// and scatter became one-hot matmuls over (dst-block, src-block) chunks.
// Hopper gathers rows well, so the layout is CSR: edges sorted by
// destination, `col` and `val` per edge, built once on the host (ops/spmm.py).
//
// What bounds it. Counting each input once, the product reads x, col, val
// and the row pointers and writes out: at the reference-scale graph
// (E = 22.6M directed edges, N = 247,000, D = 64) ~308 MB in fp32 and
// ~276 MB in bf16 against 2 * E * D = 2.9 GFLOP, so device-memory bytes bound
// it. What the kernel really moves is one row of x per edge: E * 256 B =
// 5.8 GB in fp32, E * 128 B = 2.9 GB in bf16, nearly all of it served by L2
// and L1 (x in fp32 is 63 MB and does not fit the 50 MB L2; the bf16 copy
// is 32 MB and does). On the card the gathers come out of the caches at
// 7.4-8 TB/s whatever the kernel's shape, so its time is the gathered bytes
// over that rate: the bf16 mode halves it, and nothing else did.
//
// Design.
//   * 16-byte loads. A row of D values is D * sizeof(T) / 16 lanes wide
//     (8 lanes for bf16 at D = 64, 16 for fp32), so one warp instruction
//     gathers 32 / that many rows (4 or 2): lane l takes 16 bytes of the row
//     of edge g * rows_per_load + l / lanes_per_row and keeps its own fp32
//     sums for those 4 (fp32) or 8 (bf16) features. The loads go through L1
//     (ld.global.nc), where the hot item rows stay.
//   * Many warps, few loads each. Two warp loads are in flight per warp and
//     the kernel is held to 32 registers, so 64 warps are resident per SM and
//     all of L1 stays a cache. Measured on the card against this choice: a
//     per-warp ring in shared memory filled by cp.async with 8 or 16 warp
//     loads in flight (the rows no longer held in registers) was 20% (bf16)
//     to 40% (fp32) slower, and 4 or 8 loads in registers 3-15% slower: the
//     ring's shared memory is taken from L1, and deeper unrolling costs
//     resident warps. TMA is no help either: on Hopper it copies boxes of a
//     tensor and has no gather.
//   * col/val of the next 32 edges are fetched one chunk ahead by one
//     coalesced load each and handed round by shuffle.
//   * One warp per segment of a destination row; a segment ends with a
//     fixed butterfly over the lane groups and one coalesced store. Within a
//     lane group edges are summed in edge order; no atomics on floats, so
//     two calls give the same bits.
//   * Work order. Item degrees are heavily skewed (the most popular item of
//     the reference-scale graph has ~1e5 edges, a user ~56). The host cuts a
//     row longer than `max_segment` edges into segments of that length and
//     hands the kernel the segments longest first (`seg_order`), so the
//     full-length hub segments start the grid and the short user rows fill
//     its tail (1-2% on the card). A row of one segment is written straight
//     to `out`; a row of several writes its partial sums to scratch, and the
//     second kernel below adds them in segment order, one warp per hub row.
//   * Byte offsets are computed in 64 bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kBlocksPerSm = 8;  // 64 resident warps: the kernel fits 32 registers
constexpr int kUnroll = 2;       // warp loads in flight per warp
constexpr unsigned kFull = 0xffffffffu;

// T is the stored type of x, D its width.
template <typename T, int D>
struct Geometry {
  static constexpr int kRowBytes = D * (int)sizeof(T);
  static constexpr int kLanesPerRow = kRowBytes / 16;
  static constexpr int kRowsPerLoad = 32 / kLanesPerRow;
  static constexpr int kVals = 16 / (int)sizeof(T);  // features a lane sums
  static_assert(kLanesPerRow >= 1 && kLanesPerRow <= 32, "row of 16 to 512 bytes");
};

__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[4]) {
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// a bf16 is the high half of an fp32: widening is a shift, exact
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[8]) {
  const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// One warp per segment: the i-th warp of the grid takes segment seg_order[i],
// edges [seg_ptr[s], seg_ptr[s + 1]). seg_out[s] >= 0 is the row of `out` the
// segment owns alone; otherwise -(slot + 1) names its row of `partial`.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
spmm_segments_kernel(const int* __restrict__ seg_order, const int* __restrict__ seg_ptr,
                     const int* __restrict__ seg_out, const int* __restrict__ col,
                     const float* __restrict__ val, const T* __restrict__ x,
                     float* __restrict__ out, float* __restrict__ partial,
                     int num_segments) {
  using G = Geometry<T, D>;
  constexpr int kRows = G::kRowsPerLoad, kVals = G::kVals;
  constexpr int kLoadsPerChunk = 32 / kRows;
  constexpr int kU = kUnroll < kLoadsPerChunk ? kUnroll : kLoadsPerChunk;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t index = (int64_t)blockIdx.x * kWarpsPerBlock + warp;
  if (index >= num_segments) return;
  const int seg = seg_order[index];
  const int start = seg_ptr[seg], n = seg_ptr[seg + 1] - start;
  const int sub = lane / G::kLanesPerRow, part = lane % G::kLanesPerRow;
  const unsigned char* xb = reinterpret_cast<const unsigned char*>(x) + part * 16;

  float acc[kVals];
#pragma unroll
  for (int i = 0; i < kVals; ++i) acc[i] = 0.f;

  int c_next = 0;
  float w_next = 0.f;
  if (lane < n) {
    c_next = __ldg(col + start + lane);
    w_next = __ldg(val + start + lane);
  }
  for (int base = 0; base < n; base += 32) {
    const int c_cur = c_next;
    const float w_cur = w_next;  // 0 past the end of the segment
    c_next = 0;
    w_next = 0.f;
    if (base + 32 + lane < n) {
      c_next = __ldg(col + start + base + 32 + lane);
      w_next = __ldg(val + start + base + 32 + lane);
    }
#pragma unroll
    for (int u0 = 0; u0 < kLoadsPerChunk; u0 += kU) {
      if (base + u0 * kRows < n) {
        uint4 raw[kU];
        float w[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = (u0 + u) * kRows + sub;  // within the chunk
          const int c = __shfl_sync(kFull, c_cur, e);
          w[u] = __shfl_sync(kFull, w_cur, e);
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          if (base + e < n)
            raw[u] = __ldg(reinterpret_cast<const uint4*>(xb + (int64_t)c * G::kRowBytes));
        }
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          float row[kVals];
          unpack(raw[u], row);
#pragma unroll
          for (int i = 0; i < kVals; ++i) acc[i] = fmaf(w[u], row[i], acc[i]);
        }
      }
    }
  }
#pragma unroll
  for (int off = G::kLanesPerRow; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < kVals; ++i) acc[i] += __shfl_xor_sync(kFull, acc[i], off);
  }
  if (sub == 0) {
    const int target = seg_out[seg];
    float* dst = (target >= 0 ? out + (int64_t)target * D
                              : partial + (int64_t)(-(target + 1)) * D) + part * kVals;
#pragma unroll
    for (int i = 0; i < kVals; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
}

// One warp per hub row h: out[hub_row[h]] = sum of the partial rows
// [hub_ptr[h], hub_ptr[h + 1]) in that order. A lane holds D / 32 features.
template <int VEC>
struct Packed;
template <> struct Packed<1> { using T = float; };
template <> struct Packed<2> { using T = float2; };
template <> struct Packed<4> { using T = float4; };

template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_hub_reduce_kernel(const int* __restrict__ hub_row, const int* __restrict__ hub_ptr,
                       const float* __restrict__ partial, float* __restrict__ out,
                       int num_hubs) {
  using P = typename Packed<VEC>::T;
  constexpr int D = 32 * VEC, kAhead = 8;
  const int lane = threadIdx.x & 31;
  const int64_t h = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (h >= num_hubs) return;
  const int start = hub_ptr[h], end = hub_ptr[h + 1];

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int p = start; p < end; p += kAhead) {
    P rows[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (p + k < end) {
        rows[k] = __ldg(reinterpret_cast<const P*>(partial + (int64_t)(p + k) * D) + lane);
      } else {
        float* f = reinterpret_cast<float*>(&rows[k]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const float* f = reinterpret_cast<const float*>(&rows[k]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += f[i];
    }
  }
  P sum;
  float* f = reinterpret_cast<float*>(&sum);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = acc[i];
  reinterpret_cast<P*>(out + (int64_t)hub_row[h] * D)[lane] = sum;
}

inline int blocks_for(int warps) { return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock; }

template <typename T, int D>
int launch_segments(const int* seg_order, const int* seg_ptr, const int* seg_out,
                    const int* col, const float* val, const void* x, float* out,
                    float* partial, int num_segments, cudaStream_t s) {
  spmm_segments_kernel<T, D><<<blocks_for(num_segments), kThreads, 0, s>>>(
      seg_order, seg_ptr, seg_out, col, val, static_cast<const T*>(x), out, partial,
      num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widths the kernels take.
int spmm_supports_dim(int D) { return D == 32 || D == 64 || D == 128; }

// x is (N, D) bf16 when x_is_bf16, else fp32; out and partial are fp32.
int spmm_csr(const int* seg_order, const int* seg_ptr, const int* seg_out, const int* col,
             const float* val, const void* x, int x_is_bf16, float* out, float* partial,
             int num_segments, int D, void* stream) {
  if (num_segments <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPMM_LAUNCH(T, WIDTH)                                                            \
  return launch_segments<T, WIDTH>(seg_order, seg_ptr, seg_out, col, val, x, out, partial, \
                                   num_segments, s)
  if (x_is_bf16) {
    if (D == 32) SPMM_LAUNCH(__nv_bfloat16, 32);
    if (D == 64) SPMM_LAUNCH(__nv_bfloat16, 64);
    if (D == 128) SPMM_LAUNCH(__nv_bfloat16, 128);
  } else {
    if (D == 32) SPMM_LAUNCH(float, 32);
    if (D == 64) SPMM_LAUNCH(float, 64);
    if (D == 128) SPMM_LAUNCH(float, 128);
  }
#undef SPMM_LAUNCH
  return (int)cudaErrorInvalidValue;
}

int spmm_hub_reduce(const int* hub_row, const int* hub_ptr, const float* partial,
                    float* out, int num_hubs, int D, void* stream) {
  if (num_hubs <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(num_hubs);
  switch (D) {
    case 32:
      spmm_hub_reduce_kernel<1><<<blocks, kThreads, 0, s>>>(hub_row, hub_ptr, partial,
                                                            out, num_hubs);
      break;
    case 64:
      spmm_hub_reduce_kernel<2><<<blocks, kThreads, 0, s>>>(hub_row, hub_ptr, partial,
                                                            out, num_hubs);
      break;
    case 128:
      spmm_hub_reduce_kernel<4><<<blocks, kThreads, 0, s>>>(hub_row, hub_ptr, partial,
                                                            out, num_hubs);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // extern "C"
