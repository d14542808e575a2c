// Sparse propagation out = A @ x for Hopper (sm_90a), fp32 in and out.
//
// Replaces the TPU kernels recsys_tpu/ops/pallas_spmm.py: _spmm_kernel and
// _spmm_kernel_packed. A is the symmetric normalized user-item adjacency;
// the contract kept from the TPU kernel is
//
//   out[d] = sum over edges e with dst[e] == d of  w[e] * x[src[e]]
//
// in fp32, with zero rows for nodes without edges, no (E, D) message array
// in device memory, and a backward that is the same product (A is
// symmetric, so the wrapper launches this kernel on the incoming gradient).
//
// What is not kept is the TPU layout. There a scatter is slow, so gather
// and scatter became one-hot matmuls over (dst-block, src-block) chunks,
// with lane packing and sub-chunk splits to fill the matrix unit. Hopper
// gathers rows well, so the layout here is CSR: edges sorted by destination,
// `col` and `val` per edge, built once on the host (ops/spmm.py).
//
// Design.
//   * One warp per segment of a destination row. A lane holds VEC
//     neighbouring features (D = 32 * VEC; float2 at D = 64), so one source
//     row is one coalesced read of D * 4 bytes.
//   * The warp reads 32 edges' (col, val) with one coalesced load, hands
//     them round by shuffle, and issues the gathers eight at a time so that
//     eight row reads are in flight per warp before the first FMA.
//   * Sums stay in registers, in edge order; one coalesced store per
//     segment. No atomics, so two calls give the same bits.
//   * Hub rows. Item degrees are heavily skewed (the most popular item of
//     the reference-scale graph has ~1e5 edges, a user ~56), and one warp
//     walking such a row would be the kernel's tail. The host cuts a row
//     longer than `max_segment` edges into segments of that length. A row
//     of one segment is written straight to `out`; a row of several writes
//     its partial sums to scratch, and the second kernel below adds them in
//     segment order, one warp per hub row. That was taken over one block
//     per hub row with a shared-memory tree because it spreads a hub row
//     over as many SMs as it has segments, keeps one gather loop for every
//     row, and stays deterministic; the scratch traffic is a few MB against
//     GBs of gathers.
//   * Byte offsets are computed in 64 bits.
//
// Bound on this card: device-memory bytes. Counting each input once, the
// product reads x, col, val and the row pointers and writes out: at the
// reference-scale graph (E = 22.6M directed edges, N = 247,000, D = 64)
// about 308 MB against 2 * E * D = 2.9 GFLOP, so memory bounds it by a
// factor of two over fp32 issue. What the kernel really moves is one row
// of x per edge (E * 256 B = 5.8 GB when no source row is found in L2),
// so its time sits between the two figures and depends on L2 reuse.
// Storing x in bf16 and reordering nodes for L2 reuse are the routes to a
// faster version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpsPerBlock = 8;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kUnroll = 8;  // gathers in flight per warp
constexpr unsigned kFull = 0xffffffffu;

template <int VEC> struct Row;
template <> struct Row<1> { using T = float; };
template <> struct Row<2> { using T = float2; };
template <> struct Row<4> { using T = float4; };

template <int VEC>
__device__ __forceinline__ void load_row(const float* base, int lane, float (&r)[VEC]) {
  using T = typename Row<VEC>::T;
  const T v = __ldg(reinterpret_cast<const T*>(base) + lane);
  const float* f = reinterpret_cast<const float*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) r[i] = f[i];
}

template <int VEC>
__device__ __forceinline__ void store_row(float* base, int lane, const float (&acc)[VEC]) {
  using T = typename Row<VEC>::T;
  T v;
  float* f = reinterpret_cast<float*>(&v);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = acc[i];
  reinterpret_cast<T*>(base)[lane] = v;
}

// One warp per segment s: edges [seg_ptr[s], seg_ptr[s + 1]). seg_out[s] >= 0
// is the row of `out` the segment owns alone; otherwise -(slot + 1) names its
// row of `partial`.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_segments_kernel(const int* __restrict__ seg_ptr, const int* __restrict__ seg_out,
                     const int* __restrict__ col, const float* __restrict__ val,
                     const float* __restrict__ x, float* __restrict__ out,
                     float* __restrict__ partial, int num_segments) {
  constexpr int D = 32 * VEC;
  const int lane = threadIdx.x & 31;
  const int64_t seg = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (seg >= num_segments) return;
  const int start = seg_ptr[seg], end = seg_ptr[seg + 1];

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;

  for (int base = start; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_col = 0;
    float my_val = 0.f;
    if (lane < n) {
      my_col = __ldg(col + base + lane);
      my_val = __ldg(val + base + lane);
    }
    for (int u = 0; u < n; u += kUnroll) {
      float rows[kUnroll][VEC];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int c = __shfl_sync(kFull, my_col, (u + k) & 31);
        if (u + k < n) {
          load_row<VEC>(x + (int64_t)c * D, lane, rows[k]);
        } else {
#pragma unroll
          for (int i = 0; i < VEC; ++i) rows[k][i] = 0.f;
        }
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        // lanes past n hold val 0, so a skipped gather adds +0
        const float v = __shfl_sync(kFull, my_val, (u + k) & 31);
#pragma unroll
        for (int i = 0; i < VEC; ++i) acc[i] = fmaf(v, rows[k][i], acc[i]);
      }
    }
  }

  const int target = seg_out[seg];
  float* dst = target >= 0 ? out + (int64_t)target * D
                           : partial + (int64_t)(-(target + 1)) * D;
  store_row<VEC>(dst, lane, acc);
}

// One warp per hub row h: out[hub_row[h]] = sum of the partial rows
// [hub_ptr[h], hub_ptr[h + 1]) in that order.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
spmm_hub_reduce_kernel(const int* __restrict__ hub_row, const int* __restrict__ hub_ptr,
                       const float* __restrict__ partial, float* __restrict__ out,
                       int num_hubs) {
  constexpr int D = 32 * VEC;
  const int lane = threadIdx.x & 31;
  const int64_t h = (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
  if (h >= num_hubs) return;
  const int start = hub_ptr[h], end = hub_ptr[h + 1];

  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int p = start; p < end; p += kUnroll) {
    float rows[kUnroll][VEC];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      if (p + k < end) {
        load_row<VEC>(partial + (int64_t)(p + k) * D, lane, rows[k]);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) rows[k][i] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += rows[k][i];
    }
  }
  store_row<VEC>(out + (int64_t)hub_row[h] * D, lane, acc);
}

inline int blocks_for(int warps) { return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock; }

}  // namespace

extern "C" {

// Widths the kernels take: D = 32 * VEC for VEC in {1, 2, 4}.
int spmm_supports_dim(int D) { return D == 32 || D == 64 || D == 128; }

int spmm_csr(const int* seg_ptr, const int* seg_out, const int* col, const float* val,
             const float* x, float* out, float* partial, int num_segments, int D,
             void* stream) {
  if (num_segments <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int blocks = blocks_for(num_segments);
  switch (D) {
    case 32:
      spmm_segments_kernel<1><<<blocks, kThreads, 0, s>>>(seg_ptr, seg_out, col, val, x,
                                                          out, partial, num_segments);
      break;
    case 64:
      spmm_segments_kernel<2><<<blocks, kThreads, 0, s>>>(seg_ptr, seg_out, col, val, x,
                                                          out, partial, num_segments);
      break;
    case 128:
      spmm_segments_kernel<4><<<blocks, kThreads, 0, s>>>(seg_ptr, seg_out, col, val, x,
                                                          out, partial, num_segments);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
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
