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
//     hands the kernel the segments in `seg_order`: every hub row's
//     segments first, longest first (equal lengths largest hub first), then
//     the other rows longest first. So the full-length hub segments start
//     the grid, a block's warps take segments of one length, and the
//     short user rows fill its tail (1-2% on the card). A row of one segment
//     is written straight to `out`; a row of several (a hub) writes its
//     partial sums to scratch.
//   * Hub rows are finished inside the same launch. A hub segment's warp
//     stores its partial row and counts its arrival in the hub's counter
//     (`hub_count`, one acquire-release atomic add); the warp that arrives
//     last resets the counter to 0, adds the hub's partial rows in
//     segment order from 0.0f (a lane per D / 32 features, 16 floats a lane
//     in flight) and writes the hub's row of `out`. The sum is the one a
//     separate pass would take, so the bits do not depend on which warp
//     finishes. The partial rows were written by other SMs during this
//     launch, so the walk reads them through L2 (ld.global.cg), never
//     through the read-only path. The hub segments come first in the grid,
//     so the walks run beside the gathers of the rest of it and not after
//     them. A call is one launch, and
//     the counters are zero again after it (CUDA-graph replay, back-to-back
//     calls).
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

template <int VEC>
struct Packed;
template <> struct Packed<1> { using T = float; };
template <> struct Packed<2> { using T = float2; };
template <> struct Packed<4> { using T = float4; };

// One arrival at a hub's counter: atom.add.acq_rel at GPU scope. The release
// half publishes the warp's partial row (ordered before it by __syncwarp);
// the acquire half, for the warp that arrives last, makes the rows of the
// warps that arrived before visible to its reads. No separate fence.
__device__ __forceinline__ int arrive(int* counter) {
  int old;
  asm volatile("atom.acq_rel.gpu.global.add.s32 %0, [%1], 1;"
               : "=r"(old) : "l"(counter) : "memory");
  return old;
}

// ld.global.cg: through L2, past L1 and the read-only path. volatile and a
// memory clobber keep the load after the arrival that orders it.
__device__ __forceinline__ float load_cg(const float* p) {
  float v;
  asm volatile("ld.global.cg.f32 %0, [%1];" : "=f"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ float2 load_cg(const float2* p) {
  float2 v;
  asm volatile("ld.global.cg.v2.f32 {%0, %1}, [%2];" : "=f"(v.x), "=f"(v.y) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ float4 load_cg(const float4* p) {
  float4 v;
  asm volatile("ld.global.cg.v4.f32 {%0, %1, %2, %3}, [%4];"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w) : "l"(p) : "memory");
  return v;
}

// out_row = the nseg partial rows at `rows`, added in order from 0.0f; a lane
// holds D / 32 features. The rows come from other SMs of this launch: read
// through L2 (load_cg), not the read-only path.
template <int D>
__device__ __forceinline__ void hub_finish(const float* rows, int nseg, float* out_row,
                                           int lane) {
  constexpr int VEC = D / 32, kAhead = 16 / VEC;
  using P = typename Packed<VEC>::T;
  float acc[VEC];
#pragma unroll
  for (int i = 0; i < VEC; ++i) acc[i] = 0.f;
  for (int p = 0; p < nseg; p += kAhead) {
    P r[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (p + k < nseg) {
        r[k] = load_cg(reinterpret_cast<const P*>(rows + (int64_t)(p + k) * D) + lane);
      } else {
        float* f = reinterpret_cast<float*>(&r[k]);
#pragma unroll
        for (int i = 0; i < VEC; ++i) f[i] = 0.f;
      }
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {  // x + 0.0f == x: acc is never -0.0f
      const float* f = reinterpret_cast<const float*>(&r[k]);
#pragma unroll
      for (int i = 0; i < VEC; ++i) acc[i] += f[i];
    }
  }
  P sum;
  float* f = reinterpret_cast<float*>(&sum);
#pragma unroll
  for (int i = 0; i < VEC; ++i) f[i] = acc[i];
  reinterpret_cast<P*>(out_row)[lane] = sum;
}

__device__ __forceinline__ int64_t warp_index() {
  return (int64_t)blockIdx.x * kWarpsPerBlock + (threadIdx.x >> 5);
}

// One warp per segment: the i-th warp of the grid takes segment seg_order[i],
// edges [seg_ptr[s], seg_ptr[s + 1]). seg_out[s] >= 0 is the row of `out` the
// segment owns alone; otherwise -(slot + 1) names its row of `partial`, and
// slot_hub[slot] = h its hub: row hub_row[h] of `out` is the sum of the slots
// [hub_ptr[h], hub_ptr[h + 1]), which the last of them to arrive adds up.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm)
spmm_segments_kernel(const int* __restrict__ seg_order, const int* __restrict__ seg_ptr,
                     const int* __restrict__ seg_out, const int* __restrict__ col,
                     const float* __restrict__ val, const T* __restrict__ x,
                     float* __restrict__ out, float* __restrict__ partial,
                     const int* __restrict__ slot_hub, const int* __restrict__ hub_ptr,
                     const int* __restrict__ hub_row, int* __restrict__ hub_count,
                     int num_segments) {
  using G = Geometry<T, D>;
  constexpr int kRows = G::kRowsPerLoad, kVals = G::kVals;
  constexpr int kLoadsPerChunk = 32 / kRows;
  constexpr int kU = kUnroll < kLoadsPerChunk ? kUnroll : kLoadsPerChunk;
  // bf16 at D = 32 (eight rows a load) has no register to spare: its chunk's
  // pairs of loads run as a loop, not unrolled
  constexpr int kPairUnroll = sizeof(T) == 2 && D == 32 ? 1 : kLoadsPerChunk / kU;
  const int lane = threadIdx.x & 31;
  if (warp_index() >= num_segments) return;
  const int seg = seg_order[warp_index()];
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
  // pos: the chunk's first edge; rem: the segment's edges from there on
  for (int pos = start, rem = n; rem > 0; pos += 32, rem -= 32) {
    const int c_cur = c_next;
    const float w_cur = w_next;  // 0 past the end of the segment
    c_next = 0;
    w_next = 0.f;
    if (32 + lane < rem) {
      c_next = __ldg(col + pos + 32 + lane);
      w_next = __ldg(val + pos + 32 + lane);
    }
#pragma unroll (kPairUnroll)
    for (int u0 = 0; u0 < kLoadsPerChunk; u0 += kU) {
      if (u0 * kRows < rem) {
        uint4 raw[kU];
        float w[kU];
#pragma unroll
        for (int u = 0; u < kU; ++u) {
          const int e = (u0 + u) * kRows + sub;  // within the chunk
          const int c = __shfl_sync(kFull, c_cur, e);
          w[u] = __shfl_sync(kFull, w_cur, e);
          raw[u] = make_uint4(0u, 0u, 0u, 0u);
          if (e < rem)
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
  // Where the segment goes, read by the storing lanes and handed round; the
  // segment is read again through a volatile pointer. Both keep the values
  // out of registers across the edge loop, which the bf16 instantiations
  // fill to the 32 (a hoisted load there spills).
  int target = 0, h = 0;
  if (sub == 0) {
    const volatile int* order = seg_order;
    target = seg_out[order[warp_index()]];
    if (target < 0) h = slot_hub[-(target + 1)];  // in flight beside the stores
    float* dst = (target >= 0 ? out + (int64_t)target * D
                              : partial + (int64_t)(-(target + 1)) * D) + part * kVals;
#pragma unroll
    for (int i = 0; i < kVals; i += 4)
      *reinterpret_cast<float4*>(dst + i) = make_float4(acc[i], acc[i + 1], acc[i + 2], acc[i + 3]);
  }
  target = __shfl_sync(kFull, target, 0);
  if (target >= 0) return;  // the whole warp: target is the segment's
  h = __shfl_sync(kFull, h, 0);
  const int first = hub_ptr[h], nseg = hub_ptr[h + 1] - first;
  __syncwarp();  // the storing lanes' partial row before lane 0's arrival
  int last = 0;
  if (lane == 0) {
    last = arrive(hub_count + h) == nseg - 1;
    if (last) hub_count[h] = 0;  // every arrival is in: clean for the next launch
  }
  if (!__shfl_sync(kFull, last, 0)) return;
  __syncwarp();  // lane 0's acquire before the other lanes' loads
  hub_finish<D>(partial + (int64_t)first * D, nseg, out + (int64_t)hub_row[h] * D, lane);
}

inline int blocks_for(int warps) { return (warps + kWarpsPerBlock - 1) / kWarpsPerBlock; }

template <typename T, int D>
int launch_segments(const int* seg_order, const int* seg_ptr, const int* seg_out,
                    const int* col, const float* val, const void* x, float* out,
                    float* partial, const int* slot_hub, const int* hub_ptr,
                    const int* hub_row, int* hub_count, int num_segments, cudaStream_t s) {
  spmm_segments_kernel<T, D><<<blocks_for(num_segments), kThreads, 0, s>>>(
      seg_order, seg_ptr, seg_out, col, val, static_cast<const T*>(x), out, partial,
      slot_hub, hub_ptr, hub_row, hub_count, num_segments);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Widths the kernels take.
int spmm_supports_dim(int D) { return D == 32 || D == 64 || D == 128; }

// x is (N, D) bf16 when x_is_bf16, else fp32; out and partial are fp32.
// hub_count is the (H,) int32 workspace of the stream's launches: zero before
// the launch and zero again after it.
int spmm_csr(const int* seg_order, const int* seg_ptr, const int* seg_out, const int* col,
             const float* val, const void* x, int x_is_bf16, float* out, float* partial,
             const int* slot_hub, const int* hub_ptr, const int* hub_row, int* hub_count,
             int num_segments, int D, void* stream) {
  if (num_segments <= 0) return (int)cudaGetLastError();
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define SPMM_LAUNCH(T, WIDTH)                                                             \
  return launch_segments<T, WIDTH>(seg_order, seg_ptr, seg_out, col, val, x, out, partial, \
                                   slot_hub, hub_ptr, hub_row, hub_count, num_segments, s)
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

}  // extern "C"
