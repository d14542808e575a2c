// Approximate top-k scan for Hopper (sm_90a): the scores of a query block
// against the catalog, fused with a per-bin maximum, in fp32 and in int8.
//
// Replaces jax.lax.approx_max_k as the JAX package calls it, at
// recsys_tpu/eval/recall.py:71 (fp32 scores: topk_scores(method="approx"))
// and recsys_tpu/ops/quant.py:74 (the int8 catalog: int8_topk(method=
// "approx")). That is XLA's TPU primitive, not a Pallas kernel: XLA fuses a
// partial reduce into the product's output, so that each of O bins keeps
// its maximum and only the O winners are sorted (Chern et al., "TPU-KNN",
// 2022). The semantics held here are those of ops/approx_topk.py:
//
//   s[b, c] = dot(u[b], items[c]) (+ prior[c]);  s[b, 0] = s[b, c >= n] = -inf
//   bin j of row b holds the columns j, j + O, j + 2O, ... (slices of O lanes)
//   out_val[b, j] = max of the bin,  out_col[b, j] = the lowest column holding it
//
// The (B, n) score matrix is never written. A block owns 128 queries x 128
// bins and walks the slices in column order; a later slice wins a bin only
// when strictly greater, so ties keep the lowest column. No atomics and a
// fixed order of every sum: two calls give the same bits.
//
// What bounds each scan on this card, and what the design does about it
// (B = 1,024, n = 1,000,001, D = 128, O = 2,048 bins: 2.6e11 operations
// against 0.5 GB of fp32 items; NVIDIA H100 80GB HBM3, 700 W, PERF.md §6):
//
//   * fp32 (approx_scan_f32_kernel): fp32 fused multiply-adds, the precision
//     of the port's exact path (no TF32, which would part the two paths);
//     each score one fmaf chain in k order, then + prior. Bound: the 67
//     TFLOP/s of the FP32 lanes, 3.9 ms. The lanes are fed from shared
//     memory, so the tile decides: 8 x 8 scores a thread (128 x 128 a block
//     of 256 threads) read 16 words for 64 multiply-adds, 4 a word, what an
//     SM's 32 shared words a clock sustain at 128 lanes. The item tiles come
//     through a ring of three cp.async stages (32 k deep, rows padded to 36
//     words so that the 16-byte reads of a warp fall in distinct banks), one
//     barrier a stage; up to D = 128 the block's queries are loaded once and
//     stay (beyond, they come with each item tile). The bins' running maxima
//     and their 16-bit slices live in shared memory, read and written once a
//     slice, so that the product keeps its 254 registers. Measured 7.4 ms at
//     1.98 GHz (58% of the FP32 lanes without the loads: 6.9 ms); cuBLAS's
//     fp32 product of the same operands alone takes 7.2 ms.
//   * int8 (approx_scan_int8_kernel): the product on the tensor cores,
//     wgmma m64n128k32 s8.s8 -> s32 (bound: 0.13 ms at 1,979 TOP/s). One warp
//     of a producer warpgroup fills a ring of up to eight 128-row x 128-byte
//     item tiles by TMA in the 128-byte swizzled layout wgmma reads (rows
//     whose pitch TMA cannot take, D % 16 != 0, through the warp's own loads,
//     zero-filled); the block's queries stay in shared memory. setmaxnreg
//     hands the producers' registers to the two consumer warpgroups of 64
//     queries each, which take turns at the tensor cores (named barriers),
//     so that one's bin epilogue runs beside the other's product. The
//     epilogue works on the int32 sums: one integer multiply-add packs
//     (sum, slice) into a key and one integer max keeps it; only the
//     winners are dequantized, float(acc) * alpha[b], at the end. The keys
//     equal the bins of the dequantized scores bit for bit where |sum| <
//     2^23 (D <= 511 at |int8| <= 128) and 2^-126 <= alpha[b] <= 1e30: two
//     different sums then stay apart after the multiply by alpha, and equal
//     sums stay equal. A block with a row that misses the premise (alpha
//     <= 0, say), and every block at D >= 512, keeps the dequantized scores
//     themselves, their slices in shared memory. Measured 0.44 ms. What
//     holds it there (scripts/torch_approx_ablation.py): the loop around
//     the product, 0.30 ms with neither the product nor the epilogue; the
//     product and the epilogue add 0.14 ms on top, the item loads nothing.
//
// Grid: the query blocks of one bin block are adjacent in the launch order,
// so that the blocks that read the same item rows run together. Where a
// catalog gives fewer blocks than the card has SMs (or a block's slices
// outgrow its 16-bit or packed slice numbers) the slices are split over
// `parts` blocks; each writes its bins to a workspace and a second launch
// merges them in part order, strictly greater winning, which is the rule of
// one block. One block an SM.
//
// Measured and not kept: the first design, one template for both modes, 64
// queries x 128 bins a block, 4 x 8 scores a thread from 16-deep tiles
// staged through registers with transposed stores, __dp4a for int8 (9.7 /
// 3.26 ms at 1M); the fp32 query tile streamed with every item tile at
// D = 128 (7.6 ms); a cluster of 2 or 4 query blocks sharing each item tile
// by TMA multicast (0.47 / 0.92 ms against 0.45: the loads do not bound
// it); two accumulators a warpgroup, the next slice's product under this
// one's epilogue (0.58 ms: ptxas serializes wgmma whose accumulators are
// read in flight); the producer spinning on test_wait (no change); a ring
// of 4 tiles (no change); per-thread epilogue modes (ptxas serializes wgmma
// on a divergent path).

#include <cuda.h>  // CUtensorMap and its enums; the encoder is looked up in libcuda at run time
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;  // queries a block
constexpr int kBN = 128;  // bins a block
// the largest slice count a part's 16-bit slice numbers hold
constexpr int kMaxPartSlices = 1 << 16;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, TMA, cp.async ------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   smem_addr(bar)), "r"(bytes)
               : "memory");
}
// the arrival of the threads where `pred` is set (a predicated instruction,
// not a branch: the consumers' code stays free of divergent paths)
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %1, 0;\n@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(smem_addr(bar)), "r"(static_cast<int>(pred))
      : "memory");
}
// the wait loop inside one asm block, so that the code around it stays free of
// divergent paths for the compiler
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_addr(bar)), "r"(parity)
      : "memory");
}
// a (128 bytes x 128 rows) box at (x, y) of `map` into `dst`, completing on `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int x, int y,
                                         uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(x), "r"(y)
      : "memory");
}
// 16 bytes (4 bytes) from src, zero-filled past `bytes` (0 reads nothing)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// the slices [t_begin, t_end) of part `part` for a block whose bins start at j0
struct SliceRange {
  int begin, count;
};
__device__ __forceinline__ SliceRange slice_range(int j0, int n, int O, int part, int L) {
  // the slices in which some bin of this block holds a real column
  const long long last = j0 < n ? (static_cast<long long>(n) - j0 + O - 1) / O : 0;
  const long long begin = static_cast<long long>(part) * L;
  const long long end = min(last, begin + L);
  return {static_cast<int>(begin), static_cast<int>(max(0LL, end - begin))};
}

// ============================== fp32 ==========================================

namespace f32 {
constexpr int kThreads = 256;
constexpr int kBK = 32;            // k a stage
constexpr int kLD = kBK + 4;       // words a staged row: 16-byte reads of 8 rows hit 8 bank groups
constexpr int kStages = 3;
constexpr int kMaxResident = 128;  // widths whose query tile stays in shared memory
constexpr int kResLD = kMaxResident + 4;  // its row, in words: the same bank groups
constexpr int kBinLD = kBN + 8;    // words a row of the bins' maxima: a warp's 4 x 8 are 32 banks
// kResident: the query tile once, then item tiles a stage; else both tiles a stage
template <bool kResident> struct Layout {
  static constexpr int kStageFloats = (kResident ? 1 : 2) * kBM * kLD;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((kResident ? (size_t)kBM * kResLD : 0) + (size_t)kStages * kStageFloats +
                       (size_t)kBM * kBinLD) +
      sizeof(uint16_t) * (size_t)kBM * kBinLD;
};
}  // namespace f32

// One block: queries [q0, q0 + 128) x bins [j0, j0 + 128), the slices of its
// part. Thread (TY, TX) of 16 x 16 (a warp 4 x 8 of them) holds the scores
// of queries TY + 16 i and bins TX + 16 j, i, j < 8. kResident (D <= 128):
// the queries are loaded once and stay; else they come with each item tile.
template <bool kResident>
__global__ void __launch_bounds__(f32::kThreads, 1)
approx_scan_f32_kernel(const float* __restrict__ u, const float* __restrict__ items,
                       const float* __restrict__ prior, int B, int n, int D, int O, int L,
                       int qblocks, bool vec, float* __restrict__ out_val,
                       int* __restrict__ out_col) {
  using namespace f32;
  constexpr int kStageFloats = Layout<kResident>::kStageFloats;
  constexpr int kLdA = kResident ? kResLD : kLD;  // the query tile's row, in words
  extern __shared__ __align__(16) float smem_f[];
  float* resident = smem_f;
  float* stages = resident + (kResident ? kBM * kResLD : 0);
  float* best = stages + kStages * kStageFloats;
  uint16_t* bslice = reinterpret_cast<uint16_t*>(best + kBM * kBinLD);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int TY = (warp >> 1) * 4 + (lane >> 3), TX = (warp & 1) * 8 + (lane & 7);
  const int qb = blockIdx.x % qblocks, bb = blockIdx.x / qblocks;
  const int q0 = qb * kBM, j0 = bb * kBN, part = blockIdx.y;
  const SliceRange sr = slice_range(j0, n, O, part, L);
  const int ktiles = (D + kBK - 1) / kBK;
  const int steps = sr.count * ktiles;

#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      best[(TY + 16 * i) * kBinLD + TX + 16 * j] = -INFINITY;
      bslice[(TY + 16 * i) * kBinLD + TX + 16 * j] = 0;
    }

  // 32 k of 128 rows of a (rows, D) matrix from row r0 and k0 into `dst` (row
  // stride ld words), zero past D and past the rows
  auto load = [&](float* dst, int ld, const float* m, long long r0, long long rows, int k0) {
    if (vec) {
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int e = tid + kThreads * t, r = e >> 3, k = k0 + 4 * (e & 7);
        const bool in = k < D && r0 + r < rows;
        cp_async16(dst + r * ld + 4 * (e & 7), in ? m + (r0 + r) * D + k : m, in ? 16 : 0);
      }
    } else {
      for (int e = tid; e < kBM * kBK; e += kThreads) {
        const int r = e / kBK, k = k0 + e % kBK;
        const bool in = k < D && r0 + r < rows;
        cp_async4(dst + r * ld + e % kBK, in ? m + (r0 + r) * D + k : m, in ? 4 : 0);
      }
    }
  };
  // step s: slice sr.begin + s / ktiles, k from (s % ktiles) * kBK
  auto fetch = [&](int s) {
    if (s >= steps) return;
    float* st = stages + (s % kStages) * kStageFloats;
    const int k0 = (s % ktiles) * kBK;
    load(st, kLD, items, static_cast<long long>(sr.begin + s / ktiles) * O + j0, n, k0);
    if (!kResident) load(st + kBM * kLD, kLD, u, q0, B, k0);
  };
  if (kResident && steps > 0)
    for (int kt = 0; kt < ktiles; ++kt) load(resident + kt * kBK, kResLD, u, q0, B, kt * kBK);
  fetch(0);
  cp_async_commit();
  fetch(1);
  cp_async_commit();

  float acc[8][8];
  float pr[8];
  for (int s = 0; s < steps; ++s) {
    cp_async_wait1();
    __syncthreads();  // stage s landed for all; stage s - 1 is read by all
    fetch(s + 2);
    cp_async_commit();
    const int kt = s % ktiles, tl = s / ktiles;
    const long long cbase = static_cast<long long>(sr.begin + tl) * O + j0;
    if (kt == 0) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
    }
    if (kt == ktiles - 1) {  // the slice's prior, in flight under the last tile
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const long long c = cbase + TX + 16 * j;
        pr[j] = (prior != nullptr && c < n) ? __ldg(prior + c) : 0.f;
      }
    }
    const float* Bs = stages + (s % kStages) * kStageFloats;
    const float* As = kResident ? resident + kt * kBK : Bs + kBM * kLD;
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 a[8], b[8];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        a[i] = *reinterpret_cast<const float4*>(As + (TY + 16 * i) * kLdA + kk);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        b[j] = *reinterpret_cast<const float4*>(Bs + (TX + 16 * j) * kLD + kk);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }
    if (kt != ktiles - 1) continue;
    // the slice is summed: its scores into the bins' maxima
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bin = j0 + TX + 16 * j;
      const long long c = cbase + TX + 16 * j;
      const bool real = bin < O && c < n && c != 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float sc = real ? acc[i][j] + pr[j] : -INFINITY;
        const int at = (TY + 16 * i) * kBinLD + TX + 16 * j;
        if (sc > best[at]) {  // strictly: equal scores keep the lower column
          best[at] = sc;
          bslice[at] = static_cast<uint16_t>(tl);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = q0 + TY + 16 * i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int bin = j0 + TX + 16 * j;
      if (bin >= O) continue;
      const int at = (TY + 16 * i) * kBinLD + TX + 16 * j;
      const long long o = (static_cast<long long>(part) * B + row) * O + bin;
      out_val[o] = best[at];
      out_col[o] = static_cast<int>(static_cast<long long>(sr.begin + bslice[at]) * O + bin);
    }
  }
}

// ============================== int8 ==========================================

namespace i8 {
constexpr int kConsumers = 256;              // two warpgroups of 64 queries
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup (one warp works)
// registers a thread after setmaxnreg: 128 x 40 + 256 x 232 = 64,512 <= 65,536
constexpr int kProducerRegs = 40, kConsumerRegs = 232;
constexpr int kTile = kBM * 128;             // 128 rows x 128 bytes (one swizzle atom wide)
constexpr int kMaxStages = 8;
constexpr int kMaxResident = 6;              // k chunks of the queries kept in shared memory
// the dequantized-score path's 16-bit slice numbers: 64 a consumer thread
constexpr int kSliceBytes = kConsumers * 64 * 2;
constexpr size_t kSmemLimit = 227 * 1024;
}  // namespace i8

struct Int8Plan {
  int kc;          // 128-byte chunks of k
  int resident;    // the queries' chunks stay in shared memory (else each stage brings its own)
  int stages;     // at least kc: the two warpgroups take turns; else each as its tiles land
  int shift;       // bits of the slice in a packed key; 0: no integer keys at this width
  size_t smem;
};

// The largest s with (max |sum| + 1) * 2^s <= 2^31, max |sum| = D * 128^2, where
// max |sum| < 2^23; else 0 (the dequantized scores are kept).
int int_key_shift(int D) {
  const long long maxabs = static_cast<long long>(D) * 128 * 128;
  if (maxabs >= (1LL << 23)) return 0;
  int s = 0;
  while (((maxabs + 1) << (s + 1)) <= (1LL << 31)) ++s;
  return s;
}

Int8Plan int8_plan(int D) {
  Int8Plan p;
  p.kc = (D + 127) / 128;
  p.resident = p.kc <= i8::kMaxResident;
  p.shift = int_key_shift(D);
  const size_t fixed = 1024 + (p.resident ? (size_t)p.kc * i8::kTile : 0) + i8::kSliceBytes +
                       kBM * sizeof(float) + (2 * i8::kMaxStages + 1) * sizeof(uint64_t);
  const size_t stage = (p.resident ? 1 : 2) * (size_t)i8::kTile;
  p.stages = static_cast<int>(min((size_t)i8::kMaxStages, (i8::kSmemLimit - fixed) / stage));
  p.smem = fixed + stage * p.stages;
  return p;
}

// the descriptor of a K-major operand in the 128-byte swizzled layout at `p`
// (rows of 128 bytes, 8-row atoms of 1024 bytes, 1024-byte aligned; a k step
// of 32 bytes advances the start address inside the atom)
__device__ __forceinline__ uint64_t wgmma_desc(const void* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 128 s32, this thread's 64) = A (64 x 32 s8) * B (128 x 32 s8)^T (+ d)
__device__ __forceinline__ void wgmma_s8(int (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p;\n}\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]), "+r"(d[6]),
        "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]), "+r"(d[11]), "+r"(d[12]),
        "+r"(d[13]), "+r"(d[14]), "+r"(d[15]), "+r"(d[16]), "+r"(d[17]), "+r"(d[18]),
        "+r"(d[19]), "+r"(d[20]), "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]),
        "+r"(d[25]), "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),
        "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]), "+r"(d[36]),
        "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]), "+r"(d[41]), "+r"(d[42]),
        "+r"(d[43]), "+r"(d[44]), "+r"(d[45]), "+r"(d[46]), "+r"(d[47]), "+r"(d[48]),
        "+r"(d[49]), "+r"(d[50]), "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]),
        "+r"(d[55]), "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),
        "+r"(d[61]), "+r"(d[62]), "+r"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving accumulator registers across the async
// wgmma pipeline
__device__ __forceinline__ void fence_acc(int (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// the consumer warpgroups' turns at the tensor cores (named barriers 1 and 2)
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(i8::kConsumers) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "n"(i8::kConsumers) : "memory");
}


// The producer warp's own copy of a (128 rows x 128 bytes) box at byte k0 of
// rows [r0, r0 + 128) of the (rows, D) int8 matrix m into the swizzled tile
// `dst` (the 16-byte chunk c of row r at c ^ (r % 8)), zero past D and past
// the rows: the path of the widths whose row pitch TMA cannot take.
__device__ __forceinline__ void copy_tile(uint8_t* dst, const int8_t* __restrict__ m,
                                          long long r0, long long rows, int D, int k0,
                                          bool words, int lane) {
  for (int e = lane; e < kBM * 32; e += 32) {
    const int r = e >> 5, w = e & 31, kb = k0 + 4 * w;
    uint32_t v = 0;
    if (r0 + r < rows && kb < D) {
      const int8_t* p = m + (r0 + r) * D + kb;
      if (words && kb + 4 <= D) {
        v = __ldg(reinterpret_cast<const uint32_t*>(p));
      } else {
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (kb + b < D) v |= (static_cast<uint32_t>(static_cast<uint8_t>(p[b]))) << (8 * b);
      }
    }
    const int chunk = (w >> 2) ^ (r & 7);
    *reinterpret_cast<uint32_t*>(dst + r * 128 + chunk * 16 + (w & 3) * 4) = v;
  }
}

struct Int8Args {
  const int8_t* uq;
  const int8_t* q;
  const float* alpha;
  int B, n, D, O, L, qblocks;
  int kc, resident, stages, shift, tma, words;
  float* out_val;
  int* out_col;
};

// One block: queries [q0, q0 + 128) x bins [j0, j0 + 128), the slices of its
// part. Warps 0-7 are two consumer warpgroups (queries 64 w ... 64 w + 63);
// warp 8 is the producer (warps 9-11 fill its warpgroup, whose registers
// setmaxnreg hands to the consumers). wgmma's accumulator: warp m of a warpgroup, lane
// (g, t) = (lane / 4, lane % 4) holds rows 16 m + g (+ 8) and columns
// 8 (i / 4) + 2 t (+ 1) of the 64 x 128 tile as d[i]. The consumers' code
// has no divergent path (roles and modes are uniform, single-thread work is
// predicated), which would make ptxas serialize the wgmma.
__global__ void __launch_bounds__(i8::kThreads, 1)
approx_scan_int8_kernel(const __grid_constant__ CUtensorMap map_u,
                        const __grid_constant__ CUtensorMap map_q, const Int8Args a) {
  using namespace i8;
  extern __shared__ __align__(16) uint8_t smem_i[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_i) + 1023) & ~static_cast<uintptr_t>(1023));
  uint8_t* a_tiles = smem;
  uint8_t* ring = smem + (a.resident ? a.kc : 0) * kTile;
  const int stage_bytes = (a.resident ? 1 : 2) * kTile;
  uint16_t* fslice = reinterpret_cast<uint16_t*>(ring + a.stages * stage_bytes);
  float* s_alpha = reinterpret_cast<float*>(fslice + kSliceBytes / 2);  // the block's rows'
  uint64_t* full = reinterpret_cast<uint64_t*>(s_alpha + kBM);
  uint64_t* empty = full + kMaxStages;
  uint64_t* a_full = empty + kMaxStages;

  const int tid = threadIdx.x, lane = tid & 31;
  const int warp = __shfl_sync(0xffffffffu, tid >> 5, 0);  // uniform for the compiler
  const int qb = blockIdx.x % a.qblocks, bb = blockIdx.x / a.qblocks;
  const int q0 = qb * kBM, j0 = bb * kBN, part = blockIdx.y;
  const SliceRange sr = slice_range(j0, a.n, a.O, part, a.L);
  const int steps = sr.count * a.kc;
  const int wg = warp >> 2, g = lane >> 2, t4 = lane & 3;
  const int rloc = 64 * wg + 16 * (warp & 3) + g;  // a consumer's rows: rloc, rloc + 8

  // the packed keys' premise, for the whole block: every row's alpha in
  // [2^-126, 1e30] (NaN fails) at a width that has integer keys
  bool ok = true;
  if (tid < kBM) {
    const float al = q0 + tid < a.B ? __ldg(a.alpha + q0 + tid) : 1.f;
    s_alpha[tid] = al;
    ok = al >= 1.17549435e-38f && al <= 1e30f;
  }
  if (tid == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    mbar_init(a_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  const bool ikey = __shfl_sync(0xffffffffu, __syncthreads_and(ok), 0) && a.shift > 0;

  if (warp >= kConsumers / 32) {
    // ---- the producer: the queries once, then (slice, k chunk) item tiles ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (warp != kConsumers / 32 || steps == 0) return;
    if (a.tma) {
      if (lane != 0) return;
      if (a.resident) {
        mbar_expect_tx(a_full, a.kc * kTile);
        for (int c = 0; c < a.kc; ++c) tma_load(a_tiles + c * kTile, &map_u, 128 * c, q0, a_full);
      }
      for (int s = 0; s < steps; ++s) {
        const int st = s % a.stages, round = s / a.stages;
        if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
        const int c = s % a.kc;
        const long long row = static_cast<long long>(sr.begin + s / a.kc) * a.O + j0;
        uint8_t* dst = ring + st * stage_bytes;
        mbar_expect_tx(full + st, stage_bytes);
        tma_load(dst, &map_q, 128 * c, static_cast<int>(row), full + st);
        if (!a.resident) tma_load(dst + kTile, &map_u, 128 * c, q0, full + st);
      }
    } else {
      if (a.resident) {
        for (int c = 0; c < a.kc; ++c)
          copy_tile(a_tiles + c * kTile, a.uq, q0, a.B, a.D, 128 * c, a.words, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        mbar_arrive_if(a_full, lane == 0);
      }
      for (int s = 0; s < steps; ++s) {
        const int st = s % a.stages, round = s / a.stages;
        if (round > 0) mbar_wait(empty + st, (round - 1) & 1);
        const int c = s % a.kc;
        const long long row = static_cast<long long>(sr.begin + s / a.kc) * a.O + j0;
        uint8_t* dst = ring + st * stage_bytes;
        copy_tile(dst, a.q, row, a.n, a.D, 128 * c, a.words, lane);
        if (!a.resident) copy_tile(dst + kTile, a.uq, q0, a.B, a.D, 128 * c, a.words, lane);
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        __syncwarp();
        mbar_arrive_if(full + st, lane == 0);
      }
    }
    return;
  }

  // ---- the consumers ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  // ikey: packed keys sum * 2^shift + (2^shift - 1 - slice), INT_MIN for
  // nothing; else the dequantized scores' bits, their slices in fslice
  // ([i][consumer thread], 16 bits)
  const int mul = 1 << a.shift, top = mul - 1;
  int key[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) key[i] = ikey ? INT_MIN : __float_as_int(-INFINITY);
  if (!ikey) {
#pragma unroll
    for (int i = 0; i < 64; ++i) fslice[i * kConsumers + tid] = 0;
  }
  // with a ring that holds a slice's tiles, the warpgroups take turns at the tensor cores
  const bool turns = a.stages >= a.kc;

  if (a.resident && steps > 0) mbar_wait(a_full, 0);
  int acc[64];
  for (int tl = 0; tl < sr.count; ++tl) {
    if (turns && wg == 0 && tl > 0) named_sync(2);
    if (turns && wg == 1) named_sync(1);
    for (int c = 0; c < a.kc; ++c) {
      const int s = tl * a.kc + c, st = s % a.stages;
      mbar_wait(full + st, (s / a.stages) & 1);
      const uint8_t* bt = ring + st * stage_bytes;
      const uint8_t* at = (a.resident ? a_tiles + c * kTile : bt + kTile) + wg * 64 * 128;
      const int ks = min(4, (a.D - 128 * c + 31) / 32);
      fence_acc(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      if (ks == 4) {  // a whole chunk: the common case, unrolled
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wgmma_s8(acc, wgmma_desc(at + 32 * k), wgmma_desc(bt + 32 * k), (c | k) != 0);
      } else {
        for (int k = 0; k < ks; ++k)
          wgmma_s8(acc, wgmma_desc(at + 32 * k), wgmma_desc(bt + 32 * k), (c | k) != 0);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      if (c > 0) {  // the previous chunk's tile is read: give it back
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        mbar_arrive_if(empty + (s - 1) % a.stages, lane == 0);
      }
    }
    if (turns && wg == 0) named_arrive(1);
    if (turns && wg == 1 && tl + 1 < sr.count) named_arrive(2);
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_acc(acc);
    mbar_arrive_if(empty + (tl * a.kc + a.kc - 1) % a.stages, lane == 0);

    // the slice's scores into the bins; column cbase + x is real where x < lim
    // and not the PAD column
    const long long cbase = static_cast<long long>(sr.begin + tl) * a.O + j0;
    const bool pad = cbase == 0;
    const int lim = static_cast<int>(min(static_cast<long long>(kBN), a.n - cbase));
    if (ikey) {
      const int low = top - tl;
      if (!pad && lim == kBN) {
#pragma unroll
        for (int i = 0; i < 64; ++i) key[i] = max(key[i], acc[i] * mul + low);
      } else {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int x = 8 * (i >> 2) + 2 * t4 + (i & 1);
          key[i] = max(key[i], (x < lim && !(pad && x == 0)) ? acc[i] * mul + low : INT_MIN);
        }
      }
    } else {
      const float al[2] = {s_alpha[rloc], s_alpha[rloc + 8]};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int x = 8 * (i >> 2) + 2 * t4 + (i & 1);
        const float sc = (x < lim && !(pad && x == 0))
                             ? __int2float_rn(acc[i]) * al[(i >> 1) & 1] : -INFINITY;
        // strictly: equal scores keep the lower column
        const bool take = sc > __int_as_float(key[i]);
        key[i] = take ? __float_as_int(sc) : key[i];
        if (take) fslice[i * kConsumers + tid] = static_cast<uint16_t>(tl);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int row = q0 + rloc + 8 * ((i >> 1) & 1);
    const int bin = j0 + 8 * (i >> 2) + 2 * t4 + (i & 1);
    float v;
    int tl;
    if (ikey) {
      const bool none = key[i] == INT_MIN;
      v = none ? -INFINITY : __int2float_rn(key[i] >> a.shift) * s_alpha[row - q0];
      tl = none ? 0 : top - (key[i] & top);
    } else {
      v = __int_as_float(key[i]);
      tl = fslice[i * kConsumers + tid];
    }
    if (row < a.B && bin < a.O) {
      const long long o = (static_cast<long long>(part) * a.B + row) * a.O + bin;
      a.out_val[o] = v;
      a.out_col[o] = static_cast<int>(static_cast<long long>(sr.begin + tl) * a.O + bin);
    }
  }
}

// ============================== the parts' merge ================================

// out[e] = the first of parts[p][e], p = 0 .. P - 1, that no later one beats
// strictly: the bins' rule across the parts, which hold the slices in order
__global__ void merge_parts_kernel(const float* __restrict__ wv, const int* __restrict__ wc,
                                   int parts, long long count, float* __restrict__ out_val,
                                   int* __restrict__ out_col) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < count;
       e += (long long)gridDim.x * blockDim.x) {
    float v = wv[e];
    int c = wc[e];
    for (int p = 1; p < parts; ++p) {
      const float w = wv[p * count + e];
      if (w > v) {
        v = w;
        c = wc[p * count + e];
      }
    }
    out_val[e] = v;
    out_col[e] = c;
  }
}

// ============================== host side =======================================

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

struct Grid {
  int qblocks, binblocks, S, parts, L;
};

// the launch's shape, or an error for sizes outside what the kernels index
cudaError_t grid_of(int int8_mode, int B, int n, int D, int O, int slices, Grid* g) {
  if (B < 0 || n < 1 || D < 1 || O < 1 || slices < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(O) * slices < n) return cudaErrorInvalidValue;
  if (static_cast<long long>(O) * slices > INT32_MAX) return cudaErrorInvalidValue;
  const long long qblocks = (static_cast<long long>(B) + kBM - 1) / kBM;
  const long long binblocks = (static_cast<long long>(O) + kBN - 1) / kBN;
  if (qblocks > 65535 || qblocks * binblocks > INT32_MAX) return cudaErrorInvalidValue;
  g->qblocks = static_cast<int>(qblocks);
  g->binblocks = static_cast<int>(binblocks);
  // the slices that hold a column; a part holds at most `cap` of them
  g->S = static_cast<int>((static_cast<long long>(n) + O - 1) / O);
  int cap = kMaxPartSlices;
  if (int8_mode) {
    const int shift = int_key_shift(D);
    if (shift > 0) cap = min(cap, 1 << shift);
  }
  int parts = (g->S + cap - 1) / cap;
  // a short grid: 2-4 parts where that leaves fewer rounds of slices on the SMs
  // (a block a SM); equal costs keep fewer parts
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const long long blocks = qblocks * binblocks;
  if (blocks * parts < sms) {
    long long best_cost = -1;
    int best = parts;
    for (int p = parts; p <= max(parts, 4); ++p) {
      const long long waves = (blocks * p + sms - 1) / sms;
      const long long cost = waves * ((g->S + p - 1) / p);
      if (best_cost < 0 || cost < best_cost) {
        best_cost = cost;
        best = p;
      }
    }
    parts = best;
  }
  g->L = (g->S + parts - 1) / parts;
  g->parts = (g->S + g->L - 1) / g->L;  // no empty part
  if (g->parts > 65535) return cudaErrorInvalidValue;
  return cudaSuccess;
}

// the bins of each part into the workspace, merged into out; or into out
cudaError_t finish(const Grid& g, int B, int O, float* ws_val, int* ws_col, float* out_val,
                   int* out_col, cudaStream_t stream) {
  if (g.parts == 1) return cudaGetLastError();
  const long long count = static_cast<long long>(B) * O;
  const int threads = 256;
  const long long blocks = min((count + threads - 1) / threads, 65535LL * 8);
  merge_parts_kernel<<<static_cast<unsigned>(blocks), threads, 0, stream>>>(
      ws_val, ws_col, g.parts, count, out_val, out_col);
  return cudaGetLastError();
}

// the fp32 kernel for width D and its shared memory
typedef void (*F32Kernel)(const float*, const float*, const float*, int, int, int, int, int, int,
                          bool, float*, int*);
struct F32Launch {
  F32Kernel kernel;
  size_t smem;
};
F32Launch f32_launch(int D) {
  if (D <= f32::kMaxResident)
    return {approx_scan_f32_kernel<true>, f32::Layout<true>::kSmemBytes};
  return {approx_scan_f32_kernel<false>, f32::Layout<false>::kSmemBytes};
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) != cudaSuccess)
      return nullptr;
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q) !=
        cudaSuccess)
      return nullptr;
#endif
    if (q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (rows, D) int8 matrix as 128-byte x 128-row boxes in the 128-byte swizzle,
// zero past its edges
bool int8_map(CUtensorMap* map, const void* base, long long rows, int D) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D)};
  const cuuint32_t box[2] = {128, kBM};
  const cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

extern "C" {

// The number of parts a scan's slices are split over (1: no workspace), or
// minus a cudaError_t for a size the kernels do not take. int8_mode: 0 for
// approx_scan_f32, 1 for approx_scan_int8. The workspace of a split scan is
// (parts, B, O) fp32 values and int32 columns.
int approx_scan_parts(int int8_mode, int B, int n, int D, int O, int slices) {
  Grid g;
  const cudaError_t err = grid_of(int8_mode, B, n, D, O, slices, &g);
  return err == cudaSuccess ? g.parts : -static_cast<int>(err);
}

// Blocks of the scan that fit on an SM at width D (its registers and shared
// memory), or minus a cudaError_t.
int approx_scan_blocks_per_sm(int int8_mode, int D) {
  int blocks = 0;
  cudaError_t err;
  if (int8_mode) {
    const Int8Plan p = int8_plan(D);
    err = cudaFuncSetAttribute(approx_scan_int8_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, approx_scan_int8_kernel,
                                                          i8::kThreads, p.smem);
  } else {
    const F32Launch f = f32_launch(D);
    err = cudaFuncSetAttribute(f.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f.smem);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, f.kernel, f32::kThreads,
                                                          f.smem);
  }
  return err == cudaSuccess ? blocks : -static_cast<int>(err);
}

// Every pointer is a contiguous device array: u (B, D) fp32, items (n, D)
// fp32, prior (n,) fp32 or null, out_val / out_col (B, O) fp32 / int32, and
// where approx_scan_parts gives parts > 1 the workspace ws_val / ws_col
// (parts, B, O). Returns the cudaError_t of the launches; a call with no
// queries launches nothing.
int approx_scan_f32(const void* u, const void* items, const void* prior, int B, int n, int D,
                    int O, int slices, int parts, void* ws_val, void* ws_col, void* out_val,
                    void* out_col, void* stream) {
  Grid g;
  cudaError_t err = grid_of(0, B, n, D, O, slices, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts != g.parts || (g.parts > 1 && (ws_val == nullptr || ws_col == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const F32Launch f = f32_launch(D);
  err = cudaFuncSetAttribute(f.kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)f.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool vec = D % 4 == 0 && aligned16(u) && aligned16(items);
  float* ov = static_cast<float*>(g.parts > 1 ? ws_val : out_val);
  int* oc = static_cast<int*>(g.parts > 1 ? ws_col : out_col);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  f.kernel<<<dim3(g.qblocks * g.binblocks, g.parts), f32::kThreads, f.smem, st>>>(
      static_cast<const float*>(u), static_cast<const float*>(items),
      static_cast<const float*>(prior), B, n, D, O, g.L, g.qblocks, vec, ov, oc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(g, B, O, static_cast<float*>(ws_val), static_cast<int*>(ws_col),
                                 static_cast<float*>(out_val), static_cast<int*>(out_col), st));
}

// uq (B, D) int8, q (n, D) int8, alpha (B,) fp32; out_val (B, O) fp32 (the
// dequantized scores' bins), out_col (B, O) int32; the workspace as above.
int approx_scan_int8(const void* uq, const void* q, const void* alpha, int B, int n, int D,
                     int O, int slices, int parts, void* ws_val, void* ws_col, void* out_val,
                     void* out_col, void* stream) {
  Grid g;
  cudaError_t err = grid_of(1, B, n, D, O, slices, &g);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (alpha == nullptr || parts != g.parts ||
      (g.parts > 1 && (ws_val == nullptr || ws_col == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const Int8Plan p = int8_plan(D);
  err = cudaFuncSetAttribute(approx_scan_int8_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)p.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  Int8Args a;
  a.uq = static_cast<const int8_t*>(uq);
  a.q = static_cast<const int8_t*>(q);
  a.alpha = static_cast<const float*>(alpha);
  a.B = B;
  a.n = n;
  a.D = D;
  a.O = O;
  a.L = g.L;
  a.qblocks = g.qblocks;
  a.kc = p.kc;
  a.resident = p.resident;
  a.stages = p.stages;
  a.shift = p.shift;
  a.words = D % 4 == 0 && (reinterpret_cast<uintptr_t>(uq) & 3) == 0 &&
            (reinterpret_cast<uintptr_t>(q) & 3) == 0;
  CUtensorMap map_u{}, map_q{};
  a.tma = D % 16 == 0 && aligned16(uq) && aligned16(q) && int8_map(&map_u, uq, B, D) &&
          int8_map(&map_q, q, n, D);
  a.out_val = static_cast<float*>(g.parts > 1 ? ws_val : out_val);
  a.out_col = static_cast<int*>(g.parts > 1 ? ws_col : out_col);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  approx_scan_int8_kernel<<<dim3(g.qblocks * g.binblocks, g.parts), i8::kThreads, p.smem, st>>>(
      map_u, map_q, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(finish(g, B, O, static_cast<float*>(ws_val), static_cast<int*>(ws_col),
                                 static_cast<float*>(out_val), static_cast<int*>(out_col), st));
}

}  // extern "C"
