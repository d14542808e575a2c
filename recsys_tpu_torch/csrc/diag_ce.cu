// Fused in-batch contrastive cross-entropy for Hopper (sm_90a): fp32 in and
// out, the products on the tensor cores at fp32 accuracy.
//
// Replaces the TPU kernels recsys_tpu/ops/pallas_contrastive.py:
// _fwd_kernel (forward) and _bwd_kernel (backward). Per row i:
//
//   logit_ij = (q_i . k_j) * inv_temp - corr_j
//   logit_ij = -3e4  where j != i and (pos_j == pos_i or usr_j == usr_i
//                                      or valid_j == 0)
//   lse_i    = logsumexp_j logit_ij,   loss_i = lse_i - logit_ii
//
// and the backward, with g_i = dL/dloss_i and P = exp(logit - lse):
//
//   dlogit_ij = (P_ij - [i == j]) * g_i * inv_temp   (0 where forbidden)
//   dq_i = sum_j dlogit_ij k_j,   dk_j = sum_i dlogit_ij q_i
//
// What bounds it: operations. A call reads O(B * D) bytes and does
// O(B^2 * D) multiply-adds, and the (B, B) logits never reach device memory.
// On the CUDA cores every multiply-add read both operands from shared
// memory; here the products are mma.sync.aligned.m16n8k8 (tf32 inputs, fp32
// accumulators) on the tensor cores.
//
// Accuracy. q and k are fp32 in the TPU kernel, 1 / tau is 12.5, and the
// tolerances are its suite's: loss 1e-4, gradients 1e-5. One TF32 product
// (10 mantissa bits: a relative 2^-11 per operand, ~6e-3 on a logit of 12.5)
// misses both. So every operand is split, x = hi + lo with hi = x rounded to
// the 19 bits the tensor cores read and lo = x - hi cut to 19 bits, and each
// product is three:
//
//   a * b ~= lo_a * hi_b + hi_a * lo_b + hi_a * hi_b     (fp32 accumulators)
//
// which leaves lo_a * lo_b and the cut of lo, a relative ~2^-21 per term:
// ~1e-5 on a logit in the worst case, 2e-6 measured, and below 1e-7 on a
// gradient entry of size 1e-1. All three terms are used in both products of
// the backward (logits again, then dlogits times rows): with per-row
// upstream gradients of size ~1 the second product's terms reach ~30, and two
// terms would leave 2^-11 of that. The split is integer work (add half an
// ulp, mask; subtract, mask): cvt.rna.tf32.f32 gives the same hi but goes
// through the slower conversion unit, and the kernel splits the owned rows
// at every k-step. exp is __expf (ex2.approx): a relative ~5e-6 at |x| = 30, inside
// both tolerances. tests/test_torch_tf32_split.py repeats the arithmetic in
// numpy against fp64.
//
// Design. The TPU kernel kept the whole (B, D) key matrix in VMEM; a Hopper
// block has 227 KB of shared memory, so one templated kernel runs in three
// modes, each block owning OWN indices and streaming tiles of 64 from the
// other side through shared memory:
//
//   fwd : owns rows, streams key tiles, online softmax (running max / sum)
//   dq  : owns rows, streams key tiles, recomputes P from the saved lse
//   dk  : owns key columns, streams row tiles; the sum over rows stays
//         inside the block, so dk is deterministic and needs no atomics.
//
//   * A block is 8 warps laid out WM x WN: a warp owns 16 of the block's
//     rows and 64 / WN of the tile's columns. Its 16 x (64 / WN) logits are
//     mma accumulators; the mask, the online softmax (fwd) or dlogit (dq, dk)
//     are computed on those fragments in registers, with the metadata of the
//     lane's two owned indices held in registers and that of a streamed index
//     read as one 16-byte word.
//   * The second product of dq / dk takes the dlogit fragments straight as
//     its A operand: an m16n8 accumulator holds (row, 2t), (row, 2t + 1) where
//     the A operand of m16n8k8 wants (row, t), (row, t + 4), so the streamed
//     index is permuted inside each group of 8 (k-slot t <-> 2t, t + 4 <->
//     2t + 1) and the B fragments are read under the same permutation. With a
//     row stride of D + 4 floats both products read shared memory free of
//     bank conflicts.
//   * The three terms of a product are issued term by term across the warp's
//     accumulators, so that consecutive mma instructions do not wait for one
//     another.
//   * The streamed tile is split into hi and lo planes once, as it is
//     stored (eight 16-byte loads in flight per thread, 16-byte stores); the
//     owned rows are split as their fragments are loaded (once per 8 values
//     of depth, shared by the warp's column tiles).
//   * Large batches (B >= 4096): OWN = 64 (4 x 2 warps), so the other side is
//     streamed B / 64 times instead of B / 16. Small batches: OWN = 16 (1 x 8
//     warps), B / 16 blocks, so that B = 192 ... 768 still spreads over
//     12 ... 48 SMs and a block's 8 warps share each tile.
//   * The WN column groups are merged at the end through shared memory in
//     warp order: running max / sum / diagonal (fwd), partial dq / dk rows
//     (bwd). Fixed order, so two calls give the same bits.
//
// Measured on the card at B = 8192, D = 128 and not kept: holding the next
// tile's rows in registers while this one is multiplied (5% slower), and 32
// owned rows a block with two blocks resident per SM (forward 5% slower,
// backward 4% faster). A block's phases (load and split, first product, mask
// and softmax, second product) run one after another and their times add up;
// wgmma with a producer warp that overlaps them is the route to a faster
// version.
//
// Nothing is padded in device memory: indices >= B are masked, widths up to
// 256 are zero-filled in shared memory to 128 or 256.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr int kLargeB = 4096;  // from here a block owns 64 indices, below 16
constexpr float kNeg = -3.0e4f;

enum Mode { kFwd = 0, kDq = 1, kDk = 2 };

// WM x WN warps; 16 * WM owned indices; tiles of STR streamed indices; widths
// up to 8 * DT.
template <int WM_, int WN_, int DT_>
struct Tile {
  static constexpr int WM = WM_, WN = WN_, DT = DT_;
  static constexpr int OWN = 16 * WM;
  static constexpr int STR = 64;
  static constexpr int LD = 8 * DT + 4;     // row stride in floats: 4 mod 32
  static constexpr int NT = STR / WN / 8;   // 8-column mma tiles per warp
  static_assert(WM * WN == kWarps, "8 warps");
  static_assert(NT >= 1 && NT * WN * 8 == STR, "the warps tile the streamed axis");
  static_assert(WN * OWN <= 2 * STR, "the merge scratch fits the streamed planes");
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)(OWN + 2 * STR) * LD + 3 * WN * OWN + 3 * (OWN + STR)) +
      sizeof(int) * 3 * (size_t)(OWN + STR);
};

struct Problem {
  const float* q;
  const float* k;
  const float* corr;
  const int* pos;
  const int* usr;
  const int* valid;
  const float* lse;  // backward only
  const float* g;    // backward only
  int B;
  int D;
  float inv_temp;
};

// Per-index metadata of one tile, in shared memory: ids = (pos, usr, valid,
// corr) with the three integers kept as bit patterns, row = (lse, g).
struct Meta {
  float4* ids;
  float2* row;
};

__device__ __forceinline__ void load_meta(const Problem& p, Meta m, int base,
                                          int n, int tid) {
  for (int t = tid; t < n; t += kThreads) {
    const int a = base + t;
    const bool in = a < p.B;
    m.ids[t] = make_float4(__int_as_float(in ? p.pos[a] : 0), __int_as_float(in ? p.usr[a] : 0),
                           __int_as_float(in ? p.valid[a] : 0), in ? p.corr[a] : 0.f);
    m.row[t] = make_float2((in && p.lse) ? p.lse[a] : 0.f, (in && p.g) ? p.g[a] : 0.f);
  }
}

// The tensor cores read the top 19 bits of a tf32 operand (sign, 8 exponent
// bits, 10 of the mantissa). x = hi + lo with hi = x rounded to those bits
// (half an ulp added, then cut: integer work, where cvt.rna.tf32 goes through
// the slower conversion unit) and lo = x - hi, exact in fp32 and cut to the same bits:
// |lo| <= 2^-11 |x|, and the cut of lo leaves <= 2^-21 |x|.
constexpr unsigned kTf32Mask = 0xffffe000u;

__device__ __forceinline__ void split(float x, unsigned& hi, unsigned& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & kTf32Mask;
  lo = __float_as_uint(x - __uint_as_float(hi)) & kTf32Mask;
}

__device__ __forceinline__ void mma_tf32(float* c, const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[i] += a * b[i] at fp32 accuracy for N accumulators: the small terms
// first, and each term across all N before the next, so that consecutive mma
// instructions do not wait for one another's accumulator
template <int N>
__device__ __forceinline__ void mma_3xtf32(float (*c)[4], const unsigned (&a_hi)[4],
                                           const unsigned (&a_lo)[4],
                                           const unsigned (&b_hi)[N][2],
                                           const unsigned (&b_lo)[N][2]) {
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a_lo, b_hi[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a_hi, b_lo[i]);
#pragma unroll
  for (int i = 0; i < N; ++i) mma_tf32(c[i], a_hi, b_hi[i]);
}

// Rows [base, base + n) of a (B, D) matrix into shared memory with row
// stride ld, as they are (lo == nullptr) or split into hi and lo planes.
// Rows >= B are zero; columns >= D are left as they are (zeroed once).
__device__ __forceinline__ void store_value(float* hi, float* lo, int at, float v) {
  if (lo == nullptr) {
    hi[at] = v;
  } else {
    unsigned h, l;
    split(v, h, l);
    hi[at] = __uint_as_float(h);
    lo[at] = __uint_as_float(l);
  }
}

__device__ __forceinline__ void store_value4(float* hi, float* lo, int at, const float4& v) {
  if (lo == nullptr) {
    *reinterpret_cast<float4*>(hi + at) = v;
  } else {
    const float in[4] = {v.x, v.y, v.z, v.w};
    unsigned h[4], l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) split(in[i], h[i], l[i]);
    *reinterpret_cast<uint4*>(hi + at) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(lo + at) = make_uint4(l[0], l[1], l[2], l[3]);
  }
}

constexpr int kBatch = 8;  // float4 loads a thread keeps in flight

// (row, first column) of the e-th float4 of a tile whose rows hold d4 of them.
// e < 2^14 and d4 <= 64, so the product is never within rounding of a whole
// number and the float quotient is exact; an integer division costs ~25
// instructions, and a thread does 16 of these a tile.
__device__ __forceinline__ void row_col4(int e, int d4, float inv_d4, int& r, int& c) {
  r = __float2int_rd((e + 0.5f) * inv_d4);
  c = (e - r * d4) << 2;
}

// The float4s e0, e0 + kThreads, ... of rows [base, base + n) of a (B, D)
// matrix with D % 4 == 0, into registers, and from there into shared memory.
__device__ __forceinline__ void fetch_rows4(const float* src, int base, int n, int B,
                                            int D, int e0, float4 (&v)[kBatch]) {
  const int d4 = D >> 2, total = n * d4;
  const float inv_d4 = 1.f / d4;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int e = e0 + b * kThreads;
    int r, c;
    row_col4(e, d4, inv_d4, r, c);
    v[b] = make_float4(0.f, 0.f, 0.f, 0.f);
    if (e < total && base + r < B)
      v[b] = __ldg(reinterpret_cast<const float4*>(src + (size_t)(base + r) * D + c));
  }
}

__device__ __forceinline__ void store_rows4(float* hi, float* lo, int n, int D, int ld,
                                            int e0, const float4 (&v)[kBatch]) {
  const int d4 = D >> 2, total = n * d4;
  const float inv_d4 = 1.f / d4;
#pragma unroll
  for (int b = 0; b < kBatch; ++b) {
    const int e = e0 + b * kThreads;
    int r, c;
    row_col4(e, d4, inv_d4, r, c);
    if (e < total) store_value4(hi, lo, r * ld + c, v[b]);
  }
}

__device__ __forceinline__ void load_rows(const float* src, float* hi, float* lo,
                                          int base, int n, int B, int D, int ld,
                                          int tid) {
  if ((D & 3) == 0) {  // rows are 16-byte aligned
    for (int e0 = tid; e0 < n * (D >> 2); e0 += kBatch * kThreads) {
      float4 v[kBatch];
      fetch_rows4(src, base, n, B, D, e0, v);
      store_rows4(hi, lo, n, D, ld, e0, v);
    }
  } else {
    for (int e = tid; e < n * D; e += kThreads) {
      const int r = e / D, d = e - r * D;
      const int a = base + r;
      store_value(hi, lo, r * ld + d, a < B ? __ldg(src + (size_t)a * D + d) : 0.f);
    }
  }
}

template <int MODE, class C>
__global__ void __launch_bounds__(kThreads, 1)
diag_ce_kernel(Problem p, float* out0, float* out1) {
  constexpr int LD = C::LD, NT = C::NT, DT = C::DT, OWN = C::OWN, STR = C::STR,
                WN = C::WN;
  constexpr int kOutTiles = MODE == kFwd ? 1 : DT;  // dq / dk accumulators
  constexpr int kGroup = MODE == kFwd ? 1 : 4;      // output tiles per batch of mma
  extern __shared__ __align__(16) float smem[];
  const int D = p.D, B = p.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragment coordinates
  const int wm = warp / WN, wn = warp % WN;
  const int own0 = blockIdx.x * OWN;
  const int row0 = wm * 16 + g;           // this lane's owned rows: row0, row0 + 8
  const int col0 = wn * (NT * 8);         // this warp's columns of the tile

  float* own = smem;               // OWN x LD, fp32 as loaded
  float* s_hi = own + OWN * LD;    // STR x LD, the tf32 head of each value
  float* s_lo = s_hi + STR * LD;   // STR x LD, the tf32 rest
  float* merge = s_lo + STR * LD;  // 3 x WN x OWN (fwd)
  Meta om, sm;                     // of the owned and of the streamed indices
  om.ids = reinterpret_cast<float4*>(merge + 3 * WN * OWN);
  sm.ids = om.ids + OWN;
  om.row = reinterpret_cast<float2*>(sm.ids + STR);
  sm.row = om.row + OWN;

  // columns D .. 8 * DT are depth of the first product: zero for the whole run
  if (D < 8 * DT) {
    for (int e = tid; e < (OWN + 2 * STR) * LD; e += kThreads) smem[e] = 0.f;
    __syncthreads();
  }

  // fwd and dq own query rows and stream keys; dk owns keys, streams rows
  const float* own_src = MODE == kDk ? p.k : p.q;
  const float* str_src = MODE == kDk ? p.q : p.k;
  load_rows(own_src, own, nullptr, own0, OWN, B, D, LD, tid);
  load_meta(p, om, own0, OWN, tid);

  // fwd: running max / sum / diagonal of rows row0 and row0 + 8, over this
  // warp's columns (the four lanes of a quad hold the same values)
  float run_m[2] = {-INFINITY, -INFINITY}, run_s[2] = {0.f, 0.f}, diag[2] = {0.f, 0.f};
  // dq / dk: rows row0 and row0 + 8 of the output, summed over this warp's columns
  float out_acc[kOutTiles][4];
#pragma unroll
  for (int dt = 0; dt < kOutTiles; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) out_acc[dt][c] = 0.f;

  const int ksteps = (D + 7) >> 3;
  const float* a_ptr = own + row0 * LD + t;

  // the metadata of this lane's two owned indices stays in registers
  __syncthreads();
  const float4 own_ids[2] = {om.ids[row0], om.ids[row0 + 8]};
  const float2 own_row[2] = {om.row[row0], om.row[row0 + 8]};

  for (int str0 = 0; str0 < B; str0 += STR) {
    __syncthreads();  // the previous tile is consumed
    load_rows(str_src, s_hi, s_lo, str0, STR, B, D, LD, tid);
    load_meta(p, sm, str0, STR, tid);
    __syncthreads();

    // first product: owned rows x streamed rows, depth D
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[nt][c] = 0.f;
#pragma unroll 2
    for (int ks = 0; ks < ksteps; ++ks) {
      unsigned a_hi[4], a_lo[4];
      split(a_ptr[ks * 8], a_hi[0], a_lo[0]);
      split(a_ptr[ks * 8 + 8 * LD], a_hi[1], a_lo[1]);
      split(a_ptr[ks * 8 + 4], a_hi[2], a_lo[2]);
      split(a_ptr[ks * 8 + 8 * LD + 4], a_hi[3], a_lo[3]);
      unsigned b_hi[NT][2], b_lo[NT][2];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int at = (col0 + nt * 8 + g) * LD + ks * 8 + t;
        b_hi[nt][0] = __float_as_uint(s_hi[at]);
        b_hi[nt][1] = __float_as_uint(s_hi[at + 4]);
        b_lo[nt][0] = __float_as_uint(s_lo[at]);
        b_lo[nt][1] = __float_as_uint(s_lo[at + 4]);
      }
      mma_3xtf32<NT>(acc, a_hi, a_lo, b_hi, b_lo);
    }

    // on the fragments: the masked logit (fwd) or dlogit (dq, dk) of each entry
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int cc = 0; cc < 2; ++cc) {
        const int s = col0 + nt * 8 + 2 * t + cc;  // streamed index in the tile
        const float4 str_ids = sm.ids[s];
        const float2 str_row = MODE == kDk ? sm.row[s] : make_float2(0.f, 0.f);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int c = 2 * r + cc;  // (row0 + 8 r, s) in the accumulator
          const int oa = own0 + row0 + 8 * r, sb = str0 + s;
          // (row i, column j) of the logit matrix and their metadata
          const int i = MODE == kDk ? sb : oa;
          const int j = MODE == kDk ? oa : sb;
          const float4 ri = MODE == kDk ? str_ids : own_ids[r];
          const float2 rr = MODE == kDk ? str_row : own_row[r];
          const float4 cj = MODE == kDk ? own_ids[r] : str_ids;
          float val;
          if (i >= B || j >= B) {
            val = MODE == kFwd ? (j >= B ? -INFINITY : kNeg) : 0.f;
          } else {
            const float logit = acc[nt][c] * p.inv_temp - cj.w;
            const bool forbid =
                i != j && (__float_as_int(ri.x) == __float_as_int(cj.x) ||
                           __float_as_int(ri.y) == __float_as_int(cj.y) ||
                           __float_as_int(cj.z) == 0);
            if (MODE == kFwd) {
              val = forbid ? kNeg : logit;
              if (i == j) diag[r] += logit;
            } else {
              const float prob = __expf(logit - rr.x);
              val = forbid ? 0.f : (prob - (i == j ? 1.f : 0.f)) * rr.y * p.inv_temp;
            }
          }
          acc[nt][c] = val;
        }
      }
    }

    if (MODE == kFwd) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float tile_m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tile_m = fmaxf(tile_m, fmaxf(acc[nt][2 * r], acc[nt][2 * r + 1]));
        tile_m = fmaxf(tile_m, __shfl_xor_sync(0xffffffffu, tile_m, 1));
        tile_m = fmaxf(tile_m, __shfl_xor_sync(0xffffffffu, tile_m, 2));
        const float m_new = fmaxf(run_m[r], tile_m);
        // a warp whose columns all lie past B has seen -inf only so far
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          part += __expf(acc[nt][2 * r] - m_safe) + __expf(acc[nt][2 * r + 1] - m_safe);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        run_s[r] = run_s[r] * __expf(run_m[r] - m_safe) + part;
        run_m[r] = m_new;
      }
    } else {
      // second product: dlogit fragments x streamed rows, depth = this warp's
      // columns, under the k-slot permutation t <-> 2t, t + 4 <-> 2t + 1
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        unsigned a_hi[4], a_lo[4];
        split(acc[nt][0], a_hi[0], a_lo[0]);  // (row0,     2t)
        split(acc[nt][2], a_hi[1], a_lo[1]);  // (row0 + 8, 2t)
        split(acc[nt][1], a_hi[2], a_lo[2]);  // (row0,     2t + 1)
        split(acc[nt][3], a_hi[3], a_lo[3]);  // (row0 + 8, 2t + 1)
        const int at = (col0 + nt * 8 + 2 * t) * LD + g;
#pragma unroll
        for (int dt0 = 0; dt0 < kOutTiles; dt0 += kGroup) {
          if (dt0 * 8 < D) {  // a group past D would add zeros: skipped
            unsigned b_hi[kGroup][2], b_lo[kGroup][2];
#pragma unroll
            for (int i = 0; i < kGroup; ++i) {
              const int d = (dt0 + i) * 8;
              b_hi[i][0] = __float_as_uint(s_hi[at + d]);
              b_hi[i][1] = __float_as_uint(s_hi[at + d + LD]);
              b_lo[i][0] = __float_as_uint(s_lo[at + d]);
              b_lo[i][1] = __float_as_uint(s_lo[at + d + LD]);
            }
            mma_3xtf32<kGroup>(out_acc + dt0, a_hi, a_lo, b_hi, b_lo);
          }
        }
      }
    }
  }

  if (MODE == kFwd) {
    // merge the WN column groups of each row, in warp order
    float* m_all = merge;
    float* s_all = merge + WN * OWN;
    float* d_all = merge + 2 * WN * OWN;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float dg = diag[r];
      dg += __shfl_xor_sync(0xffffffffu, dg, 1);
      dg += __shfl_xor_sync(0xffffffffu, dg, 2);
      if (t == 0) {
        const int at = wn * OWN + row0 + 8 * r;
        m_all[at] = run_m[r];
        s_all[at] = run_s[r];
        d_all[at] = dg;
      }
    }
    __syncthreads();
    if (tid < OWN && own0 + tid < B) {
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < WN; ++w) m = fmaxf(m, m_all[w * OWN + tid]);
      float sum = 0.f, dg = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        sum += s_all[w * OWN + tid] * expf(m_all[w * OWN + tid] - m);
        dg += d_all[w * OWN + tid];
      }
      const float lse = m + logf(sum);
      out0[own0 + tid] = lse - dg;  // loss
      out1[own0 + tid] = lse;
    }
  } else {
    // add the WN partial outputs of each owned row, in warp order
    __syncthreads();  // every warp is done with the streamed planes
    float* scratch = s_hi;  // WN x OWN x LD
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt) {
      if (dt * 8 < D) {
        float* at = scratch + (wn * OWN + row0) * LD + dt * 8 + 2 * t;
        *reinterpret_cast<float2*>(at) = make_float2(out_acc[dt][0], out_acc[dt][1]);
        *reinterpret_cast<float2*>(at + 8 * LD) = make_float2(out_acc[dt][2], out_acc[dt][3]);
      }
    }
    __syncthreads();
    for (int e = tid; e < OWN * D; e += kThreads) {
      const int o = e / D, d = e - o * D;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) sum += scratch[(w * OWN + o) * LD + d];
      if (own0 + o < B) out0[(size_t)(own0 + o) * D + d] = sum;
    }
  }
}

template <int MODE, class C>
int launch_tile(const Problem& p, float* out0, float* out1, void* stream) {
  if (C::kSmemBytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        diag_ce_kernel<MODE, C>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::kSmemBytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.B + C::OWN - 1) / C::OWN);
  diag_ce_kernel<MODE, C><<<grid, kThreads, C::kSmemBytes, (cudaStream_t)stream>>>(
      p, out0, out1);
  return (int)cudaGetLastError();
}

template <int MODE>
int launch(const Problem& p, float* out0, float* out1, void* stream) {
  if (p.B < 1 || p.D < 1 || p.D > kMaxD) return (int)cudaErrorInvalidValue;
  const bool large = p.B >= kLargeB, wide = p.D > 128;
  if (large) {
    return wide ? launch_tile<MODE, Tile<4, 2, 32>>(p, out0, out1, stream)
                : launch_tile<MODE, Tile<4, 2, 16>>(p, out0, out1, stream);
  }
  return wide ? launch_tile<MODE, Tile<1, 8, 32>>(p, out0, out1, stream)
              : launch_tile<MODE, Tile<1, 8, 16>>(p, out0, out1, stream);
}

Problem make_problem(const float* q, const float* k, const float* corr,
                     const int* pos, const int* usr, const int* valid,
                     const float* lse, const float* g, int B, int D,
                     float inv_temp) {
  Problem p;
  p.q = q; p.k = k; p.corr = corr;
  p.pos = pos; p.usr = usr; p.valid = valid;
  p.lse = lse; p.g = g;
  p.B = B; p.D = D; p.inv_temp = inv_temp;
  return p;
}

}  // namespace

// Plain C interface (loaded with ctypes). Every pointer is device memory;
// each function launches on `stream` and returns the cudaError_t of the
// launch (0 = success). Nothing is allocated here.
extern "C" {

int diag_ce_max_dim() { return kMaxD; }

int diag_ce_fwd(const float* q, const float* k, const float* corr,
                const int* pos, const int* usr, const int* valid, int B, int D,
                float inv_temp, float* loss, float* lse, void* stream) {
  return launch<kFwd>(make_problem(q, k, corr, pos, usr, valid, nullptr,
                                   nullptr, B, D, inv_temp),
                      loss, lse, stream);
}

int diag_ce_bwd_dq(const float* q, const float* k, const float* corr,
                   const int* pos, const int* usr, const int* valid,
                   const float* lse, const float* g, int B, int D,
                   float inv_temp, float* dq, void* stream) {
  return launch<kDq>(make_problem(q, k, corr, pos, usr, valid, lse, g, B, D,
                                  inv_temp),
                     dq, nullptr, stream);
}

int diag_ce_bwd_dk(const float* q, const float* k, const float* corr,
                   const int* pos, const int* usr, const int* valid,
                   const float* lse, const float* g, int B, int D,
                   float inv_temp, float* dk, void* stream) {
  return launch<kDk>(make_problem(q, k, corr, pos, usr, valid, lse, g, B, D,
                                  inv_temp),
                     dk, nullptr, stream);
}

}  // extern "C"
