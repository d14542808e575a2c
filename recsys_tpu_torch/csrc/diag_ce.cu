// Fused in-batch contrastive cross-entropy for Hopper (sm_90a): fp32 in and
// out, the products on the tensor cores at fp32 accuracy.
//
// Replaces the TPU kernels recsys_tpu/ops/pallas_contrastive.py:
// _fwd_kernel (forward) and _bwd_kernel (backward). Per row i:
//
//   raw_ij   = (q_i . k_j) * inv_temp - corr_j
//   logit_ij = min(max(raw_ij, -clamp), clamp)
//   logit_ij = -3e4  where j != i and (pos_j == pos_i or usr_j == usr_i
//                                      or valid_j == 0)
//   lse_i    = logsumexp_j logit_ij,   loss_i = lse_i - logit_ii
//
// and the backward, with g_i = dL/dloss_i and P = exp(logit - lse):
//
//   dlogit_ij = (P_ij - [i == j]) * g_i * inv_temp   (0 where forbidden, and
//                                                     where raw_ij is clipped)
//   dq_i = sum_j dlogit_ij k_j,   dk_j = sum_i dlogit_ij q_i
//
// The clamp is LightGCL's (+-100 on its SSL logits, as jnp.clip there); the
// other callers pass none (+inf), and their launches take the instances
// built without it (CLAMP = false), whose code is that of a kernel without
// the clamp.
//
// What bounds it: operations. A call reads O(B * D) bytes and does
// O(B^2 * D) multiply-adds, and the (B, B) logits never reach device memory.
// The products are mma.sync.aligned.m16n8k8 (tf32 inputs, fp32
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
// ulp, mask; subtract, mask). exp is __expf (ex2.approx): a relative ~5e-6 at
// |x| = 30, inside both tolerances. tests/test_torch_tf32_split.py repeats
// the arithmetic in numpy against fp64, and tests/test_torch_diag_ce_combine.py
// the merge of partial results below.
//
// Design. A call is one cooperative launch of diag_ce_kernel<MODE>, in three
// phases with a grid-wide barrier between them:
//
//   1. split    q and k split once into hi / lo planes, rows padded to a
//               whole number of owner blocks and widths to 128 or 256 with
//               zeros; the per-index metadata packed as (pos, usr, valid,
//               corr) and (lse, g).
//   2. products fwd and dq own query rows and stream key tiles; dk owns key
//               columns and streams query rows. The (owner block, streamed
//               tile) pairs, R x R of them, are cut into G contiguous ranges,
//               G = the SM count (at least R, at most R x R): every SM gets
//               the same number of tiles give or take one, whatever B is. A
//               range spans at most two owner blocks (G >= R), so it writes
//               at most two partial results.
//   3. combine  each owner block's partials merged in the order of the
//               ranges that made them (fwd: running max / sum / diagonal ->
//               loss, lse; dq / dk: partial rows summed). Fixed order, no
//               atomics: two calls give the same bits.
//
//   * A block is 8 warps, WM x WN: a warp owns 16 rows of the block's
//     owner rows and NT 8-column mma tiles of each streamed tile. The owner
//     rows' planes stay in shared memory for the range; the streamed tiles
//     come through a ring of two stages filled by cp.async while the tensor
//     cores work on the other stage.
//   * The first product reads both operands with ldmatrix (a 32-bit value is
//     a pair of b16, so the m8n8 b16 layout hands each lane the (g, t) word
//     of an 8 x 4 fp32 block, which is the tf32 fragment layout). Its logits
//     stay mma accumulators; the mask, the online softmax (fwd) or dlogit
//     (dq, dk) are computed on those fragments in registers.
//   * The second product of dq / dk takes the dlogit fragments straight as
//     its A operand: an m16n8 accumulator holds (row, 2t), (row, 2t + 1) where
//     the A operand of m16n8k8 wants (row, t), (row, t + 4), so the streamed
//     index is permuted inside each group of 8 (k-slot t <-> 2t, t + 4 <->
//     2t + 1) and the B fragments are read under the same permutation. With a
//     row stride of D + 4 floats every read of shared memory is free of bank
//     conflicts.
//   * The three terms of a product are issued term by term across the warp's
//     accumulators, so that consecutive mma instructions do not wait for one
//     another.
//   * Block shapes (launch): widths up to 128, owner blocks of 64 rows (4 x 2
//     warps) and tiles of 64 (Narrow); below one such pair an SM (B < ~730
//     on 132 SMs), 32 and 32 (2 x 4 warps: Small), so that a small batch
//     still spreads over the SMs; widths 129 to 256, 32 and 32 (Wide), so
//     that the owner planes and two stages fit in shared memory.
//   * The forward at widths up to 128 (WgFwd) takes its product by wgmma
//     (m64n32k8 tf32, both operands in shared memory in the 128-byte
//     swizzled layout, one warpgroup a 32-key half of a 64-key tile): the
//     card runs mma.sync's TF32 at about a quarter of its TF32 peak, which
//     held the forward at ~6,500 clocks a 64 x 64 tile. The backward keeps
//     mma.sync: its second product takes the dlogit accumulators as A
//     operand with the k-slot permutation below, and the transposed
//     streamed tile it would need as wgmma's B is not in shared memory.
//
// Measured and not kept (NVIDIA H100 80GB HBM3; PERF.md §6): three
// launches a call (split, products, combine: the cooperative launch saves
// two launches and the gaps between them); a forward tile of 64 rows x 128
// keys streamed 32 deep through four stages with 32 x 32 logits a warp (no
// gain: not bound by shared memory); the forward's softmax of tile t beside
// the wgmma of tile t + 1 (slower: with two stages the next load then has
// less time to land); the owner rows' A operand in registers with three
// stages (255 registers, spills, and ptxas serializes the wgmma).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 256;
constexpr float kNeg = -3.0e4f;

enum Mode { kFwd = 0, kDq = 1, kDk = 2 };

// WM x WN warps; 16 * WM owner rows; tiles of as many streamed indices; each
// warp NT 8-column mma tiles of a streamed tile; widths up to DP.
template <int WM_, int WN_, int NT_, int DP_>
struct Tile {
  static constexpr bool kWgmma = false;
  static constexpr int WM = WM_, WN = WN_, NT = NT_, DP = DP_;
  static constexpr int OWN = 16 * WM;
  static constexpr int STR = 8 * NT * WN;
  static constexpr int LD = DP + 4;  // row stride in floats: 4 mod 32
  static_assert(WM * WN == kWarps, "8 warps");
  static_assert(STR == OWN, "owner blocks and streamed tiles cut B alike");
  static_assert(NT == 1 || NT % 2 == 0, "B fragments are read two tiles at a time");
  static constexpr int kPlaneFloats = (2 * OWN + 4 * STR) * LD;  // owner hi, lo; 2 stages x 2
  static_assert(WN * OWN * LD <= 4 * STR * LD, "the merge scratch fits the stages");
  static constexpr size_t kSmemBytes =
      sizeof(float) * (size_t)kPlaneFloats + 2 * sizeof(float4) * 2 * STR;
};

using Narrow = Tile<4, 2, 4, 128>;
using Small = Tile<2, 4, 1, 128>;
using Wide = Tile<2, 4, 1, 256>;

// The forward at widths up to 128: owner blocks of 64 rows and tiles of 64
// keys as Narrow, the first product by wgmma, WN warpgroups a tile.
struct WgFwd {
  static constexpr bool kWgmma = true;
  static constexpr int WN = 2, NT = 4, DP = 128;
  static constexpr int OWN = 64, STR = 64, ROWS = 64;  // rows of a swizzled plane
  static constexpr int kAtomFloats = ROWS * 32;        // 64 rows x 128 bytes
  static_assert(WN * 4 == kWarps && STR == WN * NT * 8, "a warpgroup a 32-key half");
  static_assert(STR == OWN, "owner blocks and streamed tiles cut B alike");
  static constexpr size_t kSmemBytes =
      1024 + sizeof(float) * 6 * (size_t)ROWS * DP + sizeof(float4) * 2 * STR;
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
  float clamp;       // +inf: no clamp (the CLAMP = false instances)
};

// What the three phases write and read, carved out of the caller's workspace.
struct Plan {
  float* q_hi;          // (Bp, DP) planes, written by the split phase
  float* q_lo;
  float* k_hi;
  float* k_lo;
  const float* own_hi;  // the owner side's planes (q's, or k's for dk)
  const float* own_lo;
  const float* str_hi;  // and the streamed side's
  const float* str_lo;
  float4* ids;          // (Bp,) (pos, usr, valid as bits; corr)
  float4* rows;         // (Bp,) (lse, g, 0, 0)
  float* part;          // G x 2 partial results
  int B, D, Bp;
  int R, G;             // owner blocks (= streamed tiles), ranges
  float inv_temp;
  float clamp;
};

// The logit after the clamp, and whether the clamp cut it (its gradient is 0
// there, as jnp.clip's); without CLAMP the logit as it is.
template <bool CLAMP>
__device__ __forceinline__ float clamped(float raw, float c) {
  if constexpr (CLAMP) return fminf(fmaxf(raw, -c), c);
  return raw;
}

template <bool CLAMP>
__device__ __forceinline__ bool clipped(float raw, float c) {
  if constexpr (CLAMP) return !(raw >= -c && raw <= c);
  return false;
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

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_addr(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// four 8 x 4 fp32 blocks (as 8 x 8 b16): lane l gives the address of row l % 8
// of block l / 8 and receives word (l / 4, l % 4) of each block
__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(unsigned (&r)[2], const float* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// -- phase 1: the split -------------------------------------------------------

// q and k into hi / lo planes of shape (Bp, DP), zero past (B, D); the
// metadata of every index into ids / rows (zero past B). Grid-stride.
template <class C>
__device__ void split_phase(const Problem& pr, const Plan& p) {
  constexpr int n4 = C::DP / 4, DP = C::DP;
  const int total = p.Bp * n4, D = pr.D, B = pr.B;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total; e += gridDim.x * blockDim.x) {
    const int r = e / n4, c = (e % n4) * 4;
    const float* src[2] = {pr.q, pr.k};
    float* hi[2] = {p.q_hi, p.k_hi};
    float* lo[2] = {p.q_lo, p.k_lo};
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      float v[4] = {0.f, 0.f, 0.f, 0.f};
      if (r < B && c < D) {
        const float* row = src[m] + (size_t)r * D;
        if ((D & 3) == 0) {  // rows are 16-byte aligned
          const float4 x = __ldg(reinterpret_cast<const float4*>(row + c));
          v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
        } else {
#pragma unroll
          for (int i = 0; i < 4; ++i) v[i] = c + i < D ? __ldg(row + c + i) : 0.f;
        }
      }
      unsigned h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(v[i], h[i], l[i]);
      *reinterpret_cast<uint4*>(hi[m] + (size_t)r * DP + c) = make_uint4(h[0], h[1], h[2], h[3]);
      *reinterpret_cast<uint4*>(lo[m] + (size_t)r * DP + c) = make_uint4(l[0], l[1], l[2], l[3]);
    }
    if (c == 0) {
      const bool in = r < B;
      p.ids[r] = make_float4(__int_as_float(in ? pr.pos[r] : 0), __int_as_float(in ? pr.usr[r] : 0),
                             __int_as_float(in ? pr.valid[r] : 0), in ? pr.corr[r] : 0.f);
      p.rows[r] = make_float4((in && pr.lse) ? pr.lse[r] : 0.f, (in && pr.g) ? pr.g[r] : 0.f,
                              0.f, 0.f);
    }
  }
}

// -- the partition of the (owner block, streamed tile) pairs ----------------

// range c of G over the P = R x R pairs (owner block u / R, tile u % R):
// [first(c), first(c + 1))
__device__ __forceinline__ long long range_first(int c, long long P, int G) {
  return (long long)c * P / G;
}

// slot of owner block r among the (at most two) that range c spans
__device__ __forceinline__ int slot_of(int c, int r, int R, int G) {
  return range_first(c, (long long)R * R, G) / R == r ? 0 : 1;
}

// floats of one partial result
template <int MODE, class C>
__host__ __device__ constexpr int part_floats() {
  return MODE == kFwd ? 3 * C::OWN : C::OWN * C::DP;
}

// -- phase 2: the products ----------------------------------------------------

// n rows from `base` of a pair of (Bp, DP) planes into shared memory (row
// stride LD), by cp.async
template <class C>
__device__ __forceinline__ void load_planes(float* hi, float* lo, const float* src_hi,
                                            const float* src_lo, int base, int n, int tid) {
  constexpr int n4 = C::DP / 4;
  for (int e = tid; e < n * n4; e += kThreads) {
    const int r = e / n4, c = (e % n4) * 4;
    const size_t at = (size_t)(base + r) * C::DP + c;
    cp_async16(hi + r * C::LD + c, src_hi + at);
    cp_async16(lo + r * C::LD + c, src_lo + at);
  }
}

template <class C>
__device__ __forceinline__ void load_tile(const Plan& p, float* hi, float* lo, float4* ids,
                                          float4* rows, int base, int tid) {
  load_planes<C>(hi, lo, p.str_hi, p.str_lo, base, C::STR, tid);
  if (tid < C::STR) {
    cp_async16(ids + tid, p.ids + base + tid);
    cp_async16(rows + tid, p.rows + base + tid);
  }
}

// Range c of the (owner block, tile) pairs into its partial results.
template <int MODE, class C, bool CLAMP>
__device__ void run_range(const Plan& p, int c, float* smem) {
  constexpr int LD = C::LD, NT = C::NT, DP = C::DP, OWN = C::OWN, STR = C::STR,
                WN = C::WN;
  constexpr int kOutTiles = MODE == kFwd ? 1 : DP / 8;  // dq / dk accumulators
  constexpr int kGroup = MODE == kFwd ? 1 : 4;          // output tiles per batch of mma
  const int B = p.B, D = p.D, R = p.R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragment coordinates
  const int wm = warp / WN, wn = warp % WN;
  const int row0 = wm * 16 + g;           // this lane's owner rows: row0, row0 + 8
  const int col0 = wn * (NT * 8);         // this warp's columns of a tile

  float* own_hi = smem;                   // OWN x LD
  float* own_lo = own_hi + OWN * LD;
  float* stages = own_lo + OWN * LD;      // 2 x (hi, lo) x STR x LD
  float4* s_ids = reinterpret_cast<float4*>(stages + 4 * STR * LD);  // 2 x STR
  float4* s_rows = s_ids + 2 * STR;                                  // 2 x STR

  const int ksteps = (D + 7) >> 3;
  // this lane's ldmatrix row addresses (ldsm_x4): A = 16 owner rows x 8 of
  // depth, B = two 8-column tiles (one for NT == 1) x 8 of depth
  const int a_off = (wm * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * LD + (lane >> 4) * 4;
  const int b_off = NT == 1 ? (col0 + (lane & 7)) * LD + ((lane >> 3) & 1) * 4
                            : (col0 + (lane & 7) + ((lane >> 4) & 1) * 8) * LD +
                                  ((lane >> 3) & 1) * 4;

  const long long P = (long long)R * R;
  const long long u_end = range_first(c + 1, P, p.G);
  int slot = 0;
  for (long long u = range_first(c, P, p.G); u < u_end; ++slot) {
    const int r = (int)(u / R);
    const int t_first = (int)(u - (long long)r * R);
    const int t_last = (int)min((long long)R, t_first + (u_end - u));  // exclusive
    u += t_last - t_first;
    const int own0 = r * OWN;

    load_planes<C>(own_hi, own_lo, p.own_hi, p.own_lo, own0, OWN, tid);
    load_tile<C>(p, stages, stages + STR * LD, s_ids, s_rows, t_first * STR, tid);
    cp_async_commit();
    // the metadata of this lane's two owner indices stays in registers (read
    // through L2: the split phase of this launch wrote it)
    const float4 own_ids[2] = {__ldcg(p.ids + own0 + row0), __ldcg(p.ids + own0 + row0 + 8)};
    const float4 own_row[2] = {__ldcg(p.rows + own0 + row0), __ldcg(p.rows + own0 + row0 + 8)};

    // fwd: running max / sum / diagonal of rows row0 and row0 + 8, over this
    // warp's columns (the four lanes of a quad hold the same values)
    float run_m[2] = {-INFINITY, -INFINITY}, run_s[2] = {0.f, 0.f}, diag[2] = {0.f, 0.f};
    // dq / dk: rows row0 and row0 + 8 of the output, summed over this warp's columns
    float out_acc[kOutTiles][4];
#pragma unroll
    for (int dt = 0; dt < kOutTiles; ++dt)
#pragma unroll
      for (int i = 0; i < 4; ++i) out_acc[dt][i] = 0.f;

    for (int tt = t_first; tt < t_last; ++tt) {
      const int st = (tt - t_first) & 1;
      if (tt + 1 < t_last) {  // the next tile into the other stage
        float* nx = stages + (st ^ 1) * 2 * STR * LD;
        load_tile<C>(p, nx, nx + STR * LD, s_ids + (st ^ 1) * STR, s_rows + (st ^ 1) * STR,
                     (tt + 1) * STR, tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
      const float* s_hi = stages + st * 2 * STR * LD;
      const float* s_lo = s_hi + STR * LD;
      const float4* sid = s_ids + st * STR;
      const float4* srow = s_rows + st * STR;
      const int str0 = tt * STR;

      // first product: owner rows x streamed rows, depth D
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[nt][i] = 0.f;
#pragma unroll 2
      for (int ks = 0; ks < ksteps; ++ks) {
        unsigned a_hi[4], a_lo[4];
        ldsm_x4(a_hi, own_hi + a_off + ks * 8);
        ldsm_x4(a_lo, own_lo + a_off + ks * 8);
        unsigned b_hi[NT][2], b_lo[NT][2];
        if constexpr (NT == 1) {
          ldsm_x2(b_hi[0], s_hi + b_off + ks * 8);
          ldsm_x2(b_lo[0], s_lo + b_off + ks * 8);
        } else {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            unsigned x[4], y[4];
            ldsm_x4(x, s_hi + b_off + np * 16 * LD + ks * 8);
            ldsm_x4(y, s_lo + b_off + np * 16 * LD + ks * 8);
            b_hi[2 * np][0] = x[0]; b_hi[2 * np][1] = x[1];
            b_hi[2 * np + 1][0] = x[2]; b_hi[2 * np + 1][1] = x[3];
            b_lo[2 * np][0] = y[0]; b_lo[2 * np][1] = y[1];
            b_lo[2 * np + 1][0] = y[2]; b_lo[2 * np + 1][1] = y[3];
          }
        }
        mma_3xtf32<NT>(acc, a_hi, a_lo, b_hi, b_lo);
      }

      // on the fragments: the masked logit (fwd) or dlogit (dq, dk) of each entry
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int s = col0 + nt * 8 + 2 * t + cc;  // streamed index in the tile
          const float4 str_ids = sid[s];
          const float4 str_row = MODE == kDk ? srow[s] : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int ci = 2 * rr + cc;  // (row0 + 8 rr, s) in the accumulator
            const int oa = own0 + row0 + 8 * rr, sb = str0 + s;
            // (row i, column j) of the logit matrix and their metadata
            const int i = MODE == kDk ? sb : oa;
            const int j = MODE == kDk ? oa : sb;
            const float4 ri = MODE == kDk ? str_ids : own_ids[rr];
            const float4 rw = MODE == kDk ? str_row : own_row[rr];
            const float4 cj = MODE == kDk ? own_ids[rr] : str_ids;
            float val;
            if (i >= B || j >= B) {
              val = MODE == kFwd ? (j >= B ? -INFINITY : kNeg) : 0.f;
            } else {
              const float raw = acc[nt][ci] * p.inv_temp - cj.w;
              const float logit = clamped<CLAMP>(raw, p.clamp);
              const bool forbid =
                  i != j && (__float_as_int(ri.x) == __float_as_int(cj.x) ||
                             __float_as_int(ri.y) == __float_as_int(cj.y) ||
                             __float_as_int(cj.z) == 0);
              if (MODE == kFwd) {
                val = forbid ? kNeg : logit;
                if (i == j) diag[rr] += logit;
              } else {
                const float prob = __expf(logit - rw.x);
                val = forbid || clipped<CLAMP>(raw, p.clamp)
                          ? 0.f
                          : (prob - (i == j ? 1.f : 0.f)) * rw.y * p.inv_temp;
              }
            }
            acc[nt][ci] = val;
          }
        }
      }

      if (MODE == kFwd) {
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          float tile_m = -INFINITY;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            tile_m = fmaxf(tile_m, fmaxf(acc[nt][2 * rr], acc[nt][2 * rr + 1]));
          tile_m = fmaxf(tile_m, __shfl_xor_sync(0xffffffffu, tile_m, 1));
          tile_m = fmaxf(tile_m, __shfl_xor_sync(0xffffffffu, tile_m, 2));
          const float m_new = fmaxf(run_m[rr], tile_m);
          // a warp whose columns all lie past B has seen -inf only so far
          const float m_safe = m_new == -INFINITY ? 0.f : m_new;
          float part = 0.f;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            part += __expf(acc[nt][2 * rr] - m_safe) + __expf(acc[nt][2 * rr + 1] - m_safe);
          part += __shfl_xor_sync(0xffffffffu, part, 1);
          part += __shfl_xor_sync(0xffffffffu, part, 2);
          run_s[rr] = run_s[rr] * __expf(run_m[rr] - m_safe) + part;
          run_m[rr] = m_new;
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
      __syncthreads();  // the stage is consumed
    }

    // the WN column groups of each owner row merged in warp order, in the
    // stages' memory, into partial result (c, slot)
    float* part = p.part + ((size_t)c * 2 + slot) * part_floats<MODE, C>();
    if (MODE == kFwd) {
      float* m_all = stages;
      float* s_all = m_all + WN * OWN;
      float* d_all = s_all + WN * OWN;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float dg = diag[rr];
        dg += __shfl_xor_sync(0xffffffffu, dg, 1);
        dg += __shfl_xor_sync(0xffffffffu, dg, 2);
        if (t == 0) {
          const int at = wn * OWN + row0 + 8 * rr;
          m_all[at] = run_m[rr];
          s_all[at] = run_s[rr];
          d_all[at] = dg;
        }
      }
      __syncthreads();
      if (tid < OWN) {
        float m = -INFINITY;
#pragma unroll
        for (int w = 0; w < WN; ++w) m = fmaxf(m, m_all[w * OWN + tid]);
        float sum = 0.f, dg = 0.f;
#pragma unroll
        for (int w = 0; w < WN; ++w) {
          sum += s_all[w * OWN + tid] * expf(m_all[w * OWN + tid] - m);
          dg += d_all[w * OWN + tid];
        }
        part[tid] = m;
        part[OWN + tid] = sum;
        part[2 * OWN + tid] = dg;
      }
    } else {
      float* scratch = stages;  // WN x OWN x LD
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
        part[o * DP + d] = sum;
      }
    }
    __syncthreads();  // the stages and the owner planes are free again
  }
}

// Range c of the forward under WgFwd: as run_range, the first product by
// wgmma. Both planes of the owner rows and of each streamed tile sit in
// shared memory in the 128-byte swizzled K-major layout of wgmma (8 rows x
// 32 tf32 an atom, the 16-byte chunk c of row r at c ^ (r % 8)); warpgroup
// w multiplies the 64 owner rows by keys [32 w, 32 w + 32) of the tile.
// Its accumulators are laid out as mma.sync's: warp (w, m) holds rows
// 16 m + g, 16 m + g + 8 and columns 32 w + 8 i + 2 t, + 1.
template <class C>
__device__ __forceinline__ void load_swizzled(float* hi, float* lo, const float* src_hi,
                                              const float* src_lo, int base, int tid) {
  constexpr int kChunks = C::DP / 4;  // 16-byte chunks a row
  for (int e = tid; e < C::ROWS * kChunks; e += kThreads) {
    const int row = e / kChunks, c16 = e % kChunks;
    const int at = (c16 / 8) * C::kAtomFloats + row * 32 + (((c16 % 8) ^ (row & 7)) * 4);
    const size_t from = (size_t)(base + row) * C::DP + 4 * c16;
    cp_async16(hi + at, src_hi + from);
    cp_async16(lo + at, src_lo + from);
  }
}

// a K-major, 128-byte swizzled operand at `p` (1024-byte aligned atoms):
// 8-row groups 1024 bytes apart
__device__ __forceinline__ uint64_t wgmma_desc(const float* p) {
  return (uint64_t)((smem_addr(p) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d = A (64 x 8, desc a) * B (32 x 8, desc b)^T (+ d where accumulate != 0),
// tf32 in, fp32 accumulators
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[4][4], uint64_t a, uint64_t b,
                                               int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// keeps the compiler from moving accumulator registers across the async
// wgmma pipeline (which would serialize it)
__device__ __forceinline__ void fence_operands(float (&d)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+f"(d[i][j])::"memory");
}

template <class C, bool CLAMP>
__device__ void run_range_wgmma(const Plan& p, int c, float* smem_raw) {
  constexpr int OWN = C::OWN, STR = C::STR, NT = C::NT, WN = C::WN, DP = C::DP;
  constexpr int kPlane = C::ROWS * DP;  // floats of one swizzled plane
  // the atoms want 1024-byte alignment; kSmemBytes holds the slack
  float* smem = reinterpret_cast<float*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~(uintptr_t)1023);
  const int B = p.B, R = p.R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;  // the mma fragment coordinates
  const int wn = warp / 4, wm = warp % 4; // warpgroup, warp in it
  const int row0 = wm * 16 + g;           // this lane's owner rows: row0, row0 + 8
  const int col0 = wn * (NT * 8);         // this warpgroup's columns of a tile

  float* own_hi = smem;
  float* own_lo = own_hi + kPlane;
  float* stages = own_lo + kPlane;        // 2 x (hi, lo) planes
  float4* s_ids = reinterpret_cast<float4*>(stages + 4 * kPlane);  // 2 x STR
  const int ksteps = (p.D + 7) >> 3;

  const long long P = (long long)R * R;
  const long long u_end = range_first(c + 1, P, p.G);
  int slot = 0;
  for (long long u = range_first(c, P, p.G); u < u_end; ++slot) {
    const int r = (int)(u / R);
    const int t_first = (int)(u - (long long)r * R);
    const int t_last = (int)min((long long)R, t_first + (u_end - u));  // exclusive
    u += t_last - t_first;
    const int own0 = r * OWN;

    load_swizzled<C>(own_hi, own_lo, p.own_hi, p.own_lo, own0, tid);
    load_swizzled<C>(stages, stages + kPlane, p.str_hi, p.str_lo, t_first * STR, tid);
    if (tid < STR) cp_async16(s_ids + tid, p.ids + t_first * STR + tid);
    cp_async_commit();
    const float4 own_ids[2] = {__ldcg(p.ids + own0 + row0), __ldcg(p.ids + own0 + row0 + 8)};
    float run_m[2] = {-INFINITY, -INFINITY}, run_s[2] = {0.f, 0.f}, diag[2] = {0.f, 0.f};

    for (int tt = t_first; tt < t_last; ++tt) {
      const int st = (tt - t_first) & 1;
      if (tt + 1 < t_last) {  // the next tile into the other stage
        float* nx = stages + (st ^ 1) * 2 * kPlane;
        load_swizzled<C>(nx, nx + kPlane, p.str_hi, p.str_lo, (tt + 1) * STR, tid);
        if (tid < STR) cp_async16(s_ids + (st ^ 1) * STR + tid, p.ids + (tt + 1) * STR + tid);
        cp_async_commit();
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      // what cp.async wrote must be visible to wgmma, which reads through the async proxy
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      __syncthreads();
      const float* s_hi = stages + st * 2 * kPlane;
      const float* s_lo = s_hi + kPlane;
      const float4* sid = s_ids + st * STR;
      const int str0 = tt * STR;

      float acc[NT][4];
      fence_operands(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
      for (int ks = 0; ks < ksteps; ++ks) {
        // k-step ks: atom ks / 4, 32 bytes a k-step inside it
        const int at = (ks / 4) * C::kAtomFloats + (ks % 4) * 8;
        const int bt = at + col0 * 32;  // the warpgroup's 32 keys: 4 row groups on
        const uint64_t a_hi = wgmma_desc(own_hi + at), a_lo = wgmma_desc(own_lo + at);
        const uint64_t b_hi = wgmma_desc(s_hi + bt), b_lo = wgmma_desc(s_lo + bt);
        wgmma_m64n32k8(acc, a_lo, b_hi, ks);  // the small terms first; the first sets acc
        wgmma_m64n32k8(acc, a_hi, b_lo, 1);
        wgmma_m64n32k8(acc, a_hi, b_hi, 1);
      }
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_operands(acc);

      // on the accumulators: the masked logit of each entry, online softmax
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int s = col0 + nt * 8 + 2 * t + cc;  // streamed index in the tile
          const float4 cj = sid[s];
          const int j = str0 + s;
#pragma unroll
          for (int rr = 0; rr < 2; ++rr) {
            const int i = own0 + row0 + 8 * rr;
            const float4 ri = own_ids[rr];
            float val;
            if (i >= B || j >= B) {
              val = j >= B ? -INFINITY : kNeg;
            } else {
              const float logit =
                  clamped<CLAMP>(acc[nt][2 * rr + cc] * p.inv_temp - cj.w, p.clamp);
              const bool forbid =
                  i != j && (__float_as_int(ri.x) == __float_as_int(cj.x) ||
                             __float_as_int(ri.y) == __float_as_int(cj.y) ||
                             __float_as_int(cj.z) == 0);
              val = forbid ? kNeg : logit;
              if (i == j) diag[rr] += logit;
            }
            acc[nt][2 * rr + cc] = val;
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        float tile_m = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          tile_m = fmaxf(tile_m, fmaxf(acc[nt][2 * rr], acc[nt][2 * rr + 1]));
        tile_m = fmaxf(tile_m, __shfl_xor_sync(0xffffffffu, tile_m, 1));
        tile_m = fmaxf(tile_m, __shfl_xor_sync(0xffffffffu, tile_m, 2));
        const float m_new = fmaxf(run_m[rr], tile_m);
        // a warp whose columns all lie past B has seen -inf only so far
        const float m_safe = m_new == -INFINITY ? 0.f : m_new;
        float part = 0.f;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
          part += __expf(acc[nt][2 * rr] - m_safe) + __expf(acc[nt][2 * rr + 1] - m_safe);
        part += __shfl_xor_sync(0xffffffffu, part, 1);
        part += __shfl_xor_sync(0xffffffffu, part, 2);
        run_s[rr] = run_s[rr] * __expf(run_m[rr] - m_safe) + part;
        run_m[rr] = m_new;
      }
      __syncthreads();  // the stage is consumed
    }

    // the WN column groups of each owner row merged in warpgroup order
    float* part = p.part + ((size_t)c * 2 + slot) * part_floats<kFwd, C>();
    float* m_all = stages;
    float* s_all = m_all + WN * OWN;
    float* d_all = s_all + WN * OWN;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      float dg = diag[rr];
      dg += __shfl_xor_sync(0xffffffffu, dg, 1);
      dg += __shfl_xor_sync(0xffffffffu, dg, 2);
      if (t == 0) {
        const int at = wn * OWN + row0 + 8 * rr;
        m_all[at] = run_m[rr];
        s_all[at] = run_s[rr];
        d_all[at] = dg;
      }
    }
    __syncthreads();
    if (tid < OWN) {
      float m = -INFINITY;
#pragma unroll
      for (int w = 0; w < WN; ++w) m = fmaxf(m, m_all[w * OWN + tid]);
      float sum = 0.f, dg = 0.f;
#pragma unroll
      for (int w = 0; w < WN; ++w) {
        sum += s_all[w * OWN + tid] * expf(m_all[w * OWN + tid] - m);
        dg += d_all[w * OWN + tid];
      }
      part[tid] = m;
      part[OWN + tid] = sum;
      part[2 * OWN + tid] = dg;
    }
    __syncthreads();  // the stages and the owner planes are free again
  }
}

// -- phase 3: the combine -------------------------------------------------------

// Each owner block's partials merged in range order: fwd one item an owner
// block, dq / dk one item per 4 x kThreads values of its rows (a float4 a
// thread). Grid-stride.
template <int MODE, class C>
__host__ __device__ constexpr int combine_items() {
  return MODE == kFwd ? 1 : (C::OWN * C::DP / 4 + kThreads - 1) / kThreads;
}

template <int MODE, class C>
__device__ void combine_phase(const Plan& p, float* out0, float* out1) {
  constexpr int OWN = C::OWN, DP = C::DP, PF = part_floats<MODE, C>();
  constexpr int kChunks = combine_items<MODE, C>();  // items an owner block
  const int R = p.R, G = p.G, B = p.B, D = p.D, tid = threadIdx.x;
  const long long P = (long long)R * R;
  for (int item = blockIdx.x; item < R * kChunks; item += gridDim.x) {
    const int r = item / kChunks, chunk = item - r * kChunks;
    const long long lo = (long long)r * R, hi = lo + R;
    // the ranges that reach owner block r: [c0, c1)
    int c0 = (int)(lo * G / P);
    while (c0 > 0 && range_first(c0, P, G) > lo) --c0;
    while (range_first(c0 + 1, P, G) <= lo) ++c0;
    int c1 = c0 + 1;
    while (c1 < G && range_first(c1, P, G) < hi) ++c1;
    // the first reaches r as its last owner block, the others as their first
    const float* first = p.part + ((size_t)c0 * 2 + slot_of(c0, r, R, G)) * PF;
    auto part = [&](int c) { return c == c0 ? first : p.part + (size_t)c * 2 * PF; };
    if (MODE == kFwd) {
      const int i = r * OWN + tid;
      if (tid < OWN && i < B) {
        float m = -INFINITY;
        for (int c = c0; c < c1; ++c) m = fmaxf(m, __ldcg(part(c) + tid));
        float sum = 0.f, dg = 0.f;
        for (int c = c0; c < c1; ++c) {
          const float* pc = part(c);
          sum += __ldcg(pc + OWN + tid) * expf(__ldcg(pc + tid) - m);
          dg += __ldcg(pc + 2 * OWN + tid);
        }
        const float lse = m + logf(sum);
        out0[i] = lse - dg;  // loss
        out1[i] = lse;
      }
    } else {
      const int e4 = chunk * kThreads + tid;        // float4 index in the (OWN, DP) partial
      const int o = e4 / (DP / 4), d = (e4 % (DP / 4)) * 4, i = r * OWN + o;
      if (o < OWN && i < B && d < D) {
        float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
        for (int c = c0; c < c1; ++c) {
          const float4 v = __ldcg(reinterpret_cast<const float4*>(part(c) + o * DP + d));
          sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
        }
        float* dst = out0 + (size_t)i * D + d;
        if ((D & 3) == 0) {
          *reinterpret_cast<float4*>(dst) = sum;
        } else {
          const float v[4] = {sum.x, sum.y, sum.z, sum.w};
          for (int j = 0; j < 4 && d + j < D; ++j) dst[j] = v[j];
        }
      }
    }
  }
}

// -- the kernel: the three phases, a grid-wide barrier between them --------------

template <int MODE, class C, bool CLAMP>
__global__ void __launch_bounds__(kThreads, 1)
diag_ce_kernel(Problem pr, Plan p, float* out0, float* out1) {
  extern __shared__ __align__(16) float smem[];
  cg::grid_group grid = cg::this_grid();
  split_phase<C>(pr, p);
  grid.sync();
  for (int c = blockIdx.x; c < p.G; c += gridDim.x) {
    if constexpr (C::kWgmma) {
      run_range_wgmma<C, CLAMP>(p, c, smem);
    } else {
      run_range<MODE, C, CLAMP>(p, c, smem);
    }
  }
  grid.sync();
  combine_phase<MODE, C>(p, out0, out1);
}

// -- the launch plan ----------------------------------------------------------

int sm_count() {
  static int cached[64] = {0};
  int dev = 0, n = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
  if (dev < 64) cached[dev] = n;
  return n;
}

// Owner blocks R, ranges G, padded rows Bp and the workspace's carve-up.
template <int MODE, class C>
struct Layout {
  int R, G, Bp;
  size_t plane, part;  // floats of one plane, of all partials
  explicit Layout(int B) {
    R = (B + C::OWN - 1) / C::OWN;
    Bp = R * C::OWN;
    // one range an SM, at least one an owner block, at most one a pair
    const long long pairs = (long long)R * R;
    const int sms = sm_count();
    G = sms > R ? (int)(pairs < sms ? pairs : sms) : R;
    plane = (size_t)Bp * C::DP;
    part = (size_t)G * 2 * part_floats<MODE, C>();
  }
  size_t bytes() const {
    return sizeof(float) * (4 * plane + part) + 2 * sizeof(float4) * (size_t)Bp;
  }
};

// Blocks of diag_ce_kernel<MODE, C, CLAMP> that fit on the device at once: a
// cooperative launch needs all of them resident for its grid-wide barriers.
template <int MODE, class C, bool CLAMP>
int resident_blocks() {
  static int cached[64] = {0};
  int dev = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev]) return cached[dev];
  if (cudaFuncSetAttribute(diag_ce_kernel<MODE, C, CLAMP>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)C::kSmemBytes) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, diag_ce_kernel<MODE, C, CLAMP>,
                                                    kThreads, C::kSmemBytes) != cudaSuccess)
    return 0;
  const int n = per_sm * sm_count();
  if (dev < 64) cached[dev] = n;
  return n;
}

template <int MODE, class C, bool CLAMP>
int launch_tile(const Problem& pr, void* workspace, float* out0, float* out1, void* stream) {
  const Layout<MODE, C> L(pr.B);
  const int resident = resident_blocks<MODE, C, CLAMP>();
  if (L.G < 1 || resident < 1) return (int)cudaErrorInvalidValue;
  float* ws = static_cast<float*>(workspace);
  Plan p;
  p.q_hi = ws;
  p.q_lo = ws + L.plane;
  p.k_hi = ws + 2 * L.plane;
  p.k_lo = ws + 3 * L.plane;
  p.part = ws + 4 * L.plane;
  p.ids = reinterpret_cast<float4*>(p.part + L.part);
  p.rows = p.ids + L.Bp;
  const bool own_k = MODE == kDk;  // dk owns keys and streams query rows
  p.own_hi = own_k ? p.k_hi : p.q_hi;
  p.own_lo = own_k ? p.k_lo : p.q_lo;
  p.str_hi = own_k ? p.q_hi : p.k_hi;
  p.str_lo = own_k ? p.q_lo : p.k_lo;
  p.B = pr.B; p.D = pr.D; p.Bp = L.Bp; p.R = L.R; p.G = L.G;
  p.inv_temp = pr.inv_temp;
  p.clamp = pr.clamp;
  Problem prob = pr;
  void* args[] = {&prob, &p, &out0, &out1};
  // a block a range or a combine item, whichever are more, at most as many as
  // are resident (a block then takes several ranges)
  const int items = L.R * combine_items<MODE, C>();
  int blocks = L.G > items ? L.G : items;
  if (blocks > resident) blocks = resident;
  cudaError_t err =
      cudaLaunchCooperativeKernel((const void*)diag_ce_kernel<MODE, C, CLAMP>, dim3(blocks),
                                  dim3(kThreads), args, C::kSmemBytes, (cudaStream_t)stream);
  return (int)(err != cudaSuccess ? err : cudaGetLastError());
}

bool valid_shape(int B, int D) { return B >= 1 && D >= 1 && D <= kMaxD; }

// Below one 64-row pair an SM (B < ~730 on 132 SMs) 32-row blocks, so that
// the small batches of the item tower spread over more SMs.
bool small_batch(int B) {
  const long long r = (B + Narrow::OWN - 1) / Narrow::OWN;
  return r * r < sm_count();
}

template <int MODE, bool CLAMP>
int launch_clamp(const Problem& p, void* workspace, float* out0, float* out1, void* stream) {
  if (p.D > 128) return launch_tile<MODE, Wide, CLAMP>(p, workspace, out0, out1, stream);
  if (small_batch(p.B))
    return launch_tile<MODE, Small, CLAMP>(p, workspace, out0, out1, stream);
  if constexpr (MODE == kFwd)
    return launch_tile<MODE, WgFwd, CLAMP>(p, workspace, out0, out1, stream);
  return launch_tile<MODE, Narrow, CLAMP>(p, workspace, out0, out1, stream);
}

template <int MODE>
int launch(const Problem& p, void* workspace, float* out0, float* out1, void* stream) {
  if (!valid_shape(p.B, p.D)) return (int)cudaErrorInvalidValue;
  return p.clamp == INFINITY ? launch_clamp<MODE, false>(p, workspace, out0, out1, stream)
                             : launch_clamp<MODE, true>(p, workspace, out0, out1, stream);
}

template <int MODE>
size_t workspace_bytes(int B, int D) {
  if (!valid_shape(B, D)) return 0;
  if (D > 128) return Layout<MODE, Wide>(B).bytes();
  if (small_batch(B)) return Layout<MODE, Small>(B).bytes();
  if constexpr (MODE == kFwd) return Layout<MODE, WgFwd>(B).bytes();
  return Layout<MODE, Narrow>(B).bytes();
}

Problem make_problem(const float* q, const float* k, const float* corr,
                     const int* pos, const int* usr, const int* valid,
                     const float* lse, const float* g, int B, int D,
                     float inv_temp, float clamp) {
  Problem p;
  p.q = q; p.k = k; p.corr = corr;
  p.pos = pos; p.usr = usr; p.valid = valid;
  p.lse = lse; p.g = g;
  p.B = B; p.D = D; p.inv_temp = inv_temp; p.clamp = clamp;
  return p;
}

}  // namespace

// Plain C interface (loaded with ctypes). Every pointer is device memory;
// each function launches on `stream` and returns the cudaError_t of the
// launches (0 = success). `clamp` bounds the logits to [-clamp, clamp];
// +inf for none. Nothing is allocated here: `workspace` holds at
// least diag_ce_workspace_bytes(B, D, mode) bytes (mode 0 fwd, 1 dq, 2 dk),
// computed for the current device, 16-byte aligned.
extern "C" {

int diag_ce_max_dim() { return kMaxD; }

size_t diag_ce_workspace_bytes(int B, int D, int mode) {
  return mode == kFwd ? workspace_bytes<kFwd>(B, D)
                      : mode == kDq ? workspace_bytes<kDq>(B, D) : workspace_bytes<kDk>(B, D);
}

int diag_ce_fwd(const float* q, const float* k, const float* corr,
                const int* pos, const int* usr, const int* valid, int B, int D,
                float inv_temp, float clamp, void* workspace, float* loss, float* lse,
                void* stream) {
  return launch<kFwd>(make_problem(q, k, corr, pos, usr, valid, nullptr,
                                   nullptr, B, D, inv_temp, clamp),
                      workspace, loss, lse, stream);
}

int diag_ce_bwd_dq(const float* q, const float* k, const float* corr,
                   const int* pos, const int* usr, const int* valid,
                   const float* lse, const float* g, int B, int D,
                   float inv_temp, float clamp, void* workspace, float* dq, void* stream) {
  return launch<kDq>(make_problem(q, k, corr, pos, usr, valid, lse, g, B, D,
                                  inv_temp, clamp),
                     workspace, dq, nullptr, stream);
}

int diag_ce_bwd_dk(const float* q, const float* k, const float* corr,
                   const int* pos, const int* usr, const int* valid,
                   const float* lse, const float* g, int B, int D,
                   float inv_temp, float clamp, void* workspace, float* dk, void* stream) {
  return launch<kDk>(make_problem(q, k, corr, pos, usr, valid, lse, g, B, D,
                                  inv_temp, clamp),
                     workspace, dk, nullptr, stream);
}

}  // extern "C"
