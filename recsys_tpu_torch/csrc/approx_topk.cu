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
// The (B, n) score matrix is never written: a block computes the scores of
// a (64 queries) x (128 bins) tile one slice after the other and keeps each
// bin's running maximum and column in registers. Slices are visited in
// column order and a later slice wins only when strictly greater, so ties
// keep the lowest column. No atomics, a fixed order of every sum: two calls
// give the same bits.
//
//   * fp32 (approx_scan_f32): plain fp32 fused multiply-adds in k order, the
//     precision of the port's exact path (no TF32, which would part the two
//     paths): the values differ from cuBLAS's product only by the order of
//     the sum. The prior is added after the sum, as the plain form adds it.
//   * int8 (approx_scan_int8): __dp4a, four int8 products into an int32
//     accumulator, exact; the bins are taken of the dequantized scores
//     float(acc) * alpha[b], as the JAX package bins them. Where |acc| < 2^23
//     the float is exact and two sums that differ stay apart after the
//     multiply, so these are also the bins of the int32 sums.
//
// Bound on this card: operations. At B = 1024 queries, n = 1,000,001 items
// and D = 128 the scan is 2.6e11 operations against 0.5 GB of items: 3.9 ms
// at the 67 TFLOP/s of fp32 outside the tensor cores, 0.13 ms at the int8
// tensor-core rate. This first design is the plain register-tiled product:
// tiles of 16 k-values (64 int8) staged in shared memory (16-byte global
// loads where the width and the pointers allow, transposed on the way in),
// each thread 4 queries x 8 bins. __dp4a runs on the integer pipe, far from
// the tensor cores' int8 rate; wgmma, TMA and a persistent grid are later
// work. Only the slices that hold a real column of a block's bins are
// visited.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBM = 64;              // queries a block
constexpr int kBN = 128;             // bins a block
constexpr int kBK = 16;              // k a stage: fp32 values, or int8 words of 4
constexpr int kTX = 16, kTY = 16;    // threads over bins, over queries
constexpr int kTM = kBM / kTY;       // 4 queries a thread: ty*4 + i
constexpr int kTN = kBN / kTX;       // 8 bins a thread: tx*4 + j, 64 + tx*4 + j
constexpr int kThreads = kTX * kTY;  // 256
constexpr int kPadM = kBM + 4;       // row strides of the staged tiles: float4
constexpr int kPadN = kBN + 4;       // reads stay aligned, the transposed stores
                                     // conflict at most two ways
__device__ __forceinline__ int bin_of(int j0, int tx, int j) {
  return j0 + (j < 4 ? tx * 4 + j : kBN / 2 + tx * 4 + (j - 4));
}

// ---- staging: 4 words of a row of a (rows, D) matrix ---------------------------

// fp32: 4 consecutive values of row `row` from k, zero past D or past the rows.
__device__ __forceinline__ float4 load4_f32(const float* __restrict__ m, long long row,
                                            bool valid, int k, int D, bool vec) {
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (!valid || k >= D) return v;
  const float* p = m + row * (long long)D + k;
  if (vec) return *reinterpret_cast<const float4*>(p);  // D % 4 == 0, 16-byte base
  v.x = p[0];
  if (k + 1 < D) v.y = p[1];
  if (k + 2 < D) v.z = p[2];
  if (k + 3 < D) v.w = p[3];
  return v;
}

// int8: 16 consecutive int8 (4 words) of row `row` from byte k, zero past D.
__device__ __forceinline__ int4 load16_i8(const int8_t* __restrict__ m, long long row,
                                          bool valid, int k, int D, bool vec) {
  int4 v = make_int4(0, 0, 0, 0);
  if (!valid || k >= D) return v;
  const int8_t* p = m + row * (long long)D + k;
  if (vec) return *reinterpret_cast<const int4*>(p);  // D % 16 == 0, 16-byte base
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (k + b < D) w[b / 4] |= (static_cast<int>(p[b]) & 0xff) << (8 * (b % 4));
  return make_int4(w[0], w[1], w[2], w[3]);
}

// ---- the scan ----------------------------------------------------------------

// kMode: kF32 bins fp32 scores (+ prior); kInt8 bins float(acc) * alpha[q].
// Word is what a stage holds (a float, or 4 int8).
enum Mode { kF32 = 0, kInt8 = 1 };

template <int kMode> struct Types {
  using Elem = int8_t;
  using Word = int;
  using Vec = int4;
};
template <> struct Types<kF32> {
  using Elem = float;
  using Word = float;
  using Vec = float4;
};

__device__ __forceinline__ float4 load4(const float* m, long long row, bool valid, int word,
                                        int D, bool vec) {
  return load4_f32(m, row, valid, word, D, vec);
}
__device__ __forceinline__ int4 load4(const int8_t* m, long long row, bool valid, int word,
                                      int D, bool vec) {
  return load16_i8(m, row, valid, 4 * word, D, vec);
}
__device__ __forceinline__ float mac(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ int mac(int a, int b, int c) { return __dp4a(a, b, c); }

// One block: queries [q0, q0 + 64) x bins [j0, j0 + 128), every slice that
// holds a real column of them. The global loads of the next (slice, k-tile)
// step are in flight while the current one is multiplied.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
approx_scan_kernel(const typename Types<kMode>::Elem* __restrict__ u,
                   const typename Types<kMode>::Elem* __restrict__ items,
                   const float* __restrict__ side, int B, int n, int D, int O, int slices,
                   bool vec, float* __restrict__ out_val,
                   int* __restrict__ out_col) {
  using Word = typename Types<kMode>::Word;
  using Vec = typename Types<kMode>::Vec;
  __shared__ __align__(16) Word As[kBK][kPadM];
  __shared__ __align__(16) Word Bs[kBK][kPadN];
  const int tid = threadIdx.x, tx = tid % kTX, ty = tid / kTX;
  const int q0 = blockIdx.y * kBM, j0 = blockIdx.x * kBN;

  float best[kTM][kTN];
  int col[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      best[i][j] = -INFINITY;
      col[i][j] = bin_of(j0, tx, j);  // a bin that holds nothing above the floor: its first column
    }
  float scale[kTM];  // kInt8: the rows' alpha
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty * 4 + i;
    scale[i] = (kMode == kInt8 && row < B) ? side[row] : 1.f;
  }
  // the slices in which some bin of this block holds a real column
  const int last = j0 < n
      ? static_cast<int>(min(static_cast<long long>(slices),
                             (static_cast<long long>(n) - j0 + O - 1) / O))
      : 0;
  const int words = kMode == kF32 ? D : (D + 3) / 4;  // k of a row, in words
  const int ktiles = (words + kBK - 1) / kBK;
  const int steps = last * ktiles;

  // staging: a thread brings 4 words of one query row and of two item rows
  const int sr = tid / (kBK / 4), sk = (tid % (kBK / 4)) * 4;  // sr < 64
  Vec a, b[2];
  auto fetch = [&](int step) {
    const int t = step / ktiles, w = (step % ktiles) * kBK + sk;
    const long long c0 = static_cast<long long>(t) * O + j0;
    a = load4(u, q0 + sr, q0 + sr < B, w, D, vec);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sr + h * kBM;
      b[h] = load4(items, c0 + r, j0 + r < O && c0 + r < n, w, D, vec);
    }
  };
  if (steps > 0) fetch(0);

  Word acc[kTM][kTN];
  for (int step = 0; step < steps; ++step) {
    __syncthreads();  // the previous tile's reads are done
    As[sk + 0][sr] = a.x; As[sk + 1][sr] = a.y; As[sk + 2][sr] = a.z; As[sk + 3][sr] = a.w;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = sr + h * kBM;
      Bs[sk + 0][r] = b[h].x; Bs[sk + 1][r] = b[h].y;
      Bs[sk + 2][r] = b[h].z; Bs[sk + 3][r] = b[h].w;
    }
    __syncthreads();
    if (step + 1 < steps) fetch(step + 1);
    if (step % ktiles == 0) {
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = Word(0);
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const Vec av = *reinterpret_cast<const Vec*>(&As[kk][ty * 4]);
      const Vec b0 = *reinterpret_cast<const Vec*>(&Bs[kk][tx * 4]);
      const Vec b1 = *reinterpret_cast<const Vec*>(&Bs[kk][kBN / 2 + tx * 4]);
      const Word ar[kTM] = {av.x, av.y, av.z, av.w};
      const Word br[kTN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < kTM; ++i)
#pragma unroll
        for (int j = 0; j < kTN; ++j) acc[i][j] = mac(ar[i], br[j], acc[i][j]);
    }
    if (step % ktiles != ktiles - 1) continue;
    // the slice is summed: its scores into the bins' maxima
    const int t = step / ktiles;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int bin = bin_of(j0, tx, j);
      const long long c = static_cast<long long>(t) * O + bin;
      const bool real = bin < O && c < n && c != 0;
      const float p = (kMode == kF32 && side != nullptr && real) ? side[c] : 0.f;
#pragma unroll
      for (int i = 0; i < kTM; ++i) {
        float s = -INFINITY;
        if (real) {
          if constexpr (kMode == kF32) s = acc[i][j] + p;
          else s = __int2float_rn(acc[i][j]) * scale[i];
        }
        if (s > best[i][j]) {  // strictly: equal scores keep the lower column
          best[i][j] = s;
          col[i][j] = static_cast<int>(c);
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= B) continue;
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int bin = bin_of(j0, tx, j);
      if (bin >= O) continue;
      const long long o = static_cast<long long>(row) * O + bin;
      out_val[o] = best[i][j];
      out_col[o] = col[i][j];
    }
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// the launch's shape, or an error for sizes outside what the kernels index
cudaError_t grid_of(int B, int n, int D, int O, int slices, dim3* grid) {
  if (B < 0 || n < 1 || D < 1 || O < 1 || slices < 1) return cudaErrorInvalidValue;
  if (static_cast<long long>(O) * slices < n) return cudaErrorInvalidValue;
  if (static_cast<long long>(O) * slices > INT32_MAX) return cudaErrorInvalidValue;
  const long long qblocks = (static_cast<long long>(B) + kBM - 1) / kBM;
  if (qblocks > 65535) return cudaErrorInvalidValue;
  *grid = dim3((O + kBN - 1) / kBN, static_cast<unsigned>(qblocks));
  return cudaSuccess;
}

}  // namespace

extern "C" {

// Every pointer is a contiguous device array: u (B, D) fp32, items (n, D)
// fp32, prior (n,) fp32 or null, out_val / out_col (B, O) fp32 / int32.
// Returns the cudaError_t of the launch; a call with no queries launches
// nothing.
int approx_scan_f32(const void* u, const void* items, const void* prior, int B, int n,
                    int D, int O, int slices, void* out_val, void* out_col, void* stream) {
  dim3 grid;
  cudaError_t err = grid_of(B, n, D, O, slices, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = D % 4 == 0 && aligned16(u) && aligned16(items);
  approx_scan_kernel<kF32><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(u), static_cast<const float*>(items),
      static_cast<const float*>(prior), B, n, D, O, slices, vec,
      static_cast<float*>(out_val), static_cast<int*>(out_col));
  return static_cast<int>(cudaGetLastError());
}

// uq (B, D) int8, q (n, D) int8, alpha (B,) fp32; out_val (B, O) fp32 (the
// dequantized scores' bins), out_col (B, O) int32.
int approx_scan_int8(const void* uq, const void* q, const void* alpha, int B, int n, int D,
                     int O, int slices, void* out_val, void* out_col, void* stream) {
  dim3 grid;
  cudaError_t err = grid_of(B, n, D, O, slices, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (alpha == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0) return static_cast<int>(cudaGetLastError());
  const bool vec = D % 16 == 0 && aligned16(uq) && aligned16(q);
  approx_scan_kernel<kInt8><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(uq), static_cast<const int8_t*>(q),
      static_cast<const float*>(alpha), B, n, D, O, slices, vec,
      static_cast<float*>(out_val), static_cast<int*>(out_col));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
