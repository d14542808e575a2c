// Fused in-batch contrastive cross-entropy for Hopper (sm_90a), fp32.
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
// Design. The TPU kernel kept the whole (B, D) key matrix in VMEM; at
// B = 8192, D = 128 that is 4 MB, and a Hopper block has at most 227 KB of
// shared memory. So one templated kernel runs in three modes, each block
// owning a tile of kOwn indices and streaming tiles of kStream from the
// other side through shared memory:
//
//   fwd : owns rows, streams key tiles, online softmax (running max/sum)
//   dq  : owns rows, streams key tiles, recomputes P from the saved lse
//   dk  : owns key columns, streams row tiles; the sum over rows stays
//         inside the block, so dk is deterministic and needs no atomics
//         (the TPU summed it across its sequential grid, which Hopper's
//         parallel blocks do not have).
//
// Nothing is padded: indices >= B do not exist and are skipped, so no
// sentinel ids are needed. Logits never reach device memory.
//
// Bound on this card: the (B, B) logit tile is produced by fp32 FMAs on
// the CUDA cores (no tensor cores in this version), each reading its
// operands from shared memory, so the kernel is bound by shared-memory
// bandwidth and fp32 issue, not by device memory (it reads O(B*D) bytes
// for O(B^2*D) FLOPs). wgmma and TMA are the route to a faster version.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;  // 8 warps
constexpr int kOwn = 16;       // indices a block owns
constexpr int kStream = 64;    // indices per streamed tile
constexpr int kMaxD = 256;
constexpr int kAcc = kOwn * kMaxD / kThreads;  // dq/dk outputs per thread
constexpr int kRowsPerWarp = kOwn / (kThreads / 32);
constexpr float kNeg = -3.0e4f;
static_assert(kStream == 64, "phase B of fwd reads two columns per lane");
static_assert(kThreads % kStream == 0 && kOwn % (kThreads / 32) == 0, "tile mapping");

enum Mode { kFwd = 0, kDq = 1, kDk = 2 };

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

// Per-index metadata of one tile, in shared memory.
struct Meta {
  int* pos;
  int* usr;
  int* valid;
  float* corr;
  float* lse;
  float* g;
};

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ Meta carve_meta(int*& ip, float*& fp, int n) {
  Meta m;
  m.pos = ip; ip += n;
  m.usr = ip; ip += n;
  m.valid = ip; ip += n;
  m.corr = fp; fp += n;
  m.lse = fp; fp += n;
  m.g = fp; fp += n;
  return m;
}

__device__ __forceinline__ void load_meta(const Problem& p, Meta m, int base,
                                          int n, int tid) {
  for (int t = tid; t < n; t += kThreads) {
    const int a = base + t;
    const bool in = a < p.B;
    m.pos[t] = in ? p.pos[a] : 0;
    m.usr[t] = in ? p.usr[a] : 0;
    m.valid[t] = in ? p.valid[a] : 0;
    m.corr[t] = in ? p.corr[a] : 0.f;
    m.lse[t] = (in && p.lse) ? p.lse[a] : 0.f;
    m.g[t] = (in && p.g) ? p.g[a] : 0.f;
  }
}

// Rows [base, base + n) of a (B, D) matrix into shared memory with row
// stride D + 1 (odd for even D, so a warp reading one column of 32 rows
// hits 32 different banks). Rows >= B are zero.
__device__ __forceinline__ void load_rows(const float* src, float* dst,
                                          int base, int n, int B, int D,
                                          int tid) {
  const int ld = D + 1;
  for (int e = tid; e < n * D; e += kThreads) {
    const int r = e / D, d = e - r * D;
    const int a = base + r;
    dst[r * ld + d] = a < B ? src[(size_t)a * D + d] : 0.f;
  }
}

template <int MODE>
__global__ void __launch_bounds__(kThreads)
diag_ce_kernel(Problem p, float* out0, float* out1) {
  extern __shared__ float smem[];
  const int D = p.D, ld = D + 1, B = p.B;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int own0 = blockIdx.x * kOwn;

  float* own = smem;                      // kOwn x ld
  float* str = own + kOwn * ld;           // kStream x ld
  float* tile = str + kStream * ld;       // kOwn x (kStream + 1)
  float* fp = tile + kOwn * (kStream + 1);
  int* ip = reinterpret_cast<int*>(fp + 3 * (kOwn + kStream));
  Meta om = carve_meta(ip, fp, kOwn);
  Meta sm = carve_meta(ip, fp, kStream);

  // fwd and dq own query rows and stream keys; dk owns keys, streams rows
  const float* own_src = MODE == kDk ? p.k : p.q;
  const float* str_src = MODE == kDk ? p.q : p.k;
  load_rows(own_src, own, own0, kOwn, B, D, tid);
  load_meta(p, om, own0, kOwn, tid);

  // fwd: running max / sum / diagonal of the rows this warp reduces
  float run_m[kRowsPerWarp], run_s[kRowsPerWarp], diag[kRowsPerWarp];
#pragma unroll
  for (int r = 0; r < kRowsPerWarp; ++r) {
    run_m[r] = -INFINITY;
    run_s[r] = 0.f;
    diag[r] = 0.f;
  }
  // dq / dk: output element tid + c * kThreads of the kOwn x D tile
  float acc[kAcc];
#pragma unroll
  for (int c = 0; c < kAcc; ++c) acc[c] = 0.f;

  // phase-A mapping: one streamed index s, four owned indices
  constexpr int kOwnPerThread = kOwn * kStream / kThreads;
  const int s_a = tid % kStream;
  const int o_a = tid / kStream;

  for (int str0 = 0; str0 < B; str0 += kStream) {
    __syncthreads();  // the previous tile is consumed
    load_rows(str_src, str, str0, kStream, B, D, tid);
    load_meta(p, sm, str0, kStream, tid);
    __syncthreads();

    // phase A: one tile of logits (fwd) or dlogits (dq, dk)
    float dots[kOwnPerThread];
#pragma unroll
    for (int c = 0; c < kOwnPerThread; ++c) dots[c] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float x = str[s_a * ld + d];
#pragma unroll
      for (int c = 0; c < kOwnPerThread; ++c)
        dots[c] = fmaf(own[(o_a + c * (kThreads / kStream)) * ld + d], x,
                       dots[c]);
    }
#pragma unroll
    for (int c = 0; c < kOwnPerThread; ++c) {
      const int o = o_a + c * (kThreads / kStream);
      const int oa = own0 + o, sb = str0 + s_a;
      // (row i, column j) of the logit matrix
      const int i = MODE == kDk ? sb : oa;
      const int j = MODE == kDk ? oa : sb;
      const int ri = MODE == kDk ? s_a : o, cj = MODE == kDk ? o : s_a;
      const Meta& rm = MODE == kDk ? sm : om;
      const Meta& cm = MODE == kDk ? om : sm;
      float val;
      if (i >= B || j >= B) {
        val = MODE == kFwd ? (j >= B ? -INFINITY : kNeg) : 0.f;
      } else {
        const float logit = dots[c] * p.inv_temp - cm.corr[cj];
        const bool forbid =
            i != j && (rm.pos[ri] == cm.pos[cj] || rm.usr[ri] == cm.usr[cj] ||
                       cm.valid[cj] == 0);
        if (MODE == kFwd) {
          val = forbid ? kNeg : logit;
        } else {
          const float prob = expf(logit - rm.lse[ri]);
          val = forbid ? 0.f
                       : (prob - (i == j ? 1.f : 0.f)) * rm.g[ri] * p.inv_temp;
        }
      }
      tile[o * (kStream + 1) + s_a] = val;
    }
    __syncthreads();

    // phase B
    if (MODE == kFwd) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        const int o = warp * kRowsPerWarp + r;
        const float v0 = tile[o * (kStream + 1) + lane];
        const float v1 = tile[o * (kStream + 1) + lane + 32];
        const float m_new = fmaxf(run_m[r], warp_max(fmaxf(v0, v1)));
        const float part = warp_sum(expf(v0 - m_new) + expf(v1 - m_new));
        run_s[r] = run_s[r] * expf(run_m[r] - m_new) + part;
        run_m[r] = m_new;
        const int row = own0 + o;
        if (str0 + lane == row) diag[r] += v0;
        if (str0 + lane + 32 == row) diag[r] += v1;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kAcc; ++c) {
        const int e = tid + c * kThreads;
        if (e < kOwn * D) {
          const int o = e / D, d = e - o * D;
          float sum = 0.f;
#pragma unroll 8
          for (int s = 0; s < kStream; ++s)
            sum = fmaf(tile[o * (kStream + 1) + s], str[s * ld + d], sum);
          acc[c] += sum;
        }
      }
    }
  }

  if (MODE == kFwd) {
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int row = own0 + warp * kRowsPerWarp + r;
      const float dg = warp_sum(diag[r]);
      if (lane == 0 && row < B) {
        const float lse = run_m[r] + logf(run_s[r]);
        out0[row] = lse - dg;  // loss
        out1[row] = lse;
      }
    }
  } else {
#pragma unroll
    for (int c = 0; c < kAcc; ++c) {
      const int e = tid + c * kThreads;
      if (e < kOwn * D) {
        const int o = e / D, d = e - o * D;
        if (own0 + o < B) out0[(size_t)(own0 + o) * D + d] = acc[c];
      }
    }
  }
}

size_t smem_bytes(int D) {
  return sizeof(float) * ((size_t)(kOwn + kStream) * (D + 1) +
                          (size_t)kOwn * (kStream + 1) +
                          3 * (size_t)(kOwn + kStream)) +
         sizeof(int) * 3 * (size_t)(kOwn + kStream);
}

template <int MODE>
int launch(const Problem& p, float* out0, float* out1, void* stream) {
  if (p.B < 1 || p.D < 1 || p.D > kMaxD) return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes(p.D);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        diag_ce_kernel<MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((p.B + kOwn - 1) / kOwn);
  diag_ce_kernel<MODE><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      p, out0, out1);
  return (int)cudaGetLastError();
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
