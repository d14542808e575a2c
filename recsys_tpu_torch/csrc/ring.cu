// Ring all-gather for Hopper (sm_90a), one way and both ways.
//
// Replaces the TPU kernels recsys_tpu/parallel/pallas_ring.py:
// _ring_all_gather_kernel and _ring_all_gather_bidi_kernel (behind
// ring_all_gather and ring_sharded_topk). Contract, to the bit: ranks
// 0..S-1 each hold a chunk x_r of chunk_bytes bytes; every rank's output is
// concat(x_0 .. x_{S-1}); data moves only from a rank to a ring neighbour
// (to the right; to the left as well when both ways), one chunk a hop, and a
// chunk that arrives at hop t is the one sent on at hop t+1. One way takes
// S-1 hops; both ways ceil((S-1)/2): the chunks from the left arrive
// clockwise (S/2 hops), those from the right counter-clockwise ((S-1)/2).
// Forward only, as the TPU kernel (the callers differentiate nothing
// through it).
//
// Thought through again for this card, not carried over. The TPU kernel
// receives into two comm_buf slots in VMEM, because a neighbour cannot
// address its output block, copies each arrival out of the slot, and needs a
// ready handshake because the two slots are reused. Here every rank's output
// lies in device memory that a neighbour can address through a pointer (its
// own memory for virtual ranks on one card, a peer mapping across cards). So
// a rank WRITES THE CHUNK STRAIGHT INTO ITS NEIGHBOUR'S OUTPUT AT THE CHUNK'S
// FINAL PLACE and forwards from its own output. Every place is written
// exactly once: no slot, no reuse, no ready handshake, no copy-out, and half
// the bytes move. What is left of the protocol is one flag per arrival.
//
// Bound on this card: device-memory bytes; the kernel computes nothing. Each
// rank reads and writes S * chunk_bytes. What the design does about it:
//   * Bytes, not types: 16-byte vectors where both pointers allow it, 4-byte
//     words otherwise, single bytes for the tail, decided per copy at run
//     time (a ragged chunk leaves odd places unaligned). Four loads are in
//     flight per thread before the first store.
//   * Block b of a rank owns slice b of every chunk and depends only on
//     block b of its neighbour, through a flag of its own per hop and
//     direction. No barrier across the blocks of a rank, none across ranks.
//     The two directions are separate blocks (blockIdx.z) and overlap.
//   * Ordering. Writer: all threads store, __syncthreads(), one thread
//     __threadfence_system() and a release store of the call's epoch on the
//     receiver's flag. Reader: one thread spins on an acquire load,
//     __syncthreads(), then all threads read the forwarded bytes past L1
//     (ld.global.cg), which is not coherent between SMs.
//   * Flags live in the RECEIVER's memory (it spins locally; across cards the
//     writer's store is a posted peer write) and are compared against a call
//     epoch that the wrapper increments: no reset between calls, and a flag
//     left by an earlier call never satisfies a later one.
//   * A spinning block needs its neighbour's block to be running: the whole
//     grid must be resident at once. The wrapper keeps it within
//     ring_max_resident_blocks() and raises beyond it.
//   * No wait is unbounded: a spin gives up after spin_cycles of clock64(),
//     writes an error word (code, rank, hop, direction) and leaves; the other
//     spinners see the word and leave too. The wrapper's check_errors() reads
//     it. The launch itself never synchronises.
//
// Interface that assumes no single card: the launch serves ranks
// [rank_begin, rank_begin + rank_count) of S and takes, for all S ranks, the
// output pointers, the local pointers and the flag pointers. On one card one
// launch serves all ranks (blockIdx.y = rank). On peer-mapped cards the same
// kernel would be launched once a card with the same tables; there a launch
// also waits for its own last arrival before it ends, so that the end of a
// card's launch means its output is whole. The tables travel as kernel
// parameters: outputs are new tensors every call, and a table in device
// memory would cost a host-to-device copy that makes the stream wait.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kMaxRanks = 32;
constexpr unsigned kErrTimeout = 1u;

struct RingArgs {
  char* out[kMaxRanks];          // rank r's (S * chunk_bytes) output
  const char* local[kMaxRanks];  // rank r's chunk
  unsigned* flags[kMaxRanks];    // rank r's arrivals: [2][S - 1][max_blocks]
  unsigned* err;                 // 4 words: code, rank, hop, direction
  long long chunk_bytes;
  long long spin_cycles;
  int S, rank_begin, hops_cw, hops_ccw, max_blocks;
  unsigned epoch;
};

__device__ __forceinline__ unsigned ld_acquire_sys(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.sys.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_release_sys(unsigned* p, unsigned v) {
  asm volatile("st.release.sys.global.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}

// n units of T from src to dst by the whole block; loads go past L1.
template <typename T>
__device__ __forceinline__ void copy_units(T* dst, const T* src, long long n) {
  const long long step = blockDim.x;
  long long i = threadIdx.x;
  for (; i + (kUnroll - 1) * step < n; i += kUnroll * step) {
    T v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldcg(src + i + u * step);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * step] = v[u];
  }
  for (; i < n; i += step) dst[i] = __ldcg(src + i);
}

__device__ __forceinline__ void copy_bytes(char* dst, const char* src, long long n) {
  const uintptr_t both = reinterpret_cast<uintptr_t>(dst) | reinterpret_cast<uintptr_t>(src);
  long long done = 0;
  if ((both & 15) == 0) {
    copy_units(reinterpret_cast<int4*>(dst), reinterpret_cast<const int4*>(src), n >> 4);
    done = (n >> 4) << 4;
  } else if ((both & 3) == 0) {
    copy_units(reinterpret_cast<int*>(dst), reinterpret_cast<const int*>(src), n >> 2);
    done = (n >> 2) << 2;
  }
  copy_units(dst + done, src + done, n - done);
}

// Block-wide wait until *flag has reached this call's epoch. False when the
// spin ran out of its budget or another block reported an error.
__device__ bool wait_for(const unsigned* flag, unsigned epoch, long long spin_cycles,
                         unsigned* err, int rank, int hop, int dir) {
  __shared__ int arrived;
  if (threadIdx.x == 0) {
    const long long start = clock64();
    int ok = 1;
    unsigned spins = 0;
    while (static_cast<int>(ld_acquire_sys(flag) - epoch) < 0) {
      if ((++spins & 63u) != 0) continue;
      if (*reinterpret_cast<volatile unsigned*>(err) != 0u) {
        ok = 0;
        break;
      }
      if (clock64() - start > spin_cycles) {
        if (atomicCAS(err, 0u, kErrTimeout) == 0u) {
          err[1] = static_cast<unsigned>(rank);
          err[2] = static_cast<unsigned>(hop);
          err[3] = static_cast<unsigned>(dir);
          __threadfence_system();
        }
        ok = 0;
        break;
      }
    }
    arrived = ok;
  }
  __syncthreads();
  const bool ok = arrived != 0;
  __syncthreads();  // `arrived` is free for the next wait
  return ok;
}

__global__ void __launch_bounds__(kThreads) ring_all_gather_kernel(const RingArgs a) {
  const int S = a.S;
  const int b = blockIdx.x;
  const int r = a.rank_begin + blockIdx.y;
  const int dir = blockIdx.z;  // 0: to the right (clockwise), 1: to the left
  const int hops = dir == 0 ? a.hops_cw : a.hops_ccw;
  const int to = dir == 0 ? (r + 1) % S : (r + S - 1) % S;

  // this block's slice of every chunk, a multiple of 16 bytes but for the last
  long long slice = (a.chunk_bytes + gridDim.x - 1) / gridDim.x;
  slice = (slice + 15) & ~15LL;
  const long long lo = min(static_cast<long long>(b) * slice, a.chunk_bytes);
  const long long n = min(lo + slice, a.chunk_bytes) - lo;

  char* mine = a.out[r];
  char* theirs = a.out[to];
  const char* local = a.local[r] + lo;
  const long long flag_base = static_cast<long long>(dir) * (S - 1) * a.max_blocks + b;
  const unsigned* my_flags = a.flags[r] + flag_base;
  unsigned* their_flags = a.flags[to] + flag_base;

  if (dir == 0) copy_bytes(mine + r * a.chunk_bytes + lo, local, n);  // own chunk, own place

  for (int t = 0; t < hops; ++t) {
    // the chunk that leaves rank r at hop t; it came in at hop t - 1
    const int c = dir == 0 ? (r - t + S) % S : (r + t) % S;
    const char* src = local;
    if (t > 0) {
      if (!wait_for(my_flags + (t - 1) * a.max_blocks, a.epoch, a.spin_cycles, a.err, r, t - 1, dir))
        return;
      src = mine + c * a.chunk_bytes + lo;
    }
    copy_bytes(theirs + c * a.chunk_bytes + lo, src, n);
    __syncthreads();
    if (threadIdx.x == 0) {
      __threadfence_system();
      st_release_sys(their_flags + t * a.max_blocks, a.epoch);
    }
  }
  // the launch that serves rank r ends only when r's last chunk is in
  if (hops > 0)
    wait_for(my_flags + (hops - 1) * a.max_blocks, a.epoch, a.spin_cycles, a.err, r, hops - 1, dir);
}

}  // namespace

// Launch for ranks [rank_begin, rank_begin + rank_count). out_ptrs, local_ptrs
// and flag_ptrs are host arrays of S device pointers. Returns cudaGetLastError()
// (or cudaErrorInvalidValue for an S the parameter tables cannot hold).
extern "C" int ring_all_gather(const void* const* out_ptrs, const void* const* local_ptrs,
                               const void* const* flag_ptrs, void* err, int S, int rank_begin,
                               int rank_count, long long chunk_bytes, int blocks,
                               int max_blocks, int bidirectional, unsigned epoch,
                               long long spin_cycles, void* stream) {
  if (S < 2 || S > kMaxRanks || blocks < 1 || blocks > max_blocks || rank_count < 1 ||
      rank_begin < 0 || rank_begin + rank_count > S)
    return static_cast<int>(cudaErrorInvalidValue);
  RingArgs a;
  for (int r = 0; r < S; ++r) {
    a.out[r] = static_cast<char*>(const_cast<void*>(out_ptrs[r]));
    a.local[r] = static_cast<const char*>(local_ptrs[r]);
    a.flags[r] = static_cast<unsigned*>(const_cast<void*>(flag_ptrs[r]));
  }
  a.err = static_cast<unsigned*>(err);
  a.chunk_bytes = chunk_bytes;
  a.spin_cycles = spin_cycles;
  a.S = S;
  a.rank_begin = rank_begin;
  a.hops_cw = bidirectional ? S / 2 : S - 1;
  a.hops_ccw = bidirectional ? (S - 1) / 2 : 0;
  a.max_blocks = max_blocks;
  a.epoch = epoch;
  const dim3 grid(blocks, rank_count, a.hops_ccw > 0 ? 2 : 1);
  ring_all_gather_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// How many blocks of the kernel the card holds at once, or -cudaError_t.
extern "C" int ring_max_resident_blocks(int device) {
  int per_sm = 0, sms = 0;
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, ring_all_gather_kernel,
                                                                kThreads, 0);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return e == cudaSuccess ? per_sm * sms : -static_cast<int>(e);
}

// The SM clock in kHz (clock64() counts its cycles), or -cudaError_t.
extern "C" int ring_clock_khz(int device) {
  int khz = 0;
  const cudaError_t e = cudaDeviceGetAttribute(&khz, cudaDevAttrClockRate, device);
  return e == cudaSuccess ? khz : -static_cast<int>(e);
}

extern "C" int ring_max_ranks() { return kMaxRanks; }
