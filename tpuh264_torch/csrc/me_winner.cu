// K12: the stage-A winner of the P encode's motion search -- the two-
// phase rate-biased selection on K1's SAD table -- in two launches a
// reference.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py `_int_winner`
// (:332; called :714-717), not a pallas_call.  Its plain PyTorch version
// is kernels/pframe.py `_int_winner_plain`.
//
// What it computes, exactly as the plain version, on the table sads [S,
// R, C, 289] int32 (candidate k = (dy + 8) * 17 + dx + 8, dy-major):
//  * phase 1: each MB's first-index argmin of 4 * sad + lam * rate0(k),
//    rate0 = golden mv_rate_bits(4 dx, 4 dy), and the count of MBs that
//    won each candidate, a stream's counts [S, 289] int32 summed by
//    integer atomics (order-free: the same counts every run);
//  * then the caller may sum the counts over a process group (a row-
//    sharded frame, dist/mesh.py): they leave the kernel between the
//    launches;
//  * phase 2: the stream's mode of the winners, the first-index argmax
//    of its counts (gy, gx = its dy, dx); each MB's first-index argmin of
//    4 * sad + lam * rate_q(4 (dx - gx), 4 (dy - gy)), pframe.py
//    `_rate_q` (ue lengths, `ue_len` of inter_common.cuh), giving iy0,
//    ix0 = its dy, dx.
// Costs are int32 as the plain version's (4 * sad wraps where its does:
// the sums are taken in uint32 and read back as int32).
//
// What bounds it on the H100: bytes.  The least it must move is one read
// of the table (37.7 MB at 1080p x 4: 0.011 ms at 3.35 TB/s) and the
// winners out.  The two launches read the table twice; the second read
// is meant to hit the 50 MB L2.
//
// Design.  The first design (a warp a MB, a block a few MBs) made one
// global atomic a MB on a stream's 289 counters -- "rigid" scenes give
// most MBs one winner, so they serialise on one address -- and had every
// warp of phase 2 re-read the counts and take their argmax; this one
// takes half the time of each phase on an H100:
//  * A persistent grid: `blocks` blocks (the caller sizes it to the
//    card's SMs: two blocks an SM, which beat one, three and four on an
//    H100, tools/time_refs.py --k12-blocks), block b the contiguous chunk
//    of MBs [b n, b n + n), n = ceil(MBs / blocks); warp w of the block
//    takes the chunk's MBs w, w + kWarps, ...  Each warp loads its next
//    MB's row while it reduces the current one (two rows of 1,156 B in
//    flight a warp; loading two ahead was slower).
//  * A chunk is walked stream by stream (a chunk may span streams: each
//    stream's part is a segment, every warp goes through every segment's
//    block barriers).  Phase 1 gathers a segment's winners in a shared
//    histogram of 289 bins by shared atomics, then flushes one global
//    atomicAdd a nonzero bin; phase 2 takes the stream's mode once a
//    segment (warp 0, from the counts; the block reads it from shared
//    memory) and each thread its candidates' rate relative to it.
//  * Phase 1 walks each chunk forwards, phase 2 backwards: phase 2's
//    first reads are what phase 1 read last, the likeliest to be in L2.
//  * Lane l holds candidates l + 32 i (i = 0 .. 9): each warp load is 128
//    consecutive bytes of the MB's row.  A lane keeps its first minimum
//    (strict <, in increasing k); the warp's first-index minimum is the
//    least cost by `redux.sync` min, then the least k among the lanes
//    that hold it.  The argmax of the counts goes the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inter_common.cuh"  // ue_len

namespace {

constexpr int kSR = 8;           // search range
constexpr int kN = 2 * kSR + 1;  // 17 offsets an axis
constexpr int kNN = kN * kN;     // 289 candidates
constexpr int kPer = (kNN + 31) / 32;  // 10 candidates a lane (at most)
constexpr int kWarps = 8;        // warps a block
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 1 << 30;   // above every candidate index

struct WinArgs {
  const int32_t* sads;   // [S, R, C, 289]
  int32_t* counts;       // [S, 289]: zero before phase 1
  int32_t *iy0, *ix0;    // [S, R, C]
  int32_t *gy, *gx;      // [S]
  int S, R, C, lam;
  int blocks;            // the grid: at most one a warp's MB
  int phase;
};

constexpr int kPtrs = 6;
constexpr int kInts = 6;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k12_operands` builds them (n[4] the most blocks a
// launch, n[5] the phase).
inline WinArgs win_args(void* const* p, const int* n) {
  WinArgs a;
  a.sads = static_cast<const int32_t*>(p[0]);
  a.counts = static_cast<int32_t*>(p[1]);
  a.iy0 = static_cast<int32_t*>(p[2]), a.ix0 = static_cast<int32_t*>(p[3]);
  a.gy = static_cast<int32_t*>(p[4]), a.gx = static_cast<int32_t*>(p[5]);
  a.S = n[0], a.R = n[1], a.C = n[2], a.lam = n[3];
  const int most = (a.S * a.R * a.C + kWarps - 1) / kWarps;
  a.blocks = n[4] < 1 ? 1 : n[4] < most ? n[4] : most;
  a.phase = n[5];
  return a;
}

// A lane's candidates of one MB's row.
struct Row {
  int v[kPer];
};

__device__ __forceinline__ void load_row(Row& r, const int32_t* row,
                                         int lane) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    r.v[i] = k < kNN ? row[k] : 0;
  }
}

// The warp's first index of the least `v` among the lanes' (v, k), each
// lane's k its first of its least v.
__device__ __forceinline__ int first_min(int v, int k) {
  const int least = __reduce_min_sync(kFull, v);
  return __reduce_min_sync(kFull, v == least ? k : kNone);
}

// The first-index argmin of the row's costs 4 * sad + pen (int32, wrapping).
__device__ __forceinline__ int winner(const Row& r, const int* pen,
                                      int lane) {
  int best = 0, bk = kNone;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    if (k < kNN) {
      const int cost = (int)(4u * (unsigned)r.v[i] + (unsigned)pen[i]);
      if (bk == kNone || cost < best) best = cost, bk = k;
    }
  }
  return first_min(best, bk);
}

// The first-index argmax of the stream's 289 counts (the phase-1 mode).
__device__ __forceinline__ int mode_of(const int32_t* counts, int lane) {
  int best = -1, bk = kNone;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    if (k < kNN && counts[k] > best) best = counts[k], bk = k;
  }
  const int most = __reduce_max_sync(kFull, best);
  return __reduce_min_sync(kFull, best == most ? bk : kNone);
}

// lam times each of the lane's candidates' rate relative to (gy, gx)
// (phase 1: (0, 0), the rate0 table).
__device__ __forceinline__ void penalties(int* pen, int lam, int gy, int gx,
                                          int lane) {
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    const int dy = k / kN - kSR, dx = k % kN - kSR;
    pen[i] = lam * (ue_len(4 * (dx - gx)) + ue_len(4 * (dy - gy)));
  }
}

__global__ void __launch_bounds__(32 * kWarps)
    me_winner_kernel(const __grid_constant__ WinArgs a) {
  __shared__ int hist[kNN];  // phase 1: the segment's winners
  __shared__ int mode;       // phase 2: the segment's stream's mode
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = a.R * a.C, mbs = a.S * per;
  const int chunk = (mbs + a.blocks - 1) / a.blocks;
  const int lo = blockIdx.x * chunk, hi = min(mbs, lo + chunk);
  if (lo >= hi) return;  // uniform across the block
  const bool one = a.phase == 1;
  // the warp's j-th MB of the walk (forwards in phase 1, else backwards)
  const int n = (hi - lo - warp + kWarps - 1) / kWarps;
  auto mb_of = [&](int j) {
    return one ? lo + warp + kWarps * j : hi - 1 - warp - kWarps * j;
  };
  int pen[kPer];
  if (one) {
    penalties(pen, a.lam, 0, 0, lane);
    for (int k = threadIdx.x; k < kNN; k += 32 * kWarps) hist[k] = 0;
  }
  Row next;  // the warp's next row, loading
  if (n > 0) load_row(next, a.sads + (size_t)mb_of(0) * kNN, lane);
  int j = 0;
  const int s0 = (one ? lo : hi - 1) / per, s1 = (one ? hi - 1 : lo) / per;
  for (int s = s0;; s += one ? 1 : -1) {
    const int seg_lo = max(lo, s * per), seg_hi = min(hi, (s + 1) * per);
    if (!one) {
      if (warp == 0) {
        const int g = mode_of(a.counts + (size_t)s * kNN, lane);
        if (lane == 0) {
          mode = g;
          if (seg_lo == s * per)
            a.gy[s] = g / kN - kSR, a.gx[s] = g % kN - kSR;
        }
      }
      __syncthreads();  // the mode is in shared memory
      penalties(pen, a.lam, mode / kN - kSR, mode % kN - kSR, lane);
    } else {
      __syncthreads();  // the histogram is zero
    }
    for (; j < n; ++j) {
      const int m = mb_of(j);
      if (m < seg_lo || m >= seg_hi) break;  // the next segment's
      const Row cur = next;
      if (j + 1 < n) load_row(next, a.sads + (size_t)mb_of(j + 1) * kNN, lane);
      const int win = winner(cur, pen, lane);
      if (lane == 0) {
        if (one)
          atomicAdd(hist + win, 1);
        else
          a.iy0[m] = win / kN - kSR, a.ix0[m] = win % kN - kSR;
      }
    }
    __syncthreads();  // phase 1: every winner is in; 2: the mode is read
    if (one) {
      for (int k = threadIdx.x; k < kNN; k += 32 * kWarps) {
        if (hist[k]) atomicAdd(a.counts + (size_t)s * kNN + k, hist[k]);
        hist[k] = 0;
      }
    }
    if (s == s1) break;
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_refs_kernels.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `win_args`' order (host
// arrays); n[4] the most blocks a launch, n[5] the phase, 1 or 2.
extern "C" int th264_me_winner(void* const* p, const int* n, void* stream) {
  const WinArgs a = win_args(p, n);
  me_winner_kernel<<<a.blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
