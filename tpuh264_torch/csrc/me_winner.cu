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
//    of its counts (gy, gx = its dy, dx), recomputed by every warp from
//    the counts; each MB's first-index argmin of 4 * sad + lam *
//    rate_q(4 (dx - gx), 4 (dy - gy)), pframe.py `_rate_q` (ue lengths,
//    `ue_len` of inter_common.cuh), giving iy0, ix0 = its dy, dx.
// Costs are int32 as the plain version's (4 * sad wraps where its does).
//
// What bounds it on the H100: bytes.  The least it must move is one read
// of the table (37.7 MB at 1080p x 4: 0.011 ms at 3.35 TB/s) and the
// winners out; this design reads the table twice, once a phase (the
// second read may hit the 50 MB L2), and the counts (1,156 B a stream)
// once a warp from L2.
//
// Design: a warp a MB, kWarps MBs a block.  Lane l holds candidates l +
// 32 i (i = 0 .. 9): each warp load is 128 consecutive bytes of the MB's
// row of the table.  A lane keeps its first minimum (strict <, in
// increasing k); the warp's first-index minimum is the least cost by
// `redux.sync` min, then the least k among the lanes that hold it.  The
// argmax of the counts goes the same way.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inter_common.cuh"  // ue_len

namespace {

constexpr int kSR = 8;           // search range
constexpr int kN = 2 * kSR + 1;  // 17 offsets an axis
constexpr int kNN = kN * kN;     // 289 candidates
constexpr int kPer = (kNN + 31) / 32;  // 10 candidates a lane (at most)
constexpr int kWarps = 8;        // MBs a block, a warp each
constexpr unsigned kFull = 0xffffffffu;
constexpr int kNone = 1 << 30;   // above every candidate index

struct WinArgs {
  const int32_t* sads;   // [S, R, C, 289]
  int32_t* counts;       // [S, 289]: zero before phase 1
  int32_t *iy0, *ix0;    // [S, R, C]
  int32_t *gy, *gx;      // [S]
  int S, R, C, lam, phase;
};

constexpr int kPtrs = 6;
constexpr int kInts = 5;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k12_operands` builds them.
inline WinArgs win_args(void* const* p, const int* n) {
  WinArgs a;
  a.sads = static_cast<const int32_t*>(p[0]);
  a.counts = static_cast<int32_t*>(p[1]);
  a.iy0 = static_cast<int32_t*>(p[2]), a.ix0 = static_cast<int32_t*>(p[3]);
  a.gy = static_cast<int32_t*>(p[4]), a.gx = static_cast<int32_t*>(p[5]);
  a.S = n[0], a.R = n[1], a.C = n[2], a.lam = n[3], a.phase = n[4];
  return a;
}

// The warp's first index of the least `v` among the lanes' (v, k), each
// lane's k its first of its least v.
__device__ __forceinline__ int first_min(int v, int k) {
  const int least = __reduce_min_sync(kFull, v);
  return __reduce_min_sync(kFull, v == least ? k : kNone);
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

__global__ void __launch_bounds__(32 * kWarps)
    me_winner_kernel(const __grid_constant__ WinArgs a) {
  const int lane = threadIdx.x & 31;
  const int m = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int per = a.R * a.C;
  if (m >= a.S * per) return;  // warp-uniform
  const int s = m / per;
  const int32_t* row = a.sads + (size_t)m * kNN;
  int32_t* counts = a.counts + (size_t)s * kNN;
  int gy = 0, gx = 0;
  if (a.phase == 2) {
    const int g = mode_of(counts, lane);
    gy = g / kN - kSR, gx = g % kN - kSR;
  }
  int best = 0, bk = kNone;
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int k = lane + 32 * i;
    if (k < kNN) {
      const int dy = k / kN - kSR, dx = k % kN - kSR;
      const int rate = a.phase == 2
                           ? ue_len(4 * (dx - gx)) + ue_len(4 * (dy - gy))
                           : ue_len(4 * dx) + ue_len(4 * dy);
      const int cost = 4 * row[k] + a.lam * rate;
      if (bk == kNone || cost < best) best = cost, bk = k;
    }
  }
  const int win = first_min(bk == kNone ? INT32_MAX : best, bk);
  if (lane != 0) return;
  if (a.phase == 1) {
    atomicAdd(counts + win, 1);
  } else {
    a.iy0[m] = win / kN - kSR, a.ix0[m] = win % kN - kSR;
    if (m == s * per) a.gy[s] = gy, a.gx[s] = gx;
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_refs_kernels.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `win_args`' order (host
// arrays); n[4] the phase, 1 or 2.
extern "C" int th264_me_winner(void* const* p, const int* n, void* stream) {
  const WinArgs a = win_args(p, n);
  const int mbs = a.S * a.R * a.C;
  me_winner_kernel<<<(mbs + kWarps - 1) / kWarps, 32 * kWarps, 0,
                     (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
