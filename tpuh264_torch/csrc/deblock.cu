// D1: the in-loop deblocking filter (H.264 8.7) in row-slice mode
// (disable_deblocking_filter_idc 2): a block of two warps per two MB
// rows, one warp for their luma and one for their chroma.
//
// Replaces: tpuh264/kernels/deblock.py `deblock_frame_rows` (:130), a
// jax.lax.scan over MB columns (scan at :303), not a pallas_call.  Its
// plain PyTorch version is `kernels/deblock.py` `_deblock_rows_plain`.
//
// What it computes, exactly as the plain version: per MB, in order, the
// left MB edge (luma and both chroma planes; bS 4 if either MB is intra,
// else 2 if either 4x4 block beside the edge is coded, else 1 if the
// whole-MB MVs differ by >= 4 quarter pels or the reference indices
// differ, else 0; none in column 0), the internal vertical edges x = 4,
// 8, 12 (chroma x = 4) and the internal horizontal edges y = 4, 8, 12
// (chroma y = 4), bS 3 if intra, else 2 if either block is coded.  With
// t8 the luma edges 4 and 12 (both ways) get bS 0; the chroma internal
// edge takes luma edge 8's bS unmasked.  Chroma row (column) k takes the
// bS of luma 4-row group k / 2.  The next MB's left edge changes columns
// 13..15 of this MB after its horizontal edges.  Samples must lie in
// [0, 255] (every reconstruction the callers pass); the arithmetic is
// int32 as the plain version's, and the outputs are its uint8 planes.
//
// Two entries.  `th264_deblock_rows` (`deblock_frame_rows`) takes int32
// planes, contiguous int32 side fields and the per-4x4 coded counts of
// `deblock_nnz`.  `th264_deblock_ring` (`deblock_ring`, the GOP pipeline's
// and the sessions' `deblock_i` / `deblock_p`) reads uint8 planes, 16
// and 8 bytes a row (the reconstructions as the codec's kernels write
// them), kind, mvx, mvy, refidx and t8 in place, each with its own MB
// stride (the GOP decode's record views), works out the coded 4x4 blocks
// itself from the MBs' luma_ac levels (int16, a 4x4 block coded iff one
// of its 16 levels is nonzero; for a t8 MB iff its 8x8 block has one, as
// `deblock_nnz`), takes a null kind as "every MB intra" (an IDR: only the
// planes are read), and writes the filtered planes wherever the caller
// says: the GOP pipeline's DPB ring slot.  The coded state costs the
// column chain one ballot: thread 16 h + j of either warp loads the 32
// bytes of 4x4 block j of its lane's MB two columns ahead, with the
// samples, and at the column one ballot gives every thread the MB's 16
// coded bits.  The two entries share one kernel, a template on the plane
// type and on where the coded state comes from, so that neither pays for
// the other's choice at run time (a build that chose at run time, with
// null-field branches and 64-bit strided addresses, ran 22% slower).
//
// What bounds it on the H100: one lane's chain, not bytes.  Row slices
// never filter across MB rows, so the S x R MB rows are independent
// lanes (272 at 1080p x 4), but inside a lane the C columns are strictly
// ordered, and each luma line of a column goes through 7 dependent
// filter evaluations: the left edge, x = 4, 8, 12, then (as a column)
// y = 4, 8, 12, whose result the next column's left edge reads.  The
// bytes bound (int32 planes and side information in, uint8 planes out:
// 65.3 MB, 0.0195 ms at 1080p x 4) is far below that chain.
//
// Design, around one lane's chain (a warp a lane with seven
// shared-memory passes a column took ~2,990 cycles a column):
//  * Lines live in registers.  A luma thread owns one sample row of its
//    MB (16 int32) and the same row of the MB to its left, whose columns
//    12..15 are the left edge's p side: the left edge and x = 4, 8, 12
//    are register arithmetic in that thread.  Shared memory is a
//    transpose only: the thread writes its row, reads its column,
//    filters y = 4, 8, 12, writes the column back and reads its row,
//    which the next column's left edge finishes.  Two exchanges and two
//    __syncwarps a column.  Rows are padded to 20 words (chroma 12) and
//    the lanes' buffers offset by 16 (chroma 8) banks, so the 16-byte
//    row accesses and the 4-byte column accesses are free of bank
//    conflicts.  Chroma works the same way with rows of 8 and one
//    internal edge each way.
//  * Luma and chroma on separate warps of a 64-thread block: warp 0
//    holds the luma of lanes 2b (threads 0-15) and 2b + 1 (16-31), warp
//    1 their U and V rows (8 threads each).  Neither path waits for the
//    other, and the chroma chain (left edge and x = 4 independent, then
//    y = 4) ends first; the warps share nothing, so the block has no
//    barrier.  Two lanes a warp rather than 16 idle threads: a warp's
//    instruction costs the same either way, and two lanes a block (136
//    blocks at 1080p x 4) ran faster on the card than four or three,
//    which share an SM's L1 and shared memory among more lanes.
//  * bS leaves the chain: the side information arrives in registers
//    with the samples, and each thread works out the bS of its edges
//    (left, three vertical and three horizontal for luma; the t8 mask;
//    chroma's luma group k / 2) from it alone, beside the first filter.
//  * No branch inside a column: the filters compute every result and
//    select, as the plain version's torch.where's do (& and |, never the
//    short-circuit && and ||), so a column is one straight block the
//    compiler schedules as a whole, and bS 4 lines do not serialise a
//    warp against bS < 4 lines.  The threshold tests |a - b| < t are
//    (a - b)^2 < t^2: a multiply-add instead of two operations of the
//    integer ALU, which takes a warp instruction every other cycle.
//  * Column c + 2's samples and side information load into registers
//    while column c is filtered, two input slots alternating so that no
//    value is copied, and column c + 4's rows are prefetched into L2: at
//    1080p x 4 the 65 MB do not stay in the 50 MB L2, and without the
//    prefetch a column waited ~170 cycles longer on device memory.  A
//    finished MB leaves once, as uint8, 16 bytes a luma row and 8 a
//    chroma row, as soon as the next MB's left edge has run.  ALPHA,
//    BETA and TC0 (Table 8-16, 8-17) sit in __constant__ memory, copied
//    from the port's golden/deblock.py (tests/test_torch_deblock.py holds
//    them equal); qp is uniform.
//
// What bounds it now: the luma warp's instruction rate.  A column is
// ~600 of its instructions, most on the integer ALU, around the chain
// of ~7 dependent filter evaluations and two exchanges: ~1,230 cycles a
// column at 480p x 8 and ~1,325 at 1080p x 4 on an H100 at 1980 MHz
// (PERF.md; chip_smoke.py phase 2 and tools/time_deblock.py print the
// reading).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLS = 20;       // luma exchange row stride (words): 16 + 4
constexpr int kLLane = 336;   // luma words a lane: 16 rows x 20, + 16
constexpr int kCS = 12;       // chroma exchange row stride: 8 + 4
constexpr int kCPlane = 104;  // chroma words a lane's plane: 8 x 12, + 8

__constant__ int kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9,
    10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80,
    90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ int kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
    14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ int kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},
    {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14},
    {8, 11, 16}, {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// the filter parameters of one QP (luma qp or chroma qpc)
struct Params {
  int alpha2, beta2, strong2, tc1, tc2, tc3;  // squares: alpha^2, beta^2,
                                               // ((alpha >> 2) + 2)^2
  __device__ int tc0(int bs) const {       // tc0 for bS 1, 2, >= 3
    return bs <= 1 ? tc1 : (bs == 2 ? tc2 : tc3);
  }
};

__device__ __forceinline__ Params params(int qp) {
  const int a = kAlpha[qp], b = kBeta[qp], s = (a >> 2) + 2;
  return Params{a * a, b * b, s * s, kTc0[qp][0], kTc0[qp][1], kTc0[qp][2]};
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

// |a - b| < t as (a - b)^2 < t^2: a multiply-add, where |.| and a compare
// would both take the integer ALU, which runs at half the warp's rate
__device__ __forceinline__ bool near(int a, int b, int t2) {
  return (a - b) * (a - b) < t2;
}

// One luma edge line p3 p2 p1 p0 | q0 q1 q2 q3 (8.7.2.3, 8.7.2.4),
// without a branch (& and |, never the short-circuit && and ||): every
// result is computed, then the filterSamplesFlag, ap / aq and bS select.
// p1 + Clip3(-tc0, tc0, (p2 + avg - 2 p1) >> 1) is computed as
// (2 p2 + p0 + q0 + 1) >> 2 clipped to p1 -+ tc0, which takes fewer
// operations.  Only an MB edge (kMbEdge) can have bS 4: there the bS 4
// result is computed too.
template <bool kMbEdge>
__device__ __forceinline__ void filter_luma(int p3, int& p2, int& p1,
                                            int& p0, int& q0, int& q1,
                                            int& q2, int q3, int bs,
                                            const Params& f) {
  const bool filt = (bs > 0) & near(p0, q0, f.alpha2) &
                    near(p1, p0, f.beta2) & near(q1, q0, f.beta2);
  const bool ap = near(p2, p0, f.beta2), aq = near(q2, q0, f.beta2);
  const int tc0 = f.tc0(bs), tc = tc0 + ap + aq;
  const int d = ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3;
  const int sum = p0 + q0 + 1;
  const bool fp = filt & ap, fq = filt & aq;
  const int delta = clip3(-tc, tc, d);
  const int np0 = clip3(0, 255, p0 + delta);
  const int nq0 = clip3(0, 255, q0 - delta);
  const int np1 = clip3(p1 - tc0, p1 + tc0, (2 * p2 + sum) >> 2);
  const int nq1 = clip3(q1 - tc0, q1 + tc0, (2 * q2 + sum) >> 2);
  if (!kMbEdge) {
    p1 = fp ? np1 : p1;
    p0 = filt ? np0 : p0;
    q0 = filt ? nq0 : q0;
    q1 = fq ? nq1 : q1;
    return;
  }
  const bool s4 = filt & (bs == 4), strong = near(p0, q0, f.strong2);
  const bool sp = s4 & ap & strong, sq = s4 & aq & strong;
  const int o_p2 = sp ? (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3 : p2;
  const int o_q2 = sq ? (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3 : q2;
  const int o_p1 = sp ? (p2 + p1 + p0 + q0 + 2) >> 2
                      : (fp & !s4 ? np1 : p1);
  const int o_q1 = sq ? (q2 + q1 + q0 + p0 + 2) >> 2
                      : (fq & !s4 ? nq1 : q1);
  const int o_p0 = sp     ? (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
                   : s4   ? (2 * p1 + p0 + q1 + 2) >> 2
                   : filt ? np0
                          : p0;
  const int o_q0 = sq     ? (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
                   : s4   ? (2 * q1 + q0 + p1 + 2) >> 2
                   : filt ? nq0
                          : q0;
  p2 = o_p2;
  p1 = o_p1;
  p0 = o_p0;
  q0 = o_q0;
  q1 = o_q1;
  q2 = o_q2;
}

// One chroma edge line p1 p0 | q0 q1, the same way.
template <bool kMbEdge>
__device__ __forceinline__ void filter_chroma(int p1, int& p0, int& q0,
                                              int q1, int bs,
                                              const Params& f) {
  const bool filt = (bs > 0) & near(p0, q0, f.alpha2) &
                    near(p1, p0, f.beta2) & near(q1, q0, f.beta2);
  const int tc = f.tc0(bs) + 1;
  const int d = ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3;
  const int delta = clip3(-tc, tc, d);
  const int np0 = clip3(0, 255, p0 + delta);
  const int nq0 = clip3(0, 255, q0 - delta);
  const bool s4 = kMbEdge & (bs == 4);
  const int o_p0 = !filt ? p0 : s4 ? (2 * p1 + p0 + q1 + 2) >> 2 : np0;
  const int o_q0 = !filt ? q0 : s4 ? (2 * q1 + q0 + p1 + 2) >> 2 : nq0;
  p0 = o_p0;
  q0 = o_q0;
}

// The kernel's inputs and outputs: lanes = S * R MB rows of C columns.
// Planes are uint8 (the ring entry) or int32 (the counts entry): the
// kernel's P.  Every per-MB field is read
// in place, MB m at element m * its stride (the GOP decode's record views
// have stride 9; a field the caller does not give is read from kZeros,
// kind from kIntra, with stride 0).  The coded 4x4 blocks come from `lev`
// (the kernel's kLev: luma_ac [.., 16, 16] int16, nonzero coded; with
// the 8x8 rule for t8 MBs) or from `nnz` (counts [.., 16], > 0 coded).
struct Args {
  const void *y, *u, *v;
  const int32_t *kind, *mvx, *mvy, *ref, *t8, *nnz;
  const int16_t* lev;
  uint8_t *oy, *ou, *ov;
  int lanes, C, qp, qpc;
  int sk, smx, smy, sref, st8, slev;  // MB strides, in elements
};

// What a field or the levels read where the caller gives none (stride 0):
// zeros (512 bytes: a MB's luma levels), and kind 2, intra.
__device__ int32_t kZeros[128];
__device__ int32_t kIntra[1] = {2};

// One MB's side information as it is loaded: the fields, and the raw
// coded state of the thread's 4x4 block (its 16 levels; or its count in
// lv[0].x).
struct SideIn {
  int kind, mvx, mvy, ref, t8;
  int4 lv[2];
};

// ... and as the bS needs it: m holds the MB's coded 4x4 blocks, bit
// 4 by + bx.
struct Side {
  int kind, mvx, mvy, ref;
  unsigned m;
};

// MB mb's side information; j is the 4x4 block (raster) whose coded state
// this thread loads.  Element offsets are 32-bit: a frame's MBs times a
// record's 400 slots stay far below 2^31.
template <bool kLev>
__device__ __forceinline__ SideIn load_side(const Args& a, int mb, int j) {
  SideIn s;
  s.kind = a.kind[mb * a.sk];
  s.mvx = a.mvx[mb * a.smx];
  s.mvy = a.mvy[mb * a.smy];
  s.ref = a.ref[mb * a.sref];
  s.t8 = a.t8[mb * a.st8];
  if constexpr (kLev) {
    const int4* q = reinterpret_cast<const int4*>(a.lev + mb * a.slev + 16 * j);
    s.lv[0] = q[0];
    s.lv[1] = q[1];
  } else {
    s.lv[0] = make_int4(a.nnz[16 * mb + j], 0, 0, 0);
    s.lv[1] = make_int4(0, 0, 0, 0);
  }
  return s;
}

// The 8x8 rule (8.7.2.1): a 4x4 block of an 8x8-transform MB counts as
// coded iff its 8x8 block has a coefficient.  The levels of 8x8 block q
// (raster) are the 64 of luma_ac[4q .. 4q + 3], so its bit group is m's
// bits 4q .. 4q + 3; its 4x4 blocks are raster bits kQuad[q].
__device__ __forceinline__ unsigned rule8x8(unsigned m) {
  const unsigned kQuad[4] = {0x0033u, 0x00ccu, 0x3300u, 0xcc00u};
  unsigned e = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) e |= ((m >> (4 * q)) & 15u) ? kQuad[q] : 0u;
  return e;
}

// The column's side information from what was loaded: the coded state of
// the 16 blocks of the thread's MB, one block a thread of its half warp,
// by one ballot of the whole warp (both halves' lanes).
template <bool kLev>
__device__ __forceinline__ Side side_of(const SideIn& in, int half) {
  const int4 p = in.lv[0], q = in.lv[1];
  const bool coded =
      kLev ? ((p.x | p.y | p.z | p.w | q.x | q.y | q.z | q.w) != 0)
           : (p.x > 0);
  unsigned m = (__ballot_sync(0xffffffffu, coded) >> (16 * half)) & 0xffffu;
  if (kLev && in.t8 == 1) m = rule8x8(m);
  return Side{in.kind, in.mvx, in.mvy, in.ref, m};
}

__device__ __forceinline__ int bit(unsigned m, int k) {
  return (int)((m >> k) & 1u);
}

// bS of the left MB edge in the thread's 4x4-block group g: p the left
// MB, c this one
__device__ __forceinline__ int bs_left(const Side& p, const Side& c, int g) {
  const int moved = (abs(c.mvx - p.mvx) >= 4) | (abs(c.mvy - p.mvy) >= 4) |
                    (c.ref != p.ref);
  const int coded = (bit(p.m, 4 * g + 3) | bit(c.m, 4 * g)) ? 2 : moved;
  return ((c.kind == 2) | (p.kind == 2)) ? 4 : coded;
}

// bS of an internal edge between 4x4 blocks coded a and b
__device__ __forceinline__ int bs_internal(const Side& s, int a, int b) {
  return s.kind == 2 ? 3 : ((a | b) ? 2 : 0);
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 255) | ((uint32_t)(b & 255) << 8) |
         ((uint32_t)(c & 255) << 16) | ((uint32_t)(d & 255) << 24);
}

// N samples (16 or 8) to dst as uint8, in one store
template <int N>
__device__ __forceinline__ void store_row(uint8_t* dst, const int (&m)[N]) {
  const uint32_t w0 = pack4(m[0], m[1], m[2], m[3]);
  const uint32_t w1 = pack4(m[4], m[5], m[6], m[7]);
  if constexpr (N == 16)
    *reinterpret_cast<uint4*>(dst) =
        make_uint4(w0, w1, pack4(m[8], m[9], m[10], m[11]),
                   pack4(m[12], m[13], m[14], m[15]));
  else
    *reinterpret_cast<uint2*>(dst) = make_uint2(w0, w1);
}

// N int32 samples (N / 4 int4) from src into m
template <int N>
__device__ __forceinline__ void load_row(int4 (&m)[N / 4],
                                         const int32_t* src) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) m[j] = reinterpret_cast<const int4*>(src)[j];
}

template <int N>
__device__ __forceinline__ void unpack_row(int (&m)[N],
                                           const int4 (&w)[N / 4]) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    m[4 * j] = w[j].x;
    m[4 * j + 1] = w[j].y;
    m[4 * j + 2] = w[j].z;
    m[4 * j + 3] = w[j].w;
  }
}

__device__ __forceinline__ void unpack_word(int* m, uint32_t w) {
  m[0] = (int)(w & 255u);
  m[1] = (int)((w >> 8) & 255u);
  m[2] = (int)((w >> 16) & 255u);
  m[3] = (int)(w >> 24);
}

// One line's row of one MB as it is loaded: N samples of the plane type P
// (int32: N / 4 int4; uint8: one 16- or 8-byte vector).
template <typename P, int N>
struct Raw {
  int4 w[N / 4];
  __device__ void load(const int32_t* src) { load_row<N>(w, src); }
  __device__ void unpack(int (&m)[N]) const { unpack_row<N>(m, w); }
};
template <>
struct Raw<uint8_t, 16> {
  uint4 w;
  __device__ void load(const uint8_t* src) {
    w = *reinterpret_cast<const uint4*>(src);
  }
  __device__ void unpack(int (&m)[16]) const {
    unpack_word(m, w.x);
    unpack_word(m + 4, w.y);
    unpack_word(m + 8, w.z);
    unpack_word(m + 12, w.w);
  }
};
template <>
struct Raw<uint8_t, 8> {
  uint2 w;
  __device__ void load(const uint8_t* src) {
    w = *reinterpret_cast<const uint2*>(src);
  }
  __device__ void unpack(int (&m)[8]) const {
    unpack_word(m, w.x);
    unpack_word(m + 4, w.y);
  }
};

// Exchange 1: thread i writes its row i of an N x N block (row stride
// S), then reads column i into m.  Exchange 2 writes column i of m and
// reads row i into row.
template <int N, int S>
__device__ __forceinline__ void rows_to_cols(int (&m)[N], int* buf, int i) {
#pragma unroll
  for (int j = 0; j < N / 4; ++j)
    reinterpret_cast<int4*>(buf + i * S)[j] =
        make_int4(m[4 * j], m[4 * j + 1], m[4 * j + 2], m[4 * j + 3]);
  __syncwarp();
#pragma unroll
  for (int k = 0; k < N; ++k) m[k] = buf[k * S + i];
}

template <int N, int S>
__device__ __forceinline__ void cols_to_rows(const int (&m)[N], int (&row)[N],
                                             int* buf, int i) {
#pragma unroll
  for (int k = 0; k < N; ++k) buf[k * S + i] = m[k];
  __syncwarp();
  int4 w[N / 4];
  load_row<N>(w, buf + i * S);
  unpack_row<N>(row, w);
}

// One thread's line through a lane: its row of every MB (N = 16 luma,
// 8 chroma), the side information's group g, its exchange buffer and
// its row / column index i there; j the 4x4 block whose coded state it
// loads, half its lane's half of the warp.
template <typename P>
struct Line {
  const P* src;
  uint8_t* dst;
  int mb0;  // the lane's first MB
  int g, i, j, half;
  int* buf;
  bool valid;  // false: a missing lane's stand-in, which stores nothing
};

// One column's inputs in flight: the line's N samples and its side
// information.
template <typename P, int N>
struct In {
  Raw<P, N> s;
  SideIn sd;
};

// a hint that brings p's line into L2 (nothing where the source runs on
// the CPU, in tests/test_torch_deblock.py)
__device__ __forceinline__ void prefetch_l2(const void* p) {
#ifdef __CUDA_ARCH__
  asm volatile("prefetch.global.L2 [%0];" ::"l"(p));
#endif
}

template <typename P, bool kLev, int N>
__device__ __forceinline__ void load_in(In<P, N>& in, const Args& a,
                                        const Line<P>& l, int col) {
  in.s.load(l.src + N * col);
  in.sd = load_side<kLev>(a, l.mb0 + col, l.j);
}

// MB column col of the line, from `in`, which then takes column col + 2
// (the last column again at the end) while column col + 4's rows go to
// L2.  prev holds the line's row of the MB to the left and ps its side
// information; both become this MB's.
template <typename P, bool kLev, int N>
__device__ __forceinline__ void column(In<P, N>& in, int col, const Args& a,
                                       const Line<P>& l, int (&prev)[N],
                                       Side& ps, const Params& f) {
  int m[N];
  in.s.unpack(m);
  const Side cs = side_of<kLev>(in.sd, l.half);
  const bool t8 = in.sd.t8 == 1;  // 8x8 transform: no luma edges 4, 12
  load_in<P, kLev, N>(in, a, l, min(col + 2, a.C - 1));
  const int pc = min(col + 4, a.C - 1);
  const int pm = l.mb0 + pc;
  prefetch_l2(l.src + N * pc);
  if constexpr (kLev)
    prefetch_l2(a.lev + pm * a.slev + 16 * l.j);
  else
    prefetch_l2(a.nnz + 16 * pm + l.j);

  // the bS of the line's edges, from the side information alone
  const int g = l.g;
  const int bl = col > 0 ? bs_left(ps, cs, g) : 0;
  if constexpr (N == 16) {
    int bv[3], bh[3];
#pragma unroll
    for (int e = 0; e < 3; ++e) {
      bv[e] = t8 & (e != 1)
                  ? 0
                  : bs_internal(cs, bit(cs.m, 4 * g + e),
                                bit(cs.m, 4 * g + e + 1));
      bh[e] = t8 & (e != 1)
                  ? 0
                  : bs_internal(cs, bit(cs.m, 4 * e + g),
                                bit(cs.m, 4 * e + 4 + g));
    }
    // the left MB edge; then the left MB's row is final (in column 0 a
    // dummy row, which column 1 or the last store overwrites)
    filter_luma<true>(prev[12], prev[13], prev[14], prev[15], m[0], m[1],
                      m[2], m[3], bl, f);
    if (l.valid) store_row<16>(l.dst + 16 * max(col - 1, 0), prev);
    // internal vertical edges x = 4, 8, 12, then on column i horizontal
    // edges y = 4, 8, 12
#pragma unroll
    for (int x = 4; x < 16; x += 4)
      filter_luma<false>(m[x - 4], m[x - 3], m[x - 2], m[x - 1], m[x],
                         m[x + 1], m[x + 2], m[x + 3], bv[x / 4 - 1], f);
    rows_to_cols<16, kLS>(m, l.buf, l.i);
#pragma unroll
    for (int y = 4; y < 16; y += 4)
      filter_luma<false>(m[y - 4], m[y - 3], m[y - 2], m[y - 1], m[y],
                         m[y + 1], m[y + 2], m[y + 3], bh[y / 4 - 1], f);
    cols_to_rows<16, kLS>(m, prev, l.buf, l.i);
  } else {
    // luma group g's bS: left edge, edge 8 each way (never t8-masked)
    const int bv = bs_internal(cs, bit(cs.m, 4 * g + 1), bit(cs.m, 4 * g + 2));
    const int bh = bs_internal(cs, bit(cs.m, 4 + g), bit(cs.m, 8 + g));
    filter_chroma<true>(prev[6], prev[7], m[0], m[1], bl, f);
    if (l.valid) store_row<8>(l.dst + 8 * max(col - 1, 0), prev);
    filter_chroma<false>(m[2], m[3], m[4], m[5], bv, f);
    rows_to_cols<8, kCS>(m, l.buf, l.i);
    filter_chroma<false>(m[2], m[3], m[4], m[5], bh, f);
    cols_to_rows<8, kCS>(m, prev, l.buf, l.i);
  }
  ps = cs;
}

// The line through all C columns.  Two input slots alternate (even
// columns in A, odd in B), so each load lands in the registers the
// column two back has just left and no value is copied.
template <typename P, bool kLev, int N>
__device__ __forceinline__ void lane_line(const Args& a, const Line<P>& l,
                                          const Params& f) {
  const int C = a.C;
  In<P, N> A, B;
  load_in<P, kLev, N>(A, a, l, 0);
  load_in<P, kLev, N>(B, a, l, min(1, C - 1));
  int prev[N] = {};
  Side ps{};
  for (int col = 0;; col += 2) {
    column<P, kLev, N>(A, col, a, l, prev, ps, f);
    if (col + 1 == C) break;
    column<P, kLev, N>(B, col + 1, a, l, prev, ps, f);
    if (col + 2 == C) break;
  }
  if (l.valid) store_row<N>(l.dst + N * (C - 1), prev);  // the last MB
}

// Block b: lanes 2b and 2b + 1 (a missing second lane recomputes the
// last one and stores nothing).  Warp 0 luma: thread 16 h + r is row r
// of lane 2b + h.  Warp 1 chroma: thread 16 h + 8 p + k is row k of
// plane p (U, V) of lane 2b + h.  Thread 16 h + j of either warp loads
// the coded state of 4x4 block j of its lane's MB.  P: the planes' type;
// kLev: the coded blocks from the levels (the ring entry), else from the
// counts.
template <typename P, bool kLev>
__global__ void __launch_bounds__(64)
    deblock_rows_kernel(const __grid_constant__ Args a) {
  __shared__ __align__(16) int L[2 * kLLane];
  __shared__ __align__(16) int Ch[4 * kCPlane];
  const int t = threadIdx.x & 31, h = t >> 4;
  const int lane = 2 * blockIdx.x + h;
  const bool valid = lane < a.lanes;
  const int at = valid ? lane : a.lanes - 1;
  const int mb0 = at * a.C;
  const P* y = static_cast<const P*>(a.y);
  if (threadIdx.x < 32) {
    const int r = t & 15;
    const size_t row = (size_t)(16 * at + r) * 16 * a.C;
    lane_line<P, kLev, 16>(a, Line<P>{y + row, a.oy + row, mb0, r >> 2, r,
                                      r, h, L + h * kLLane, valid},
                           params(a.qp));
  } else {
    const int p = (t >> 3) & 1, k = t & 7;
    const size_t row = (size_t)(8 * at + k) * 8 * a.C;
    const P* c = static_cast<const P*>(p ? a.v : a.u);
    lane_line<P, kLev, 8>(a, Line<P>{c + row, (p ? a.ov : a.ou) + row,
                                     mb0, k >> 1, k, t & 15, h,
                                     Ch + (t >> 3) * kCPlane, valid},
                          params(a.qpc));
  }
}

// The device addresses of kZeros and kIntra (on CPU threads, where the
// source runs in the tests, their own).
inline const int32_t* zeros_addr() {
#ifdef __CUDACC__
  void* p = nullptr;
  cudaGetSymbolAddress(&p, kZeros);
  return static_cast<const int32_t*>(p);
#else
  return kZeros;
#endif
}

inline const int32_t* intra_addr() {
#ifdef __CUDACC__
  void* p = nullptr;
  cudaGetSymbolAddress(&p, kIntra);
  return static_cast<const int32_t*>(p);
#else
  return kIntra;
#endif
}

// A null field or level array read as zeros (kind: as every MB intra),
// with stride 0.
inline Args with_defaults(Args a) {
  const int32_t* z = zeros_addr();
  if (!a.kind) a.kind = intra_addr(), a.sk = 0;
  if (!a.mvx) a.mvx = z, a.smx = 0;
  if (!a.mvy) a.mvy = z, a.smy = 0;
  if (!a.ref) a.ref = z, a.sref = 0;
  if (!a.t8) a.t8 = z, a.st8 = 0;
  if (!a.lev) a.lev = reinterpret_cast<const int16_t*>(z), a.slev = 0;
  return a;
}

// The arguments of the counts entry: int32 planes, contiguous fields, the
// per-4x4 counts; ref and t8 may be null (all 0).
inline Args rows_args(const int32_t* y, const int32_t* u, const int32_t* v,
                      const int32_t* kind, const int32_t* mvx,
                      const int32_t* mvy, const int32_t* ref,
                      const int32_t* t8, const int32_t* nnz, uint8_t* oy,
                      uint8_t* ou, uint8_t* ov, int lanes, int C, int qp,
                      int qpc) {
  return with_defaults(Args{y, u, v, kind, mvx, mvy, ref, t8, nnz, nullptr,
                            oy, ou, ov, lanes, C, qp, qpc, 1, 1, 1, 1, 1,
                            0});
}

constexpr int kPtrs = 13;
constexpr int kInts = 10;

// The ring entry's arguments from its pointer and int arrays, in the
// order kernels/deblock.py `_k4_ring_operands` builds them: y, u, v,
// kind, mvx, mvy, ref, t8, nnz, lev, oy, ou, ov; lanes, C, qp, qpc, then
// the strides of kind, mvx, mvy, ref, t8 and lev.  The planes are uint8.
inline Args ring_args(void* const* p, const int* n) {
  return with_defaults(Args{p[0], p[1], p[2],
              static_cast<const int32_t*>(p[3]),
              static_cast<const int32_t*>(p[4]),
              static_cast<const int32_t*>(p[5]),
              static_cast<const int32_t*>(p[6]),
              static_cast<const int32_t*>(p[7]),
              static_cast<const int32_t*>(p[8]),
              static_cast<const int16_t*>(p[9]),
              static_cast<uint8_t*>(p[10]), static_cast<uint8_t*>(p[11]),
              static_cast<uint8_t*>(p[12]),
              n[0], n[1], n[2], n[3], n[4], n[5], n[6], n[7], n[8],
              n[9]});
}

}  // namespace

#ifdef __CUDACC__  // the entries; tests/test_torch_deblock.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// The counts entry (`deblock_frame_rows`): lanes = S * R MB rows of C MB
// columns; ref and t8 may be null (all 0).
extern "C" int th264_deblock_rows(
    const int32_t* y, const int32_t* u, const int32_t* v,
    const int32_t* kind, const int32_t* mvx, const int32_t* mvy,
    const int32_t* ref, const int32_t* t8, const int32_t* nnz, uint8_t* oy,
    uint8_t* ou, uint8_t* ov, int lanes, int C, int qp, int qpc,
    void* stream) {
  const Args a = rows_args(y, u, v, kind, mvx, mvy, ref, t8, nnz, oy, ou, ov,
                           lanes, C, qp, qpc);
  deblock_rows_kernel<int32_t, false>
      <<<(lanes + 1) / 2, 64, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The ring entry (`deblock_ring`): p kPtrs device pointers, n kInts ints
// (host arrays, `ring_args`' order).
extern "C" int th264_deblock_ring(void* const* p, const int* n,
                                  void* stream) {
  const Args a = ring_args(p, n);
  if (a.lanes < 1 || a.C < 1) return (int)cudaErrorInvalidValue;
  deblock_rows_kernel<uint8_t, true>
      <<<(a.lanes + 1) / 2, 64, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
