// The Intra_4x4 luma predictor (H.264 8.3.1.2) of the row-slice layout,
// one 4x4 block a step of a warp: the neighbour rules, DC and the nine
// modes of kernels/intra44.py (`_gather_neighbors`, `pred_dc`,
// `pred_directional`, `_select`).  K5's Intra_4x4 route (intra_recon.cu)
// walks a MB's 16 blocks with it; it assumes nothing of the samples'
// range (the left column may be any int32 where the left MB took
// `other`), so every sum wraps as the plain version's int32 sums do.
//
// The MB's samples lie in shared memory while it is walked: sample (x, y),
// x and y in -1..15, at `i44_at(x, y)`.  Row -1 stays zero (the MB row
// above is another slice: T, TR and X of the top blocks are 0), column -1
// holds the left MB's right column (zeros in column 0, where `l_ok` is
// false), and each row is 16-byte aligned.
//
// The directional modes are affine forms over the neighbour vector n =
// [L0..3, X, T0..3, TR0..3]: pred = (sum_k n[k] W[m, p, k] + R[m, p]) >>
// S[m, p].  The tables are not written here: kernels/intra44.py
// `tap_words` packs the port's own W, R and S (`_build_tables`) into one
// word a (mode, pixel), and the kernel takes those 144 words as an operand
// (`tables.get("i44_taps")`).  A word holds at most three taps (every
// form has at most three): bits 0-3, 4-7, 8-11 their neighbour indices,
// 12-13, 14-15, 16-17 their weights (0..3), 18-19 R and 20-21 S.  Mode 2,
// DC, has no taps: it depends on which neighbours are available.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kI44Pitch = 20;              // ints a row of the MB's samples
constexpr int kI44Pix = 17 * kI44Pitch;    // rows -1..15
constexpr int kI44Taps = 9 * 16;           // tap words: (mode, pixel)

// the index of sample (x, y) of the MB, x and y in -1..15
__host__ __device__ constexpr int i44_at(int x, int y) {
  return (y + 1) * kI44Pitch + x + 4;
}

// the position (bx, by) of z-scan block bi (luma4x4BlkIdx,
// kernels/intra44.py BLK_SCAN), and the z-scan index of block (bx, by)
__host__ __device__ constexpr int blk_x(int bi) {
  return (bi & 1) | ((bi >> 1) & 2);
}
__host__ __device__ constexpr int blk_y(int bi) {
  return ((bi >> 1) & 1) | ((bi >> 2) & 2);
}
__host__ __device__ constexpr int blk_z(int bx, int by) {
  return (bx & 1) | ((by & 1) << 1) | ((bx & 2) << 1) | ((by & 2) << 2);
}

// whether block bi's top-right samples are real (`_static_tr_kind`
// "real"): in the MB (by > 0, bx < 3) and decoded before it; else TR is
// T3 repeated ("repl"; with by == 0, T3 is 0 too)
__host__ __device__ constexpr bool tr_real(int bi) {
  return blk_y(bi) > 0 && blk_x(bi) < 3 &&
         blk_z(blk_x(bi) + 1, blk_y(bi) - 1) < bi;
}

// The sample index lane k (0..12) of block bi takes as n[k]: L0..3, X,
// T0..3, TR0..3 (TR real or T3 repeated).  Lanes 13-31 read n[0]'s.
__device__ __forceinline__ int i44_neighbour(int bi, int k) {
  const int x0 = 4 * blk_x(bi), y0 = 4 * blk_y(bi);
  if (k < 4) return i44_at(x0 - 1, y0 + k);
  if (k == 4) return i44_at(x0 - 1, y0 - 1);
  if (k < 9 || (k < 13 && tr_real(bi))) return i44_at(x0 + k - 5, y0 - 1);
  if (k < 13) return i44_at(x0 + 3, y0 - 1);
  return i44_at(x0 - 1, y0);
}

// Lane k's prediction of pixel (k & 3, (k >> 2) & 3) of the block by mode
// m (0..8) from the neighbours n[j] that lanes j = 0..12 hold in `nv`;
// l_ok / t_ok: L / T available (DC).  Every lane of the warp takes part.
__device__ __forceinline__ int i44_predict(const uint32_t* taps, int m,
                                           int nv, int k, bool l_ok,
                                           bool t_ok) {
  if (m == 2) {  // DC: pred_dc, wrapping as its int32 sums
    const bool in = (k < 4 && l_ok) || (k >= 5 && k < 9 && t_ok);
    const unsigned s = __reduce_add_sync(0xffffffffu, in ? (unsigned)nv : 0u);
    if (l_ok && t_ok) return (int)(s + 4u) >> 3;
    if (l_ok || t_ok) return (int)(s + 2u) >> 2;
    return 128;
  }
  const uint32_t w = taps[16 * m + (k & 15)];
  const unsigned n0 = __shfl_sync(0xffffffffu, (unsigned)nv, w & 15);
  const unsigned n1 = __shfl_sync(0xffffffffu, (unsigned)nv, (w >> 4) & 15);
  const unsigned n2 = __shfl_sync(0xffffffffu, (unsigned)nv, (w >> 8) & 15);
  const unsigned acc = n0 * ((w >> 12) & 3) + n1 * ((w >> 14) & 3) +
                       n2 * ((w >> 16) & 3) + ((w >> 18) & 3);
  return (int)acc >> ((w >> 20) & 3);
}

}  // namespace
