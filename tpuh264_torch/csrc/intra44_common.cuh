// The Intra_4x4 luma predictor (H.264 8.3.1.2) of the row-slice layout,
// one 4x4 block a step of a warp: the neighbour rules, DC and the nine
// modes of kernels/intra44.py (`_gather_neighbors`, `pred_dc`,
// `pred_directional`, `_select`), and the encoder's mode choice
// (`_avail9`, the SADs, `argmin_first`).  K5's Intra_4x4 route
// (intra_recon.cu) walks a MB's 16 blocks with it, and so does K6's
// (intra16_enc.cu, the encoder's trial).  The predictor assumes nothing of
// the samples' range (K5's left column may be any int32 where the left MB
// took `other`), so every sum wraps as the plain version's int32 sums do;
// the SADs assume 0..255 samples, as the encoder's are.
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

// The block's DC prediction (pred_dc, wrapping as its int32 sums) from
// the neighbours n[j] that lanes j = 0..12 hold in `nv`; l_ok / t_ok: L /
// T available.  A warp-uniform call (one redux.sync).
__device__ __forceinline__ int i44_dc(int nv, int k, bool l_ok, bool t_ok) {
  const bool in = (k < 4 && l_ok) || (k >= 5 && k < 9 && t_ok);
  const unsigned s = __reduce_add_sync(0xffffffffu, in ? (unsigned)nv : 0u);
  if (l_ok && t_ok) return (int)(s + 4u) >> 3;
  if (l_ok || t_ok) return (int)(s + 2u) >> 2;
  return 128;
}

// A lane's prediction by tap word w (a directional mode's, of its pixel)
// from the neighbours lanes 0..12 hold in `nv`.  Every lane of the warp
// takes part; the words may differ from lane to lane (a word of 0, DC's,
// gives 0).
__device__ __forceinline__ int i44_tap(uint32_t w, int nv) {
  const unsigned n0 = __shfl_sync(0xffffffffu, (unsigned)nv, w & 15);
  const unsigned n1 = __shfl_sync(0xffffffffu, (unsigned)nv, (w >> 4) & 15);
  const unsigned n2 = __shfl_sync(0xffffffffu, (unsigned)nv, (w >> 8) & 15);
  const unsigned acc = n0 * ((w >> 12) & 3) + n1 * ((w >> 14) & 3) +
                       n2 * ((w >> 16) & 3) + ((w >> 18) & 3);
  return (int)acc >> ((w >> 20) & 3);
}

// Lane k's prediction of pixel (k & 3, (k >> 2) & 3) of the block by mode
// m (0..8, warp-uniform) from the neighbours n[j] that lanes j = 0..12
// hold in `nv`; l_ok / t_ok: L / T available (DC).
__device__ __forceinline__ int i44_predict(const uint32_t* taps, int m,
                                           int nv, int k, bool l_ok,
                                           bool t_ok) {
  if (m == 2) return i44_dc(nv, k, l_ok, t_ok);
  return i44_tap(taps[16 * m + (k & 15)], nv);
}

// Whether mode m is available (kernels/intra44.py `_avail9`): 0, 3 and 7
// need T; 1 and 8 need L; 4, 5 and 6 both; DC (2) always.
__device__ __forceinline__ bool i44_avail(int m, bool l_ok, bool t_ok) {
  return m == 2 || ((m == 1 || m == 8)        ? l_ok
                    : (m >= 4 && m <= 6) ? l_ok && t_ok
                                         : t_ok);
}

// The encoder's DC prediction (pred_dc) of the block whose first sample
// (0, 0) is at pix[0], from its L and T samples in the MB's samples (the
// encoder's are 0..255: no sum wraps).  Per lane, no cross-lane step.
// i44_dc's twin (the decoder's, from neighbours held in lanes, wrapping):
// a change of the DC rule goes into both.
__device__ __forceinline__ int i44_dc_at(const int* pix, bool l_ok,
                                         bool t_ok) {
  const int4 tv = *reinterpret_cast<const int4*>(pix - kI44Pitch);
  const int st = tv.x + tv.y + tv.z + tv.w;
  const int sl = pix[-1] + pix[kI44Pitch - 1] + pix[2 * kI44Pitch - 1] +
                 pix[3 * kI44Pitch - 1];
  if (l_ok && t_ok) return (st + sl + 4) >> 3;
  if (l_ok || t_ok) return ((l_ok ? sl : st) + 2) >> 2;
  return 128;
}

// The SADs of nine modes, two a word: lanes 0-15 predict the block's
// pixel t & 15 by modes 0, 2, 4, 6, 8 and lanes 16-31 by 1, 3, 5, 7
// (`pred` of pass j, `src` the lane's source sample, both 0..255); word j
// is the warp's sum of |src - pred| (lanes 16-31 shifted by 16, none of
// theirs in pass 4), one redux.sync a word: modes 2j in bits 0-15 and 2j
// + 1 in bits 16-31, each at most 16 * 255.  Every lane gets every word.
// (A tree of xor shuffles instead: ten instructions a word against one,
// and slower on the card: tools/time_intra16.py, PERF.md.)
struct I44Sads {
  unsigned w[5];
};

__device__ __forceinline__ I44Sads i44_sads(int src, const int* pred,
                                            int k) {
  I44Sads s;
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const unsigned d = (unsigned)abs(src - pred[j]);
    s.w[j] = k < 16 ? d : j < 4 ? d << 16 : 0u;
  }
#pragma unroll
  for (int j = 0; j < 5; ++j) s.w[j] = __reduce_add_sync(0xffffffffu, s.w[j]);
  return s;
}

// The encoder's mode of the block (`encode_mb`): the first index of the
// least SAD among the available modes (`argmin_first`; an unavailable
// mode costs INT32_MAX): the least of the keys SAD * 16 + m, in
// registers.  Warp-uniform.
__device__ __forceinline__ int i44_best(const I44Sads& s, bool l_ok,
                                        bool t_ok) {
  int key[9];
#pragma unroll
  for (int m = 0; m < 9; ++m)
    key[m] = i44_avail(m, l_ok, t_ok)
                 ? (int)((s.w[m >> 1] >> (16 * (m & 1))) & 0xffffu) * 16 + m
                 : 0x7fffffff;
  const int a = min(min(key[0], key[1]), min(key[2], key[3]));
  const int b = min(min(key[4], key[5]), min(key[6], key[7]));
  return min(min(a, b), key[8]) & 15;
}

}  // namespace
