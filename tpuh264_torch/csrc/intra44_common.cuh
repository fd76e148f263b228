// The Intra_4x4 luma predictor (H.264 8.3.1.2) of the row-slice layout:
// the neighbour rules, DC and the nine modes of kernels/intra44.py
// (`_gather_neighbors`, `pred_dc`, `pred_directional`, `_select`), the
// encoder's mode choice (`_avail9`, the SADs, `argmin_first`), and the
// order in which the kernels walk a MB's 16 blocks: their 10 dependency
// levels, both blocks of a level that has two at once.  K5's Intra_4x4
// route (intra_recon.cu) walks a MB so in one warp, a half-warp a block;
// K6's (intra16_enc.cu, the encoder's trial) in two warps, a warp a
// block.
// The predictor assumes nothing of the samples' range (K5's left column
// may be any int32 where the left MB took `other`), so every sum wraps
// as the plain version's int32 sums do; the SADs assume 0..255 samples,
// as the encoder's are.
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
// DC, has no taps (its words are 0; every other word is not): it depends
// on which neighbours are available.
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

// The dependency levels of the MB's blocks.  Block bi reads its left, top,
// top-left and, where tr_real(bi), top-right block (i44_neighbour), so
// the blocks fall into 10 levels, in z-scan indices
//   {0} {1} {2, 4} {3, 5} {6, 8} {7, 9} {10, 12} {11, 13} {14} {15},
// each block's neighbours on lower levels: no two blocks of a level read
// each other's samples, and a walk of the levels in order (the blocks of
// a level in any order) gives the z-scan walk's result exactly.  Level
// l's blocks are i44_level_block(l, 0) and (l, 1), the same block where
// the level has one.  i44_levels_hold() checks the table against blk_x,
// blk_y and tr_real.
constexpr int kI44Levels = 10;
__host__ __device__ constexpr int i44_level_block(int l, int h) {
  return (int)(((h ? 0xfedc985410ull : 0xfeba763210ull) >> (4 * l)) & 15);
}

// the level of block bi (-1 where the table has none)
__host__ __device__ constexpr int i44_level_of(int bi) {
  int lv = -1;
  for (int l = 0; l < kI44Levels; ++l)
    if (i44_level_block(l, 0) == bi || i44_level_block(l, 1) == bi) lv = l;
  return lv;
}

// Every block on one level, and every block it reads (L, T, X, TR where
// real, inside the MB) on a lower one.
__host__ __device__ constexpr bool i44_levels_hold() {
  for (int bi = 0; bi < 16; ++bi) {
    int n = 0;
    for (int l = 0; l < kI44Levels; ++l)
      n += (i44_level_block(l, 0) == bi) +
           (i44_level_block(l, 1) == bi &&
            i44_level_block(l, 1) != i44_level_block(l, 0));
    if (n != 1) return false;
    const int x = blk_x(bi), y = blk_y(bi);
    for (int b = 0; b < 16; ++b) {
      const int dx = blk_x(b) - x, dy = blk_y(b) - y;
      const bool reads = (dx == -1 && dy == 0) || (dx == 0 && dy == -1) ||
                         (dx == -1 && dy == -1) ||
                         (dx == 1 && dy == -1 && tr_real(bi));
      if (reads && i44_level_of(b) >= i44_level_of(bi)) return false;
    }
  }
  return true;
}
static_assert(i44_levels_hold(),
              "a block of the level table reads one of its own level");

// The sample index that lane k (0..12) of a half-warp reads as n[k] of
// block bi: L0..3, X, T0..3, TR0..3 (TR real or T3 repeated); k 13-15
// read n[0]'s.
__device__ __forceinline__ int i44_neighbour(int bi, int k) {
  const int x0 = 4 * blk_x(bi), y0 = 4 * blk_y(bi);
  if (k < 4) return i44_at(x0 - 1, y0 + k);
  if (k == 4) return i44_at(x0 - 1, y0 - 1);
  if (k < 9 || (k < 13 && tr_real(bi))) return i44_at(x0 + k - 5, y0 - 1);
  if (k < 13) return i44_at(x0 + 3, y0 - 1);
  return i44_at(x0 - 1, y0);
}

// The block's DC prediction (pred_dc, wrapping as its int32 sums) from
// its L and T samples in the MB's samples, the block's first sample (0,
// 0) at pix[0]; l_ok / t_ok: L / T available.  Per lane, no cross-lane
// step.
__device__ __forceinline__ int i44_dc_at(const int* pix, bool l_ok,
                                         bool t_ok) {
  const int4 tv = *reinterpret_cast<const int4*>(pix - kI44Pitch);
  const unsigned st = (unsigned)tv.x + (unsigned)tv.y + (unsigned)tv.z +
                      (unsigned)tv.w;
  const unsigned sl = (unsigned)pix[-1] + (unsigned)pix[kI44Pitch - 1] +
                      (unsigned)pix[2 * kI44Pitch - 1] +
                      (unsigned)pix[3 * kI44Pitch - 1];
  if (l_ok && t_ok) return (int)(st + sl + 4u) >> 3;
  if (l_ok || t_ok) return (int)((l_ok ? sl : st) + 2u) >> 2;
  return 128;
}

// A lane's prediction by tap word w (a directional mode's, of its pixel)
// from the neighbours n[k] that lanes `base` + k (k = 0..12; base = t &
// 16: each half-warp predicts a block of its own) hold in `nv`.  Every
// lane of the warp takes part; the words may differ from lane to lane (a
// word of 0, DC's, gives 0).
__device__ __forceinline__ int i44_tap(uint32_t w, int nv, int base) {
  const unsigned n0 =
      __shfl_sync(0xffffffffu, (unsigned)nv, base | (w & 15));
  const unsigned n1 =
      __shfl_sync(0xffffffffu, (unsigned)nv, base | ((w >> 4) & 15));
  const unsigned n2 =
      __shfl_sync(0xffffffffu, (unsigned)nv, base | ((w >> 8) & 15));
  const unsigned acc = n0 * ((w >> 12) & 3) + n1 * ((w >> 14) & 3) +
                       n2 * ((w >> 16) & 3) + ((w >> 18) & 3);
  return (int)acc >> ((w >> 20) & 3);
}

// The neighbours' ring, L3 L2 L1 L0 X T0 .. T3 TR0 .. TR3: neighbour k's
// predecessor and successor on it (an end its own).
__host__ __device__ constexpr int i44_ring_prev(int k) {
  return k == 3 ? 3 : k < 3 ? k + 1 : k == 4 ? 0 : k - 1;
}
__host__ __device__ constexpr int i44_ring_next(int k) {
  return k == 0 ? 4 : k < 4 ? k - 1 : k == 12 ? 12 : k + 1;
}

// Every directional prediction is a neighbour n[k] (S 0), its mean with
// its ring successor (n[k] + n[next] + 1) >> 1 (S 1), or its 3-tap filter
// (n[prev] + 2 n[k] + n[next] + 2) >> 2 (S 2; at an end of the ring the
// end counts thrice).  Lane k (0..12) packs the three for its k into
// bytes 0, 1 and 2 of one word, from the neighbours lanes 0..12 hold in
// `nv` (the encoder's samples, 0..255).  The encoder's trial takes each
// of its predictions by one shuffle of these words (`i44_pick`), not by
// three of `i44_tap`: 0.92 -> 0.75 ms a 1080p x 4 I frame on the card
// (tools/time_intra16.py, PERF.md).
__device__ __forceinline__ uint32_t i44_filtered(int nv, int k) {
  const int a = __shfl_sync(0xffffffffu, nv, i44_ring_prev(k));
  const int b = __shfl_sync(0xffffffffu, nv, i44_ring_next(k));
  return (uint32_t)nv | (uint32_t)((nv + b + 1) >> 1) << 8 |
         (uint32_t)((a + 2 * nv + b + 2) >> 2) << 16;
}

// The form of tap word w (a directional mode's, of a pixel) in those
// packed words: the lane that holds it in bits 16-20 and, in bits 0-15,
// the byte_perm selector that takes its byte (S) to byte 0.
__host__ __device__ constexpr uint32_t i44_form(uint32_t w) {
  const int s = (w >> 20) & 3, a = w & 15, b = (w >> 4) & 15;
  int k = a;
  if (s == 1) k = i44_ring_next(a) == b ? a : b;
  if (s == 2)
    for (int j = 0; j < 3; ++j)
      if (((w >> (12 + 2 * j)) & 3) >= 2) k = (w >> (4 * j)) & 15;
  return (uint32_t)k << 16 | 0x4440u | (uint32_t)s;
}

// A lane's prediction by form f (i44_form) from the packed words `fw`.
__device__ __forceinline__ int i44_pick(uint32_t f, uint32_t fw) {
  return (int)__byte_perm(__shfl_sync(0xffffffffu, fw, f >> 16), 0, f);
}

// Whether mode m is available (kernels/intra44.py `_avail9`): 0, 3 and 7
// need T; 1 and 8 need L; 4, 5 and 6 both; DC (2) always.
__device__ __forceinline__ bool i44_avail(int m, bool l_ok, bool t_ok) {
  return m == 2 || ((m == 1 || m == 8)        ? l_ok
                    : (m >= 4 && m <= 6) ? l_ok && t_ok
                                         : t_ok);
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
// registers, two a word.  Warp-uniform.  (Keys a register each and a
// tree of mins: 3-4% slower on the card, tools/time_intra16.py.)
__device__ __forceinline__ int i44_best(const I44Sads& s, bool l_ok,
                                        bool t_ok) {
  // the keys of modes 2j and 2j + 1 as the two halves of a word (at most
  // 4080 * 16 + 8 < 0xffff), 0xffff where unavailable (word 4: mode 8
  // alone); their least by DPX 16-bit mins
  unsigned key[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    key[j] = (s.w[j] << 4) | (unsigned)(2 * j) |
             (i44_avail(2 * j, l_ok, t_ok) ? 0u : 0xffffu) |
             (j < 4 && i44_avail(2 * j + 1, l_ok, t_ok)
                  ? (unsigned)(2 * j + 1) << 16
                  : 0xffff0000u);
  const unsigned m = __vimin3_u16x2(__vimin3_u16x2(key[0], key[1], key[2]),
                                    key[3], key[4]);
  return (int)min(m & 0xffffu, m >> 16) & 15;
}

}  // namespace
