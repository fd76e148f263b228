// K6: the encoder's intra column scans (D3, the I encode, with its
// Intra_4x4 route for `intra44`, and D4, the intra-in-P trial of the P
// encode): a block of six warps per MB row, with only the
// prediction-dependent work on the column chain.
//
// Replaces: the jax.lax.scan of tpuh264/kernels/iframe.py
// `encode_iframe_scan` (:199; step :219, its Intra_4x4 trial and choice
// :233-260 with tpuh264/kernels/intra44.py `encode_mb` :289, scan :308)
// and the intra-in-P scan of tpuh264/kernels/pframe.py
// `encode_pframe_rows_multi` (:638; `_intra16_costs` :531, substep :866,
// scan :989), not pallas_calls.  Its plain PyTorch versions are
// `kernels/iframe.py` `_encode_iframe_scan_plain` and
// `kernels/pframe.py` `_intra_in_p_scan_plain`.
//
// What it computes, exactly as the plain versions (`_intra16_mb` a
// column): each MB is predicted from the left MB's right sample column
// (luma: DC (sum of the 16 + 8) >> 4 or H; chroma: DC per 4-row half
// (sum of the 4 + 2) >> 2 or H), 128 and DC only in column 0; luma
// chooses by its SAD, chroma by the summed Cb + Cr SAD, ties to DC.
// Then the forward 4x4 transform of src - pred; the 16 luma DCs through
// the 4x4 Hadamard and quant_luma_dc, the chroma DCs through the 2x2
// Hadamard and quant_chroma_dc; the AC through quant4x4 (intra
// rounding f = 2^qbits / 3); and the reconstruction: DC dequant, AC
// dequant, inverse 4x4, (+ 32) >> 6, clip to 0..255.  The plain
// versions mask the dequantised levels by cbp; here every mask is a
// no-op (a cbp of 0 means those levels are all zero), so none is
// applied.  With `inter_sad` (D4) the MB takes the intra result only
// where its luma SAD is strictly below inter_sad (inter wins a tie);
// elsewhere its reconstruction is `rec_inter`, and that final
// reconstruction is the next MB's left neighbour.
//
// Arithmetic: every `>>` of a negative value is arithmetic (signed int,
// as torch's); a dequant `(z * v) << k` is written as a multiply by
// 1 << k (a left shift of a negative value is undefined in C++17); every
// product fits int32 (golden/transform.py).  QP is an argument: the rate
// controller moves it from frame to frame.  The source planes and
// `rec_inter` hold 8-bit samples (0..255), as every plane of the codec
// does: the SADs are taken on packed bytes (__vsadu4), DC and H summed
// in the two halves of one 32-bit word (each at most 65,280).
//
// The algebra the design rests on, exact in integers:
//  1. The forward core transform F (forward4x4: adds and 2*) is linear:
//     F(src - pred) = F(src) - F(pred).
//  2. A DC prediction is constant over a 4x4 block (chroma's DC per
//     4-row half too): F(pred) is 16 pdc at raster 0, zero elsewhere.
//  3. An H prediction p_r is constant along each row r: F(pred) is zero
//     but at rasters 0, 4, 8, 12, where it is 4 v_r, v = forward4x4's
//     vertical butterfly of (p_0 .. p_3) (v_0 their sum).
//  4. So 12 of a block's 15 AC levels are quant(F(src)), off the
//     prediction; the levels at 4, 8, 12 are quant(F(src) - 4 v) (v = 0
//     for DC); a block's DC coefficient is its sample sum S less 16 pdc
//     or 4 v_0.  Through the luma DC Hadamard H X H: Fh - 256 pdc at
//     (0, 0) (DC) or Fh - 16 (H L)_i at (i, 0) (H; L_by the sum of block
//     row by's four left samples), Fh the Hadamard of the sums S: only
//     its column j = 0 depends on the prediction.  Chroma's 2x2: Fc less
//     2 (s a)_i at (i, 0), a_r = 16 dcs_r (DC) or 4 L_r (H).
//  5. The inverse transform's row pass takes the `>> 1` of d1 and d3
//     apart, so output x of row r is d0_r + P[r][x], P from the row's
//     other three dequantised levels: off the prediction.  Column 3 is
//     d0_r + K_r, K_r = d2 - d1 - (d3 >> 1); d0_r is the dequantised DC
//     (r = 0) or the level at 4r.
//  6. So the next MB's left column (the final right sample column) needs
//     on the chain only: the SADs and the choice, the prediction-
//     dependent DC levels (4 luma, 2 a chroma plane) and the inverse
//     Hadamard of the right-hand blocks, their levels at 4, 8, 12, and
//     the column pass of their column 3; the rest is done off it.
//
// Design.  What bounds the kernel on the H100 is integer issue and the
// latency of one warp's instruction stream, not bytes.  The S x R MB rows
// are independent lanes (272 at 1080p x 4, 240 at 480p x 8), so an SM
// runs two or three of them; a warp alone issues about one instruction
// every three cycles, and an SM sub-partition at most half a warp of
// integer work a cycle.  So each lane's column work is cut short on the
// chain (6.) and spread over the six warps of a 192-thread block, none
// of them a long stream, with few instructions in all.  Each warp role
// runs its own loop of C + 2 steps (registers per role: 96 in all, so
// three blocks share an SM); the roles meet at one block barrier a step
// over a ring of kSlots MB columns in shared memory.  At step k:
//  * prep, column k (warp 2 luma, two threads a 4x4 block, each two of
//    its rows; warp 3 chroma, four threads a block, a row each): the
//    source packed as bytes for the chains' SADs, F(src), the 12
//    prediction-independent levels (written out in zigzag order, the
//    slots of rasters 4, 8, 12 left to finish) and whether any is
//    nonzero, the row pass P, the block sums; after a __syncwarp, the DC
//    Hadamards of the sums (luma by xor-shuffle butterflies), quantised
//    off column 0.  Column k + 1's source is loaded meanwhile.
//  * the chains, column k - 1 (warp 0 luma, warp 1 chroma; a right
//    column row a lane, lanes 16-31 repeating 0-15): the left column from
//    shared memory, the lane's 8 (chroma 4) samples' DC and H SADs in one
//    packed xor-shuffle reduction, and in its shadow both candidates of
//    the lane's row: the DC levels at (i, 0), the inverse Hadamard's row
//    of the right-hand block, the levels at 4, 8, 12 (under DC no more
//    than quant(F(src))) and the column pass of column 3.  The choice
//    picks one (D4: rec_inter's right sample where inter wins, loaded a
//    column ahead), and lanes 0-15 store the next column's left.  The
//    chroma chain picks the last column's intra or inter right samples
//    at the start of the column, by the luma chain's `use` of the step
//    before (D4).
//  * finish, column k - 2 (warp 4 luma, two threads a block, each two of
//    its columns; warp 5 chroma, four threads a block, a column each):
//    the levels at 4, 8, 12 (their zigzag slots), the dequantised DC, the
//    column passes, the reconstruction, cbp by ballots, the DC levels,
//    modes, SAD and choice; D4 copies rec_inter where inter wins.
//
// The Intra_4x4 route (`intra44`, the entry th264_intra44_encode_rows):
// the template instance kI44, so that the D3 and D4 instances keep their
// code and registers.  Per MB (kernels/iframe.py `_intra44_choice`) the
// Intra_16x16 candidate above and the causal Intra_4x4 trial
// (kernels/intra44.py `encode_mb`: the 16 blocks in z-scan order, each
// predicted by the first available mode of least SAD from the samples the
// blocks before it reconstructed, its 16 levels quant4x4 (intra) of
// forward4x4, its samples idct_add); the MB keeps the one of lower J = 8
// SSD + lam8 rate (rate: 8 + the DC and AC levels' 2 bit_length + 1 for
// Intra_16x16, 96 + the levels' for Intra_4x4; Intra_16x16 on a tie), and
// its luma right column is the next MB's left.  Chroma does not depend on
// the choice.  The next left now needs the whole candidate (its SSD and
// rate) and the trial's dependent block steps, so D3's split of the luma
// chain does not carry over: the instance re-schedules the luma roles, at
// step k column k - 1:
//  * warps 0 and 5 walk the trial through the MB's samples in shared
//    memory (intra44_common.cuh's layout, the left column beside them) by
//    the blocks' 10 dependency levels (intra44_common.cuh: no block reads
//    another of its level), warp 0 each level's first block and warp 5
//    the second of the six levels that have two, meeting at named barrier
//    2 after each of levels 1-7.  A block step (`trial_block`) reads the
//    13 neighbours and DC's samples, packs each neighbour's 2-tap mean and
//    3-tap filter beside it, takes the other modes two a pass, each by
//    one shuffle of those packed words (`i44_form` of its tap word: lanes
//    0-15 modes 0, 2, 4, 6, 8, lanes 16-31 1, 3, 5, 7), the passes' SADs
//    two a word by one redux each, the first least
//    available mode from keys in registers, forward4x4, quant, dequant and
//    inverse4x4 by shuffles along rows and columns; lanes 0-15 store the
//    samples and levels.  Warp 5 leaves its part of the SSD, rate and cbp
//    in shared memory and, while warp 0 walks the last two levels alone,
//    runs the chroma finish of column k - 2 (its role in D3); warp 0 sums
//    the SSD, rate and cbp and arrives at named barrier 1.
//  * warp 4 meanwhile runs the chain's Intra_16x16 choice and finish's
//    levels and reconstruction of the same column, with its SSD and rate;
//    then bar.sync on barrier 1, the choice, every luma store of the
//    winner, and the next column's left.
//  * prep (warps 2, 3) and the chroma chain (warp 1) are D3's.
// It is bound by the trial's chain, 10 levels of a block step each, and
// by the issue its warps share with the other lanes' on an SM: a block
// step alone took ~1,100 cycles on the H100 (16 in z-scan order a MB),
// two at once ~1,500, and ~1,200 with the predictions taken from the
// packed ring (some 60 instructions fewer a step; PERF.md).  The block's
// other warps wait on it.  The 10 levels are unrolled: ptxas keeps the
// instance at 96 registers for three blocks an SM.  (A seventh warp for
// the second blocks held ptxas to 80 registers, with spills; one warp
// walking both blocks of a level, a half-warp each with nine modes a
// lane, ran slower than the z-scan walk.)  Every J stays within int32
// (luma44_column).

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"  // the quantiser, zigzag and Hadamard
                                // helpers K6 shares with K7 / K8
#include "intra44_common.cuh"  // the Intra_4x4 neighbours, predictor and
                                // mode choice K6 shares with K5

#ifdef __CUDACC__
namespace {
// bar.arrive / bar.sync on the named barrier `id` of `n` threads: the
// kI44 instance's hand-over from its trial warp to its luma warp (the
// arrive orders the trial's shared-memory stores before the wait's
// return)
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}
__device__ __forceinline__ void bar_wait(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}
}  // namespace
#endif

namespace {

constexpr int kThreads = 192;
constexpr int kLuma = 0, kChroma = 1, kPrepY = 2, kPrepC = 3, kFinY = 4,
              kFinC = 5;  // warps: chains, prep, finish
constexpr int kSlots = 3;  // ring: prepared, chained, finished columns

struct Args {
  const void *sy, *su, *sv;    // source planes [S,H,W], [S,H/2,W/2]
  int src_u8;                  // 1: uint8 samples, 0: int32
  const int32_t* inter_sad;    // D4: [lanes, C]; null for D3
  const int32_t *iy, *iu, *iv; // D4: rec_inter, MB layout [lanes,C,n,n]
  int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [lanes, C]
  int32_t* sad;                // D4: [lanes, C]; may be null
  uint8_t* use;                // D4: [lanes, C] 0 / 1; null for D3
  int16_t *dc, *ac, *cdc, *cac;  // [.,16], [.,16,16], [.,2,4], [.,2,4,15]
  int16_t* i4;                 // D3: [., 16] set to -1; may be null
  uint8_t *ry8, *ru8, *rv8;    // D3: uint8 recon planes, raster
  int32_t *ry, *ru, *rv;       // D4: int32 final recon, MB layout
  int lanes, C, qp, qpc;
  const uint32_t* taps;        // kI44: the Intra_4x4 tap words
  int lam8;                    // kI44: iframe.py _LAMBDA8[qp]
};

// One MB column of the lane.  Blocks 0-15 are luma (by * 4 + bx), 16-19
// Cb and 20-23 Cr (by * 2 + bx); coefficients raster.  Every array is
// 16-byte aligned: the roles read and write them as int4 / uint2.
struct __align__(16) Slot {
  // prep's
  __align__(16) uint32_t ys[64];  // luma source bytes, row-major, 4 a word
  __align__(16) uint32_t cs[32];  // chroma's: Cb rows 0-7, then Cr, 2 a row
  __align__(16) int S[24];        // each block's sample sum, F(src) at 0
  __align__(16) int zl[16];       // luma Fh (i, j): raw at j 0,
                                  // quant_luma_dc at j >= 1
  __align__(16) int zq0[4];       // quant_luma_dc of Fh (i, 0)
  __align__(16) int zc[8];        // chroma Fc per plane (4p + 2i + j): raw
                                  // at j 0, quant_chroma_dc at j 1
  __align__(16) int16_t lv[24][16];  // levels off column 0; raw F(src) at
                                     // rasters 0, 4, 8, 12
  __align__(16) int P[24][16];    // the row pass of the levels off column 0
  // the chains'
  __align__(16) int lft[16];      // the luma left column of this MB
  __align__(16) int clft[16];     // chroma's (Cb 8, Cr 8)
  __align__(16) int zl0[4];       // the luma DC levels at (i, 0)
  __align__(16) int zc0[4];       // the chroma DC levels at (i, 0), 2p + i
  __align__(16) int cdcp[4];      // chroma DC predictions, 2p + half
  int mode, cmode, pdc, sad, use;
  int nzy, nzc;  // prep's: a luma / chroma AC level off rasters 4, 8, 12
                 // is nonzero
};

// forward4x4's vertical butterfly of one column p (v.x the sum): 4 v is
// F(pred) at rasters 0, 4, 8, 12 of an H prediction p
__device__ __forceinline__ int4 vert(int4 p) {
  const int a0 = p.x + p.w, a1 = p.y + p.z, a2 = p.y - p.z, a3 = p.x - p.w;
  return make_int4(a0 + a1, 2 * a3 + a2, a0 - a1, a3 - 2 * a2);
}

// The inverse transform's column pass of one column f, (+ 32) >> 6 and
// the prediction p of each row, clipped: the block's final samples.
__device__ __forceinline__ int4 column(int f0, int f1, int f2, int f3,
                                       int4 p) {
  const int g0 = f0 + f2, g1 = f0 - f2;
  const int g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
  return make_int4(clip255(p.x + ((g0 + g3 + 32) >> 6)),
                   clip255(p.y + ((g1 + g2 + 32) >> 6)),
                   clip255(p.z + ((g1 - g2 + 32) >> 6)),
                   clip255(p.w + ((g0 - g3 + 32) >> 6)));
}

// Output row r of the column pass, less f0 (which enters every row as
// it is): f2 + f1 + (f3 >> 1), -f2 + (f1 >> 1) - f3, -f2 - (f1 >> 1) +
// f3, f2 - f1 - (f3 >> 1), without a branch on r.
struct RowOf {
  bool mid;  // rows 1 and 2 take f1 >> 1 and f3, rows 0 and 3 f1, f3 >> 1
  int s1, s2, s3;
};

__device__ __forceinline__ RowOf row_of(int r) {
  return RowOf{r == 1 || r == 2, r < 2 ? 1 : -1, (r == 0 || r == 3) ? 1 : -1,
               (r == 0 || r == 2) ? 1 : -1};
}

__device__ __forceinline__ int rest_of_row(const RowOf& w, int f1, int f2,
                                           int f3) {
  return w.s2 * f2 + w.s1 * (w.mid ? f1 >> 1 : f1) +
         w.s3 * (w.mid ? f3 : f3 >> 1);
}

// Row r of the right sample column of a right-hand block: its levels at
// 4, 8, 12 from the raw F(src) (ra.y, .z, .w) less 4 v (v zero for a DC
// prediction), dequantised, plus K (kk); d0 of row 0 the dequantised DC
// `dcd`; the column pass; + the row's prediction `pred`, clipped.
__device__ __forceinline__ int right_sample(const Quant& q, int dcd,
                                            int4 ra, int4 k, int4 v,
                                            int pred, const RowOf& w) {
  const int f1 = dq_ac(q, q_ac(q, ra.y - 4 * v.y, 2), 2) + k.y;
  const int f2 = dq_ac(q, q_ac(q, ra.z - 4 * v.z, 0), 0) + k.z;
  const int f3 = dq_ac(q, q_ac(q, ra.w - 4 * v.w, 2), 2) + k.w;
  return clip255(pred + ((dcd + k.x + rest_of_row(w, f1, f2, f3) + 32) >> 6));
}

// A prep or finish thread's block: plane 0 luma, 1 Cb, 2 Cr; j its raster
// index in its plane's MB, n the MB width; b its index among the 24; h
// its half (luma, two threads a block) or its row / column (chroma, four
// threads a block).
struct Block {
  int b, h, plane, by, bx, j, n;
};

__device__ __forceinline__ Block block_of(bool luma, int t) {
  if (luma) {
    const int i = t >> 1;
    return Block{i, t & 1, 0, i >> 2, i & 3, i, 16};
  }
  const int i = t >> 2, j = i & 3;
  return Block{16 + i, t & 3, 1 + (i >> 2), j >> 1, j & 1, j, 8};
}

// A block's four source rows, loaded a step ahead by the prep warps, as
// packed bytes (every thread of a block loads all four).  int32 samples
// (0..255) are packed too, at the end of the step that loads them, so
// that the loads' latency passes under that step's work.
struct Next {
  uint32_t w[4];
};

struct Raw {
  int4 v[4];
};

__device__ __forceinline__ void prep_load(Next& nx, Raw& raw, const Args& a,
                                          const Block& k, size_t lane,
                                          int col) {
  const size_t w = (size_t)a.C * k.n;
  const size_t row0 = lane * k.n + 4 * k.by, x0 = (size_t)col * k.n + 4 * k.bx;
  const void* p = k.plane == 0 ? a.sy : k.plane == 1 ? a.su : a.sv;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const size_t o = (row0 + y) * w + x0;
    if (a.src_u8)
      nx.w[y] = *reinterpret_cast<const uint32_t*>(
          static_cast<const uint8_t*>(p) + o);
    else
      raw.v[y] = *reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(p) + o);
  }
}

// Zigzag slot s's level of a block whose levels (raster) sit at lv, as
// prep writes it: 0 at the DC's slot 0 and at the slots of rasters 4, 8,
// 12 (2, 3, 9), which finish writes.
__device__ __forceinline__ int prep_slot(const int16_t* lv, int s) {
  return (s == 0 || s == 2 || s == 3 || s == 9) ? 0 : lv[zz(s)];
}

// The DC Hadamards of the block sums, quantised off column j = 0 (the
// only one the prediction reaches): luma by butterflies across lanes
// (lane t and t + 16: sum t), ending with Fh(pi(p), pi(q)) in lane (p, q)
// (pi = (0, 3, 1, 2), the sequency order of the Hadamard matrix's rows);
// chroma a thread an element (t < 8).
__device__ void prep_dc(Slot& s, bool luma, int t, const Quant& q) {
  if (luma) {
    int f = s.S[t & 15];
#pragma unroll
    for (int o = 1; o < 16; o <<= 1) {
      const int g = __shfl_xor_sync(0xffffffffu, f, o);
      f = (t & o) ? g - f : f + g;
    }
    const int i = (0x2130 >> (4 * ((t >> 2) & 3))) & 15,
              j = (0x2130 >> (4 * (t & 3))) & 15;
    const int z = q_ldc(q, f);
    if (t < 16) s.zl[4 * i + j] = j ? z : f;
    if (t < 16 && j == 0) s.zq0[i] = z;
  } else if (t < 8) {
    const int i = (t >> 1) & 1, j = t & 1;
    const int4 S4 = ld4(s.S + 16 + 4 * (t >> 2));
    const int f = (S4.x + (j ? -S4.y : S4.y)) +
                  (i ? -1 : 1) * (S4.z + (j ? -S4.w : S4.w));
    s.zc[t] = j ? q_cdc(q, f) : f;
  }
}

// The luma prep of column col (warp 2): thread t, rows 2h, 2h + 1 of
// block t >> 1.
__device__ void prep_luma(const Args& a, Slot& s, const Next& nx,
                          const Block& k, size_t lane, int col, int t,
                          const Quant& q) {
  const size_t m = lane * a.C + col;
  const int h = k.h;
  int x[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = (nx.w[i >> 2] >> (8 * (i & 3))) & 255;
  // the source as bytes, for the chain's SADs
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
    s.ys[(4 * k.by + 2 * h + rr) * 4 + k.bx] = h ? nx.w[2 + rr] : nx.w[rr];
  // forward4x4: the vertical butterflies' rows 2h, 2h + 1, then those
  // rows' horizontal ones
  const int m1 = h ? 1 : 2, m2 = h ? -2 : 1, sg = h ? -1 : 1;
  int v[2][4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a0 = x[c] + x[12 + c], a1 = x[4 + c] + x[8 + c];
    const int a2 = x[4 + c] - x[8 + c], a3 = x[c] - x[12 + c];
    v[0][c] = a0 + sg * a1;       // row 0 (h 0) or 2 (h 1)
    v[1][c] = m1 * a3 + m2 * a2;  // row 1: 2 a3 + a2; row 3: a3 - 2 a2
  }
  int lv[8], pr[8];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    const int p0 = v[rr][0], p1 = v[rr][1], p2 = v[rr][2], p3 = v[rr][3];
    const int b0 = p0 + p3, b1 = p1 + p2, b2 = p1 - p2, b3 = p0 - p3;
    const int f[4] = {b0 + b1, 2 * b3 + b2, b0 - b1, b3 - 2 * b2};
    int d[4];
    lv[4 * rr] = f[0];  // raw in column 0
#pragma unroll
    for (int c = 1; c < 4; ++c) {
      const int cl = pos_class(4 * rr + c);  // row parity is rr's
      lv[4 * rr + c] = q_ac(q, f[c], cl);
      d[c] = dq_ac(q, lv[4 * rr + c], cl);
    }
    // inverse4x4's row pass with d0 = 0
    const int e2 = (d[1] >> 1) - d[3], e3 = d[1] + (d[3] >> 1);
    pr[4 * rr] = d[2] + e3;
    pr[4 * rr + 1] = e2 - d[2];
    pr[4 * rr + 2] = -d[2] - e2;
    pr[4 * rr + 3] = d[2] - e3;
  }
  if (h == 0) s.S[k.b] = lv[0];
  reinterpret_cast<int4*>(s.lv[k.b])[h] =
      make_int4(pack16(lv[0], lv[1]), pack16(lv[2], lv[3]),
                pack16(lv[4], lv[5]), pack16(lv[6], lv[7]));
  int4* pp = reinterpret_cast<int4*>(s.P[k.b]) + 2 * h;
  pp[0] = make_int4(pr[0], pr[1], pr[2], pr[3]);
  pp[1] = make_int4(pr[4], pr[5], pr[6], pr[7]);
  __syncwarp();
  // zigzag slots 8h .. 8h + 7 of the levels off rasters 4, 8, 12
  int zs[8], nz = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) nz |= zs[i] = prep_slot(s.lv[k.b], 8 * h + i);
  reinterpret_cast<int4*>(a.ac + m * 256 + 16 * k.b)[h] =
      make_int4(pack16(zs[0], zs[1]), pack16(zs[2], zs[3]),
                pack16(zs[4], zs[5]), pack16(zs[6], zs[7]));
  const uint32_t nzb = __ballot_sync(0xffffffffu, nz != 0);
  if (t == 0) s.nzy = nzb != 0;
  prep_dc(s, true, t, q);
}

// The chroma prep of column col (warp 3): thread t, row r = t & 3 of
// block 16 + (t >> 2); `stage` holds the chroma AC levels in their output
// order; qm / qv the quantiser / dequantiser factors of the row's
// positions 1-3.
__device__ void prep_chroma(const Args& a, Slot& s, int16_t* stage,
                            const Next& nx, const Block& k, size_t lane,
                            int col, int t, const Quant& q, int4 cr,
                            int4 qm, int4 qv) {
  const size_t m = lane * a.C + col;
  const int r = k.h, p = k.plane - 1;
  const uint32_t wr = r == 0 ? nx.w[0] : r == 1 ? nx.w[1]
                      : r == 2 ? nx.w[2] : nx.w[3];
  s.cs[16 * p + 2 * (4 * k.by + r) + k.bx] = wr;
  // forward4x4: row r of the vertical butterflies (weights cr), then its
  // horizontal one
  int y[4];
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int x0 = (nx.w[0] >> (8 * c)) & 255, x1 = (nx.w[1] >> (8 * c)) & 255;
    const int x2 = (nx.w[2] >> (8 * c)) & 255, x3 = (nx.w[3] >> (8 * c)) & 255;
    y[c] = cr.x * x0 + cr.y * x1 + cr.z * x2 + cr.w * x3;
  }
  const int b0 = y[0] + y[3], b1 = y[1] + y[2], b2 = y[1] - y[2],
            b3 = y[0] - y[3];
  const int f0 = b0 + b1;  // raw in column 0
  const int l1 = quant(2 * b3 + b2, qm.y, q.fq, q.qbits);
  const int l2 = quant(b0 - b1, qm.z, q.fq, q.qbits);
  const int l3 = quant(b3 - 2 * b2, qm.w, q.fq, q.qbits);
  const int d1 = l1 * qv.y, d2 = l2 * qv.z, d3 = l3 * qv.w;
  // inverse4x4's row pass with d0 = 0
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  if (r == 0) s.S[k.b] = f0;
  *reinterpret_cast<uint2*>(s.lv[k.b] + 4 * r) =
      make_uint2(pack16(f0, l1), pack16(l2, l3));
  reinterpret_cast<int4*>(s.P[k.b])[r] =
      make_int4(d2 + e3, e2 - d2, -d2 - e2, d2 - e3);
  __syncwarp();
  // zigzag slots 4r .. 4r + 3 (slot 0, the DC, is not stored)
  int16_t* o = stage + 60 * p + 15 * k.j - 1;  // slot i at o[i]
  int nz = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int sl = 4 * r + i, z = prep_slot(s.lv[k.b], sl);
    nz |= z;
    if (sl) o[sl] = (int16_t)z;
  }
  const uint32_t nzb = __ballot_sync(0xffffffffu, nz != 0);
  if (t == 0) s.nzc = nzb != 0;
  prep_dc(s, false, t, q);
  __syncwarp();  // the chroma AC staged
  if (t < 15)
    reinterpret_cast<int4*>(a.cac + m * 120)[t] =
        reinterpret_cast<const int4*>(stage)[t];
}

// The raw F(src) at rasters 4, 8, 12 (in .y, .z, .w) and K (column 3 of
// P, rows 0-3) of block b of slot s.
__device__ __forceinline__ int4 raw_of(const Slot& s, int b) {
  return make_int4(0, s.lv[b][4], s.lv[b][8], s.lv[b][12]);
}
__device__ __forceinline__ int4 k_of(const Slot& s, int b) {
  return make_int4(s.P[b][3], s.P[b][7], s.P[b][11], s.P[b][15]);
}

// The luma chain, column col (warp 0; see the note above): lane t takes
// right column row y = t & 15 (lanes 16-31 repeat 0-15) and SAD row t >>
// 1; `ir` / `isad` D4's rec_inter right sample of row y and inter SAD,
// of this column on entry and of the next on return.  kI44 (warp 4 of
// that instance): the Intra_16x16 candidate's choice alone; the next
// column's left waits for the choice against the trial (its right
// samples here go unused, and the compiler drops them).
template <bool kI44>
__device__ void luma_column(const Args& a, Slot& s, Slot& next, size_t lane,
                            int col, int t, const Quant& q, bool d4, int4 sy,
                            const RowOf& w, int& ir, int& isad) {
  const size_t m = lane * a.C + col;
  const bool first = col == 0;
  const int y = t & 15, by = y >> 2;
  const int ir_now = ir, isad_now = isad;
  if (d4 && col + 1 < a.C) {  // the next column's, a step ahead
    ir = a.iy[(m + 1) * 256 + 16 * y + 15];
    isad = a.inter_sad[m + 1];
  }
  const int4 L0 = ld4(s.lft), L1 = ld4(s.lft + 4), L2 = ld4(s.lft + 8),
             L3 = ld4(s.lft + 12);
  const int4 rows = ld4(s.lft + 4 * by);
  const int lsad = s.lft[t >> 1], lme = s.lft[y];
  const uint2 sw = reinterpret_cast<const uint2*>(s.ys)[t];
  const int4 z0 = ld4(s.zl), z1 = ld4(s.zl + 4), z2 = ld4(s.zl + 8),
             z3 = ld4(s.zl + 12), zq = ld4(s.zq0);
  const int4 ra = raw_of(s, 4 * by + 3), kk = k_of(s, 4 * by + 3);

  // DC's prediction, then the DC and H SADs in one packed reduction
  const int lb0 = sum4(L0), lb1 = sum4(L1), lb2 = sum4(L2), lb3 = sum4(L3);
  const int pdc = first ? 128 : (lb0 + lb1 + lb2 + lb3 + 8) >> 4;
  const uint32_t pd4 = (uint32_t)pdc * 0x01010101u;
  const uint32_t ph4 = (uint32_t)lsad * 0x01010101u;
  const uint32_t sads = warp_sum(
      __vsadu4(sw.x, pd4) + __vsadu4(sw.y, pd4) +
      ((__vsadu4(sw.x, ph4) + __vsadu4(sw.y, ph4)) << 16));

  // meanwhile both candidates of row y: R_i = sum over j >= 1 of
  // z(i, j) h(j, 3); the DC levels at (i, 0), quant_luma_dc of Fh(i, 0)
  // less 256 pdc at i = 0 (DC) or less 16 (H L)_i (H); the inverse
  // Hadamard's row by of column 3, dequantised
  const int R0 = z0.z - z0.y - z0.w, R1 = z1.z - z1.y - z1.w,
            R2 = z2.z - z2.y - z2.w, R3 = z3.z - z3.y - z3.w;
  const int zd0 = q_ldc(q, z0.x - 256 * pdc), zd1 = zq.y, zd2 = zq.z,
            zd3 = zq.w;
  const int gd = (zd0 + R0) + sy.y * (zd1 + R1) + sy.z * (zd2 + R2) +
                 sy.w * (zd3 + R3);
  const int rec_dc = right_sample(q, dq_ldc(q, gd), ra, kk, splat(0), pdc, w);
  const int zh0 = q_ldc(q, z0.x - 16 * (lb0 + lb1 + lb2 + lb3));
  const int zh1 = q_ldc(q, z1.x - 16 * (lb0 + lb1 - lb2 - lb3));
  const int zh2 = q_ldc(q, z2.x - 16 * (lb0 - lb1 - lb2 + lb3));
  const int zh3 = q_ldc(q, z3.x - 16 * (lb0 - lb1 + lb2 - lb3));
  const int gh = (zh0 + R0) + sy.y * (zh1 + R1) + sy.z * (zh2 + R2) +
                 sy.w * (zh3 + R3);
  const int rec_h = right_sample(q, dq_ldc(q, gh), ra, kk, vert(rows), lme, w);

  // the choice: DC wins a tie and is column 0's only mode; D4's inter
  // wins a tie with the intra SAD
  const int sad_dc = (int)(sads & 0xffffu), sad_h = (int)(sads >> 16);
  const bool dc = first || sad_dc <= sad_h;
  const int sad = dc ? sad_dc : sad_h;
  const bool use = !d4 || sad < isad_now;
  if (!kI44 && t < 16 && col + 1 < a.C)
    next.lft[y] = use ? (dc ? rec_dc : rec_h) : ir_now;
  if (t < 4)  // the DC levels at (i, 0), for finish
    s.zl0[t] = pick4(dc ? make_int4(zd0, zd1, zd2, zd3)
                        : make_int4(zh0, zh1, zh2, zh3), t);
  if (t == 0) {
    s.mode = dc ? 2 : 1;
    s.pdc = pdc;
    s.sad = sad;
    s.use = use;
  }
}

// The chroma chain, column col (warp 1): lane t takes right column row t
// & 15 (plane p = (t >> 3) & 1, row y = t & 7) and the 4 SAD samples of
// word t; `crec` carries its intra right sample from column to column,
// `ir` its rec_inter right sample (D4), loaded a column ahead of its use.
__device__ void chroma_column(const Args& a, const Slot& pv, Slot& s,
                              size_t lane, int col, int t, const Quant& q,
                              bool d4, const RowOf& w, int& crec, int& ir) {
  const size_t m = lane * a.C + col;
  const bool first = col == 0;
  const int p = (t >> 3) & 1, y = t & 7, hb = y >> 2;
  if (!first) {  // the last column's final right samples: this one's left
    if (t < 16) s.clft[t] = !d4 || pv.use ? crec : ir;
    __syncwarp();
  }
  if (d4)  // this column's, for the next one's left
    ir = (p ? a.iv : a.iu)[m * 64 + 8 * y + 7];
  const int4 c0 = ld4(s.clft + 8 * p), c1 = ld4(s.clft + 8 * p + 4);
  const int4 cs = ld4(s.clft + 4 * (t >> 3));  // the SAD row's half
  const int lsad = s.clft[t >> 1], lme = s.clft[8 * p + y];
  const uint32_t sw = s.cs[t];
  const int4 zc = ld4(s.zc + 4 * p);
  const int4 ra = raw_of(s, 16 + 4 * p + 2 * hb + 1),
             kk = k_of(s, 16 + 4 * p + 2 * hb + 1);

  // DC's prediction of each half, then the summed Cb + Cr SADs
  const int l0 = sum4(c0), l1 = sum4(c1);
  const int d0 = first ? 128 : (l0 + 2) >> 2, d1 = first ? 128 : (l1 + 2) >> 2;
  const int dsad = first ? 128 : (sum4(cs) + 2) >> 2;
  const uint32_t sads = warp_sum(
      __vsadu4(sw, (uint32_t)dsad * 0x01010101u) +
      (__vsadu4(sw, (uint32_t)lsad * 0x01010101u) << 16));

  // meanwhile both candidates of the lane's row: plane p's DC levels at
  // (i, 0), a_r = 16 dcs_r (DC) or 4 L_r (H), and the inverse 2x2
  // Hadamard at (hb, 1)
  const int sg = hb ? -1 : 1;
  const int zd0 = q_cdc(q, zc.x - 32 * (d0 + d1));
  const int zd1 = q_cdc(q, zc.z - 32 * (d0 - d1));
  const int gd = (zd0 - zc.y) + sg * (zd1 - zc.w);
  const int rec_dc = right_sample(q, dq_cdc(q, gd), ra, kk, splat(0),
                              hb ? d1 : d0, w);
  const int zh0 = q_cdc(q, zc.x - 8 * (l0 + l1));
  const int zh1 = q_cdc(q, zc.z - 8 * (l0 - l1));
  const int gh = (zh0 - zc.y) + sg * (zh1 - zc.w);
  const int rec_h = right_sample(q, dq_cdc(q, gh), ra, kk, vert(hb ? c1 : c0),
                             lme, w);

  const bool dc = first || (sads & 0xffffu) <= (sads >> 16);
  crec = dc ? rec_dc : rec_h;
  if (y == 0 && t < 16) {  // lanes 0 and 8: plane p's DC levels
    s.zc0[2 * p] = dc ? zd0 : zh0;
    s.zc0[2 * p + 1] = dc ? zd1 : zh1;
    s.cdcp[2 * p] = d0;
    s.cdcp[2 * p + 1] = d1;
  }
  if (t == 0) s.cmode = dc ? 0 : 1;
}

// The luma finish of column col (warp 4): thread t, columns 2h, 2h + 1
// of block t >> 1; sy, sx its Hadamard signs h(by, i), h(j, bx).
// `luma16` / `store16` below are its twin for the kI44 instance: a change
// of the Intra_16x16 arithmetic or stores goes into both.  (One body for
// both, with the stores in this order or after the recon, gave the D3 /
// D4 instance 88 registers and made D3 1-8% slower on an H100.)
__device__ void finish_luma(const Args& a, const Slot& s, const Block& k,
                            size_t lane, int col, int t, const Quant& q,
                            bool d4, int4 sy, int4 sx) {
  const size_t m = lane * a.C + col;
  const bool use = !d4 || s.use;
  const int h = k.h;
  const int4 pr = s.mode == 2 ? splat(s.pdc) : ld4(s.lft + 4 * k.by);
  const int4 v = vert(pr);  // zero but v.x for a DC prediction
  const int16_t* lv = s.lv[k.b];
  const int q4 = q_ac(q, lv[4] - 4 * v.y, 2);
  const int q8 = q_ac(q, lv[8] - 4 * v.z, 0);
  const int q12 = q_ac(q, lv[12] - 4 * v.w, 2);
  // zigzag slots 2, 3 (rasters 4, 8; h 0) and 9 (raster 12; h 1)
  int16_t* o = a.ac + m * 256 + 16 * k.b;
  if (h) {
    o[9] = (int16_t)q12;
  } else {
    o[2] = (int16_t)q4;
    o[3] = (int16_t)q8;
  }
  // the dequantised DC: element (by, bx) of the inverse Hadamard
  const int4 zi = ld4(s.zl0);
  int g = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 z = ld4(s.zl + 4 * i);
    g += pick4(sy, i) * (pick4(zi, i) + z.y * sx.y + z.z * sx.z + z.w * sx.w);
  }
  const int d0[4] = {dq_ldc(q, g), dq_ac(q, q4, 2), dq_ac(q, q8, 0),
                     dq_ac(q, q12, 2)};
  // columns 2h, 2h + 1: e[r] = d0_r + P[r][x], the column pass
  int rec[2][4];
#pragma unroll
  for (int xx = 0; xx < 2; ++xx) {
    int e[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) e[r] = d0[r] + s.P[k.b][4 * r + 2 * h + xx];
    const int4 c = column(e[0], e[1], e[2], e[3], pr);
    rec[xx][0] = c.x, rec[xx][1] = c.y, rec[xx][2] = c.z, rec[xx][3] = c.w;
  }
  // the reconstruction, where it is the intra one
  if (use) {
    if (d4) {
      int32_t* op = a.ry + m * 256 + 4 * k.by * 16 + 4 * k.bx + 2 * h;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        *reinterpret_cast<int2*>(op + 16 * y) = make_int2(rec[0][y],
                                                           rec[1][y]);
    } else {
      const size_t w = (size_t)a.C * 16;
      uint8_t* op = a.ry8 + (lane * 16 + 4 * k.by) * w + (size_t)col * 16 +
                    4 * k.bx + 2 * h;
#pragma unroll
      for (int y = 0; y < 4; ++y)
        *reinterpret_cast<uint16_t*>(op + y * w) =
            (uint16_t)(rec[0][y] | (rec[1][y] << 8));
    }
  } else {  // D4: the inter reconstruction stays
    const int4* iy = reinterpret_cast<const int4*>(a.iy) + m * 64;
    int4* oy = reinterpret_cast<int4*>(a.ry) + m * 64;
    oy[t] = iy[t];
    oy[t + 32] = iy[t + 32];
  }
  const uint32_t nzb = __ballot_sync(0xffffffffu, (h ? q12 : q4 | q8) != 0);
  if (a.i4 && t < 2) reinterpret_cast<int4*>(a.i4 + m * 16)[t] = splat(-1);
  if (t < 16) {  // the DC level of zigzag slot t
    const int zr = zz(t);
    a.dc[m * 16 + t] = (int16_t)((zr & 3) ? s.zl[zr] : s.zl0[zr >> 2]);
  }
  if (t == 0) {
    a.mode[m] = s.mode;
    a.cbp_l[m] = nzb != 0 || s.nzy;
    if (a.sad) a.sad[m] = s.sad;
    if (a.use) a.use[m] = use;
  }
}

// The Intra_16x16 candidate of a luma thread of the kI44 instance (warp
// 4): finish_luma's work on columns 2h, 2h + 1 of block k.b, its levels at
// 4, 8, 12 and the reconstruction rec[x][row], then, where it wins,
// finish_luma's D3 stores (`store16`).  finish_luma keeps its own copy,
// so that the D3 and D4 instances keep their code and registers: an edit
// to one of the twins goes into the other.
struct Luma16 {
  int q4, q8, q12;
  int rec[2][4];
};

__device__ __forceinline__ Luma16 luma16(const Slot& s, const Block& k,
                                         const Quant& q, int4 sy, int4 sx) {
  Luma16 o;
  const int h = k.h;
  const int4 pr = s.mode == 2 ? splat(s.pdc) : ld4(s.lft + 4 * k.by);
  const int4 v = vert(pr);  // zero but v.x for a DC prediction
  const int16_t* lv = s.lv[k.b];
  o.q4 = q_ac(q, lv[4] - 4 * v.y, 2);
  o.q8 = q_ac(q, lv[8] - 4 * v.z, 0);
  o.q12 = q_ac(q, lv[12] - 4 * v.w, 2);
  // the dequantised DC: element (by, bx) of the inverse Hadamard
  const int4 zi = ld4(s.zl0);
  int g = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int4 z = ld4(s.zl + 4 * i);
    g += pick4(sy, i) * (pick4(zi, i) + z.y * sx.y + z.z * sx.z + z.w * sx.w);
  }
  const int d0[4] = {dq_ldc(q, g), dq_ac(q, o.q4, 2), dq_ac(q, o.q8, 0),
                     dq_ac(q, o.q12, 2)};
  // columns 2h, 2h + 1: e[r] = d0_r + P[r][x], the column pass
#pragma unroll
  for (int xx = 0; xx < 2; ++xx) {
    int e[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) e[r] = d0[r] + s.P[k.b][4 * r + 2 * h + xx];
    const int4 c = column(e[0], e[1], e[2], e[3], pr);
    o.rec[xx][0] = c.x, o.rec[xx][1] = c.y, o.rec[xx][2] = c.z;
    o.rec[xx][3] = c.w;
  }
  return o;
}

// The level of zigzag slot t (< 16) of the MB's luma DC.
__device__ __forceinline__ int dc_level(const Slot& s, int t) {
  const int zr = zz(t);
  return (zr & 3) ? s.zl[zr] : s.zl0[zr >> 2];
}

__device__ __forceinline__ void store16(const Args& a, const Slot& s,
                                        const Block& k, size_t lane, int col,
                                        int t, const Luma16& o) {
  const size_t m = lane * a.C + col;
  const int h = k.h;
  // zigzag slots 2, 3 (rasters 4, 8; h 0) and 9 (raster 12; h 1)
  int16_t* ol = a.ac + m * 256 + 16 * k.b;
  if (h) {
    ol[9] = (int16_t)o.q12;
  } else {
    ol[2] = (int16_t)o.q4;
    ol[3] = (int16_t)o.q8;
  }
  const size_t w = (size_t)a.C * 16;
  uint8_t* op = a.ry8 + (lane * 16 + 4 * k.by) * w + (size_t)col * 16 +
                4 * k.bx + 2 * h;
#pragma unroll
  for (int y = 0; y < 4; ++y)
    *reinterpret_cast<uint16_t*>(op + y * w) =
        (uint16_t)(o.rec[0][y] | (o.rec[1][y] << 8));
  const uint32_t nzb =
      __ballot_sync(0xffffffffu, (h ? o.q12 : o.q4 | o.q8) != 0);
  if (t < 2) reinterpret_cast<int4*>(a.i4 + m * 16)[t] = splat(-1);
  if (t < 16) a.dc[m * 16 + t] = (int16_t)dc_level(s, t);
  if (t == 0) {
    a.mode[m] = s.mode;
    a.cbp_l[m] = nzb != 0 || s.nzy;
  }
}

// The chroma finish of column col (warp 5): thread t, column x = t & 3
// of block 16 + (t >> 2).
__device__ void finish_chroma(const Args& a, const Slot& s, const Block& k,
                              size_t lane, int col, int t, const Quant& q,
                              bool d4) {
  const size_t m = lane * a.C + col;
  const bool use = !d4 || s.use;
  const int x = k.h, p = k.plane - 1;
  const int4 pr = s.cmode == 0 ? splat(s.cdcp[2 * p + k.by])
                               : ld4(s.clft + 8 * p + 4 * k.by);
  const int4 v = vert(pr);  // zero but v.x for a DC prediction
  const int16_t* lv = s.lv[k.b];
  const int q4 = q_ac(q, lv[4] - 4 * v.y, 2);
  const int q8 = q_ac(q, lv[8] - 4 * v.z, 0);
  const int q12 = q_ac(q, lv[12] - 4 * v.w, 2);
  // zigzag slots 2, 3, 9 (rasters 4, 8, 12): threads x 0, 1, 2
  if (x < 3)
    a.cac[m * 120 + 60 * p + 15 * k.j + (x == 2 ? 8 : x + 1)] =
        (int16_t)(x == 0 ? q4 : x == 1 ? q8 : q12);
  // the dequantised DC: element (by, bx) of the inverse 2x2 Hadamard
  const int4 zc = ld4(s.zc + 4 * p);
  const int z00 = s.zc0[2 * p], z10 = s.zc0[2 * p + 1];
  const int sx = k.bx ? -1 : 1;
  const int g = dq_cdc(q, (z00 + sx * zc.y) + (k.by ? -1 : 1) *
                                                  (z10 + sx * zc.w));
  // column x: e[r] = d0_r + P[r][x], the column pass
  const int* pp = s.P[k.b] + x;
  const int4 c = column(g + pp[0], dq_ac(q, q4, 2) + pp[4],
                        dq_ac(q, q8, 0) + pp[8], dq_ac(q, q12, 2) + pp[12],
                        pr);
  if (use) {
    if (d4) {
      int32_t* op = (p ? a.rv : a.ru) + m * 64 + 4 * k.by * 8 + 4 * k.bx + x;
      op[0] = c.x, op[8] = c.y, op[16] = c.z, op[24] = c.w;
    } else {
      const size_t w = (size_t)a.C * 8;
      uint8_t* op = (p ? a.rv8 : a.ru8) + (lane * 8 + 4 * k.by) * w +
                    (size_t)col * 8 + 4 * k.bx + x;
      op[0] = (uint8_t)c.x, op[w] = (uint8_t)c.y, op[2 * w] = (uint8_t)c.z,
      op[3 * w] = (uint8_t)c.w;
    }
  } else {  // D4: the inter reconstruction stays
    const int4* ic = reinterpret_cast<const int4*>(t < 16 ? a.iu : a.iv);
    int4* oc = reinterpret_cast<int4*>(t < 16 ? a.ru : a.rv);
    oc[m * 16 + (t & 15)] = ic[m * 16 + (t & 15)];
  }
  // cbp: chroma AC (here or prep's), else chroma DC (x 0: raster j's)
  const uint32_t nzb = __ballot_sync(0xffffffffu, (q4 | q8 | q12) != 0);
  const int zj = (k.j & 1) ? pick4(zc, k.j) : k.j ? z10 : z00;
  const uint32_t dcb = __ballot_sync(0xffffffffu, x == 0 && zj != 0);
  if (x == 0) a.cdc[m * 8 + 4 * p + k.j] = (int16_t)zj;
  if (t == 0) {
    a.cmode[m] = s.cmode;
    a.cbp_c[m] = (nzb != 0 || s.nzc) ? 2 : dcb ? 1 : 0;
  }
}

// The end of a step: every warp of the block meets here once a step.
// Each warp role runs a loop of its own that reaches it C + 2 times (bar.sync
// 0 counts the block's warps wherever in the code they arrive), so that
// each role keeps only its own registers.
__device__ __forceinline__ void step_end() {
#ifdef __CUDA_ARCH__
  asm volatile("bar.sync 0;" ::: "memory");
#else
  __syncthreads();
#endif
}

// The slot after / before slot i of the ring.
__device__ __forceinline__ int next_slot(int i) {
  return i == kSlots - 1 ? 0 : i + 1;
}
__device__ __forceinline__ int prev_slot(int i) {
  return i == 0 ? kSlots - 1 : i - 1;
}

// The luma chain's loop (warp 0): at step c, column c - 1.
__device__ void luma_chain(const Args& a, Slot* ring, size_t lane, int t,
                           bool d4) {
  const Quant q = quantiser(a.qp);
  const int by = (t & 15) >> 2;  // the right-hand block of the lane's row
  const int4 sy = make_int4(h4(by, 0), h4(by, 1), h4(by, 2), h4(by, 3));
  const RowOf w = row_of(t & 3);
  int ir = 0, isad = 0;
  if (t < 16) ring[0].lft[t] = 0;  // read, never used, in column 0
  if (d4) {
    ir = a.iy[lane * a.C * 256 + 16 * (t & 15) + 15];
    isad = a.inter_sad[lane * a.C];
  }
  for (int c = 0, i = kSlots - 1; c < a.C + 2; ++c, i = next_slot(i)) {
    if (c >= 1 && c <= a.C)
      luma_column<false>(a, ring[i], ring[next_slot(i)], lane, c - 1, t, q,
                         d4, sy, w, ir, isad);
    step_end();
  }
}

// The chroma chain's loop (warp 1): at step c, column c - 1.
__device__ void chroma_chain(const Args& a, Slot* ring, size_t lane, int t,
                             bool d4) {
  const Quant q = quantiser(a.qpc);
  const RowOf w = row_of(t & 3);
  int crec = 0, ir = 0;
  if (t < 16) ring[0].clft[t] = 0;  // read, never used, in column 0
  for (int c = 0, i = kSlots - 1; c < a.C + 2; ++c, i = next_slot(i)) {
    if (c >= 1 && c <= a.C)
      chroma_column(a, ring[prev_slot(i)], ring[i], lane, c - 1, t, q, d4, w,
                    crec, ir);
    step_end();
  }
}

// The prep loops (warp 2 luma, warp 3 chroma): at step c, column c; the
// next column's source loaded meanwhile.
__device__ void prep_loop(const Args& a, Slot* ring, int16_t* stage,
                          size_t lane, int t, bool luma) {
  const Quant q = quantiser(luma ? a.qp : a.qpc);
  const Block k = block_of(luma, t);
  // a chroma thread's row r = k.h: its vertical butterfly's weights and
  // its positions' quantiser and dequantiser factors
  const int r = k.h;
  const int4 cr = r == 0   ? make_int4(1, 1, 1, 1)
                  : r == 1 ? make_int4(2, 1, -1, -2)
                  : r == 2 ? make_int4(1, -1, -1, 1)
                           : make_int4(1, -2, 2, -1);
  const int c1 = r & 1 ? 1 : 2, c2 = r & 1 ? 2 : 0;  // classes of 1, 3 / 2
  const int4 qm = make_int4(0, q.mf[c1], q.mf[c2], q.mf[c1]);
  const int4 qv = make_int4(0, q.vs[c1] * q.scale, q.vs[c2] * q.scale,
                            q.vs[c1] * q.scale);
  Next nx{};
  Raw raw{};
  prep_load(nx, raw, a, k, lane, 0);
  if (!a.src_u8)
#pragma unroll
    for (int y = 0; y < 4; ++y) nx.w[y] = pack4(raw.v[y]);
  for (int c = 0, i = 0; c < a.C + 2; ++c, i = next_slot(i)) {
    if (c < a.C) {
      const Next cur = nx;
      const bool more = c + 1 < a.C;
      if (more) prep_load(nx, raw, a, k, lane, c + 1);
      if (luma)
        prep_luma(a, ring[i], cur, k, lane, c, t, q);
      else
        prep_chroma(a, ring[i], stage, cur, k, lane, c, t, q, cr, qm, qv);
      if (more && !a.src_u8)
#pragma unroll
        for (int y = 0; y < 4; ++y) nx.w[y] = pack4(raw.v[y]);
    }
    step_end();
  }
}

// The finish loops (warp 4 luma, warp 5 chroma): at step c, column c - 2.
__device__ void finish_loop(const Args& a, Slot* ring, size_t lane, int t,
                            bool luma, bool d4) {
  const Quant q = quantiser(luma ? a.qp : a.qpc);
  const Block k = block_of(luma, t);
  // a luma thread's Hadamard signs h(by, i) and h(j, bx)
  const int4 sy = make_int4(h4(k.by, 0), h4(k.by, 1), h4(k.by, 2),
                            h4(k.by, 3));
  const int4 sx = make_int4(h4(0, k.bx), h4(1, k.bx), h4(2, k.bx),
                            h4(3, k.bx));
  for (int c = 0, i = kSlots - 2; c < a.C + 2; ++c, i = next_slot(i)) {
    if (c >= 2) {
      if (luma)
        finish_luma(a, ring[i], k, lane, c - 2, t, q, d4, sy, sx);
      else
        finish_chroma(a, ring[i], k, lane, c - 2, t, q, d4);
    }
    step_end();
  }
}

// -- the Intra_4x4 route (the kI44 instance) ---------------------------

// The trial's shared memory: the MB's samples as the trial reconstructs
// them (intra44_common.cuh's layout: row -1 and the corner stay zero,
// column -1 the left column), and the trial's results: its
// levels (raster block 4 by + bx x zigzag slot), its block modes (z-scan),
// SSD, rate (96 + the levels' `rate_bits`) and 4-bit cbp; and the second
// trial warp's part of the SSD, rate and cbp.
struct Trial {
  __align__(16) int pix[kI44Pix];
  __align__(16) int16_t coef[16][16];
  __align__(16) int16_t modes[16];
  int ssd, rate, cbp;
  int ssd_b, rate_b, cbp_b;
};

// The hand-off between the two trial warps after a level (named barrier
// 2): each one's blocks of the level are written before either reads
// them.
__device__ __forceinline__ void level_sync() { bar_wait(2, 64); }

// forward4x4's weights, row i of its matrix ((1, 1, 1, 1), (2, 1, -1, -2),
// (1, -1, -1, 1), (1, -2, 2, -1))
__device__ __forceinline__ int4 fwd_row(int i) {
  return i == 0   ? make_int4(1, 1, 1, 1)
         : i == 1 ? make_int4(2, 1, -1, -2)
         : i == 2 ? make_int4(1, -1, -1, 1)
                  : make_int4(1, -2, 2, -1);
}

// Output i of inverse4x4's butterfly of d0 .. d3 (a row or a column).
__device__ __forceinline__ int inv_out(int d0, int d1, int d2, int d3,
                                       int i) {
  const int e0 = d0 + d2, e1 = d0 - d2;
  const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
  return i == 0 ? e0 + e3 : i == 1 ? e1 + e2 : i == 2 ? e1 - e2 : e0 - e3;
}

// A trial lane's constants: its pixel p = t & 15, (x, y) = (p & 3, p >>
// 2), of every block (lanes 16-31 repeat 0-15); the first lanes of its row
// and of its column; forward4x4's weights of its x and y; the quantiser
// and dequantiser factors of its position's class; its level's zigzag
// slot; its neighbour's offset from a block's first sample (the block's
// sample (0, 0)) where the block's TR is real and where it is T3 repeated
// (`i44_neighbour` of blocks 6 and 3: the rule moves with the block but
// for TR); the forms (`i44_form`) of its pixel's tap words by its five
// modes, 2j + (t >> 4) (mode 8 twice on lanes 16-31; DC's unused).
struct Lane44 {
  int row, colm;
  int4 wx, wy;
  int mf, vs, slot;
  int nb_real, nb_repl;
  uint32_t tw[5];
};

__device__ __forceinline__ Lane44 lane44(const Args& a, int t,
                                         const Quant& q) {
  const int p = t & 15, c = pos_class(p);
  int slot = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) slot = zz(k) == p ? k : slot;
  Lane44 ln{t & ~3, t & ~12, fwd_row(p & 3), fwd_row(p >> 2), q.mf[c],
            q.vs[c] * q.scale, slot, i44_neighbour(6, t) - i44_at(8, 4),
            i44_neighbour(3, t) - i44_at(4, 4), {}};
#pragma unroll
  for (int j = 0; j < 5; ++j)
    ln.tw[j] = i44_form(a.taps[16 * min(2 * j + (t >> 4), 8) + p]);
  return ln;
}

// The four values of the lane's row (`stride` 1, lanes from `first`) or
// column (4) of the 4x4 block the lanes hold.
__device__ __forceinline__ int4 gather4(int v, int first, int stride) {
  return make_int4(__shfl_sync(0xffffffffu, v, first),
                   __shfl_sync(0xffffffffu, v, first + stride),
                   __shfl_sync(0xffffffffu, v, first + 2 * stride),
                   __shfl_sync(0xffffffffu, v, first + 3 * stride));
}

// One pass of forward4x4 (the lane's weights w) and of inverse4x4
// (output i) along a row or a column.
__device__ __forceinline__ int fwd_pass(int v, int first, int stride,
                                        int4 w) {
  const int4 g = gather4(v, first, stride);
  return w.x * g.x + w.y * g.y + w.z * g.z + w.w * g.w;
}

__device__ __forceinline__ int inv_pass(int v, int first, int stride,
                                        int i) {
  const int4 g = gather4(v, first, stride);
  return inv_out(g.x, g.y, g.z, g.w, i);
}

// One block step of the Intra_4x4 trial (kernels/intra44.py `encode_mb`):
// block bi of the MB in `tr`.  Lanes 0-12 read the 13 neighbours and
// pack each one's 2-tap mean and 3-tap filter beside it, every lane the
// block's L and T samples for DC; five passes of two modes (lanes 0-15
// modes 0, 2, 4, 6, 8, lanes 16-31 1, 3, 5, 7), each prediction one
// shuffle of a packed word by its tap word's form (kept in registers:
// every directional prediction is a neighbour, a mean or a filter of
// the ring of neighbours, `i44_form`); the passes' SADs two a
// word by one redux each; the first least available mode from keys in
// registers; its prediction from the lane (or the lane 16 above) that
// made it; the residual's forward4x4 by shuffles (rows, then columns),
// quant4x4 (intra), dequant, inverse4x4 (rows, then columns), clip; lanes
// 0-15 store the samples and levels, lane 0 the mode.  It adds the
// block's SSD and rate to the lane's, its cbp bit to `cbp`.
__device__ __forceinline__ void trial_block(const Slot& s, Trial& tr,
                                            int bi, bool l_mb, int t,
                                            const Quant& q, const Lane44& ln,
                                            int& ssd, int& rate, int& cbp) {
  const int p = t & 15, x = p & 3, y = p >> 2;
  const bool hi = t >= 16;
  const int bx = blk_x(bi), by = blk_y(bi);
  const int* pb = tr.pix + i44_at(4 * bx, 4 * by);
  const int nv = pb[tr_real(bi) ? ln.nb_real : ln.nb_repl];
  const int src = (s.ys[(4 * by + y) * 4 + bx] >> (8 * x)) & 255;
  const bool l_ok = bx > 0 || l_mb, t_ok = by > 0;
  const int dc = i44_dc_at(pb, l_ok, t_ok);
  const uint32_t fw = i44_filtered(nv, p);
  int pr[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) {
    const int tap = i44_pick(ln.tw[j], fw);  // every lane shuffles
    pr[j] = j == 1 && !hi ? dc : tap;        // mode 2: DC
  }
  const int best = i44_best(i44_sads(src, pr, t), l_ok, t_ok);
  int mine = pr[0];
#pragma unroll
  for (int j = 1; j < 5; ++j) mine = (best >> 1) == j ? pr[j] : mine;
  const int pred = __shfl_sync(0xffffffffu, mine, p + 16 * (best & 1));
  // forward4x4 of the residual, quant, dequant, inverse4x4, clip
  int w = fwd_pass(src - pred, ln.row, 1, ln.wx);
  w = fwd_pass(w, ln.colm, 4, ln.wy);
  const int z = quant(w, ln.mf, q.fq, q.qbits);
  int d = inv_pass(z * ln.vs, ln.row, 1, x);
  d = inv_pass(d, ln.colm, 4, y);
  const int rec = clip255(pred + ((d + 32) >> 6));
  if (t < 16) {
    tr.pix[i44_at(4 * bx + x, 4 * by + y)] = rec;
    tr.coef[4 * by + bx][ln.slot] = (int16_t)z;
  }
  if (t == 0) tr.modes[bi] = (int16_t)best;
  ssd += (rec - src) * (rec - src);
  rate += rate_bits(z);
  cbp |= __ballot_sync(0xffffffffu, z != 0) ? 1 << (bi >> 2) : 0;
}

// The Intra_4x4 trial of column col by trial warp kHalf (0: warp 0, 1:
// warp 5): the MB's 16 blocks by their 10 dependency levels
// (intra44_common.cuh) through the samples in shared memory, warp 0 each
// level's first block and warp 5 its second (where the level has
// two), a block step a level each.  After each level from 1 to 7 the two
// warps meet at named barrier 2 (`level_sync`: a block of levels 2-9
// reads blocks of the level before it, which the other warp may have
// made; warp 5's last block is on level 7).  Then the SSD, rate and
// cbp (warp 5's part through `Trial`, before its last hand-off),
// and warp 0 hands over to warp 4.
template <int kHalf>
__device__ __forceinline__ void trial_column(const Slot& s, Trial& tr,
                                             int col, int t, const Quant& q,
                                             const Lane44& ln) {
  const bool hi = t >= 16;
  if (kHalf == 0 && t < 16) tr.pix[i44_at(-1, t)] = s.lft[t];  // zeros in
                                                                // column 0
  int ssd = 0, rate = 0, cbp = 0;
  __syncwarp();
  // all 10 levels unrolled: constant neighbour offsets, and one level's
  // loads overlap the last one's chain
#pragma unroll
  for (int l = 0; l < kI44Levels; ++l) {
    const int bi = i44_level_block(l, kHalf);
    if (kHalf == 0 || bi != i44_level_block(l, 0))
      trial_block(s, tr, bi, col > 0, t, q, ln, ssd, rate, cbp);
    if (kHalf == 1 && l == 7) {  // its part, before its last hand-off
      ssd = (int)warp_sum(hi ? 0u : (unsigned)ssd);
      rate = (int)warp_sum(hi ? 0u : (unsigned)rate);
      if (t == 0) tr.ssd_b = ssd, tr.rate_b = rate, tr.cbp_b = cbp;
    }
    if (l >= 1 && l <= 7)
      level_sync();  // the level's blocks are written
    else
      __syncwarp();  // the level's samples are written
  }
  if (kHalf == 1) return;
  // at most 256 * 255^2 and 96 + 256 * 33: no int32 sum wraps
  ssd = (int)warp_sum(hi ? 0u : (unsigned)ssd);
  rate = (int)warp_sum(hi ? 0u : (unsigned)rate);
  if (t == 0)
    tr.ssd = ssd + tr.ssd_b, tr.rate = 96 + rate + tr.rate_b,
    tr.cbp = cbp | tr.cbp_b;
  bar_arrive(1, 64);  // to warp 4: the trial of this column is done
}

// The trial's loops of the kI44 instance: warp 0 (kHalf 0) and warp 5
// (kHalf 1), at step c column c - 1; warp 5 then runs the chroma finish
// of column c - 2 (D3's, warp 5's role in the instance without kI44),
// while warp 0 walks the last two levels alone.
template <int kHalf>
__device__ void trial_loop(const Args& a, Slot* ring, Trial& tr,
                           size_t lane, int t) {
  const Quant q = quantiser(a.qp), qc = quantiser(a.qpc);
  const Lane44 ln = lane44(a, t, q);
  const Block k = block_of(false, t);
  if (kHalf == 0)
    for (int i = t; i < kI44Pix; i += 32) tr.pix[i] = 0;
  __syncwarp();
  for (int c = 0, i = kSlots - 1; c < a.C + 2; ++c, i = next_slot(i)) {
    if (c >= 1 && c <= a.C)
      trial_column<kHalf>(ring[i], tr, c - 1, t, q, ln);
    if (kHalf == 1 && c >= 2)
      finish_chroma(a, ring[prev_slot(i)], k, lane, c - 2, t, qc, false);
    step_end();
  }
}

// The luma of column col in the kI44 instance (warp 4): the Intra_16x16
// candidate (the chain's choice, then finish's levels and reconstruction)
// with its SSD and rate (`_intra44_choice`: r16 = 8 + the DC and AC
// levels' `rate_bits`), in the shadow of the trial; then, the trial done,
// the choice J = 8 SSD + lam8 rate, Intra_16x16 on a tie, and every luma
// store of the winner; its right sample column is the next one's left.
// Every J stays within int32: 8 SSD <= 8 * 256 * 255^2 < 2^27, lam8 <=
// 55,705 and a rate below 6,000 (a level's `rate_bits` <= 27 here:
// |level| < 2^13), so lam8 rate < 2^29.
__device__ void luma44_column(const Args& a, Slot& s, Slot& next,
                              const Trial& tr, const Block& k, size_t lane,
                              int col, int t, const Quant& q, int4 csy,
                              const RowOf& w, int4 sy, int4 sx) {
  int ir = 0, isad = 0;
  luma_column<true>(a, s, next, lane, col, t, q, false, csy, w, ir, isad);
  __syncwarp();  // its mode, DC prediction and DC levels
  const Luma16 o = luma16(s, k, q, sy, sx);
  const int h = k.h;
  int e = 0, r = h ? rate_bits(o.q12) : rate_bits(o.q4) + rate_bits(o.q8);
#pragma unroll
  for (int yy = 0; yy < 4; ++yy) {
    const uint32_t src = s.ys[(4 * k.by + yy) * 4 + k.bx] >> (16 * h);
#pragma unroll
    for (int xx = 0; xx < 2; ++xx) {
      const int d = o.rec[xx][yy] - (int)((src >> (8 * xx)) & 255);
      e += d * d;
    }
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)  // rows 2h, 2h + 1, columns 1-3: prep's
    if (i & 3) r += rate_bits(s.lv[k.b][8 * h + i]);
  if (t < 16) r += rate_bits(dc_level(s, t));
  const int ssd16 = (int)warp_sum((unsigned)e);
  const int r16 = 8 + (int)warp_sum((unsigned)r);
  bar_wait(1, 64);  // the trial of this column is done
  const bool i4 =
      8 * tr.ssd + a.lam8 * tr.rate < 8 * ssd16 + a.lam8 * r16;
  const size_t m = lane * a.C + col;
  if (!i4) {
    store16(a, s, k, lane, col, t, o);
    if (k.bx == 3 && h == 1 && col + 1 < a.C)
#pragma unroll
      for (int yy = 0; yy < 4; ++yy) next.lft[4 * k.by + yy] = o.rec[1][yy];
    return;
  }
  // Intra_4x4: its levels (slot 0 too), block modes, recon; no DC levels
  reinterpret_cast<int4*>(a.ac + m * 256)[t] =
      reinterpret_cast<const int4*>(tr.coef)[t];
  if (t < 2)
    reinterpret_cast<int4*>(a.i4 + m * 16)[t] =
        reinterpret_cast<const int4*>(tr.modes)[t];
  if (t < 16) a.dc[m * 16 + t] = 0;
  const int y = t >> 1, x0 = 8 * (t & 1);
  const int* px = tr.pix + i44_at(x0, y);
  *reinterpret_cast<uint2*>(a.ry8 + (lane * 16 + y) * ((size_t)a.C * 16) +
                            (size_t)col * 16 + x0) =
      make_uint2(pack4(ld4(px)), pack4(ld4(px + 4)));
  if (t == 0) a.mode[m] = 4, a.cbp_l[m] = tr.cbp;
  if (t < 16 && col + 1 < a.C) next.lft[t] = tr.pix[i44_at(15, t)];
}

// The luma loop of the kI44 instance (warp 4): at step c, column c - 1.
__device__ void luma44_loop(const Args& a, Slot* ring, const Trial& tr,
                            size_t lane, int t) {
  const Quant q = quantiser(a.qp);
  const Block k = block_of(true, t);
  const int cby = (t & 15) >> 2;  // the chain's: its row's right block
  const int4 csy = make_int4(h4(cby, 0), h4(cby, 1), h4(cby, 2), h4(cby, 3));
  const RowOf w = row_of(t & 3);
  const int4 sy = make_int4(h4(k.by, 0), h4(k.by, 1), h4(k.by, 2),
                            h4(k.by, 3));
  const int4 sx = make_int4(h4(0, k.bx), h4(1, k.bx), h4(2, k.bx),
                            h4(3, k.bx));
  if (t < 16) ring[0].lft[t] = 0;  // column 0's left, which the trial reads
  for (int c = 0, i = kSlots - 1; c < a.C + 2; ++c, i = next_slot(i)) {
    if (c >= 1 && c <= a.C)
      luma44_column(a, ring[i], ring[next_slot(i)], tr, k, lane, c - 1, t, q,
                    csy, w, sy, sx);
    step_end();
  }
}

// Block b is lane b: its six warps walk the C columns in C + 2 steps.
// At 96 registers (ptxas) three blocks fit an SM: 272 lanes at 1080p x 4
// on 132 SMs run in one wave.  kI44 (the Intra_4x4 route): warps 0 and 5
// run the trial, warp 4 the luma of the same column, warp 5 then the
// chroma finish (see the note above); its launch bounds ask for three
// blocks an SM too (two were slower, 1.66 against 1.07 ms for the
// z-scan walk, 1080p x 4, H100).
template <bool kI44>
__global__ void __launch_bounds__(kThreads, kI44 ? 3 : 2)
    intra16_enc_kernel(Args a) {
  __shared__ Slot ring[kSlots];
  __shared__ __align__(16) int16_t stage[120];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  const size_t lane = blockIdx.x;
  if constexpr (kI44) {
    __shared__ Trial tr;
    switch (warp) {
      case kLuma: trial_loop<0>(a, ring, tr, lane, t); break;
      case kChroma: chroma_chain(a, ring, lane, t, false); break;
      case kPrepY: prep_loop(a, ring, stage, lane, t, true); break;
      case kPrepC: prep_loop(a, ring, stage, lane, t, false); break;
      case kFinY: luma44_loop(a, ring, tr, lane, t); break;
      default: trial_loop<1>(a, ring, tr, lane, t);  // kFinC
    }
  } else {
    const bool d4 = a.inter_sad != nullptr;
    switch (warp) {
      case kLuma: luma_chain(a, ring, lane, t, d4); break;
      case kChroma: chroma_chain(a, ring, lane, t, d4); break;
      case kPrepY: prep_loop(a, ring, stage, lane, t, true); break;
      case kPrepC: prep_loop(a, ring, stage, lane, t, false); break;
      case kFinY: finish_loop(a, ring, lane, t, true, d4); break;
      default: finish_loop(a, ring, lane, t, false, d4);
    }
  }
}

}  // namespace

#ifdef __CUDACC__  // the entries; tests/test_torch_intra_enc.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// D3: lanes = S * R MB rows of C MB columns; the source planes are
// uint8 (src_u8 1) or int32, raster; recon out as uint8 raster planes.
extern "C" int th264_intra16_encode_rows(
    const void* sy, const void* su, const void* sv, int src_u8,
    int32_t* mode, int32_t* cmode, int32_t* cbp_l, int32_t* cbp_c,
    int16_t* dc, int16_t* ac, int16_t* cdc, int16_t* cac, int16_t* i4,
    uint8_t* ry, uint8_t* ru, uint8_t* rv, int lanes, int C, int qp,
    int qpc, void* stream) {
  const Args a{sy, su, sv, src_u8, nullptr, nullptr, nullptr, nullptr,
               mode, cmode, cbp_l, cbp_c, nullptr, nullptr, dc, ac, cdc,
               cac, i4, ry, ru, rv, nullptr, nullptr, nullptr, lanes, C, qp,
               qpc};
  intra16_enc_kernel<false>
      <<<lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// D3 with the Intra_4x4 trial (`intra44`): the same operands (i4 given),
// then the tap words (kernels/intra44.py `tap_words`, 144 uint32) and
// lam8, kernels/iframe.py _LAMBDA8[qp].
extern "C" int th264_intra44_encode_rows(
    const void* sy, const void* su, const void* sv, int src_u8,
    int32_t* mode, int32_t* cmode, int32_t* cbp_l, int32_t* cbp_c,
    int16_t* dc, int16_t* ac, int16_t* cdc, int16_t* cac, int16_t* i4,
    uint8_t* ry, uint8_t* ru, uint8_t* rv, int lanes, int C, int qp,
    int qpc, const uint32_t* taps, int lam8, void* stream) {
  const Args a{sy, su, sv, src_u8, nullptr, nullptr, nullptr, nullptr,
               mode, cmode, cbp_l, cbp_c, nullptr, nullptr, dc, ac, cdc,
               cac, i4, ry, ru, rv, nullptr, nullptr, nullptr, lanes, C, qp,
               qpc, taps, lam8};
  intra16_enc_kernel<true><<<lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// D4: the same with the inter SAD [lanes, C] and the inter
// reconstruction (int32, MB layout); writes the choice (`use`), the
// intra SAD and the final reconstruction (int32, MB layout).
extern "C" int th264_intra16_in_p_rows(
    const void* sy, const void* su, const void* sv, int src_u8,
    const int32_t* inter_sad, const int32_t* iy, const int32_t* iu,
    const int32_t* iv, int32_t* mode, int32_t* cmode, int32_t* cbp_l,
    int32_t* cbp_c, int32_t* sad, uint8_t* use, int16_t* dc, int16_t* ac,
    int16_t* cdc, int16_t* cac, int32_t* ry, int32_t* ru, int32_t* rv,
    int lanes, int C, int qp, int qpc, void* stream) {
  const Args a{sy, su, sv, src_u8, inter_sad, iy, iu, iv, mode, cmode,
               cbp_l, cbp_c, sad, use, dc, ac, cdc, cac, nullptr, nullptr,
               nullptr, nullptr, ry, ru, rv, lanes, C, qp, qpc};
  intra16_enc_kernel<false>
      <<<lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
