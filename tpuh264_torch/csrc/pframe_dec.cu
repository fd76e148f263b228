// K10: the P decode's inter reconstruction -- the MV chain, motion
// compensation and the inter residuals -- a warp per MB; with the t8
// route also the 8x8 inverse transform of the MBs whose t8 is 1.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py
// `decode_pframe_rows_multi` (:1021) before its intra scan, not a
// pallas_call: the MV chain `comb` :1078, `_mc_all` :1091, `q_from_zz`
// :1118 with the luma dequant and inverse transforms, the 8x8 luma with
// t8 :1101-1110, and `chroma_res` :1139.  Its plain PyTorch version is
// `kernels/pframe.py` `_inter_decode_plain`.
//
// What it computes, exactly as the plain version, from the parsed
// symbols as MBSymbolsP holds them (int32 kind, mvd, refidx and cbps,
// int16 levels):
//  * the MV chain along each MB row, mv_c = g_c * (mv_{c-1} + mvd_c) with
//    g_c = 1 for an inter MB (0 for skip and intra: their motion is 0);
//  * motion compensation from reference refidx (reference 0 where refidx
//    is outside 1 .. N-1, as `_mc_all`'s selection leaves it): luma the
//    rounded mean of the fraction's two half-pel components, chroma the
//    eighth-pel bilinear, at indices clamped into the planes;
//  * luma: the zigzag levels back to raster, the 8x8 groups outside
//    cbp_luma (0 for a skip) dropped, dequantised, inverse 4x4, (+ 32) >>
//    6, added to the prediction and clipped; chroma: the DC levels through
//    the 2x2 Hadamard and dequant where cbp_chroma >= 1, the AC levels
//    where it is 2 (0 for a skip), the inverse transform likewise;
//  * the t8 route (`pframe_decode_t8_kernel`; config 3's CABAC + 8x8
//    sessions): where symbols.t8 is 1, the luma is idct8_add(pred,
//    dequant8x8(inverse_zigzag8(levels))) of the four 8x8 blocks, block k
//    / 4's 64 zigzag levels in rows k of the [16, 16] levels, without the
//    cbp mask and whatever the MB's kind, as the plain version does; all
//    32 lanes take it (`luma8`: lane l a coefficient column, then a
//    column of samples, of block l >> 3, one transpose through shared
//    memory), and the chroma lanes go on as without t8.
// Every MB is reconstructed so, intra MBs too (their motion is 0): K5
// (`_intra_recon_scan`) takes this int32 [S,R,C,16,16], [S,R,C,8,8] x 2
// as `other` and replaces the intra MBs.  It writes (mvx, mvy) [S,R,C],
// zero for intra and skip MBs, for the deblock.
//
// What bounds it on the H100: bytes, as many as the data asks for.  An
// MB reads from its reference the half-pel planes its quarter-pel
// fraction needs (G alone for a whole-pel vector, at most two planes), a
// 16x16 byte window each, and two 8x8 byte chroma windows, with 792
// bytes of symbols, and writes 1,544 bytes (int32 reconstruction and
// motion): at most 2,976 bytes a MB, 97 MB or 0.029 ms at 1080p x 4.  Its
// arithmetic is small.  The first design (d893870) ran a block of 8 warps
// a MB row behind a block barrier every 32 columns: 272 blocks at 1080p
// x 4, two or three rows an SM, each warp's MBs one after another.
//
// Design: a warp per MB over the whole grid (kWarps MBs a block, about
// 4,080 blocks at 1080p x 4), no block barrier.
//  * The MV chain by look-back: the warp reads the kinds of the 32
//    columns ending at its own (a lane a column, one coalesced load),
//    finds the last reset (a column that is not inter, or left of the
//    row) by a ballot and sums the mvds after it (__reduce_add_sync); with
//    no reset among the 32 it goes on 32 columns further left.  Exact for
//    any number of columns: the sum restarts where the plain version's
//    running reset index does.
//  * MC: all 32 lanes, the luma 8 samples a lane (row lane / 2), the
//    chroma 4 (plane lane / 16), straight from K11's byte planes: a
//    component's 8 bytes from the two or three aligned words that hold
//    them, funnel-shifted into place and averaged four bytes at a time; a
//    window inside the plane (every MB whose vector stays within the pad)
//    takes no clamp, one that touches the border clamps byte by byte.
//    The prediction goes to shared memory as bytes.
//  * The residuals: lanes 0-15 a luma 4x4 block each, their levels two
//    16-byte loads, lanes 16-23 a chroma block each, the chroma AC
//    levels staged through shared memory by 16-byte loads; the int32
//    reconstruction leaves as 16-byte stores, a block row each.
//  * The t8 route is a kernel of its own, so that the route without t8
//    keeps its code, registers and occupancy.  Its MB's loads that need
//    no vector go out at once when the warp starts: its luma, chroma AC
//    and DC levels by cp.async straight into shared memory (48 16-byte
//    copies, no register held while they fly), its fields and t8 flag,
//    and the look-back's kinds and mvds together (the route without t8
//    reads the mvds after the ballot); so the MB waits on two rounds of
//    loads, these and MC's, not on five in a chain (look-back kinds,
//    mvds, fields, MC, then the flag and the 8x8 levels after MC).  Held
//    to 32 registers (__launch_bounds__(256, 8)), 64 warps an SM: config
//    3's 8,160 MBs in one wave, as the route without t8 (the first t8
//    route, 40 registers and 48 warps, took 1.29 waves).  `luma8` takes
//    each lane's eight levels straight from shared memory by an index
//    word (kZz8Col) and its scales by class (`cls8_row`): a constant
//    load at a lane's own index is serialised across the warp's
//    addresses, and the first route made three a coefficient.
// Where trouble is likely: negative shifts and masks (mv >> 2, & 3, >> 3,
// & 7) stay int arithmetic, as torch's; the planes are uint8 with rows
// 16-byte aligned, `lp` / `cpitch` bytes apart (the wrapper raises on
// another layout), and no word is read past a row's pitch (an inside
// window's last word starts before Wp <= lp); the levels are 16-byte
// aligned (the wrapper clones a level array that is not).  Each symbol
// field is read with its own MB stride: the GOP decode's record
// views (MB fields 9 ints apart, level slots 400 int16 apart) go as they
// lie, with no operand copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inter_common.cuh"  // dequant, inverse transforms, MC

namespace {

constexpr int kWarps = 8;     // MBs a block, a warp each
constexpr int kMaxRefs = 16;  // H.264's most references
constexpr unsigned kFull = 0xffffffffu;

struct DecArgs {
  const int32_t *kind, *mvdx, *mvdy, *refidx, *cbp_l, *cbp_c;  // [S,R,C]
  const int16_t *luma_ac, *chroma_dc, *chroma_ac;  // [.,16,16] [.,2,4] [.,2,4,15]
  const uint8_t *pl[kMaxRefs];                 // half-pel planes [4,S,Hp,lp]
  const uint8_t *pu[kMaxRefs], *pv[kMaxRefs];  // chroma [S, Hcp, cpitch]
  const int32_t* t8;  // [S,R,C] 1: the 8x8 transform (null: no t8 route)
  int32_t *ry, *ru, *rv;                       // [S,R,C,16,16], [.,8,8] x 2
  int32_t *mvx, *mvy;                          // [S, R, C]
  int S, R, C, N, Hp, Wp, Hcp, Wcp, pe, cp, qp, qpc;
  int lp, cpitch;  // the planes' row pitches, bytes
  int st8;         // t8's MB stride
  // each field's MB stride in elements (the record views' 9 and 400, or
  // a contiguous field's own size)
  int sk, smx, smy, sri, scl, scc, sla, scd, sca;
};

constexpr int kPtrs = 9 + 3 * kMaxRefs + 1 + 5;  // 63
constexpr int kInts = 24;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k10_launch` builds them.
inline DecArgs dec_args(void* const* p, const int* n) {
  DecArgs a;
  auto in = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto lev = [p](int i) { return static_cast<const int16_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  a.kind = in(0), a.mvdx = in(1), a.mvdy = in(2), a.refidx = in(3);
  a.cbp_l = in(4), a.cbp_c = in(5);
  a.luma_ac = lev(6), a.chroma_dc = lev(7), a.chroma_ac = lev(8);
  auto pln = [p](int i) { return static_cast<const uint8_t*>(p[i]); };
  for (int k = 0; k < kMaxRefs; ++k) {
    a.pl[k] = pln(9 + k);
    a.pu[k] = pln(9 + kMaxRefs + k);
    a.pv[k] = pln(9 + 2 * kMaxRefs + k);
  }
  a.t8 = in(9 + 3 * kMaxRefs);
  const int o = 10 + 3 * kMaxRefs;
  a.ry = out(o), a.ru = out(o + 1), a.rv = out(o + 2);
  a.mvx = out(o + 3), a.mvy = out(o + 4);
  a.S = n[0], a.R = n[1], a.C = n[2], a.N = n[3], a.Hp = n[4], a.Wp = n[5];
  a.Hcp = n[6], a.Wcp = n[7], a.pe = n[8], a.cp = n[9], a.qp = n[10];
  a.qpc = n[11], a.lp = n[12], a.cpitch = n[13], a.st8 = n[14];
  a.sk = n[15], a.smx = n[16], a.smy = n[17], a.sri = n[18], a.scl = n[19];
  a.scc = n[20], a.sla = n[21], a.scd = n[22], a.sca = n[23];
  return a;
}

// A warp's shared memory: its MB's prediction as bytes (luma 4 words a
// row, chroma 2) and its chroma AC levels.
struct WarpMem {
  uint32_t pred[64], pu[16], pv[16];
  alignas(16) int16_t cac[120];
};
// The t8 route's: the prediction, the MB's levels as they lie in the
// symbols (luma [16, 16], chroma DC [2, 4], AC [2, 4, 15]), copied in by
// cp.async, and the 8x8 blocks' staging (the dequantised coefficients,
// the transposes, then the recon).
struct WarpMemT8 {
  uint32_t pred[64], pu[16], pv[16];
  alignas(16) int16_t lev[256];
  alignas(16) int16_t cdc[8];
  alignas(16) int16_t cac[120];
  alignas(16) int st[256];
};

// The motion of MB column c of the row whose first MB is `row0`: the sum
// of the mvds over the run of inter MBs that ends at c (0 where c is not
// inter), every lane the same.  Lane l looks at column end - 31 + l.
__device__ __forceinline__ int2 mv_lookback(const DecArgs& a, size_t row0,
                                            int c, int lane) {
  int vx = 0, vy = 0;
  for (int end = c;; end -= 32) {
    const int cc = end - 31 + lane;
    const bool inter = cc >= 0 && a.kind[(row0 + cc) * a.sk] == 1;
    const unsigned resets = __ballot_sync(kFull, !inter);
    const int last = resets ? 31 - __clz((int)resets) : -1;  // the last reset
    const bool run = lane > last;  // after it: the run that reaches c
    vx += (int)__reduce_add_sync(kFull, run ? (unsigned)a.mvdx[(row0 + cc) * a.smx] : 0u);
    vy += (int)__reduce_add_sync(kFull, run ? (unsigned)a.mvdy[(row0 + cc) * a.smy] : 0u);
    if (resets) return make_int2(vx, vy);
  }
}

// `mv_lookback` with the kinds and the mvds of the 32 columns loaded
// together, before the ballot (the t8 route's: no load waits on another)
__device__ __forceinline__ int2 mv_lookback_ahead(const DecArgs& a,
                                                  size_t row0, int c,
                                                  int lane) {
  int vx = 0, vy = 0;
  for (int end = c;; end -= 32) {
    const int cc = end - 31 + lane;
    int kind = -1, dx = 0, dy = 0;
    if (cc >= 0) {
      const size_t mb = row0 + cc;
      kind = a.kind[mb * a.sk], dx = a.mvdx[mb * a.smx];
      dy = a.mvdy[mb * a.smy];
    }
    const unsigned resets = __ballot_sync(kFull, kind != 1);
    const int last = resets ? 31 - __clz((int)resets) : -1;  // the last reset
    const bool run = lane > last;  // after it: the run that reaches c
    vx += (int)__reduce_add_sync(kFull, run ? (unsigned)dx : 0u);
    vy += (int)__reduce_add_sync(kFull, run ? (unsigned)dy : 0u);
    if (resets) return make_int2(vx, vy);
  }
}

// 8 samples of row y of byte plane p (hp x wp, rows lp bytes apart)
// from column x, as bytes: `inside` (the row's 8 lie in the plane) from
// the two or three aligned words that hold them, else clamped one by one.
__device__ __forceinline__ uint2 row8(const uint8_t* p, int y, int x, int hp,
                                      int wp, int lp, bool inside) {
  if (inside) {
    const int off = x & 3;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(
        p + (size_t)y * lp + x - off);
    const uint32_t w0 = w[0], w1 = w[1], w2 = off ? w[2] : 0u;
    return make_uint2(__funnelshift_r(w0, w1, 8 * off),
                      __funnelshift_r(w1, w2, 8 * off));
  }
  int v[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) v[j] = at(p, y, x + j, hp, wp, lp);
  return make_uint2(pack_bytes(v[0], v[1], v[2], v[3]),
                    pack_bytes(v[4], v[5], v[6], v[7]));
}

// The lane's 8 luma prediction samples (MB row `row`, columns col ..
// col + 7) from stream s's G plane `g` (the others lstride on) at the
// integer origin (y0, x0) = MB origin + (mv >> 2) + pe and fraction f =
// (mvy & 3) * 4 + (mvx & 3), as bytes: the rounded mean of the
// fraction's two components, four bytes at a time; `inside` when the
// 17x17 reach lies in the plane.
__device__ __forceinline__ uint2 mc_luma8(const uint8_t* g, size_t lstride,
                                          int hp, int wp, int lp, int y0,
                                          int x0, int f, int row, int col,
                                          bool inside) {
  const int c1 = kQpel[f][0], c2 = kQpel[f][1];
  const uint2 a = row8(g + kCompPl[c1] * lstride, y0 + kCompDy[c1] + row,
                       x0 + kCompDx[c1] + col, hp, wp, lp, inside);
  if (c1 == c2) return a;  // one component: (a + a + 1) >> 1 = a
  const uint2 b = row8(g + kCompPl[c2] * lstride, y0 + kCompDy[c2] + row,
                       x0 + kCompDx[c2] + col, hp, wp, lp, inside);
  return make_uint2(avg4(a.x, b.x), avg4(a.y, b.y));
}

// The luma of a t8 MB (the plain version's rec8: idct8_add(pred,
// dequant8x8(inverse_zigzag8(levels))) of the four 8x8 blocks, no cbp
// mask), all 32 lanes: lane l takes coefficient column v = l & 7 of 8x8
// block b = l >> 3, its eight levels gathered from `lev` (the MB's
// [16, 16] levels in shared memory: block b's 64 zigzag levels in rows 4 b
// .. 4 b + 3; kZz8Col gives their indices) and dequantised, inverts it
// along u (lane: column v), then through `st` along v (lane: column x of
// the block), adds the prediction and clips; the MB's recon leaves
// through `st` as 16-byte stores.
__device__ __forceinline__ void luma8(const DecArgs& a, const uint32_t* pred,
                                      const int16_t* lev, int* st, size_t m,
                                      int lane) {
  const int b = lane >> 3, i = lane & 7, y8 = 8 * (b >> 1), xw = 2 * (b & 1);
  int* const sb = st + 64 * b;
  const int m6 = a.qp % 6;
  int x[8];  // coefficients [u][v = i]
  {
    const uint64_t zc = kZz8Col[i];
    const unsigned cw = cls8_row(i);  // cls8(u, i) at nibble u & 3
    int sc[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sc[j] = kV8[m6][(cw >> (4 * j)) & 15];
#pragma unroll
    for (int u = 0; u < 8; ++u)
      x[u] = dq8(lev[64 * b + (int)((zc >> (8 * u)) & 63)], sc[u & 3], a.qp);
  }
  inv8(x);  // [v = i][x]
#pragma unroll
  for (int k = 0; k < 8; ++k) sb[8 * i + k] = x[k];
  __syncwarp();
#pragma unroll
  for (int v = 0; v < 8; ++v) x[v] = sb[8 * v + i];
  __syncwarp();
  inv8(x);  // column i of the block's residual, rows y
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const int o = 4 * (y8 + y) + xw + (i >> 2);
    st[16 * (y8 + y) + 4 * xw + i] =
        clip255(byte_of(pred[o], i & 3) + ((x[y] + 32) >> 6));
  }
  __syncwarp();
  int4* const out = reinterpret_cast<int4*>(a.ry + m * 256);
  out[lane] = reinterpret_cast<const int4*>(st)[lane];
  out[lane + 32] = reinterpret_cast<const int4*>(st)[lane + 32];
}

// The routes without t8 (RTC, the default config).
__global__ void __launch_bounds__(32 * kWarps)
    pframe_decode_kernel(const __grid_constant__ DecArgs a) {
  __shared__ WarpMem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rc = a.R * a.C, mbs = a.S * rc;
  const int mi = blockIdx.x * kWarps + warp;
  if (mi >= mbs) return;  // the whole warp: no block barrier follows
  WarpMem& w = smem[warp];
  const size_t m = mi;
  const int s = mi / rc, r = (mi % rc) / a.C, c = mi % a.C;
  const int2 mv = mv_lookback(a, m - c, c, lane);
  const int mvx = mv.x, mvy = mv.y;
  if (lane == 0) a.mvx[m] = mvx, a.mvy[m] = mvy;

  const int kind = a.kind[m * a.sk], ri = a.refidx[m * a.sri];
  const int ref = ri >= 1 && ri < a.N ? ri : 0;
  const bool skip = kind == 0;
  const int cbp_l = skip ? 0 : a.cbp_l[m * a.scl];
  const int cbp_c = skip ? 0 : a.cbp_c[m * a.scc];
  // the chroma AC levels into shared memory, 16 bytes a lane
  if (lane < 15)
    reinterpret_cast<int4*>(w.cac)[lane] =
        reinterpret_cast<const int4*>(a.chroma_ac + m * a.sca)[lane];
  {
    const int row = lane >> 1, col = (lane & 1) * 8;
    const int y0 = 16 * r + (mvy >> 2) + a.pe, x0 = 16 * c + (mvx >> 2) + a.pe;
    const bool inside = y0 >= 0 && x0 >= 0 && y0 + 17 <= a.Hp && x0 + 17 <= a.Wp;
    const uint2 p = mc_luma8(a.pl[ref] + (size_t)s * a.Hp * a.lp,
                             (size_t)a.S * a.Hp * a.lp, a.Hp, a.Wp, a.lp, y0,
                             x0, (mvy & 3) * 4 + (mvx & 3), row, col, inside);
    w.pred[2 * lane] = p.x, w.pred[2 * lane + 1] = p.y;
    const int y8 = 8 * r + (mvy >> 3) + a.cp, x8 = 8 * c + (mvx >> 3) + a.cp;
    const bool cin = y8 >= 0 && x8 >= 0 && y8 + 9 <= a.Hcp && x8 + 9 <= a.Wcp;
    const uint8_t* cref =
        (lane >> 4 ? a.pv : a.pu)[ref] + (size_t)s * a.Hcp * a.cpitch;
    (lane >> 4 ? w.pv : w.pu)[lane & 15] =
        mc_chroma4(cref, a.Hcp, a.Wcp, a.cpitch, y8, x8, mvx & 7, mvy & 7,
                   (lane & 15) >> 1, (lane & 1) * 4, cin);
  }
  __syncwarp();

  const bool luma = lane < 16, chroma = lane >= 16 && lane < 24;
  if (!luma && !chroma) return;
  const int cl = lane - 16, cpl = cl >> 2, cb = cl & 3;
  const int by = luma ? lane >> 2 : cb >> 1, bx = luma ? lane & 3 : cb & 1;
  const int n = luma ? 16 : 8;
  const Quant Q = quantiser_inter(luma ? a.qp : a.qpc);
  int d[16];
  if (luma) {
    const bool coded = (cbp_l >> (((by >> 1) << 1) | (bx >> 1))) & 1;
    const int4* lp = reinterpret_cast<const int4*>(a.luma_ac + m * a.sla + 16 * lane);
    const int4 h0 = lp[0], h1 = lp[1];
    const int words[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int lv = (int)(int16_t)(words[k >> 1] >> (16 * (k & 1)));
      const int i = zz(k);
      d[i] = coded ? dq_ac(Q, lv, pos_class(i)) : 0;
    }
  } else {
    const int16_t* dc = a.chroma_dc + m * a.scd + 4 * cpl;
    const int lvl[4] = {dc[0], dc[1], dc[2], dc[3]};
    d[0] = cbp_c >= 1 ? dq_cdc(Q, had2(lvl, cb)) : 0;
    const int16_t* lv = w.cac + 60 * cpl + 15 * cb;
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      const int i = zz(k);
      d[i] = cbp_c == 2 ? dq_ac(Q, lv[k - 1], pos_class(i)) : 0;
    }
  }
  const uint32_t* pp = luma ? w.pred : cpl ? w.pv : w.pu;
  const int wpr = luma ? 4 : 2;  // prediction words a row
  uint32_t pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pw[i] = pp[(4 * by + i) * wpr + bx];
  inv4_add(d, pw);
  int32_t* o = (luma ? a.ry : cpl ? a.rv : a.ru) + m * n * n + 4 * bx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<int4*>(o + (4 * by + i) * n) =
        make_int4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
}

// The t8 route (config 3's CABAC + 8x8 sessions): the route above, with
// a MB whose t8 is 1 through `luma8`, and every load that needs no
// vector issued when the warp starts (the note at the top).
__global__ void __launch_bounds__(32 * kWarps, 8)
    pframe_decode_t8_kernel(const __grid_constant__ DecArgs a) {
  __shared__ WarpMemT8 smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rc = a.R * a.C, mbs = a.S * rc;
  const int mi = blockIdx.x * kWarps + warp;
  if (mi >= mbs) return;  // the whole warp: no block barrier follows
  WarpMemT8& w = smem[warp];
  const size_t m = mi;
  const int s = mi / rc, r = (mi % rc) / a.C, c = mi % a.C;
  // the levels into shared memory, a 16-byte copy a lane: luma (32),
  // chroma AC (15), chroma DC (1)
  cp_async16(reinterpret_cast<int4*>(w.lev) + lane,
             reinterpret_cast<const int4*>(a.luma_ac + m * a.sla) + lane);
  if (lane < 15)
    cp_async16(reinterpret_cast<int4*>(w.cac) + lane,
               reinterpret_cast<const int4*>(a.chroma_ac + m * a.sca) + lane);
  else if (lane == 15)
    cp_async16(w.cdc, a.chroma_dc + m * a.scd);
  cp_async_commit();
  const int kind = a.kind[m * a.sk], ri = a.refidx[m * a.sri];
  const bool t8mb = a.t8[m * a.st8] == 1;  // its luma through the 8x8 inverse
  const int cbp_l0 = a.cbp_l[m * a.scl], cbp_c0 = a.cbp_c[m * a.scc];
  const int2 mv = mv_lookback_ahead(a, m - c, c, lane);
  const int mvx = mv.x, mvy = mv.y;
  if (lane == 0) a.mvx[m] = mvx, a.mvy[m] = mvy;
  const int ref = ri >= 1 && ri < a.N ? ri : 0;
  {
    const int row = lane >> 1, col = (lane & 1) * 8;
    const int y0 = 16 * r + (mvy >> 2) + a.pe, x0 = 16 * c + (mvx >> 2) + a.pe;
    const bool inside = y0 >= 0 && x0 >= 0 && y0 + 17 <= a.Hp && x0 + 17 <= a.Wp;
    const uint2 p = mc_luma8(a.pl[ref] + (size_t)s * a.Hp * a.lp,
                             (size_t)a.S * a.Hp * a.lp, a.Hp, a.Wp, a.lp, y0,
                             x0, (mvy & 3) * 4 + (mvx & 3), row, col, inside);
    w.pred[2 * lane] = p.x, w.pred[2 * lane + 1] = p.y;
    const int y8 = 8 * r + (mvy >> 3) + a.cp, x8 = 8 * c + (mvx >> 3) + a.cp;
    const bool cin = y8 >= 0 && x8 >= 0 && y8 + 9 <= a.Hcp && x8 + 9 <= a.Wcp;
    const uint8_t* cref =
        (lane >> 4 ? a.pv : a.pu)[ref] + (size_t)s * a.Hcp * a.cpitch;
    (lane >> 4 ? w.pv : w.pu)[lane & 15] =
        mc_chroma4(cref, a.Hcp, a.Wcp, a.cpitch, y8, x8, mvx & 7, mvy & 7,
                   (lane & 15) >> 1, (lane & 1) * 4, cin);
  }
  cp_async_wait<0>();
  __syncwarp();  // the prediction and every lane's levels

  if (t8mb) luma8(a, w.pred, w.lev, w.st, m, lane);
  const bool luma = lane < 16 && !t8mb, chroma = lane >= 16 && lane < 24;
  if (!luma && !chroma) return;
  const bool skip = kind == 0;
  const int cbp_l = skip ? 0 : cbp_l0, cbp_c = skip ? 0 : cbp_c0;
  const int cl = lane - 16, cpl = cl >> 2, cb = cl & 3;
  const int by = luma ? lane >> 2 : cb >> 1, bx = luma ? lane & 3 : cb & 1;
  const int n = luma ? 16 : 8;
  const Quant Q = quantiser_inter(luma ? a.qp : a.qpc);
  int d[16];
  if (luma) {
    const bool coded = (cbp_l >> (((by >> 1) << 1) | (bx >> 1))) & 1;
    const int4* lp = reinterpret_cast<const int4*>(w.lev + 16 * lane);
    const int4 h0 = lp[0], h1 = lp[1];
    const int words[8] = {h0.x, h0.y, h0.z, h0.w, h1.x, h1.y, h1.z, h1.w};
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      const int lv = (int)(int16_t)(words[k >> 1] >> (16 * (k & 1)));
      const int i = zz(k);
      d[i] = coded ? dq_ac(Q, lv, pos_class(i)) : 0;
    }
  } else {
    const int16_t* dc = w.cdc + 4 * cpl;
    const int lvl[4] = {dc[0], dc[1], dc[2], dc[3]};
    d[0] = cbp_c >= 1 ? dq_cdc(Q, had2(lvl, cb)) : 0;
    const int16_t* lv = w.cac + 60 * cpl + 15 * cb;
#pragma unroll
    for (int k = 1; k < 16; ++k) {
      const int i = zz(k);
      d[i] = cbp_c == 2 ? dq_ac(Q, lv[k - 1], pos_class(i)) : 0;
    }
  }
  const uint32_t* pp = luma ? w.pred : cpl ? w.pv : w.pu;
  const int wpr = luma ? 4 : 2;  // prediction words a row
  uint32_t pw[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) pw[i] = pp[(4 * by + i) * wpr + bx];
  inv4_add(d, pw);
  int32_t* o = (luma ? a.ry : cpl ? a.rv : a.ru) + m * n * n + 4 * bx;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    *reinterpret_cast<int4*>(o + (4 * by + i) * n) =
        make_int4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_pframe_kernel.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `dec_args`' order (host
// arrays); one warp a MB of the S * R * C.
extern "C" int th264_pframe_decode(void* const* p, const int* n,
                                   void* stream) {
  const DecArgs a = dec_args(p, n);
  const int mbs = a.S * a.R * a.C;
  const int blocks = (mbs + kWarps - 1) / kWarps;
  if (a.t8)
    pframe_decode_t8_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(
        a);
  else
    pframe_decode_kernel<<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The warps an SM of each route that can be resident at once, out[0]
// without t8, out[1] the t8 route (the runtime's occupancy of their
// launches); returns the CUDA error.
extern "C" int th264_pframe_decode_resident(int* out) {
  int b[2];
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b[0], pframe_decode_kernel, 32 * kWarps, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b[1], pframe_decode_t8_kernel, 32 * kWarps, 0);
  out[0] = b[0] * kWarps, out[1] = b[1] * kWarps;
  return (int)e;
}

#endif  // __CUDACC__
