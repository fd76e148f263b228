// K10: the P decode's inter reconstruction -- the MV chain, motion
// compensation and the inter residuals -- a block per MB row.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py
// `decode_pframe_rows_multi` (:1021) before its intra scan, not a
// pallas_call: the MV chain `comb` :1078, `_mc_all` :1091, `q_from_zz`
// :1118 with the luma dequant and inverse transforms, and `chroma_res`
// :1139.  Its plain PyTorch version is `kernels/pframe.py`
// `_inter_decode_plain` (called with t8 False).
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
//    where it is 2 (0 for a skip), the inverse transform likewise.
// Every MB is reconstructed so, intra MBs too (their motion is 0): K5
// (`_intra_recon_scan`) takes this int32 [S,R,C,16,16], [S,R,C,8,8] x 2
// as `other` and replaces the intra MBs.  It writes (mvx, mvy) [S,R,C],
// zero for intra and skip MBs, for the deblock.
//
// What bounds it on the H100: bytes, as many as the data asks for.  An
// MB reads from its reference the half-pel planes its quarter-pel
// fraction needs (G alone for a whole-pel vector, at most two planes), a
// 16x16 int32 window each, and two 8x8 int32 chroma windows, with 792
// bytes of symbols, and writes 1,544 bytes (int32 reconstruction and
// motion): at most 4.9 KB a MB, 160 MB or 0.048 ms at 1080p x 4.  Its
// arithmetic is small.
//
// Design, simple and right first: a block of kWarps warps per MB row
// (stream s, row r).  The row's columns go 32 at a time: warp 0 runs the
// chain over the 32 columns as a segmented inclusive scan by shuffles
// (each column a pair (reset, sum); an inter MB continues its left
// neighbour's sum, any other resets it to 0), carrying the last column's
// vector into the next 32; after a block barrier every warp takes every
// kWarps-th MB of them: the prediction into its shared memory, then
// lanes 0-15 a luma 4x4 block each and lanes 16-23 a chroma block each.
// Where trouble is likely: negative shifts and masks (mv >> 2, & 3, >> 3,
// & 7) stay int arithmetic, as torch's; every load is a scalar one (the
// half-pel planes' rows are not 16-byte aligned); the chain restarts at
// every non-inter MB, as the plain version's running reset index does.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inter_common.cuh"  // dequant, inverse transforms, MC

namespace {

constexpr int kWarps = 8;  // a block's warps: MBs reconstructed at once
constexpr int kMaxRefs = 16;  // H.264's most references

struct DecArgs {
  const int32_t *kind, *mvdx, *mvdy, *refidx, *cbp_l, *cbp_c;  // [S,R,C]
  const int16_t *luma_ac, *chroma_dc, *chroma_ac;  // [.,16,16] [.,2,4] [.,2,4,15]
  const int32_t *pl[kMaxRefs];                 // half-pel planes [4,S,Hp,Wp]
  const int32_t *pu[kMaxRefs], *pv[kMaxRefs];  // chroma [S, Hcp, Wcp]
  int32_t *ry, *ru, *rv;                       // [S,R,C,16,16], [.,8,8] x 2
  int32_t *mvx, *mvy;                          // [S, R, C]
  int S, R, C, N, Hp, Wp, Hcp, Wcp, pe, cp, qp, qpc;
};

constexpr int kPtrs = 9 + 3 * kMaxRefs + 5;  // 62
constexpr int kInts = 12;

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
  for (int k = 0; k < kMaxRefs; ++k) {
    a.pl[k] = in(9 + k);
    a.pu[k] = in(9 + kMaxRefs + k);
    a.pv[k] = in(9 + 2 * kMaxRefs + k);
  }
  const int o = 9 + 3 * kMaxRefs;
  a.ry = out(o), a.ru = out(o + 1), a.rv = out(o + 2);
  a.mvx = out(o + 3), a.mvy = out(o + 4);
  a.S = n[0], a.R = n[1], a.C = n[2], a.N = n[3], a.Hp = n[4], a.Wp = n[5];
  a.Hcp = n[6], a.Wcp = n[7], a.pe = n[8], a.cp = n[9], a.qp = n[10];
  a.qpc = n[11];
  return a;
}

// A warp's shared memory: its MB's prediction and chroma DC levels.
struct WarpMem {
  int pred[256], pu[64], pv[64];
};

// One MB (m = (s, r, c)) at motion (mvx, mvy), by one warp.
__device__ void recon_mb(const DecArgs& a, WarpMem& w, int lane, size_t m,
                         int s, int r, int c, int mvx, int mvy) {
  const RefPlanes geo{nullptr, nullptr, nullptr,
                      (size_t)a.S * a.Hp * a.Wp, a.Hp, a.Wp, a.Hcp, a.Wcp};
  const int kind = a.kind[m], ri = a.refidx[m];
  const int ref = ri >= 1 && ri < a.N ? ri : 0;
  const bool skip = kind == 0;
  const int cbp_l = skip ? 0 : a.cbp_l[m], cbp_c = skip ? 0 : a.cbp_c[m];
  {
    const int32_t* l = a.pl[ref] + (size_t)s * a.Hp * a.Wp;
    const int f = (mvy & 3) * 4 + (mvx & 3);
    const int y0 = 16 * r + (mvy >> 2) + a.pe, x0 = 16 * c + (mvx >> 2) + a.pe;
    for (int i = lane; i < 256; i += 32)
      w.pred[i] = mc_luma(geo, l, y0, x0, f, i >> 4, i & 15);
    const size_t cso = (size_t)s * a.Hcp * a.Wcp;
    const int y8 = 8 * r + (mvy >> 3) + a.cp, x8 = 8 * c + (mvx >> 3) + a.cp;
    const int xf = mvx & 7, yf = mvy & 7;
    for (int i = lane; i < 64; i += 32) {
      w.pu[i] = mc_chroma(geo, a.pu[ref] + cso, y8, x8, xf, yf, i >> 3, i & 7);
      w.pv[i] = mc_chroma(geo, a.pv[ref] + cso, y8, x8, xf, yf, i >> 3, i & 7);
    }
  }
  __syncwarp();
  const bool luma = lane < 16, chroma = lane >= 16 && lane < 24;
  if (luma || chroma) {
    const int cl = lane - 16, cpl = cl >> 2, cb = cl & 3;
    const int by = luma ? lane >> 2 : cb >> 1, bx = luma ? lane & 3 : cb & 1;
    const int n = luma ? 16 : 8;
    const int* pred = luma ? w.pred : cpl ? w.pv : w.pu;
    int d[16], pr[16];
#pragma unroll
    for (int i = 0; i < 16; ++i)
      pr[i] = pred[(4 * by + (i >> 2)) * n + 4 * bx + (i & 3)];
    if (luma) {
      const Quant Q = quantiser_inter(a.qp);
      const bool coded = (cbp_l >> (((by >> 1) << 1) | (bx >> 1))) & 1;
      const int16_t* lv = a.luma_ac + m * 256 + 16 * lane;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int i = zz(k);
        d[i] = coded ? dq_ac(Q, lv[k], pos_class(i)) : 0;
      }
    } else {
      const Quant QC = quantiser_inter(a.qpc);
      const int16_t* dc = a.chroma_dc + m * 8 + 4 * cpl;
      const int lvl[4] = {dc[0], dc[1], dc[2], dc[3]};
      d[0] = cbp_c >= 1 ? dq_cdc(QC, had2(lvl, cb)) : 0;
      const int16_t* lv = a.chroma_ac + m * 120 + 60 * cpl + 15 * cb;
#pragma unroll
      for (int k = 1; k < 16; ++k) {
        const int i = zz(k);
        d[i] = cbp_c == 2 ? dq_ac(QC, lv[k - 1], pos_class(i)) : 0;
      }
    }
    inv4_add(d, pr);
    int32_t* o = luma ? a.ry : cpl ? a.rv : a.ru;
#pragma unroll
    for (int i = 0; i < 16; ++i)
      o[m * n * n + (4 * by + (i >> 2)) * n + 4 * bx + (i & 3)] = d[i];
  }
  __syncwarp();  // the warp's next MB overwrites the prediction
}

__global__ void __launch_bounds__(32 * kWarps)
    pframe_decode_kernel(const DecArgs a) {
  __shared__ WarpMem smem[kWarps];
  __shared__ int mvs[2][32];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x;  // s * R + r
  const int s = row / a.R, r = row % a.R;
  const size_t m0 = (size_t)row * a.C;
  int carry_x = 0, carry_y = 0;  // warp 0: the vector left of the 32
  for (int c0 = 0; c0 < a.C; c0 += 32) {
    if (warp == 0) {
      const int c = c0 + lane;
      const bool inter = c < a.C && a.kind[m0 + c] == 1;
      int reset = !inter, vx = inter ? a.mvdx[m0 + c] : 0,
          vy = inter ? a.mvdy[m0 + c] : 0;
      // segmented inclusive scan: (reset, sum) after (reset', sum') is
      // (reset | reset', reset ? sum : sum' + sum)
      for (int o = 1; o < 32; o <<= 1) {
        const int src = lane >= o ? lane - o : lane;
        const int pr = __shfl_sync(0xffffffffu, reset, src);
        const int px = __shfl_sync(0xffffffffu, vx, src);
        const int py = __shfl_sync(0xffffffffu, vy, src);
        if (lane >= o && !reset) reset = pr, vx += px, vy += py;
      }
      if (!reset) vx += carry_x, vy += carry_y;
      mvs[0][lane] = vx, mvs[1][lane] = vy;
      if (c < a.C) a.mvx[m0 + c] = vx, a.mvy[m0 + c] = vy;
      carry_x = __shfl_sync(0xffffffffu, vx, 31);
      carry_y = __shfl_sync(0xffffffffu, vy, 31);
    }
    __syncthreads();
    const int n = min(32, a.C - c0);
    for (int k = warp; k < n; k += kWarps)
      recon_mb(a, smem[warp], lane, m0 + c0 + k, s, r, c0 + k, mvs[0][k],
               mvs[1][k]);
    __syncthreads();  // the next 32 columns overwrite mvs
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_pframe_kernel.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `dec_args`' order (host
// arrays); a block a MB row of the S * R.
extern "C" int th264_pframe_decode(void* const* p, const int* n,
                                   void* stream) {
  const DecArgs a = dec_args(p, n);
  pframe_decode_kernel<<<a.S * a.R, 32 * kWarps, 0, (cudaStream_t)stream>>>(
      a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
