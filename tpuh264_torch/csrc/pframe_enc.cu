// K9: the P encode after stage A -- per MB and reference the full-pel and
// quarter-pel refinement, the reference choice, motion compensation, the
// inter luma and chroma transforms, quantisation and reconstruction, and
// P_Skip -- a warp per MB.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py
// `encode_pframe_rows_multi` (:638) after its stage A, not a pallas_call:
// `_int_refine` :381, `_extract_w2` :421, `_subpel_refine` :433, the
// reference choice :700-740, `_mc_all` :610, `_transform_inter_luma` :541,
// `_recon_inter_luma` :558, `_chroma_fwd` :565, `_recon_chroma` :573,
// P_Skip and the batched symbols :810-845.  Its plain PyTorch version is
// `kernels/pframe.py` `_inter_encode_plain` (called with t8 False).
//
// What it computes, exactly as the plain version, per MB of stream s and
// per reference n < N (1-16), from stage A's winner (iy0, ix0) and the
// stream's global vector (gy, gx) of that reference:
//  * stage B: the 3x3 full-pel refine on the G plane, cost sad + lam *
//    rate_q(4 mx - 4 gx, 4 my - 4 gy), candidates in raster order (dy
//    outer), a candidate replacing the best only when strictly cheaper;
//  * stages C / D: the 49 quarter-pel costs around the refined vector
//    (each prediction the rounded mean of two half-pel components,
//    QPEL_TBL), then the half-pel selection in OFFSETS_HALF order and the
//    quarter-pel one in OFFSETS_QUARTER order around it, both from the
//    centre and on a strict <; the SAD kept is the chosen position's;
//  * the reference choice: the cost plus lam * ref_idx_bits(n + ref_base,
//    ref_base + N) (the host's `ref_cost`), a later reference replacing
//    the best only on a strict <;
//  * motion compensation from the chosen reference: luma the rounded mean
//    of the fraction's two components, chroma the eighth-pel bilinear of
//    the _CP-padded planes, both at indices clamped into the planes as
//    `_gather_win` clamps them;
//  * luma: the 4x4 forward transform of src - pred, the inter
//    quantisation (rounding 2^qbits / 6), the levels in zigzag order
//    (blocks in raster order), cbp from the 8x8 groups, and the
//    reconstruction with the uncoded groups' levels masked; chroma at
//    qpc: the 2x2 DC Hadamard and its quantisation, the AC levels, cbp
//    (2 any AC, 1 any DC, else 0) and the reconstruction;
//  * P_Skip: luma and chroma cbp 0, motion 0 and reference index
//    refsel + ref_base 0; refidx is 0 for a skip, else refsel + ref_base.
// It writes mvx, mvy, refsel, inter SAD, kind, refidx, both cbps and the
// int16 levels [S,R,C,16,16], [S,R,C,2,4], [S,R,C,2,4,15] (the MBSymbolsP
// layouts), and the reconstruction: int32 MBs [S,R,C,16,16], [S,R,C,8,8]
// x 2 with intra-in-P (K6's D4 takes them as rec_inter), else the uint8
// planes [S,H,W], [S,H/2,W/2] x 2.
//
// What bounds it on the H100: bytes.  Every MB searches every reference,
// and its 18x18 windows of the four half-pel planes tile each plane, so
// at 1080p x 4 with one reference it must read the four int32 half-pel
// planes and the two chroma planes over the frame's area (150.4 MB) and
// the int32 source (50.1 MB), and write 1,184 bytes a MB (38.6 MB):
// about 239 MB, 0.071 ms at 3.35 TB/s.  Its arithmetic, 58 candidate SADs
// of 256 samples a MB and reference, is some 0.5 G integer operations at
// 1080p x 4, far under the card's rate.
//
// Design, simple and right first: a warp per MB, kWarps MBs a block (no
// block barrier: a warp past the last MB returns).  The warp stages the
// source MB and, per reference, the 18x18 G window of stage B and then
// the four planes' 18x18 windows of stages C / D in its shared memory;
// lane l takes row l / 2 and eight columns of every candidate, whose SAD
// an xor-shuffle reduction gives every lane, so every lane runs the same
// selections.  Then lanes 0-15 take a luma 4x4 block each and lanes 16-23
// a chroma block each (cbps by ballots, the chroma DCs through shared
// memory).  Where trouble is likely, and what is done about it:
//  * tie order: every selection is the plain version's sequential strict
//    < in its own order (stage B raster, half then quarter, references by
//    index), run identically on every lane; no parallel min reorders it;
//  * `_rate_q`: the plain version counts 2|v| + 1 against the powers up
//    to 128, exact for |v| <= 127; `ue_len` counts the same way, and the
//    static_assert below bounds the refined vectors at 71;
//  * negative shifts and masks: mv >> 2, & 3, >> 3, & 7 stay int
//    arithmetic (floor, two's complement), as torch's;
//  * alignment: the half-pel planes are [S, Hp, Wp] int32 with Wp not a
//    multiple of 4; every load here is a scalar one;
//  * multi-reference: up to sixteen references' pointers (unused ones
//    repeat reference 0's), a reference's winners at [n, S, R, C]; N is 1
//    right after an IDR, and ref_base is the temporal-layer session's
//    forced reference.

#include <cuda_runtime.h>
#include <stdint.h>

#include "inter_common.cuh"  // inter quantiser, transforms, MC, rate

namespace {

constexpr int kWarps = 4;     // MBs a block, a warp each
constexpr int kMaxRefs = 16;  // H.264's most references
constexpr int kWin = 18;      // window side: 16 + the +-1 around a vector
constexpr int kSearch = 8, kRefine = 1;  // golden.inter SEARCH_RANGE, REFINE_RANGE
static_assert(4 * (kSearch + kRefine) + 3 + 4 * kSearch <= 127,
              "a refined vector's rate is outside _rate_q's exact range");

struct EncArgs {
  const int32_t *y, *u, *v;            // source [S,H,W], [S,H/2,W/2] x 2
  const int32_t *iy0, *ix0;            // stage A winners [N, S, R, C]
  const int32_t *gy, *gx;              // global vectors [N, S]
  const int32_t *pl[kMaxRefs];         // half-pel planes [4, S, Hp, Wp]
  const int32_t *pu[kMaxRefs], *pv[kMaxRefs];  // chroma [S, Hcp, Wcp]
  int32_t *mvx, *mvy, *refsel, *sad, *kind, *refidx, *cbp_l, *cbp_c;
  int16_t *luma_ac, *chroma_dc, *chroma_ac;
  void *ry, *ru, *rv;                  // int32 MBs (mb_out) or uint8 planes
  int S, R, C, N, Hp, Wp, Hcp, Wcp, pe, cp, qp, qpc, lam, ref_base, mb_out;
  int ref_cost[kMaxRefs];              // lam * ref_idx_bits of reference n
};

constexpr int kPtrs = 3 + 4 + 3 * kMaxRefs + 8 + 3 + 3;  // 69
constexpr int kInts = 15 + kMaxRefs;                      // 31

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k9_launch` builds them.
inline EncArgs enc_args(void* const* p, const int* n) {
  EncArgs a;
  auto in = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  auto lev = [p](int i) { return static_cast<int16_t*>(p[i]); };
  a.y = in(0), a.u = in(1), a.v = in(2);
  a.iy0 = in(3), a.ix0 = in(4), a.gy = in(5), a.gx = in(6);
  for (int k = 0; k < kMaxRefs; ++k) {
    a.pl[k] = in(7 + k);
    a.pu[k] = in(7 + kMaxRefs + k);
    a.pv[k] = in(7 + 2 * kMaxRefs + k);
  }
  const int o = 7 + 3 * kMaxRefs;  // the outputs
  a.mvx = out(o), a.mvy = out(o + 1), a.refsel = out(o + 2);
  a.sad = out(o + 3), a.kind = out(o + 4), a.refidx = out(o + 5);
  a.cbp_l = out(o + 6), a.cbp_c = out(o + 7);
  a.luma_ac = lev(o + 8), a.chroma_dc = lev(o + 9), a.chroma_ac = lev(o + 10);
  a.ry = p[o + 11], a.ru = p[o + 12], a.rv = p[o + 13];
  a.S = n[0], a.R = n[1], a.C = n[2], a.N = n[3], a.Hp = n[4], a.Wp = n[5];
  a.Hcp = n[6], a.Wcp = n[7], a.pe = n[8], a.cp = n[9], a.qp = n[10];
  a.qpc = n[11], a.lam = n[12], a.ref_base = n[13], a.mb_out = n[14];
  for (int k = 0; k < kMaxRefs; ++k) a.ref_cost[k] = n[15 + k];
  return a;
}
static_assert(7 + 3 * kMaxRefs + 14 == kPtrs, "pointer count");

// A warp's shared memory: its MB's source, one reference's windows, the
// 49 costs and SADs, the prediction, the chroma DCs.
struct WarpMem {
  int src[256], su[64], sv[64];
  int win[4][kWin][kWin];
  int cost[49], sad[49];
  int pred[256], pu[64], pv[64];
  int cdc[2][4];
};

// the 18x18 window of plane `p` (stream s's) at plane-space (y0, x0),
// each index clamped into the plane
__device__ __forceinline__ void load_win(int (*w)[kWin], const int32_t* p,
                                         int y0, int x0, int hp, int wp,
                                         int lane) {
  for (int i = lane; i < kWin * kWin; i += 32)
    w[i / kWin][i % kWin] = at(p, y0 + i / kWin, x0 + i % kWin, hp, wp);
}

__device__ __forceinline__ int warp_sad(int part) {
  return (int)warp_sum((unsigned)part);
}

__global__ void __launch_bounds__(32 * kWarps)
    pframe_encode_kernel(const EncArgs a) {
  __shared__ WarpMem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rc = a.R * a.C, mbs = a.S * rc;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= mbs) return;  // the whole warp: no block barrier follows
  WarpMem& w = smem[warp];
  const int s = m / rc, r = (m % rc) / a.C, c = m % a.C;
  const int H = 16 * a.R, W = 16 * a.C, Hc = H / 2, Wc = W / 2;
  const RefPlanes geo{nullptr, nullptr, nullptr,
                      (size_t)a.S * a.Hp * a.Wp, a.Hp, a.Wp, a.Hcp, a.Wcp};
  const size_t lso = (size_t)s * a.Hp * a.Wp, cso = (size_t)s * a.Hcp * a.Wcp;

  const int32_t* ys = a.y + (size_t)s * H * W + (size_t)16 * r * W + 16 * c;
  for (int i = lane; i < 256; i += 32) w.src[i] = ys[(i >> 4) * W + (i & 15)];
  const size_t co = (size_t)s * Hc * Wc + (size_t)8 * r * Wc + 8 * c;
  for (int i = lane; i < 64; i += 32) {
    w.su[i] = a.u[co + (i >> 3) * Wc + (i & 7)];
    w.sv[i] = a.v[co + (i >> 3) * Wc + (i & 7)];
  }
  __syncwarp();

  const int row = lane >> 1, col = (lane & 1) * 8;  // the lane's 8 samples
  const int* srow = w.src + 16 * row + col;
  int best_cost = 0, best_mvx = 0, best_mvy = 0, best_sad = 0, best_ref = 0;
  for (int n = 0; n < a.N; ++n) {
    const size_t am = (size_t)n * mbs + m;
    const int iy0 = a.iy0[am], ix0 = a.ix0[am];
    const int gqy = 4 * a.gy[n * a.S + s], gqx = 4 * a.gx[n * a.S + s];
    const int32_t* g = a.pl[n] + lso;

    // stage B: 3x3 full-pel refine, raster order, strict <
    load_win(w.win[0], g, 16 * r + iy0 - kRefine + a.pe,
             16 * c + ix0 - kRefine + a.pe, a.Hp, a.Wp, lane);
    __syncwarp();
    int bcost = 0, iy = 0, ix = 0;
    for (int k = 0; k < 9; ++k) {
      const int oy = k / 3, ox = k % 3;
      const int* wr = &w.win[0][row + oy][col + ox];
      int part = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) part += abs(srow[j] - wr[j]);
      const int sad = warp_sad(part);
      const int my = iy0 - kRefine + oy, mx = ix0 - kRefine + ox;
      const int cost = sad + a.lam * rate_q(4 * mx - gqx, 4 * my - gqy);
      if (k == 0 || cost < bcost) bcost = cost, iy = my, ix = mx;
    }
    __syncwarp();

    // stages C / D: the four planes' windows at the refined vector - 1
    for (int p = 0; p < 4; ++p)
      load_win(w.win[p], a.pl[n] + p * geo.lstride + lso,
               16 * r + iy - 1 + a.pe, 16 * c + ix - 1 + a.pe, a.Hp, a.Wp,
               lane);
    __syncwarp();
    for (int k = 0; k < 49; ++k) {
      const int py = k / 7 - 3, px = k % 7 - 3;
      const int f = (py & 3) * 4 + (px & 3);
      const int c1 = kQpel[f][0], c2 = kQpel[f][1];
      const int* w1 = &w.win[kCompPl[c1]][1 + (py >> 2) + kCompDy[c1] + row]
                            [1 + (px >> 2) + kCompDx[c1] + col];
      const int* w2 = &w.win[kCompPl[c2]][1 + (py >> 2) + kCompDy[c2] + row]
                            [1 + (px >> 2) + kCompDx[c2] + col];
      int part = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) part += abs(srow[j] - ((w1[j] + w2[j] + 1) >> 1));
      const int sad = warp_sad(part);
      if (lane == 0) {
        w.sad[k] = sad;
        w.cost[k] = sad + a.lam * rate_q(4 * ix + px - gqx, 4 * iy + py - gqy);
      }
    }
    __syncwarp();
    // half-pel (OFFSETS_HALF order), then quarter-pel (OFFSETS_QUARTER)
    // around it; both from the centre, strict <
    int cost = w.cost[24], by = 0, bx = 0;
    for (int k = 0; k < 9; ++k) {
      const int hy = 2 * (k / 3) - 2, hx = 2 * (k % 3) - 2;
      const int cand = w.cost[(3 + hy) * 7 + 3 + hx];
      if (k != 4 && cand < cost) cost = cand, by = hy, bx = hx;
    }
    const int base_y = by, base_x = bx;
    for (int k = 0; k < 9; ++k) {
      const int qy = base_y + k / 3 - 1, qx = base_x + k % 3 - 1;
      const int cand = w.cost[(3 + qy) * 7 + 3 + qx];
      if (k != 4 && cand < cost) cost = cand, by = qy, bx = qx;
    }
    const int sad = w.sad[(3 + by) * 7 + 3 + bx];
    cost += a.ref_cost[n];
    if (n == 0 || cost < best_cost) {
      best_cost = cost, best_mvx = 4 * ix + bx, best_mvy = 4 * iy + by;
      best_sad = sad, best_ref = n;
    }
    __syncwarp();  // the next reference overwrites the windows and costs
  }

  // motion compensation from the chosen reference
  const int mvx = best_mvx, mvy = best_mvy;
  {
    const int32_t* l = a.pl[best_ref] + lso;
    const int f = (mvy & 3) * 4 + (mvx & 3);
    const int y0 = 16 * r + (mvy >> 2) + a.pe, x0 = 16 * c + (mvx >> 2) + a.pe;
    for (int i = lane; i < 256; i += 32)
      w.pred[i] = mc_luma(geo, l, y0, x0, f, i >> 4, i & 15);
    const int y8 = 8 * r + (mvy >> 3) + a.cp, x8 = 8 * c + (mvx >> 3) + a.cp;
    const int xf = mvx & 7, yf = mvy & 7;
    const int32_t *cu = a.pu[best_ref] + cso, *cv = a.pv[best_ref] + cso;
    for (int i = lane; i < 64; i += 32) {
      w.pu[i] = mc_chroma(geo, cu, y8, x8, xf, yf, i >> 3, i & 7);
      w.pv[i] = mc_chroma(geo, cv, y8, x8, xf, yf, i >> 3, i & 7);
    }
  }
  __syncwarp();

  // the transforms: lanes 0-15 luma block lane (raster by * 4 + bx),
  // lanes 16-23 chroma block (lane - 16) & 3 of plane (lane - 16) >> 2
  const bool luma = lane < 16, chroma = lane >= 16 && lane < 24;
  const int cl = lane - 16, cpl = cl >> 2, cb = cl & 3;
  const Quant Q = quantiser_inter(a.qp), QC = quantiser_inter(a.qpc);
  int x[16], q[16], pr[16];
  bool nz_ac = false;
  if (luma || chroma) {
    const int stride = luma ? 16 : 8;
    const int by = luma ? lane >> 2 : cb >> 1, bx = luma ? lane & 3 : cb & 1;
    const int* src = luma ? w.src : cpl ? w.sv : w.su;
    const int* pred = luma ? w.pred : cpl ? w.pv : w.pu;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int o = (4 * by + (i >> 2)) * stride + 4 * bx + (i & 3);
      pr[i] = pred[o];
      x[i] = src[o] - pr[i];
    }
    fwd4(x);
    const Quant& qq = luma ? Q : QC;
#pragma unroll
    for (int i = 0; i < 16; ++i) q[i] = q_ac(qq, x[i], pos_class(i));
    if (luma) {
      int16_t* lv = a.luma_ac + (size_t)m * 256 + 16 * lane;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        lv[k] = (int16_t)q[zz(k)];
        nz_ac |= q[k] != 0;
      }
    } else {
      int16_t* lv = a.chroma_ac + (size_t)m * 120 + 60 * cpl + 15 * cb;
#pragma unroll
      for (int k = 1; k < 16; ++k) {
        lv[k - 1] = (int16_t)q[zz(k)];
        nz_ac |= q[zz(k)] != 0;
      }
      w.cdc[cpl][cb] = x[0];  // the block's DC coefficient
    }
  }
  __syncwarp();
  int dcq = 0;
  if (chroma) {
    dcq = q_cdc(QC, had2(w.cdc[cpl], cb));
    a.chroma_dc[(size_t)m * 8 + 4 * cpl + cb] = (int16_t)dcq;
  }
  __syncwarp();
  if (chroma) w.cdc[cpl][cb] = dcq;
  const unsigned nzl = __ballot_sync(0xffffffffu, luma && nz_ac);
  const unsigned anyac = __ballot_sync(0xffffffffu, chroma && nz_ac);
  const unsigned anydc = __ballot_sync(0xffffffffu, chroma && dcq != 0);
  const int cbp_l = ((nzl & 0x33u) ? 1 : 0) | ((nzl & 0xCCu) ? 2 : 0) |
                    ((nzl & 0x3300u) ? 4 : 0) | ((nzl & 0xCC00u) ? 8 : 0);
  const int cbp_c = anyac ? 2 : anydc ? 1 : 0;

  // the reconstruction: uncoded 8x8 groups' and chroma's cbp-masked
  // levels dropped, dequantised, inverse transformed, added, clipped
  if (luma) {
    const int by = lane >> 2, bx = lane & 3;
    const bool coded = (cbp_l >> (((by >> 1) << 1) | (bx >> 1))) & 1;
#pragma unroll
    for (int i = 0; i < 16; ++i) x[i] = coded ? dq_ac(Q, q[i], pos_class(i)) : 0;
    inv4_add(x, pr);
  } else if (chroma) {
    const int dc = cbp_c >= 1 ? dq_cdc(QC, had2(w.cdc[cpl], cb)) : 0;
#pragma unroll
    for (int i = 1; i < 16; ++i)
      x[i] = cbp_c == 2 ? dq_ac(QC, q[i], pos_class(i)) : 0;
    x[0] = dc;
    inv4_add(x, pr);
  }
  if (luma || chroma) {
    const int by = luma ? lane >> 2 : cb >> 1, bx = luma ? lane & 3 : cb & 1;
    const int n = luma ? 16 : 8;
    for (int i = 0; i < 16; ++i) {
      const int yy = 4 * by + (i >> 2), xx = 4 * bx + (i & 3);
      if (a.mb_out) {
        int32_t* o = static_cast<int32_t*>(luma ? a.ry : cpl ? a.rv : a.ru);
        o[(size_t)m * n * n + yy * n + xx] = x[i];
      } else {
        uint8_t* o = static_cast<uint8_t*>(luma ? a.ry : cpl ? a.rv : a.ru);
        const int pw = luma ? W : Wc, ph = luma ? H : Hc;
        o[(size_t)s * ph * pw + (size_t)(n * r + yy) * pw + n * c + xx] =
            (uint8_t)x[i];
      }
    }
  }
  if (lane == 0) {
    const bool skip = cbp_l == 0 && cbp_c == 0 && mvx == 0 && mvy == 0 &&
                      best_ref + a.ref_base == 0;
    a.mvx[m] = mvx, a.mvy[m] = mvy, a.refsel[m] = best_ref;
    a.sad[m] = best_sad, a.kind[m] = skip ? 0 : 1;
    a.refidx[m] = skip ? 0 : best_ref + a.ref_base;
    a.cbp_l[m] = cbp_l, a.cbp_c[m] = cbp_c;
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_pframe_kernel.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `enc_args`' order (host
// arrays); one warp a MB of the S * R * C.
extern "C" int th264_pframe_encode(void* const* p, const int* n,
                                   void* stream) {
  const EncArgs a = enc_args(p, n);
  const int mbs = a.S * a.R * a.C;
  pframe_encode_kernel<<<(mbs + kWarps - 1) / kWarps, 32 * kWarps, 0,
                         (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
