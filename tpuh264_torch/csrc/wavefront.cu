// K7 and K8: the single-slice I frame's wavefront scans, the encode (K7,
// `th264_wavefront_encode`) and the reconstruction from parsed symbols
// (K8, `th264_wavefront_decode`): one block per stream, one launch a
// frame each way.
//
// Replaces: the jax.lax.scans of tpuh264/kernels/wavefront.py
// `encode_iframe_single` (:151; step :180, scan :284, `_collect` :288) and
// `decode_iframe_single` (:325; step :353, scan :435), not pallas_calls.
// Their plain PyTorch versions are kernels/wavefront.py
// `_encode_iframe_single_plain` and `_decode_iframe_single_plain`.
//
// What they compute, exactly as the plain versions.  A single-slice
// picture predicts across MB rows, so MB (r, c) reads the reconstructed
// samples of its left, top and top-left neighbours: the top row, the
// left column and the corner p[-1, -1] of each plane.
//  * K7, per MB: the four Intra_16x16 luma candidates in the golden order
//    DC, V, H, Plane (mode numbers 2, 0, 1, 3), V needing the top, H the
//    left, Plane both; the first strict minimum of the SADs wins.  Then
//    the luma transform of src - pred, the 16 DC coefficients through the
//    4x4 Hadamard and quant_luma_dc, the AC through quant4x4 (intra
//    rounding), the reconstruction (DC dequant, AC dequant, inverse 4x4,
//    (+ 32) >> 6, clip to 0..255).  Chroma the same, in the order DC (a
//    DC a 4x4 quadrant, 8.3.4.1), H, V, Plane (scale 34), by the summed
//    Cb + Cr SAD, with the 2x2 Hadamard and quant_chroma_dc.  The plain
//    version masks the dequantised levels by cbp; every such mask is a
//    no-op (a cbp of 0 means those levels are all zero), so none is
//    applied here.
//  * K8, per MB: the prediction of the parsed `mode` / `cmode` from the
//    same neighbours, plus the residuals of iframe._intra_residuals
//    (batched in torch before the launch: they do not depend on the
//    prediction), clipped to 0..255.
// Where a neighbour is unavailable (row 0 has no top, column 0 no left)
// its samples read 0, and so does the corner where either is missing.  A
// legal stream never predicts from them: V needs the top, H the left,
// Plane both, and DC uses only the available sides.  (On a mode that is
// illegal at its MB the plain version reads its saved corner, the
// bottom-right sample of MB (r - 2, 0), at a Plane MB of column 0 from
// row 2 on; K8 reads 0 there.)
//
// Design.  A wave is the anti-diagonal d = r + c: MB (r, c) reads only
// MBs of waves d - 1 and d - 2, so R + C - 1 waves cover the frame, each
// holding at most min(R, C) MBs (the JAX scan's waves 2r + c are a
// different order of the same dependencies).  Each stream is a block:
// its warps take the wave's MBs, a warp an MB, looping where the wave
// holds more MBs than the block has warps, and a __syncthreads() ends
// each wave.  Neighbours are read back from the uint8 reconstruction the
// block writes (block-scope visibility after the barrier; one SM's L1
// serves them): no frontier, no saved corner.  Inside a warp, the SADs
// take all 32 lanes (a lane 8 luma and 4 chroma samples of each
// candidate, then shuffle reductions); the transform lanes 0-15 a luma
// 4x4 block each and 16-23 a chroma block each; the DC Hadamards go
// through the warp's shared scratch.
//
// What bounds it on the H100: the chain of waves, not bytes.  A stream
// runs on one SM, a wave's MBs a few warps deep, each MB a warp's
// instruction stream of roughly a thousand integer instructions with a
// few global round trips; its bytes bound (the source in, the levels and
// the recon out) is microseconds.  This is the simple first version:
// spreading a stream over a thread-block cluster is the next step.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"

namespace {

constexpr int kWarps = 16;  // warps a block: MBs of a wave in flight
constexpr int kThreads = 32 * kWarps;

struct EncArgs {
  const void *sy, *su, *sv;     // source planes [S,H,W], [S,H/2,W/2]
  int src_u8;                   // 1: uint8 samples, 0: int32 (0..255)
  int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [S, R, C]
  int16_t *dc, *ac, *cdc, *cac;  // [.,16], [.,16,16], [.,2,4], [.,2,4,15]
  int16_t* i4;                   // [., 16], set to -1
  uint8_t *ry, *ru, *rv;         // recon planes, raster
  int R, C, qp, qpc;
};

struct DecArgs {
  const int32_t *mode, *cmode;   // [S, R, C]
  const int32_t *res_y, *res_u, *res_v;  // [S,R,C,4,4,4,4], [.,2,2,4,4]
  uint8_t *ry, *ru, *rv;         // recon planes, raster
  int R, C;
};

// A warp's MB neighbours: the top row, left column and corner of each
// plane (luma 16, Cb and Cr 8 samples), zero where unavailable.
struct Nb {
  int top[16], left[16];
  int ctop[2][8], cleft[2][8];
  int corner[3];
};

// One plane of one stream: its samples from `base`, rows of `w`.
struct Plane {
  uint8_t* base;
  size_t w;
  __device__ __forceinline__ int at(int y, int x) const {
    return base[(size_t)y * w + x];
  }
};

__device__ __forceinline__ Plane plane_of(uint8_t* p, int s, int R, int C,
                                          int n) {
  const size_t w = (size_t)n * C;
  return Plane{p + (size_t)s * n * R * w, w};
}

// The neighbours of MB (r, c) (luma `py`, chroma `pc[2]`), read from the
// reconstruction by the whole warp: luma top by lanes 0-15, left by
// 16-31; chroma plane t >> 4, top by lanes t & 15 < 8, left by the rest;
// the corners by lanes 0-2.
__device__ void load_nb(Nb& nb, const Plane& py, const Plane* pc, int r,
                        int c, int t) {
  if (t < 16)
    nb.top[t] = r ? py.at(16 * r - 1, 16 * c + t) : 0;
  else
    nb.left[t - 16] = c ? py.at(16 * r + t - 16, 16 * c - 1) : 0;
  const int p = t >> 4, k = t & 15;
  if (k < 8)
    nb.ctop[p][k] = r ? pc[p].at(8 * r - 1, 8 * c + k) : 0;
  else
    nb.cleft[p][k - 8] = c ? pc[p].at(8 * r + k - 8, 8 * c - 1) : 0;
  if (t < 3) {
    const Plane& q = t ? pc[t - 1] : py;
    const int n = t ? 8 : 16;
    nb.corner[t] = r && c ? q.at(n * r - 1, n * c - 1) : 0;
  }
  __syncwarp();
}

// Plane prediction (8.3.3.4 / 8.3.4.4) of an n x n block: a, b, c of
// (a + b (x - n/2 + 1) + c (y - n/2 + 1) + 16) >> 5, clipped.
struct PlaneFit {
  int a, b, c;
};

template <int N, int SCALE>
__device__ __forceinline__ PlaneFit plane_fit(const int* top,
                                              const int* left, int corner) {
  constexpr int half = N / 2;
  int h = 0, v = 0;
#pragma unroll
  for (int x = 0; x < half; ++x) {
    const int tl = x == half - 1 ? corner : top[half - 2 - x];
    const int ll = x == half - 1 ? corner : left[half - 2 - x];
    h += (x + 1) * (top[half + x] - tl);
    v += (x + 1) * (left[half + x] - ll);
  }
  return PlaneFit{16 * (top[N - 1] + left[N - 1]), (SCALE * h + 32) >> 6,
                  (SCALE * v + 32) >> 6};
}

template <int N>
__device__ __forceinline__ int plane_at(const PlaneFit& f, int y, int x) {
  return clip255((f.a + f.b * (x - (N / 2 - 1)) + f.c * (y - (N / 2 - 1)) +
                  16) >> 5);
}

// Luma: DC and the plane fit.
struct LumaPred {
  int dc;
  PlaneFit pf;
};

__device__ __forceinline__ LumaPred luma_pred_of(const Nb& nb, bool tav,
                                                 bool lav) {
  int st = 0, sl = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) st += nb.top[i], sl += nb.left[i];
  const int dc = tav && lav ? (st + sl + 16) >> 5
                 : tav      ? (st + 8) >> 4
                 : lav      ? (sl + 8) >> 4
                            : 128;
  return LumaPred{dc, plane_fit<16, 5>(nb.top, nb.left, nb.corner[0])};
}

// sample (y, x) of luma mode `mode` (0 V, 1 H, 2 DC, 3 Plane)
__device__ __forceinline__ int luma_at(const Nb& nb, const LumaPred& p,
                                       int mode, int y, int x) {
  return mode == 0 ? nb.top[x]
         : mode == 1 ? nb.left[y]
         : mode == 2 ? p.dc
                     : plane_at<16>(p.pf, y, x);
}

// Chroma of one plane: the DC of each 4x4 quadrant [by][bx] and the
// plane fit.
struct ChromaPred {
  int dc[2][2];
  PlaneFit pf;
};

__device__ __forceinline__ ChromaPred chroma_pred_of(const int* top,
                                                     const int* left,
                                                     int corner, bool tav,
                                                     bool lav) {
  const int ts0 = top[0] + top[1] + top[2] + top[3];
  const int ts1 = top[4] + top[5] + top[6] + top[7];
  const int ls0 = left[0] + left[1] + left[2] + left[3];
  const int ls1 = left[4] + left[5] + left[6] + left[7];
  auto corner_dc = [&](int t, int l) {
    return tav && lav ? (t + l + 4) >> 3
           : tav      ? (t + 2) >> 2
           : lav      ? (l + 2) >> 2
                      : 128;
  };
  auto top_pref = [&](int t, int l) {
    return tav ? (t + 2) >> 2 : lav ? (l + 2) >> 2 : 128;
  };
  auto left_pref = [&](int t, int l) {
    return lav ? (l + 2) >> 2 : tav ? (t + 2) >> 2 : 128;
  };
  ChromaPred p;
  p.dc[0][0] = corner_dc(ts0, ls0);
  p.dc[0][1] = top_pref(ts1, ls0);
  p.dc[1][0] = left_pref(ts0, ls1);
  p.dc[1][1] = corner_dc(ts1, ls1);
  p.pf = plane_fit<8, 34>(top, left, corner);
  return p;
}

// sample (y, x) of chroma mode `cmode` (0 DC, 1 H, 2 V, 3 Plane)
__device__ __forceinline__ int chroma_at(const int* top, const int* left,
                                         const ChromaPred& p, int cmode,
                                         int y, int x) {
  return cmode == 0 ? p.dc[y >> 2][x >> 2]
         : cmode == 1 ? left[y]
         : cmode == 2 ? top[x]
                      : plane_at<8>(p.pf, y, x);
}

// forward4x4 in place on a raster block: the vertical butterflies of each
// column, then the horizontal ones of each row
__device__ __forceinline__ void forward4x4(int* x) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a0 = x[c] + x[12 + c], a1 = x[4 + c] + x[8 + c];
    const int a2 = x[4 + c] - x[8 + c], a3 = x[c] - x[12 + c];
    x[c] = a0 + a1, x[4 + c] = 2 * a3 + a2, x[8 + c] = a0 - a1;
    x[12 + c] = a3 - 2 * a2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int* p = x + 4 * r;
    const int b0 = p[0] + p[3], b1 = p[1] + p[2];
    const int b2 = p[1] - p[2], b3 = p[0] - p[3];
    p[0] = b0 + b1, p[1] = 2 * b3 + b2, p[2] = b0 - b1, p[3] = b3 - 2 * b2;
  }
}

// inverse4x4 (8.5.12.2) in place: rows first, then columns
__device__ __forceinline__ void inverse4x4(int* d) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int* p = d + 4 * r;
    const int e0 = p[0] + p[2], e1 = p[0] - p[2];
    const int e2 = (p[1] >> 1) - p[3], e3 = p[1] + (p[3] >> 1);
    p[0] = e0 + e3, p[1] = e1 + e2, p[2] = e1 - e2, p[3] = e0 - e3;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int g0 = d[c] + d[8 + c], g1 = d[c] - d[8 + c];
    const int g2 = (d[4 + c] >> 1) - d[12 + c], g3 = d[4 + c] + (d[12 + c] >> 1);
    d[c] = g0 + g3, d[4 + c] = g1 + g2, d[8 + c] = g1 - g2;
    d[12 + c] = g0 - g3;
  }
}

__device__ __forceinline__ int warp_sum_i(int v) {
  return (int)warp_sum((unsigned)v);
}

// the first strict minimum of four costs among the available ones
// (candidate 0 always is)
__device__ __forceinline__ int first_min(const int* cost, const bool* av) {
  int best = 0;
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (av[i] && cost[i] < cost[best]) best = i;
  return best;
}

// A warp's scratch for one MB of K7.
struct __align__(16) EncWarp {
  __align__(16) uint8_t ys[256];    // the source luma MB, raster
  __align__(16) uint8_t cs[2][64];  // Cb, Cr
  Nb nb;
  int dcs[16];     // each luma block's DC coefficient, block by * 4 + bx
  int zl[16];      // the luma DC levels, raster (i, j)
  int cdc[2][4];   // each chroma block's DC coefficient
  int czl[2][4];   // the chroma DC levels, raster
};

// K7 on MB (r, c) of stream s, by one warp (lane t).
__device__ void encode_mb(const EncArgs& a, EncWarp& w, int s, int r, int c,
                          int t, const Quant& ql, const Quant& qc) {
  const int R = a.R, C = a.C;
  const size_t m = ((size_t)s * R + r) * C + c;
  const Plane py = plane_of(a.ry, s, R, C, 16);
  const Plane pc[2] = {plane_of(a.ru, s, R, C, 8), plane_of(a.rv, s, R, C, 8)};
  // the source MB: lanes 0-15 a luma row each, 16-23 Cb rows, 24-31 Cr;
  // int32 samples packed to bytes (16-byte loads: a row starts at a
  // multiple of 8 samples)
  if (t < 16) {
    const size_t o = ((size_t)s * 16 * R + 16 * r + t) * (16 * (size_t)C) +
                     16 * (size_t)c;
    uint4 v;
    if (a.src_u8) {
      v = *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(a.sy) +
                                          o);
    } else {
      const int4* q = reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(a.sy) + o);
      v = make_uint4(pack4(q[0]), pack4(q[1]), pack4(q[2]), pack4(q[3]));
    }
    *reinterpret_cast<uint4*>(w.ys + 16 * t) = v;
  } else {
    const int p = (t - 16) >> 3, y = t & 7;
    const size_t o = ((size_t)s * 8 * R + 8 * r + y) * (8 * (size_t)C) +
                     8 * (size_t)c;
    const void* src = p ? a.sv : a.su;
    uint2 v;
    if (a.src_u8) {
      v = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(src) +
                                          o);
    } else {
      const int4* q = reinterpret_cast<const int4*>(
          static_cast<const int32_t*>(src) + o);
      v = make_uint2(pack4(q[0]), pack4(q[1]));
    }
    *reinterpret_cast<uint2*>(w.cs[p] + 8 * y) = v;
  }
  load_nb(w.nb, py, pc, r, c, t);  // its __syncwarp covers the source too
  const Nb& nb = w.nb;
  const bool tav = r > 0, lav = c > 0;
  const bool av_l[4] = {true, tav, lav, tav && lav};  // DC, V, H, Plane
  const bool av_c[4] = {true, lav, tav, tav && lav};  // DC, H, V, Plane
  const LumaPred lp = luma_pred_of(nb, tav, lav);
  const ChromaPred cp0 = chroma_pred_of(nb.ctop[0], nb.cleft[0],
                                        nb.corner[1], tav, lav);
  const ChromaPred cp1 = chroma_pred_of(nb.ctop[1], nb.cleft[1],
                                        nb.corner[2], tav, lav);

  // the luma SADs in the golden order DC, V, H, Plane: lane t, row t >> 1,
  // 8 samples from 8 (t & 1)
  int sad[4] = {0, 0, 0, 0};
  {
    const int y = t >> 1, x0 = 8 * (t & 1);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int x = x0 + k, v = w.ys[16 * y + x];
      sad[0] += abs(v - lp.dc);
      sad[1] += abs(v - nb.top[x]);
      sad[2] += abs(v - nb.left[y]);
      sad[3] += abs(v - plane_at<16>(lp.pf, y, x));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) sad[i] = warp_sum_i(sad[i]);
  const int mode = (0x3102 >> (4 * first_min(sad, av_l))) & 15;

  // the chroma SADs, Cb + Cr, in the order DC, H, V, Plane: lane t, plane
  // t >> 4, row (t >> 1) & 7, 4 samples from 4 (t & 1)
  int csad[4] = {0, 0, 0, 0};
  {
    const int p = t >> 4, y = (t >> 1) & 7, x0 = 4 * (t & 1);
    const ChromaPred& cp = p ? cp1 : cp0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int x = x0 + k, v = w.cs[p][8 * y + x];
      csad[0] += abs(v - cp.dc[y >> 2][x >> 2]);
      csad[1] += abs(v - nb.cleft[p][y]);
      csad[2] += abs(v - nb.ctop[p][x]);
      csad[3] += abs(v - plane_at<8>(cp.pf, y, x));
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) csad[i] = warp_sum_i(csad[i]);
  const int cmode = first_min(csad, av_c);

  // the transform: lanes 0-15 luma block t (by = t >> 2, bx = t & 3),
  // lanes 16-23 chroma block j = (t - 16) & 3 of plane (t - 16) >> 2
  const bool luma = t < 16, chroma = t >= 16 && t < 24;
  const int p = (t - 16) >> 2, j = (t - 16) & 3;
  const int by = luma ? t >> 2 : j >> 1, bx = luma ? t & 3 : j & 1;
  const ChromaPred& cp = p ? cp1 : cp0;
  const int* ctop = nb.ctop[p & 1];
  const int* cleft = nb.cleft[p & 1];
  int x[16], pr[16];
  bool nz = false;
  if (luma || chroma) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int yy = 4 * by + (i >> 2), xx = 4 * bx + (i & 3);
      pr[i] = luma ? luma_at(nb, lp, mode, yy, xx)
                   : chroma_at(ctop, cleft, cp, cmode, yy, xx);
      x[i] = (luma ? w.ys[16 * yy + xx] : w.cs[p][8 * yy + xx]) - pr[i];
    }
    forward4x4(x);
    const Quant& q = luma ? ql : qc;
    if (luma)
      w.dcs[t] = x[0];
    else
      w.cdc[p][j] = x[0];
#pragma unroll
    for (int i = 1; i < 16; ++i) {
      x[i] = q_ac(q, x[i], pos_class(i));
      nz |= x[i] != 0;
    }
    if (luma) {  // the levels in zigzag order, slot 0 (the DC) zero
      int zs[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) zs[k] = k ? x[zz(k)] : 0;
      int4* o = reinterpret_cast<int4*>(a.ac + m * 256 + 16 * t);
      o[0] = make_int4(pack16(zs[0], zs[1]), pack16(zs[2], zs[3]),
                       pack16(zs[4], zs[5]), pack16(zs[6], zs[7]));
      o[1] = make_int4(pack16(zs[8], zs[9]), pack16(zs[10], zs[11]),
                       pack16(zs[12], zs[13]), pack16(zs[14], zs[15]));
    } else {  // zigzag slots 1-15
      int16_t* o = a.cac + m * 120 + 60 * p + 15 * j - 1;
#pragma unroll
      for (int k = 1; k < 16; ++k) o[k] = (int16_t)x[zz(k)];
    }
  }
  __syncwarp();
  // the DC Hadamards of the block DCs, quantised: luma element (t >> 2,
  // t & 3) of H X H, chroma element (by, bx) of plane p's 2x2 one
  if (luma) {
    const int i = t >> 2, jj = t & 3;
    int f = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      f += h4(i, k >> 2) * h4(jj, k & 3) * w.dcs[k];
    w.zl[t] = q_ldc(ql, f);
  } else if (chroma) {
    const int* d = w.cdc[p];
    const int f = (d[0] + (bx ? -d[1] : d[1])) +
                  (by ? -1 : 1) * (d[2] + (bx ? -d[3] : d[3]));
    w.czl[p][j] = q_cdc(qc, f);
  }
  __syncwarp();
  const bool cbp_l = __ballot_sync(0xffffffffu, luma && nz) != 0;
  const bool ac_c = __ballot_sync(0xffffffffu, chroma && nz) != 0;
  const bool dc_c =
      __ballot_sync(0xffffffffu, chroma && w.czl[p & 1][j] != 0) != 0;

  // the reconstruction: the dequantised DC (the inverse Hadamard's
  // element (by, bx)) and AC, inverse4x4, + pred, clipped
  if (luma || chroma) {
    const Quant& q = luma ? ql : qc;
    int g = 0;
    if (luma) {
#pragma unroll
      for (int k = 0; k < 16; ++k)
        g += h4(by, k >> 2) * h4(bx, k & 3) * w.zl[k];
      x[0] = dq_ldc(ql, g);
    } else {
      const int* z = w.czl[p];
      g = (z[0] + (bx ? -z[1] : z[1])) + (by ? -1 : 1) * (z[2] + (bx ? -z[3] : z[3]));
      x[0] = dq_cdc(qc, g);
    }
#pragma unroll
    for (int i = 1; i < 16; ++i) x[i] = dq_ac(q, x[i], pos_class(i));
    inverse4x4(x);
    const Plane& out = luma ? py : pc[p];
    const int n = luma ? 16 : 8;
#pragma unroll
    for (int yy = 0; yy < 4; ++yy) {
      uint32_t v = 0;
#pragma unroll
      for (int xx = 0; xx < 4; ++xx)
        v |= (uint32_t)clip255(pr[4 * yy + xx] + ((x[4 * yy + xx] + 32) >> 6))
             << (8 * xx);
      *reinterpret_cast<uint32_t*>(
          out.base + (size_t)(n * r + 4 * by + yy) * out.w + n * c + 4 * bx) =
          v;
    }
    if (luma) {
      a.dc[m * 16 + t] = (int16_t)w.zl[zz(t)];
      if (a.i4) a.i4[m * 16 + t] = -1;
    } else {
      a.cdc[m * 8 + 4 * p + j] = (int16_t)w.czl[p][j];
    }
  }
  if (t == 0) {
    a.mode[m] = mode;
    a.cmode[m] = cmode;
    a.cbp_l[m] = cbp_l;
    a.cbp_c[m] = ac_c ? 2 : dc_c ? 1 : 0;
  }
  __syncwarp();  // the scratch is the warp's next MB's
}

// K8 on MB (r, c) of stream s, by one warp (lane t; `nb` its scratch).
__device__ void decode_mb(const DecArgs& a, Nb& nb, int s, int r, int c,
                          int t) {
  const int R = a.R, C = a.C;
  const size_t m = ((size_t)s * R + r) * C + c;
  const Plane py = plane_of(a.ry, s, R, C, 16);
  const Plane pc[2] = {plane_of(a.ru, s, R, C, 8), plane_of(a.rv, s, R, C, 8)};
  load_nb(nb, py, pc, r, c, t);
  const bool tav = r > 0, lav = c > 0;
  const int mode = a.mode[m], cmode = a.cmode[m];
  // luma: lane t, row y = t >> 1, 8 samples from x0 = 8 (t & 1): the
  // residuals of blocks (y >> 2, x0 >> 2) and the next, row y & 3
  {
    const LumaPred lp = luma_pred_of(nb, tav, lav);
    const int y = t >> 1, x0 = 8 * (t & 1);
    const int* res = a.res_y + m * 256 + ((y >> 2) * 4 + (x0 >> 2)) * 16 +
                     4 * (y & 3);
    const int4 r0 = ld4(res), r1 = ld4(res + 16);
    const int rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const uint32_t v = clip255(luma_at(nb, lp, mode, y, x0 + k) + rv[k]);
      if (k < 4)
        lo |= v << (8 * k);
      else
        hi |= v << (8 * (k - 4));
    }
    *reinterpret_cast<uint2*>(py.base + (size_t)(16 * r + y) * py.w +
                              16 * c + x0) = make_uint2(lo, hi);
  }
  // chroma: lane t, plane t >> 4, row y = (t >> 1) & 7, 4 samples from
  // x0 = 4 (t & 1): block (y >> 2, t & 1), its row y & 3
  {
    const int p = t >> 4, y = (t >> 1) & 7, bx = t & 1;
    const ChromaPred cp = chroma_pred_of(nb.ctop[p], nb.cleft[p],
                                         nb.corner[1 + p], tav, lav);
    const int4 rr = ld4((p ? a.res_v : a.res_u) + m * 64 +
                        ((y >> 2) * 2 + bx) * 16 + 4 * (y & 3));
    const int rv[4] = {rr.x, rr.y, rr.z, rr.w};
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v |= (uint32_t)clip255(chroma_at(nb.ctop[p], nb.cleft[p], cp, cmode, y,
                                       4 * bx + k) + rv[k])
           << (8 * k);
    *reinterpret_cast<uint32_t*>(pc[p].base + (size_t)(8 * r + y) * pc[p].w +
                                 8 * c + 4 * bx) = v;
  }
  __syncwarp();  // the scratch is the warp's next MB's
}

// The waves d = r + c of one stream (block s = blockIdx.x): the warps take
// the wave's MBs, r from max(0, d - C + 1) up, a warp every kWarps rows.
__global__ void __launch_bounds__(kThreads) wavefront_enc_kernel(EncArgs a) {
  __shared__ EncWarp scratch[kWarps];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31, s = blockIdx.x;
  const Quant ql = quantiser(a.qp), qc = quantiser(a.qpc);
  for (int d = 0; d < a.R + a.C - 1; ++d) {
    const int r1 = min(a.R - 1, d);
    for (int r = max(0, d - a.C + 1) + warp; r <= r1; r += kWarps)
      encode_mb(a, scratch[warp], s, r, d - r, t, ql, qc);
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads) wavefront_dec_kernel(DecArgs a) {
  __shared__ Nb scratch[kWarps];
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31, s = blockIdx.x;
  for (int d = 0; d < a.R + a.C - 1; ++d) {
    const int r1 = min(a.R - 1, d);
    for (int r = max(0, d - a.C + 1) + warp; r <= r1; r += kWarps)
      decode_mb(a, scratch[warp], s, r, d - r, t);
    __syncthreads();
  }
}

}  // namespace

#ifdef __CUDACC__  // the entries; tests/test_torch_wavefront_kernel.py
                   // runs the rest above on CPU threads, compiled by g++
                   // against shims

// K7: S streams of R x C MBs, source planes uint8 (src_u8 1) or int32,
// raster; the MBSymbols fields (i4modes all -1) and the uint8 recon
// planes out.
extern "C" int th264_wavefront_encode(
    const void* sy, const void* su, const void* sv, int src_u8,
    int32_t* mode, int32_t* cmode, int32_t* cbp_l, int32_t* cbp_c,
    int16_t* dc, int16_t* ac, int16_t* cdc, int16_t* cac, int16_t* i4,
    uint8_t* ry, uint8_t* ru, uint8_t* rv, int S, int R, int C, int qp,
    int qpc, void* stream) {
  const EncArgs a{sy, su, sv, src_u8, mode, cmode, cbp_l, cbp_c, dc, ac,
                  cdc, cac, i4, ry, ru, rv, R, C, qp, qpc};
  wavefront_enc_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// K8: S streams of R x C MBs: int32 mode, cmode and residuals in; the
// uint8 recon planes out.
extern "C" int th264_wavefront_decode(
    const int32_t* mode, const int32_t* cmode, const int32_t* res_y,
    const int32_t* res_u, const int32_t* res_v, uint8_t* ry, uint8_t* ru,
    uint8_t* rv, int S, int R, int C, void* stream) {
  const DecArgs a{mode, cmode, res_y, res_u, res_v, ry, ru, rv, R, C};
  wavefront_dec_kernel<<<S, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
