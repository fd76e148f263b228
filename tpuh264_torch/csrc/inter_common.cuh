// The device helpers K9 (pframe_enc.cu) and K10 (pframe_dec.cu) share:
// the inter quantiser, the 4x4 forward and inverse core transforms, the
// 2x2 chroma DC Hadamard, the quarter-pel luma and eighth-pel chroma
// motion compensation, and the motion vector rate.  Each bit-exact with
// the torch code of kernels/transform.py and kernels/pframe.py; on top of
// intra16_common.cuh's tables and integer quant / dequant forms.
//
// Arithmetic: `>>` of a negative int is arithmetic and `&` two's
// complement, as torch's on int32, so `mvy >> 2`, `mvy & 3`, `mvy >> 3`
// and `mvy & 7` are the floor division and remainder the plain version
// takes; they stay int arithmetic here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"

namespace {

// The quantiser of an inter block: the rounding offset is 2^qbits / 6
// (transform.py quant4x4 / quant_chroma_dc with intra=False), where
// intra16_common.cuh's `quantiser` keeps the intra 2^qbits / 3 of K6-K8.
__device__ __forceinline__ Quant quantiser_inter(int qp) {
  Quant q = quantiser(qp);
  q.fq = (1 << q.qbits) / 6;
  return q;
}

// forward4x4 on a raster 4x4 block, in place: the column butterflies,
// then the row butterflies (exact integers: the order does not matter)
__device__ __forceinline__ void fwd4(int* x) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a0 = x[c] + x[12 + c], a1 = x[4 + c] + x[8 + c];
    const int a2 = x[4 + c] - x[8 + c], a3 = x[c] - x[12 + c];
    x[c] = a0 + a1, x[4 + c] = 2 * a3 + a2, x[8 + c] = a0 - a1;
    x[12 + c] = a3 - 2 * a2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int* y = x + 4 * r;
    const int b0 = y[0] + y[3], b1 = y[1] + y[2], b2 = y[1] - y[2],
              b3 = y[0] - y[3];
    y[0] = b0 + b1, y[1] = 2 * b3 + b2, y[2] = b0 - b1, y[3] = b3 - 2 * b2;
  }
}

// inverse4x4 (8.5.12.2: rows first, then columns; the `>> 1`s make the
// order matter), then (+ 32) >> 6 added to `pred` and clipped to 0..255,
// in place on the raster block d.
__device__ __forceinline__ void inv4_add(int* d, const int* pred) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int* y = d + 4 * r;
    const int e0 = y[0] + y[2], e1 = y[0] - y[2], e2 = (y[1] >> 1) - y[3],
              e3 = y[1] + (y[3] >> 1);
    y[0] = e0 + e3, y[1] = e1 + e2, y[2] = e1 - e2, y[3] = e0 - e3;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int g0 = d[c] + d[8 + c], g1 = d[c] - d[8 + c];
    const int g2 = (d[4 + c] >> 1) - d[12 + c], g3 = d[4 + c] + (d[12 + c] >> 1);
    d[c] = g0 + g3, d[4 + c] = g1 + g2, d[8 + c] = g1 - g2, d[12 + c] = g0 - g3;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) d[i] = clip255(pred[i] + ((d[i] + 32) >> 6));
}

// element k (raster, by * 2 + bx) of hadamard2x2 over the four blocks'
// values x (raster)
__device__ __forceinline__ int had2(const int* x, int k) {
  const int a0 = x[0] + x[2], a1 = x[1] + x[3];  // rows summed
  const int b0 = x[0] - x[2], b1 = x[1] - x[3];  // rows differenced
  return k == 0 ? a0 + a1 : k == 1 ? a0 - a1 : k == 2 ? b0 + b1 : b0 - b1;
}

// The quarter-pel luma components (golden.inter QPEL_TBL, kernels/pframe.py
// `_COMP_*`): component id -> half-pel plane (G, b, h, j) and its integer
// offset (dy, dx); and for each fraction fy * 4 + fx the two components
// whose rounded mean is the prediction.
__constant__ int kCompPl[8] = {0, 1, 2, 3, 0, 0, 1, 2};
__constant__ int kCompDy[8] = {0, 0, 0, 0, 0, 1, 1, 0};
__constant__ int kCompDx[8] = {0, 0, 0, 0, 1, 0, 0, 1};
__constant__ int kQpel[16][2] = {{0, 0}, {0, 1}, {1, 1}, {1, 4},
                                 {0, 2}, {1, 2}, {1, 3}, {1, 7},
                                 {2, 2}, {2, 3}, {3, 3}, {3, 7},
                                 {2, 5}, {2, 6}, {3, 6}, {7, 6}};

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// One reference's planes: the four half-pel planes of its luma ([4, S,
// Hp, Wp], pad pe) and its two chroma planes ([S, Hcp, Wcp], pad cp), all
// int32; each read at indices clamped into the plane, as the plain
// version's `_gather_win` clamps them (legal motion never reaches it).
struct RefPlanes {
  const int32_t *l, *u, *v;
  size_t lstride;  // S * Hp * Wp: from one half-pel plane to the next
  int Hp, Wp, Hcp, Wcp;
};

__device__ __forceinline__ int at(const int32_t* p, int y, int x, int h,
                                  int w) {
  return p[(size_t)clampi(y, 0, h - 1) * w + clampi(x, 0, w - 1)];
}

// Quarter-pel luma sample (yy, xx) of the MB whose plane-space origin at
// the motion's integer part is (y0, x0) = MB origin + (mv >> 2) + pe, at
// fraction f = (mvy & 3) * 4 + (mvx & 3); `l` is stream s's G plane.
__device__ __forceinline__ int mc_luma(const RefPlanes& p, const int32_t* l,
                                       int y0, int x0, int f, int yy, int xx) {
  int v = 1;
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const int id = kQpel[f][k];
    v += at(l + kCompPl[id] * p.lstride, y0 + kCompDy[id] + yy,
            x0 + kCompDx[id] + xx, p.Hp, p.Wp);
  }
  return v >> 1;
}

// Eighth-pel bilinear chroma sample (yy, xx) from stream s's plane `c`,
// origin (y0, x0) = chroma MB origin + (mv >> 3) + cp, fractions (xf, yf)
// = mv & 7.
__device__ __forceinline__ int mc_chroma(const RefPlanes& p, const int32_t* c,
                                         int y0, int x0, int xf, int yf,
                                         int yy, int xx) {
  const int y = y0 + yy, x = x0 + xx;
  return ((8 - xf) * (8 - yf) * at(c, y, x, p.Hcp, p.Wcp) +
          xf * (8 - yf) * at(c, y, x + 1, p.Hcp, p.Wcp) +
          (8 - xf) * yf * at(c, y + 1, x, p.Hcp, p.Wcp) +
          xf * yf * at(c, y + 1, x + 1, p.Hcp, p.Wcp) + 32) >> 6;
}

// kernels/pframe.py `_rate_q` of one component: 2 * n - 1, n the count of
// the powers 1, 2, .., 128 that are <= 2|v| + 1, i.e. min(bit length, 8):
// golden.inter.mv_rate_bits's ue(2|v|) length wherever |v| <= 127.  The
// refined vectors stay within 4 * (SEARCH_RANGE + REFINE_RANGE) + 3 + 4 *
// SEARCH_RANGE = 71 quarter-pels of the global vector (asserted by the
// sources' static_asserts), so the count is the exact length there.
__device__ __forceinline__ int ue_len(int v) {
  const unsigned x = 2u * (unsigned)abs(v) + 1u;
  int n = 0;
  while (n < 7 && (x >> n) > 1u) ++n;  // n + 1 = min(bit length, 8)
  return 2 * (n + 1) - 1;
}
__device__ __forceinline__ int rate_q(int vx, int vy) {
  return ue_len(vx) + ue_len(vy);
}

}  // namespace
