// The device helpers K9 (pframe_enc.cu) and K10 (pframe_dec.cu) share:
// the inter quantiser, the 4x4 forward and inverse core transforms, the
// 2x2 chroma DC Hadamard, the quarter-pel component tables, the
// eighth-pel chroma motion compensation, packed-byte helpers, the
// motion vector rate, and the 8x8 transform's passes, quantiser, scales,
// zigzag of the t8 routes.  Each bit-exact with the torch code of
// kernels/transform.py, transform8.py, iframe.py and kernels/pframe.py;
// on top of intra16_common.cuh's tables, integer quant / dequant forms
// and level rate (`rate_bits`).  The
// reference planes are K11's: uint8, rows 16-byte aligned and a pitch of
// a multiple of 16 bytes apart (kernels/pframe.py `_references`).
//
// Arithmetic: `>>` of a negative int is arithmetic and `&` two's
// complement, as torch's on int32, so `mvy >> 2`, `mvy & 3`, `mvy >> 3`
// and `mvy & 7` are the floor division and remainder the plain version
// takes; they stay int arithmetic here.  Predictions are kept as packed
// bytes: every sample they are made of is 0..255 (the references are
// reconstructed pictures, and build_halfpel_planes_ext clips b, h, j).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"

#ifdef __CUDACC__
namespace {
// cp.async: 4 or 16 bytes from global to shared memory with no register
// held while they fly (the t8 routes' windows and levels), the thread's
// copies since the last commit made one group, and a wait until all but
// the newest N groups have landed.  A wait orders only the thread's own
// copies: a __syncwarp after it gives the warp's.  (On the CPU threads
// of the tests, tests/cuda_threads.py queues each thread's copies and
// lands them at the wait, so a read before its wait finds what was there
// before.)
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}
}  // namespace
#endif

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

// byte j of a packed word
__device__ __forceinline__ int byte_of(uint32_t w, int j) {
  return (int)((w >> (8 * j)) & 255u);
}

// inverse4x4 (8.5.12.2: rows first, then columns; the `>> 1`s make the
// order matter), then (+ 32) >> 6 added to the prediction and clipped to
// 0..255, in place on the raster block d; pred[i] holds row i's four
// prediction samples as bytes.
__device__ __forceinline__ void inv4_add(int* d, const uint32_t* pred) {
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
  for (int i = 0; i < 16; ++i)
    d[i] = clip255(byte_of(pred[i >> 2], i & 3) + ((d[i] + 32) >> 6));
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
// whose rounded mean is the prediction (one component twice at the
// whole- and half-pel fractions 0, 2, 8, 10).
__constant__ int kCompPl[8] = {0, 1, 2, 3, 0, 0, 1, 2};
__constant__ int kCompDy[8] = {0, 0, 0, 0, 0, 1, 1, 0};
__constant__ int kCompDx[8] = {0, 0, 0, 0, 1, 0, 0, 1};
__constant__ int kQpel[16][2] = {{0, 0}, {0, 1}, {1, 1}, {1, 4},
                                 {0, 2}, {1, 2}, {1, 3}, {1, 7},
                                 {2, 2}, {2, 3}, {3, 3}, {3, 7},
                                 {2, 5}, {2, 6}, {3, 6}, {7, 6}};

// The t8 routes' kQpel through kCompPl / kCompDy / kCompDx: fraction f's
// two components as byte f of two immediates (bits 0-1 the first's
// plane, 2 its dy, 3 its dx, 4-7 the second's likewise), not four
// constant-memory loads a component at a run-time index
__device__ __forceinline__ unsigned qpel_pair(int f) {
  const uint64_t pk = f >> 3 ? 0x5a535242a3333222ull : 0xa131212081111000ull;
  return (unsigned)(pk >> (8 * (f & 7))) & 255u;
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// sample (y, x) of an h x w byte plane, rows `pitch` bytes apart, at
// indices clamped into it (never into the pitch bytes past w), as the
// plain version's `_gather_win` clamps them (legal motion never reaches
// it)
__device__ __forceinline__ int at(const uint8_t* p, int y, int x, int h,
                                  int w, int pitch) {
  return p[(size_t)clampi(y, 0, h - 1) * pitch + clampi(x, 0, w - 1)];
}

// four 0..255 ints as the bytes of a word, the first lowest
__device__ __forceinline__ uint32_t pack_bytes(int a, int b, int c, int d) {
  return (uint32_t)a | ((uint32_t)b << 8) | ((uint32_t)c << 16) |
         ((uint32_t)d << 24);
}

// the per-byte rounded mean (a + b + 1) >> 1 of two packed words: per
// byte, (a | b) - ((a ^ b) >> 1), the mask keeping each byte's shift
// inside it (no byte borrows: (a | b) >= (a ^ b) / 2)
__device__ __forceinline__ uint32_t avg4(uint32_t a, uint32_t b) {
  return (a | b) - (((a ^ b) >> 1) & 0x7f7f7f7fu);
}

// The eighth-pel bilinear (8.4.2.2.2) of four chroma samples from the
// 2 x 5 integer samples t around them, fractions (xf, yf), as the bytes
// of a word.
__device__ __forceinline__ uint32_t bilin4(const int (&t)[2][5], int xf,
                                           int yf) {
  const int w00 = (8 - xf) * (8 - yf), w01 = xf * (8 - yf);
  const int w10 = (8 - xf) * yf, w11 = xf * yf;
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    out |= (uint32_t)((w00 * t[0][j] + w01 * t[0][j + 1] + w10 * t[1][j] +
                       w11 * t[1][j + 1] + 32) >> 6) << (8 * j);
  return out;
}

// Four eighth-pel bilinear chroma samples (8.4.2.2.2), row yy and
// columns xx .. xx + 3 of a chroma MB, from byte plane c (hc x wc, rows
// `pitch` bytes apart) at origin (y0, x0) = chroma MB origin + (mv >> 3)
// + cp, fractions (xf, yf) = mv & 7, as the bytes of a word.  `inside`:
// the MB's 9x9 window lies in the plane, so no index needs the clamp and
// a row's 5 samples come from the two aligned words that hold them (the
// second starts before column x0 + 9 <= wc: never past the row).
__device__ __forceinline__ uint32_t mc_chroma4(const uint8_t* c, int hc,
                                               int wc, int pitch, int y0,
                                               int x0, int xf, int yf,
                                               int yy, int xx, bool inside) {
  int t[2][5];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (inside) {
      const int x = x0 + xx, off = x & 3;
      const uint32_t* p = reinterpret_cast<const uint32_t*>(
          c + (size_t)(y0 + yy + i) * pitch + x - off);
      const uint32_t w0 = p[0], w1 = p[1];
      const uint32_t lo = __funnelshift_r(w0, w1, 8 * off);
#pragma unroll
      for (int j = 0; j < 4; ++j) t[i][j] = byte_of(lo, j);
      t[i][4] = byte_of(w1, off);
    } else {
#pragma unroll
      for (int j = 0; j < 5; ++j)
        t[i][j] = at(c, y0 + yy + i, x0 + xx + j, hc, wc, pitch);
    }
  }
  return bilin4(t, xf, yf);
}

// `mc_chroma4` from a chroma window in shared memory (K9's t8 route):
// its rows kRow words apart, sample (y, x) of the window at byte x of row
// y; (y0, x0) the MC origin in it.
template <int kRow>
__device__ __forceinline__ uint32_t mc_chroma4_win(const uint32_t* win,
                                                   int y0, int x0, int xf,
                                                   int yf, int yy, int xx) {
  int t[2][5];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = x0 + xx, off = x & 3;
    const uint32_t* p = win + (y0 + yy + i) * kRow + (x >> 2);
    const uint32_t w0 = p[0], w1 = p[1];
    const uint32_t lo = __funnelshift_r(w0, w1, 8 * off);
#pragma unroll
    for (int j = 0; j < 4; ++j) t[i][j] = byte_of(lo, j);
    t[i][4] = byte_of(w1, off);
  }
  return bilin4(t, xf, yf);
}

// kernels/pframe.py `_rate_q` of one component: 2 * n - 1, n the count of
// the powers 1, 2, .., 128 that are <= 2|v| + 1, i.e. min(bit length, 8):
// golden.inter.mv_rate_bits's ue(2|v|) length wherever |v| <= 127.  The
// refined vectors stay within 4 * (SEARCH_RANGE + REFINE_RANGE) + 3 + 4 *
// SEARCH_RANGE = 71 quarter-pels of the global vector (asserted by
// pframe_enc.cu's static_assert), so the count is the exact length there.
__device__ __forceinline__ int ue_len(int v) {
  const int bits = 32 - __clz(2 * abs(v) + 1);
  return 2 * min(bits, 8) - 1;
}
__device__ __forceinline__ int rate_q(int vx, int vy) {
  return ue_len(vx) + ue_len(vy);
}

// ---- the 8x8 transform of the t8 routes (K9's trial, K10's decode):
// kernels/transform8.py, whose tables are golden/transform8.py's.  An 8x8
// block's coefficients lie as transform8.py's forward8x8 returns them,
// [u][v] with u the frequency along x (its first pass) and v along y.

// the position classes of the scales (_DQ8_SCAN), the dequant scales
// (_DQ8_INIT, levelScale8x8) and the forward multipliers (_MF8_INIT) of
// class c at qp % 6
__constant__ int kCls8[16] = {0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1};
__constant__ int kV8[6][6] = {{20, 18, 32, 19, 25, 24}, {22, 19, 35, 21, 28, 26},
                              {26, 23, 42, 24, 33, 31}, {28, 25, 45, 26, 35, 33},
                              {32, 28, 51, 30, 40, 38}, {36, 32, 58, 34, 46, 43}};
__constant__ int kMF8[6][6] = {
    {13107, 11428, 20972, 12222, 16777, 15481},
    {11916, 10826, 19174, 11058, 14980, 14290},
    {10082, 8943, 15978, 9675, 12710, 11985},
    {9362, 8228, 14913, 8931, 11984, 11259},
    {8192, 7346, 13159, 7740, 10486, 9777},
    {7282, 6428, 11570, 6830, 9118, 8640}};
// ZIGZAG8: level k's coefficient, 8 u + v
__constant__ int kZz8[64] = {
    0,  8,  1,  2,  9,  16, 24, 17, 10, 3,  4,  11, 18, 25, 32, 40,
    33, 26, 19, 12, 5,  6,  13, 20, 27, 34, 41, 48, 56, 49, 42, 35,
    28, 21, 14, 7,  15, 22, 29, 36, 43, 50, 57, 58, 51, 44, 37, 30,
    23, 31, 38, 45, 52, 59, 60, 53, 46, 39, 47, 54, 61, 62, 55, 63};

// The t8 routes' zigzag of one lane's eight coefficients at once (one
// constant load a lane, not one a coefficient, where lanes index apart):
// kZz8Row[r] byte k is kZz8[8 r + k]; kZz8Col[v] byte u is the level
// index of coefficient [u][v] (kZz8's inverse).
__constant__ uint64_t kZz8Row[8] = {
    0x1118100902010800ull, 0x282019120b04030aull, 0x140d06050c131a21ull,
    0x232a31383029221bull, 0x241d160f070e151cull, 0x1e252c333a39322bull,
    0x353c3b342d261f17ull, 0x3f373e3d362f272eull};
__constant__ uint64_t kZz8Col[8] = {
    0x1c1b0f0e06050100ull, 0x2a1d1a100d070402ull, 0x2b291e19110c0803ull,
    0x352c281f18120b09ull, 0x36342d272017130aull, 0x3c37332e26211614ull,
    0x3d3b38322f252215ull, 0x3f3e3a3931302423ull};

__device__ __forceinline__ int cls8(int u, int v) {
  return kCls8[(u & 3) * 4 + (v & 3)];
}

// cls8(u, v) for every v & 3 at once, as the nibbles v & 3 of an
// immediate (kCls8 is symmetric: also cls8(u, v) for every u & 3 at
// v's nibble u & 3)
__device__ __forceinline__ unsigned cls8_row(int u) {
  return (unsigned)(0x1513525415133430ull >> (16 * (u & 3))) & 0xffffu;
}

// one forward 1-D pass (transform8.py `_fwd_stage`), in place
__device__ __forceinline__ void fwd8(int* x) {
  const int s07 = x[0] + x[7], d07 = x[0] - x[7];
  const int s16 = x[1] + x[6], d16 = x[1] - x[6];
  const int s25 = x[2] + x[5], d25 = x[2] - x[5];
  const int s34 = x[3] + x[4], d34 = x[3] - x[4];
  const int a0 = s07 + s34, a1 = s16 + s25, a2 = s07 - s34, a3 = s16 - s25;
  const int a4 = d16 + d25 + (d07 + (d07 >> 1));
  const int a5 = d07 - d34 - (d25 + (d25 >> 1));
  const int a6 = d07 + d34 - (d16 + (d16 >> 1));
  const int a7 = d16 - d25 + (d34 + (d34 >> 1));
  x[0] = a0 + a1, x[1] = a4 + (a7 >> 2), x[2] = a2 + (a3 >> 1);
  x[3] = a5 + (a6 >> 2), x[4] = a0 - a1, x[5] = a6 - (a5 >> 2);
  x[6] = (a2 >> 1) - a3, x[7] = (a4 >> 2) - a7;
}

// one inverse 1-D pass (transform8.py `_inv_stage`, 8.5.13), in place
__device__ __forceinline__ void inv8(int* x) {
  const int a0 = x[0] + x[4], a4 = x[0] - x[4];
  const int a2 = (x[2] >> 1) - x[6], a6 = x[2] + (x[6] >> 1);
  const int b0 = a0 + a6, b2 = a4 + a2, b4 = a4 - a2, b6 = a0 - a6;
  const int a1 = -x[3] + x[5] - x[7] - (x[7] >> 1);
  const int a3 = x[1] + x[7] - x[3] - (x[3] >> 1);
  const int a5 = -x[1] + x[7] + x[5] + (x[5] >> 1);
  const int a7 = x[3] + x[5] + x[1] + (x[1] >> 1);
  const int b1 = a1 + (a7 >> 2), b7 = a7 - (a1 >> 2);
  const int b3 = a3 + (a5 >> 2), b5 = (a3 >> 2) - a5;
  x[0] = b0 + b7, x[1] = b2 + b5, x[2] = b4 + b3, x[3] = b6 + b1;
  x[4] = b6 - b1, x[5] = b4 - b3, x[6] = b2 - b5, x[7] = b0 - b7;
}

// quant8x8(intra=False) of coefficient w at multiplier mf: sign(w) *
// ((|w| mf + f) >> qbits), f = 2^qbits / 6, qbits = 16 + qp / 6
__device__ __forceinline__ int q8(int w, int mf, int f, int qbits) {
  const int l = (abs(w) * mf + f) >> qbits;
  return w < 0 ? -l : l;
}

// dequant8x8 of level z at scale v: << (qp / 6 - 2) from QP 12 on,
// below it the rounded >> (2 - qp / 6)
__device__ __forceinline__ int dq8(int z, int v, int qp) {
  const int zv = z * v;
  return qp >= 12 ? zv * (1 << (qp / 6 - 2))  // the shift, defined for zv < 0
                  : (zv + (1 << (1 - qp / 6))) >> (2 - qp / 6);
}

}  // namespace
