// The device helpers K6 (intra16_enc.cu), K7 / K8 (wavefront.cu) and K5
// (intra_recon.cu) share: the H.264 quantiser tables and their integer
// quant / dequant forms, zigzag and Hadamard indexing, small vector
// helpers, the level rate of the Intra_4x4 and 8x8 choices (`rate_bits`),
// and the Intra_16x16 residual decode of K8 and K5 from the parsed levels
// (`load_levels`, `block_residual`).  Each
// bit-exact with the torch code of kernels/transform.py (itself with
// golden/transform.py): every `>>` of a negative value is arithmetic, and
// a dequant `(z * v) << k` is written as a multiply by 1 << k (a left
// shift of a negative value is undefined in C++17).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// quantiser multiplier MF and dequantiser scale V of the position
// classes a ((even, even)), b ((odd, odd)) and c (the rest), by qp % 6
// (golden/transform.py MF_TABLE, V_TABLE)
__constant__ int kMF[3][6] = {{13107, 11916, 10082, 9362, 8192, 7282},
                              {5243, 4660, 4194, 3647, 3355, 2893},
                              {8066, 7490, 6554, 5825, 5243, 4559}};
__constant__ int kV[3][6] = {{10, 11, 13, 14, 16, 18},
                             {16, 18, 20, 23, 25, 29},
                             {13, 14, 16, 18, 20, 23}};

// raster index of 4x4 zigzag slot k (golden ZIGZAG4), a nibble a slot
__device__ __forceinline__ int zz(int k) {
  return (int)((0xFEB7ADC963258410ull >> (4 * k)) & 15);
}

// the 4x4 Hadamard matrix's entry (i, k): -1 where bit 4 i + k is set
__device__ __forceinline__ int h4(int i, int k) {
  return ((0xA6C0 >> (4 * i + k)) & 1) ? -1 : 1;
}

// position class of raster coefficient i: 0 = a, 1 = b, 2 = c
__device__ __forceinline__ int pos_class(int i) {
  const int r = i >> 2, c = i & 3;
  return ((r | c) & 1) == 0 ? 0 : ((r & c) & 1) ? 1 : 2;
}

__device__ __forceinline__ int quant(int w, int mf, int f, int qbits) {
  const int z = (abs(w) * mf + f) >> qbits;
  return w < 0 ? -z : z;
}

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }

// One plane's quantiser at its QP.
struct Quant {
  int qd, qbits, fq, scale, mf[3], vs[3];
};

__device__ __forceinline__ Quant quantiser(int qp) {
  Quant q;
  const int qm = qp % 6;
  q.qd = qp / 6;
  q.qbits = 15 + q.qd;
  q.fq = (1 << q.qbits) / 3;
  q.scale = 1 << q.qd;
#pragma unroll
  for (int i = 0; i < 3; ++i) q.mf[i] = kMF[i][qm], q.vs[i] = kV[i][qm];
  return q;
}

__device__ __forceinline__ int q_ac(const Quant& q, int w, int c) {
  return quant(w, q.mf[c], q.fq, q.qbits);
}
__device__ __forceinline__ int dq_ac(const Quant& q, int z, int c) {
  return z * q.vs[c] * q.scale;
}
__device__ __forceinline__ int q_ldc(const Quant& q, int f) {
  return quant(f, q.mf[0], q.fq << 2, q.qbits + 2);
}
__device__ __forceinline__ int dq_ldc(const Quant& q, int g) {
  return q.qd >= 2 ? g * q.vs[0] * (1 << (q.qd - 2))
                   : (g * q.vs[0] + (1 << (1 - q.qd))) >> (2 - q.qd);
}
__device__ __forceinline__ int q_cdc(const Quant& q, int f) {
  return quant(f, q.mf[0], q.fq << 1, q.qbits + 1);
}
__device__ __forceinline__ int dq_cdc(const Quant& q, int g) {
  return (g * q.vs[0] * q.scale) >> 1;
}

__device__ __forceinline__ int4 ld4(const int* p) {
  return *reinterpret_cast<const int4*>(p);
}
__device__ __forceinline__ int4 splat(int x) { return make_int4(x, x, x, x); }
__device__ __forceinline__ unsigned warp_sum(unsigned v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ int pick4(int4 v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}
__device__ __forceinline__ int sum4(int4 v) { return v.x + v.y + v.z + v.w; }

__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return (uint32_t)(uint16_t)lo | ((uint32_t)(uint16_t)hi << 16);
}

// four int32 samples (0..255) as the bytes of a word, x first
__device__ __forceinline__ uint32_t pack4(int4 v) {
  return (uint32_t)(v.x & 255) | ((uint32_t)(v.y & 255) << 8) |
         ((uint32_t)(v.z & 255) << 16) | ((uint32_t)(v.w & 255) << 24);
}

// kernels/iframe.py `_rate_bits` of one level: 2 bit_length(|l|) + 1,
// the length counted against the powers up to 2^15 (so at most 16), 0
// for a zero level
__device__ __forceinline__ int rate_bits(int l) {
  return l ? 2 * min(32 - __clz(abs(l)), 16) + 1 : 0;
}

__device__ __forceinline__ int clip16(int x) {
  return min(max(x, -32768), 32767);
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

// A lane's levels of one Intra_16x16 MB, int16 pairs.  Luma lane t < 16:
// `ac0/1` block t's 16 zigzag slots (slot 0 unused), `dc0/1` the 16 DC
// levels; chroma lane 16 + 4 p + j: `ac0/1` block j of plane p's slots
// 1-15 (slot 0 zero), `dc0.x/y` the plane's 4 DC levels (raster).  cbl,
// cbc: the MB's cbp_luma and cbp_chroma.
struct LevelPart {
  int4 ac0, ac1, dc0, dc1;
  int cbl, cbc;
};

__device__ __forceinline__ int level_at(const int4& w0, const int4& w1,
                                        int i) {
  const uint32_t w = (uint32_t)pick4(i < 8 ? w0 : w1, (i & 7) >> 1);
  return (int)(int16_t)(i & 1 ? w >> 16 : w & 0xffffu);
}

// Lane t's LevelPart of the MB whose fields start at dc (16 luma DC
// levels), ac (16 x 16 luma AC), cdc (2 x 4 chroma DC) and cac (2 x 4 x 15
// chroma AC), in MBSymbols' layouts, in device or shared memory; dc and ac
// 16-byte aligned, cdc 8-byte.
__device__ __forceinline__ LevelPart load_levels(const int16_t* dc,
                                                 const int16_t* ac,
                                                 const int16_t* cdc,
                                                 const int16_t* cac, int cbl,
                                                 int cbc, int t) {
  LevelPart v;
  v.cbl = cbl;
  v.cbc = cbc;
  v.ac0 = v.ac1 = v.dc0 = v.dc1 = make_int4(0, 0, 0, 0);
  if (t < 16) {
    const int4* a4 = reinterpret_cast<const int4*>(ac + 16 * t);
    const int4* d4 = reinterpret_cast<const int4*>(dc);
    v.ac0 = a4[0], v.ac1 = a4[1], v.dc0 = d4[0], v.dc1 = d4[1];
  } else if (t < 24) {
    const int p = (t - 16) >> 2, j = (t - 16) & 3;
    const int16_t* c = cac + 60 * p + 15 * j;  // 2-aligned
    int w[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      w[k] = (int)pack16(k ? c[2 * k - 1] : 0, c[2 * k]);
    v.ac0 = make_int4(w[0], w[1], w[2], w[3]);
    v.ac1 = make_int4(w[4], w[5], w[6], w[7]);
    const uint2 d = *reinterpret_cast<const uint2*>(cdc + 4 * p);
    v.dc0 = make_int4((int)d.x, (int)d.y, 0, 0);
  }
  return v;
}

// Lane t's residual 4x4 block of an Intra_16x16 MB, exactly as
// kernels/iframe.py `_intra_residuals`: luma block t (raster block t) on
// lanes 0-15, chroma block j of plane p on 16 + 4 p + j; luma AC only
// where cbl == 1, chroma DC only where cbc >= 1, chroma AC only where cbc
// == 2.  x: the 16 residuals, raster, (inverse + 32) >> 6 in int32.
// Returns false on lanes 24-31 (x untouched).
__device__ __forceinline__ bool block_residual(const LevelPart& v,
                                               const Quant& ql,
                                               const Quant& qc, int t,
                                               int* x) {
  if (t >= 24) return false;
  const bool luma = t < 16;
  const int j = (t - 16) & 3;
  const int by = luma ? t >> 2 : j >> 1, bx = luma ? t & 3 : j & 1;
  const Quant q = luma ? ql : qc;  // a copy: a reference to one of the
                                   // two would put both on the stack
  if (luma) {  // element (by, bx) of the inverse DC Hadamard
    int g = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      g += h4(by, zz(k) >> 2) * h4(bx, zz(k) & 3) * level_at(v.dc0, v.dc1, k);
    x[0] = dq_ldc(ql, g);
  } else {  // element (by, bx) of plane p's 2x2 one, where cbp has a DC
    const int z0 = level_at(v.dc0, v.dc1, 0), z1 = level_at(v.dc0, v.dc1, 1);
    const int z2 = level_at(v.dc0, v.dc1, 2), z3 = level_at(v.dc0, v.dc1, 3);
    const int g = (z0 + (bx ? -z1 : z1)) +
                  (by ? -1 : 1) * (z2 + (bx ? -z3 : z3));
    x[0] = v.cbc >= 1 ? dq_cdc(qc, g) : 0;
  }
  const bool ac = luma ? v.cbl == 1 : v.cbc == 2;  // cbp has the AC
#pragma unroll
  for (int k = 1; k < 16; ++k)
    x[zz(k)] =
        ac ? dq_ac(q, level_at(v.ac0, v.ac1, k), pos_class(zz(k))) : 0;
  inverse4x4(x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = (x[i] + 32) >> 6;
  return true;
}

// The residual 4x4 block of an Intra_4x4 MB's luma, exactly as
// kernels/intra44.py `decode_mb`: its 16 zigzag levels (ac0 / ac1 as
// `load_levels` gives a luma lane: slot 0 a level too), every position
// dequantised as AC (`dequant_flat`), no DC and no cbp mask.  x: the 16
// residuals, raster, (inverse + 32) >> 6 in int32.
__device__ __forceinline__ void block_residual44(const LevelPart& v,
                                                 const Quant& q, int* x) {
#pragma unroll
  for (int k = 0; k < 16; ++k)
    x[zz(k)] = dq_ac(q, level_at(v.ac0, v.ac1, k), pos_class(zz(k)));
  inverse4x4(x);
#pragma unroll
  for (int i = 0; i < 16; ++i) x[i] = (x[i] + 32) >> 6;
}

}  // namespace
