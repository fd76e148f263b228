// The device helpers K6 (intra16_enc.cu) and K7 / K8 (wavefront.cu)
// share: the H.264 quantiser tables and their integer quant / dequant
// forms, zigzag and Hadamard indexing, and small vector helpers.  Each
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

}  // namespace
