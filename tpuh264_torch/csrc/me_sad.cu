// K1: stage-A integer motion search -- the exact SAD table over the +-8
// grid on the stride-2 subsample.
//
// Replaces: tpuh264/kernels/me_pallas.py `_kernel` (pallas_call at
// me_pallas.py:139, entry `sad_field` :103).
//
// What it computes: for every 16x16 MB of every stream, its 8x8 even-
// sample subsample against the G half-pel plane (edge-padded by 13) at
// all 289 offsets (dy-major), written as int32 [S, R, C, 289] -- the
// layout of the plain version `me_cuda._sad_field` and of the winner
// selection that consumes it.  Samples must lie in [0, 255] (uint8
// sources, clamped half-pel planes): they are packed four to a word.
//
// What bounds it on the H100: device memory.  At 1080p x 4 it reads the
// even source samples (8.4 MB as int32) and the window of the G plane
// that the candidates reach (1103 x 1935 a stream, 34.1 MB) and writes
// the 37.7 MB table: 80.2 MB, 24.0 us at 3.35 TB/s.  The arithmetic
// is 0.60 G absolute differences, 150 M four-byte SIMD sums.
//
// Design: one block per (stream, pair of MB rows, tile of 8 MBs), 288
// threads (17 candidate rows x 8 MBs x 2 column phases, in 9 warps).
//  * The 47-row reference strip the two rows' candidates touch is staged
//    once as BYTES, split into its two column phases: a candidate's 8
//    stride-2 samples of one row are then 8 consecutive bytes of one
//    phase row, two 32-bit words after a funnel shift.  Staging two MB
//    rows at a time reads the strip's 15 shared rows once, not twice.
//  * Thread (dy, MB, phase) holds the MB's 64 subsampled source samples
//    as 16 words in registers and evaluates the 9 (even phase) or 8 (odd
//    phase) candidates dx = 2j + phase of its row dy from the same four
//    reference words per source row: 2 shared loads, 9 funnel shifts and
//    up to 18 `vabsdiff4.add` per source row for 9 candidates.  A half-
//    warp is the 8 MBs x 2 phases of one dy; the phase planes sit 16
//    banks apart, so its loads are conflict-free.
//  * Results go through a shared tile (MB stride 290 words) and leave as
//    the tile's contiguous [8, 289] run of the table, coalesced.  Ragged
//    tiles (C % 8) and a last odd MB row are guarded.
//  * Small blocks (32 registers, 18 KB of shared memory) let 6-7 of them
//    share an SM, so one block's loads overlap another's arithmetic.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSR = 8;                  // search range
constexpr int kN = 2 * kSR + 1;         // 17 offsets per axis
constexpr int kNN = kN * kN;            // 289 candidates
constexpr int kPE = 13;                 // plane pad
constexpr int kT = 8;                   // MBs per tile
constexpr int kRB = 2;                  // MB rows per block
constexpr int kRows = 16 * kRB + 15;    // strip rows 16r+5 .. 16(r+kRB)+19
constexpr int kGroups = 2 * kT + 2;     // 8-column groups: 16*kT+15 cols
constexpr int kRowW = 20;               // words per phase row (18 used)
constexpr int kPlaneW = 976;            // words per phase plane (= 16 mod 32)
constexpr int kStageW = 290;            // words per MB in the output tile
constexpr int kWork = kN * kT * 2;      // 272 (dy, MB, phase) threads
constexpr int kThreads = 288;           // whole warps

static_assert(kRows * kRowW <= kPlaneW && kPlaneW % 32 == 16, "planes");
static_assert(kGroups <= kRowW && kWork <= kThreads, "strip row, threads");

// sum over the four bytes of |a - b|, plus c (one SIMD video op)
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

__global__ void __launch_bounds__(kThreads, 6)
    sad_field_kernel(const int32_t* __restrict__ y,
                     const int32_t* __restrict__ g,
                     int32_t* __restrict__ out, int R, int C, int H, int W) {
  __shared__ __align__(16) uint32_t plane[2 * kPlaneW];
  __shared__ __align__(16) uint32_t src[kRB * kT * 16];
  __shared__ int32_t stage[kT * kStageW];
  const int c0 = blockIdx.x * kT;
  const int r0 = blockIdx.y * kRB;
  const int s = blockIdx.z;
  const int Hp = H + 2 * kPE, Wp = W + 2 * kPE;
  const int ncol = min(kT, C - c0);
  const int nrow = min(kRB, R - r0);

  // reference strip -> two byte planes: group q of row yy is strip
  // columns 8q..8q+7; its even columns are word q of phase row 0, its
  // odd columns word q of phase row 1 (byte k = sample 8q + 2k + phase)
  const int32_t* gs =
      g + ((size_t)s * Hp + 16 * r0 + kPE - kSR) * Wp + 16 * c0 + kPE - kSR;
  const int xlim = Wp - (16 * c0 + kPE - kSR);  // columns inside the plane
  const int ylim = Hp - (16 * r0 + kPE - kSR);  // rows inside the plane
  for (int i = threadIdx.x; i < kRows * kGroups; i += kThreads) {
    const int yy = i / kGroups, q = i - yy * kGroups;
    const int32_t* row = gs + (size_t)yy * Wp;
    uint32_t ev = 0u, od = 0u;
    if (yy < ylim) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int x = 8 * q + 2 * k;
        ev |= (x < xlim ? (uint32_t)row[x] : 0u) << (8 * k);
        od |= (x + 1 < xlim ? (uint32_t)row[x + 1] : 0u) << (8 * k);
      }
    }
    plane[yy * kRowW + q] = ev;
    plane[kPlaneW + yy * kRowW + q] = od;
  }
  // the tiles' subsampled MBs: word 2*iy + h of MB m of row rb holds
  // samples (2iy, 8h + 2k), k = 0..3, in bytes k
  const int32_t* ys = y + ((size_t)s * H + 16 * r0) * W + 16 * c0;
  for (int i = threadIdx.x; i < kRB * kT * 16; i += kThreads) {
    const int rb = i / (kT * 16), m = (i >> 4) % kT;
    const int iy = (i >> 1) & 7, h = i & 1;
    uint32_t v = 0u;
    if (m < ncol && rb < nrow) {
      const int32_t* p = ys + (size_t)(16 * rb + 2 * iy) * W + 16 * m + 8 * h;
#pragma unroll
      for (int k = 0; k < 4; ++k) v |= (uint32_t)p[2 * k] << (8 * k);
    }
    src[i] = v;
  }
  __syncthreads();

  const int t = threadIdx.x;
  const int ph = t & 1;              // column phase: dx + 8 = 2j + ph
  const int m = (t >> 1) % kT;
  const int dyp = t / (2 * kT);      // dy + 8
  for (int rb = 0; rb < nrow; ++rb) {
    if (m < ncol && t < kWork) {
      uint32_t sv[16];
      const uint4* s4 = reinterpret_cast<const uint4*>(src + 16 * (rb * kT + m));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const uint4 v = s4[k];
        sv[4 * k] = v.x; sv[4 * k + 1] = v.y;
        sv[4 * k + 2] = v.z; sv[4 * k + 3] = v.w;
      }
      uint32_t acc[9];
#pragma unroll
      for (int j = 0; j < 9; ++j) acc[j] = 0u;
      // bytes 8m .. 8m+15 of phase row 16rb + dy + 2iy: candidate j
      // reads bytes 8m+j .. 8m+j+7
      const uint32_t* pr =
          plane + ph * kPlaneW + (16 * rb + dyp) * kRowW + 2 * m;
#pragma unroll
      for (int iy = 0; iy < 8; ++iy) {
        const uint2 lo = *reinterpret_cast<const uint2*>(pr + 2 * iy * kRowW);
        const uint2 hi =
            *reinterpret_cast<const uint2*>(pr + 2 * iy * kRowW + 2);
        const uint32_t w[5] = {lo.x, lo.y, hi.x, hi.y, 0u};  // w[4]: unread
#pragma unroll
        for (int j = 0; j < 9; ++j) {
          const int q = j >> 2, sh = 8 * (j & 3);
          const uint32_t a = sh ? __funnelshift_r(w[q], w[q + 1], sh) : w[q];
          const uint32_t b =
              sh ? __funnelshift_r(w[q + 1], w[q + 2], sh) : w[q + 1];
          acc[j] = sad4(b, sv[2 * iy + 1], sad4(a, sv[2 * iy], acc[j]));
        }
      }
      int32_t* st = stage + m * kStageW + dyp * kN + ph;
#pragma unroll
      for (int j = 0; j < 9; ++j)
        if (2 * j + ph < kN) st[2 * j] = (int32_t)acc[j];
    }
    __syncthreads();
    // the tile's MBs are contiguous in the table: one coalesced run
    int32_t* o = out + (((size_t)s * R + r0 + rb) * C + c0) * kNN;
    for (int i = threadIdx.x; i < ncol * kNN; i += kThreads) {
      const int mm = i / kNN;
      o[i] = stage[mm * kStageW + i - mm * kNN];
    }
    __syncthreads();  // the stage is refilled for the next row
  }
}

}  // namespace

extern "C" int th264_sad_field(const int32_t* y, const int32_t* g,
                               int32_t* out, int s, int h, int w,
                               void* stream) {
  const int R = h / 16, C = w / 16;
  dim3 grid((C + kT - 1) / kT, (R + kRB - 1) / kRB, s);
  sad_field_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      y, g, out, R, C, h, w);
  return (int)cudaGetLastError();
}

extern "C" const char* th264_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
