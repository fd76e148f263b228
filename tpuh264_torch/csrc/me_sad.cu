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
// selection that consumes it.  Source samples must lie in [0, 255]
// (uint8 pictures): they are packed four to a word.  The G plane is the
// uint8 plane K11 writes (kernels/pframe.py `_references`): rows 16-byte
// aligned, `lp` bytes apart (Wp = W + 26 rounded up to 16); the bytes
// past Wp are no samples and are never read as such.
//
// What bounds it on the H100: device memory.  At 1080p x 4 it reads the
// even source samples (8.4 MB as int32) and the window of the G plane
// that the candidates reach (1103 x 1935 bytes a stream, 8.5 MB) and
// writes the 37.7 MB table: 54.6 MB, 16.3 us at 3.35 TB/s.  The
// arithmetic is 0.60 G absolute differences, 150 M four-byte SIMD sums.
//
// Design: one block per (stream, pair of MB rows, tile of 8 MBs), 288
// threads (17 candidate rows x 8 MBs x 2 column phases, in 9 warps).
//  * The 47-row reference strip the two rows' candidates touch is staged
//    once as BYTES, split into its two column phases: a candidate's 8
//    stride-2 samples of one row are then 8 consecutive bytes of one
//    phase row, two 32-bit words after a funnel shift.  Staging two MB
//    rows at a time reads the strip's 15 shared rows once, not twice.
//    A staging thread reads 24 bytes of a strip row from the byte plane
//    (a 16-byte and an 8-byte load at aligned columns) and splits two
//    8-sample groups into their phases with byte permutes; samples past
//    the plane's width (its pitch bytes, or past the last row) stage 0.
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

struct SadArgs {
  const int32_t* y;  // source [S, H, W]
  const uint8_t* g;  // G plane [S, Hp, lp] (the first Wp bytes samples)
  int32_t* out;      // [S, R, C, 289]
  int S, H, W, lp, R, C, tiles_x, tiles_y, blocks;
};

constexpr int kPtrs = 3;
constexpr int kInts = 4;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/me_cuda.py `sad_field` builds them: (y, g, out), (S, H, W, lp).
inline SadArgs sad_args(void* const* p, const int* n) {
  SadArgs a;
  a.y = static_cast<const int32_t*>(p[0]);
  a.g = static_cast<const uint8_t*>(p[1]);
  a.out = static_cast<int32_t*>(p[2]);
  a.S = n[0], a.H = n[1], a.W = n[2], a.lp = n[3];
  a.R = a.H / 16, a.C = a.W / 16;
  a.tiles_x = (a.C + kT - 1) / kT, a.tiles_y = (a.R + kRB - 1) / kRB;
  a.blocks = a.tiles_x * a.tiles_y * a.S;
  return a;
}

// sum over the four bytes of |a - b|, plus c (one SIMD video op)
__device__ __forceinline__ uint32_t sad4(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  uint32_t d;
  asm("vabsdiff4.u32.u32.u32.add %0, %1, %2, %3;"
      : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
#else
  return __vsadu4(a, b) + c;
#endif
}

// w with its bytes at plane columns >= lim zeroed, `first` the column of
// its lowest byte
__device__ __forceinline__ uint32_t keep_below(uint32_t w, int first,
                                               int lim) {
  const int nb = lim - first;  // the word's bytes inside the plane
  return nb >= 4 ? w : nb <= 0 ? 0u : w & ((1u << (8 * nb)) - 1u);
}

__global__ void __launch_bounds__(kThreads, 6)
    sad_field_kernel(const __grid_constant__ SadArgs a) {
  __shared__ __align__(16) uint32_t plane[2 * kPlaneW];
  __shared__ __align__(16) uint32_t src[kRB * kT * 16];
  __shared__ int32_t stage[kT * kStageW];
  const int R = a.R, C = a.C, H = a.H, W = a.W;
  const int bx = blockIdx.x % a.tiles_x;
  const int by = (blockIdx.x / a.tiles_x) % a.tiles_y;
  const int s = blockIdx.x / (a.tiles_x * a.tiles_y);
  const int c0 = bx * kT;
  const int r0 = by * kRB;
  const int Hp = H + 2 * kPE, Wp = W + 2 * kPE;
  const int ncol = min(kT, C - c0);
  const int nrow = min(kRB, R - r0);
  const int32_t* __restrict__ y = a.y;
  int32_t* __restrict__ out = a.out;

  // reference strip -> two byte planes: group q of row yy is strip
  // columns 8q..8q+7 (plane columns 16 c0 + 5 + 8q ..); its even columns
  // are word q of phase row 0, its odd columns word q of phase row 1
  // (byte k = sample 8q + 2k + phase).  Thread item (yy, c) reads plane
  // columns 16 c0 + 16c .. + 23 as words w[0..5] and splits groups 2c
  // (its words 1-3) and 2c + 1 (words 3-5).
  const uint8_t* gs = a.g + ((size_t)s * Hp + 16 * r0 + kPE - kSR) * a.lp +
                      16 * c0;
  const int ylim = Hp - (16 * r0 + kPE - kSR);  // rows inside the plane
  for (int i = threadIdx.x; i < kRows * kGroups / 2; i += kThreads) {
    const int yy = i / (kGroups / 2), c = i - yy * (kGroups / 2);
    const int col = 16 * c0 + 16 * c;  // plane column of w[0]
    uint32_t w[6] = {0u, 0u, 0u, 0u, 0u, 0u};
    if (yy < ylim) {
      const uint8_t* row = gs + (size_t)yy * a.lp + 16 * c;
      if (col + 16 <= a.lp) {
        const uint4 v = *reinterpret_cast<const uint4*>(row);
        w[0] = v.x, w[1] = v.y, w[2] = v.z, w[3] = v.w;
      }
      if (col + 24 <= a.lp) {
        const uint2 v = *reinterpret_cast<const uint2*>(row + 16);
        w[4] = v.x, w[5] = v.y;
      }
      if (col + 24 > Wp) {  // the plane's last columns: no pitch byte
#pragma unroll
        for (int k = 0; k < 6; ++k) w[k] = keep_below(w[k], col + 4 * k, Wp);
      }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const uint32_t wa = w[2 * h + 1], wb = w[2 * h + 2], wc = w[2 * h + 3];
      const int q = 2 * c + h;
      plane[yy * kRowW + q] = __byte_perm(wa, wb, 0x7531);
      plane[kPlaneW + yy * kRowW + q] =
          __byte_perm(__byte_perm(wa, wb, 0x0642), wc, 0x4210);
    }
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
          const uint32_t c0w =
              sh ? __funnelshift_r(w[q], w[q + 1], sh) : w[q];
          const uint32_t c1w =
              sh ? __funnelshift_r(w[q + 1], w[q + 2], sh) : w[q + 1];
          acc[j] = sad4(c1w, sv[2 * iy + 1], sad4(c0w, sv[2 * iy], acc[j]));
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

#ifdef __CUDACC__  // the entries; tests/test_torch_me.py runs the rest
                   // above on CPU threads, compiled by g++ against shims

// p: kPtrs device pointers, n: kInts ints, in `sad_args`' order (host
// arrays).
extern "C" int th264_sad_field(void* const* p, const int* n, void* stream) {
  const SadArgs a = sad_args(p, n);
  sad_field_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

extern "C" const char* th264_cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

#endif  // __CUDACC__
