// K11: the P frame's reference build -- the four half-pel planes (G, b,
// h, j) of every luma reference and its two chroma planes, padded -- one
// launch over all N references.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py
// `build_halfpel_planes` (:111) with `_pad_ref` (:133), and
// `build_halfpel_planes_ext` (:146) with `_pad_ref_ext` (:174) for a
// row-sharded DPB (called :660-675 in the encode, :1037-1050 in the
// decode), not a pallas_call.  Its plain PyTorch version is
// kernels/pframe.py `_references_plain`.
//
// What it computes, exactly as the plain version.  With R(y, x) the
// reference sample at output position (y, x), rows and columns clamped
// into the source (the normative Clip3 of 8.4.2.2):
//     R(y, x) = src[clamp(y - oy, 0, Hs - 1)][clamp(x - 13, 0, W - 1)]
// where the frame itself is the source (oy = 13 = HALO_Y, Hs = H) or,
// with `halo`, the reference already extended by HALO_Y rows a side
// (oy = 0, Hs = H + 26: the rows a row-sharded DPB exchanges; its outer 3
// output rows replicate its edge rows, as the plain version's 6-tap
// margin does), each plane [Hs + 2 oy, W + 26] int32:
//     G = R(y, x),
//     b = clip((B1(y, x) + 16) >> 5),  B1(y, x) = tap6 of R(y, x-2 .. x+3)
//     h = clip((tap6 of R(y-2 .. y+3, x) + 16) >> 5)
//     j = clip((tap6 of B1(y-2 .. y+3, x) + 512) >> 10)
// with tap6 = (1, -5, 20, 20, -5, 1) and clip to 0..255; all in int32
// (|B1| <= 10,710 and |tap6 of B1| <= 557,000 for samples in 0..255, and
// exact for any int32 sample the plain version would not overflow on).
// Chroma: src[clamp(y - oyc, 0, Hcs - 1)][clamp(x - 8, 0, Wc - 1)], oyc
// = 8 = HALO_C without `halo`, 0 with it.  The outputs are one [N, 4, S,
// Hp, Wp] and one [N, 2, S, Hcp, Wcp] buffer, in the layout of the plain
// version's lists (K1, K9 and K10 read them unchanged).  Each reference's
// three planes come by their own pointers, newest first: the GOP
// pipeline passes the slots of its uint8 DPB rings as they lie.
//
// What bounds it on the H100: bytes.  It reads the references (int32 or
// uint8) and writes four int32 luma planes and two int32 chroma planes a
// reference: at 1080p x 4 with one reference 33 + 17 MB in and 138 + 17
// MB out, ~205 MB or 0.061 ms at 3.35 TB/s.  Its arithmetic is 24
// integer multiply-adds a luma sample.
//
// Design: a 256-thread block a 32 x 64 tile of one (reference, stream)
// plane, and after those the chroma blocks, in one grid.
//  * The tile's reference samples with their 6-tap margin (37 x 69) are
//    staged once in shared memory, the clamps applied there; B1 of its 37
//    rows is computed once into shared memory, so h and j are column
//    passes over shared rows.  Consecutive lanes take consecutive
//    columns: every shared access is conflict-free and every global
//    store a warp makes is 32 consecutive int32 of one plane row.
//  * Stores are scalar: a plane row is W + 26 int32 long, not a multiple
//    of four, so no row start is 16-byte aligned.
//  * Chroma is a clamped copy, 8 samples a thread, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPE = 13;        // luma plane pad (pframe._PE)
constexpr int kCP = 8;         // chroma pad (pframe._CP)
constexpr int kTX = 64;        // output columns a tile
constexpr int kTY = 32;        // output rows a tile
constexpr int kThreads = 256;  // a block
constexpr int kRW = kTX + 5;   // staged columns x0-2 .. x0+kTX+2
constexpr int kRH = kTY + 5;   // staged rows y0-2 .. y0+kTY+2
constexpr int kChroma = 8;     // chroma samples a thread
constexpr int kMaxRefs = 16;   // H.264's most references

struct RefArgs {
  // reference n's planes [S, Hs, W], [S, Hcs, Wc] x 2, newest first (the
  // DPB's slots by pointer; unused entries null)
  const void *y[kMaxRefs], *u[kMaxRefs], *v[kMaxRefs];
  int32_t* planes;        // [N, 4, S, Hp, Wp]
  int32_t* chroma;        // [N, 2, S, Hcp, Wcp]
  int N, S, Hs, W, oy, Hcs, Wc, oyc, u8;
  int Hp, Wp, Hcp, Wcp, tiles_x, tiles_y, luma_blocks, blocks;
};

constexpr int kPtrs = 3 * kMaxRefs + 2;
constexpr int kInts = 9;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k11_operands` builds them.
inline RefArgs ref_args(void* const* p, const int* n) {
  RefArgs a;
  for (int k = 0; k < kMaxRefs; ++k) {
    a.y[k] = p[k];
    a.u[k] = p[kMaxRefs + k];
    a.v[k] = p[2 * kMaxRefs + k];
  }
  a.planes = static_cast<int32_t*>(p[3 * kMaxRefs]);
  a.chroma = static_cast<int32_t*>(p[3 * kMaxRefs + 1]);
  a.N = n[0], a.S = n[1], a.Hs = n[2], a.W = n[3], a.oy = n[4];
  a.Hcs = n[5], a.Wc = n[6], a.oyc = n[7], a.u8 = n[8];
  a.Hp = a.Hs + 2 * a.oy, a.Wp = a.W + 2 * kPE;
  a.Hcp = a.Hcs + 2 * a.oyc, a.Wcp = a.Wc + 2 * kCP;
  a.tiles_x = (a.Wp + kTX - 1) / kTX, a.tiles_y = (a.Hp + kTY - 1) / kTY;
  a.luma_blocks = a.N * a.S * a.tiles_x * a.tiles_y;
  const long long chroma = 2LL * a.N * a.S * a.Hcp * a.Wcp;
  a.blocks = a.luma_blocks +
             (int)((chroma + kThreads * kChroma - 1) / (kThreads * kChroma));
  return a;
}

__device__ __forceinline__ int src_at(const void* p, int u8, size_t i) {
  return u8 ? (int)static_cast<const uint8_t*>(p)[i]
            : static_cast<const int32_t*>(p)[i];
}

__device__ __forceinline__ int tap6(int a, int b, int c, int d, int e,
                                    int f) {
  return a - 5 * b + 20 * c + 20 * d - 5 * e + f;
}

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }

// The 32 x 64 output tile `t` of plane pl = n * S + s.
__device__ void luma_tile(const RefArgs& a, int pl, int t) {
  __shared__ int sr[kRH][kRW];  // R(y0 - 2 + i, x0 - 2 + j)
  __shared__ int sb[kRH][kTX];  // B1(y0 - 2 + i, x0 + j)
  const int y0 = (t / a.tiles_x) * kTY, x0 = (t % a.tiles_x) * kTX;
  const int n = pl / a.S, s = pl - n * a.S;
  const void* ref = a.y[n];
  const size_t src = (size_t)s * a.Hs * a.W;
  for (int i = threadIdx.x; i < kRH * kRW; i += kThreads) {
    const int ry = i / kRW, rx = i - ry * kRW;
    const int sy = min(max(y0 - 2 + ry - a.oy, 0), a.Hs - 1);
    const int sx = min(max(x0 - 2 + rx - kPE, 0), a.W - 1);
    sr[ry][rx] = src_at(ref, a.u8, src + (size_t)sy * a.W + sx);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRH * kTX; i += kThreads) {
    const int ry = i / kTX, rx = i - ry * kTX;
    const int* r = &sr[ry][rx];
    sb[ry][rx] = tap6(r[0], r[1], r[2], r[3], r[4], r[5]);
  }
  __syncthreads();
  const int lx = threadIdx.x % kTX, x = x0 + lx;
  if (x >= a.Wp) return;
  const size_t plane = (size_t)a.Hp * a.Wp, step = (size_t)a.S * plane;
  int32_t* o = a.planes + (size_t)n * 4 * step + s * plane + x;
  for (int ly = threadIdx.x / kTX; ly < kTY && y0 + ly < a.Hp;
       ly += kThreads / kTX) {
    const int g = sr[ly + 2][lx + 2];
    const int b = clip255((sb[ly + 2][lx] + 16) >> 5);
    const int h = clip255((tap6(sr[ly][lx + 2], sr[ly + 1][lx + 2],
                                sr[ly + 2][lx + 2], sr[ly + 3][lx + 2],
                                sr[ly + 4][lx + 2], sr[ly + 5][lx + 2]) +
                           16) >> 5);
    const int j = clip255((tap6(sb[ly][lx], sb[ly + 1][lx], sb[ly + 2][lx],
                                sb[ly + 3][lx], sb[ly + 4][lx],
                                sb[ly + 5][lx]) +
                           512) >> 10);
    int32_t* q = o + (size_t)(y0 + ly) * a.Wp;
    q[0] = g;
    q[step] = b;
    q[2 * step] = h;
    q[3 * step] = j;
  }
}

// Chroma block cb: kThreads * kChroma consecutive output samples of the
// [N, 2, S, Hcp, Wcp] buffer, a thread every kThreads-th.
__device__ void chroma_part(const RefArgs& a, int cb) {
  const size_t plane = (size_t)a.Hcp * a.Wcp;
  const size_t total = 2 * (size_t)a.N * a.S * plane;
  for (int k = 0; k < kChroma; ++k) {
    const size_t e = ((size_t)cb * kChroma + k) * kThreads + threadIdx.x;
    if (e >= total) return;
    const size_t pl = e / plane;  // (2 n + c) * S + s
    const int rem = (int)(e - pl * plane);
    const int y = rem / a.Wcp, x = rem - y * a.Wcp;
    const int s = (int)(pl % a.S), nc = (int)(pl / a.S);
    const int sy = min(max(y - a.oyc, 0), a.Hcs - 1);
    const int sx = min(max(x - kCP, 0), a.Wc - 1);
    const size_t i = (size_t)s * a.Hcs * a.Wc + (size_t)sy * a.Wc + sx;
    a.chroma[e] = src_at((nc & 1 ? a.v : a.u)[nc >> 1], a.u8, i);
  }
}

__global__ void __launch_bounds__(kThreads)
    halfpel_kernel(const __grid_constant__ RefArgs a) {
  const int b = blockIdx.x;
  const int per = a.tiles_x * a.tiles_y;
  if (b < a.luma_blocks)
    luma_tile(a, b / per, b % per);
  else
    chroma_part(a, b - a.luma_blocks);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_refs_kernels.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `ref_args`' order (host
// arrays).
extern "C" int th264_halfpel_refs(void* const* p, const int* n,
                                  void* stream) {
  const RefArgs a = ref_args(p, n);
  halfpel_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
