// K15: the device source -- frames t .. t + k - 1 of every stream, luma
// [k, S, H, W] and chroma [k, S, H/2, W/2] uint8, of the three kinds
// "rigid", "noise" and "moving_gradient", in one launch.
//
// Replaces: tpuh264/engine/sources.py `_device_source_gop` (:143), which
// the JAX package compiles into its dispatch program (called at
// tpuh264/engine/devpipe.py:535); not a pallas_call.  Its plain version
// is `engine/sources.py` `_device_source_gop_plain`, a chain of ~57
// separately rounded float32 / int ATen ops.
//
// What it computes, sample for sample as that chain does on the card:
//  * "rigid": with xf = x - 2 t, yf = y - t, ph = 1.7 s (float32),
//      Y = clamp(128 + 46 sin(xf/17 + ph) cos(yf/23) + 34 sin((xf + yf)
//          / 7.1 + ph) + 18 cos(xf/3.3) sin(yf/4.7 + ph), 0, 255),
//    and with x2 = 2c - t, y2 = 2r - t/2 at chroma column c, row r,
//      U = 128 + 44 sin(x2/19 + ph) cos(y2/13),
//      V = 128 + 44 cos(x2/11 - ph) sin(y2/29),
//    each truncated to uint8.  Every operation is its own IEEE float32
//    rounding, in the plain version's order, left to right: products and
//    sums by __fmul_rn / __fadd_rn / __fsub_rn, which nvcc never
//    contracts into an FMA.  ATen's CUDA division by a Python scalar is a
//    product with the scalar's float32 reciprocal (BinaryDivTrueKernel.cu:
//    `a * (1 / b)` for a CPU scalar b), so `xf / 17.0` here is xf times
//    the float32 1 / 17, computed on the host as ATen computes it.  sinf
//    and cosf are CUDA's accurate ones (ATen's ::sin / ::cos on floats),
//    never __sinf.
//  * "noise": the int32 hash of `_hash_noise` (sources.py:33) of (x +
//    97 s, y, t) for luma and (2c + 97 s + 7, 2r + 3, t), (2c + 97 s +
//    13, 2r + 11, t) for U and V, in wrapping 32-bit arithmetic.
//  * "moving_gradient": Y = (2x + y + 7t + 37s) mod 256; U = 128 + 47
//    sin((2c + 3t + 11s) / 37), V = 128 + 47 cos((2r - 5t + 13s) / 29).
//
// What bounds it on the H100: bytes for "noise" and "moving_gradient"
// (the frames out, 1.5 k S H W bytes: 50.1 MB at 1080p x 4 x 4 frames,
// 0.0150 ms at 3.35 TB/s), instruction issue for "rigid": computed
// sample by sample, the field takes 5 sinf / cosf a luma sample and 2 a
// chroma sample, each 24 instructions on its fast path (~0.2 ms of issue
// at 1080p x 4); with the tables below, one sinf and ~13 more
// instructions a luma sample (~0.04 ms).
//
// Design: a block of 256 threads makes a tile of 128 columns x 32 rows of
// one plane of one (frame, stream) -- a 16-byte chunk of a row a thread,
// written with one 16-byte store; a chroma block makes the U and the V
// tile together.  The rigid field is separable but for one term: every
// factor that depends on the column alone (46 sin(xf/17 + ph), 18
// cos(xf/3.3), xf) or on the row alone (cos(yf/23), sin(yf/4.7 + ph),
// yf) is computed once a tile into shared memory -- the same roundings,
// so the same values -- and a sample then costs one sinf (the diagonal
// term) and six float operations; a chroma sample costs two products and
// two sums.  The moving gradient's chroma is a function of the column (U)
// or the row (V) alone and comes from the same tables.  The blocks are
// ordered luma tiles then chroma tiles of (frame 0, stream 0), then the
// next stream, then the next frame.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTileW = 128;  // columns a tile: 8 chunks of 16 bytes
constexpr int kTileH = 32;   // rows a tile: a chunk a thread
enum { kRigid = 0, kNoise = 1, kGradient = 2 };

struct SrcArgs {
  uint8_t *y, *u, *v;  // [k, S, H, W], [k, S, H/2, W/2] x 2
  int W, H, S, k, t, kind;
  int ltx, lty, ctx, cty;  // luma / chroma tiles across and down
  int per, blocks;         // tiles a (frame, stream), all blocks
  // the float32 reciprocals of the plain version's Python divisors, and
  // its phase step 1.7, as ATen rounds them
  float inv17, inv23, inv71, inv33, inv47, inv19, inv13, inv11, inv29,
      inv37, k17;
};

constexpr int kPtrs = 3;
constexpr int kInts = 6;

// The arguments from the entry's pointer and int arrays, in the order
// engine/sources.py `_k15_operands` builds them.
inline SrcArgs source_args(void* const* p, const int* n) {
  SrcArgs a;
  a.y = static_cast<uint8_t*>(p[0]);
  a.u = static_cast<uint8_t*>(p[1]);
  a.v = static_cast<uint8_t*>(p[2]);
  a.W = n[0], a.H = n[1], a.S = n[2], a.k = n[3], a.t = n[4], a.kind = n[5];
  a.ltx = (a.W + kTileW - 1) / kTileW, a.lty = (a.H + kTileH - 1) / kTileH;
  a.ctx = (a.W / 2 + kTileW - 1) / kTileW;
  a.cty = (a.H / 2 + kTileH - 1) / kTileH;
  a.per = a.ltx * a.lty + a.ctx * a.cty;
  a.blocks = a.per * a.S * a.k;
  // a / b for a CPU scalar b is a * (1 / b) in float32 (ATen)
  const float one = 1.0f;
  a.inv17 = one / (float)17.0, a.inv23 = one / (float)23.0;
  a.inv71 = one / (float)7.1, a.inv33 = one / (float)3.3;
  a.inv47 = one / (float)4.7, a.inv19 = one / (float)19.0;
  a.inv13 = one / (float)13.0, a.inv11 = one / (float)11.0;
  a.inv29 = one / (float)29.0, a.inv37 = one / (float)37.0;
  a.k17 = (float)1.7;
  return a;
}

// wrapping 32-bit int arithmetic (what int32 tensors do), free of
// signed-overflow UB
__device__ __forceinline__ int wadd(int a, int b) {
  return (int)((unsigned)a + (unsigned)b);
}
__device__ __forceinline__ int wsub(int a, int b) {
  return (int)((unsigned)a - (unsigned)b);
}
__device__ __forceinline__ int wmul(int a, int b) {
  return (int)((unsigned)a * (unsigned)b);
}

// `_hash_noise(a, b, c)`: the low byte of the int32 hash
__device__ __forceinline__ uint32_t hash_noise(int a, int b, int c) {
  int h = wadd(wadd(wmul(a, 1664525), wmul(b, 1013904223)), wmul(c, 69069));
  h ^= h >> 13;  // arithmetic shifts of the signed value
  h = wadd(wmul(h, 1103515245), 12345);
  h ^= h >> 7;
  return (uint32_t)h & 255u;
}

// float -> uint8 as ATen converts (through int64: truncation); every
// value here lies in 0 .. 255
__device__ __forceinline__ uint32_t to_u8(float f) {
  return (uint32_t)__float2int_rz(f) & 255u;
}

// sixteen bytes (four words, byte i of word i / 4 at bits 8 (i % 4)) to
// row `dst` at column x of a row of `w` bytes: one 16-byte store where
// the chunk is whole and aligned, else bytewise (unrolled, so that q
// stays in registers)
__device__ __forceinline__ void store16(uint8_t* dst, int x, int w,
                                        const uint32_t (&q)[4]) {
  if (x + 16 <= w && ((uintptr_t)dst & 15) == 0) {
    *reinterpret_cast<uint4*>(dst) = make_uint4(q[0], q[1], q[2], q[3]);
    return;
  }
#pragma unroll
  for (int i = 0; i < 16; ++i)
    if (x + i < w) dst[i] = (uint8_t)(q[i >> 2] >> (8 * (i & 3)));
}

// sample c of a chunk into its byte of q
__device__ __forceinline__ void put(uint32_t (&q)[4], int c, uint32_t s) {
  q[c >> 2] |= s << (8 * (c & 3));
}

__global__ void __launch_bounds__(kThreads)
    source_kernel(const __grid_constant__ SrcArgs a) {
  // the tile's column (x) and row (y) factors
  __shared__ float tx[3][kTileW];
  __shared__ float ty[3][kTileH];
  const int b = blockIdx.x;
  const int fs = b / a.per, tile = b - fs * a.per;
  const int fi = fs / a.S, si = fs - fi * a.S;
  const int ti = wadd(a.t, fi);
  const bool luma = tile < a.ltx * a.lty;
  const int tl = luma ? tile : tile - a.ltx * a.lty;
  const int ntx = luma ? a.ltx : a.ctx;
  const int x0 = (tl % ntx) * kTileW, y0 = (tl / ntx) * kTileH;
  const int w = luma ? a.W : a.W / 2, h = luma ? a.H : a.H / 2;
  const int i = (int)threadIdx.x;
  const float tf = __int2float_rn(ti);
  const float ph = __fmul_rn(__int2float_rn(si), a.k17);

  if (a.kind != kNoise) {
    if (i < kTileW) {
      const int x = x0 + i;
      if (a.kind == kRigid && luma) {
        const float xf = __fsub_rn(__int2float_rn(x), __fmul_rn(tf, 2.0f));
        tx[0][i] = __fmul_rn(46.0f, sinf(__fadd_rn(__fmul_rn(xf, a.inv17),
                                                   ph)));
        tx[1][i] = __fmul_rn(18.0f, cosf(__fmul_rn(xf, a.inv33)));
        tx[2][i] = xf;
      } else if (a.kind == kRigid) {
        const float x2 =
            __fsub_rn(__int2float_rn(2 * x), __fmul_rn(tf, 1.0f));
        tx[0][i] = __fmul_rn(44.0f, sinf(__fadd_rn(__fmul_rn(x2, a.inv19),
                                                   ph)));
        tx[1][i] = __fmul_rn(44.0f, cosf(__fsub_rn(__fmul_rn(x2, a.inv11),
                                                   ph)));
      } else if (!luma) {  // the moving gradient's U, a column's
        const int n = wadd(wadd(2 * x, wmul(ti, 3)), wmul(si, 11));
        tx[0][i] = __fadd_rn(
            __fmul_rn(47.0f, sinf(__fmul_rn(__int2float_rn(n), a.inv37))),
            128.0f);
      }
    } else if (i < kTileW + kTileH) {
      const int j = i - kTileW, y = y0 + j;
      if (a.kind == kRigid && luma) {
        const float yf = __fsub_rn(__int2float_rn(y), __fmul_rn(tf, 1.0f));
        ty[0][j] = cosf(__fmul_rn(yf, a.inv23));
        ty[1][j] = sinf(__fadd_rn(__fmul_rn(yf, a.inv47), ph));
        ty[2][j] = yf;
      } else if (a.kind == kRigid) {
        const float y2 =
            __fsub_rn(__int2float_rn(2 * y), __fmul_rn(tf, 0.5f));
        ty[0][j] = cosf(__fmul_rn(y2, a.inv13));
        ty[1][j] = sinf(__fmul_rn(y2, a.inv29));
      } else if (!luma) {  // the moving gradient's V, a row's
        const int n = wadd(wsub(2 * y, wmul(ti, 5)), wmul(si, 13));
        ty[0][j] = __fadd_rn(
            __fmul_rn(47.0f, cosf(__fmul_rn(__int2float_rn(n), a.inv29))),
            128.0f);
      }
    }
    __syncthreads();
  }

  const int r = i >> 3, cx = (i & 7) * 16;
  const int x = x0 + cx, y = y0 + r;
  if (x >= w || y >= h) return;
  const size_t row = ((size_t)fs * h + y) * w + x;
  uint32_t q[4] = {0, 0, 0, 0}, p[4] = {0, 0, 0, 0};
  if (luma) {
    if (a.kind == kRigid) {
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const int k = cx + c;
        const float d = sinf(__fadd_rn(
            __fmul_rn(__fadd_rn(tx[2][k], ty[2][r]), a.inv71), ph));
        float f = __fadd_rn(__fmul_rn(tx[0][k], ty[0][r]), 128.0f);
        f = __fadd_rn(f, __fmul_rn(34.0f, d));
        f = __fadd_rn(f, __fmul_rn(tx[1][k], ty[1][r]));
        put(q, c, to_u8(fminf(fmaxf(f, 0.0f), 255.0f)));
      }
    } else if (a.kind == kNoise) {
      const int xs = wadd(x, wmul(si, 97));
#pragma unroll
      for (int c = 0; c < 16; ++c) put(q, c, hash_noise(wadd(xs, c), y, ti));
    } else {
      const int g = wadd(wadd(wadd(2 * x, y), wmul(ti, 7)), wmul(si, 37));
#pragma unroll
      for (int c = 0; c < 16; ++c) put(q, c, (uint32_t)wadd(g, 2 * c) & 255u);
    }
    store16(a.y + row, x, w, q);
    return;
  }
  if (a.kind == kRigid) {
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      const int k = cx + c;
      put(q, c, to_u8(__fadd_rn(__fmul_rn(tx[0][k], ty[0][r]), 128.0f)));
      put(p, c, to_u8(__fadd_rn(__fmul_rn(tx[1][k], ty[1][r]), 128.0f)));
    }
  } else if (a.kind == kNoise) {
    const int xs = wadd(2 * x, wmul(si, 97));
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      put(q, c, hash_noise(wadd(xs, 2 * c + 7), 2 * y + 3, ti));
      put(p, c, hash_noise(wadd(xs, 2 * c + 13), 2 * y + 11, ti));
    }
  } else {
    const uint32_t v = to_u8(ty[0][r]);
#pragma unroll
    for (int c = 0; c < 16; ++c) {
      put(q, c, to_u8(tx[0][cx + c]));
      put(p, c, v);
    }
  }
  store16(a.u + row, x, w, q);
  store16(a.v + row, x, w, p);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_source.py runs the rest
                   // above on CPU threads, compiled by g++ against shims

// p: kPtrs device pointers, n: kInts ints, in `source_args`' order (host
// arrays): one launch.
extern "C" int th264_source(void* const* p, const int* n, void* stream) {
  const SrcArgs a = source_args(p, n);
  if (a.W < 2 || a.H < 2 || a.W % 2 || a.H % 2 || a.S < 1 || a.k < 1 ||
      a.kind < kRigid || a.kind > kGradient)
    return (int)cudaErrorInvalidValue;
  source_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
