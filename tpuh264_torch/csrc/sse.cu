// K14: the decoder's SSE -- for every frame f of a dispatch and decode
// stream d, the sum over the luma plane of (decoded - source)^2, exact in
// 64 bits, in one launch.
//
// Replaces: the SSE the JAX package computes in its decode program
// (tpuh264/engine/devpipe.py :692-696, float32 there), not a pallas_call.
// Its plain version is `kernels/sse.py` `_sse_plain` (int64 in PyTorch).
//
// What it computes: out[f, d] = sum_{y, x} (dec_f[d, y, x] - src[f, d /
// fanout, y, x])^2 for the k decoded luma planes dec_f [S, H, W] uint8
// (one pointer a frame: the deblocked outputs the decode keeps) against
// the dispatch's source frames src [k, S / fanout, H, W] uint8 -- decode
// stream d carries encoded stream d / fanout --, or against zeros where
// src is null (host-fed frames, measured by the caller).
//
// What bounds it on the H100: bytes.  It reads every decoded and source
// sample once, 2 k S H W bytes: 66.8 MB at an interior 1080p x 4
// dispatch, ~20 us at 3.35 TB/s; the arithmetic is 3 operations a byte.
//
// Design: a block of kThreads threads takes kVec 16-byte vectors a
// thread of one plane (32 KB of it), vector j of thread t at (part * kVec
// + j) * kThreads + t, so a warp's loads are one 512-byte run; each
// thread sums its squares in 32 bits (at most 16 * kVec * 255^2 < 2^27),
// the warp by one redux.sync (< 2^32), and one 64-bit atomic add a warp
// lands it on the plane's total, which the entry zeroes first.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxFrames = 16;
constexpr int kThreads = 256;
constexpr int kVec = 8;  // 16-byte vectors a thread
constexpr unsigned kFull = 0xffffffffu;

struct SseArgs {
  const uint8_t* dec[kMaxFrames];  // frame f's decoded luma [S, H, W]
  const uint8_t* src;              // [k, S / fanout, H, W], or null
  unsigned long long* out;         // [k, S]
  int k, S, fanout, plane;         // plane = H * W, a multiple of 16
  int parts, blocks;               // blocks a plane, all blocks
};

constexpr int kPtrs = kMaxFrames + 2;
constexpr int kInts = 4;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/sse.py `_k14_operands` builds them (unused frames null).
inline SseArgs sse_args(void* const* p, const int* n) {
  SseArgs a;
  for (int f = 0; f < kMaxFrames; ++f)
    a.dec[f] = static_cast<const uint8_t*>(p[f]);
  a.src = static_cast<const uint8_t*>(p[kMaxFrames]);
  a.out = static_cast<unsigned long long*>(p[kMaxFrames + 1]);
  a.k = n[0], a.S = n[1], a.fanout = n[2], a.plane = n[3];
  const int per = 16 * kVec * kThreads;
  a.parts = (a.plane + per - 1) / per;
  a.blocks = a.k * a.S * a.parts;
  return a;
}

__device__ __forceinline__ uint32_t sq_diff(uint32_t x, uint32_t y) {
  uint32_t s = 0;
#pragma unroll
  for (int i = 0; i < 32; i += 8) {
    const int d = (int)((x >> i) & 255u) - (int)((y >> i) & 255u);
    s += (uint32_t)(d * d);
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
    sse_kernel(const __grid_constant__ SseArgs a) {
  const int b = blockIdx.x;
  const int pl = b / a.parts, part = b - pl * a.parts;
  const int f = pl / a.S, d = pl - f * a.S;
  const uint4* x =
      reinterpret_cast<const uint4*>(a.dec[f] + (size_t)d * a.plane);
  const uint4* y =
      a.src ? reinterpret_cast<const uint4*>(
                  a.src + ((size_t)f * (a.S / a.fanout) + d / a.fanout) *
                              a.plane)
            : nullptr;
  const int n16 = a.plane / 16;
  uint32_t acc = 0;
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const int v = (part * kVec + j) * kThreads + (int)threadIdx.x;
    if (v < n16) {
      const uint4 p = x[v];
      const uint4 q = y ? y[v] : make_uint4(0u, 0u, 0u, 0u);
      acc += sq_diff(p.x, q.x) + sq_diff(p.y, q.y) + sq_diff(p.z, q.z) +
             sq_diff(p.w, q.w);
    }
  }
  const uint32_t warp = __reduce_add_sync(kFull, acc);
  if ((threadIdx.x & 31) == 0 && warp)
    atomicAdd(a.out + pl, (unsigned long long)warp);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_sse.py runs the rest
                   // above on CPU threads, compiled by g++ against shims

// p: kPtrs device pointers, n: kInts ints, in `sse_args`' order (host
// arrays): the totals zeroed, then one launch.
extern "C" int th264_sse(void* const* p, const int* n, void* stream) {
  const SseArgs a = sse_args(p, n);
  if (a.k < 1 || a.k > kMaxFrames || a.S < 1 || a.fanout < 1 ||
      a.S % a.fanout || a.plane % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(
      a.out, 0, sizeof(unsigned long long) * a.k * a.S, st);
  if (err != cudaSuccess) return (int)err;
  if (a.plane == 0) return 0;
  sse_kernel<<<a.blocks, kThreads, 0, st>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
