// P1 and P2: the Pallas toolchain probe of tools/pallas_smoke.py on the
// card -- the bit operations the CAVLC kernel needs, and a gridded sum of
// slabs read in multi-dimensional blocks.
//
// Replaces: tools/pallas_smoke.py `kernel` (:7, its pallas_call :18) and
// `k2` (:35, its pallas_call :41).  Their plain versions are
// kernels/probe.py `_probe_bits_plain` and `_slab_sum_plain`.
//
// What they compute, for every element, wrapping mod 2^32:
//   P1  x int32, u = x as uint32, sh = u & 7:
//       out = (u >> sh | u << (8 - sh)) + clz(u | 1) + (x > 5, signed)
//   P2  lv [16, M, L] int32:  out[m, l] = sum_{j < 16} lv[j, m, l]
// Every value is a uint32_t here: >> on an int is arithmetic where P1
// wants the logical shift, and a signed overflow (P1's << and sum, P2's
// sum) is undefined behaviour that nvcc may exploit.
//
// What bounds them on the H100: bytes.  P1 reads and writes 4 bytes an
// element for about ten integer operations; P2 reads 64 bytes an output
// element for 15 adds.  At the probe's own shapes ([8, 128], 8 KB;
// [16, 32, 128], 72 KB) a launch's latency is all of the time.
//
// Design: grid-stride loops over 16-byte chunks, neighbouring threads on
// neighbouring chunks (a warp's access one 512-byte run).  P1 keeps
// kUnroll chunk loads in flight a thread before it computes and stores
// them; P2 gives a thread one output chunk at a time and issues its 16
// slab loads (stride M * L) before it adds them.  Chunks are taken only
// where both pointers are 16-byte aligned (and, for P2, M * L is a
// multiple of 4, so that every slab starts aligned); what is left -- a
// tail of fewer than 4 elements, or every element of an unaligned call
// -- goes through a scalar grid-stride loop.  The caller caps the grid
// (the SMs times the blocks that fit on one).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;  // P1's 16-byte chunks in flight a thread
constexpr int kSlabs = 16;  // P2's slabs: `k2`'s range(16)
constexpr int kPtrs = 2;

struct BitsArgs {
  const uint32_t* x;  // [N] int32, as its bits
  uint32_t* out;      // [N]
  int n;              // N
  int vec;            // 16-byte chunks taken (0 where a pointer is off)
  int blocks;
};

struct SlabArgs {
  const uint32_t* lv;  // [kSlabs, M, L] int32, as its bits
  uint32_t* out;       // [M, L]
  int ml;              // M * L
  int vec;             // 16-byte chunks of a slab taken (0: scalar only)
  int blocks;
};

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// Blocks for `work` threads' worth, at least 1 and at most `cap`.
inline int grid(int work, int cap) {
  int b = (work + kThreads - 1) / kThreads;
  b = b < cap ? b : cap;
  return b < 1 ? 1 : b;
}

// p: {x, out}; n: {N, the grid's cap}, as kernels/probe.py passes them.
inline BitsArgs bits_args(void* const* p, const int* n) {
  BitsArgs a;
  a.x = static_cast<const uint32_t*>(p[0]);
  a.out = static_cast<uint32_t*>(p[1]);
  a.n = n[0];
  a.vec = aligned16(a.x) && aligned16(a.out) ? a.n / 4 : 0;
  const int chunks = (a.vec + kUnroll - 1) / kUnroll, tail = a.n - 4 * a.vec;
  a.blocks = grid(chunks > tail ? chunks : tail, n[1]);
  return a;
}

// p: {lv, out}; n: {M * L, the grid's cap}.
inline SlabArgs slab_args(void* const* p, const int* n) {
  SlabArgs a;
  a.lv = static_cast<const uint32_t*>(p[0]);
  a.out = static_cast<uint32_t*>(p[1]);
  a.ml = n[0];
  a.vec = a.ml % 4 == 0 && aligned16(a.lv) && aligned16(a.out) ? a.ml / 4
                                                               : 0;
  const int tail = a.ml - 4 * a.vec;
  a.blocks = grid(a.vec > tail ? a.vec : tail, n[1]);
  return a;
}

__device__ __forceinline__ uint32_t bit_ops(uint32_t u) {
  const uint32_t sh = u & 7u;
  const uint32_t r = (u >> sh) | (u << (8u - sh));
  return r + (uint32_t)__clz((int)(u | 1u)) + ((int)u > 5 ? 1u : 0u);
}

__device__ __forceinline__ uint4 bit_ops4(uint4 v) {
  return make_uint4(bit_ops(v.x), bit_ops(v.y), bit_ops(v.z), bit_ops(v.w));
}

__global__ void __launch_bounds__(kThreads)
    bits_kernel(const __grid_constant__ BitsArgs a) {
  const int t = blockIdx.x * kThreads + (int)threadIdx.x;
  const int stride = a.blocks * kThreads;
  const uint4* x4 = reinterpret_cast<const uint4*>(a.x);
  uint4* o4 = reinterpret_cast<uint4*>(a.out);
  for (int base = t; base < a.vec; base += kUnroll * stride) {
    uint4 v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (base + k * stride < a.vec) v[k] = x4[base + k * stride];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k)
      if (base + k * stride < a.vec) o4[base + k * stride] = bit_ops4(v[k]);
  }
  for (int i = 4 * a.vec + t; i < a.n; i += stride) a.out[i] = bit_ops(a.x[i]);
}

__global__ void __launch_bounds__(kThreads)
    slab_kernel(const __grid_constant__ SlabArgs a) {
  const int t = blockIdx.x * kThreads + (int)threadIdx.x;
  const int stride = a.blocks * kThreads;
  const uint4* l4 = reinterpret_cast<const uint4*>(a.lv);
  uint4* o4 = reinterpret_cast<uint4*>(a.out);
  for (int i = t; i < a.vec; i += stride) {
    uint4 v[kSlabs];
#pragma unroll
    for (int j = 0; j < kSlabs; ++j) v[j] = l4[(size_t)j * a.vec + i];
    uint4 s = v[0];
#pragma unroll
    for (int j = 1; j < kSlabs; ++j) {
      s.x += v[j].x;
      s.y += v[j].y;
      s.z += v[j].z;
      s.w += v[j].w;
    }
    o4[i] = s;
  }
  for (int i = 4 * a.vec + t; i < a.ml; i += stride) {
    uint32_t s = 0;
    for (int j = 0; j < kSlabs; ++j) s += a.lv[(size_t)j * a.ml + i];
    a.out[i] = s;
  }
}

// The pointers' 4-byte alignment and the sizes an entry takes.
inline bool valid(void* const* p, int count, int cap) {
  for (int i = 0; i < kPtrs; ++i)
    if (!p[i] || (reinterpret_cast<uintptr_t>(p[i]) & 3)) return false;
  return count >= 0 && count <= (1 << 30) && cap >= 1;
}

}  // namespace

#ifdef __CUDACC__  // the entries; tests/test_torch_probe.py runs the rest
                   // above on CPU threads, compiled by g++ against shims

// p: {x, out} device pointers, n: {N, the grid's cap} (host arrays).
extern "C" int th264_probe_bits(void* const* p, const int* n, void* stream) {
  if (!valid(p, n[0], n[1])) return (int)cudaErrorInvalidValue;
  const BitsArgs a = bits_args(p, n);
  if (a.n == 0) return 0;
  bits_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// p: {lv, out} device pointers, n: {M * L, the grid's cap} (host arrays).
extern "C" int th264_probe_slab_sum(void* const* p, const int* n,
                                    void* stream) {
  if (!valid(p, n[0], n[1]) || n[0] > (1 << 30) / kSlabs)
    return (int)cudaErrorInvalidValue;
  const SlabArgs a = slab_args(p, n);
  if (a.ml == 0) return 0;
  slab_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
