"""CUDA's names for g++, so that a kernel source of tpuh264_torch/csrc
runs on CPU threads in the tests, where there is no card and no nvcc.

A block's threads run as std::threads, one block at a time; each warp's
__syncwarp is a std::barrier among its 32 threads (`g_warp[w]`, set by
the harness), and a warp shuffle is an exchange through a per-warp
array between two such barriers, so every thread of the warp must reach
it, as the kernels' warp-uniform code does.  __shared__ arrays are
statics, int4 / uint2 / uint4 plain structs.  There is no block-wide
barrier: the kernels that run here have none.  A harness includes the
kernel's source after this header (as cuda_runtime.h); the source's
launch entry is guarded by __CUDACC__, which g++ does not define.
"""

import shutil
import subprocess

import pytest

SHIMS = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cstdint>
#include <cstdlib>
using std::abs; using std::max; using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(n)
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
struct uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
struct Dim { int x; };
inline thread_local Dim threadIdx, blockIdx;
inline std::barrier<>* g_warp[2];
inline void __syncwarp() { g_warp[threadIdx.x >> 5]->arrive_and_wait(); }
inline int g_xchg[2][32];
inline int __shfl_sync(unsigned, int v, int src) {
  const int w = threadIdx.x >> 5;
  g_xchg[w][threadIdx.x & 31] = v;
  __syncwarp();
  const int r = g_xchg[w][src & 31];
  __syncwarp();
  return r;
}
inline int __shfl_xor_sync(unsigned mask, int v, int lane_mask) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ lane_mask);
}
"""


def build(d, harness: str, csrc: str, name: str) -> str:
    """Compile `harness` (C++ that includes a kernel source of `csrc`)
    against the shims, in directory `d`: the executable's path.  Skips
    the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to run the kernel source on the CPU")
    (d / "cuda_runtime.h").write_text(SHIMS)
    (d / "harness.cpp").write_text(harness)
    exe = d / name
    subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                    "-pthread", "-I", str(d), "-I", csrc, "-o", str(exe),
                    str(d / "harness.cpp")], check=True)
    return str(exe)
