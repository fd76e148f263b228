"""CUDA's names for g++, so that a kernel source of tpuh264_torch/csrc
runs on CPU threads in the tests, where there is no card and no nvcc.

A block's threads run as std::threads, one block at a time; each warp's
__syncwarp is a std::barrier among its 32 threads (`g_warp[w]`, set by
the harness), and __syncthreads a std::barrier among the block's threads
(`g_block`, set by a harness whose kernel calls it).  Or, where the
harness runs a block by `run_block_fibers`, its threads are ucontext
fibers on one OS thread and the barriers switch between them, each fiber
resumed once the barrier it waits at opens: for blocks of many warps,
far cheaper than as many OS threads.  A warp shuffle or
ballot is an exchange through a per-warp array after one such warp
barrier: the arrays alternate between two copies from one exchange to
the next (each thread counts its own), so a thread may write the next
while a slower one still reads the last; every thread of the warp must
reach each exchange, as the kernels' warp-uniform code does.
__shared__ arrays are statics, int2 / int4 / uint2 / uint4 plain structs;
__vsadu4 is computed byte by byte.  A harness includes the kernel's
source after this header (as cuda_runtime.h); the source's launch entry
is guarded by __CUDACC__, which g++ does not define.
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
#include <functional>
#include <memory>
#include <vector>
#include <ucontext.h>
using std::abs; using std::max; using std::min;
#define __global__
#define __device__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
struct alignas(16) int4 { int x, y, z, w; };
inline int4 make_int4(int a, int b, int c, int d) { return int4{a, b, c, d}; }
struct alignas(8) int2 { int x, y; };
inline int2 make_int2(int a, int b) { return int2{a, b}; }
struct alignas(8) uint2 { uint32_t x, y; };
inline uint2 make_uint2(uint32_t a, uint32_t b) { return uint2{a, b}; }
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return uint4{a, b, c, d};
}
struct Dim { int x; };
inline thread_local Dim threadIdx, blockIdx;
inline std::barrier<>* g_warp[32];
inline std::barrier<>* g_block;
// Fiber mode (run_block_fibers): a block's threads as ucontext fibers on
// one OS thread, each resumed only once the barrier it waits at opens.
struct FiberBar {
  int expected = 0, count = 0;
  unsigned gen = 0;
};
struct Fiber {
  ucontext_t ctx;
  unsigned xcount = 0;
  FiberBar* bar = nullptr;  // the barrier it waits at, of generation gen
  unsigned gen = 0;
  bool done = false;
};
inline bool g_fibers = false;
inline FiberBar g_fwarp[32], g_fblock;
inline Fiber* g_fiber;  // the running one
inline ucontext_t g_sched;
inline void fiber_wait(FiberBar& b) {
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.gen;
    return;
  }
  g_fiber->bar = &b;
  g_fiber->gen = b.gen;
  swapcontext(&g_fiber->ctx, &g_sched);
}
inline void __syncwarp() {
  if (g_fibers)
    fiber_wait(g_fwarp[threadIdx.x >> 5]);
  else
    g_warp[threadIdx.x >> 5]->arrive_and_wait();
}
inline void __syncthreads() {
  if (g_fibers)
    fiber_wait(g_fblock);
  else
    g_block->arrive_and_wait();
}
inline uint32_t g_xchg[32][2][32];
inline thread_local unsigned g_xcount;
// thread x's value, as every thread of the warp offers its own
inline uint32_t* exchange(uint32_t v) {
  const int w = threadIdx.x >> 5, c = g_xcount++ & 1;
  g_xchg[w][c][threadIdx.x & 31] = v;
  __syncwarp();
  return g_xchg[w][c];
}
inline int __shfl_sync(unsigned, int v, int src) {
  return (int)exchange((uint32_t)v)[src & 31];
}
inline unsigned __shfl_sync(unsigned, unsigned v, int src) {
  return exchange(v)[src & 31];
}
inline int __shfl_xor_sync(unsigned mask, int v, int lane_mask) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ lane_mask);
}
inline unsigned __shfl_xor_sync(unsigned mask, unsigned v, int lane_mask) {
  return __shfl_sync(mask, v, (threadIdx.x & 31) ^ lane_mask);
}
inline unsigned __ballot_sync(unsigned, int p) {
  const uint32_t* all = exchange(p != 0);
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= all[i] << i;
  return b;
}
// Runs `body` as block `block`'s `n` threads (warps of 32), as fibers.
inline std::function<void()> g_fiber_body;
inline void fiber_entry() {
  g_fiber_body();
  g_fiber->done = true;
}
inline void run_block_fibers(int n, int block, std::function<void()> body) {
  static std::vector<std::unique_ptr<char[]>> stacks;
  constexpr size_t kStack = 1 << 17;
  while ((int)stacks.size() < n) stacks.emplace_back(new char[kStack]);
  std::vector<Fiber> fs(n);
  g_fiber_body = std::move(body);
  g_fibers = true;
  for (int w = 0; w < (n + 31) / 32; ++w) g_fwarp[w] = FiberBar{32};
  g_fblock = FiberBar{n};
  for (int i = 0; i < n; ++i) {
    getcontext(&fs[i].ctx);
    fs[i].ctx.uc_stack.ss_sp = stacks[i].get();
    fs[i].ctx.uc_stack.ss_size = kStack;
    fs[i].ctx.uc_link = &g_sched;
    makecontext(&fs[i].ctx, fiber_entry, 0);
  }
  for (int live = n; live;)
    for (int i = 0; i < n; ++i) {
      Fiber& f = fs[i];
      if (f.done || (f.bar && f.bar->gen == f.gen)) continue;
      f.bar = nullptr;
      threadIdx.x = i;
      blockIdx.x = block;
      g_xcount = f.xcount;
      g_fiber = &f;
      swapcontext(&g_sched, &f.ctx);
      f.xcount = g_xcount;
      live -= f.done;
    }
  g_fibers = false;
}
inline unsigned __vsadu4(unsigned a, unsigned b) {
  unsigned s = 0;
  for (int i = 0; i < 32; i += 8) {
    const int x = (a >> i) & 255, y = (b >> i) & 255;
    s += x > y ? x - y : y - x;
  }
  return s;
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
