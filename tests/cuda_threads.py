"""CUDA's names for g++, so that a kernel source of tpuh264_torch/csrc
runs on CPU threads in the tests, where there is no card and no nvcc.

A block's threads run as std::threads, one block at a time; each warp's
__syncwarp is a std::barrier among its 32 threads (`g_warp[w]`, set by
the harness), and __syncthreads a std::barrier among the block's threads
(`g_block`, set by a harness whose kernel calls it). Or, where the
harness runs a block by `run_block_fibers`, its threads are fibers on
one OS thread and the barriers switch between them, each fiber resumed
once the barrier it waits at opens: for blocks of many warps, far
cheaper than as many OS threads. A fiber is entered by swapcontext; it
switches by swapcontext too, or, where `fast_switch()` (a one-time probe
build) found it to work, by _setjmp / _longjmp, which make no system
call (`CT_LONGJMP`: jumping between stacks is outside what C promises,
and a shadow stack or a checked longjmp refuses it). `run_cluster_fibers` runs the CTAs
of one thread-block cluster together so, each with its own warp barriers
and its own dynamic shared memory (`cl_smem`, filled with a pattern
first so that a kernel that reads what it never wrote fails); `cl_map`
is DSMEM (the same offset in a sibling CTA's buffer), `cl_sync` the
cluster barrier, `cl_acquire` / `cl_release` (and `cta_acquire` /
`cta_release`) plain loads and stores of a flag, and `cl_pause`, the
body of a kernel's wait loop, yields the fiber. A run in which every
live fiber only waits (no barrier reached, no flag released) is a
deadlock and aborts. `bar_wait` / `bar_arrive` are a kernel's named
barriers (bar.sync / bar.arrive id, n) among its fibers. A warp shuffle
or ballot is an exchange through a per-warp array after one such warp
barrier: the arrays alternate between
two copies from one exchange to the next (each thread counts its own),
so a thread may write the next while a slower one still reads the last;
every thread of the warp must reach each exchange, as the kernels' warp-
uniform code does. `__reduce_add_sync` (redux.sync) sums such an
exchange, and `__reduce_min_sync` / `__reduce_max_sync` take its least /
greatest; `cp_async4` / `cp_async16` (cp.async) queue a thread's copies,
`cp_async_commit` closes a group and `cp_async_wait<N>` lands all but
the newest N groups, so that a read before its wait finds the old bytes;
`atomicAdd` (int and 64-bit), `atomicExch` (64-bit) and `atomicOr`
are atomics on the host, `__shfl_up_sync` an exchange like
`__shfl_sync`, `__popc` the builtin. `CT_REVERSE` in the environment of
an ENTRY_HARNESS run starts its blocks last first and resumes a block's
fibers last first, so that what two warps or blocks do in either order
is met. __shared__ arrays are statics, int2 / int4 / uint2 / uint4
plain structs, __grid_constant__ nothing; __vsadu4 is computed byte by
byte, __clz by the compiler's builtin; `__byte_perm`, `__funnelshift_r`,
the DPX `__vimin_s16x2_relu` and `__vimin3_u16x2` and the bit casts are
their definitions in plain C++, `__fmaf_rd` the double sum rounded down
to a float, `__fmul_rn` / `__fadd_rn` / `__fsub_rn` and the int / float
conversions the host's
float32 operations (sinf / cosf are the host's: within an ulp of the
card's, not equal). A harness
includes the kernel's source after this header (as cuda_runtime.h); the
source's launch entry is guarded by __CUDACC__, which g++ does not
define.
"""

import os
import shutil
import struct
import subprocess

import numpy as np
import pytest
import torch

SHIMS = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <functional>
#include <cstring>
#include <memory>
#include <vector>
#include <setjmp.h>
#include <ucontext.h>
using std::abs; using std::max; using std::min;
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))
#define __launch_bounds__(...)
#define __grid_constant__
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
// Fiber mode (run_block_fibers, run_cluster_fibers): a block's threads as
// ucontext fibers on one OS thread, each resumed only once the barrier it
// waits at opens.
constexpr int kMaxCta = 16;  // CTAs a cluster
struct FiberBar {
  int expected = 0, count = 0;
  unsigned gen = 0;
};
// cp.async (cp_async4 / cp_async16, cp_async_commit, cp_async_wait<N>):
// a thread's copies wait in its queue, and land only when a wait reaches
// their group, so that a read before its wait finds what was there before
struct CpCopy {
  void* dst;
  const void* src;
  int n;
};
struct CpQueue {
  std::vector<CpCopy> open;                // since the last commit
  std::vector<std::vector<CpCopy>> groups;  // committed, oldest first
};
struct Fiber {
  CpQueue cpq;     // its cp.async copies
  ucontext_t ctx;  // its first entry
  jmp_buf jb;      // where it left off since
  bool started = false;
  unsigned xcount = 0;
  FiberBar* bar = nullptr;  // the barrier it waits at, of generation gen
  unsigned gen = 0;
  int cta = 0, tid = 0;
  bool done = false;
};
inline bool g_fibers = false;
inline bool g_reverse = false;  // resume fibers last first (CT_REVERSE)
inline FiberBar g_fwarp[kMaxCta][32], g_fblock[kMaxCta], g_fcluster;
inline Fiber* g_fiber;  // the running one
inline int g_cta = 0;   // its CTA in the cluster (0 outside fiber mode)
inline unsigned long g_progress = 0;  // barrier arrivals, flag releases
inline ucontext_t g_sched;
inline jmp_buf g_sched_jb;
// Back to the scheduler.  With CT_LONGJMP every switch after a fiber's
// first entry is an _setjmp / _longjmp pair, which saves no signal mask:
// swapcontext makes a system call for it on every switch, several times
// the cost.
inline void to_sched() {
#ifdef CT_LONGJMP
  if (!_setjmp(g_fiber->jb)) _longjmp(g_sched_jb, 1);
#else
  swapcontext(&g_fiber->ctx, &g_sched);
#endif
}
inline void fiber_wait(FiberBar& b) {
  ++g_progress;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.gen;
    return;
  }
  g_fiber->bar = &b;
  g_fiber->gen = b.gen;
  to_sched();
}
inline void __syncwarp() {
  if (g_fibers)
    fiber_wait(g_fwarp[g_cta][threadIdx.x >> 5]);
  else
    g_warp[threadIdx.x >> 5]->arrive_and_wait();
}
inline void __syncthreads() {
  if (g_fibers)
    fiber_wait(g_fblock[g_cta]);
  else
    g_block->arrive_and_wait();
}
// A named barrier `id` of `n` threads (fiber mode): `bar_wait` (bar.sync
// id, n) waits for it; `bar_arrive` (bar.arrive id, n) counts towards it
// and goes on.
inline FiberBar g_fnamed[kMaxCta][16];
inline void bar_arrive(int id, int n) {
  if (!g_fibers) abort();
  FiberBar& b = g_fnamed[g_cta][id];
  b.expected = n;
  ++g_progress;
  if (++b.count == b.expected) {
    b.count = 0;
    ++b.gen;
  }
}
inline void bar_wait(int id, int n) {
  if (!g_fibers) abort();
  g_fnamed[g_cta][id].expected = n;
  fiber_wait(g_fnamed[g_cta][id]);
}
// Clusters (run_cluster_fibers): each CTA's dynamic shared memory, DSMEM,
// the cluster barrier, flags and the yield of a wait loop.
inline uint8_t* g_smem[kMaxCta];
inline uint8_t* cl_smem() { return g_smem[g_cta]; }
template <typename T>
inline T* cl_map(T* p, int rank) {
  return reinterpret_cast<T*>(g_smem[rank] +
                              (reinterpret_cast<uint8_t*>(p) - g_smem[g_cta]));
}
inline void cl_sync() { fiber_wait(g_fcluster); }
inline unsigned cl_acquire(const unsigned* p) {
  return *static_cast<const volatile unsigned*>(p);
}
inline void cl_release(unsigned* p, unsigned v) {
  ++g_progress;
  *static_cast<volatile unsigned*>(p) = v;
}
inline unsigned cta_acquire(const unsigned* p) { return cl_acquire(p); }
inline void cta_release(unsigned* p, unsigned v) { cl_release(p, v); }
inline void cl_pause() {
  g_fiber->bar = nullptr;
  to_sched();
}
inline thread_local CpQueue t_cpq;
inline CpQueue& cp_queue() { return g_fibers ? g_fiber->cpq : t_cpq; }
inline void cp_async4(void* dst, const void* src) {
  cp_queue().open.push_back({dst, src, 4});
}
inline void cp_async16(void* dst, const void* src) {
  cp_queue().open.push_back({dst, src, 16});
}
inline void cp_async_commit() {
  CpQueue& q = cp_queue();
  q.groups.push_back(std::move(q.open));
  q.open.clear();
}
template <int N>
inline void cp_async_wait() {
  CpQueue& q = cp_queue();
  while ((int)q.groups.size() > N) {
    for (const CpCopy& c : q.groups.front()) std::memcpy(c.dst, c.src, c.n);
    q.groups.erase(q.groups.begin());
  }
}
inline uint32_t g_xchg[kMaxCta][32][2][32];
inline thread_local unsigned g_xcount;
// thread x's value, as every thread of the warp offers its own
inline uint32_t* exchange(uint32_t v) {
  const int w = threadIdx.x >> 5, c = g_xcount++ & 1;
  g_xchg[g_cta][w][c][threadIdx.x & 31] = v;
  __syncwarp();
  return g_xchg[g_cta][w][c];
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
// redux.sync: the warp's sum, to every lane
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  const uint32_t* all = exchange(v);
  unsigned sum = 0;
  for (int i = 0; i < 32; ++i) sum += all[i];
  return sum;
}
inline int __reduce_add_sync(unsigned mask, int v) {
  return (int)__reduce_add_sync(mask, (unsigned)v);
}
// redux.sync min / max of signed ints, to every lane
inline int __reduce_min_sync(unsigned, int v) {
  const uint32_t* all = exchange((uint32_t)v);
  int m = (int)all[0];
  for (int i = 1; i < 32; ++i) m = std::min(m, (int)all[i]);
  return m;
}
inline int __reduce_max_sync(unsigned, int v) {
  const uint32_t* all = exchange((uint32_t)v);
  int m = (int)all[0];
  for (int i = 1; i < 32; ++i) m = std::max(m, (int)all[i]);
  return m;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned long long atomicExch(unsigned long long* p,
                                     unsigned long long v) {
  return __atomic_exchange_n(p, v, __ATOMIC_RELAXED);
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}
// thread x - d's value (its own below d), as every thread offers its own
inline int __shfl_up_sync(unsigned, int v, unsigned d) {
  const int l = threadIdx.x & 31;
  const uint32_t* all = exchange((uint32_t)v);
  return l >= (int)d ? (int)all[l - d] : v;
}
inline unsigned __ballot_sync(unsigned, int p) {
  const uint32_t* all = exchange(p != 0);
  unsigned b = 0;
  for (int i = 0; i < 32; ++i) b |= all[i] << i;
  return b;
}
// Runs `body` as the `n` threads (warps of 32) of each of the `ctas`
// CTAs of one cluster, blocks first_block.., as fibers; each CTA with
// `smem` bytes of dynamic shared memory.
inline std::function<void()> g_fiber_body;
inline void fiber_entry() {
  g_fiber_body();
  ++g_progress;
  g_fiber->done = true;
#ifdef CT_LONGJMP
  _longjmp(g_sched_jb, 1);  // never returns through uc_link
#endif
}
inline void run_cluster_fibers(int n, int ctas, int first_block, size_t smem,
                               std::function<void()> body) {
  static std::vector<std::unique_ptr<char[]>> stacks;
  constexpr size_t kStack = 1 << 17;
  const int total = n * ctas;
  if (ctas > kMaxCta) abort();
  while ((int)stacks.size() < total) stacks.emplace_back(new char[kStack]);
  const int fill = (int)0xa5a5a5a5u;
  std::vector<std::vector<int4>> mem(ctas, std::vector<int4>(
      (smem + 15) / 16, int4{fill, fill, fill, fill}));
  for (int k = 0; k < ctas; ++k)
    g_smem[k] = reinterpret_cast<uint8_t*>(mem[k].data());
  std::vector<Fiber> fs(total);
  g_fiber_body = std::move(body);
  g_fibers = true;
  for (int k = 0; k < ctas; ++k) {
    for (int w = 0; w < (n + 31) / 32; ++w) g_fwarp[k][w] = FiberBar{32};
    g_fblock[k] = FiberBar{n};
  }
  g_fcluster = FiberBar{total};
  for (int i = 0; i < total; ++i) {
    fs[i].cta = i / n, fs[i].tid = i % n;
    getcontext(&fs[i].ctx);
    fs[i].ctx.uc_stack.ss_sp = stacks[i].get();
    fs[i].ctx.uc_stack.ss_size = kStack;
    fs[i].ctx.uc_link = &g_sched;
    makecontext(&fs[i].ctx, fiber_entry, 0);
  }
  for (int live = total, idle = 0; live;) {
    const unsigned long before = g_progress;
    for (int ii = 0; ii < total; ++ii) {
      Fiber& f = fs[g_reverse ? total - 1 - ii : ii];
      if (f.done || (f.bar && f.bar->gen == f.gen)) continue;
      f.bar = nullptr;
      threadIdx.x = f.tid;
      blockIdx.x = first_block + f.cta;
      g_cta = f.cta;
      g_xcount = f.xcount;
      g_fiber = &f;
#ifdef CT_LONGJMP
      if (!_setjmp(g_sched_jb)) {
        if (f.started) _longjmp(f.jb, 1);
        f.started = true;
        swapcontext(&g_sched, &f.ctx);
      }
#else
      swapcontext(&g_sched, &f.ctx);
#endif
      f.xcount = g_xcount;
      live -= f.done;
    }
    idle = g_progress == before ? idle + 1 : 0;
    if (live && idle > 2) {  // every live fiber waits on what none will do
      fprintf(stderr, "deadlock: %d fibers wait forever\n", live);
      abort();
    }
  }
  g_fibers = false;
  g_cta = 0;
}
// Runs `body` as block `block`'s `n` threads (warps of 32), as fibers.
inline void run_block_fibers(int n, int block, std::function<void()> body) {
  run_cluster_fibers(n, 1, block, 0, std::move(body));
}
inline int __clz(int x) { return x ? __builtin_clz((unsigned)x) : 32; }
inline int __popc(unsigned x) { return __builtin_popcount(x); }
// prmt: byte i of the result is byte (s >> 4i) & 7 of y:x (x lowest)
inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = ((uint64_t)y << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i)
    r |= (uint32_t)((v >> (8 * ((s >> (4 * i)) & 7))) & 255u) << (8 * i);
  return r;
}
inline uint32_t __funnelshift_r(uint32_t lo, uint32_t hi, uint32_t sh) {
  return (uint32_t)((((uint64_t)hi << 32) | lo) >> (sh & 31));
}
inline float __int_as_float(int x) {
  float f;
  std::memcpy(&f, &x, 4);
  return f;
}
inline uint32_t __float_as_uint(float f) {
  uint32_t x;
  std::memcpy(&x, &f, 4);
  return x;
}
// a * b + c rounded toward minus infinity (exact where a * b + c is exact
// in double, as in every kernel use: float products, sums below 2^24)
inline float __fmaf_rd(float a, float b, float c) {
  const double d = (double)a * b + c;
  float f = (float)d;
  if ((double)f > d) f = std::nextafterf(f, -INFINITY);
  return f;
}
// DPX: per 16-bit half, max(min(a, b), 0) of signed halves
inline uint32_t __vimin_s16x2_relu(uint32_t a, uint32_t b) {
  uint32_t r = 0;
  for (int i = 0; i < 32; i += 16) {
    const int x = (int16_t)(a >> i), y = (int16_t)(b >> i);
    r |= (uint32_t)(uint16_t)std::max(std::min(x, y), 0) << i;
  }
  return r;
}
// DPX: per 16-bit half, the least of three unsigned halves
inline uint32_t __vimin3_u16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t r = 0;
  for (int i = 0; i < 32; i += 16)
    r |= std::min({(a >> i) & 0xffffu, (b >> i) & 0xffffu,
                   (c >> i) & 0xffffu}) << i;
  return r;
}
// IEEE float32 operations, each rounded once (never contracted: g++
// compiles ISO C++ with -ffp-contract=off), and the conversions
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __int2float_rn(int x) { return (float)x; }
inline int __float2int_rz(float f) { return (int)f; }
inline unsigned __vsadu4(unsigned a, unsigned b) {
  unsigned s = 0;
  for (int i = 0; i < 32; i += 8) {
    const int x = (a >> i) & 255, y = (b >> i) & 255;
    s += x > y ? x - y : y - x;
  }
  return s;
}
"""


def _gxx(gxx, d, defines, csrc, exe, src, **kw):
    # -U_FORTIFY_SOURCE: with CT_LONGJMP, _longjmp between fiber stacks
    # must not be the checked longjmp
    return subprocess.run([gxx, "-std=c++20", "-O1", "-fno-strict-aliasing",
                           "-U_FORTIFY_SOURCE", "-pthread",
                           *(f"-D{x}" for x in defines), "-I", str(d),
                           "-I", csrc, "-o", str(exe), str(src)], **kw)


# Fibers of two warps that meet at warp and block barriers and exchange
# by shuffles many times, each summing what it saw: 0 where every sum is
# right.
_PROBE = r"""
#include <cuda_runtime.h>
int main() {
  static int got[64];
  for (int b = 0; b < 3; ++b)
    run_block_fibers(64, b, [&] {
      const int t = threadIdx.x;
      int acc = 0;
      for (int i = 0; i < 200; ++i) {
        acc += __shfl_sync(~0u, t + i, (t + 1) & 31);
        __syncthreads();
      }
      got[t] = acc;
    });
  for (int t = 0; t < 64; ++t) {
    int want = 0;
    for (int i = 0; i < 200; ++i) want += (t & 32) + ((t + 1) & 31) + i;
    if (got[t] != want) return 1;
  }
  return 0;
}
"""
_FAST = []


def fast_switch(gxx: str, d) -> bool:
    """Whether fibers may switch by _setjmp / _longjmp (CT_LONGJMP) with
    this compiler and C library: a probe built and run once a process, in
    directory `d`; any failure (a shadow stack, a checked longjmp, a
    crash) keeps swapcontext."""
    if not _FAST:
        src = d / "switch_probe.cpp"
        src.write_text(_PROBE)
        exe = d / "switch_probe"
        try:
            ok = (_gxx(gxx, d, ("CT_LONGJMP",), str(d), exe, src,
                       capture_output=True).returncode == 0
                  and subprocess.run([os.path.abspath(exe)],
                                     capture_output=True,
                                     timeout=60).returncode == 0)
        except (OSError, subprocess.TimeoutExpired):
            ok = False
        _FAST.append(ok)
    return _FAST[0]


def build(d, harness: str, csrc: str, name: str, defines=()) -> str:
    """Compile `harness` (C++ that includes a kernel source of `csrc`)
    against the shims, in directory `d`, with the macros `defines`
    ("NAME=VALUE") and CT_LONGJMP where `fast_switch` allows it: the
    executable's path.  Skips the test where there is no g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ (C++20) to run the kernel source on the CPU")
    (d / "cuda_runtime.h").write_text(SHIMS)
    (d / "harness.cpp").write_text(harness)
    exe = d / name
    fast = ("CT_LONGJMP",) if fast_switch(gxx, d) else ()
    _gxx(gxx, d, (*fast, *defines), csrc, exe, d / "harness.cpp",
         check=True)
    return str(exe)


# A kernel source's launch entry, generically: reads the entry's ints
# (count, then int32s), then its pointer slots (count, then per slot:
# int64 bytes, int32 kind -- 0 output, 1 input, 2 input and output, 3
# null -- and an input's bytes), builds the kernel's arguments with the
# source's own unpacking (`ARGS(p, n)`) and runs BLOCKS blocks of THREADS
# threads as fibers; writes every output slot's bytes in order.  SOURCE,
# ARGS, KERNEL, BLOCKS (an expression in the arguments `a`) and THREADS
# are macros of `build`.
ENTRY_HARNESS = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include <vector>
#include SOURCE
int main() {
  int32_t k;
  if (fread(&k, 4, 1, stdin) != 1) return 2;
  std::vector<int> n(k);
  if (fread(n.data(), 4, k, stdin) != (size_t)k) return 2;
  if (fread(&k, 4, 1, stdin) != 1 || k != kPtrs) return 3;
  std::vector<std::vector<int4>> buf(k);
  std::vector<int> kind(k);
  std::vector<void*> p(k);
  std::vector<int64_t> size(k);
  for (int i = 0; i < k; ++i) {
    if (fread(&size[i], 8, 1, stdin) != 1 || fread(&kind[i], 4, 1, stdin) != 1)
      return 4;
    if (kind[i] == 3) {
      p[i] = nullptr;
      continue;
    }
    const int fill = (int)0xa5a5a5a5u;  // what a kernel never writes shows
    buf[i].assign((size[i] + 15) / 16 + 1, int4{fill, fill, fill, fill});
    p[i] = buf[i].data();
    if ((kind[i] == 1 || kind[i] == 2) &&
        fread(p[i], 1, size[i], stdin) != (size_t)size[i])
      return 5;
  }
  const auto a = ARGS(p.data(), n.data());
  const int blocks = BLOCKS;
  g_reverse = getenv("CT_REVERSE") != nullptr;
  for (int k = 0; k < blocks; ++k) {
    const int b = g_reverse ? blocks - 1 - k : k;
    run_block_fibers(THREADS, b, [&] { KERNEL(a); });
  }
  for (int i = 0; i < k; ++i)
    if (kind[i] == 0 || kind[i] == 2) fwrite(p[i], 1, size[i], stdout);
  return 0;
}
"""


def build_entry(d, csrc: str, source: str, args: str, kernel: str,
                blocks: str, threads: str, defines=()) -> str:
    """`build` of ENTRY_HARNESS over the source `source` of `csrc`, its
    argument unpacking `args`, kernel `kernel`, grid `blocks` and block
    `threads`, with the source's macros `defines` ("NAME=VALUE"): the
    executable's path."""
    return build(d, ENTRY_HARNESS, csrc, os.path.splitext(source)[0],
                 (f'SOURCE="{source}"', f"ARGS={args}", f"KERNEL={kernel}",
                  f"BLOCKS={blocks}", f"THREADS={threads}", *defines))


def _span(t: torch.Tensor) -> bytes:
    """The bytes a kernel reads from tensor t's pointer: from its first
    element to its last in its storage (a strided view's gaps included)."""
    if not t.numel():
        return b""
    n = 1 + sum((sz - 1) * st for sz, st in zip(t.shape, t.stride()))
    return t.as_strided((n,), (1,)).contiguous().numpy().tobytes()


def run_entry(exe: str, ins, outs, ints, inout=(), reverse=False):
    """A kernel source built by `build_entry`, on CPU threads, over an
    entry's operands: input tensors `ins` (a strided view as the memory it
    spans; None as a null pointer), output
    tensors `outs` (contiguous, filled in place; those whose index is in
    `inout` sent first as inputs too; None a null pointer) and `ints`.
    With `reverse` the blocks run last first, and so do a block's fibers
    at each pass of the scheduler.  Returns `outs`."""
    body = [struct.pack("<i", len(ints)),
            np.asarray(ints, np.int32).tobytes(),
            struct.pack("<i", len(ins) + len(outs))]
    for t in ins:
        if t is None:
            body.append(struct.pack("<qi", 0, 3))
            continue
        raw = _span(t)
        body += [struct.pack("<qi", len(raw), 1), raw]
    for i, t in enumerate(outs):
        if t is None:
            body.append(struct.pack("<qi", 0, 3))
            continue
        nb = t.numel() * t.element_size()
        if i in inout:
            body += [struct.pack("<qi", nb, 2), t.contiguous().numpy()
                     .tobytes()]
        else:
            body.append(struct.pack("<qi", nb, 0))
    env = dict(os.environ, CT_REVERSE="1") if reverse else None
    raw = subprocess.run([exe], input=b"".join(body), capture_output=True,
                         check=True, env=env).stdout
    off = 0
    for t in outs:
        if t is None:
            continue
        nb = t.numel() * t.element_size()
        t.copy_(torch.frombuffer(bytearray(raw[off:off + nb]),
                                 dtype=t.dtype).reshape(t.shape))
        off += nb
    assert off == len(raw)
    return outs
