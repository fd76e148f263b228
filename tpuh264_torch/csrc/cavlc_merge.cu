// K3: concatenate K variable-length MSB-first bit strings per lane.
//
// Replaces: tpuh264/kernels/cavlc_pallas.py `_merge_kernel` (pallas_call
// at cavlc_pallas.py:570 in `_merge_tree_dev`, entry `merge_tree` :508).
// Plain version: `cavlc_cuda.tree_merge`.
//
// What it computes: for each lane, strings words[k] (W words each, all-
// zero past their bit length bits[k]) appended in order, truncated at
// n_out words (1 <= n_out <= 8192), plus the total bit length.  In the
// pipeline it runs at two levels: a lane is one MB with K = 27 chunk
// strings of W = 20 words merged into 128 (MB_W), or one slice with
// K = C + 2 or C + 3 strings of W = 128 words (slice header, the C MBs,
// the P trailing skip_run, the rbsp trailing bits) merged into 8192
// (SLICE_W).
//
// Precondition: every string fits its budget, 0 <= bits[k] <= 32 * W.
// Then the result equals the plain version's pairwise tree (whose
// intermediate truncation at min(2w, n_out) words drops only bits that
// land past n_out anyway) bit for bit, truncated lanes included.  A
// longer string is already truncated by its producer, and the pipeline
// flags it as an overflow (entropy_gpu.py `_merge_mbs`), so its dispatch
// goes to the host packer.
//
// What bounds it on the H100: device memory.  A lane reads its K bit
// lengths and only the words its strings use (a P dispatch's strings are
// mostly empty: ~1 MB of 68 MB at the MB level of a 1080p x 4 dispatch)
// and writes n_out + 1 words: 82.5 MB at that MB level (0.025 ms at
// 3.35 TB/s), ~37 MB at its slice level (1,088 lanes of 32 KB).
//
// Design: every lane is merged into a zeroed tile of n_out words in
// shared memory.  Each word of a string is shifted by the string's start
// bit & 31 and ORed into at most two tile words with shared atomicOr:
// only neighbouring strings share a word and OR commutes, so the result
// does not depend on order.  Pieces at word >= n_out are dropped; a zero
// shift writes one word (v << 32 is undefined in C++).  The tile leaves
// with coalesced 16-byte stores (scalar head and tail where a row does
// not start or end on a 16-byte boundary).  Two kernels:
//  - merge_warp (K <= 32, n_out <= 256: the MB level): thread k of a warp
//    holds string k of 4 lanes at once.  The 4 lanes' bit lengths load
//    together, their start bits come from register shuffle scans, then
//    the first words of the 4 lanes' strings load together: two rounds
//    of device-memory latency for 4 lanes, not for one.  8 warps a block.
//  - merge_block (any other shape: the slice level): a block of 256
//    threads a lane.  The threads stage the K bit lengths in shared
//    memory in one round, the first warp scans them 32 at a time with a
//    carry (each string's start bit and its first index in the lane's
//    list of used words: string k uses min(ceil(bits/32), W) words), and
//    the threads then take the used words densely (thread j: used word j,
//    its string by binary search), so a lane reads its used words, not
//    K x W.  The tile (32 KB at 8192 words) and the two sums fit 48 KB of
//    shared memory for K <= 1024.
// The slice entry (th264_merge_slices), the GOP pipeline's slice
// level: merge_block's design over strings read where their producers
// left them (the header, K3's MB-level output, K13's tail word) and the
// rbsp trailer made in the kernel from the body's total, so no joined
// [S, R, K, MB_W] buffer is built; it also sets the overflow flag (an MB
// past its words, a body past 32 * n_out - 64 bits).  Static shared
// memory (the tile and the two sums, 40 KB), so the CPU-thread tests
// build it.  Plain version: `cavlc_cuda._merge_slices_plain`.
// There is no per-thread array indexed at run time and no cap below
// n_out = 8192.  What still holds it back: a warp still waits through
// two rounds of latency for its 4 lanes, and a string's words past its
// first load one at a time (IDR and intra MBs); at the slice level the
// 1,088 blocks of a 1080p x 4 dispatch run in ~1.65 waves (5 blocks an
// SM, by registers), so the last one runs part full.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxOut = 8192;      // SLICE_W: a 32 KB tile
constexpr int kMaxK = 1024;        // strings a lane
constexpr int kWarpK = 32;         // merge_warp: a thread a string
constexpr int kWarpOut = 256;      // merge_warp: widest output
constexpr int kWarpLanes = 4;      // merge_warp: lanes a warp
constexpr int kBlockWarps = 8;     // merge_warp: warps a block
constexpr int kBlockThreads = 256; // merge_block: threads a lane
constexpr unsigned kFull = 0xffffffffu;

__host__ __device__ __forceinline__ int round4(int x) { return (x + 3) & ~3; }

// ORs word v of a string, its first bit at bit pos of the lane, into the
// lane's tile of n_out words.
__device__ __forceinline__ void put(uint32_t* tile, uint32_t v, int pos,
                                    int n_out) {
  if (v == 0u) return;
  const int q = pos >> 5;
  const int sh = pos & 31;
  if ((unsigned)q < (unsigned)n_out) atomicOr(&tile[q], v >> sh);
  if (sh != 0 && (unsigned)(q + 1) < (unsigned)n_out)
    atomicOr(&tile[q + 1], v << (32 - sh));
}

// Copies count words of a shared tile to o, thread tid of G: a scalar
// head up to o's next 16-byte boundary, 16-byte stores, a scalar tail.
__device__ __forceinline__ void write_span(int32_t* o, const uint32_t* tile,
                                           int count, int tid, int G) {
  const int head =
      min((int)(((16 - ((uintptr_t)o & 15)) & 15) >> 2), count);
  const int n_vec = (count - head) >> 2;
  for (int q = tid; q < head; q += G) o[q] = (int32_t)tile[q];
  uint4* o4 = reinterpret_cast<uint4*>(o + head);
  if (head == 0) {
    const uint4* t4 = reinterpret_cast<const uint4*>(tile);
    for (int q = tid; q < n_vec; q += G) o4[q] = t4[q];
  } else {
    for (int q = tid; q < n_vec; q += G) {
      const uint32_t* s4 = tile + head + 4 * q;
      o4[q] = make_uint4(s4[0], s4[1], s4[2], s4[3]);
    }
  }
  for (int q = head + 4 * n_vec + tid; q < count; q += G)
    o[q] = (int32_t)tile[q];
}

// The slice entry (th264_merge_slices): lane i is slice i; its strings
// are read where their producers left them, not from one joined buffer:
// string 0 the slice header (hdr_w words), 1..C the slice's MBs (K3's MB
// level: mb_w words each), then (P slices) the trailing skip_run (one
// word) and last the rbsp trailing bits, a stop bit and zeros up to the
// byte boundary, whose length comes from the body's total.  It writes the
// slice's words and its byte count, and sets the overflow flag where an
// MB string passes mb_w words or the body passes 32 * n_out - 64 bits.
struct SliceArgs {
  const int32_t *hdr, *hdr_len;    // [L, hdr_w], [L]
  const int32_t *mb, *mb_bits;     // [L * C, mb_w], [L * C]
  const int32_t *tail;             // [L, 2] (word, bits), or null
  int32_t *out, *out_bytes, *ovf;  // [L, n_out], [L], [1]
  int L, C, hdr_w, mb_w, n_out;
};

constexpr int kSlicePtrs = 8;
constexpr int kSliceInts = 5;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/cavlc_cuda.py `_k3_slice_operands` builds them.
inline SliceArgs slice_args(void* const* p, const int* n) {
  SliceArgs a;
  auto in = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  a.hdr = in(0), a.hdr_len = in(1), a.mb = in(2), a.mb_bits = in(3);
  a.tail = in(4), a.out = out(5), a.out_bytes = out(6), a.ovf = out(7);
  a.L = n[0], a.C = n[1], a.hdr_w = n[2], a.mb_w = n[3], a.n_out = n[4];
  return a;
}

// Word t of lane i's string k (K strings, the last the trailer).
__device__ __forceinline__ uint32_t slice_word(const SliceArgs& a, int64_t i,
                                               int k, int t, int K) {
  if (k == 0) return (uint32_t)a.hdr[i * a.hdr_w + t];
  if (k <= a.C) return (uint32_t)a.mb[(i * a.C + k - 1) * a.mb_w + t];
  if (k < K - 1) return (uint32_t)a.tail[2 * i];
  return 0x80000000u;  // the rbsp stop bit
}

__global__ void __launch_bounds__(kBlockThreads)
    merge_slices_kernel(const __grid_constant__ SliceArgs a) {
  __shared__ __align__(16) uint32_t tile[kMaxOut];
  __shared__ int start[kMaxK + 1], used[kMaxK + 1];
  const int tid = threadIdx.x;
  const int64_t i = blockIdx.x;
  const int n_out = a.n_out, C = a.C;
  const int K = C + (a.tail ? 3 : 2);

  // 1. zero the tile and stage the body's bit lengths and word budgets
  // (in start / used); an MB past its budget is an overflow
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int q = tid; q < round4(n_out) / 4; q += kBlockThreads)
    tile4[q] = make_uint4(0u, 0u, 0u, 0u);
  for (int k = tid; k < K - 1; k += kBlockThreads) {
    int lb, w;
    if (k == 0) {
      lb = a.hdr_len[i], w = a.hdr_w;
    } else if (k <= C) {
      lb = a.mb_bits[i * C + k - 1], w = a.mb_w;
      if (lb > 32 * a.mb_w) *a.ovf = 1;
    } else {
      lb = a.tail[2 * i + 1], w = 1;
    }
    start[k] = lb;
    used[k] = w;
  }
  __syncthreads();
  if (tid < 32) {  // the two exclusive prefix sums, 32 strings at a time
    int carry_bits = 0, carry_used = 0;
    for (int k0 = 0; k0 < K - 1; k0 += 32) {
      const int k = k0 + tid;
      const int lb = k < K - 1 ? start[k] : 0;
      const int nw = lb > 0 ? min((lb + 31) >> 5, used[k]) : 0;
      int sb = lb, su = nw;  // inclusive sums over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ub = __shfl_up_sync(kFull, sb, d);
        const int uu = __shfl_up_sync(kFull, su, d);
        if (tid >= d) {
          sb += ub;
          su += uu;
        }
      }
      __syncwarp();  // every lane has read start / used before they change
      if (k < K - 1) {
        start[k] = carry_bits + sb - lb;
        used[k] = carry_used + su - nw;
      }
      carry_bits += __shfl_sync(kFull, sb, 31);
      carry_used += __shfl_sync(kFull, su, 31);
    }
    if (tid == 0) {  // the trailer: stop bit, zeros to the byte boundary
      start[K - 1] = carry_bits;
      used[K - 1] = carry_used;
      start[K] = carry_bits + 1 + ((8 - ((carry_bits + 1) % 8)) % 8);
      used[K] = carry_used + 1;
      if (carry_bits > 32 * n_out - 64) *a.ovf = 1;
    }
  }
  __syncthreads();

  // 2. scatter the used words into the tile
  const int n_used = used[K];
  for (int j = tid; j < n_used; j += kBlockThreads) {
    int lo = 0, hi = K - 1;  // the last string k with used[k] <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (used[mid] <= j) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int t = j - used[lo];
    put(tile, slice_word(a, i, lo, t, K), start[lo] + 32 * t, n_out);
  }
  __syncthreads();

  // 3. write the row, then the byte count
  write_span(a.out + i * n_out, tile, n_out, tid, kBlockThreads);
  if (tid == 0) a.out_bytes[i] = start[K] / 8;
}

}  // namespace

#ifdef __CUDACC__  // the kernels with dynamic shared memory and the launch
                   // entries; tests/test_torch_cavlc_prologue.py runs the
                   // slice kernel above on CPU threads, compiled by g++
                   // against shims

namespace {

// K <= 32, n_out <= 256: a warp merges kWarpLanes consecutive lanes, whose
// tiles lie back to back in shared memory as their rows do in out.
__global__ void merge_warp(const int32_t* __restrict__ words,
                           const int32_t* __restrict__ bits,
                           int32_t* __restrict__ out,
                           int32_t* __restrict__ out_bits, int64_t n, int K,
                           int W, int n_out) {
  constexpr int L = kWarpLanes;
  extern __shared__ __align__(16) uint32_t smem[];
  const int warp = threadIdx.x >> 5;
  const int tid = threadIdx.x & 31;
  const int64_t i0 = ((int64_t)blockIdx.x * kBlockWarps + warp) * L;
  if (i0 >= n) return;  // a whole warp
  const int rows = (int)min((int64_t)L, n - i0);
  const int span = round4(L * n_out);
  uint32_t* tile = smem + warp * span;

  int lb[L];
#pragma unroll
  for (int l = 0; l < L; ++l)
    lb[l] = (l < rows && tid < K) ? __ldg(bits + (i0 + l) * K + tid) : 0;
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int q = tid; q < span / 4; q += 32)
    tile4[q] = make_uint4(0u, 0u, 0u, 0u);

  int start[L], nw[L], total[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    int s = lb[l];  // inclusive sum over the warp
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int u = __shfl_up_sync(kFull, s, d);
      if (tid >= d) s += u;
    }
    start[l] = s - lb[l];
    total[l] = __shfl_sync(kFull, s, 31);
    nw[l] = lb[l] > 0 ? min((lb[l] + 31) >> 5, W) : 0;
  }
  // string tid of lane i0 + l starts at src + l * K * W
  const int32_t* src = words + (i0 * K + tid) * W;
  uint32_t v[L];
#pragma unroll
  for (int l = 0; l < L; ++l)
    v[l] = nw[l] > 0 ? (uint32_t)__ldg(src + (int64_t)l * K * W) : 0u;
  __syncwarp();
#pragma unroll
  for (int l = 0; l < L; ++l) {
    uint32_t* row = tile + l * n_out;
    const int32_t* s = src + (int64_t)l * K * W;
    put(row, v[l], start[l], n_out);
    for (int t = 1; t < nw[l]; ++t)
      put(row, (uint32_t)__ldg(s + t), start[l] + 32 * t, n_out);
  }
  __syncwarp();
  write_span(out + i0 * n_out, tile, rows * n_out, tid, 32);
#pragma unroll
  for (int l = 0; l < L; ++l)
    if (tid == l && l < rows) out_bits[i0 + l] = total[l];
}

// Any K <= 1024, n_out <= 8192: a block of kBlockThreads threads a lane.
__global__ void merge_block(const int32_t* __restrict__ words,
                            const int32_t* __restrict__ bits,
                            int32_t* __restrict__ out,
                            int32_t* __restrict__ out_bits, int K, int W,
                            int n_out) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int tid = threadIdx.x;
  const int64_t i = blockIdx.x;
  uint32_t* tile = smem;
  int* start = reinterpret_cast<int*>(smem + round4(n_out));
  int* used = start + K + 1;

  // 1. zero the tile and stage the bit lengths (in start); then the
  // first warp turns them into the two exclusive prefix sums
  uint4* tile4 = reinterpret_cast<uint4*>(tile);
  for (int q = tid; q < round4(n_out) / 4; q += kBlockThreads)
    tile4[q] = make_uint4(0u, 0u, 0u, 0u);
  for (int k = tid; k < K; k += kBlockThreads)
    start[k] = __ldg(bits + i * K + k);
  __syncthreads();
  if (tid < 32) {
    int carry_bits = 0, carry_used = 0;
    for (int k0 = 0; k0 < K; k0 += 32) {
      const int k = k0 + tid;
      const int lb = k < K ? start[k] : 0;
      const int nw = lb > 0 ? min((lb + 31) >> 5, W) : 0;
      int sb = lb, su = nw;  // inclusive sums over the warp
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int ub = __shfl_up_sync(kFull, sb, d);
        const int uu = __shfl_up_sync(kFull, su, d);
        if (tid >= d) {
          sb += ub;
          su += uu;
        }
      }
      if (k < K) {
        start[k] = carry_bits + sb - lb;
        used[k] = carry_used + su - nw;
      }
      carry_bits += __shfl_sync(kFull, sb, 31);
      carry_used += __shfl_sync(kFull, su, 31);
    }
    if (tid == 0) {
      start[K] = carry_bits;
      used[K] = carry_used;
    }
  }
  __syncthreads();

  // 2. scatter the used words into the tile
  const int n_used = used[K];
  const int32_t* src = words + i * K * W;
  for (int j = tid; j < n_used; j += kBlockThreads) {
    int lo = 0, hi = K - 1;  // the last string k with used[k] <= j
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (used[mid] <= j) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int t = j - used[lo];
    put(tile, (uint32_t)__ldg(src + (int64_t)lo * W + t), start[lo] + 32 * t,
        n_out);
  }
  __syncthreads();

  // 3. write the row, then the total
  write_span(out + i * n_out, tile, n_out, tid, kBlockThreads);
  if (tid == 0) out_bits[i] = start[K];
}

}  // namespace

extern "C" int th264_merge_tree(const int32_t* words, const int32_t* bits,
                                int32_t* out, int32_t* out_bits, int64_t n,
                                int K, int W, int n_out, void* stream) {
  if (n <= 0) return 0;
  if (n_out < 1 || n_out > kMaxOut || K < 1 || K > kMaxK || W < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (K <= kWarpK && n_out <= kWarpOut) {
    const int64_t lanes = (int64_t)kBlockWarps * kWarpLanes;
    const int64_t blocks = (n + lanes - 1) / lanes;
    if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)kBlockWarps * round4(kWarpLanes * n_out) * 4;
    merge_warp<<<(unsigned)blocks, 32 * kBlockWarps, smem, st>>>(
        words, bits, out, out_bits, n, K, W, n_out);
  } else {
    if (n > 0x7fffffff) return (int)cudaErrorInvalidValue;
    const size_t smem =
        (size_t)(round4(n_out) + round4(2 * (K + 1))) * 4;
    merge_block<<<(unsigned)n, kBlockThreads, smem, st>>>(
        words, bits, out, out_bits, K, W, n_out);
  }
  return (int)cudaGetLastError();
}

// p: kSlicePtrs device pointers, n: kSliceInts ints, in `slice_args`'
// order (host arrays); a block of kBlockThreads threads a slice.
extern "C" int th264_merge_slices(void* const* p, const int* n,
                                  void* stream) {
  const SliceArgs a = slice_args(p, n);
  if (a.L <= 0) return 0;
  if (a.n_out < 1 || a.n_out > kMaxOut || a.C < 1 ||
      a.C + 3 > kMaxK || a.hdr_w < 1 || a.mb_w < 1)
    return (int)cudaErrorInvalidValue;
  merge_slices_kernel<<<a.L, kBlockThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The slice entry's blocks an SM that can be resident at once, out[0],
// and its threads a block, out[1] (the runtime's occupancy of its
// launch); returns the CUDA error.
extern "C" int th264_merge_slices_resident(int* out) {
  out[1] = kBlockThreads;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &out[0], merge_slices_kernel, kBlockThreads, 0);
}

#endif  // __CUDACC__
