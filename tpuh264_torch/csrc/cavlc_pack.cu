// K2: fused CAVLC symbolise + pack of 4x4 residual blocks.
//
// Replaces: tpuh264/kernels/cavlc_pallas.py `_cavlc_kernel` (pallas_call
// at cavlc_pallas.py:425 in `_pack_blocks_dev`, entry `pack_blocks`
// :329).  Plain version: `cavlc_cuda.block_slots` + `pack_slots`.
//
// What it computes, per block (row): up to `nh` MB-header slots, then
// (unless code_residual is 0) coeff_token, trailing-one signs, the level
// prefix/suffix chain with escapes, total_zeros (chroma DC included)
// and run_before (H.264 9.2), written MSB-first into n_w 32-bit words
// plus the total bit length.  Bits past n_w words are dropped (the
// caller's overflow flags route such dispatches to the host packer).
//
// What bounds it on the H100: device memory.  A row reads 64 B of levels,
// 12 B of nc / maxc / code_residual and 8 * nh B of header slots and
// writes 4 * (n_w + 1) B: at the 1080p x 4 P dispatch (3.5 M rows, nh 6,
// n_w 20) 733 MB, ~219 us at 3.35 TB/s.  The VLC work is small per row
// but sequential and branchy, and most rows of a P dispatch are empty.
//
// Design: one block of 128 threads per 128 consecutive rows.
//  1. The block's contiguous inputs are staged in shared memory with
//     coalesced loads (levels as 16-byte vectors into rows padded to 20
//     words, so a thread's 4 vector reads of its row are conflict-free).
//  2. Thread t emits row t's header slots, derives the row's nonzero
//     mask, and finishes the rows that need no level chain (no residual,
//     or an all-zero block: one coeff_token).  Rows with coefficients go
//     on a block-local work list (warp ballot, one shared atomic a warp).
//  3. The threads take the work list densely, so the level chain runs in
//     full warps, and walk only the nonzero positions (a bit mask, clz):
//     a warp's loop count is its largest total_coeff, not 16.
//  4. Strings are assembled in a zeroed shared tile (row stride n_w | 1,
//     odd: conflict-free), never in per-thread arrays, and the block's
//     contiguous [rows, n_w] output and bit lengths leave coalesced.
// The emission arithmetic is the plain version's exactly (shift clips at
// [0, 31] and [1, 31], zero-length slots ignored, the long prefix's zero
// high part skipped, truncation at n_w words with the bit length still
// counting every bit), so the words are identical in every case.  The
// VLC tables are __constant__ arrays generated from the port's
// entropy/cavlc_tables.py at build time (cavlc_tables.cuh).
//
// The symbols entry (th264_pack_symbols), the GOP pipeline's: a
// row is chunk k of MB m, its 16 levels read straight from the symbols'
// luma_dc / luma_ac (z-order block, an intra MB's AC from slot 1) /
// chroma_dc / chroma_ac arrays (16-byte loads for the luma blocks) and
// its nC, maxc, code_residual and presence from K13's chunk int, the
// MB's header slots on chunk 0; so no [.., 27, 16] level array is built.
// An absent chunk writes bit length 0 and zero words (what `_merge_mbs`'
// masks did), a present one past n_w words sets the overflow flag.
// Phases 2-4 are the block entry's; its shared memory is static (n_w <=
// 32), so the CPU-thread tests build it.  Plain version:
// `cavlc_cuda._pack_symbols_plain`.  Bound: each chunk's int, the coded
// chunks' levels and the MB headers in, n_w + 1 words a chunk out.

#include <cuda_runtime.h>
#include <stdint.h>

#include "cavlc_tables.cuh"  // kCT[5*17*4], kTZ[15*16], kTZC[3*4], kRB[7*15]

namespace {

constexpr int kRowsPB = 128;  // rows (and threads) per block
constexpr int kLvW = 20;      // shared words per levels row (16 used)

__device__ __forceinline__ int clip(int x, int lo, int hi) {
  return x < lo ? lo : (x > hi ? hi : x);
}

// MSB-first writer into one row of the shared tile (zeroed beforehand)
struct BitOut {
  uint32_t* w;
  int n_w;
  int off;

  __device__ void put(uint32_t val, int len) {
    if (len <= 0) return;  // dead slot: value ignored
    const int end = (off & 31) + len;
    const int h0 = off >> 5;
    const uint32_t c_hi = end <= 32 ? val << clip(32 - end, 0, 31)
                                    : val >> clip(end - 32, 0, 31);
    const uint32_t c_lo = end > 32 ? val << clip(64 - end, 1, 31) : 0u;
    if (h0 < n_w) w[h0] |= c_hi;
    if (c_lo != 0u && h0 + 1 < n_w) w[h0 + 1] |= c_lo;
    off += len;
  }
  __device__ void skip(int len) {
    if (len > 0) off += len;
  }
};

__device__ __forceinline__ int ct_ctx(int nc) {
  return nc < 0 ? 4 : nc < 2 ? 0 : nc < 4 ? 1 : nc < 8 ? 2 : 3;
}

// coeff_token .. run_before of one block with total_coeff > 0
__device__ void pack_levels(BitOut& o, const int32_t* lv, uint32_t nz,
                            uint32_t big, int nc, int maxc) {
  const int total = __popc(nz);
  const int last_big = big ? 31 - __clz(big) : -1;
  const int t1 = min(3, __popc(last_big >= 0 ? nz >> (last_big + 1) : nz));
  const int tok = kCT[(ct_ctx(nc) * 17 + total) * 4 + t1];
  o.put((uint32_t)(tok & 0xFFFF), tok >> 16);

  // level chain over the nonzeros, descending: the suffix length carries
  int sl = (total > 10 && t1 < 3) ? 1 : 0;
  int above = 0;  // nonzeros at higher positions
  for (uint32_t m = nz; m; ++above) {
    const int j = 31 - __clz(m);
    m ^= 1u << j;
    const int l = lv[j];
    if (j > last_big && above < t1) {
      o.put(l < 0 ? 1u : 0u, 1);  // trailing-one sign
      continue;
    }
    const int a = abs(l);
    int lc = 2 * a - 2 + (l < 0);
    if (above == t1 && t1 < 3) lc -= 2;
    lc = max(lc, 0);
    const int base0 = sl == 0 ? 30 : (15 << sl);
    const bool small0 = sl == 0 && lc < 14;
    const bool mid0 = sl == 0 && lc >= 14 && lc < 30;
    const bool smallp = sl > 0 && lc < (15 << sl);
    const int rem0 = max(lc - base0, 0);
    const int p = max(15, 3 + (31 - __clz(rem0 + 4096)));
    const int plen = small0 ? lc + 1
                     : mid0 ? 15
                     : smallp ? (lc >> sl) + 1
                              : p + 1;
    const int sufl = small0 ? 0 : mid0 ? 4 : smallp ? sl : p - 3;
    const int sufv =
        small0 ? 0
        : mid0 ? lc - 14
        : smallp ? (lc & ((1 << sl) - 1))
                 : rem0 - ((int)(1u << (p - 3)) - 4096);
    const int zhi = max(plen - 16, 0);
    o.skip(zhi);  // the all-zero high part of a long prefix
    o.put((1u << sufl) | (uint32_t)sufv, plen - zhi + sufl);
    int new_sl = max(sl, 1);
    if (a > (3 << (new_sl - 1)) && new_sl < 6) ++new_sl;
    sl = new_sl;
  }

  if (total < maxc) {
    const int tz = (31 - __clz(nz)) + 1 - total;
    const int e = maxc == 4
        ? kTZC[clip(total - 1, 0, 2) * 4 + clip(tz, 0, 3)]
        : kTZ[clip(total - 1, 0, 14) * 16 + clip(tz, 0, 15)];
    o.put((uint32_t)(e & 0xFFFF), e >> 16);
  }

  // run_before, nonzero positions 15..1 descending
  above = 0;
  for (uint32_t m = nz; m; ++above) {
    const int j = 31 - __clz(m);
    m ^= 1u << j;
    const int zeros_below = j - (total - above - 1);
    if (j >= 1 && above < total - 1 && zeros_below > 0) {
      const int run = j - (m ? 31 - __clz(m) : -1) - 1;
      const int e = kRB[(clip(zeros_below, 1, 7) - 1) * 15 + clip(run, 0, 14)];
      o.put((uint32_t)(e & 0xFFFF), e >> 16);
    }
  }
}

// z-order chunk j (0-15) -> the raster block by * 4 + bx (blk_scan)
__device__ __forceinline__ int blk_scan(int j) {
  const int by = ((j >> 3) << 1) | ((j >> 1) & 1);
  const int bx = (((j >> 2) & 1) << 1) | (j & 1);
  return by * 4 + bx;
}

// The symbols entry (th264_pack_symbols): a row is chunk k of MB m (row
// 27 m + k), its levels read straight from the MB's symbol arrays, its
// nC / maxc / code_residual / presence from K13's chunk int, the MB's
// header slots (K13's) on chunk 0.  An absent chunk writes bit length 0
// and zero words; a present one longer than n_w words sets the overflow
// flag.
struct SymArgs {
  const int16_t *luma_dc, *luma_ac, *chroma_dc, *chroma_ac;  // [M, 16],
                                              // [M, 256], [M, 8], [M, 120]
  const int32_t *meta, *hdr_l, *hdr_v;        // [M, 27], [M, nh] x 2
  int32_t *words, *bitlen, *ovf;              // [M, 27, n_w], [M, 27], [1]
  int rows, nh, n_w;                          // rows = 27 M
};

constexpr int kSymPtrs = 10;
constexpr int kSymInts = 3;
constexpr int kMaxWs = 33;  // a row's shared words: n_w | 1, n_w <= 32

// The arguments from the entry's pointer and int arrays, in the order
// kernels/cavlc_cuda.py `_k2_symbol_operands` builds them.
inline SymArgs sym_args(void* const* p, const int* n) {
  SymArgs a;
  auto lev = [p](int i) { return static_cast<const int16_t*>(p[i]); };
  auto in = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  a.luma_dc = lev(0), a.luma_ac = lev(1), a.chroma_dc = lev(2);
  a.chroma_ac = lev(3), a.meta = in(4), a.hdr_l = in(5), a.hdr_v = in(6);
  a.words = out(7), a.bitlen = out(8), a.ovf = out(9);
  a.rows = n[0], a.nh = n[1], a.n_w = n[2];
  return a;
}

// The 16 int16 levels of a 16-byte aligned pair of vectors, as ints.
__device__ __forceinline__ void unpack16(const int16_t* src, int* h) {
  const int4* v = reinterpret_cast<const int4*>(src);
  const int4 a = v[0], b = v[1];
  const int w[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    h[2 * i] = (int)(int16_t)(w[i] & 0xffff);
    h[2 * i + 1] = w[i] >> 16;
  }
}

__global__ void __launch_bounds__(kRowsPB)
    pack_symbols_kernel(const __grid_constant__ SymArgs a) {
  __shared__ __align__(16) int32_t s_lv[kRowsPB * kLvW];
  __shared__ uint32_t s_out[kRowsPB * kMaxWs];
  __shared__ int32_t s_meta[kRowsPB], s_off[kRowsPB], s_work[kRowsPB];
  __shared__ int32_t s_cnt[1];
  const int n_w = a.n_w, ws = n_w | 1, nh = a.nh;
  const int row0 = blockIdx.x * kRowsPB;
  const int rows = min(kRowsPB, a.rows - row0);
  const int t = threadIdx.x;
  const int r = row0 + t, m = r / 27, k = r - 27 * m;

  // 1. the chunk int and the row's levels
  const int meta = t < rows ? a.meta[r] : 0;
  const bool present = (meta >> 14) & 1;
  const bool code = present && ((meta >> 13) & 1);
  const int nc = (meta & 255) - 1, maxc = (meta >> 8) & 31;
  int lv[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) lv[i] = 0;
  if (code) {
    if (k <= 16) {
      int h[16];
      unpack16(k == 0 ? a.luma_dc + (size_t)m * 16
                      : a.luma_ac + (size_t)m * 256 + 16 * blk_scan(k - 1),
               h);
      const bool shift = (meta >> 15) & 1;  // intra AC: slots 1-15
#pragma unroll
      for (int i = 0; i < 16; ++i)
        lv[i] = shift ? (i < 15 ? h[i + 1] : 0) : h[i];
    } else if (k <= 18) {
      const int16_t* src = a.chroma_dc + (size_t)m * 8 + 4 * (k - 17);
#pragma unroll
      for (int i = 0; i < 4; ++i) lv[i] = src[i];
    } else {
      const int16_t* src = a.chroma_ac + (size_t)m * 120 + 15 * (k - 19);
#pragma unroll
      for (int i = 0; i < 15; ++i) lv[i] = src[i];
    }
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) s_lv[t * kLvW + i] = lv[i];
  s_meta[t] = meta;
  for (int i = t; i < rows * ws; i += kRowsPB) s_out[i] = 0u;
  if (t == 0) s_cnt[0] = 0;
  __syncthreads();

  // 2. the header slots (chunk 0), the nonzero mask, and the rows
  // without a level chain
  bool chain = false;
  int off = 0;
  if (t < rows && present) {
    BitOut o{s_out + t * ws, n_w, 0};
    if (k == 0)
      for (int j = 0; j < nh; ++j)
        o.put((uint32_t)a.hdr_v[(size_t)m * nh + j],
              a.hdr_l[(size_t)m * nh + j]);
    if (code) {
      uint32_t nz = 0u;
#pragma unroll
      for (int j = 0; j < 16; ++j) nz |= (lv[j] != 0 ? 1u : 0u) << j;
      if (nz == 0u) {  // coeff_token of an empty block
        const int tok = kCT[ct_ctx(nc) * 17 * 4];
        o.put((uint32_t)(tok & 0xFFFF), tok >> 16);
      }
      chain = nz != 0u;
    }
    off = o.off;
  }
  s_off[t] = off;
  const unsigned vote = __ballot_sync(0xFFFFFFFFu, chain);
  const int lane = t & 31;
  int base = 0;
  if (lane == 0 && vote) base = atomicAdd(s_cnt, __popc(vote));
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  if (chain) s_work[base + __popc(vote & ((1u << lane) - 1u))] = t;
  __syncthreads();

  // 3. the level chains, one work-list row per thread
  if (t < s_cnt[0]) {
    const int row = s_work[t];
    const int32_t* l = s_lv + row * kLvW;
    uint32_t nz = 0u, big = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      nz |= (l[j] != 0 ? 1u : 0u) << j;
      big |= (abs(l[j]) > 1 ? 1u : 0u) << j;
    }
    const int rm = s_meta[row];
    BitOut o{s_out + row * ws, n_w, s_off[row]};
    pack_levels(o, l, nz, big, (rm & 255) - 1, (rm >> 8) & 31);
    s_off[row] = o.off;
  }
  __syncthreads();

  // 4. coalesced write-back of the contiguous [rows, n_w] words
  int32_t* wo = a.words + (size_t)row0 * n_w;
  const unsigned inv = ((1u << 20) + n_w - 1) / n_w;  // i / n_w, i < 2^14
  for (int i = t; i < rows * n_w; i += kRowsPB) {
    const int q = (int)(((unsigned)i * inv) >> 20);
    wo[i] = (int32_t)s_out[q * ws + i - q * n_w];
  }
  if (t < rows) {
    a.bitlen[r] = s_off[t];
    if (s_off[t] > 32 * n_w) *a.ovf = 1;  // K2 truncated the string
  }
}

}  // namespace

#ifdef __CUDACC__  // the block entry (dynamic shared memory) and both
                   // launch entries; tests/test_torch_cavlc_prologue.py
                   // runs the symbols kernel above on CPU threads,
                   // compiled by g++ against shims

namespace {

__global__ void __launch_bounds__(kRowsPB) pack_blocks_kernel(
    const int32_t* __restrict__ levels, const int32_t* __restrict__ nc_a,
    const int32_t* __restrict__ maxc_a, const int32_t* __restrict__ cr_a,
    const int32_t* __restrict__ hl, const int32_t* __restrict__ hv,
    int32_t* __restrict__ words, int32_t* __restrict__ bitlen, int64_t n,
    int nh, int n_w) {
  extern __shared__ __align__(16) int32_t smem[];
  int32_t* s_lv = smem;                      // [kRowsPB][kLvW]
  int32_t* s_nc = s_lv + kRowsPB * kLvW;     // [kRowsPB]
  int32_t* s_mc = s_nc + kRowsPB;
  int32_t* s_cr = s_mc + kRowsPB;
  int32_t* s_off = s_cr + kRowsPB;           // bits written per row
  int32_t* s_work = s_off + kRowsPB;         // rows with coefficients
  int32_t* s_cnt = s_work + kRowsPB;         // [4]: work list length
  uint32_t* s_out = reinterpret_cast<uint32_t*>(s_cnt + 4);  // [rows][ws]
  int32_t* s_hl = reinterpret_cast<int32_t*>(s_out) + kRowsPB * (n_w | 1);
  int32_t* s_hv = s_hl + kRowsPB * nh;
  const int ws = n_w | 1;

  const int64_t row0 = (int64_t)blockIdx.x * kRowsPB;
  const int rows = (int)min((int64_t)kRowsPB, n - row0);
  const int t = threadIdx.x;

  // 1. coalesced staging of the block's rows: every load is issued
  // before the first shared store, so the block waits on memory once
  const int4* lv4 = reinterpret_cast<const int4*>(levels + row0 * 16);
  int4 lvv[4];
  int32_t hlv[8], hvv[8];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (t + k * kRowsPB < rows * 4) lvv[k] = lv4[t + k * kRowsPB];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = t + k * kRowsPB;
    if (i < rows * nh) {
      hlv[k] = hl[row0 * nh + i];
      hvv[k] = hv[row0 * nh + i];
    }
  }
  int32_t ncv = 0, mcv = 0, crv = 0;
  if (t < rows) {
    ncv = nc_a[row0 + t];
    mcv = maxc_a[row0 + t];
    crv = cr_a[row0 + t];
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int i = t + k * kRowsPB;
    if (i < rows * 4)
      *reinterpret_cast<int4*>(s_lv + (i >> 2) * kLvW + 4 * (i & 3)) = lvv[k];
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const int i = t + k * kRowsPB;
    if (i < rows * nh) {
      s_hl[i] = hlv[k];
      s_hv[i] = hvv[k];
    }
  }
  s_nc[t] = ncv;
  s_mc[t] = mcv;
  s_cr[t] = crv;
  for (int i = t; i < rows * ws; i += kRowsPB) s_out[i] = 0u;
  if (t == 0) s_cnt[0] = 0;
  __syncthreads();

  // 2. header slots, the nonzero mask, and the rows without a level chain
  bool chain = false;
  if (t < rows) {
    BitOut o{s_out + t * ws, n_w, 0};
    for (int k = 0; k < nh; ++k)
      o.put((uint32_t)s_hv[t * nh + k], s_hl[t * nh + k]);
    if (s_cr[t] != 0) {
      uint32_t nz = 0u;
      const int4* r4 = reinterpret_cast<const int4*>(s_lv + t * kLvW);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int4 v = r4[q];
        nz |= (v.x != 0 ? 1u : 0u) << (4 * q);
        nz |= (v.y != 0 ? 2u : 0u) << (4 * q);
        nz |= (v.z != 0 ? 4u : 0u) << (4 * q);
        nz |= (v.w != 0 ? 8u : 0u) << (4 * q);
      }
      if (nz == 0u) {  // coeff_token of an empty block
        const int tok = kCT[ct_ctx(s_nc[t]) * 17 * 4];
        o.put((uint32_t)(tok & 0xFFFF), tok >> 16);
      }
      chain = nz != 0u;
    }
    s_off[t] = o.off;
  }
  const unsigned vote = __ballot_sync(0xFFFFFFFFu, chain);
  const int lane = t & 31;
  int base = 0;
  if (lane == 0 && vote) base = atomicAdd(s_cnt, __popc(vote));
  base = __shfl_sync(0xFFFFFFFFu, base, 0);
  if (chain) s_work[base + __popc(vote & ((1u << lane) - 1u))] = t;
  __syncthreads();

  // 3. the level chains, one work-list row per thread
  if (t < s_cnt[0]) {
    const int row = s_work[t];
    const int32_t* lv = s_lv + row * kLvW;
    uint32_t nz = 0u, big = 0u;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      nz |= (lv[j] != 0 ? 1u : 0u) << j;
      big |= (abs(lv[j]) > 1 ? 1u : 0u) << j;
    }
    BitOut o{s_out + row * ws, n_w, s_off[row]};
    pack_levels(o, lv, nz, big, s_nc[row], s_mc[row]);
    s_off[row] = o.off;
  }
  __syncthreads();

  // 4. coalesced write-back of the contiguous [rows, n_w] words
  int32_t* wo = words + row0 * n_w;
  const unsigned inv = ((1u << 20) + n_w - 1) / n_w;  // i / n_w, i < 2^14
  for (int i = t; i < rows * n_w; i += kRowsPB) {
    const int r = (int)(((unsigned)i * inv) >> 20);
    wo[i] = (int32_t)s_out[r * ws + i - r * n_w];
  }
  if (t < rows) bitlen[row0 + t] = s_off[t];
}

}  // namespace

extern "C" int th264_pack_blocks(const int32_t* levels, const int32_t* nc,
                                 const int32_t* maxc, const int32_t* code_res,
                                 const int32_t* hdr_len,
                                 const int32_t* hdr_val, int32_t* words,
                                 int32_t* bitlen, int64_t n, int nh, int n_w,
                                 void* stream) {
  if (n <= 0) return 0;
  if (n_w < 1 || n_w > 32 || nh < 0 || nh > 8) return (int)cudaErrorInvalidValue;
  const size_t smem =
      sizeof(int32_t) * (kRowsPB * (kLvW + 5 + (n_w | 1) + 2 * nh) + 4);
  const int64_t blocks = (n + kRowsPB - 1) / kRowsPB;
  pack_blocks_kernel<<<(unsigned)blocks, kRowsPB, smem, (cudaStream_t)stream>>>(
      levels, nc, maxc, code_res, hdr_len, hdr_val, words, bitlen, n, nh,
      n_w);
  return (int)cudaGetLastError();
}

// p: kSymPtrs device pointers, n: kSymInts ints, in `sym_args`' order
// (host arrays); a block a kRowsPB rows.
extern "C" int th264_pack_symbols(void* const* p, const int* n,
                                  void* stream) {
  const SymArgs a = sym_args(p, n);
  if (a.rows <= 0) return 0;
  if (a.n_w < 1 || a.n_w > 32 || a.nh < 0 || a.nh > 8)
    return (int)cudaErrorInvalidValue;
  pack_symbols_kernel<<<(a.rows + kRowsPB - 1) / kRowsPB, kRowsPB, 0,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
