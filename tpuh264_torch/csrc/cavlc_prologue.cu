// K13: the CAVLC prologue -- per MB and per chunk what K2 needs besides
// the levels: each chunk's nC, maxc, whether it codes a residual and
// whether it is present, the MB's header slots, and (P slices) each
// row's trailing skip_run -- in one launch over a dispatch's frames.
//
// Replaces: the work the JAX package fuses into its dispatch programs
// around the K2 pallas_call (tpuh264/kernels/entropy_tpu.py :627-797
// before `pack_blocks` at :798 for P slices, :480-567 for I slices), not
// a pallas_call.  Its plain version is `cavlc_cuda._prologue_plain`,
// built on entropy_gpu.py `pframe_pack_inputs` / `iframe_pack_inputs`.
//
// What it computes, per MB m of row (slice) i, column c, exactly as the
// plain version:
//  * the coded-coefficient count of every luma 4x4 block and chroma AC
//    block: P, an intra MB counts AC slots 1-15 when cbp_luma == 1, an
//    inter MB all 16 under its 8x8 group's cbp bit; I, slots 1-15 when
//    cbp_luma == 1; chroma AC all 15 when the (coded) cbp_chroma is 2;
//  * nC per block, the row-slice rule: the left block may lie in the
//    left MB, the top block only inside the MB; both -> (na + nt + 1) >>
//    1, one -> it, none -> 0; the luma-DC chunk takes block (0, 0)'s nC,
//    the chroma DC chunks -1;
//  * per chunk (0 luma DC / header, 1-16 luma AC in z-order, 17-18
//    chroma DC, 19-26 chroma AC) one int: nC + 1 (bits 0-7), maxc (bits
//    8-12), code_residual (bit 13), present (bit 14), and "shift" (bit
//    15: an intra MB's AC levels start at slot 1);
//  * the header slots (length, value): P, the skip_run before the MB,
//    mb_type (with ref_idx_l0 te(v) for nra > 1), the mvd se(v) pair or
//    the chroma mode and dqp, coded_block_pattern me(v) and dqp; every
//    length 0 for a skipped MB; I, mb_type, the chroma mode and dqp;
//  * P: each row's trailing skip_run as one MSB-first word and its
//    length, and the overflow flag where that length passes 32 bits.
// The values under zero-length slots are the plain version's too, so
// its outputs are equal int for int.
//
// What bounds it on the H100: bytes.  It reads the eight int32 fields of
// every MB and the int16 levels of the coded blocks only (a skipped MB
// reads none), and writes 27 + 2 nh ints an MB: at an interior 1080p x
// 4 RTC dispatch (130,560 MBs) ~31 MB, ~9 us at 3.35 TB/s.
//
// Design: a warp a row (slice), kWarps rows a block; lane l takes
// columns l, l + 32, .. in passes of 32.
//  * The skip runs: a ballot of the coded MBs of the pass; a lane's
//    previous coded MB is the highest set bit below it, else the carry
//    (the last coded column of the earlier passes, -1 at first).
//  * nC across MBs: each lane packs its MB's right-column counts (luma 4,
//    chroma 2 + 2, five bits each) and shuffles them one lane up; lane 0
//    takes the carry from lane 31 of the pass before.
//  * Levels: a lane loads only the blocks its masks count, 16-byte loads
//    (luma 32 bytes a block, chroma AC the MB's 240 bytes).
//  * The pass's 32 MBs' chunk ints and slots are contiguous in the
//    outputs: they are staged in shared memory and leave in coalesced
//    stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 4;    // rows a block, a warp each
constexpr int kChunks = 27;  // chunks an MB
constexpr int kMaxNh = 6;    // header slots an MB (P)
constexpr unsigned kFull = 0xffffffffu;

// tbl.CBP_INTER_INV: coded_block_pattern -> me(v) code number (inter)
__constant__ int kCbpInterInv[48] = {
    0,  2,  3,  7,  4,  8,  17, 13, 5,  18, 9,  14, 10, 15, 16, 11,
    1,  32, 33, 36, 34, 37, 44, 40, 35, 45, 38, 41, 39, 42, 43, 19,
    6,  24, 25, 20, 26, 21, 46, 28, 27, 47, 22, 29, 23, 30, 31, 12};

struct ProArgs {
  const int32_t *kind, *mode, *cmode, *cbp_l, *cbp_c, *mvdx, *mvdy, *refidx;
  const int16_t *luma_ac, *chroma_ac;  // [M, 256], [M, 120]
  int32_t *meta;                       // [M, 27]
  int32_t *hdr_l, *hdr_v;              // [M, nh]
  int32_t *tail;                       // [rows, 2] (word, bits); P only
  int32_t *ovf;                        // [1], set to 1 on an overflow
  int rows, C, pslice, nra, nh;
};

constexpr int kPtrs = 15;
constexpr int kInts = 4;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/cavlc_cuda.py `_k13_operands` builds them.  I slices pass null
// kind, mvdx, mvdy, refidx and tail.
inline ProArgs pro_args(void* const* p, const int* n) {
  ProArgs a;
  auto in = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  a.kind = in(0), a.mode = in(1), a.cmode = in(2), a.cbp_l = in(3);
  a.cbp_c = in(4), a.mvdx = in(5), a.mvdy = in(6), a.refidx = in(7);
  a.luma_ac = static_cast<const int16_t*>(p[8]);
  a.chroma_ac = static_cast<const int16_t*>(p[9]);
  a.meta = out(10), a.hdr_l = out(11), a.hdr_v = out(12);
  a.tail = out(13), a.ovf = out(14);
  a.rows = n[0], a.C = n[1], a.pslice = n[2], a.nra = n[3];
  a.nh = a.pslice ? 6 : 3;
  return a;
}

__device__ __forceinline__ int bit_length(unsigned x) {
  return 32 - __clz((int)x);
}

// ue(v) of v >= 0: (length, code number + 1)
__device__ __forceinline__ void ue(int v, int& len, int& val) {
  val = v + 1;
  len = 2 * bit_length((unsigned)val) - 1;
}

__device__ __forceinline__ int se_code(int v) {
  return v > 0 ? 2 * v - 1 : -2 * v;
}

// Nonzero int16 halves of an int4 of levels; `skip0` leaves out the first.
__device__ __forceinline__ int nz8(int4 v, bool skip0) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  int n = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    n += (!(skip0 && i == 0) && (w[i] & 0xffff) != 0) ? 1 : 0;
    n += ((uint32_t)w[i] >> 16) != 0u ? 1 : 0;
  }
  return n;
}

__device__ __forceinline__ int nc_of(bool a_ok, int na, bool b_ok, int nt) {
  return a_ok && b_ok ? (na + nt + 1) >> 1 : a_ok ? na : b_ok ? nt : 0;
}

// z-order chunk j (0-15) -> the raster block by * 4 + bx (blk_scan)
__device__ __forceinline__ int blk_scan(int j) {
  const int by = ((j >> 3) << 1) | ((j >> 1) & 1);
  const int bx = (((j >> 2) & 1) << 1) | (j & 1);
  return by * 4 + bx;
}

struct WarpMem {
  int32_t meta[32 * kChunks];
  int32_t hl[32 * kMaxNh], hv[32 * kMaxNh];
};

__global__ void __launch_bounds__(32 * kWarps)
    prologue_kernel(const __grid_constant__ ProArgs a) {
  __shared__ WarpMem mem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= a.rows) return;  // a whole warp
  WarpMem& w = mem[warp];
  const int C = a.C, nh = a.nh;
  int carry_prev = -1;  // the last coded column of the earlier passes
  int carry_y = 0, carry_v = 0;  // lane 31's right-column counts, the
                                 // pass before
  for (int c0 = 0; c0 < C; c0 += 32) {
    const int c = c0 + lane;
    const bool live = c < C;
    const size_t m = (size_t)row * C + (live ? c : 0);
    int kind = 2, mode = 0, cmode = 0, cbp_l = 0, cbp_c = 0, mvdx = 0;
    int mvdy = 0, refs = 0;
    if (live) {
      mode = a.mode[m], cmode = a.cmode[m];
      cbp_l = a.cbp_l[m], cbp_c = a.cbp_c[m];
      if (a.pslice) {
        kind = a.kind[m], mvdx = a.mvdx[m], mvdy = a.mvdy[m];
        refs = a.refidx ? a.refidx[m] : 0;
      }
    }
    const bool coded = kind != 0, intra = kind == 2, inter = kind == 1;
    if (!coded) cbp_c = 0;

    // coded-coefficient counts, masked as the nC rule reads them
    int ny[16], nu[4], nv[4];
#pragma unroll
    for (int b = 0; b < 16; ++b) ny[b] = 0;
#pragma unroll
    for (int b = 0; b < 4; ++b) nu[b] = nv[b] = 0;
    if (live && (intra ? cbp_l == 1 : inter && cbp_l != 0)) {
      const int4* lp = reinterpret_cast<const int4*>(a.luma_ac + m * 256);
#pragma unroll
      for (int b = 0; b < 16; ++b) {
        const int g = ((b >> 3) << 1) | ((b & 3) >> 1);  // its 8x8 group
        if (intra || ((cbp_l >> g) & 1))
          ny[b] = nz8(lp[2 * b], intra) + nz8(lp[2 * b + 1], false);
      }
    }
    if (live && cbp_c == 2) {
      const int4* cp = reinterpret_cast<const int4*>(a.chroma_ac + m * 120);
#pragma unroll
      for (int q = 0; q < 15; ++q) {
        const int4 v = cp[q];
        const int wv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int e = 8 * q + i;  // element e of [2][4][15]
          const int h = i & 1 ? (int)((uint32_t)wv[i >> 1] >> 16)
                              : (wv[i >> 1] & 0xffff);
          if (e < 60)
            nu[e / 15] += h != 0 ? 1 : 0;
          else
            nv[e / 15 - 4] += h != 0 ? 1 : 0;
        }
      }
    }

    // the left MB's right-column counts (five bits each): the lane
    // below's, or lane 0 the carry
    const int edge_y = ny[3] | ny[7] << 5 | ny[11] << 10 | ny[15] << 15 |
                       nu[1] << 20 | nu[3] << 25;
    const int edge_v = nv[1] | nv[3] << 5;
    int left_y = __shfl_up_sync(kFull, edge_y, 1);
    int left_v = __shfl_up_sync(kFull, edge_v, 1);
    if (lane == 0) left_y = carry_y, left_v = carry_v;
    carry_y = __shfl_sync(kFull, edge_y, 31);
    carry_v = __shfl_sync(kFull, edge_v, 31);
    const bool a_mb = c > 0;  // a left MB in the slice

    int ncy[16], ncu[4], ncv[4];
#pragma unroll
    for (int b = 0; b < 16; ++b) {
      const int by = b >> 2, bx = b & 3;
      const int na = bx > 0 ? ny[b - 1] : (left_y >> (5 * by)) & 31;
      ncy[b] = nc_of(bx > 0 || a_mb, na, by > 0, by > 0 ? ny[b - 4] : 0);
    }
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int by = b >> 1, bx = b & 1;
      const int nau = bx > 0 ? nu[b - 1] : (left_y >> (20 + 5 * by)) & 31;
      const int nav = bx > 0 ? nv[b - 1] : (left_v >> (5 * by)) & 31;
      ncu[b] = nc_of(bx > 0 || a_mb, nau, by > 0, by > 0 ? nu[b - 2] : 0);
      ncv[b] = nc_of(bx > 0 || a_mb, nav, by > 0, by > 0 ? nv[b - 2] : 0);
    }

    // the 27 chunk ints
    const bool shift = a.pslice ? intra : true;
    int32_t* mt = w.meta + lane * kChunks;
    auto chunk = [&](int k, int nc, int maxc, bool code, bool pres,
                     bool sh) {
      mt[k] = (nc + 1) | maxc << 8 | (code ? 1 << 13 : 0) |
              (pres ? 1 << 14 : 0) | (sh ? 1 << 15 : 0);
    };
    chunk(0, ncy[0], 16, a.pslice ? intra : true, coded, false);
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const bool pres = coded && (shift ? cbp_l == 1 : (cbp_l >> (j >> 2)) & 1);
      chunk(1 + j, ncy[blk_scan(j)], shift ? 15 : 16, true, pres, shift);
    }
    chunk(17, -1, 4, true, cbp_c >= 1, false);
    chunk(18, -1, 4, true, cbp_c >= 1, false);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      chunk(19 + q, q < 4 ? ncu[q] : ncv[q - 4], 15, true, cbp_c == 2, false);

    // the header slots
    int L[kMaxNh], V[kMaxNh];
    if (a.pslice) {
      const unsigned vote = __ballot_sync(kFull, live && coded);
      const unsigned below = vote & ((1u << lane) - 1u);
      const int prev = below ? c0 + 31 - __clz((int)below) : carry_prev;
      if (vote) carry_prev = c0 + 31 - __clz((int)vote);
      ue(c - prev - 1, L[0], V[0]);  // skip_run
      ue(intra ? 6 + mode + 4 * cbp_c + 12 * cbp_l : 0, L[1], V[1]);
      if (a.nra > 1 && !intra) {  // mb_type ue(0) ++ ref_idx_l0 te(v)
        int tl = 1, tv = 1 - refs;
        if (a.nra > 2) ue(refs, tl, tv);
        L[1] = 1 + tl, V[1] = (1 << tl) | tv;
      }
      ue(intra ? cmode : se_code(mvdx), L[2], V[2]);
      ue(intra ? 0 : se_code(mvdy), L[3], V[3]);  // intra: dqp se(0)
      ue(kCbpInterInv[cbp_l | cbp_c << 4], L[4], V[4]);
      if (!inter) L[4] = 0;
      L[5] = inter && (cbp_l | cbp_c) > 0 ? 1 : 0, V[5] = 1;
      if (!coded) {
#pragma unroll
        for (int k = 0; k < kMaxNh; ++k) L[k] = 0;
      }
    } else {
      ue(1 + mode + 4 * cbp_c + 12 * cbp_l, L[0], V[0]);
      ue(cmode, L[1], V[1]);
      L[2] = V[2] = 1;  // mb_qp_delta se(0)
    }
#pragma unroll
    for (int k = 0; k < kMaxNh; ++k)
      if (k < nh) w.hl[lane * nh + k] = L[k], w.hv[lane * nh + k] = V[k];

    // the pass's MBs leave in coalesced stores
    __syncwarp();
    const int n_live = min(32, C - c0);
    const size_t m0 = (size_t)row * C + c0;
    for (int i = lane; i < n_live * kChunks; i += 32)
      a.meta[m0 * kChunks + i] = w.meta[i];
    for (int i = lane; i < n_live * nh; i += 32) {
      a.hdr_l[m0 * nh + i] = w.hl[i];
      a.hdr_v[m0 * nh + i] = w.hv[i];
    }
    __syncwarp();
  }
  if (a.pslice && lane == 0) {  // the row's trailing skip_run
    const int trail = C - 1 - carry_prev;
    int tl = 0, tv = 0;
    uint32_t word = 0u;
    if (trail > 0) {
      ue(trail, tl, tv);
      word = (uint32_t)((uint64_t)(uint32_t)tv << min(max(32 - tl, 0), 31));
    }
    a.tail[2 * row] = (int32_t)word;
    a.tail[2 * row + 1] = tl;
    if (tl > 32) *a.ovf = 1;  // one word carries the run
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_cavlc_prologue.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `pro_args`' order (host
// arrays); a warp a row.
extern "C" int th264_cavlc_prologue(void* const* p, const int* n,
                                    void* stream) {
  const ProArgs a = pro_args(p, n);
  if (a.rows <= 0 || a.C <= 0) return 0;
  prologue_kernel<<<(a.rows + kWarps - 1) / kWarps, 32 * kWarps, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
