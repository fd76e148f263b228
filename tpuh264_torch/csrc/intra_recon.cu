// D2: the intra-reconstruction column scan of the decoders (Intra_16x16
// DC / H luma and DC / H chroma prediction from the left MB, plus the
// residuals it decodes from the parsed levels, clipped to 0..255), a
// block of warps per MB row.
//
// Replaces: the jax.lax.scan of tpuh264/kernels/pframe.py
// `decode_pframe_rows_multi` (:1021; substep :1167, scan :1218) with its
// intra residuals (:1129-1148), and of tpuh264/kernels/iframe.py
// `decode_iframe_scan` (:336, scan :404) with its residuals (:365-369),
// not pallas_calls.  Its plain PyTorch version is `kernels/iframe.py`
// `_intra_recon_scan_plain` (called with i44 None): `_intra_residuals`,
// then the column loop.
//
// What it computes, exactly as the plain version: MB (lane, c) of an
// intra lane position decodes its residuals from the levels as
// `_intra_residuals` does (luma DC always, luma AC where cbp_luma == 1,
// chroma DC where cbp_chroma >= 1, chroma AC where cbp_chroma == 2;
// intra16_common.cuh `block_residual`, K8's code) and takes its
// prediction from the left MB's right sample column (luma: DC (sum of the
// 16 + 8) >> 4 where mode == 2, else H, the left sample of its row;
// chroma: DC per 4-row half (sum of the 4 + 2) >> 2 where cmode == 0,
// else H); in column 0, as the JAX scans with their zero carry, DC is 128
// and H predicts 0 (no legal stream codes H there; the encoder codes
// column 0 as DC).  It adds the residual and clips to 0..255.  An MB
// whose is_intra is 0 takes `other` instead (the inter reconstruction),
// reads no levels, and serves as the next MB's left neighbour all the
// same.  Without `other` every MB is intra (the I decode).  `other` and
// the output are int32 of any value: nothing here assumes samples in
// 0..255.
//
// What bounds it on the H100: bytes.  Row slices never predict across
// MB rows, so the S x R MB rows are independent lanes (272 at 1080p x
// 4), chained along their C columns only through the left sample
// column, and only where the column is intra: an MB that takes `other`
// breaks the chain.  Each MB's 1,536 bytes of output come either from
// `other` or from the levels, never both, so the least the function must
// move is is_intra (a byte), an intra MB's mode, cmode and cbps and its
// levels (at most 800 bytes), or another MB's 1,536 bytes of `other`,
// and the output: 100.7 MB, 0.030 ms, for a 1080p x 4 P frame without
// intra MBs; ~77 MB, 0.023 ms, for its IDR.
//
// Design: a block a lane, a team as K8's (wavefront.cu): one prediction
// warp whose chain is only the prediction, and kWorkers worker warps
// that run ahead of it.  (The first design, one warp a lane, put each
// intra MB's residual decode on the chain: ~2,400 cycles a column, 15% of
// the IDR's bound.)
//  * Worker w takes columns w, w + kWorkers, ..., kAhead of them loading
//    ahead in registers (levels if the column is intra, else `other`:
//    the per-MB flags, 32 columns at a time, one column a thread, a
//    window ahead, and a shuffle hands column x's flags to the warp).  An
//    intra column's levels (those its cbps code: two 16-byte loads a
//    thread) go through the worker's shared staging, a lane decodes one
//    4x4 block (lanes 0-15 luma, 16-23 chroma: `block_residual`) into the
//    column's slot of a ring of kRing columns in shared memory.  A
//    column that takes `other` the worker copies to the output, and where
//    the next column is intra it leaves its right sample column (the
//    next MB's left) in the slot.  The ring holds int32: with `other` of
//    any value a prediction is any int32, and int16 residuals saturated
//    as K8's would not be exact then.  So the copies of a P frame without
//    intra MBs keep kWorkers x kAhead = 8 columns in flight a lane.
//  * Each slot has a ready count (the column + 1, released by its worker
//    after the slot is written); one consumed count (the columns the
//    prediction warp is done with) lets a worker reuse slot c % kRing for
//    column c once column c - kRing is consumed.  The counts are CTA-scope
//    acquire / release on shared addresses (as generic addresses they
//    compiled to generic loads and stores: 13% slower on the IDR).  Every
//    wait is `wait_local`, which the tests run on CPU threads as a fiber
//    that yields.
//  * Measured on an H100 (tools/time_refs.py --k5-variant): 4 workers
//    were the fastest on the IDR (2, 3 and 5 slower, rings of 10-24 no
//    faster); 6 or 8 workers (in earlier versions) ran 1.6-1.7x slower,
//    as if a third block no longer fitted an SM (272 lanes, 132 SMs).
//    What holds the IDR is issue: the workers' residual decode shares
//    each SM's schedulers with the prediction warps of two or three
//    lanes.
//  * The prediction warp walks the columns: for an intra column it takes
//    the residuals of the slot, the left samples by shuffles from the
//    threads whose chunks ended the previous MB's rows (t | 12, chroma t
//    | 4), DC sums by xor-shuffles (luma over t bits 0, 1, 4 and both
//    chunks; chroma over bits 0, 1), adds, clips, stores; for a column
//    that takes `other` before an intra one, it reads the left samples
//    the worker left in the slot.
//  * The Intra_4x4 route (`i44`, the decoders of sessions with
//    `intra44`): the template instance kI44, picked by the entry where
//    i4modes is given, so that the instance without it keeps its code and
//    registers.  Its plain version is `_intra_recon_scan_plain` with i44:
//    kernels/intra44.py `decode_mb`, replacing the luma of every MB whose
//    mode is 4 (tpuh264/kernels/iframe.py :372-376; intra44.py:338).  A
//    worker loads such an MB's 16 luma blocks of levels whatever its cbps
//    say (slot 0 a level too; from the i44 levels, `ac44`) and its 16
//    block modes in place of the luma DC, decodes the blocks'
//    residuals as ever (`block_residual44`: every position dequantised as
//    AC at the i44 QP) and leaves the modes, clamped to 0..8 as `_select`
//    clamps them, beside the slot.  The prediction warp walks the 16
//    blocks by their 10 dependency levels through the MB's samples in
//    shared memory (intra44_common.cuh), two blocks at once on the six
//    levels that have two: each half-warp one block, lanes 0-12 of it
//    reading its 13 neighbours, every lane its pixel's taps by shuffles
//    within its half and its block's DC from the samples, adding the
//    residual, clipping and storing (lanes 16-31 store nothing on a level
//    of one block); then each thread reads its two luma chunks back.
//    Chroma is as for any intra MB.  What holds the route is the chain of
//    10 dependent steps an MB and the issue that the prediction warp
//    shares with the workers, not bytes (three workers were 3% faster
//    than four on an all-Intra_4x4 IDR, four the fastest on the
//    Intra_16x16 one: PERF.md).
//  * A thread owns three 16-byte chunks of every MB: luma chunks t and
//    t + 32 and chunk t & 15 of chroma plane t >> 4, in the residuals'
//    4x4-block order (by, bx, y, x).  A chunk is the 4 samples of one
//    4x4 block row, so it is also 4 adjacent samples of the raster MB:
//    `other` and the output are read and written at that raster place.
//    Every global load and store of samples is 16 bytes, a warp's
//    covering whole 512-byte (luma) and 256-byte (chroma) spans.  The
//    level fields may be strided views of one record buffer (the GOP
//    decode's [.., 400] int16 slots): each field comes with its MB stride.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"  // quantiser, load_levels, block_residual
#include "intra44_common.cuh"  // the Intra_4x4 neighbours and predictor

#ifdef __CUDACC__
namespace {
// acquire / release at CTA scope on a flag in shared memory (a shared
// address: as a generic one, each was a generic load or store), and the
// pause of a wait loop
__device__ __forceinline__ unsigned cta_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.shared.u32 %0, [%1];"
               : "=r"(v)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}
__device__ __forceinline__ void cta_release(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.shared.u32 [%0], %1;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "r"(v)
               : "memory");
}
__device__ __forceinline__ void cl_pause() { __nanosleep(20); }
}  // namespace
#endif

// The ring's columns and the worker warps; the tests build the source
// with a smaller ring and fewer workers, so that short lanes wrap the
// ring, and tools/time_refs.py times other choices.
#ifndef K5_RING
#define K5_RING 8
#endif
#ifndef K5_WORKERS
#define K5_WORKERS 4
#endif

namespace {

constexpr int kRing = K5_RING;        // columns in the shared ring
constexpr int kWorkers = K5_WORKERS;  // worker warps a lane
constexpr int kAhead = 2;             // a worker's columns loading ahead
constexpr int kThreads = 32 * (1 + kWorkers);
constexpr unsigned kFull = 0xffffffffu;

struct Args {
  const int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [lanes, C], MB-strided
  const uint8_t* is_intra;   // [lanes, C] bool; null: every MB intra
                             // (then `other` is too)
  const int16_t *dc, *ac, *cdc, *cac;  // levels, MBSymbols' layouts
  const int32_t *oy, *ou, *ov;         // other, raster; may be null
  // the Intra_4x4 route's: i4modes [lanes, C, 16] int16 (null: no route),
  // the luma levels of its MBs [lanes, C, 16, 16] int16, the tap words
  const int16_t *i4m, *ac44;
  const uint32_t* taps;
  int32_t *y, *u, *v;                  // output, raster
  int lanes, C, qp, qpc;
  // MB strides in elements: of mode, cmode, cbp_l, cbp_c, dc, ac, cdc,
  // cac (the level strides multiples of 8: 16-byte loads)
  int sm, scm, scl, scc, sdc, sac, scdc, scac;
  int qp44, si4, sac44;  // the i44 QP; the MB strides of i4m and ac44
};

constexpr int kPtrs = 18;
constexpr int kInts = 15;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/iframe.py `_k5_operands` builds them.
inline Args k5_args(void* const* p, const int* n) {
  Args a;
  auto i32 = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto lev = [p](int i) { return static_cast<const int16_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  a.mode = i32(0), a.cmode = i32(1), a.cbp_l = i32(2), a.cbp_c = i32(3);
  a.is_intra = static_cast<const uint8_t*>(p[4]);
  a.dc = lev(5), a.ac = lev(6), a.cdc = lev(7), a.cac = lev(8);
  a.oy = i32(9), a.ou = i32(10), a.ov = i32(11);
  a.i4m = lev(12), a.ac44 = lev(13);
  a.taps = static_cast<const uint32_t*>(p[14]);
  a.y = out(15), a.u = out(16), a.v = out(17);
  a.lanes = n[0], a.C = n[1], a.qp = n[2], a.qpc = n[3];
  a.sm = n[4], a.scm = n[5], a.scl = n[6], a.scc = n[7];
  a.sdc = n[8], a.sac = n[9], a.scdc = n[10], a.scac = n[11];
  a.qp44 = n[12], a.si4 = n[13], a.sac44 = n[14];
  return a;
}

// packed per-MB flags: luma DC, chroma DC, intra, and what its cbps
// code: luma AC, chroma DC, chroma AC; a worker adds whether the next
// column is intra; the kI44 instance marks an intra MB of mode 4
constexpr int kLumaDc = 1, kChromaDc = 2, kIntra = 4, kLumaAc = 8,
              kCDc = 16, kCAc = 32, kNextIntra = 64, kI4 = 128;

template <bool kI44>
__device__ __forceinline__ int load_flags(const Args& a, size_t mb0,
                                          int col) {
  if (col >= a.C) return 0;
  const size_t m = mb0 + col;
  if (a.is_intra != nullptr && !a.is_intra[m]) return 0;
  const int cbc = a.cbp_c[m * a.scc];
  const int mode = a.mode[m * a.sm];
  int f = kIntra | (mode == 2 ? kLumaDc : 0) |
          (a.cmode[m * a.scm] == 0 ? kChromaDc : 0) |
          (a.cbp_l[m * a.scl] == 1 ? kLumaAc : 0) | (cbc >= 1 ? kCDc : 0) |
          (cbc == 2 ? kCAc : 0);
  if constexpr (kI44) f |= mode == 4 ? kI4 : 0;
  return f;
}

__device__ __forceinline__ int4 add_clip(int4 r, int p) {
  return make_int4(clip255(p + r.x), clip255(p + r.y), clip255(p + r.z),
                   clip255(p + r.w));
}

// One thread's chunks of a lane: offsets (in int4s) of its luma chunks A
// and B and its chroma chunk in the raster layout of one MB, its chroma
// plane, and the rows whose right samples it keeps (the left column's
// indices: luma 0-15, Cb 16-23, Cr 24-31); `edge`: its chunks end their
// rows (bx 3, chroma bx 1).
struct Chunks {
  int xa, xb, xc;
  int ea, eb, ec;
  bool v, edge_l, edge_c;
};

__device__ __forceinline__ Chunks chunks(int t) {
  // luma chunk k = 16 by + 4 bx + y holds row 4 by + y, samples 4 bx ..:
  // raster chunk (4 by + y) * 4 + bx; chroma k = 8 by + 4 bx + y holds
  // row 4 by + y, samples 4 bx ..: raster chunk (4 by + y) * 2 + bx
  const int by = t >> 4, bx = (t >> 2) & 3, y = t & 3;
  const int j = t & 15, cby = j >> 3, cbx = (j >> 2) & 1;
  const int p = t >> 4;
  return Chunks{(4 * by + y) * 4 + bx, (4 * (by + 2) + y) * 4 + bx,
                (4 * cby + y) * 2 + cbx, 4 * by + y, 4 * by + y + 8,
                16 + 8 * p + 4 * cby + y, p == 1, bx == 3, cbx == 1};
}

// A column in the ring: an intra MB's residuals in the block layout
// (by, bx, y, x), or, for another MB before an intra one, its right
// sample column (`left` of the next MB: luma 16 | Cb 8 | Cr 8).
union Slot {
  struct {
    int4 ry[64];
    int4 rc[2][16];
  } r;
  int left[32];
};

// A worker's staging of an intra MB's levels: luma AC 16 x 16; luma DC 16
// | chroma DC 2 x 4 | chroma AC 2 x 4 x 15.
struct Stage {
  int4 ac[32];
  int4 misc[18];
};

struct MemBase {
  Slot ring[kRing];
  Stage stage[kWorkers];
  unsigned ready[kRing];  // slot k: the column + 1 last written there
  unsigned consumed;      // columns the prediction warp is done with
};

template <bool kI44>
struct Mem : MemBase {};

// The Intra_4x4 route's besides: the prediction warp's MB samples
// (intra44_common.cuh's layout) and tap words; each slot's block modes
template <>
struct Mem<true> : MemBase {
  __align__(16) int pix[kI44Pix];
  uint32_t taps[kI44Taps];
  uint8_t m4[kRing][16];
};

// Until *f >= v (acquire, CTA scope).
__device__ __forceinline__ void wait_local(const unsigned* f, unsigned v) {
  while (cta_acquire(f) < v) cl_pause();
}

// The thread's flag window: column 32 w + t's flags in `cur`, the next
// window's in `next`; `base` = 32 w.  Columns are asked for in order, none
// past the next window.
template <bool kI44>
struct Flags {
  int cur, next, base;
  __device__ __forceinline__ Flags(const Args& a, size_t mb0, int t)
      : cur(load_flags<kI44>(a, mb0, t)),
        next(load_flags<kI44>(a, mb0, 32 + t)),
        base(0) {}
  __device__ __forceinline__ int of(const Args& a, size_t mb0, int t,
                                    int col) {
    if (col >= base + 32) {  // uniform: the window moves on
      cur = next;
      base += 32;
      next = load_flags<kI44>(a, mb0, base + 32 + t);
    }
    return __shfl_sync(kFull, cur, col & 31);
  }
};

__device__ __forceinline__ int4 ld16(const int16_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// A worker's column in registers: the thread's three chunks of `other`,
// or of an intra MB its luma AC chunk (a) and DC / chroma AC chunk (b).
struct Loaded {
  int4 a, b, c;
  int f;  // its flags, kNextIntra included
};

// Column `col` of the lane into l: an intra MB's levels (those its cbps
// code; of an Intra_4x4 MB every luma level and, in place of the luma DC,
// its 16 block modes), else `other`.  Columns past the lane's end load
// nothing.
template <bool kI44>
__device__ __forceinline__ void fetch(Loaded& l, const Args& a,
                                      const Chunks& k, size_t mb0, int col,
                                      int flags, int t) {
  l.f = flags;
  if (col >= a.C) return;
  const size_t m = mb0 + col;
  if (flags & kIntra) {
    const int4 z = make_int4(0, 0, 0, 0);
    const bool i4 = kI44 && (flags & kI4);
    l.a = i4 ? ld16(a.ac44 + m * a.sac44 + 8 * t)
          : (flags & kLumaAc) ? ld16(a.ac + m * a.sac + 8 * t)
                              : z;
    // thread 0-1 the luma DC (an Intra_4x4 MB's modes), 2 the chroma DC,
    // 3-17 the chroma AC
    const int16_t* lo = i4 ? a.i4m + m * a.si4 : a.dc + m * a.sdc;
    l.b = t < 2 ? ld16(lo + 8 * t)
          : t == 2 ? ((flags & kCDc) ? ld16(a.cdc + m * a.scdc) : z)
          : (t < 18 && (flags & kCAc)) ? ld16(a.cac + m * a.scac + 8 * (t - 3))
                                       : z;
    return;
  }
  const int4* y = reinterpret_cast<const int4*>(a.oy) + 64 * m;
  const int4* c = reinterpret_cast<const int4*>(k.v ? a.ov : a.ou) + 16 * m;
  l.a = y[k.xa];
  l.b = y[k.xb];
  l.c = c[k.xc];
}

// Worker w: its columns w, w + kWorkers, ..., kAhead loading ahead.
template <bool kI44>
__device__ void work(const Args& a, Mem<kI44>& sm, size_t mb0, int w,
                     int t) {
  const Chunks k = chunks(t);
  const Quant ql = quantiser(a.qp), qc = quantiser(a.qpc);
  Stage& st = sm.stage[w];
  Flags<kI44> fl(a, mb0, t);
  auto flags = [&](int col) {  // col's flags, and whether col + 1 is intra
    if (col >= a.C) return 0;
    const int f = fl.of(a, mb0, t, col);
    return col + 1 < a.C && (fl.of(a, mb0, t, col + 1) & kIntra)
               ? f | kNextIntra
               : f;
  };
  Loaded ring[kAhead];
#pragma unroll
  for (int i = 0; i < kAhead; ++i) {
    const int col = w + kWorkers * i;
    fetch<kI44>(ring[i], a, k, mb0, col, flags(col), t);
  }
  for (int c0 = w; c0 < a.C; c0 += kAhead * kWorkers) {
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      const int col = c0 + kWorkers * i;
      if (col >= a.C) break;
      Loaded& l = ring[i];
      Slot& s = sm.ring[col % kRing];
      const bool intra = l.f & kIntra;  // uniform across the warp
      if (!intra) {
        const size_t m = mb0 + col;
        int4* y = reinterpret_cast<int4*>(a.y) + 64 * m;
        y[k.xa] = l.a;
        y[k.xb] = l.b;
        (reinterpret_cast<int4*>(k.v ? a.v : a.u) + 16 * m)[k.xc] = l.c;
      }
      if (intra || (l.f & kNextIntra)) {
        // the slot's last column (col - kRing) is consumed
        if (col >= kRing) wait_local(&sm.consumed, col - kRing + 1);
        if (intra) {
          st.ac[t] = l.a;
          if (t < 18) st.misc[t] = l.b;
          __syncwarp();
          const int16_t* misc = reinterpret_cast<const int16_t*>(st.misc);
          const int cbc = (l.f & kCAc) ? 2 : (l.f & kCDc) ? 1 : 0;
          const LevelPart v = load_levels(
              misc, reinterpret_cast<const int16_t*>(st.ac), misc + 16,
              misc + 24, (l.f & kLumaAc) ? 1 : 0, cbc, t);
          int x[16];
          bool has = false;
          if constexpr (kI44) {
            if ((l.f & kI4) && t < 16) {  // block t's residual, its mode
              block_residual44(v, quantiser(a.qp44), x);
              sm.m4[col % kRing][t] = (uint8_t)min(max((int)misc[t], 0), 8);
              has = true;
            }
          }
          if (has || block_residual(v, ql, qc, t, x)) {
            int4* o = t < 16 ? s.r.ry + 4 * t
                             : s.r.rc[(t - 16) >> 2] + 4 * ((t - 16) & 3);
#pragma unroll
            for (int i2 = 0; i2 < 4; ++i2)
              o[i2] = make_int4(x[4 * i2], x[4 * i2 + 1], x[4 * i2 + 2],
                                x[4 * i2 + 3]);
          }
        } else {  // the right sample column, the next MB's left
          if (k.edge_l) s.left[k.ea] = l.a.w, s.left[k.eb] = l.b.w;
          if (k.edge_c) s.left[k.ec] = l.c.w;
        }
        __syncwarp();  // the slot is written (and the staging read)
        if (t == 0) cta_release(&sm.ready[col % kRing], (unsigned)col + 1);
      }
      const int nx = col + kAhead * kWorkers;
      fetch<kI44>(l, a, k, mb0, nx, flags(nx), t);
    }
  }
}

// The Intra_4x4 luma of the MB in `slot` (kernels/intra44.py
// `decode_mb`): its 16 blocks by their 10 dependency levels
// (intra44_common.cuh) through the MB's samples in shared memory, lanes
// 0-15 a level's first block and lanes 16-31 its second, then the
// thread's chunks A and B.  la / lb: the left samples of the thread's
// rows; l_mb: the left MB is available (col > 0).
__device__ __forceinline__ void walk44(Mem<true>& sm, const Slot& s,
                                       unsigned slot, int la, int lb,
                                       bool l_mb, int t, int4& oa,
                                       int4& ob) {
  int* pix = sm.pix;
  const int row = 4 * (t >> 4) + (t & 3), bx = (t >> 2) & 3;
  if (bx == 0) pix[i44_at(-1, row)] = la, pix[i44_at(-1, row + 8)] = lb;
  // lane t: pixel p = t & 15, (p & 3, p >> 2), of its half-warp's block
  // of every level; that pixel's residual and its tap word by the block's
  // mode (0 for DC), both off the chain
  const int p = t & 15, h = t >> 4;
  const int* res = reinterpret_cast<const int*>(s.r.ry);
  int r[kI44Levels];
  uint32_t w[kI44Levels];
#pragma unroll
  for (int l = 0; l < kI44Levels; ++l) {
    const int bi = h ? i44_level_block(l, 1) : i44_level_block(l, 0);
    r[l] = res[4 * (16 * blk_y(bi) + 4 * blk_x(bi) + (p >> 2)) + (p & 3)];
    w[l] = sm.taps[16 * sm.m4[slot][bi] + p];
  }
  __syncwarp();  // the left column is written
#pragma unroll
  for (int l = 0; l < kI44Levels; ++l) {
    const int b0 = i44_level_block(l, 0), b1 = i44_level_block(l, 1);
    const int x0 = 4 * blk_x(h ? b1 : b0), y0 = 4 * blk_y(h ? b1 : b0);
    const int nv = pix[h ? i44_neighbour(b1, p) : i44_neighbour(b0, p)];
    const int dc = i44_dc_at(pix + i44_at(x0, y0), x0 > 0 || l_mb, y0 > 0);
    const int tap = i44_tap(w[l], nv, t & 16);  // every lane shuffles
    if (t < 16 || b1 != b0)
      pix[i44_at(x0 + (p & 3), y0 + (p >> 2))] = clip255(
          (int)((unsigned)(w[l] ? tap : dc) + (unsigned)r[l]));
    __syncwarp();  // the level is written
  }
  oa = ld4(pix + i44_at(4 * bx, row));
  ob = ld4(pix + i44_at(4 * bx, row + 8));
}

// The prediction warp: every column in order; an intra one from its
// slot's residuals and the left samples, another one only its left
// samples where the next column is intra (the worker stored the MB).
template <bool kI44>
__device__ void predict(const Args& a, Mem<kI44>& sm, size_t mb0, int t) {
  const Chunks k = chunks(t);
  Flags<kI44> fl(a, mb0, t);
  // the left samples of this thread's rows (luma A, B; chroma)
  int la = 0, lb = 0, lc = 0;
  int f = fl.of(a, mb0, t, 0);
  for (int col = 0; col < a.C; ++col) {
    const int fn = col + 1 < a.C ? fl.of(a, mb0, t, col + 1) : 0;
    const unsigned slot = col % kRing;
    const Slot& s = sm.ring[slot];
    if (f & kIntra) {  // uniform across the warp
      wait_local(&sm.ready[slot], (unsigned)col + 1);
      const int4 ra = s.r.ry[t], rb = s.r.ry[t + 32];
      const int4 rc = s.r.rc[t >> 4][t & 15];
      // column 0: DC 128, H against zeros
      int pa = (f & kLumaDc) ? 128 : 0, pb = pa;
      int pc = (f & kChromaDc) ? 128 : 0;
      if (col > 0) {
        pa = la, pb = lb, pc = lc;
        if (f & kLumaDc) {
          int sum = pa + pb;
          sum += __shfl_xor_sync(kFull, sum, 1);
          sum += __shfl_xor_sync(kFull, sum, 2);
          sum += __shfl_xor_sync(kFull, sum, 16);
          pa = pb = (sum + 8) >> 4;
        }
        if (f & kChromaDc) {
          int sum = pc;
          sum += __shfl_xor_sync(kFull, sum, 1);
          sum += __shfl_xor_sync(kFull, sum, 2);
          pc = (sum + 2) >> 2;
        }
      }
      int4 oa = add_clip(ra, pa), ob = add_clip(rb, pb);
      const int4 oc = add_clip(rc, pc);
      if constexpr (kI44) {
        if (f & kI4) walk44(sm, s, slot, la, lb, col > 0, t, oa, ob);
      }
      if (fn & kIntra) {  // the next MB's left, from the threads whose
                          // chunks end these rows
        la = __shfl_sync(kFull, oa.w, t | 12);
        lb = __shfl_sync(kFull, ob.w, t | 12);
        lc = __shfl_sync(kFull, oc.w, t | 4);
      }
      const size_t m = mb0 + col;
      int4* y = reinterpret_cast<int4*>(a.y) + 64 * m;
      y[k.xa] = oa;
      y[k.xb] = ob;
      (reinterpret_cast<int4*>(k.v ? a.v : a.u) + 16 * m)[k.xc] = oc;
    } else if (fn & kIntra) {
      wait_local(&sm.ready[slot], (unsigned)col + 1);
      la = s.left[k.ea], lb = s.left[k.eb], lc = s.left[k.ec];
    }
    __syncwarp();  // the slot is read
    if (t == 0) cta_release(&sm.consumed, (unsigned)col + 1);
    f = fn;
  }
}

// Block b is lane b: warp 0 predicts, warps 1 .. kWorkers work.  kI44:
// the Intra_4x4 route (i4modes given).
template <bool kI44>
__global__ void __launch_bounds__(kThreads)
    intra_recon_kernel(const __grid_constant__ Args a) {
  __shared__ Mem<kI44> sm;
  const int t = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (threadIdx.x < kRing) sm.ready[threadIdx.x] = 0;
  if (threadIdx.x == 0) sm.consumed = 0;
  if constexpr (kI44) {  // row -1 and the corner stay zero; the taps
    for (int i = threadIdx.x; i < kI44Pix; i += kThreads) sm.pix[i] = 0;
    for (int i = threadIdx.x; i < kI44Taps; i += kThreads)
      sm.taps[i] = a.taps[i];
  }
  __syncthreads();
  const size_t mb0 = (size_t)blockIdx.x * a.C;
  if (warp == 0)
    predict<kI44>(a, sm, mb0, t);
  else
    work<kI44>(a, sm, mb0, warp - 1, t);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_intra_recon.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `k5_args`' order (host
// arrays); lanes = S * R MB rows of C MB columns; is_intra and the three
// `other` planes are all given or all null (then every MB is intra);
// i4modes, the i44 levels and the tap words all given (the Intra_4x4
// route) or all null.
extern "C" int th264_intra_recon_rows(void* const* p, const int* n,
                                      void* stream) {
  const Args a = k5_args(p, n);
  if (a.i4m != nullptr)
    intra_recon_kernel<true>
        <<<a.lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  else
    intra_recon_kernel<false>
        <<<a.lanes, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
