// D2: the intra-reconstruction column scan of the decoders (Intra_16x16
// DC / H luma and DC / H chroma prediction from the left MB, plus the
// residuals it decodes from the parsed levels, clipped to 0..255), a warp
// per MB row.
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
// Design, around keeping enough bytes in flight with one warp a lane:
//  * A thread owns three 16-byte chunks of every MB: luma chunks t and
//    t + 32 and chunk t & 15 of chroma plane t >> 4, in the residuals'
//    4x4-block order (by, bx, y, x).  A chunk is the 4 samples of one
//    4x4 block row, so it is also 4 adjacent samples of the raster MB:
//    `other` and the output are read and written at that raster place.
//    Every global load and store of samples is 16 bytes, a warp's
//    covering whole 512-byte (luma) and 256-byte (chroma) spans.
//  * An intra MB's levels arrive as two 16-byte loads a thread (its
//    luma AC chunk t, and the DC and chroma AC chunks on threads 0-17),
//    those its cbps mask left out not loaded.  In its column they go
//    through the warp's shared memory, a lane decodes one 4x4 block
//    (lanes 0-15 luma, 16-23 chroma: K8's `block_residual`), and each
//    thread takes back its three chunks of residuals.  The level fields
//    may be strided views of one record buffer (the GOP decode's
//    [.., 400] int16 slots): each field comes with its MB stride.
//  * The chain is a few shuffles in intra columns only: the thread
//    whose chunk ends an MB row (bx 3, chroma bx 1) holds the left
//    sample of that row for the next MB; each thread fetches the left of
//    its rows from it (t | 12, chroma t | 4), and DC sums them with
//    xor-shuffles (luma over t bits 0, 1, 4 and both chunks; chroma over
//    bits 0, 1).  The flags of a column are uniform across the warp, so
//    the branches never diverge; a column that is not intra is a copy.
//  * Eight columns in flight: a ring of kDepth register slots, column c
//    + kDepth loading into the slot that column c has just left (the
//    loop unrolled by kDepth so every slot index is a constant).  Which
//    input a column loads (levels if intra, else `other`) is known when
//    it is fetched: the per-MB flags of 32 columns at a time arrive one
//    column a thread, a window ahead (an intra MB's mode, cmode and cbps
//    only where is_intra says so), and a shuffle hands column x's packed
//    flags to the warp.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"  // quantiser, load_levels, block_residual

namespace {

constexpr int kDepth = 8;  // columns in flight a lane

struct Args {
  const int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [lanes, C], MB-strided
  const uint8_t* is_intra;   // [lanes, C] bool; null: every MB intra
                             // (then `other` is too)
  const int16_t *dc, *ac, *cdc, *cac;  // levels, MBSymbols' layouts
  const int32_t *oy, *ou, *ov;         // other, raster; may be null
  int32_t *y, *u, *v;                  // output, raster
  int lanes, C, qp, qpc;
  // MB strides in elements: of mode, cmode, cbp_l, cbp_c, dc, ac, cdc,
  // cac (the level strides multiples of 8: 16-byte loads)
  int sm, scm, scl, scc, sdc, sac, scdc, scac;
};

constexpr int kPtrs = 15;
constexpr int kInts = 12;

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
  a.y = out(12), a.u = out(13), a.v = out(14);
  a.lanes = n[0], a.C = n[1], a.qp = n[2], a.qpc = n[3];
  a.sm = n[4], a.scm = n[5], a.scl = n[6], a.scc = n[7];
  a.sdc = n[8], a.sac = n[9], a.scdc = n[10], a.scac = n[11];
  return a;
}

// packed per-MB flags: luma DC, chroma DC, intra, and what its cbps
// code: luma AC, chroma DC, chroma AC
constexpr int kLumaDc = 1, kChromaDc = 2, kIntra = 4, kLumaAc = 8,
              kCDc = 16, kCAc = 32;

__device__ __forceinline__ int load_flags(const Args& a, size_t mb0,
                                          int col) {
  if (col >= a.C) return 0;
  const size_t m = mb0 + col;
  if (a.is_intra != nullptr && !a.is_intra[m]) return 0;
  const int cbc = a.cbp_c[m * a.scc];
  return kIntra | (a.mode[m * a.sm] == 2 ? kLumaDc : 0) |
         (a.cmode[m * a.scm] == 0 ? kChromaDc : 0) |
         (a.cbp_l[m * a.scl] == 1 ? kLumaAc : 0) | (cbc >= 1 ? kCDc : 0) |
         (cbc == 2 ? kCAc : 0);
}

__device__ __forceinline__ int4 add_clip(int4 r, int p) {
  return make_int4(clip255(p + r.x), clip255(p + r.y), clip255(p + r.z),
                   clip255(p + r.w));
}

// One thread's chunks of a lane: offsets (in int4s) of its luma chunks A
// and B and its chroma chunk in the residual layout and in the raster
// layout of one MB, and its chroma plane.
struct Chunks {
  int ra, rb, rc;  // residual layout: luma t, t + 32; chroma t & 15
  int xa, xb, xc;  // raster layout of the same samples
  bool v;          // chroma plane V (else U)
};

__device__ __forceinline__ Chunks chunks(int t) {
  // luma chunk k = 16 by + 4 bx + y holds row 4 by + y, samples 4 bx ..:
  // raster chunk (4 by + y) * 4 + bx; chroma k = 8 by + 4 bx + y holds
  // row 4 by + y, samples 4 bx ..: raster chunk (4 by + y) * 2 + bx
  const int by = t >> 4, bx = (t >> 2) & 3, y = t & 3;
  const int j = t & 15, cby = j >> 3, cbx = (j >> 2) & 1;
  return Chunks{t, t + 32, j, (4 * by + y) * 4 + bx,
                (4 * (by + 2) + y) * 4 + bx, (4 * cby + y) * 2 + cbx,
                t >= 16};
}

struct Slot {
  int4 a, b, c;  // the thread's three chunks of `other`, or of an intra
                 // MB its luma AC chunk (a) and DC / chroma AC chunk (b)
  int f;         // its flags
};

// The warp's shared memory: an intra MB's levels (luma AC 16 x 16; luma
// DC 16 | chroma DC 2 x 4 | chroma AC 2 x 4 x 15), then its residuals in
// the block layout (by, bx, y, x).
struct WarpMem {
  int4 ac[32];
  int4 misc[18];
  int4 ry[64];
  int4 rc[2][16];
};

__device__ __forceinline__ int4 ld16(const int16_t* p) {
  return *reinterpret_cast<const int4*>(p);
}

// Column `col` of the lane into slot s: an intra MB's levels (those its
// cbps code), else `other`.  Columns past the lane's end load nothing.
__device__ __forceinline__ void fetch(Slot& s, const Args& a,
                                      const Chunks& k, size_t mb0, int col,
                                      int flags, int t) {
  s.f = flags;
  if (col >= a.C) return;
  const size_t m = mb0 + col;
  if (flags & kIntra) {
    const int4 z = make_int4(0, 0, 0, 0);
    s.a = (flags & kLumaAc) ? ld16(a.ac + m * a.sac + 8 * t) : z;
    // thread 0-1 the luma DC, 2 the chroma DC, 3-17 the chroma AC
    s.b = t < 2 ? ld16(a.dc + m * a.sdc + 8 * t)
          : t == 2 ? ((flags & kCDc) ? ld16(a.cdc + m * a.scdc) : z)
          : (t < 18 && (flags & kCAc)) ? ld16(a.cac + m * a.scac + 8 * (t - 3))
                                       : z;
    return;
  }
  const int4* y = reinterpret_cast<const int4*>(a.oy) + 64 * m;
  const int4* c = reinterpret_cast<const int4*>(k.v ? a.ov : a.ou) + 16 * m;
  s.a = y[k.xa];
  s.b = y[k.xb];
  s.c = c[k.xc];
}

// The thread's flag window: column 32 w + t's flags in `cur`, the next
// window's in `next`; `base` = 32 w.  Columns are asked for in order.
struct Flags {
  int cur, next, base;
  __device__ __forceinline__ int of(const Args& a, size_t mb0, int t,
                                    int col) {
    if (col - base == 32) {  // uniform: the window moves on
      cur = next;
      base += 32;
      next = load_flags(a, mb0, base + 32 + t);
    }
    return __shfl_sync(0xffffffffu, cur, col & 31);
  }
};

// An intra column's residuals from its levels in slot s: through the
// warp's shared memory, a 4x4 block a lane, back as the thread's three
// chunks.
__device__ __forceinline__ void intra_residuals(Slot& s, WarpMem& w,
                                                const Quant& ql,
                                                const Quant& qc, int t) {
  w.ac[t] = s.a;
  if (t < 18) w.misc[t] = s.b;
  __syncwarp();
  const int16_t* misc = reinterpret_cast<const int16_t*>(w.misc);
  const int cbc = (s.f & kCAc) ? 2 : (s.f & kCDc) ? 1 : 0;
  const LevelPart v =
      load_levels(misc, reinterpret_cast<const int16_t*>(w.ac), misc + 16,
                  misc + 24, (s.f & kLumaAc) ? 1 : 0, cbc, t);
  int x[16];
  if (block_residual(v, ql, qc, t, x)) {
    int4* o = t < 16 ? w.ry + 4 * t : w.rc[(t - 16) >> 2] + 4 * ((t - 16) & 3);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = make_int4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
  __syncwarp();
  s.a = w.ry[t];
  s.b = w.ry[t + 32];
  s.c = w.rc[t >> 4][t & 15];
}

// Column `col` from slot s: decode the residuals, predict and add where
// intra, else copy; store it and keep its right samples (`last`) for the
// next column's left.
__device__ __forceinline__ void column(Slot& s, WarpMem& w, const Args& a,
                                       const Chunks& k, size_t mb0, int col,
                                       int t, const Quant& ql,
                                       const Quant& qc, int4& la, int4& lb,
                                       int4& lc) {
  if (s.f & kIntra) {  // uniform across the warp
    intra_residuals(s, w, ql, qc, t);
    // column 0: DC 128, H against zeros
    int pa = (s.f & kLumaDc) ? 128 : 0, pb = pa;
    int pc = (s.f & kChromaDc) ? 128 : 0;
    if (col > 0) {
      // the left samples of this thread's rows, from the threads whose
      // chunks ended the previous MB's rows
      pa = __shfl_sync(0xffffffffu, la.w, t | 12);
      pb = __shfl_sync(0xffffffffu, lb.w, t | 12);
      pc = __shfl_sync(0xffffffffu, lc.w, t | 4);
      if (s.f & kLumaDc) {
        int sum = pa + pb;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        sum += __shfl_xor_sync(0xffffffffu, sum, 16);
        pa = pb = (sum + 8) >> 4;
      }
      if (s.f & kChromaDc) {
        int sum = pc;
        sum += __shfl_xor_sync(0xffffffffu, sum, 1);
        sum += __shfl_xor_sync(0xffffffffu, sum, 2);
        pc = (sum + 2) >> 2;
      }
    }
    s.a = add_clip(s.a, pa);
    s.b = add_clip(s.b, pb);
    s.c = add_clip(s.c, pc);
  }
  const size_t m = mb0 + col;
  int4* y = reinterpret_cast<int4*>(a.y) + 64 * m;
  y[k.xa] = s.a;
  y[k.xb] = s.b;
  (reinterpret_cast<int4*>(k.v ? a.v : a.u) + 16 * m)[k.xc] = s.c;
  la = s.a;
  lb = s.b;
  lc = s.c;
}

// Block b is lane b: a warp walks its C columns with kDepth in flight.
__global__ void __launch_bounds__(32)
    intra_recon_kernel(const __grid_constant__ Args a) {
  __shared__ WarpMem w;
  const int t = threadIdx.x;
  const size_t mb0 = (size_t)blockIdx.x * a.C;
  const Chunks k = chunks(t);
  const Quant ql = quantiser(a.qp), qc = quantiser(a.qpc);
  Flags fl{load_flags(a, mb0, t), load_flags(a, mb0, 32 + t), 0};
  Slot ring[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i)
    fetch(ring[i], a, k, mb0, i, i < a.C ? fl.of(a, mb0, t, i) : 0, t);
  int4 la = make_int4(0, 0, 0, 0), lb = la, lc = la;
  for (int c0 = 0; c0 < a.C; c0 += kDepth) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int col = c0 + i;
      if (col >= a.C) break;
      column(ring[i], w, a, k, mb0, col, t, ql, qc, la, lb, lc);
      const int next = col + kDepth;
      fetch(ring[i], a, k, mb0, next,
            next < a.C ? fl.of(a, mb0, t, next) : 0, t);
    }
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_intra_recon.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `k5_args`' order (host
// arrays); lanes = S * R MB rows of C MB columns; is_intra and the three
// `other` planes are all given or all null (then every MB is intra).
extern "C" int th264_intra_recon_rows(void* const* p, const int* n,
                                      void* stream) {
  const Args a = k5_args(p, n);
  intra_recon_kernel<<<a.lanes, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
