// D2: the intra-reconstruction column scan of the decoders (Intra_16x16
// DC / H luma and DC / H chroma prediction from the left MB, plus the
// inverse-transformed residuals, clipped to 0..255), a warp per MB row.
//
// Replaces: the jax.lax.scan of tpuh264/kernels/pframe.py
// `decode_pframe_rows_multi` (:1021; substep :1167, scan :1218) and of
// tpuh264/kernels/iframe.py `decode_iframe_scan` (:336, scan :404), not
// pallas_calls.  Its plain PyTorch version is `kernels/iframe.py`
// `_intra_recon_scan_plain` (called with i44 None).
//
// What it computes, exactly as the plain version: MB (lane, c) of an
// intra lane position takes its prediction from the left MB's right
// sample column (luma: DC (sum of the 16 + 8) >> 4 where mode == 2, else
// H, the left sample of its row; chroma: DC per 4-row half (sum of the
// 4 + 2) >> 2 where cmode == 0, else H); in column 0, as the JAX scans
// with their zero carry, DC is 128 and H predicts 0 (no legal stream
// codes H there; the encoder codes column 0 as DC).  It adds its
// residual and clips to 0..255.  An MB whose is_intra is 0
// takes `other` instead (the inter reconstruction), and serves as the
// next MB's left neighbour all the same.  Without `other` every MB is
// intra (the I decode).  int32 in, int32 out, of any value: nothing here
// assumes samples in 0..255.
//
// What bounds it on the H100: bytes.  Row slices never predict across
// MB rows, so the S x R MB rows are independent lanes (272 at 1080p x
// 4), chained along their C columns only through the left sample
// column, and only where the column is intra: an MB that takes `other`
// breaks the chain.  Each MB's 1,536 bytes of output come either from
// `other` or from the residuals, never both, so the least the function
// must move is mode, cmode and is_intra, one of the two 1,536-byte
// inputs, and the output: 100.7 MB, 0.030 ms, for a 1080p x 4 P frame
// without intra MBs.
//
// Design, around keeping enough bytes in flight with one warp a lane:
//  * A thread owns three 16-byte chunks of every MB: luma chunks t and
//    t + 32 and chunk t & 15 of chroma plane t >> 4, in the residuals'
//    4x4-block order (by, bx, y, x).  A chunk is the 4 samples of one
//    4x4 block row, so it is also 4 adjacent samples of the raster MB:
//    `other` and the output are read and written at that raster place.
//    No shared memory; every load and store is 16 bytes, a warp's
//    covering whole 512-byte (luma) and 256-byte (chroma) spans.
//  * The chain is a few shuffles in intra columns only: the thread
//    whose chunk ends an MB row (bx 3, chroma bx 1) holds the left
//    sample of that row for the next MB; each thread fetches the left of
//    its rows from it (t | 12, chroma t | 4), and DC sums them with
//    xor-shuffles (luma over t bits 0, 1, 4 and both chunks; chroma over
//    bits 0, 1).  mode, cmode and is_intra of a column are uniform
//    across the warp, so the branches never diverge; a column that is
//    not intra is a copy.
//  * Eight columns in flight: a ring of kDepth register slots, column c
//    + kDepth loading into the slot that column c has just left (the
//    loop unrolled by kDepth so every slot index is a constant).  Which
//    input a column loads (residuals if intra, else `other`) is known
//    when it is fetched: the three per-MB words of 32 columns at a time
//    arrive one column a thread, a window ahead, and a shuffle hands
//    column x's packed flags to the warp.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kDepth = 8;  // columns in flight a lane

struct Args {
  const int32_t *mode, *cmode, *is_intra;   // [lanes, C]; is_intra may be
                                            // null (then `other` is too)
  const int32_t *ry, *ru, *rv;              // residuals, (by, bx, y, x)
  const int32_t *oy, *ou, *ov;              // other, raster; may be null
  int32_t *y, *u, *v;                       // output, raster
  int lanes, C;
};

// packed per-MB flags: luma DC, chroma DC, intra
constexpr int kLumaDc = 1, kChromaDc = 2, kIntra = 4;

__device__ __forceinline__ int load_flags(const Args& a, size_t mb0,
                                          int col) {
  if (col >= a.C) return 0;
  const size_t m = mb0 + col;
  const bool intra = a.oy == nullptr || a.is_intra[m] != 0;
  return (a.mode[m] == 2 ? kLumaDc : 0) | (a.cmode[m] == 0 ? kChromaDc : 0) |
         (intra ? kIntra : 0);
}

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }

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
  int4 a, b, c;  // the thread's three chunks of one MB
  int f;         // its flags
};

// Column `col` of the lane into slot s: the residuals where intra, else
// `other`.  Columns past the lane's end load nothing.
__device__ __forceinline__ void fetch(Slot& s, const Args& a,
                                      const Chunks& k, size_t mb0, int col,
                                      int flags) {
  s.f = flags;
  if (col >= a.C) return;
  const size_t m = mb0 + col;
  const bool intra = flags & kIntra;
  const int4* y = reinterpret_cast<const int4*>(intra ? a.ry : a.oy) + 64 * m;
  const int4* c = reinterpret_cast<const int4*>(
                      intra ? (k.v ? a.rv : a.ru) : (k.v ? a.ov : a.ou)) +
                  16 * m;
  s.a = y[intra ? k.ra : k.xa];
  s.b = y[intra ? k.rb : k.xb];
  s.c = c[intra ? k.rc : k.xc];
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

// Column `col` from slot s: predict and add where intra, else copy; store
// it and keep its right samples (`last`) for the next column's left.
__device__ __forceinline__ void column(const Slot& s, const Args& a,
                                       const Chunks& k, size_t mb0, int col,
                                       int t, int4& la, int4& lb, int4& lc) {
  int4 oa = s.a, ob = s.b, oc = s.c;
  if (s.f & kIntra) {  // uniform across the warp
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
    oa = add_clip(oa, pa);
    ob = add_clip(ob, pb);
    oc = add_clip(oc, pc);
  }
  const size_t m = mb0 + col;
  int4* y = reinterpret_cast<int4*>(a.y) + 64 * m;
  y[k.xa] = oa;
  y[k.xb] = ob;
  (reinterpret_cast<int4*>(k.v ? a.v : a.u) + 16 * m)[k.xc] = oc;
  la = oa;
  lb = ob;
  lc = oc;
}

// Block b is lane b: a warp walks its C columns with kDepth in flight.
__global__ void __launch_bounds__(32) intra_recon_kernel(Args a) {
  const int t = threadIdx.x;
  const size_t mb0 = (size_t)blockIdx.x * a.C;
  const Chunks k = chunks(t);
  Flags fl{load_flags(a, mb0, t), load_flags(a, mb0, 32 + t), 0};
  Slot ring[kDepth];
#pragma unroll
  for (int i = 0; i < kDepth; ++i)
    fetch(ring[i], a, k, mb0, i, i < a.C ? fl.of(a, mb0, t, i) : 0);
  int4 la = make_int4(0, 0, 0, 0), lb = la, lc = la;
  for (int c0 = 0; c0 < a.C; c0 += kDepth) {
#pragma unroll
    for (int i = 0; i < kDepth; ++i) {
      const int col = c0 + i;
      if (col >= a.C) break;
      column(ring[i], a, k, mb0, col, t, la, lb, lc);
      const int next = col + kDepth;
      fetch(ring[i], a, k, mb0, next,
            next < a.C ? fl.of(a, mb0, t, next) : 0);
    }
  }
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_intra_recon.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// lanes = S * R MB rows of C MB columns; is_intra and the three `other`
// planes are all given or all null (then every MB is intra).
extern "C" int th264_intra_recon_rows(
    const int32_t* mode, const int32_t* cmode, const int32_t* is_intra,
    const int32_t* ry, const int32_t* ru, const int32_t* rv,
    const int32_t* oy, const int32_t* ou, const int32_t* ov, int32_t* y,
    int32_t* u, int32_t* v, int lanes, int C, void* stream) {
  const Args a{mode, cmode, is_intra, ry, ru, rv, oy, ou, ov,
               y, u, v, lanes, C};
  intra_recon_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
