// K6: the encoder's Intra_16x16 column scan (D3, the I encode, and D4,
// the intra-in-P trial of the P encode), a warp per MB row.
//
// Replaces: the jax.lax.scan of tpuh264/kernels/iframe.py
// `encode_iframe_scan` (:199; step :219, scan :308) and the intra-in-P
// scan of tpuh264/kernels/pframe.py `encode_pframe_rows_multi` (:638;
// `_intra16_costs` :531, substep :866, scan :989), not pallas_calls.
// Its plain PyTorch versions are `kernels/iframe.py`
// `_encode_iframe_scan_plain` (called without intra44) and
// `kernels/pframe.py` `_intra_in_p_scan_plain`.
//
// What it computes, exactly as the plain versions (`_intra16_mb` a
// column): each MB is predicted from the left MB's right sample column
// (luma: DC (sum of the 16 + 8) >> 4 or H; chroma: DC per 4-row half
// (sum of the 4 + 2) >> 2 or H), 128 and DC only in column 0; luma
// chooses by its SAD, chroma by the summed Cb + Cr SAD, ties to DC.
// Then the forward 4x4 transform of src - pred; the 16 luma DCs through
// the 4x4 Hadamard and quant_luma_dc, the chroma DCs through the 2x2
// Hadamard and quant_chroma_dc; the AC through quant4x4 (intra
// rounding f = 2^qbits / 3); and the reconstruction: DC dequant, AC
// dequant, inverse 4x4, (+ 32) >> 6, clip to 0..255.  The plain
// versions mask the dequantised levels by cbp; here every mask is a
// no-op (a cbp of 0 means those levels are all zero), so none is
// applied.  With `inter_sad` (D4) the MB takes the intra result only
// where its luma SAD is strictly below inter_sad (inter wins a tie);
// elsewhere its reconstruction is `rec_inter`, and that final
// reconstruction is the next MB's left neighbour.
//
// Arithmetic: every `>>` of a negative value is arithmetic (signed int,
// as torch's); a dequant `(z * v) << k` is written as a multiply by
// 1 << k (a left shift of a negative value is undefined in C++17); every
// product fits int32 (golden/transform.py).  QP is an argument: the rate
// controller moves it from frame to frame.
//
// What bounds it on the H100: latency along the chain.  The S x R MB
// rows are independent lanes (272 at 1080p x 4, 240 at 480p x 8), a
// warp each: about two warps an SM, so the card's bytes (52.7 MB for a
// 1080p x 4 I frame, 0.016 ms) are far from the limit; each lane walks
// its C columns one after the other, and a column is three warp
// barriers, ~25 shuffles and a few hundred integer instructions a
// thread.  Design, simple first:
//  * Threads 0-15 own the 16 luma 4x4 blocks (by * 4 + bx, raster),
//    16-19 the Cb and 20-23 the Cr blocks, in registers; 24-31 only take
//    part in the reductions.  The transforms are butterflies in
//    registers; the SADs, cbp flags and the DC / H choice are xor-shuffle
//    reductions, so every thread learns them.
//  * Shared memory holds only what crosses blocks: the left column (32
//    samples), the DC coefficients before and after quantisation.
//  * The next column's source samples (and D4's inter SAD) are loaded
//    while the current column is computed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// quantiser multiplier MF and dequantiser scale V of the position
// classes a ((even, even)), b ((odd, odd)) and c (the rest), by qp % 6
// (golden/transform.py MF_TABLE, V_TABLE)
__constant__ int kMF[3][6] = {{13107, 11916, 10082, 9362, 8192, 7282},
                              {5243, 4660, 4194, 3647, 3355, 2893},
                              {8066, 7490, 6554, 5825, 5243, 4559}};
__constant__ int kV[3][6] = {{10, 11, 13, 14, 16, 18},
                             {16, 18, 20, 23, 25, 29},
                             {13, 14, 16, 18, 20, 23}};

struct Args {
  const void *sy, *su, *sv;    // source planes [S,H,W], [S,H/2,W/2]
  int src_u8;                  // 1: uint8 samples, 0: int32
  const int32_t* inter_sad;    // D4: [lanes, C]; null for D3
  const int32_t *iy, *iu, *iv; // D4: rec_inter, MB layout [lanes,C,n,n]
  int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [lanes, C]
  int32_t* sad;                // D4: [lanes, C]; may be null
  uint8_t* use;                // D4: [lanes, C] 0 / 1; null for D3
  int16_t *dc, *ac, *cdc, *cac;  // [.,16], [.,16,16], [.,2,4], [.,2,4,15]
  int16_t* i4;                 // D3: [., 16] set to -1; may be null
  uint8_t *ry8, *ru8, *rv8;    // D3: uint8 recon planes, raster
  int32_t *ry, *ru, *rv;       // D4: int32 final recon, MB layout
  int lanes, C, qp, qpc;
};

// raster index of 4x4 zigzag slot k (golden ZIGZAG4), a nibble a slot
__device__ __forceinline__ int zz(int k) {
  return (int)((0xFEB7ADC963258410ull >> (4 * k)) & 15);
}

// the 4x4 Hadamard matrix's entry (i, k): -1 where bit 4 i + k is set
__device__ __forceinline__ int h4(int i, int k) {
  return ((0xA6C0 >> (4 * i + k)) & 1) ? -1 : 1;
}

// position class of raster coefficient i: 0 = a, 1 = b, 2 = c
__device__ __forceinline__ int pos_class(int i) {
  const int r = i >> 2, c = i & 3;
  return ((r | c) & 1) == 0 ? 0 : ((r & c) & 1) ? 1 : 2;
}

__device__ __forceinline__ int quant(int w, int mf, int f, int qbits) {
  const int z = (abs(w) * mf + f) >> qbits;
  return w < 0 ? -z : z;
}

__device__ __forceinline__ int clip255(int x) { return min(max(x, 0), 255); }

// Forward core transform of a raster 4x4 block in place (transform.py
// forward4x4: the vertical butterflies, then the horizontal ones).
__device__ __forceinline__ void forward4x4(int (&x)[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a0 = x[c] + x[12 + c], a1 = x[4 + c] + x[8 + c];
    const int a2 = x[4 + c] - x[8 + c], a3 = x[c] - x[12 + c];
    x[c] = a0 + a1;
    x[4 + c] = 2 * a3 + a2;
    x[8 + c] = a0 - a1;
    x[12 + c] = a3 - 2 * a2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p0 = x[4 * r], p1 = x[4 * r + 1], p2 = x[4 * r + 2],
              p3 = x[4 * r + 3];
    const int b0 = p0 + p3, b1 = p1 + p2, b2 = p1 - p2, b3 = p0 - p3;
    x[4 * r] = b0 + b1;
    x[4 * r + 1] = 2 * b3 + b2;
    x[4 * r + 2] = b0 - b1;
    x[4 * r + 3] = b3 - 2 * b2;
  }
}

// Normative inverse transform in place (8.5.12.2, transform.py
// inverse4x4): each row first, then each column; `>> 1` arithmetic.
__device__ __forceinline__ void inverse4x4(int (&d)[16]) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int d0 = d[4 * r], d1 = d[4 * r + 1], d2 = d[4 * r + 2],
              d3 = d[4 * r + 3];
    const int e0 = d0 + d2, e1 = d0 - d2;
    const int e2 = (d1 >> 1) - d3, e3 = d1 + (d3 >> 1);
    d[4 * r] = e0 + e3;
    d[4 * r + 1] = e1 + e2;
    d[4 * r + 2] = e1 - e2;
    d[4 * r + 3] = e0 - e3;
  }
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int f0 = d[c], f1 = d[4 + c], f2 = d[8 + c], f3 = d[12 + c];
    const int g0 = f0 + f2, g1 = f0 - f2;
    const int g2 = (f1 >> 1) - f3, g3 = f1 + (f3 >> 1);
    d[c] = g0 + g3;
    d[4 + c] = g1 + g2;
    d[8 + c] = g1 - g2;
    d[12 + c] = g0 - g3;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_or(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v |= __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The block a thread owns: plane 0 luma (threads 0-15, 4x4 grid), 1 Cb
// (16-19) or 2 Cr (20-23, 2x2 grids); threads 24-31 own none.
struct Role {
  bool luma, chroma;
  int plane, by, bx, j;  // j: the block's raster index in its MB
  int n;                 // the plane's MB width in samples (16 or 8)
  int li;                // `left` index of the block's first row
};

__device__ __forceinline__ Role role(int t) {
  Role k{};
  k.luma = t < 16;
  k.chroma = t >= 16 && t < 24;
  if (k.luma) {
    k.plane = 0, k.by = t >> 2, k.bx = t & 3, k.j = t, k.n = 16;
    k.li = 4 * k.by;
  } else {
    const int c = k.chroma ? t - 16 : 0;
    k.plane = 1 + (c >> 2), k.j = c & 3, k.by = k.j >> 1, k.bx = k.j & 1;
    k.n = 8, k.li = 16 + 8 * (k.plane - 1) + 4 * k.by;
  }
  return k;
}

// The thread's 4x4 source block of MB (lane, col), raster, into x.
__device__ __forceinline__ void load_src(int (&x)[16], const Args& a,
                                         const Role& k, size_t lane,
                                         int col) {
  if (!(k.luma || k.chroma)) return;
  const size_t w = (size_t)a.C * k.n;
  const size_t row0 = lane * k.n + 4 * k.by;
  const size_t x0 = (size_t)col * k.n + 4 * k.bx;
  const void* p = k.plane == 0 ? a.sy : k.plane == 1 ? a.su : a.sv;
#pragma unroll
  for (int y = 0; y < 4; ++y) {
    const size_t o = (row0 + y) * w + x0;
    if (a.src_u8) {
      const uint32_t s = *reinterpret_cast<const uint32_t*>(
          static_cast<const uint8_t*>(p) + o);
      x[4 * y] = s & 255;
      x[4 * y + 1] = (s >> 8) & 255;
      x[4 * y + 2] = (s >> 16) & 255;
      x[4 * y + 3] = s >> 24;
    } else {
      const int4 s =
          *reinterpret_cast<const int4*>(static_cast<const int32_t*>(p) + o);
      x[4 * y] = s.x;
      x[4 * y + 1] = s.y;
      x[4 * y + 2] = s.z;
      x[4 * y + 3] = s.w;
    }
  }
}

// Offset (in int4s) of row y of the thread's block in an MB-layout
// int32 plane ([lanes, C, n, n]).
__device__ __forceinline__ size_t mb_row(const Role& k, size_t m, int y) {
  return (m * k.n * k.n + (size_t)(4 * k.by + y) * k.n + 4 * k.bx) >> 2;
}

// Block b is lane b: a warp walks its C columns.
__global__ void __launch_bounds__(32) intra16_enc_kernel(Args a) {
  __shared__ int left[32];  // luma rows 0-15, Cb 16-23, Cr 24-31
  __shared__ int xdc[24];   // the blocks' DC coefficients
  __shared__ int zdc[24];   // the quantised DC levels, raster per plane
  const int t = threadIdx.x;
  const size_t lane = blockIdx.x;
  const Role k = role(t);
  const bool act = k.luma || k.chroma;
  const int qp = k.chroma ? a.qpc : a.qp;  // the thread's plane's QP
  const int qm = qp % 6, qd = qp / 6;
  const int qbits = 15 + qd, fq = (1 << qbits) / 3, scale = 1 << qd;
  const int mf[3] = {kMF[0][qm], kMF[1][qm], kMF[2][qm]};
  const int vs[3] = {kV[0][qm], kV[1][qm], kV[2][qm]};
  const bool d4 = a.inter_sad != nullptr;

  int cur[16] = {}, nxt[16] = {};
  load_src(cur, a, k, lane, 0);
  int isad = d4 ? a.inter_sad[lane * a.C] : 0;
  for (int col = 0; col < a.C; ++col) {
    const size_t m = lane * a.C + col;
    int isad_next = 0;
    if (col + 1 < a.C) {
      load_src(nxt, a, k, lane, col + 1);
      if (d4) isad_next = a.inter_sad[m + 1];
    }
    const bool first = col == 0;

    // ---- prediction: DC and H of the thread's rows, their SADs ----
    int pdc = 128, ph[4] = {128, 128, 128, 128};
    if (!first && act) {
      int sum = 0;
      if (k.luma) {
#pragma unroll
        for (int i = 0; i < 16; ++i) sum += left[i];
        pdc = (sum + 8) >> 4;
      } else {  // the block's rows are its 4-row half
#pragma unroll
        for (int i = 0; i < 4; ++i) sum += left[k.li + i];
        pdc = (sum + 2) >> 2;
      }
#pragma unroll
      for (int y = 0; y < 4; ++y) ph[y] = left[k.li + y];
    }
    int sdc = 0, sh = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      sdc += abs(cur[i] - pdc);
      sh += abs(cur[i] - ph[i >> 2]);
    }
    const int l_dc = warp_sum(k.luma ? sdc : 0);
    const int c_dc = warp_sum(k.chroma ? sdc : 0);
    const int l_h = first ? 0 : warp_sum(k.luma ? sh : 0);
    const int c_h = first ? 0 : warp_sum(k.chroma ? sh : 0);
    const bool luma_dc = first || l_dc <= l_h;    // ties to DC
    const bool chroma_dc = first || c_dc <= c_h;
    const int sad = luma_dc ? l_dc : l_h;
    const bool dc_mine = k.luma ? luma_dc : chroma_dc;
    int pred[4];
#pragma unroll
    for (int y = 0; y < 4; ++y) pred[y] = dc_mine ? pdc : ph[y];

    // ---- forward transform and AC quantisation, in registers ----
    int w[16];
#pragma unroll
    for (int i = 0; i < 16; ++i) w[i] = cur[i] - pred[i >> 2];
    forward4x4(w);
    int q[16];
    int nz = 0;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      q[i] = quant(w[i], mf[pos_class(i)], fq, qbits);
      if (i > 0) nz |= q[i];
    }
    if (act) xdc[t] = w[0];
    __syncwarp();

    // ---- the DC transforms: element (i, j) of H X H is the thread's
    // own block's (luma 4x4 over (by, bx), chroma 2x2 per plane) ----
    const int base = k.luma ? 0 : 16 + 4 * (k.plane - 1);
    int z = 0;
    if (k.luma) {
      int f = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          f += h4(k.by, r) * xdc[4 * r + c] * h4(c, k.bx);
      z = quant(f, mf[0], fq << 2, qbits + 2);
    } else if (k.chroma) {
      int f = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          f += ((k.by & r) ? -1 : 1) * xdc[base + 2 * r + c] *
               ((c & k.bx) ? -1 : 1);
      z = quant(f, mf[0], fq << 1, qbits + 1);
    }
    if (act) zdc[t] = z;
    __syncwarp();
    int dcd = 0;  // the block's dequantised DC
    if (k.luma) {
      int g = 0;
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          g += h4(k.by, r) * zdc[4 * r + c] * h4(c, k.bx);
      dcd = qd >= 2 ? g * vs[0] * (1 << (qd - 2))
                    : (g * vs[0] + (1 << (1 - qd))) >> (2 - qd);
    } else if (k.chroma) {
      int g = 0;
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          g += ((k.by & r) ? -1 : 1) * zdc[base + 2 * r + c] *
               ((c & k.bx) ? -1 : 1);
      dcd = (g * vs[0] * scale) >> 1;
    }
    // cbp: luma AC anywhere (bit 0), chroma AC (bit 1), chroma DC (bit 2)
    const int flags = warp_or((k.luma && nz ? 1 : 0) |
                              (k.chroma && nz ? 2 : 0) |
                              (k.chroma && z ? 4 : 0));
    const int cbp_l = flags & 1;
    const int cbp_c = (flags & 2) ? 2 : (flags & 4) ? 1 : 0;

    // ---- reconstruction ----
    int rec[16];
    rec[0] = dcd;
#pragma unroll
    for (int i = 1; i < 16; ++i) rec[i] = q[i] * vs[pos_class(i)] * scale;
    inverse4x4(rec);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      rec[i] = clip255(pred[i >> 2] + ((rec[i] + 32) >> 6));
    const bool use = !d4 || sad < isad;  // inter wins a tie
    if (!use && act) {
      const int32_t* ip = k.plane == 0 ? a.iy : k.plane == 1 ? a.iu : a.iv;
#pragma unroll
      for (int y = 0; y < 4; ++y) {
        const int4 s = reinterpret_cast<const int4*>(ip)[mb_row(k, m, y)];
        rec[4 * y] = s.x;
        rec[4 * y + 1] = s.y;
        rec[4 * y + 2] = s.z;
        rec[4 * y + 3] = s.w;
      }
    }

    // ---- outputs ----
    if (t == 0) {
      a.mode[m] = luma_dc ? 2 : 1;
      a.cmode[m] = chroma_dc ? 0 : 1;
      a.cbp_l[m] = cbp_l;
      a.cbp_c[m] = cbp_c;
      if (a.sad) a.sad[m] = sad;
      if (a.use) a.use[m] = use;
    }
    if (k.luma) {
      a.dc[m * 16 + t] = (int16_t)zdc[zz(t)];
      int16_t* o = a.ac + m * 256 + 16 * t;
      o[0] = 0;  // slot 0 is the DC, coded apart
#pragma unroll
      for (int s = 1; s < 16; ++s) o[s] = (int16_t)q[zz(s)];
      if (a.i4) a.i4[m * 16 + t] = -1;
    } else if (k.chroma) {
      const int p = k.plane - 1;
      a.cdc[m * 8 + 4 * p + k.j] = (int16_t)z;
      int16_t* o = a.cac + m * 120 + 60 * p + 15 * k.j;
#pragma unroll
      for (int s = 1; s < 16; ++s) o[s - 1] = (int16_t)q[zz(s)];
    }
    if (act) {
      if (d4) {
        int32_t* op = k.plane == 0 ? a.ry : k.plane == 1 ? a.ru : a.rv;
#pragma unroll
        for (int y = 0; y < 4; ++y)
          reinterpret_cast<int4*>(op)[mb_row(k, m, y)] = make_int4(
              rec[4 * y], rec[4 * y + 1], rec[4 * y + 2], rec[4 * y + 3]);
      } else {
        uint8_t* op = k.plane == 0 ? a.ry8 : k.plane == 1 ? a.ru8 : a.rv8;
        const size_t w = (size_t)a.C * k.n;
#pragma unroll
        for (int y = 0; y < 4; ++y)
          *reinterpret_cast<uint32_t*>(
              op + (lane * k.n + 4 * k.by + y) * w + (size_t)col * k.n +
              4 * k.bx) = (uint32_t)rec[4 * y] |
                          ((uint32_t)rec[4 * y + 1] << 8) |
                          ((uint32_t)rec[4 * y + 2] << 16) |
                          ((uint32_t)rec[4 * y + 3] << 24);
      }
      // the right column of the final reconstruction: the next MB's left
      if (k.bx == (k.luma ? 3 : 1)) {
#pragma unroll
        for (int y = 0; y < 4; ++y) left[k.li + y] = rec[4 * y + 3];
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < 16; ++i) cur[i] = nxt[i];
    isad = isad_next;
  }
}

}  // namespace

#ifdef __CUDACC__  // the entries; tests/test_torch_intra_enc.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// D3: lanes = S * R MB rows of C MB columns; the source planes are
// uint8 (src_u8 1) or int32, raster; recon out as uint8 raster planes.
extern "C" int th264_intra16_encode_rows(
    const void* sy, const void* su, const void* sv, int src_u8,
    int32_t* mode, int32_t* cmode, int32_t* cbp_l, int32_t* cbp_c,
    int16_t* dc, int16_t* ac, int16_t* cdc, int16_t* cac, int16_t* i4,
    uint8_t* ry, uint8_t* ru, uint8_t* rv, int lanes, int C, int qp,
    int qpc, void* stream) {
  const Args a{sy, su, sv, src_u8, nullptr, nullptr, nullptr, nullptr,
               mode, cmode, cbp_l, cbp_c, nullptr, nullptr, dc, ac, cdc,
               cac, i4, ry, ru, rv, nullptr, nullptr, nullptr, lanes, C, qp,
               qpc};
  intra16_enc_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// D4: the same with the inter SAD [lanes, C] and the inter
// reconstruction (int32, MB layout); writes the choice (`use`), the
// intra SAD and the final reconstruction (int32, MB layout).
extern "C" int th264_intra16_in_p_rows(
    const void* sy, const void* su, const void* sv, int src_u8,
    const int32_t* inter_sad, const int32_t* iy, const int32_t* iu,
    const int32_t* iv, int32_t* mode, int32_t* cmode, int32_t* cbp_l,
    int32_t* cbp_c, int32_t* sad, uint8_t* use, int16_t* dc, int16_t* ac,
    int16_t* cdc, int16_t* cac, int32_t* ry, int32_t* ru, int32_t* rv,
    int lanes, int C, int qp, int qpc, void* stream) {
  const Args a{sy, su, sv, src_u8, inter_sad, iy, iu, iv, mode, cmode,
               cbp_l, cbp_c, sad, use, dc, ac, cdc, cac, nullptr, nullptr,
               nullptr, nullptr, ry, ru, rv, lanes, C, qp, qpc};
  intra16_enc_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
