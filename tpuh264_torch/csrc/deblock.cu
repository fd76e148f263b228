// D1: the in-loop deblocking filter (H.264 8.7) in row-slice mode
// (disable_deblocking_filter_idc 2), one MB row a warp.
//
// Replaces: tpuh264/kernels/deblock.py `deblock_frame_rows` (:130), a
// jax.lax.scan over MB columns (scan at :303), not a pallas_call.  Its
// plain PyTorch version is `kernels/deblock.py` `_deblock_rows_plain`.
//
// What it computes, exactly as the plain version: per MB, in order, the
// left MB edge (luma and both chroma planes; bS 4 if either MB is intra,
// else 2 if either 4x4 block beside the edge is coded, else 1 if the
// whole-MB MVs differ by >= 4 quarter pels or the reference indices
// differ, else 0; none in column 0), the internal vertical edges x = 4,
// 8, 12 (chroma x = 4) and the internal horizontal edges y = 4, 8, 12
// (chroma y = 4), bS 3 if intra, else 2 if either block is coded.  With
// t8 the luma edges 4 and 12 (both ways) get bS 0; the chroma internal
// edge takes luma edge 8's bS unmasked.  Chroma row (column) k takes the
// bS of luma 4-row group k / 2.  The next MB's left edge changes columns
// 13..15 of this MB after its horizontal edges.  Samples must lie in
// [0, 255] (every reconstruction the callers pass); the arithmetic is
// int32 as the plain version's, and the outputs are its uint8 planes.
//
// What bounds it on the H100: the dependent chain, not bytes.  Row
// slices never filter across MB rows, so the S x R MB rows are
// independent lanes (272 at 1080p x 4), but inside a lane the C columns
// are strictly ordered and each column is 7 edge passes that read what
// the pass before wrote.  The bytes bound (int32 planes and side
// information in, uint8 planes out: 65.4 MB, 0.0195 ms at 1080p x 4)
// is far below the chain's 120 x 7 dependent passes.
//
// Design: one warp (a block of 32 threads) per lane.
//  * Within an edge the 16 luma rows (vertical edges) or columns
//    (horizontal edges) are independent, and so are the 8 of each chroma
//    plane: threads 0-15 take luma, 16-23 U and 24-31 V.  The left edge
//    and the first internal edge each way keep all 32 threads busy; the
//    two further luma edges each way use 16.  A __syncwarp between passes
//    orders them.
//  * The lane keeps two MBs in shared memory as int32 (luma 16 x 2 x 16,
//    chroma 8 x 2 x 8 a plane, rows padded to 33 / 17 words so a pass's
//    row-wise reads fall in distinct banks), alternating slots: column c
//    sits in slot c & 1 and column c - 1 in the other.  Once column c's
//    left edge is filtered, MB c - 1 is final and leaves as uint8, once.
//  * Column c + 1's samples and side information are loaded into
//    registers (16-byte loads) while column c is filtered, so the loads
//    overlap the chain.
//  * ALPHA, BETA and TC0 (Table 8-16, 8-17) sit in __constant__ memory,
//    copied from the port's golden/deblock.py (tests/test_torch_deblock.py
//    holds them equal); qp is uniform, so every lookup is a broadcast.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kLS = 33;  // luma window row stride: 2 MB slots of 16 + pad
constexpr int kCS = 17;  // chroma window row stride: 2 slots of 8 + pad
constexpr int kSide = 21;  // per MB: nnz[16] (by, bx), kind, mvx, mvy, ref, t8

__constant__ int kAlpha[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 4, 4, 5, 6, 7, 8, 9,
    10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36, 40, 45, 50, 56, 63, 71, 80,
    90, 101, 113, 127, 144, 162, 182, 203, 226, 255, 255};
__constant__ int kBeta[52] = {
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 2, 2, 2, 3, 3, 3, 3,
    4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13, 14,
    14, 15, 15, 16, 16, 17, 17, 18, 18};
__constant__ int kTc0[52][3] = {
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0},
    {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 0}, {0, 0, 1},
    {0, 0, 1}, {0, 0, 1}, {0, 0, 1}, {0, 1, 1}, {0, 1, 1}, {1, 1, 1},
    {1, 1, 1}, {1, 1, 1}, {1, 1, 1}, {1, 1, 2}, {1, 1, 2}, {1, 1, 2},
    {1, 1, 2}, {1, 2, 3}, {1, 2, 3}, {2, 2, 3}, {2, 2, 4}, {2, 3, 4},
    {2, 3, 4}, {3, 3, 5}, {3, 4, 6}, {3, 4, 6}, {4, 5, 7}, {4, 5, 8},
    {4, 6, 9}, {5, 7, 10}, {6, 8, 11}, {6, 8, 13}, {7, 10, 14},
    {8, 11, 16}, {9, 12, 18}, {10, 13, 20}, {11, 15, 23}, {13, 17, 25}};

// the filter parameters of one QP (luma qp or chroma qpc)
struct Params {
  int alpha, beta, tc1, tc2, tc3;  // tc0 for bS 1, 2, >= 3
  __device__ int tc0(int bs) const {
    return bs <= 1 ? tc1 : (bs == 2 ? tc2 : tc3);
  }
};

__device__ __forceinline__ Params params(int qp) {
  return Params{kAlpha[qp], kBeta[qp], kTc0[qp][0], kTc0[qp][1],
                kTc0[qp][2]};
}

__device__ __forceinline__ int clip3(int lo, int hi, int x) {
  return min(max(x, lo), hi);
}

// One luma edge line: p_k = P[-k * st], q_k = Q[k * st], k = 0..3.
__device__ __forceinline__ void filter_luma(int* P, int* Q, int st, int bs,
                                            const Params& f) {
  if (bs <= 0) return;
  const int p0 = P[0], p1 = P[-st], p2 = P[-2 * st], p3 = P[-3 * st];
  const int q0 = Q[0], q1 = Q[st], q2 = Q[2 * st], q3 = Q[3 * st];
  if (!(abs(p0 - q0) < f.alpha && abs(p1 - p0) < f.beta &&
        abs(q1 - q0) < f.beta))
    return;
  const bool ap = abs(p2 - p0) < f.beta, aq = abs(q2 - q0) < f.beta;
  if (bs == 4) {
    const bool strong = abs(p0 - q0) < ((f.alpha >> 2) + 2);
    if (ap && strong) {
      P[0] = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3;
      P[-st] = (p2 + p1 + p0 + q0 + 2) >> 2;
      P[-2 * st] = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3;
    } else {
      P[0] = (2 * p1 + p0 + q1 + 2) >> 2;
    }
    if (aq && strong) {
      Q[0] = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3;
      Q[st] = (q2 + q1 + q0 + p0 + 2) >> 2;
      Q[2 * st] = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3;
    } else {
      Q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    }
    return;
  }
  const int tc0 = f.tc0(bs);
  const int tc = tc0 + ap + aq;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  P[0] = clip3(0, 255, p0 + delta);
  Q[0] = clip3(0, 255, q0 - delta);
  const int avg = (p0 + q0 + 1) >> 1;
  if (ap) P[-st] = p1 + clip3(-tc0, tc0, (p2 + avg - 2 * p1) >> 1);
  if (aq) Q[st] = q1 + clip3(-tc0, tc0, (q2 + avg - 2 * q1) >> 1);
}

// One chroma edge line: p1 p0 | q0 q1.
__device__ __forceinline__ void filter_chroma(int* P, int* Q, int st,
                                              int bs, const Params& f) {
  if (bs <= 0) return;
  const int p0 = P[0], p1 = P[-st], q0 = Q[0], q1 = Q[st];
  if (!(abs(p0 - q0) < f.alpha && abs(p1 - p0) < f.beta &&
        abs(q1 - q0) < f.beta))
    return;
  if (bs == 4) {
    P[0] = (2 * p1 + p0 + q1 + 2) >> 2;
    Q[0] = (2 * q1 + q0 + p1 + 2) >> 2;
    return;
  }
  const int tc = f.tc0(bs) + 1;
  const int delta = clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3);
  P[0] = clip3(0, 255, p0 + delta);
  Q[0] = clip3(0, 255, q0 - delta);
}

// bS of an internal edge between 4x4 blocks a and b of one MB
__device__ __forceinline__ int bs_internal(const int* sd, int a, int b) {
  if (sd[16] == 2) return 3;
  return (sd[a] > 0 || sd[b] > 0) ? 2 : 0;
}

// bS of the left MB edge at 4-row group by: sp the left MB, sc this one
__device__ __forceinline__ int bs_left(const int* sp, const int* sc, int by) {
  if (sc[16] == 2 || sp[16] == 2) return 4;
  if (sp[4 * by + 3] > 0 || sc[4 * by] > 0) return 2;
  return (abs(sc[17] - sp[17]) >= 4 || abs(sc[18] - sp[18]) >= 4 ||
          sc[19] != sp[19])
             ? 1
             : 0;
}

// One MB column's inputs, in flight in registers.
struct Column {
  int4 y0, y1;  // luma row t / 2, samples 8 (t & 1) .. + 7
  int4 c;       // chroma plane t / 16, row (t & 15) / 2, samples 4 (t & 1) ..
  int side;     // kSide entry t (t < kSide)
};

__device__ __forceinline__ Column load_column(
    const int32_t* __restrict__ y, const int32_t* __restrict__ u,
    const int32_t* __restrict__ v, const int32_t* __restrict__ nnz,
    const int32_t* __restrict__ kind, const int32_t* __restrict__ mvx,
    const int32_t* __restrict__ mvy, const int32_t* __restrict__ ref,
    const int32_t* __restrict__ t8, int lane, int C, int col, int t) {
  const int W = 16 * C, Wc = 8 * C;
  Column k;
  const int4* py = reinterpret_cast<const int4*>(
      y + (size_t)(16 * lane + (t >> 1)) * W + 16 * col + 8 * (t & 1));
  k.y0 = py[0];
  k.y1 = py[1];
  const int32_t* cp = (t < 16) ? u : v;
  k.c = *reinterpret_cast<const int4*>(
      cp + (size_t)(8 * lane + ((t & 15) >> 1)) * Wc + 8 * col + 4 * (t & 1));
  const size_t mb = (size_t)lane * C + col;
  k.side = 0;
  if (t < 16) k.side = nnz[16 * mb + t];
  else if (t == 16) k.side = kind[mb];
  else if (t == 17) k.side = mvx[mb];
  else if (t == 18) k.side = mvy[mb];
  else if (t == 19) k.side = ref ? ref[mb] : 0;
  else if (t == 20) k.side = t8 ? t8[mb] : 0;
  return k;
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 255) | ((uint32_t)(b & 255) << 8) |
         ((uint32_t)(c & 255) << 16) | ((uint32_t)(d & 255) << 24);
}

__global__ void __launch_bounds__(32)
    deblock_rows_kernel(const int32_t* __restrict__ y,
                        const int32_t* __restrict__ u,
                        const int32_t* __restrict__ v,
                        const int32_t* __restrict__ kind,
                        const int32_t* __restrict__ mvx,
                        const int32_t* __restrict__ mvy,
                        const int32_t* __restrict__ ref,
                        const int32_t* __restrict__ t8,
                        const int32_t* __restrict__ nnz,
                        uint8_t* __restrict__ oy, uint8_t* __restrict__ ou,
                        uint8_t* __restrict__ ov, int C, int qp, int qpc) {
  __shared__ int L[16 * kLS];
  __shared__ int Ch[2][8 * kCS];
  __shared__ int side[2][kSide];
  const int lane = blockIdx.x;  // s * R + r: its luma rows are 16 lane ..
  const int t = threadIdx.x;
  const int W = 16 * C, Wc = 8 * C;
  const Params fl = params(qp), fc = params(qpc);
  // this thread's chroma line: plane cp, row / column k
  const int cp = (t - 16) >> 3, k = (t - 16) & 7;
  const int ly = t >> 1, lh = t & 1;                  // load / store: luma
  const int cpl = t >> 4, cy = (t & 15) >> 1;         // and chroma

  Column next = load_column(y, u, v, nnz, kind, mvx, mvy, ref, t8, lane, C,
                            0, t);
  for (int col = 0; col < C; ++col) {
    const int cs = col & 1, ps = cs ^ 1;
    {  // column col -> slot cs
      int* lr = L + ly * kLS + 16 * cs + 8 * lh;
      lr[0] = next.y0.x; lr[1] = next.y0.y; lr[2] = next.y0.z;
      lr[3] = next.y0.w; lr[4] = next.y1.x; lr[5] = next.y1.y;
      lr[6] = next.y1.z; lr[7] = next.y1.w;
      int* cr = Ch[cpl] + cy * kCS + 8 * cs + 4 * lh;
      cr[0] = next.c.x; cr[1] = next.c.y; cr[2] = next.c.z; cr[3] = next.c.w;
      if (t < kSide) side[cs][t] = next.side;
    }
    __syncwarp();
    if (col + 1 < C)
      next = load_column(y, u, v, nnz, kind, mvx, mvy, ref, t8, lane, C,
                         col + 1, t);
    const int* sc = side[cs];
    const bool tf = sc[20] == 1;

    if (col > 0) {
      // ---- the left MB edge (MB col - 1 | MB col) ----
      const int* sp = side[ps];
      if (t < 16) {
        int* row = L + t * kLS;
        filter_luma(row + 16 * ps + 15, row + 16 * cs, 1,
                    bs_left(sp, sc, t >> 2), fl);
      } else {
        int* row = Ch[cp] + k * kCS;
        filter_chroma(row + 8 * ps + 7, row + 8 * cs, 1,
                      bs_left(sp, sc, k >> 1), fc);
      }
      __syncwarp();
      // MB col - 1 is final: out as uint8
      const int* lr = L + ly * kLS + 16 * ps + 8 * lh;
      *reinterpret_cast<uint2*>(oy + (size_t)(16 * lane + ly) * W +
                                16 * (col - 1) + 8 * lh) =
          make_uint2(pack4(lr[0], lr[1], lr[2], lr[3]),
                     pack4(lr[4], lr[5], lr[6], lr[7]));
      const int* cr = Ch[cpl] + cy * kCS + 8 * ps + 4 * lh;
      *reinterpret_cast<uint32_t*>((cpl ? ov : ou) +
                                   (size_t)(8 * lane + cy) * Wc +
                                   8 * (col - 1) + 4 * lh) =
          pack4(cr[0], cr[1], cr[2], cr[3]);
    }

    // ---- internal vertical edges x = 4, 8, 12 (chroma x = 4) ----
#pragma unroll
    for (int bx = 1; bx <= 3; ++bx) {
      if (t < 16) {
        const int by = t >> 2;
        int bs = bs_internal(sc, 4 * by + bx - 1, 4 * by + bx);
        if (bx != 2 && tf) bs = 0;
        int* e = L + t * kLS + 16 * cs + 4 * bx;
        filter_luma(e - 1, e, 1, bs, fl);
      } else if (bx == 1) {
        const int by = k >> 1;
        int* e = Ch[cp] + k * kCS + 8 * cs + 4;
        filter_chroma(e - 1, e, 1, bs_internal(sc, 4 * by + 1, 4 * by + 2),
                      fc);
      }
      __syncwarp();
    }
    // ---- internal horizontal edges y = 4, 8, 12 (chroma y = 4) ----
#pragma unroll
    for (int by = 1; by <= 3; ++by) {
      if (t < 16) {
        const int bx = t >> 2;
        int bs = bs_internal(sc, 4 * (by - 1) + bx, 4 * by + bx);
        if (by != 2 && tf) bs = 0;
        int* e = L + 4 * by * kLS + 16 * cs + t;
        filter_luma(e - kLS, e, kLS, bs, fl);
      } else if (by == 1) {
        const int bx = k >> 1;
        int* e = Ch[cp] + 4 * kCS + 8 * cs + k;
        filter_chroma(e - kCS, e, kCS, bs_internal(sc, 4 + bx, 8 + bx), fc);
      }
      __syncwarp();
    }
  }
  // the last MB of the lane
  const int ls = (C - 1) & 1;
  const int* lr = L + ly * kLS + 16 * ls + 8 * lh;
  *reinterpret_cast<uint2*>(oy + (size_t)(16 * lane + ly) * W +
                            16 * (C - 1) + 8 * lh) =
      make_uint2(pack4(lr[0], lr[1], lr[2], lr[3]),
                 pack4(lr[4], lr[5], lr[6], lr[7]));
  const int* cr = Ch[cpl] + cy * kCS + 8 * ls + 4 * lh;
  *reinterpret_cast<uint32_t*>((cpl ? ov : ou) + (size_t)(8 * lane + cy) * Wc +
                               8 * (C - 1) + 4 * lh) =
      pack4(cr[0], cr[1], cr[2], cr[3]);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_deblock.py runs the rest
                   // above on CPU threads, compiled by g++ against shims

// lanes = S * R MB rows of C MB columns; ref and t8 may be null (all 0).
extern "C" int th264_deblock_rows(
    const int32_t* y, const int32_t* u, const int32_t* v,
    const int32_t* kind, const int32_t* mvx, const int32_t* mvy,
    const int32_t* ref, const int32_t* t8, const int32_t* nnz, uint8_t* oy,
    uint8_t* ou, uint8_t* ov, int lanes, int C, int qp, int qpc,
    void* stream) {
  deblock_rows_kernel<<<lanes, 32, 0, (cudaStream_t)stream>>>(
      y, u, v, kind, mvx, mvy, ref, t8, nnz, oy, ou, ov, C, qp, qpc);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
