// K7 and K8: the single-slice I frame's wavefront scans, the encode (K7,
// `th264_wavefront_encode`) and the reconstruction from parsed symbols
// (K8, `th264_wavefront_decode`): one thread-block cluster per stream,
// its MB rows pipelined, one launch a frame each way.
//
// Replaces: the jax.lax.scans of tpuh264/kernels/wavefront.py
// `encode_iframe_single` (:151; step :180, scan :284, `_collect` :288) and
// `decode_iframe_single` (:325; step :353, scan :435), not pallas_calls.
// Their plain PyTorch versions are kernels/wavefront.py
// `_encode_iframe_single_plain` and `_decode_iframe_single_plain`.
//
// What they compute, exactly as the plain versions.  A single-slice
// picture predicts across MB rows, so MB (r, c) reads the reconstructed
// samples of its left, top and top-left neighbours: the top row, the
// left column and the corner p[-1, -1] of each plane.
//  * K7, per MB: the four Intra_16x16 luma candidates in the golden order
//    DC, V, H, Plane (mode numbers 2, 0, 1, 3), V needing the top, H the
//    left, Plane both; the first strict minimum of the SADs wins.  Then
//    the luma transform of src - pred, the 16 DC coefficients through the
//    4x4 Hadamard and quant_luma_dc, the AC through quant4x4 (intra
//    rounding), the reconstruction (DC dequant, AC dequant, inverse 4x4,
//    (+ 32) >> 6, clip to 0..255).  Chroma the same, in the order DC (a
//    DC a 4x4 quadrant, 8.3.4.1), H, V, Plane (scale 34), by the summed
//    Cb + Cr SAD, with the 2x2 Hadamard and quant_chroma_dc.  The plain
//    version masks the dequantised levels by cbp; every such mask is a
//    no-op here (a cbp of 0 means those levels are all zero).
//  * K8, per MB: the residuals of the parsed levels exactly as
//    iframe._intra_residuals (the JAX step's :381-401): luma AC only where
//    cbp_luma == 1, chroma DC only where cbp_chroma >= 1, chroma AC only
//    where cbp_chroma == 2 (the symbols are input, so these masks act);
//    plus the prediction of the parsed `mode` / `cmode`, clipped to
//    0..255.
// Where a neighbour is unavailable (row 0 has no top, column 0 no left)
// its samples read 0, and so does the corner of row 0 and of MB (1, 0).
// A legal stream never predicts from them: V needs the top, H the left,
// Plane both, and DC uses only the available sides.  On a mode that is
// illegal at its MB the plain version's saved corner decides: a column-0
// MB from row 2 on takes the bottom-right sample of MB (r - 2, 0), and so
// does K8.
//
// Design.  MB (r, c) needs MBs (r, c - 1), (r - 1, c) and (r - 1, c - 1),
// so the critical path is R + C - 1 MBs deep; the design shortens each
// step of it and gives every MB that is ready its own warps.
//  * A stream is a cluster of K CTAs, launched with cudaLaunchKernelEx:
//    up to 16 (non-portable) where cudaOccupancyMaxActiveClusters
//    confirms that one fits, else up to 8; a cluster that cannot be
//    resident is a CUDA error the caller raises.  CTA k owns the
//    contiguous band of rpc = ceil(R / 16) MB rows from k rpc (K =
//    ceil(R / rpc)): config 1's 23 rows as 12 x 2, 480p's 30 as 15 x 2,
//    1080p's 68 as 14 x 5.  On an H100, 16 over 8 took 9-21% off at config
//    1 and 1080p (fewer rows, so fewer warps, share an SM's schedulers)
//    and nothing at 480p x 8 (tools/time_wavefront.py).
//  * Rows, not waves.  Each MB row has a team that walks it left to
//    right, keeping its left neighbour in the team's shared scratch.  Row
//    r - 1 hands each MB's bottom sample rows (16 luma, 8 Cb, 8 Cr) down
//    to row r's inbox in the shared memory of the CTA that owns row r:
//    the `Front` entry of column c, then a release store (cluster scope)
//    of the count of columns handed down; row r acquires that count
//    before MB c.  Across a band boundary the stores go through DSMEM
//    (`cl_map`, cluster.map_shared_rank).  One lane writes the entry (the
//    bottom row gathered by shuffles) and then the count, so the release
//    orders exactly what the row below reads; the MB's global stores
//    (recon, levels), never read back, come after it, so that the release
//    does not wait for them.  The corner of MB (r, c > 0) is byte 15 / 7
//    of the inbox entry of column c - 1; at column 0 it is the last sample
//    of the top row that row r - 1 received there, handed down with
//    column 0.  Every inbox starts zeroed (row 0's top, the corners of
//    rows 0-1).  No block barrier a wave, no cluster barrier a wave: one
//    cluster barrier after the inboxes are zeroed and one before exit.
//  * Teams: rpc teams a CTA, at most WF_MAX_TEAMS = 9 (beyond, a team
//    takes every `teams`-th row of the band, which stalls the pipeline
//    but stays exact).  The pipeline wants at least min(R, C) teams a
//    stream: R at every shape here.  A team is two warps, so a CTA has at
//    most 576 threads and __launch_bounds__ holds a thread to 112
//    registers (65,536 an SM); both kernels need fewer, without spills.
//  * K7's team: a luma warp and a chroma warp, two independent chains,
//    each with its own count in the inbox.  Each loads its part of the
//    source one MB ahead into registers (the load in flight under the MB
//    before, off the chain).  The SADs go on packed bytes (__vsadu4), two
//    candidates summed in the halves of a word (at most 65,280 luma,
//    32,640 chroma), every lane 8 luma or 4 chroma samples of all four
//    candidates; the choice stays the first strict minimum in the golden
//    order.  Then a 4x4 block a lane pair (luma 16 blocks on all 32 lanes,
//    chroma 8 on lanes 0-7 and 16-23): prediction, transform, quant, the
//    DC Hadamards through the warp's scratch, dequant, inverse, recon,
//    each lane 8 samples or coefficients, one exchange in each transform
//    (on an H100, 18-19% faster than a lane a block).
//  * K8's team: a residual warp that runs up to kRing MBs ahead of the
//    chain, decoding each MB's 384 residuals from its levels into a ring
//    in shared memory (int16, saturated: exact, since the clipped sum
//    with a prediction in 0..255 is 0 or 255 beyond that; luma and chroma
//    lanes share one path but for the DC), and a prediction warp whose
//    chain is only the prediction, the add and clip and the hand-off.
//    Two counts (produced, consumed; CTA scope) guard the ring.
//  * Every wait is `wait_for` / `wait_local`, and every cluster primitive
//    one of the `cl_*` / `cta_*` functions below, so that the tests can
//    run this source on CPU threads (tests/cuda_threads.py), where a wait
//    yields its fiber.
//
// What bounds it on the H100: the chain of R + C - 1 MB steps, each one
// warp's dependent instruction stream (K7's luma or chroma MB, K8's
// prediction) plus a hand-off through (D)SMEM, and the SM's issue where
// several rows share it; not bytes: K7 moves 1,616 B an MB (source in,
// levels and recon out), K8 1,200 B (16 B of flags, 800 B of int16
// levels, 384 B of recon), microseconds at 3.35 TB/s.  K6's transform
// algebra (F(src) and 12 of 15 AC levels off the prediction) is not
// applied: in a pipeline whose every step waits on both neighbours at
// once, work moved off a chain warp shortens the step only on other
// warps, and those share the same SM's issue.

#include <cuda_runtime.h>
#include <stdint.h>

#include "intra16_common.cuh"

#ifdef __CUDACC__
#include <cooperative_groups.h>
#endif

// The largest cluster tried (16 where it fits, else 8, the portable
// size) and the most teams a CTA; the tests build the source with smaller
// ones, so that a CTA holds several rows and a team several rows too.
#ifndef WF_MAX_CLUSTER
#define WF_MAX_CLUSTER 16
#endif
#ifndef WF_MAX_TEAMS
#define WF_MAX_TEAMS 9
#endif

#ifdef __CUDACC__
namespace {
namespace cg = cooperative_groups;

// this CTA's dynamic shared memory
__device__ __forceinline__ uint8_t* cl_smem() {
  extern __shared__ __align__(16) uint8_t wf_smem[];
  return wf_smem;
}
// `p`, an address in this CTA's shared memory, in CTA `rank`'s
template <typename T>
__device__ __forceinline__ T* cl_map(T* p, int rank) {
  return cg::this_cluster().map_shared_rank(p, rank);
}
__device__ __forceinline__ void cl_sync() { cg::this_cluster().sync(); }
__device__ __forceinline__ unsigned cl_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cluster.u32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}
__device__ __forceinline__ void cl_release(unsigned* p, unsigned v) {
  asm volatile("st.release.cluster.u32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}
// the same at CTA scope (K8's ring, shared by two warps of one CTA)
__device__ __forceinline__ unsigned cta_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.cta.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void cta_release(unsigned* p, unsigned v) {
  asm volatile("st.release.cta.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void cl_pause() { __nanosleep(20); }
}  // namespace
#endif

namespace {

constexpr int kRing = 4;  // K8: MBs of residuals in flight a team

// Until *f >= v (acquire, cluster scope).
__device__ __forceinline__ void wait_for(const unsigned* f, unsigned v) {
  while (cl_acquire(f) < v) cl_pause();
}
// Until *f >= v (acquire, CTA scope).
__device__ __forceinline__ void wait_local(const unsigned* f, unsigned v) {
  while (cta_acquire(f) < v) cl_pause();
}

// A column's bottom sample rows, handed to the row below: luma 16, Cb 8
// | Cr 8.
struct Front {
  uint4 y, c;
};

// A row's inbox beside its Front entries: the columns handed down (K7:
// luma, chroma; K8: [0]) and the column-0 corner (luma, Cb, Cr).
struct Inbox {
  unsigned ready[2];
  int corner[3];
  int pad[3];
};

// K7's team scratch: the luma warp's, then the chroma warp's.
struct EncTeam {
  uint8_t ys[256];    // the source luma MB, raster
  uint8_t left[16];   // the left column
  int dcs[16];        // each block's DC coefficient
  int zl[16];         // the DC levels, raster
  uint8_t cs[2][64];  // the source Cb, Cr
  uint8_t cleft[16];  // Cb 8 | Cr 8
  int cdc[2][4], czl[2][4];
};

// K8's team scratch: the residual ring and the prediction warp's left
// columns.
struct DecTeam {
  int16_t ry[kRing][256];    // luma residuals, raster
  int16_t rc[kRing][2][64];  // Cb, Cr
  uint8_t left[32];          // luma 16 | Cb 8 | Cr 8
  unsigned produced, consumed;
  unsigned pad[2];
};

// Every part of a CTA's shared memory is a multiple of 16 bytes, so that
// each starts 16-byte aligned (uint4 accesses).
static_assert(sizeof(Front) % 16 == 0 && sizeof(Inbox) % 16 == 0 &&
                  sizeof(EncTeam) % 16 == 0 && sizeof(DecTeam) % 16 == 0,
              "shared memory parts must be 16-byte multiples");

// The rows of a launch: R x C MBs a stream, K CTAs a cluster, rpc rows a
// CTA, `teams` teams a CTA.
struct Grid {
  int R, C, K, rpc, teams;
};

// A CTA's shared memory: Front [rpc][C], Inbox [rpc], then the teams'.
struct Layout {
  uint8_t* base;
  int rpc, C;
  __device__ Front* front(int lr) const {
    return reinterpret_cast<Front*>(base) + (size_t)lr * C;
  }
  __device__ Inbox* inbox(int lr) const {
    return reinterpret_cast<Inbox*>(base + (size_t)rpc * C * sizeof(Front)) +
           lr;
  }
  template <typename T>
  __device__ T* team(int k) const {
    return reinterpret_cast<T*>(
               base + (size_t)rpc * (C * sizeof(Front) + sizeof(Inbox))) +
           k;
  }
};

__host__ __device__ inline size_t smem_bytes(const Grid& g,
                                             size_t team_bytes) {
  return (size_t)g.rpc * (g.C * sizeof(Front) + sizeof(Inbox)) +
         g.teams * team_bytes;
}

// The launch shape of an R x C frame in clusters of at most kmax CTAs
// (see the note).
inline Grid plan(int R, int C, int kmax = WF_MAX_CLUSTER) {
  const int rpc = (R + kmax - 1) / kmax;
  return Grid{R, C, (R + rpc - 1) / rpc, rpc,
              rpc < WF_MAX_TEAMS ? rpc : WF_MAX_TEAMS};
}

struct EncArgs {
  const void *sy, *su, *sv;     // source planes [S,H,W], [S,H/2,W/2]
  int src_u8;                   // 1: uint8 samples, 0: int32 (0..255)
  int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [S, R, C]
  int16_t *dc, *ac, *cdc, *cac;  // [.,16], [.,16,16], [.,2,4], [.,2,4,15]
  int16_t* i4;                   // [., 16], set to -1
  uint8_t *ry, *ru, *rv;         // recon planes, raster
  Grid g;
  int qp, qpc;
};

struct DecArgs {
  const int32_t *mode, *cmode, *cbp_l, *cbp_c;  // [S, R, C]
  const int16_t *dc, *ac, *cdc, *cac;           // as MBSymbols holds them
  uint8_t *ry, *ru, *rv;                        // recon planes, raster
  Grid g;
  int qp, qpc;
};

__device__ __forceinline__ int byte_of(uint32_t w, int k) {
  return (int)((w >> (8 * k)) & 255u);
}

// 16 / 8 bytes as ints
__device__ __forceinline__ void unpack16(const uint4& v, int* o) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 16; ++i) o[i] = byte_of(w[i >> 2], i & 3);
}
__device__ __forceinline__ void unpack8(const uint2& v, int* o) {
#pragma unroll
  for (int i = 0; i < 8; ++i) o[i] = byte_of(i < 4 ? v.x : v.y, i & 3);
}

// Plane prediction (8.3.3.4 / 8.3.4.4) of an n x n block: a, b, c of
// (a + b (x - n/2 + 1) + c (y - n/2 + 1) + 16) >> 5, clipped.
struct PlaneFit {
  int a, b, c;
};

template <int N, int SCALE>
__device__ __forceinline__ PlaneFit plane_fit(const int* top,
                                              const int* left, int corner) {
  constexpr int half = N / 2;
  int h = 0, v = 0;
#pragma unroll
  for (int x = 0; x < half; ++x) {
    const int tl = x == half - 1 ? corner : top[half - 2 - x];
    const int ll = x == half - 1 ? corner : left[half - 2 - x];
    h += (x + 1) * (top[half + x] - tl);
    v += (x + 1) * (left[half + x] - ll);
  }
  return PlaneFit{16 * (top[N - 1] + left[N - 1]), (SCALE * h + 32) >> 6,
                  (SCALE * v + 32) >> 6};
}

template <int N>
__device__ __forceinline__ int plane_at(const PlaneFit& f, int y, int x) {
  return clip255((f.a + f.b * (x - (N / 2 - 1)) + f.c * (y - (N / 2 - 1)) +
                  16) >> 5);
}

// Luma: DC and the plane fit.
struct LumaPred {
  int dc;
  PlaneFit pf;
};

__device__ __forceinline__ LumaPred luma_pred_of(const int* top,
                                                 const int* left, int corner,
                                                 bool tav, bool lav) {
  int st = 0, sl = 0;
#pragma unroll
  for (int i = 0; i < 16; ++i) st += top[i], sl += left[i];
  const int dc = tav && lav ? (st + sl + 16) >> 5
                 : tav      ? (st + 8) >> 4
                 : lav      ? (sl + 8) >> 4
                            : 128;
  return LumaPred{dc, plane_fit<16, 5>(top, left, corner)};
}

// Chroma of one plane: the DC of each 4x4 quadrant [by][bx] and the
// plane fit.
struct ChromaPred {
  int dc[2][2];
  PlaneFit pf;
};

__device__ __forceinline__ ChromaPred chroma_pred_of(const int* top,
                                                     const int* left,
                                                     int corner, bool tav,
                                                     bool lav) {
  const int ts0 = top[0] + top[1] + top[2] + top[3];
  const int ts1 = top[4] + top[5] + top[6] + top[7];
  const int ls0 = left[0] + left[1] + left[2] + left[3];
  const int ls1 = left[4] + left[5] + left[6] + left[7];
  auto corner_dc = [&](int t, int l) {
    return tav && lav ? (t + l + 4) >> 3
           : tav      ? (t + 2) >> 2
           : lav      ? (l + 2) >> 2
                      : 128;
  };
  auto top_pref = [&](int t, int l) {
    return tav ? (t + 2) >> 2 : lav ? (l + 2) >> 2 : 128;
  };
  auto left_pref = [&](int t, int l) {
    return lav ? (l + 2) >> 2 : tav ? (t + 2) >> 2 : 128;
  };
  ChromaPred p;
  p.dc[0][0] = corner_dc(ts0, ls0);
  p.dc[0][1] = top_pref(ts1, ls0);
  p.dc[1][0] = left_pref(ts0, ls1);
  p.dc[1][1] = corner_dc(ts1, ls1);
  p.pf = plane_fit<8, 34>(top, left, corner);
  return p;
}

// the DC of quadrant (qy, qx), without indexing registers
__device__ __forceinline__ int quadrant_dc(const ChromaPred& p, int qy,
                                           int qx) {
  return qy ? (qx ? p.dc[1][1] : p.dc[1][0]) : (qx ? p.dc[0][1] : p.dc[0][0]);
}

// forward4x4 in place on a raster block: the vertical butterflies of each
// column, then the horizontal ones of each row
__device__ __forceinline__ void forward4x4(int* x) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const int a0 = x[c] + x[12 + c], a1 = x[4 + c] + x[8 + c];
    const int a2 = x[4 + c] - x[8 + c], a3 = x[c] - x[12 + c];
    x[c] = a0 + a1, x[4 + c] = 2 * a3 + a2, x[8 + c] = a0 - a1;
    x[12 + c] = a3 - 2 * a2;
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    int* p = x + 4 * r;
    const int b0 = p[0] + p[3], b1 = p[1] + p[2];
    const int b2 = p[1] - p[2], b3 = p[0] - p[3];
    p[0] = b0 + b1, p[1] = 2 * b3 + b2, p[2] = b0 - b1, p[3] = b3 - 2 * b2;
  }
}

// the first strict minimum of four costs among the available ones
// (candidate 0 always is); no register array indexed at run time
__device__ __forceinline__ int first_min(const int* cost, const bool* av) {
  int best = 0, low = cost[0];
#pragma unroll
  for (int i = 1; i < 4; ++i)
    if (av[i] && cost[i] < low) best = i, low = cost[i];
  return best;
}

// The Front entries and Inbox of row r + 1 (in the CTA that owns it), or
// null pointers below the last row.
struct Below {
  Front* front;
  Inbox* inbox;
};

__device__ __forceinline__ Below below(const Layout& L, const Grid& g,
                                       int r) {
  if (r + 1 >= g.R) return Below{nullptr, nullptr};
  const int k = (r + 1) / g.rpc, lr = (r + 1) % g.rpc;
  return Below{cl_map(L.front(lr), k), cl_map(L.inbox(lr), k)};
}

// Zeroes the CTA's shared memory (the inboxes: row 0's top, the corners
// of rows 0-1, every count), then meets the cluster's other CTAs.
__device__ void start(const Layout& L, const Grid& g, size_t team_bytes) {
  uint4* p = reinterpret_cast<uint4*>(L.base);
  const int n = (int)(smem_bytes(g, team_bytes) / 16);
  for (int i = threadIdx.x; i < n; i += 64 * g.teams)
    p[i] = make_uint4(0, 0, 0, 0);
  cl_sync();
}

// Lane 0 hands a column down to the row below: its Front half `dst` (null
// below the last row) = (w0..w3), at column 0 the corner(s) from `k0`
// (and `k1` where not -1) into inbox slots `ready`'s, then the count of
// columns done (release).  Called before the MB's global stores, so that
// the release does not wait for them.
__device__ __forceinline__ void hand_down(uint4* dst, Inbox* inbox,
                                          int ready, int c, uint32_t w0,
                                          uint32_t w1, uint32_t w2,
                                          uint32_t w3, int k0, int k1,
                                          int t) {
  if (t != 0 || dst == nullptr) return;
  *dst = make_uint4(w0, w1, w2, w3);
  if (c == 0) {
    inbox->corner[ready] = k0;
    if (k1 >= 0) inbox->corner[ready + 1] = k1;
  }
  cl_release(&inbox->ready[ready], (unsigned)c + 1);
}

// ---------------------------------------------------------------- K7

// A lane's part of a source MB, loaded one MB ahead: uint8 samples in
// a.x (and a.y), or int32 samples in a (and b).
struct SrcPart {
  int4 a, b;
};

// luma: lane t, row t >> 1, 8 samples from 8 (t & 1)
__device__ __forceinline__ SrcPart load_luma(const EncArgs& a, int s, int r,
                                             int c, int t) {
  const size_t o =
      ((size_t)s * 16 * a.g.R + 16 * r + (t >> 1)) * (16 * (size_t)a.g.C) +
      16 * (size_t)c + 8 * (t & 1);
  SrcPart p;
  if (a.src_u8) {
    const uint2 v = *reinterpret_cast<const uint2*>(
        static_cast<const uint8_t*>(a.sy) + o);
    p.a = make_int4((int)v.x, (int)v.y, 0, 0);
    p.b = p.a;
  } else {
    const int4* q =
        reinterpret_cast<const int4*>(static_cast<const int32_t*>(a.sy) + o);
    p.a = q[0];
    p.b = q[1];
  }
  return p;
}

// chroma: lane t, plane t >> 4, row (t >> 1) & 7, 4 samples from 4 (t & 1)
__device__ __forceinline__ SrcPart load_chroma(const EncArgs& a, int s,
                                               int r, int c, int t) {
  const size_t o = ((size_t)s * 8 * a.g.R + 8 * r + ((t >> 1) & 7)) *
                       (8 * (size_t)a.g.C) +
                   8 * (size_t)c + 4 * (t & 1);
  const void* src = t >> 4 ? a.sv : a.su;
  SrcPart p;
  if (a.src_u8) {
    p.a = make_int4((int)*reinterpret_cast<const uint32_t*>(
                        static_cast<const uint8_t*>(src) + o),
                    0, 0, 0);
  } else {
    p.a = *reinterpret_cast<const int4*>(static_cast<const int32_t*>(src) +
                                         o);
  }
  p.b = p.a;
  return p;
}

// A 4x4 block on a lane pair, h = t & 1 the lane's half.  In the sample
// domain lane h holds columns 2h, 2h + 1 (c[2 k + j]: row k, column
// 2h + j), in the coefficient domain rows 2h, 2h + 1 (r[4 m + x]: row
// 2h + m, column x).  The forward transform takes the columns' butterflies
// where they lie, then the rows' after one exchange; the inverse the rows'
// where they lie (8.5.12.2 takes rows first), then the columns' after the
// other: every pass is forward4x4's / inverse4x4's, in its order.  Every
// lane of the warp calls the exchanges.

// c -> r: each lane keeps its columns of its rows and takes the partner's
__device__ __forceinline__ void pair_to_rows(const int* c, int* r, int h) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int own = h ? c[2 * (2 + m) + j] : c[2 * m + j];
      const int send = h ? c[2 * m + j] : c[2 * (2 + m) + j];
      const int got = __shfl_xor_sync(0xffffffffu, send, 1);
      r[4 * m + j] = h ? got : own;
      r[4 * m + 2 + j] = h ? own : got;
    }
}

// r -> c
__device__ __forceinline__ void pair_to_cols(const int* r, int* c, int h) {
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int own = h ? r[4 * m + 2 + j] : r[4 * m + j];
      const int send = h ? r[4 * m + j] : r[4 * m + 2 + j];
      const int got = __shfl_xor_sync(0xffffffffu, send, 1);
      c[2 * m + j] = h ? got : own;
      c[2 * (2 + m) + j] = h ? own : got;
    }
}

// the forward transform of c (samples) into r (coefficients)
__device__ __forceinline__ void pair_forward(int* c, int* r, int h) {
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int a0 = c[j] + c[6 + j], a1 = c[2 + j] + c[4 + j];
    const int a2 = c[2 + j] - c[4 + j], a3 = c[j] - c[6 + j];
    c[j] = a0 + a1, c[2 + j] = 2 * a3 + a2, c[4 + j] = a0 - a1;
    c[6 + j] = a3 - 2 * a2;
  }
  pair_to_rows(c, r, h);
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    int* p = r + 4 * m;
    const int b0 = p[0] + p[3], b1 = p[1] + p[2];
    const int b2 = p[1] - p[2], b3 = p[0] - p[3];
    p[0] = b0 + b1, p[1] = 2 * b3 + b2, p[2] = b0 - b1, p[3] = b3 - 2 * b2;
  }
}

// the inverse transform of r (dequantised coefficients) into c
__device__ __forceinline__ void pair_inverse(int* r, int* c, int h) {
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    int* p = r + 4 * m;
    const int e0 = p[0] + p[2], e1 = p[0] - p[2];
    const int e2 = (p[1] >> 1) - p[3], e3 = p[1] + (p[3] >> 1);
    p[0] = e0 + e3, p[1] = e1 + e2, p[2] = e1 - e2, p[3] = e0 - e3;
  }
  pair_to_cols(r, c, h);
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const int g0 = c[j] + c[4 + j], g1 = c[j] - c[4 + j];
    const int g2 = (c[2 + j] >> 1) - c[6 + j], g3 = c[2 + j] + (c[6 + j] >> 1);
    c[j] = g0 + g3, c[2 + j] = g1 + g2, c[4 + j] = g1 - g2, c[6 + j] = g0 - g3;
  }
}

// zigzag slot of raster coefficient i (the inverse of zz)
__device__ __forceinline__ int izz(int i) {
  return (int)((0xFEA9DB83C7426510ull >> (4 * i)) & 15);
}

// Quantises a pair lane's coefficients r (AC through quant4x4; the DC,
// raster 0 on lane h = 0, is left as it is): true where an AC level is
// not zero.
__device__ __forceinline__ bool pair_quant(int* r, int h, const Quant& q) {
  bool nz = false;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const bool dc = i == 0 && h == 0;
    const int z = q_ac(q, r[i], pos_class(i));  // rows 2h + m: same class
    r[i] = dc ? r[i] : z;
    nz |= !dc && z != 0;
  }
  return nz;
}

// Dequantises the AC of a pair lane's levels r (the DC left as it is).
__device__ __forceinline__ void pair_dequant(int* r, int h, const Quant& q) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
    r[i] = i == 0 && h == 0 ? r[i] : dq_ac(q, r[i], pos_class(i));
}

// The recon of a pair lane's columns: clip(pred + (c + 32) >> 6), row k's
// two samples as the bytes of rw[k].
__device__ __forceinline__ void pair_recon(const int* pr, const int* c,
                                           uint32_t* rw) {
#pragma unroll
  for (int k = 0; k < 4; ++k)
    rw[k] = (uint32_t)clip255(pr[2 * k] + ((c[2 * k] + 32) >> 6)) |
            (uint32_t)clip255(pr[2 * k + 1] + ((c[2 * k + 1] + 32) >> 6))
                << 8;
}

// K7's luma chain, MB (r, c) of stream s: lane t; `src` its 8 source
// bytes (already in w.ys).
__device__ void enc_luma_mb(const EncArgs& a, EncTeam& w, const Front* fr,
                            const Inbox* in, const Below& nb, int s, int r,
                            int c, int t, const Quant& q, uint2 src) {
  const int R = a.g.R, C = a.g.C;
  const size_t m = ((size_t)s * R + r) * C + c;
  const bool tav = r > 0, lav = c > 0;
  const uint8_t* top = reinterpret_cast<const uint8_t*>(&fr[c].y);
  const uint4 T4 = fr[c].y;
  const int corner =
      c ? reinterpret_cast<const uint8_t*>(&fr[c - 1].y)[15] : in->corner[0];
  LumaPred lp;
  {
    int tp[16], lf[16];
    unpack16(T4, tp);
    unpack16(*reinterpret_cast<const uint4*>(w.left), lf);
    lp = luma_pred_of(tp, lf, corner, tav, lav);
  }

  // the SADs in the golden order DC, V, H, Plane: lane t, row y, 8 samples
  // from x0; DC | V and H | Plane summed in the halves of a word
  int mode;
  {
    const int y = t >> 1, x0 = 8 * (t & 1);
    const uint32_t dcw = (uint32_t)lp.dc * 0x01010101u;
    const uint32_t hw = (uint32_t)w.left[y] * 0x01010101u;
    const uint32_t v0 = t & 1 ? T4.z : T4.x, v1 = t & 1 ? T4.w : T4.y;
    uint32_t p0 = 0, p1 = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      p0 |= (uint32_t)plane_at<16>(lp.pf, y, x0 + k) << (8 * k);
      p1 |= (uint32_t)plane_at<16>(lp.pf, y, x0 + 4 + k) << (8 * k);
    }
    const unsigned sdv =
        warp_sum((__vsadu4(src.x, dcw) + __vsadu4(src.y, dcw)) |
                 ((__vsadu4(src.x, v0) + __vsadu4(src.y, v1)) << 16));
    const unsigned shp =
        warp_sum((__vsadu4(src.x, hw) + __vsadu4(src.y, hw)) |
                 ((__vsadu4(src.x, p0) + __vsadu4(src.y, p1)) << 16));
    const int sad[4] = {(int)(sdv & 0xffffu), (int)(sdv >> 16),
                        (int)(shp & 0xffffu), (int)(shp >> 16)};
    const bool av[4] = {true, tav, lav, tav && lav};
    mode = (0x3102 >> (4 * first_min(sad, av))) & 15;  // DC 2 V 0 H 1 P 3
  }

  // the transform: block b = (by, bx) on lanes 2b, 2b + 1
  const int b = t >> 1, h = t & 1, by = t >> 3, bx = b & 3;
  int pr[8], cc[8], rr[8];
  {
    const uint32_t tb = *reinterpret_cast<const uint32_t*>(top + 4 * bx);
    const uint32_t lb = *reinterpret_cast<const uint32_t*>(w.left + 4 * by);
    if (mode == 3) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pr[i] = plane_at<16>(lp.pf, 4 * by + (i >> 1), 4 * bx + 2 * h + (i & 1));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pr[i] = mode == 0   ? byte_of(tb, 2 * h + (i & 1))
                : mode == 1 ? byte_of(lb, i >> 1)
                            : lp.dc;
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(
          w.ys + 16 * (4 * by + k) + 4 * bx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        cc[2 * k + j] = byte_of(sw, 2 * h + j) - pr[2 * k + j];
    }
  }
  pair_forward(cc, rr, h);
  if (h == 0) w.dcs[b] = rr[0];
  const bool nz = pair_quant(rr, h, q);
  __syncwarp();
  // the DC Hadamard of the block DCs, quantised: element (by, bx)
  if (h == 0) {
    int f = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      f += h4(by, k >> 2) * h4(bx, k & 3) * w.dcs[k];
    w.zl[b] = q_ldc(q, f);
  }
  __syncwarp();
  const bool cbp_l = __ballot_sync(0xffffffffu, nz) != 0;
  // the reconstruction: the dequantised DC (the inverse Hadamard's
  // element (by, bx)) and AC, the inverse transform, + pred, clipped; the
  // right column into the scratch as the next MB's left (read above)
  int lv[8];  // the levels, for the stores after the hand-off
#pragma unroll
  for (int i = 0; i < 8; ++i) lv[i] = i == 0 && h == 0 ? 0 : rr[i];
  pair_dequant(rr, h, q);
  if (h == 0) {
    int g = 0;
#pragma unroll
    for (int k = 0; k < 16; ++k)
      g += h4(by, k >> 2) * h4(bx, k & 3) * w.zl[k];
    rr[0] = dq_ldc(q, g);
  }
  pair_inverse(rr, cc, h);
  uint32_t rw[4];
  pair_recon(pr, cc, rw);
  if (bx == 3 && h == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) w.left[4 * by + k] = (uint8_t)(rw[k] >> 8);
  }
  // the bottom row (row 3 of blocks 12-15: lanes 24-31) down to row r + 1
  const uint32_t bot = rw[3] | __shfl_xor_sync(0xffffffffu, rw[3], 1) << 16;
  hand_down(nb.front ? &nb.front[c].y : nullptr, nb.inbox, 0, c,
            __shfl_sync(0xffffffffu, bot, 24),
            __shfl_sync(0xffffffffu, bot, 26),
            __shfl_sync(0xffffffffu, bot, 28),
            __shfl_sync(0xffffffffu, bot, 30), top[15], -1, t);
  // the outputs, after the hand-off (its release need not wait for them)
  uint8_t* out = a.ry +
                 ((size_t)s * 16 * R + 16 * r + 4 * by) * (16 * (size_t)C) +
                 16 * (size_t)c + 4 * bx + 2 * h;
#pragma unroll
  for (int k = 0; k < 4; ++k)
    *reinterpret_cast<uint16_t*>(out + (size_t)k * 16 * C) = (uint16_t)rw[k];
  int16_t* o = a.ac + m * 256 + 16 * b;  // zigzag order, slot 0 zero
#pragma unroll
  for (int i = 0; i < 8; ++i) o[h ? izz(8 + i) : izz(i)] = (int16_t)lv[i];
  if (t < 16) {
    a.dc[m * 16 + t] = (int16_t)w.zl[zz(t)];
    if (a.i4) a.i4[m * 16 + t] = -1;
  }
  if (t == 0) {
    a.mode[m] = mode;
    a.cbp_l[m] = cbp_l;
  }
  __syncwarp();  // the scratch is the next MB's
}

// K7's chroma chain, MB (r, c) of stream s: lane t; `src` its 4 source
// bytes of plane t >> 4 (already in w.cs).
__device__ void enc_chroma_mb(const EncArgs& a, EncTeam& w, const Front* fr,
                              const Inbox* in, const Below& nb, int s, int r,
                              int c, int t, const Quant& q, uint32_t src) {
  const int R = a.g.R, C = a.g.C;
  const size_t m = ((size_t)s * R + r) * C + c;
  const bool tav = r > 0, lav = c > 0;
  const int p = t >> 4, y = (t >> 1) & 7, h = t & 1;
  const uint8_t* ctop = reinterpret_cast<const uint8_t*>(&fr[c].c);
  const uint4 T4 = fr[c].c;
  const uint2 tw = p ? make_uint2(T4.z, T4.w) : make_uint2(T4.x, T4.y);
  const uint2 lw = *reinterpret_cast<const uint2*>(w.cleft + 8 * p);
  const int corner =
      c ? reinterpret_cast<const uint8_t*>(&fr[c - 1].c)[8 * p + 7]
        : in->corner[1 + p];
  ChromaPred cp;
  {
    int tp[8], lf[8];
    unpack8(tw, tp);
    unpack8(lw, lf);
    cp = chroma_pred_of(tp, lf, corner, tav, lav);
  }
  // the SADs, Cb + Cr, in the order DC, H, V, Plane: DC | H and V | Plane
  // in the halves of a word
  int cmode;
  {
    const uint32_t dcw = (uint32_t)quadrant_dc(cp, y >> 2, h) * 0x01010101u;
    const uint32_t hw = (uint32_t)w.cleft[8 * p + y] * 0x01010101u;
    const uint32_t vw = h ? tw.y : tw.x;
    uint32_t pw = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      pw |= (uint32_t)plane_at<8>(cp.pf, y, 4 * h + k) << (8 * k);
    const unsigned sdh =
        warp_sum(__vsadu4(src, dcw) | (__vsadu4(src, hw) << 16));
    const unsigned svp =
        warp_sum(__vsadu4(src, vw) | (__vsadu4(src, pw) << 16));
    const int sad[4] = {(int)(sdh & 0xffffu), (int)(sdh >> 16),
                        (int)(svp & 0xffffu), (int)(svp >> 16)};
    const bool av[4] = {true, lav, tav, tav && lav};
    cmode = first_min(sad, av);
  }

  // the transform: block j = (by, bx) of plane p on lanes 16 p + 2 j and
  // + 1 (lanes 8-15 and 24-31 repeat blocks 0-3 and store nothing)
  const bool blk = (t & 15) < 8;
  const int j = (t >> 1) & 3, by = j >> 1, bx = j & 1;
  int pr[8], cc[8], rr[8];
  {
    const uint32_t tb = bx ? tw.y : tw.x, lb = by ? lw.y : lw.x;
    const int dq = quadrant_dc(cp, by, bx);
    if (cmode == 3) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pr[i] = plane_at<8>(cp.pf, 4 * by + (i >> 1), 4 * bx + 2 * h + (i & 1));
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        pr[i] = cmode == 0   ? dq
                : cmode == 1 ? byte_of(lb, i >> 1)
                             : byte_of(tb, 2 * h + (i & 1));
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t sw = *reinterpret_cast<const uint32_t*>(
          w.cs[p] + 8 * (4 * by + k) + 4 * bx);
#pragma unroll
      for (int j = 0; j < 2; ++j)
        cc[2 * k + j] = byte_of(sw, 2 * h + j) - pr[2 * k + j];
    }
  }
  pair_forward(cc, rr, h);
  if (blk && h == 0) w.cdc[p][j] = rr[0];
  const bool nz = pair_quant(rr, h, q);
  __syncwarp();
  // the 2x2 DC Hadamard of plane p, quantised: element (by, bx)
  if (blk && h == 0) {
    const int* d = w.cdc[p];
    const int f = (d[0] + (bx ? -d[1] : d[1])) +
                  (by ? -1 : 1) * (d[2] + (bx ? -d[3] : d[3]));
    w.czl[p][j] = q_cdc(q, f);
  }
  __syncwarp();
  const bool ac_c = __ballot_sync(0xffffffffu, blk && nz) != 0;
  const bool dc_c =
      __ballot_sync(0xffffffffu, blk && h == 0 && w.czl[p][j] != 0) != 0;
  int lv[8];  // the AC levels, for the stores after the hand-off
#pragma unroll
  for (int i = 0; i < 8; ++i) lv[i] = rr[i];
  pair_dequant(rr, h, q);
  if (h == 0) {
    const int* z = w.czl[p];
    const int g = (z[0] + (bx ? -z[1] : z[1])) +
                  (by ? -1 : 1) * (z[2] + (bx ? -z[3] : z[3]));
    rr[0] = dq_cdc(q, g);
  }
  pair_inverse(rr, cc, h);
  uint32_t rw[4];
  pair_recon(pr, cc, rw);
  if (blk && bx == 1 && h == 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      w.cleft[8 * p + 4 * by + k] = (uint8_t)(rw[k] >> 8);
  }
  // the bottom rows (row 3 of blocks 2, 3: Cb lanes 4-7, Cr 20-23) down
  const uint32_t bot = rw[3] | __shfl_xor_sync(0xffffffffu, rw[3], 1) << 16;
  hand_down(nb.front ? &nb.front[c].c : nullptr, nb.inbox, 1, c,
            __shfl_sync(0xffffffffu, bot, 4),
            __shfl_sync(0xffffffffu, bot, 6),
            __shfl_sync(0xffffffffu, bot, 20),
            __shfl_sync(0xffffffffu, bot, 22), ctop[7], ctop[15], t);
  // the outputs, after the hand-off
  if (blk) {
    uint8_t* out = (p ? a.rv : a.ru) +
                   ((size_t)s * 8 * R + 8 * r + 4 * by) * (8 * (size_t)C) +
                   8 * (size_t)c + 4 * bx + 2 * h;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<uint16_t*>(out + (size_t)k * 8 * C) = (uint16_t)rw[k];
    int16_t* o = a.cac + m * 120 + 60 * p + 15 * j - 1;  // zigzag slots 1-15
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i || h) o[h ? izz(8 + i) : izz(i)] = (int16_t)lv[i];
    if (h == 0) a.cdc[m * 8 + 4 * p + j] = (int16_t)w.czl[p][j];
  }
  if (t == 0) {
    a.cmode[m] = cmode;
    a.cbp_c[m] = ac_c ? 2 : dc_c ? 1 : 0;
  }
  __syncwarp();  // the scratch is the next MB's
}

// One of K7's chains (luma or chroma) over the rows of `team`.
template <bool kLuma>
__device__ void enc_chain(const EncArgs& a, const Layout& L, int s,
                          int rank, int team, int t) {
  const Grid& g = a.g;
  const Quant q = quantiser(kLuma ? a.qp : a.qpc);
  EncTeam& w = *L.team<EncTeam>(team);
  const int r0 = rank * g.rpc, r1 = min(g.R, r0 + g.rpc);
  int r = r0 + team;
  SrcPart pf;
  if (r < r1)
    pf = kLuma ? load_luma(a, s, r, 0, t) : load_chroma(a, s, r, 0, t);
  for (; r < r1; r += g.teams) {
    const Front* fr = L.front(r - r0);
    const Inbox* in = L.inbox(r - r0);
    const Below nb = below(L, g, r);
    if (t < 4)  // column 0 has no left neighbour: zeros
      reinterpret_cast<uint32_t*>(kLuma ? w.left : w.cleft)[t] = 0;
    for (int c = 0; c < g.C; ++c) {
      // this MB's source into the scratch, the next one's load issued
      const SrcPart cur = pf;
      const int nc = c + 1 < g.C ? c + 1 : 0;
      const int nr = c + 1 < g.C ? r : r + g.teams;
      if (nr < r1)
        pf = kLuma ? load_luma(a, s, nr, nc, t) : load_chroma(a, s, nr, nc, t);
      if (kLuma) {
        const uint2 src =
            a.src_u8 ? make_uint2((uint32_t)cur.a.x, (uint32_t)cur.a.y)
                     : make_uint2(pack4(cur.a), pack4(cur.b));
        *reinterpret_cast<uint2*>(w.ys + 16 * (t >> 1) + 8 * (t & 1)) = src;
        if (r > 0) wait_for(&in->ready[0], (unsigned)c + 1);
        __syncwarp();
        enc_luma_mb(a, w, fr, in, nb, s, r, c, t, q, src);
      } else {
        const uint32_t src = a.src_u8 ? (uint32_t)cur.a.x : pack4(cur.a);
        *reinterpret_cast<uint32_t*>(w.cs[t >> 4] + 8 * ((t >> 1) & 7) +
                                     4 * (t & 1)) = src;
        if (r > 0) wait_for(&in->ready[1], (unsigned)c + 1);
        __syncwarp();
        enc_chroma_mb(a, w, fr, in, nb, s, r, c, t, q, src);
      }
    }
  }
}

// K7: a cluster of g.K CTAs a stream (s = blockIdx.x / g.K), 2 g.teams
// warps a CTA: even warps luma chains, odd chroma.
__global__ void __launch_bounds__(64 * WF_MAX_TEAMS)
    wavefront_enc_kernel(EncArgs a) {
  const int rank = blockIdx.x % a.g.K, s = blockIdx.x / a.g.K;
  const Layout L{cl_smem(), a.g.rpc, a.g.C};
  start(L, a.g, sizeof(EncTeam));
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  if (warp & 1)
    enc_chain<false>(a, L, s, rank, warp >> 1, t);
  else
    enc_chain<true>(a, L, s, rank, warp >> 1, t);
  cl_sync();  // no CTA leaves while another may still write its inboxes
}

// ---------------------------------------------------------------- K8

// K8's lane t's levels of MB (s, r, c) (see `load_levels`).
__device__ __forceinline__ LevelPart mb_levels(const DecArgs& a, int s,
                                               int r, int c, int t) {
  const size_t m = ((size_t)s * a.g.R + r) * a.g.C + c;
  return load_levels(a.dc + m * 16, a.ac + m * 256, a.cdc + m * 8,
                     a.cac + m * 120, a.cbp_l[m], a.cbp_c[m], t);
}

// The residuals of one MB into a ring slot (K8's residual warp, lane t):
// luma block t on lanes 0-15, chroma block j of plane p on 16 + 4 p + j,
// saturated to int16.
__device__ void residuals(const LevelPart& v, const Quant& ql,
                          const Quant& qc, int t, int16_t* ry,
                          int16_t (*rc)[64]) {
  int x[16];
  if (!block_residual(v, ql, qc, t, x)) return;
  const bool luma = t < 16;
  const int p = (t - 16) >> 2, j = (t - 16) & 3;
  const int by = luma ? t >> 2 : j >> 1, bx = luma ? t & 3 : j & 1;
  const int stride = luma ? 16 : 8;
  int16_t* out = (luma ? ry : rc[p]) + 4 * stride * by + 4 * bx;
#pragma unroll
  for (int yy = 0; yy < 4; ++yy) {
    const int* e = x + 4 * yy;
    *reinterpret_cast<uint2*>(out + yy * stride) =
        make_uint2(pack16(clip16(e[0]), clip16(e[1])),
                   pack16(clip16(e[2]), clip16(e[3])));
  }
}

// K8's residual warp over the rows of `team`: up to kRing MBs ahead of
// the prediction warp.
__device__ void dec_res_chain(const DecArgs& a, const Layout& L, int s,
                              int rank, int team, int t) {
  const Grid& g = a.g;
  const Quant ql = quantiser(a.qp), qc = quantiser(a.qpc);
  DecTeam& w = *L.team<DecTeam>(team);
  const int r0 = rank * g.rpc, r1 = min(g.R, r0 + g.rpc);
  int r = r0 + team, c = 0;
  LevelPart pf;
  if (r < r1) pf = mb_levels(a, s, r, 0, t);
  for (unsigned seq = 0; r < r1; ++seq) {
    const LevelPart cur = pf;
    if (++c == g.C) c = 0, r += g.teams;
    if (r < r1) pf = mb_levels(a, s, r, c, t);
    const int slot = seq % kRing;
    if (seq >= kRing) wait_local(&w.consumed, seq - kRing + 1);
    residuals(cur, ql, qc, t, w.ry[slot], w.rc[slot]);
    __syncwarp();
    if (t == 0) cta_release(&w.produced, seq + 1);
  }
}

// Luma prediction of 8 samples of row y from x0 (mode-uniform branches).
__device__ __forceinline__ void luma_row8(int mode, const LumaPred& lp,
                                          uint32_t v0, uint32_t v1, int hl,
                                          int y, int x0, int* pr) {
  if (mode == 0) {
#pragma unroll
    for (int k = 0; k < 8; ++k) pr[k] = byte_of(k < 4 ? v0 : v1, k & 3);
  } else if (mode == 1) {
#pragma unroll
    for (int k = 0; k < 8; ++k) pr[k] = hl;
  } else if (mode == 2) {
#pragma unroll
    for (int k = 0; k < 8; ++k) pr[k] = lp.dc;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) pr[k] = plane_at<16>(lp.pf, y, x0 + k);
  }
}

// K8's prediction warp on MB (r, c) (lane t), its residuals in ring slot
// seq % kRing.
__device__ void dec_mb(const DecArgs& a, DecTeam& w, const Front* fr,
                       const Inbox* in, const Below& nb, int s, int r, int c,
                       int t, int mode, int cmode, unsigned seq) {
  const int R = a.g.R, C = a.g.C, slot = seq % kRing;
  const bool tav = r > 0, lav = c > 0;
  // luma: lane t, row y = t >> 1, 8 samples from x0 = 8 (t & 1)
  const int y = t >> 1, x0 = 8 * (t & 1);
  uint32_t lo = 0, hi = 0;
  {
    const uint4 T4 = fr[c].y;
    const int corner = c ? reinterpret_cast<const uint8_t*>(&fr[c - 1].y)[15]
                         : in->corner[0];
    LumaPred lp;
    {
      int tp[16], lf[16];
      unpack16(T4, tp);
      unpack16(*reinterpret_cast<const uint4*>(w.left), lf);
      lp = luma_pred_of(tp, lf, corner, tav, lav);
    }
    int pr[8];
    luma_row8(mode, lp, t & 1 ? T4.z : T4.x, t & 1 ? T4.w : T4.y, w.left[y],
              y, x0, pr);
    const uint4 rr =
        *reinterpret_cast<const uint4*>(w.ry[slot] + 16 * y + x0);
    const uint32_t rw[4] = {rr.x, rr.y, rr.z, rr.w};
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int res =
          (int)(int16_t)(k & 1 ? rw[k >> 1] >> 16 : rw[k >> 1] & 0xffffu);
      const uint32_t v = (uint32_t)clip255(pr[k] + res);
      if (k < 4)
        lo |= v << (8 * k);
      else
        hi |= v << (8 * (k - 4));
    }
  }
  // chroma: lane t, plane p = t >> 4, row yc = (t >> 1) & 7, 4 samples
  // from 4 h
  const int p = t >> 4, yc = (t >> 1) & 7, h = t & 1;
  uint32_t cv = 0;
  {
    const uint4 T4 = fr[c].c;
    const uint2 tw = p ? make_uint2(T4.z, T4.w) : make_uint2(T4.x, T4.y);
    const uint2 lw = *reinterpret_cast<const uint2*>(w.left + 16 + 8 * p);
    const int corner =
        c ? reinterpret_cast<const uint8_t*>(&fr[c - 1].c)[8 * p + 7]
          : in->corner[1 + p];
    ChromaPred cp;
    {
      int tp[8], lf[8];
      unpack8(tw, tp);
      unpack8(lw, lf);
      cp = chroma_pred_of(tp, lf, corner, tav, lav);
    }
    const int dq = quadrant_dc(cp, yc >> 2, h);
    const int hc = w.left[16 + 8 * p + yc];
    const uint32_t vw = h ? tw.y : tw.x;
    const uint2 rr =
        *reinterpret_cast<const uint2*>(w.rc[slot][p] + 8 * yc + 4 * h);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int pred = cmode == 0   ? dq
                       : cmode == 1 ? hc
                       : cmode == 2 ? byte_of(vw, k)
                                    : plane_at<8>(cp.pf, yc, 4 * h + k);
      const uint32_t rw = k < 2 ? rr.x : rr.y;
      const int res = (int)(int16_t)(k & 1 ? rw >> 16 : rw & 0xffffu);
      cv |= (uint32_t)clip255(pred + res) << (8 * k);
    }
  }
  __syncwarp();  // the slot and the left columns are read
  if (t == 0) cta_release(&w.consumed, seq + 1);
  if (h) {  // the right columns: the next MB's left
    w.left[y] = (uint8_t)(hi >> 24);
    w.left[16 + 8 * p + yc] = (uint8_t)(cv >> 24);
  }
  // the bottom rows down to row r + 1: luma row 15 on lanes 30, 31, Cb
  // row 7 on lanes 14, 15, Cr on 30, 31
  const uint32_t y0 = __shfl_sync(0xffffffffu, lo, 30);
  const uint32_t y1 = __shfl_sync(0xffffffffu, hi, 30);
  const uint32_t y2 = __shfl_sync(0xffffffffu, lo, 31);
  const uint32_t y3 = __shfl_sync(0xffffffffu, hi, 31);
  const uint32_t c0 = __shfl_sync(0xffffffffu, cv, 14);
  const uint32_t c1 = __shfl_sync(0xffffffffu, cv, 15);
  const uint32_t c2 = __shfl_sync(0xffffffffu, cv, 30);
  const uint32_t c3 = __shfl_sync(0xffffffffu, cv, 31);
  if (t == 0 && nb.front) {
    nb.front[c].y = make_uint4(y0, y1, y2, y3);
    nb.front[c].c = make_uint4(c0, c1, c2, c3);
    if (c == 0) {  // the top this row received at column 0: its last samples
      const uint8_t* ty = reinterpret_cast<const uint8_t*>(&fr[0].y);
      const uint8_t* tc = reinterpret_cast<const uint8_t*>(&fr[0].c);
      nb.inbox->corner[0] = ty[15];
      nb.inbox->corner[1] = tc[7];
      nb.inbox->corner[2] = tc[15];
    }
    cl_release(&nb.inbox->ready[0], (unsigned)c + 1);
  }
  // the recon, after the hand-off (its release need not wait for it)
  *reinterpret_cast<uint2*>(a.ry +
                            ((size_t)s * 16 * R + 16 * r + y) *
                                (16 * (size_t)C) +
                            16 * (size_t)c + x0) = make_uint2(lo, hi);
  *reinterpret_cast<uint32_t*>((p ? a.rv : a.ru) +
                               ((size_t)s * 8 * R + 8 * r + yc) *
                                   (8 * (size_t)C) +
                               8 * (size_t)c + 4 * h) = cv;
  __syncwarp();  // the scratch is the next MB's
}

// K8's prediction warp over the rows of `team`.
__device__ void dec_pred_chain(const DecArgs& a, const Layout& L, int s,
                               int rank, int team, int t) {
  const Grid& g = a.g;
  DecTeam& w = *L.team<DecTeam>(team);
  const int r0 = rank * g.rpc, r1 = min(g.R, r0 + g.rpc);
  auto modes = [&](int r, int c) {
    const size_t m = ((size_t)s * g.R + r) * g.C + c;
    return make_int2(a.mode[m], a.cmode[m]);
  };
  int r = r0 + team;
  int2 pm = make_int2(0, 0);
  if (r < r1) pm = modes(r, 0);
  unsigned seq = 0;
  for (; r < r1; r += g.teams) {
    const Front* fr = L.front(r - r0);
    const Inbox* in = L.inbox(r - r0);
    const Below nb = below(L, g, r);
    if (t < 8) reinterpret_cast<uint32_t*>(w.left)[t] = 0;  // column 0
    for (int c = 0; c < g.C; ++c, ++seq) {
      const int2 cur = pm;
      const int nc = c + 1 < g.C ? c + 1 : 0;
      const int nr = c + 1 < g.C ? r : r + g.teams;
      if (nr < r1) pm = modes(nr, nc);
      wait_local(&w.produced, seq + 1);
      if (r > 0) wait_for(&in->ready[0], (unsigned)c + 1);
      __syncwarp();
      dec_mb(a, w, fr, in, nb, s, r, c, t, cur.x, cur.y, seq);
    }
  }
}

// K8: a cluster of g.K CTAs a stream, 2 g.teams warps a CTA: even warps
// predict, odd decode residuals.
__global__ void __launch_bounds__(64 * WF_MAX_TEAMS)
    wavefront_dec_kernel(DecArgs a) {
  const int rank = blockIdx.x % a.g.K, s = blockIdx.x / a.g.K;
  const Layout L{cl_smem(), a.g.rpc, a.g.C};
  start(L, a.g, sizeof(DecTeam));
  const int warp = threadIdx.x >> 5, t = threadIdx.x & 31;
  if (warp & 1)
    dec_res_chain(a, L, s, rank, warp >> 1, t);
  else
    dec_pred_chain(a, L, s, rank, warp >> 1, t);
  cl_sync();  // no CTA leaves while another may still write its inboxes
}

}  // namespace

#ifdef __CUDACC__  // the entries; tests/test_torch_wavefront_kernel.py
                   // runs the rest above on CPU threads, compiled by g++
                   // against shims

#include <mutex>

namespace {

// The launch configuration of S clusters of g.K CTAs.
struct Config {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute at[1];
  Config(const Grid& g, int S, size_t smem, cudaStream_t stream) : cfg{} {
    cfg.gridDim = dim3(S * g.K);
    cfg.blockDim = dim3(64 * g.teams);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    at[0].id = cudaLaunchAttributeClusterDimension;
    at[0].val.clusterDim.x = g.K;
    at[0].val.clusterDim.y = 1;
    at[0].val.clusterDim.z = 1;
    cfg.attrs = at;
    cfg.numAttrs = 1;
  }
};

// The launch shape of `kern` for R x C frames: clusters of up to
// WF_MAX_CLUSTER CTAs (non-portable above 8) where
// cudaOccupancyMaxActiveClusters confirms that one fits, else up to 8;
// remembered per frame shape.  A cluster that cannot be resident returns
// its CUDA error.
template <typename Args>
cudaError_t choose(void (*kern)(Args), int R, int C, size_t team_bytes,
                   Grid* out) {
  struct Seen {
    int R, C;
    Grid g;
  };
  static std::mutex mu;
  static Seen seen[16];
  static int n_seen = 0, smem_set = 0;
  std::lock_guard<std::mutex> lock(mu);
  for (int i = 0; i < n_seen && i < 16; ++i)
    if (seen[i].R == R && seen[i].C == C) return *out = seen[i].g, cudaSuccess;
  cudaError_t e = cudaErrorLaunchOutOfResources;
  for (const int kmax : {WF_MAX_CLUSTER, 8}) {
    const Grid g = plan(R, C, kmax);
    const size_t smem = smem_bytes(g, team_bytes);
    if ((int)smem > smem_set) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
      smem_set = (int)smem;
    }
    if (g.K > 8) {
      e = cudaFuncSetAttribute(
          kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (e != cudaSuccess) {
        cudaGetLastError();  // not this size: try the portable one
        continue;
      }
    }
    const Config c(g, 1, smem, nullptr);
    int fit = 0;
    e = cudaOccupancyMaxActiveClusters(&fit, kern, &c.cfg);
    if (e == cudaSuccess && fit >= 1) {
      seen[n_seen++ % 16] = Seen{R, C, g};
      return *out = g, cudaSuccess;
    }
    cudaGetLastError();
    if (e == cudaSuccess) e = cudaErrorLaunchOutOfResources;
  }
  return e;
}

// One launch of `kern` as S clusters of a.g.K CTAs.
template <typename Args>
int launch(void (*kern)(Args), const Args& a, int S, size_t team_bytes,
           cudaStream_t stream) {
  const Config c(a.g, S, smem_bytes(a.g, team_bytes), stream);
  const cudaError_t e = cudaLaunchKernelEx(&c.cfg, kern, a);
  return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
}

}  // namespace

// The launch shapes of an R x C frame, K7's then K8's: cluster size, MB
// rows a CTA, teams a CTA and shared memory a CTA in bytes (out[0..7]);
// returns the CUDA error where no cluster fits.
extern "C" int th264_wavefront_plan(int R, int C, int* out) {
  Grid g[2];
  cudaError_t e = choose(wavefront_enc_kernel, R, C, sizeof(EncTeam), &g[0]);
  if (e == cudaSuccess)
    e = choose(wavefront_dec_kernel, R, C, sizeof(DecTeam), &g[1]);
  if (e != cudaSuccess) return (int)e;
  const size_t team[2] = {sizeof(EncTeam), sizeof(DecTeam)};
  for (int k = 0; k < 2; ++k) {
    out[4 * k] = g[k].K, out[4 * k + 1] = g[k].rpc;
    out[4 * k + 2] = g[k].teams;
    out[4 * k + 3] = (int)smem_bytes(g[k], team[k]);
  }
  return 0;
}

// K7: S streams of R x C MBs, source planes uint8 (src_u8 1) or int32,
// raster; the MBSymbols fields (i4modes all -1) and the uint8 recon
// planes out.
extern "C" int th264_wavefront_encode(
    const void* sy, const void* su, const void* sv, int src_u8,
    int32_t* mode, int32_t* cmode, int32_t* cbp_l, int32_t* cbp_c,
    int16_t* dc, int16_t* ac, int16_t* cdc, int16_t* cac, int16_t* i4,
    uint8_t* ry, uint8_t* ru, uint8_t* rv, int S, int R, int C, int qp,
    int qpc, void* stream) {
  Grid g;
  const cudaError_t e =
      choose(wavefront_enc_kernel, R, C, sizeof(EncTeam), &g);
  if (e != cudaSuccess) return (int)e;
  const EncArgs a{sy, su, sv, src_u8, mode, cmode, cbp_l, cbp_c, dc, ac,
                  cdc, cac, i4, ry, ru, rv, g, qp, qpc};
  return launch(wavefront_enc_kernel, a, S, sizeof(EncTeam),
                (cudaStream_t)stream);
}

// K8: S streams of R x C MBs: int32 mode, cmode, cbp_luma, cbp_chroma
// [S,R,C] and the int16 levels as MBSymbols holds them (luma_dc [.,16],
// luma_ac [.,16,16], chroma_dc [.,2,4], chroma_ac [.,2,4,15]) in; the
// uint8 recon planes out.
extern "C" int th264_wavefront_decode(
    const int32_t* mode, const int32_t* cmode, const int32_t* cbp_l,
    const int32_t* cbp_c, const int16_t* dc, const int16_t* ac,
    const int16_t* cdc, const int16_t* cac, uint8_t* ry, uint8_t* ru,
    uint8_t* rv, int S, int R, int C, int qp, int qpc, void* stream) {
  Grid g;
  const cudaError_t e =
      choose(wavefront_dec_kernel, R, C, sizeof(DecTeam), &g);
  if (e != cudaSuccess) return (int)e;
  const DecArgs a{mode, cmode, cbp_l, cbp_c, dc, ac, cdc, cac,
                  ry, ru, rv, g, qp, qpc};
  return launch(wavefront_dec_kernel, a, S, sizeof(DecTeam),
                (cudaStream_t)stream);
}

#endif  // __CUDACC__
