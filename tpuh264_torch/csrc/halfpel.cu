// K11: the P frame's reference build -- the four half-pel planes (G, b,
// h, j) of every luma reference and its two chroma planes, padded -- one
// launch over all N references.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py
// `build_halfpel_planes` (:111) with `_pad_ref` (:133), and
// `build_halfpel_planes_ext` (:146) with `_pad_ref_ext` (:174) for a
// row-sharded DPB (called :660-675 in the encode, :1037-1050 in the
// decode), not a pallas_call.  Its plain PyTorch version is
// kernels/pframe.py `_references_plain`.
//
// What it computes, exactly as the plain version.  With R(y, x) the
// reference sample at output position (y, x), rows and columns clamped
// into the source (the normative Clip3 of 8.4.2.2):
//     R(y, x) = src[clamp(y - oy, 0, Hs - 1)][clamp(x - 13, 0, W - 1)]
// where the frame itself is the source (oy = 13 = HALO_Y, Hs = H) or,
// with `halo`, the reference already extended by HALO_Y rows a side
// (oy = 0, Hs = H + 26: the rows a row-sharded DPB exchanges; its outer 3
// output rows replicate its edge rows, as the plain version's 6-tap
// margin does), each plane [Hs + 2 oy, W + 26]:
//     G = R(y, x),
//     b = clip((B1(y, x) + 16) >> 5),  B1(y, x) = tap6 of R(y, x-2 .. x+3)
//     h = clip((tap6 of R(y-2 .. y+3, x) + 16) >> 5)
//     j = clip((tap6 of B1(y-2 .. y+3, x) + 512) >> 10)
// with tap6 = (1, -5, 20, 20, -5, 1) and clip to 0..255.  Chroma:
// src[clamp(y - oyc, 0, Hcs - 1)][clamp(x - 8, 0, Wc - 1)], oyc = 8 =
// HALO_C without `halo`, 0 with it.  The references are uint8 or int32
// holding 0..255 (pictures; an int32 reference is read by its low bytes),
// each reference's three planes by their own pointers, newest first (the
// GOP pipeline passes the slots of its uint8 DPB rings as they lie), each
// plane 16-byte aligned.
//
// The outputs are uint8, one [N, 4, S, Hp, lp] and one [N, 2, S, Hcp, cp]
// buffer: every plane row starts 16-byte aligned, lp = Wp = W + 26
// rounded up to 16 bytes (Wp is 10 mod 16: lp = Wp + 6), cp = Wcp = W/2
// + 16 rounded up (Wcp + 8 for an odd MB column count).  The bytes past
// Wp / Wcp are no samples; what is written there is never read.  The
// views of the first Wp / Wcp bytes are `_references`' planes, the
// layout K1, K9 and K10 read (pframe.py `_plane_buffers`).
//
// What bounds it on the H100: bytes.  At 1080p x 4 with one reference it
// reads 12.5 MB of uint8 references and writes 34.7 MB of luma planes
// and 4.4 MB of chroma: 51.6 MB, 0.0154 ms at 3.35 TB/s.  Its arithmetic,
// three 6-tap filters and three roundings a luma sample, is near that
// line once the stores are bytes: a design that spends ~18 shared loads
// and ~40 int32 operations a sample (three tap6 passes over staged
// rows) needs about 0.04 ms of issue on 132 SMs, more than twice this
// bound.  So the design cuts instructions
// a sample as well as bytes.
//
// Design: a warp a strip of 128 output columns x kTH rows of one
// (reference, stream) plane, walking down it row by row; then the chroma
// threads, in the same grid.
//  * Lane l owns output columns 4l .. 4l + 3 of the strip.  A row step
//    brings in one source row: lanes 0-8 each copy 16 source bytes,
//    kAhead rows ahead, into the warp's ring of staged rows in shared
//    memory by cp.async (no registers held while they fly); every lane
//    then reads the three words that hold its 9 samples (x - 2 .. x + 6).
//    A chunk past the frame's edge is a copy of the edge chunk, and the
//    lanes replace the words outside the frame by the edge sample as
//    they read them (the clamp).  int32 references are read and packed
//    to bytes at their step instead.
//  * The vertical taps come from registers: a lane keeps the last 6 rows
//    of R and of B1 at its 4 columns (48 floats), so h and j cost no
//    shared load; the step loop is unrolled 6 times, so the history
//    shifts by register renaming.
//  * The datapath is fp32, twice the INT32 issue rate, and exact here:
//    every value is an integer or half-integer far below 2^24 (|B1| <=
//    10,710, |tap6 of B1| <= 557,000).  A sample enters as R + 1/2 (one
//    byte permute and one add from its byte): the taps sum to 32, so B1,
//    h's sum and j's sum then carry their rounding offsets 16, 16 and 512
//    for free.  Each rounding is one FMA rounding down onto 1.5 * 2^23,
//    whose low bits are then floor(x / 32) (or / 1024); two outputs are
//    clamped to 0..255 at once as 16-bit halves (`__vimin_s16x2_relu`)
//    and a byte permute packs four.  About 30 instructions a luma
//    sample, four planes.
//  * Stores: the lane's four words (G, b, h, j) go to the warp's staging
//    in shared memory, and each lane stores 16 consecutive bytes of one
//    plane row with one 16-byte store: lanes 8p .. 8p + 7 plane p's 128
//    bytes of the row.  Chroma, a thread 16 output bytes from two 8-byte
//    loads, also 16 bytes a store.
//  * Occupancy: kTH = 31 makes the walk 36 steps (5 of them filling the
//    history, 16% more arithmetic than the outputs need) and gives 1080p
//    x 4 with one reference 4 x 36 x 16 = 2,304 warps, which must fit one
//    wave on 132 SMs: kBlocksPerSM blocks an SM (the register cap that
//    follows from it) hold them all at once.  At 110 registers, 16 warps
//    an SM, they took 1.09 waves and twice the time
//    (tools/time_refs.py).
// Where trouble is likely: an input plane off 16-byte alignment (the
// wrapper raises); the pitch bytes (a strip's last chunks are stored only
// below the pitch, never into the next row); a strip wholly past the
// frame's last sample (W = 7 MBs: its edge word is the staged copy's);
// an edge word's index outside the staged row (it is kept inside: a read
// off the ring faulted on the card); the halo geometry, one clamp formula
// with the framed one (oy = 0).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPE = 13;                 // luma plane pad (pframe._PE)
constexpr int kCP = 8;                  // chroma pad (pframe._CP)
constexpr int kStrip = 128;             // output columns a warp, 4 a lane
constexpr int kTH = 31;                 // output rows a warp
constexpr int kSteps = kTH + 5;         // source rows a warp walks
constexpr int kChunks = kStrip / 16 + 1;  // 16-byte source chunks a row
constexpr int kAhead = 6;               // source rows in flight a warp
constexpr int kRing = kAhead + 2;       // staged rows a warp
constexpr int kWarps = 4;               // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr int kBlocksPerSM = 5;         // 20 warps an SM: 1080p x 4 in a wave
constexpr int kMaxRefs = 16;            // H.264's most references
static_assert(kSteps % 6 == 0, "the history shifts by renaming over 6 steps");

struct RefArgs {
  // reference n's planes [S, Hs, W], [S, Hcs, Wc] x 2, newest first (the
  // DPB's slots by pointer; unused entries null)
  const void *y[kMaxRefs], *u[kMaxRefs], *v[kMaxRefs];
  uint8_t* planes;  // [N, 4, S, Hp, lp]
  uint8_t* chroma;  // [N, 2, S, Hcp, cp]
  int N, S, Hs, W, oy, Hcs, Wc, oyc, u8, lp, cp;
  int Hp, Wp, Hcp, Wcp, strips, tiles, luma_warps, luma_blocks, cchunks;
  int blocks;
};

constexpr int kPtrs = 3 * kMaxRefs + 2;
constexpr int kInts = 11;

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k11_operands` builds them.
inline RefArgs ref_args(void* const* p, const int* n) {
  RefArgs a;
  for (int k = 0; k < kMaxRefs; ++k) {
    a.y[k] = p[k];
    a.u[k] = p[kMaxRefs + k];
    a.v[k] = p[2 * kMaxRefs + k];
  }
  a.planes = static_cast<uint8_t*>(p[3 * kMaxRefs]);
  a.chroma = static_cast<uint8_t*>(p[3 * kMaxRefs + 1]);
  a.N = n[0], a.S = n[1], a.Hs = n[2], a.W = n[3], a.oy = n[4];
  a.Hcs = n[5], a.Wc = n[6], a.oyc = n[7], a.u8 = n[8], a.lp = n[9];
  a.cp = n[10];
  a.Hp = a.Hs + 2 * a.oy, a.Wp = a.W + 2 * kPE;
  a.Hcp = a.Hcs + 2 * a.oyc, a.Wcp = a.Wc + 2 * kCP;
  a.strips = (a.Wp + kStrip - 1) / kStrip;
  a.tiles = (a.Hp + kTH - 1) / kTH;
  a.luma_warps = a.N * a.S * a.strips * a.tiles;
  a.luma_blocks = (a.luma_warps + kWarps - 1) / kWarps;
  a.cchunks = 2 * a.N * a.S * a.Hcp * (a.cp / 16);
  a.blocks = a.luma_blocks + (a.cchunks + kThreads - 1) / kThreads;
  return a;
}

// the low bytes of four int32 samples, the first lowest
__device__ __forceinline__ uint32_t low_bytes(int4 q) {
  return __byte_perm(__byte_perm(q.x, q.y, 0x0040),
                     __byte_perm(q.z, q.w, 0x0040), 0x5410);
}

// 16 samples of the source row `row` from column c (a multiple of 16;
// columns outside 0 .. W - 1 are the clamp: the edge sample replicated)
// as bytes, the first lowest.
__device__ __forceinline__ uint4 src16(const void* row, int u8, int c,
                                       int W) {
  const int cc = min(max(c, 0), W - 16);
  uint4 v;
  if (u8) {
    v = *reinterpret_cast<const uint4*>(static_cast<const uint8_t*>(row) +
                                        cc);
  } else {
    const int4* q = reinterpret_cast<const int4*>(
        static_cast<const int32_t*>(row) + cc);
    v = make_uint4(low_bytes(q[0]), low_bytes(q[1]), low_bytes(q[2]),
                   low_bytes(q[3]));
  }
  if (c != cc) {
    const uint32_t e = (c < 0 ? v.x & 255u : v.w >> 24) * 0x01010101u;
    v = make_uint4(e, e, e, e);
  }
  return v;
}

// 8 samples of row `row` from column c (a multiple of 8; outside 0 ..
// W - 1 the edge sample replicated) as bytes
__device__ __forceinline__ uint2 src8(const void* row, int u8, int c,
                                      int W) {
  const int cc = min(max(c, 0), W - 8);
  uint2 v;
  if (u8) {
    v = *reinterpret_cast<const uint2*>(static_cast<const uint8_t*>(row) +
                                        cc);
  } else {
    const int4* q = reinterpret_cast<const int4*>(
        static_cast<const int32_t*>(row) + cc);
    v = make_uint2(low_bytes(q[0]), low_bytes(q[1]));
  }
  if (c != cc) {
    const uint32_t e = (c < 0 ? v.x & 255u : v.y >> 24) * 0x01010101u;
    v = make_uint2(e, e);
  }
  return v;
}

// 16 bytes global -> shared without registers (cp.async; on the CPU a
// copy), committed as one group a call of `commit_rows`
__device__ __forceinline__ void copy16_async(void* dst, const void* src) {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src));
#else
  *static_cast<uint4*>(dst) = *static_cast<const uint4*>(src);
#endif
}
__device__ __forceinline__ void commit_rows() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.commit_group;");
#endif
}
// the thread's copies but the last kAhead groups landed
__device__ __forceinline__ void wait_rows() {
#ifdef __CUDA_ARCH__
  asm volatile("cp.async.wait_group %0;" ::"n"(kAhead));
#endif
}

// byte i of w plus 1/2, exactly: 2^23 + byte by a byte permute into a
// float's bits, less 2^23 - 1/2
__device__ __forceinline__ float half_up(uint32_t w, int i) {
  return __int_as_float((int)__byte_perm(w, 0x4B000000u, 0x7440 + i)) -
         8388607.5f;
}

__device__ __forceinline__ float tap6(float a, float b, float c, float d,
                                      float e, float f) {
  return fmaf(-5.f, b + e, fmaf(20.f, c + d, a + f));
}

// floor(x * scale) (x / 32 or x / 1024, exact) in the low bits of 1.5 *
// 2^23 + it: one FMA rounding down, as a float's bits
__device__ __forceinline__ uint32_t floor_bits(float x, float scale) {
  return __float_as_uint(__fmaf_rd(x, scale, 12582912.f));
}

// four floor_bits results clipped to 0..255 and packed as bytes, the
// first lowest: two at a time as 16-bit halves
__device__ __forceinline__ uint32_t clip_pack(uint32_t a, uint32_t b,
                                              uint32_t c, uint32_t d) {
  const uint32_t lo = __vimin_s16x2_relu(__byte_perm(a, b, 0x5410),
                                         0x00ff00ffu);
  const uint32_t hi = __vimin_s16x2_relu(__byte_perm(c, d, 0x5410),
                                         0x00ff00ffu);
  return __byte_perm(lo, hi, 0x6420);
}

// Luma warp `wid`: a strip of kStrip output columns x kTH rows of one
// (reference, stream) plane.  ring: the warp's kRing staged source rows
// (word k: bytes of output columns 4k - 19 ..), ost: its two output
// stagings (plane, word).
__device__ void luma_strip(const RefArgs& a, int wid, uint32_t (*ring)[40],
                           uint32_t (*ost)[4][32]) {
  const int lane = threadIdx.x & 31;
  const int per = a.strips * a.tiles;
  const int pl = wid / per, rem = wid - pl * per;
  const int tile = rem / a.strips, strip = rem - tile * a.strips;
  const int n = pl / a.S, s = pl - n * a.S;
  const int x0 = strip * kStrip, y0 = tile * kTH;
  const size_t elt = a.u8 ? 1 : 4;
  const char* src =
      static_cast<const char*>(a.y[n]) + (size_t)s * a.Hs * a.W * elt;
  // lane c < kChunks stages source columns x0 - 16 + 16 c, the staged
  // row's words 4 + 4c .. (output columns x0 - 3 + 16 c ..)
  const int col = x0 - 16 + 16 * lane;
  const bool loader = lane < kChunks;
  auto row_of = [&](int k) {  // the source row of output row y0 - 2 + k
    const int sy = min(max(y0 - 2 + k - a.oy, 0), a.Hs - 1);
    return src + (size_t)sy * a.W * elt;
  };
  // uint8 rows go kAhead rows ahead by cp.async, the clamped chunk where
  // the strip passes the frame's edge (its words replaced when read);
  // int32 rows are read and packed at their step
  auto issue = [&](int k) {
    if (loader && a.u8 && k < kSteps)
      copy16_async(&ring[k % kRing][4 + 4 * lane],
                   row_of(k) + min(max(col, 0), a.W - 16));
    commit_rows();
  };
  for (int k = 0; k < kAhead; ++k) issue(k);
  // the staged words outside the frame: below word e0 the left edge
  // sample replicates, from word e1 on the right one
  const int e0 = (32 - x0) / 4, e1 = (a.W + 32 - x0) / 4;
  const bool edges = x0 < 32 || x0 + kStrip + 32 > a.W + 32;
  float r[6][4], b1[6][4];  // R + 1/2 and B1 + 16 of the last 6 rows
  uint32_t g[4];            // G words of the last 4 rows
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int m = 0; m < 4; ++m) r[i][m] = b1[i][m] = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) g[i] = 0u;
  uint8_t* const out = a.planes +
                       ((size_t)n * 4 * a.S + s) * a.Hp * a.lp + x0 +
                       16 * (lane & 7) +
                       (size_t)(lane >> 3) * a.S * a.Hp * a.lp;
  const bool in_pitch = x0 + 16 * (lane & 7) < a.lp;

#pragma unroll 6
  for (int k = 0; k < kSteps; ++k) {
    const int p = k & 1;
    uint32_t* row = ring[k % kRing];
    issue(k + kAhead);
    if (loader && !a.u8)
      *reinterpret_cast<uint4*>(&row[4 + 4 * lane]) =
          src16(row_of(k), 0, col, a.W);
    wait_rows();
    __syncwarp();
    // output columns 4l - 2 .. 4l + 6: bytes 1-3 of word l + 4, 0-3 of
    // l + 5, 0-1 of l + 6
    uint32_t w0 = row[lane + 4], w1 = row[lane + 5], w2 = row[lane + 6];
    if (edges && a.u8) {  // a strip at the frame's edge: the clamp
      // the edge words, where a staged word is replaced (a strip wholly
      // past the frame stages only clamped copies of the last chunk: its
      // word 7 ends with the edge sample); indices kept in the row
      const uint32_t lo = (row[min(max(e0, 4), 39)] & 255u) * 0x01010101u;
      const uint32_t hi =
          (row[e1 > 4 ? min(e1 - 1, 39) : 7] >> 24) * 0x01010101u;
      const int k0 = lane + 4;
      w0 = k0 < e0 ? lo : k0 >= e1 ? hi : w0;
      w1 = k0 + 1 < e0 ? lo : k0 + 1 >= e1 ? hi : w1;
      w2 = k0 + 2 < e0 ? lo : k0 + 2 >= e1 ? hi : w2;
    }
    float q[9];
    q[0] = half_up(w0, 1), q[1] = half_up(w0, 2), q[2] = half_up(w0, 3);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[3 + i] = half_up(w1, i);
    q[7] = half_up(w2, 0), q[8] = half_up(w2, 1);
#pragma unroll
    for (int i = 0; i < 5; ++i)
#pragma unroll
      for (int m = 0; m < 4; ++m)
        r[i][m] = r[i + 1][m], b1[i][m] = b1[i + 1][m];
#pragma unroll
    for (int i = 0; i < 3; ++i) g[i] = g[i + 1];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      r[5][m] = q[m + 2];
      b1[5][m] = tap6(q[m], q[m + 1], q[m + 2], q[m + 3], q[m + 4], q[m + 5]);
    }
    g[3] = __byte_perm(w0, w1, 0x6543);
    if (k < 5) continue;  // the history fills: no output row yet
    // output row y = y0 + k - 5: R rows y - 2 .. y + 3 are r[0 .. 5]
    uint32_t fb[4], fh[4], fj[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      fb[m] = floor_bits(b1[2][m], 1.f / 32);
      fh[m] = floor_bits(tap6(r[0][m], r[1][m], r[2][m], r[3][m], r[4][m],
                              r[5][m]), 1.f / 32);
      fj[m] = floor_bits(tap6(b1[0][m], b1[1][m], b1[2][m], b1[3][m],
                              b1[4][m], b1[5][m]), 1.f / 1024);
    }
    ost[p][0][lane] = g[0];
    ost[p][1][lane] = clip_pack(fb[0], fb[1], fb[2], fb[3]);
    ost[p][2][lane] = clip_pack(fh[0], fh[1], fh[2], fh[3]);
    ost[p][3][lane] = clip_pack(fj[0], fj[1], fj[2], fj[3]);
    __syncwarp();
    const int y = y0 + k - 5;
    if (in_pitch && y < a.Hp)
      *reinterpret_cast<uint4*>(out + (size_t)y * a.lp) =
          *reinterpret_cast<const uint4*>(&ost[p][lane >> 3][4 * (lane & 7)]);
  }
}

// Chroma chunk e: 16 output bytes of the [N, 2, S, Hcp, cp] buffer, row
// by row, 16-byte chunks in order.
__device__ void chroma_chunk(const RefArgs& a, int e) {
  const int per_row = a.cp / 16;
  const int row = e / per_row, x = 16 * (e - row * per_row);
  const int pl = row / a.Hcp, y = row - pl * a.Hcp;  // pl = (2n + c) S + s
  const int s = pl % a.S, nc = pl / a.S;
  const size_t elt = a.u8 ? 1 : 4;
  const int sy = min(max(y - a.oyc, 0), a.Hcs - 1);
  const char* src = static_cast<const char*>((nc & 1 ? a.v : a.u)[nc >> 1]) +
                    ((size_t)s * a.Hcs + sy) * a.Wc * elt;
  const uint2 lo = src8(src, a.u8, x - kCP, a.Wc);
  const uint2 hi = src8(src, a.u8, x - kCP + 8, a.Wc);
  *reinterpret_cast<uint4*>(a.chroma + (size_t)row * a.cp + x) =
      make_uint4(lo.x, lo.y, hi.x, hi.y);
}

__global__ void __launch_bounds__(kThreads, kBlocksPerSM)
    halfpel_kernel(const __grid_constant__ RefArgs a) {
  __shared__ __align__(16) uint32_t sw[kWarps][kRing][40];
  __shared__ __align__(16) uint32_t ost[kWarps][2][4][32];
  const int warp = threadIdx.x >> 5;
  if ((int)blockIdx.x < a.luma_blocks) {
    const int wid = blockIdx.x * kWarps + warp;
    if (wid < a.luma_warps) luma_strip(a, wid, sw[warp], ost[warp]);
    return;
  }
  const int e = (blockIdx.x - a.luma_blocks) * kThreads + threadIdx.x;
  if (e < a.cchunks) chroma_chunk(a, e);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_refs_kernels.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `ref_args`' order (host
// arrays).
extern "C" int th264_halfpel_refs(void* const* p, const int* n,
                                  void* stream) {
  const RefArgs a = ref_args(p, n);
  halfpel_kernel<<<a.blocks, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__
