// K9: the P encode after stage A -- per MB and reference the full-pel and
// quarter-pel refinement, the reference choice, motion compensation, the
// inter luma and chroma transforms, quantisation and reconstruction, and
// P_Skip -- a warp per MB; with the t8 route also the 8x8 transform's
// trial and choice of every MB.
//
// Replaces: the XLA program of tpuh264/kernels/pframe.py
// `encode_pframe_rows_multi` (:638) after its stage A, not a pallas_call:
// `_int_refine` :381, `_extract_w2` :421, `_subpel_refine` :433, the
// reference choice :700-740, `_mc_all` :610, `_transform_inter_luma` :541,
// `_recon_inter_luma` :558, the 8x8 choice with t8 :747-785,
// `_chroma_fwd` :565, `_recon_chroma` :573, P_Skip and the batched
// symbols :810-845.  Its plain PyTorch version is `kernels/pframe.py`
// `_inter_encode_plain` (the t8 route's with t8 True: `_t8_choice`).
//
// What it computes, exactly as the plain version, per MB of stream s and
// per reference n < N (1-16), from stage A's winner (iy0, ix0) and the
// stream's global vector (gy, gx) of that reference:
//  * stage B: the 3x3 full-pel refine on the G plane, cost sad + lam *
//    rate_q(4 mx - 4 gx, 4 my - 4 gy), candidates in raster order (dy
//    outer), a candidate replacing the best only when strictly cheaper;
//  * stages C / D: the half-pel selection in OFFSETS_HALF order around
//    the refined vector, then the quarter-pel one in OFFSETS_QUARTER
//    order around the half-pel winner, both on a strict <, each
//    prediction the rounded mean of two half-pel components (QPEL_TBL);
//    the plain version tabulates all 49 quarter-pel costs first, but the
//    selections read only the centre, the 8 half-pel positions and the 8
//    quarter-pel ones around the half-pel winner, so only those 17 are
//    computed here (the centre's cost and SAD are stage B's winner's: the
//    same G samples and rate); the SAD kept is the chosen position's;
//  * the reference choice: the cost plus lam * ref_idx_bits(n + ref_base,
//    ref_base + N) (the host's `ref_cost`), a later reference replacing
//    the best only on a strict <;
//  * motion compensation from the chosen reference: luma the rounded mean
//    of the fraction's two components, chroma the eighth-pel bilinear of
//    the _CP-padded planes, both at indices clamped into the planes as
//    `_gather_win` clamps them;
//  * luma: the 4x4 forward transform of src - pred, the inter
//    quantisation (rounding 2^qbits / 6), the levels in zigzag order
//    (blocks in raster order), cbp from the 8x8 groups, and the
//    reconstruction with the uncoded groups' levels masked; chroma at
//    qpc: the 2x2 DC Hadamard and its quantisation, the AC levels, cbp
//    (2 any AC, 1 any DC, else 0) and the reconstruction;
//  * the t8 route (the template's kT8; config 3's CABAC + 8x8 sessions):
//    the 8x8 coding of the MB beside the 4x4 one -- forward8x8 of the
//    four 8x8 residuals, quant8x8 (inter rounding 2^qbits / 6), zigzag8,
//    cbp8 from the blocks' levels, the recon through dequant8x8 (its
//    rounded shift below QP 12) and the 8x8 inverse -- and J = 8 SSD +
//    lam8 rate of each (rate: 2 bit_length + 1 a nonzero level, the 8x8
//    one a bit more); the 8x8 coding is chosen when its J is strictly
//    lower and it codes a level (a tie, or cbp8 0, keeps 4x4), and then
//    gives the MB its cbp, recon and levels: block k / 4's 64 zigzag
//    levels in rows k of the [16, 16] (zz8.reshape(4, 64));
//  * P_Skip: luma (the chosen) and chroma cbp 0, motion 0 and reference
//    index refsel + ref_base 0; refidx is 0 for a skip, else refsel +
//    ref_base; t8 is 0 for a skip, else the choice.
// It writes mvx, mvy, refsel, inter SAD, kind, refidx, both cbps and the
// int16 levels [S,R,C,16,16], [S,R,C,2,4], [S,R,C,2,4,15] (the MBSymbolsP
// layouts), and the reconstruction: int32 MBs [S,R,C,16,16], [S,R,C,8,8]
// x 2 with intra-in-P (K6's D4 takes them as rec_inter), else the uint8
// planes [S,H,W], [S,H/2,W/2] x 2; t8 where its pointer is given.  Given
// the pointers (the GOP pipeline's route, `out` views of a dispatch's [P *
// S, R, C] symbol buffers), lane 0 also writes mode and cmode 0 and lanes
// 0-1 the zero luma_dc, and lane 0 the mvd against the left MB's vector
// (the vector itself at column 0).  The left vector is another warp's,
// often another block's, known only once its search is done, so each
// pair of neighbours exchanges its vectors through a slot of its own
// (`pairs`, zeroed once where it is allocated and left zero by every
// launch): the second warp to arrive subtracts (`mvd_finish`).  No warp
// waits on another, no launch follows, and no launch needs a memset.  No
// MB of this route is intra (intra-in-P overlays its symbols after K9, in
// PyTorch).
//
// What bounds it on the H100: bytes.  Every MB searches every reference,
// and its windows of the four half-pel planes tile each plane, so at
// 1080p x 4 with one reference it must read the four uint8 half-pel
// planes and the two chroma planes over the frame's area (37.6 MB) and
// the int32 source (50.1 MB), and write 1,184 bytes a MB (38.6 MB, 52
// bytes more a MB where it writes the symbols): about 126 MB, 0.038 ms
// at 3.35 TB/s.  Its arithmetic, 25 candidate SADs of 256 samples a MB
// and reference on packed bytes, is far under the card's rate.  The
// window loads are the latency to hide: read as scalar int32 samples they
// took ~60% of a warp's time (tools/time_pframe.py --phases), hence the
// 16-byte chunks below.  The first design (d893870) also lost time to
// issue: 58 SADs of int32 samples from shared memory, each ending in a
// 5-step shuffle chain, behind two dependent rounds of window loads, at
// 24 warps an SM.
//
// Design: a warp per MB, kWarps MBs a block (no block barrier: a warp
// past the last MB returns).
//  * The source MB is read with 16-byte loads and kept as bytes: the
//    lane's 8 samples (row lane / 2, columns 8 (lane & 1) ..) in two
//    registers for the SADs, the MB in shared memory for the transforms.
//  * Per reference, one load before stage B: the 20x20 windows at (iy0 -
//    2, ix0 - 2) of the four half-pel planes, which hold stage B's +-1
//    and every sub-pel position around any refined vector, as bytes in
//    shared memory (1.6 KB a reference).  The planes are K11's bytes,
//    rows 16-byte aligned: a lane takes a window row of a plane (80 rows,
//    lanes l, l + 32, l + 64), reads the 20 bytes as the two or three
//    16-byte chunks that hold them and shifts them into the row's five
//    words (a funnel shift by the window's column offset, the same for
//    the whole warp).  A window inside the plane (every legal vector's)
//    takes no clamp; one that touches the border clamps every index and
//    reads byte by byte.  Two buffers: the best reference's windows stay
//    while the next reference's load into the other.
//  * Each phase (stage B's 9, the 8 half-pel, the 8 quarter-pel
//    candidates) computes its candidates' partial SADs together, 8
//    samples a lane: the window row's words shifted to the candidate's
//    byte offset, the two components' rounded mean per byte (`avg4`),
//    __vsadu4 against the source; then one redux.sync (__reduce_add_sync)
//    a candidate gives every lane the SAD, and every lane runs the same
//    sequential selection.
//  * MC: the luma prediction from the chosen reference's windows in
//    shared memory, the chroma prediction by all 32 lanes, four samples
//    each.
//  * 56 registers and 4.3 KB of shared memory a warp: 36 warps an SM.
//    Held to 48 registers (40 warps) it spills and runs slower.
//  * Then lanes 0-15 take a luma 4x4 block each and lanes 16-23 a chroma
//    block each (cbps by ballots, the chroma DCs through shared memory);
//    every store is 16 bytes a lane (the luma levels, the chroma levels
//    staged in shared memory, the int32 reconstruction) or 4 (the uint8
//    planes' rows).
//  * The t8 route's trial (`trial8`) takes all 32 lanes, lane l row, then
//    column, l & 7 of 8x8 block l >> 3, its 8 values in registers; the
//    three transposes, the levels and the 8x8 recon go through the window
//    buffers, free once MC is done.  J and cbp8 come from one ballot and
//    two redux.sync, so every lane makes the same choice; the 4x4 levels
//    wait in registers until it is made, and a chosen 8x8 MB's levels
//    leave as 16 bytes a lane.  The route is a template instance of its
//    own, so the routes without it keep their code, registers and
//    occupancy.
//  * The t8 route's search (config 3's sessions search two references):
//    references 0 and 1's stage-A winners are read when the warp starts,
//    and their windows, luma and chroma, go in flight at once by
//    cp.async, 4 bytes a copy, into two slots of shared memory
//    (WarpMemT8), before the source is read.  The second reference's
//    land during the first's search, and MC's chroma comes from the
//    chosen reference's 11x11 chroma windows, so a MB waits on one round
//    of copies, not on three in a chain (a reference's windows, the
//    next's after its search, chroma's after the choice: a third of a
//    warp's cycles by the phase clocks of tools/time_pframe.py --phases).
//    A window row is kept as the aligned words that hold it (no shift at
//    the copy: `win8` reads from the row's byte offset); a reference
//    after the second (up to 16) is copied in after the searches before
//    it, into the slot the best so far is not in.  Other warps hide the
//    second reference's copies as well (waiting for them before the first
//    search costs nothing measurable), so the route is held by its
//    instructions, and its tables come from immediates: a sub-pel
//    candidate's two components (`qpel_pair`; stage D's by the half-pel
//    winner's parity), the trial's scales by its row (`cls8_row`) and
//    zigzag by its lane (kZz8Row), where a constant load at a lane's or
//    a candidate's own index is serialised across the warp's addresses.
//    72 registers, 25,856 B of shared memory a block: 28 warps an SM
//    (held to 64 registers for 32 warps it ran 9-10% slower, 2-3% with
//    6-word rows that leave L1 more of the SM).
// Where trouble is likely, and what is done about it:
//  * tie order: every selection is the plain version's sequential strict
//    < in its own order (stage B raster, half then quarter, references by
//    index), run identically on every lane; no parallel min reorders it;
//  * `_rate_q`: the plain version counts 2|v| + 1 against the powers up
//    to 128, exact for |v| <= 127; `ue_len` takes min(bit length, 8), and
//    the static_assert below bounds the refined vectors at 71;
//  * negative shifts and masks: mv >> 2, & 3, >> 3, & 7 stay int
//    arithmetic (floor, two's complement), as torch's;
//  * alignment: the half-pel planes are uint8 [S, Hp, lp] with lp a
//    multiple of 16 and every row 16-byte aligned (the wrapper raises on
//    another layout); a chunk is never read past a row's pitch (a window
//    inside the plane ends before Wp <= lp); the pitch bytes are never
//    samples.  The source, the levels and the reconstruction are 16-byte
//    aligned (the wrapper clones a source plane that is not);
//  * multi-reference: up to sixteen references' pointers (unused ones
//    repeat reference 0's), a reference's winners at [n, S, R, C]; N is 1
//    right after an IDR, and ref_base is the temporal-layer session's
//    forced reference.  The arguments are a __grid_constant__ parameter,
//    so a reference's pointer is read where it is, not from a local copy.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "inter_common.cuh"  // inter quantiser, transforms, MC, rate

namespace {

constexpr int kWarps = 4;     // MBs a block, a warp each
constexpr int kMaxRefs = 16;  // H.264's most references
constexpr int kWin = 20;      // window side: 16 + stage B's and the sub-pel reach
constexpr int kWinWords = kWin / 4;            // a window row's words
constexpr int kPlaneWords = kWin * kWinWords;  // a plane's window
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSearch = 8, kRefine = 1;  // golden.inter SEARCH_RANGE, REFINE_RANGE
static_assert(4 * (kSearch + kRefine) + 3 + 4 * kSearch <= 127,
              "a refined vector's rate is outside _rate_q's exact range");
static_assert(kWin == 16 + 2 * (kRefine + 1), "the window holds stage B "
              "and the sub-pel components around any refined vector");

struct EncArgs {
  const int32_t *y, *u, *v;            // source [S,H,W], [S,H/2,W/2] x 2
  const int32_t *iy0, *ix0;            // stage A winners [N, S, R, C]
  const int32_t *gy, *gx;              // global vectors [N, S]
  const uint8_t *pl[kMaxRefs];         // half-pel planes [4, S, Hp, lp]
  const uint8_t *pu[kMaxRefs], *pv[kMaxRefs];  // chroma [S, Hcp, cp]
  int32_t *mvx, *mvy, *refsel, *sad, *kind, *refidx, *cbp_l, *cbp_c;
  int16_t *luma_ac, *chroma_dc, *chroma_ac;
  void *ry, *ru, *rv;                  // int32 MBs (mb_out) or uint8 planes
  // the rest of MBSymbolsP, written where non-null: the mvds against the
  // left MB's vector, and mode, cmode, t8 and luma_dc 0
  int32_t *mvdx, *mvdy, *mode, *cmode, *t8;
  int16_t *luma_dc;
  int S, R, C, N, Hp, Wp, Hcp, Wcp, pe, cp, qp, qpc, lam, ref_base, mb_out;
  int lp, cpitch;                      // the planes' row pitches, bytes
  int ref_cost[kMaxRefs];              // lam * ref_idx_bits of reference n
  int t8on, lam8;  // the 8x8 trial (the launch's template), its lambda
  // with mvdx: a slot a MB for the vectors of its pair (it and its left
  // MB), zero between launches
  unsigned long long* pairs;
};

constexpr int kPtrs = 3 + 4 + 3 * kMaxRefs + 8 + 3 + 3 + 6 + 1;  // 76
constexpr int kInts = 17 + kMaxRefs + 2;                  // 35

// The arguments from the entry's pointer and int arrays, in the order
// kernels/pframe.py `_k9_launch` builds them.
inline EncArgs enc_args(void* const* p, const int* n) {
  EncArgs a;
  auto in = [p](int i) { return static_cast<const int32_t*>(p[i]); };
  auto out = [p](int i) { return static_cast<int32_t*>(p[i]); };
  auto lev = [p](int i) { return static_cast<int16_t*>(p[i]); };
  auto pln = [p](int i) { return static_cast<const uint8_t*>(p[i]); };
  a.y = in(0), a.u = in(1), a.v = in(2);
  a.iy0 = in(3), a.ix0 = in(4), a.gy = in(5), a.gx = in(6);
  for (int k = 0; k < kMaxRefs; ++k) {
    a.pl[k] = pln(7 + k);
    a.pu[k] = pln(7 + kMaxRefs + k);
    a.pv[k] = pln(7 + 2 * kMaxRefs + k);
  }
  const int o = 7 + 3 * kMaxRefs;  // the outputs
  a.mvx = out(o), a.mvy = out(o + 1), a.refsel = out(o + 2);
  a.sad = out(o + 3), a.kind = out(o + 4), a.refidx = out(o + 5);
  a.cbp_l = out(o + 6), a.cbp_c = out(o + 7);
  a.luma_ac = lev(o + 8), a.chroma_dc = lev(o + 9), a.chroma_ac = lev(o + 10);
  a.ry = p[o + 11], a.ru = p[o + 12], a.rv = p[o + 13];
  a.mvdx = out(o + 14), a.mvdy = out(o + 15), a.mode = out(o + 16);
  a.cmode = out(o + 17), a.t8 = out(o + 18), a.luma_dc = lev(o + 19);
  a.S = n[0], a.R = n[1], a.C = n[2], a.N = n[3], a.Hp = n[4], a.Wp = n[5];
  a.Hcp = n[6], a.Wcp = n[7], a.pe = n[8], a.cp = n[9], a.qp = n[10];
  a.qpc = n[11], a.lam = n[12], a.ref_base = n[13], a.mb_out = n[14];
  a.lp = n[15], a.cpitch = n[16];
  for (int k = 0; k < kMaxRefs; ++k) a.ref_cost[k] = n[17 + k];
  a.t8on = n[17 + kMaxRefs], a.lam8 = n[18 + kMaxRefs];
  a.pairs = static_cast<unsigned long long*>(p[o + 20]);
  return a;
}
static_assert(7 + 3 * kMaxRefs + 21 == kPtrs, "pointer count");

// A warp's shared memory (4,288 bytes), every sample a byte: two
// references' four windows, the best so far and the one searched (word i
// of plane p: row i / 5, samples 4 (i % 5) ..; one word more, read past
// the last row but never used),
// the source MB and the prediction (luma 4 words a row, chroma 2), the
// chroma DC coefficients and levels, and the chroma AC levels staged for
// their 16-byte stores.
struct WarpMem {
  uint32_t win[2][4 * kPlaneWords + 1];
  uint32_t src[64], su[16], sv[16];
  uint32_t pred[64], pu[16], pv[16];
  int cdc[2][4], cdq[2][4];
  alignas(16) int16_t cac[120];
};

// The t8 route's shared memory a warp (6,464 bytes): WarpMem's with two
// slots, each a reference's windows as the aligned words that hold them,
// luma and chroma, copied in by cp.async.  A luma window row (20 bytes
// from x0) is the 6 words from x0 & ~3 (its byte 0 at byte x0 & 3 of the
// first), rows kRowW words apart (the seventh word unused: a lane's row
// of the SADs then falls on its own banks); a plane's window kWin rows.
// The chroma windows (11 x 11, `kCWin`: every sample MC can read from a
// vector within the refinement's reach of the stage-A winner) follow,
// 4 words a row, rows kCRowW apart.
constexpr int kRowW = 7, kCWin = 11, kCRowW = 5;
constexpr int kChromaW = 4 * kWin * kRowW;  // the chroma windows' word
constexpr int kSlotW = kChromaW + 2 * kCWin * kCRowW;
struct WarpMemT8 {
  uint32_t win[2][kSlotW];
  int ref01[2][4];  // references 0 and 1's iy0, ix0 and 4 gy, 4 gx
  uint32_t src[64], su[16], sv[16];
  uint32_t pred[64], pu[16], pv[16];
  int cdc[2][4], cdq[2][4];
  alignas(16) int16_t cac[120];
};
// a refined vector lies within kRefine pels and 3 quarter-pels of its
// stage-A winner: (4 iy0 + 7) >> 3 - (4 iy0 - 7) >> 3 <= 2 chroma rows
// past the window's first, and 9 rows from there
static_assert(kCWin == 2 + 9 && 4 * (kRefine + 1) - 1 == 7,
              "the chroma window holds every sample MC can read");

// A window row's five words from the chunks c[0..11] that hold it: the
// row starts at byte 4Q + sh / 8 of c (Q the word, sh its bit offset).
template <int Q>
__device__ __forceinline__ void shift_row(const uint32_t* c, int sh,
                                          uint32_t* dst) {
#pragma unroll
  for (int i = 0; i < kWinWords; ++i)
    dst[i] = __funnelshift_r(c[Q + i], c[Q + i + 1], sh);
}

// The 20x20 windows of one reference's four half-pel planes (stream s's
// G plane `g`, the others lstride on, rows lp bytes apart) at
// plane-space (y0, x0), into `win` as bytes: job j is row j % 20 of plane
// j / 20, lane l takes jobs l, l + 32, l + 64 of the 80.  A window inside
// the plane reads a row as the 16-byte chunks from column x0 & ~15 that
// hold it (a third only where the row reaches it: never past Wp <= lp)
// and shifts them into place; one that touches the border clamps every
// index and reads byte by byte.
__device__ __forceinline__ void load_windows(uint32_t* win, const uint8_t* g,
                                             size_t lstride, int y0, int x0,
                                             int hp, int wp, int lp,
                                             int lane) {
  const bool inside = y0 >= 0 && x0 >= 0 && y0 + kWin <= hp && x0 + kWin <= wp;
  const int q = (x0 >> 2) & 3, sh = 8 * (x0 & 3);
  const bool third = (x0 & 15) + kWin > 32;
#pragma unroll 1  // unrolled, its loads would take as many registers
  for (int k = 0; k < 3; ++k) {
    const int job = lane + 32 * k;
    if (job >= 4 * kWin) break;
    const int p = job / kWin, y = job - p * kWin;
    const uint8_t* pg = g + p * lstride;
    uint32_t* dst = win + p * kPlaneWords + y * kWinWords;
    if (inside) {
      const uint4* r = reinterpret_cast<const uint4*>(
          pg + (size_t)(y0 + y) * lp + (x0 & ~15));
      const uint4 a = r[0], b = r[1];
      const uint4 e = third ? r[2] : make_uint4(0u, 0u, 0u, 0u);
      const uint32_t c[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                              b.z, b.w, e.x, e.y, e.z, e.w};
      switch (q) {  // the same for the whole warp
        case 0: shift_row<0>(c, sh, dst); break;
        case 1: shift_row<1>(c, sh, dst); break;
        case 2: shift_row<2>(c, sh, dst); break;
        default: shift_row<3>(c, sh, dst); break;
      }
    } else {
#pragma unroll
      for (int i = 0; i < kWinWords; ++i) {
        const int x = x0 + 4 * i;
        dst[i] = pack_bytes(at(pg, y0 + y, x, hp, wp, lp),
                            at(pg, y0 + y, x + 1, hp, wp, lp),
                            at(pg, y0 + y, x + 2, hp, wp, lp),
                            at(pg, y0 + y, x + 3, hp, wp, lp));
      }
    }
  }
}

// the 8 bytes of plane p's window row y from byte x of the row (rows
// kRow words apart, planes kWin rows): the row's words from x / 4 shifted
// to the byte offset
template <int kRow = kWinWords>
__device__ __forceinline__ uint2 win8(const uint32_t* win, int p, int y,
                                      int x) {
  const uint32_t* w = win + p * (kWin * kRow) + y * kRow + (x >> 2);
  const int s = 8 * (x & 3);
  const uint64_t lo = ((uint64_t)w[1] << 32) | w[0];
  const uint64_t hi = ((uint64_t)w[2] << 32) | w[1];
  return make_uint2((uint32_t)(lo >> s), (uint32_t)(hi >> s));
}

// The lane's 8 luma prediction samples (MB row `row`, columns col ..
// col + 7) at quarter-pel offset (py, px) from the window's sample (oy,
// ox): the rounded mean of the fraction's two components (one, where the
// fraction names the same one twice: (a + a + 1) >> 1 = a).
__device__ __forceinline__ uint2 qpel8(const uint32_t* win, int oy, int ox,
                                       int py, int px, int row, int col) {
  const int f = (py & 3) * 4 + (px & 3);
  const int c1 = kQpel[f][0], c2 = kQpel[f][1];
  const int y = oy + (py >> 2) + row, x = ox + (px >> 2) + col;
  const uint2 a = win8(win, kCompPl[c1], y + kCompDy[c1], x + kCompDx[c1]);
  if (c1 == c2) return a;
  const uint2 b = win8(win, kCompPl[c2], y + kCompDy[c2], x + kCompDx[c2]);
  return make_uint2(avg4(a.x, b.x), avg4(a.y, b.y));
}

// `qpel8` on the t8 route's windows (WarpMemT8), the fraction's
// components e from `qpel_pair`
__device__ __forceinline__ uint2 qpel8p(const uint32_t* win, int oy, int ox,
                                        int py, int px, unsigned e, int row,
                                        int col) {
  const int y = oy + (py >> 2) + row, x = ox + (px >> 2) + col;
  const uint2 a =
      win8<kRowW>(win, e & 3, y + ((e >> 2) & 1), x + ((e >> 3) & 1));
  if ((e & 15) == (e >> 4)) return a;
  const uint2 b = win8<kRowW>(win, (e >> 4) & 3, y + ((e >> 6) & 1),
                              x + ((e >> 7) & 1));
  return make_uint2(avg4(a.x, b.x), avg4(a.y, b.y));
}

__device__ __forceinline__ unsigned sad8(uint2 s, uint2 p) {
  return __vsadu4(s.x, p.x) + __vsadu4(s.y, p.y);
}

// candidate k of 8 around a centre in raster order, the centre (4 of 9)
// left out
__device__ __forceinline__ int ring(int k) { return k + (k >= 4); }

// Reference n's windows for the MB (s, r, c) whose stage-A winner is
// (iy0, ix0), into `sl`, a slot of WarpMemT8::win: its four 20x20 luma
// windows at plane-space (y0, x0) and its two 11x11 chroma windows at
// (cy, cx).  A window inside its planes goes by cp.async, 4 bytes a
// copy, in the group the caller commits: lane l < 30 takes word l % 6 of
// rows l / 6, l / 6 + 5, .. of the 80 (the sixth word only where x0 & 3
// is not 0: its first byte is then a sample, so it ends inside the row's
// pitch), and in chroma word l & 3 of rows l >> 2, + 8, + 16 of the 22
// (the fourth only where (cx & 3) >= 2, likewise).  One that touches the
// border clamps every index and is stored byte by byte.
__device__ __forceinline__ void fetch_windows(uint32_t* sl, const EncArgs& a,
                                              int n, int s, int r, int c,
                                              int iy0, int ix0, int lane) {
  const int hp = a.Hp, wp = a.Wp, lp = a.lp, hc = a.Hcp, wc = a.Wcp;
  const int cpitch = a.cpitch;
  const size_t lstride = (size_t)a.S * hp * lp, cso = (size_t)s * hc * cpitch;
  const uint8_t* g = a.pl[n] + (size_t)s * hp * lp;  // its G plane
  const uint8_t *cu = a.pu[n] + cso, *cv = a.pv[n] + cso;
  const int y0 = 16 * r + iy0 - 2 + a.pe, x0 = 16 * c + ix0 - 2 + a.pe;
  const int cy = 8 * r + ((4 * iy0 - 7) >> 3) + a.cp;
  const int cx = 8 * c + ((4 * ix0 - 7) >> 3) + a.cp;
  const int xa = x0 & ~3;
  if (y0 >= 0 && x0 >= 0 && y0 + kWin <= hp && x0 + kWin <= wp) {
    const int wd = lane % 6, r0 = lane / 6;
    if (lane < 30 && (wd < 5 || (x0 & 3))) {
      const uint8_t* src = g + (size_t)(y0 + r0) * lp + xa + 4 * wd;
      uint32_t* dst = sl + r0 * kRowW + wd;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int p = k >> 2, dy = 5 * (k & 3);
        cp_async4(dst + (p * kWin + dy) * kRowW,
                  src + p * lstride + (size_t)dy * lp);
      }
    }
  } else {
#pragma unroll 1
    for (int j = lane; j < 4 * kWin * 6; j += 32) {
      const int p = j / (6 * kWin), y = (j - 6 * kWin * p) / 6;
      const int x = xa + 4 * (j % 6);
      const uint8_t* pg = g + p * lstride;
      sl[(p * kWin + y) * kRowW + j % 6] =
          pack_bytes(at(pg, y0 + y, x, hp, wp, lp),
                     at(pg, y0 + y, x + 1, hp, wp, lp),
                     at(pg, y0 + y, x + 2, hp, wp, lp),
                     at(pg, y0 + y, x + 3, hp, wp, lp));
    }
  }
  uint32_t* const cw = sl + kChromaW;
  const int xca = cx & ~3;
  if (cy >= 0 && cx >= 0 && cy + kCWin <= hc && cx + kCWin <= wc) {
    const int wd = lane & 3;
    if (wd < 3 || (cx & 3) >= 2) {
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const int rr = (lane >> 2) + 8 * k;  // row rr of the two planes' 22
        if (rr < 2 * kCWin) {
          const int p = rr >= kCWin, y = rr - kCWin * p;
          cp_async4(cw + rr * kCRowW + wd,
                    (p ? cv : cu) + (size_t)(cy + y) * cpitch + xca + 4 * wd);
        }
      }
    }
  } else {
#pragma unroll 1
    for (int j = lane; j < 2 * kCWin * 4; j += 32) {
      const int rr = j >> 2, p = rr >= kCWin, y = rr - kCWin * p;
      const int x = xca + 4 * (j & 3);
      const uint8_t* pc = p ? cv : cu;
      cw[rr * kCRowW + (j & 3)] = pack_bytes(
          at(pc, cy + y, x, hc, wc, cpitch), at(pc, cy + y, x + 1, hc, wc, cpitch),
          at(pc, cy + y, x + 2, hc, wc, cpitch),
          at(pc, cy + y, x + 3, hc, wc, cpitch));
    }
  }
}

// The t8 route's stages B-D of one reference, the same on every lane (the
// route without t8 runs them inline, from its windows' layout), from its
// windows `win` (a WarpMemT8 slot, the window's column 0 at byte `off` of
// a row) around its stage-A winner (iy0, ix0): the cost (SAD + lam rate
// against the global vector (gqy, gqx), in quarter-pels), the refined
// vector and its SAD.
struct Refined {
  int cost, mvy, mvx, sad;
};

__device__ __forceinline__ Refined refine(const uint32_t* win, int off,
                                          uint2 src, int iy0, int ix0,
                                          int gqy, int gqx, int lam, int row,
                                          int col) {
  // stage B: 3x3 full-pel refine on G, raster order, strict <
  int sad[9];
#pragma unroll
  for (int k = 0; k < 9; ++k)
    sad[k] = (int)sad8(
        src, win8<kRowW>(win, 0, 1 + k / 3 + row, 1 + k % 3 + col + off));
#pragma unroll
  for (int k = 0; k < 9; ++k) sad[k] = (int)__reduce_add_sync(kFull, sad[k]);
  int cost = 0, iy = 0, ix = 0, bsad = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const int my = iy0 - kRefine + k / 3, mx = ix0 - kRefine + k % 3;
    const int cand = sad[k] + lam * rate_q(4 * mx - gqx, 4 * my - gqy);
    if (k == 0 || cand < cost) cost = cand, iy = my, ix = mx, bsad = sad[k];
  }

  // stage C: the half-pel positions around (iy, ix), OFFSETS_HALF
  // order; the centre is stage B's winner.  Stage D: the quarter-pel
  // positions around the half-pel winner, OFFSETS_QUARTER order.
  const int oy = 2 + iy - iy0, ox = 2 + ix - ix0 + off;  // (iy, ix) in win
  int by = 0, bx = 0;
#pragma unroll
  for (int half = 1; half >= 0; --half) {
    const int step = half ? 2 : 1, base_y = by, base_x = bx;
    // stage D's fractions depend only on whether the half-pel winner's
    // components are odd half-pels: candidate k's components, byte k of
    // one of four immediates (`qpel_pair` of each fraction)
    const int odd = ((by & 2) >> 1) | (bx & 2);
    const uint64_t eq = odd == 0   ? 0x2120a1108152425aull
                        : odd == 1 ? 0x52425a32a32120a1ull
                        : odd == 2 ? 0xa1312181105a5352ull
                                   : 0x5a5352a332a13121ull;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int py = base_y + step * (ring(k) / 3 - 1);
      const int px = base_x + step * (ring(k) % 3 - 1);
      const unsigned e = half ? qpel_pair((py & 3) * 4 + (px & 3))
                              : (unsigned)(eq >> (8 * k)) & 255u;
      sad[k] = (int)sad8(src, qpel8p(win, oy, ox, py, px, e, row, col));
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) sad[k] = (int)__reduce_add_sync(kFull, sad[k]);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int py = base_y + step * (ring(k) / 3 - 1);
      const int px = base_x + step * (ring(k) % 3 - 1);
      const int cand =
          sad[k] + lam * rate_q(4 * ix + px - gqx, 4 * iy + py - gqy);
      if (cand < cost) cost = cand, by = py, bx = px, bsad = sad[k];
    }
  }
  return Refined{cost, 4 * iy + by, 4 * ix + bx, bsad};
}

// the t8 trial's staging, ints of the window buffers (free once MC is
// done): the transposes, the levels ([block][8 u + v]) and the recon (MB
// raster)
constexpr int kT8St = 0, kT8Lev = 256, kT8Rec = 512;
static_assert(sizeof(WarpMemT8::win) >= 768 * sizeof(int),
              "the t8 trial's staging fits the window buffers");

struct Trial8 {
  int j8, cbp8;  // J = 8 SSD + lam8 (rate + 1) and the 4-bit cbp
};

// The 8x8 coding of the MB (`_t8_choice`'s z8, zz8, cbp8, rec8 and J8),
// all 32 lanes: lane l takes row l & 7, then column l & 7, of 8x8 block
// b = l >> 3 (raster, by8 * 2 + bx8), its 8 values in registers and the
// three transposes through `t`: the residual's rows forward, the columns
// forward (the lane then holds coefficient row u = l & 7, [u][v] as
// forward8x8 lays them), quantised (their levels to t + kT8Lev) and
// dequantised, inverse along u (lane: column v), inverse along v (lane:
// column x of the block), added to the prediction and clipped (the recon
// to t + kT8Rec).  J8 and cbp8 come back the same on every lane.
__device__ __forceinline__ Trial8 trial8(const WarpMemT8& w, int* t, int qp,
                                         int lam8, int lane) {
  const int b = lane >> 3, i = lane & 7, y8 = 8 * (b >> 1), xw = 2 * (b & 1);
  int* const st = t + kT8St + 64 * b;
  int x[8];
  {  // residual row i, columns 8 bx8 .. of the block
    const int o = 4 * (y8 + i) + xw;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      x[j] = byte_of(w.src[o + (j >> 2)], j & 3) -
             byte_of(w.pred[o + (j >> 2)], j & 3);
  }
  fwd8(x);
#pragma unroll
  for (int u = 0; u < 8; ++u) st[8 * i + u] = x[u];
  __syncwarp();
#pragma unroll
  for (int y = 0; y < 8; ++y) x[y] = st[8 * y + i];
  __syncwarp();
  fwd8(x);  // coefficients [u = i][v]
  const int qbits = 16 + qp / 6, f = (1 << qbits) / 6, m6 = qp % 6;
  int mf[4], sc[4];  // row i's multipliers and scales, by v & 3
  const unsigned cw = cls8_row(i);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int cl = (cw >> (4 * j)) & 15;
    mf[j] = kMF8[m6][cl], sc[j] = kV8[m6][cl];
  }
  int rate = 0;
  bool nz = false;
#pragma unroll
  for (int v = 0; v < 8; ++v) {
    const int lv = q8(x[v], mf[v & 3], f, qbits);
    nz |= lv != 0;
    rate += rate_bits(lv);
    t[kT8Lev + 64 * b + 8 * i + v] = lv;
    st[8 * i + v] = dq8(lv, sc[v & 3], qp);
  }
  __syncwarp();
#pragma unroll
  for (int u = 0; u < 8; ++u) x[u] = st[8 * u + i];
  __syncwarp();
  inv8(x);  // [v = i][x]
#pragma unroll
  for (int k = 0; k < 8; ++k) st[8 * i + k] = x[k];
  __syncwarp();
#pragma unroll
  for (int v = 0; v < 8; ++v) x[v] = st[8 * v + i];
  inv8(x);  // column i of the block's residual, rows y
  int ssd = 0;
#pragma unroll
  for (int y = 0; y < 8; ++y) {
    const int o = 4 * (y8 + y) + xw + (i >> 2);
    const int r = clip255(byte_of(w.pred[o], i & 3) + ((x[y] + 32) >> 6));
    const int d = r - byte_of(w.src[o], i & 3);
    ssd += d * d;
    t[kT8Rec + 16 * (y8 + y) + 4 * xw + i] = r;
  }
  const unsigned nzb = __ballot_sync(kFull, nz);
  const int ssd8 = (int)__reduce_add_sync(kFull, (unsigned)ssd);
  const int rate8 = (int)__reduce_add_sync(kFull, (unsigned)rate);
  return {8 * ssd8 + lam8 * (rate8 + 1),
          ((nzb & 0xffu) ? 1 : 0) | ((nzb & 0xff00u) ? 2 : 0) |
              ((nzb & 0xff0000u) ? 4 : 0) | ((nzb & 0xff000000u) ? 8 : 0)};
}

// The mvds by pairs: MB m - 1 and MB m (one row) each exchange their
// final vector, as one word with a flag (`mvd_word`), into the pair's slot
// pairs[m], zero between launches.  The one that finds the other's word
// there arrived second: it writes MB m's mvd and empties the slot
// (`mvd_finish`).  The vector travels in the atomic itself, so nothing
// else is ordered: no fence.  A component fits 21 bits (a vector is within
// a few dozen quarter-pels of zero).
__device__ __forceinline__ unsigned long long mvd_word(int mx, int my) {
  return 1ull << 42 | (unsigned long long)(mx & 0x1fffff) << 21 |
         (unsigned long long)(my & 0x1fffff);
}

__device__ __forceinline__ int sext21(unsigned long long x) {
  return (int)((uint32_t)(x & 0x1fffff) << 11) >> 11;
}

// MB m's mvd from `got`, what the caller's exchange on pairs[m] returned
// (0 where it arrived first), and its own vector (mx, my); `right`: the
// caller is MB m.
__device__ __forceinline__ void mvd_finish(const EncArgs& a, int m,
                                           unsigned long long got, int mx,
                                           int my, bool right) {
  if (!got) return;  // the first to arrive: the other writes the mvd
  const int ox = sext21(got >> 21), oy = sext21(got);
  a.mvdx[m] = right ? mx - ox : ox - mx;
  a.mvdy[m] = right ? my - oy : oy - my;
  a.pairs[m] = 0;
}

// kT8: the 8x8 transform's trial (the t8 route, config 3's CABAC + 8x8
// sessions); without it the kernel is the RTC and default routes' own.
template <bool kT8 = false>
__global__ void __launch_bounds__(32 * kWarps)
    pframe_encode_kernel(const __grid_constant__ EncArgs a) {
  using Mem = typename std::conditional<kT8, WarpMemT8, WarpMem>::type;
  __shared__ Mem smem[kWarps];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int rc = a.R * a.C, mbs = a.S * rc;
  const int m = blockIdx.x * kWarps + warp;
  if (m >= mbs) return;  // the whole warp: no block barrier follows
  Mem& w = smem[warp];
  const int s = m / rc, r = (m % rc) / a.C, c = m % a.C;
  const int H = 16 * a.R, W = 16 * a.C, Hc = H / 2, Wc = W / 2;
  const size_t lstride = (size_t)a.S * a.Hp * a.lp;
  const size_t lso = (size_t)s * a.Hp * a.lp;
  const size_t cso = (size_t)s * a.Hcp * a.cpitch;
  const int row = lane >> 1, col = (lane & 1) * 8;  // the lane's 8 samples
  const int crow = (lane & 15) >> 1, ccol = (lane & 1) * 4;  // its chroma 4

  // the t8 route: references 0 and 1's windows, luma and chroma, in
  // flight at once (slots 0 and 1, a cp.async group each) from the
  // warp's start, so that the source's loads and the second reference's
  // copies land during the first's search; a later reference's go, one
  // at a time, to the slot the best so far is not in
  // (their winners and global vectors kept in shared memory, not in
  // registers through the first search)
  if constexpr (kT8) {
    for (int n = 0; n < 2; ++n) {
      if (n < a.N) {
        const size_t am = (size_t)n * mbs + m;
        const int iy0 = a.iy0[am], ix0 = a.ix0[am];
        w.ref01[n][0] = iy0, w.ref01[n][1] = ix0;
        w.ref01[n][2] = 4 * a.gy[n * a.S + s];
        w.ref01[n][3] = 4 * a.gx[n * a.S + s];
        fetch_windows(w.win[n], a, n, s, r, c, iy0, ix0, lane);
      }
      cp_async_commit();
    }
  }

  // the source as bytes: the lane's luma 8 in registers and shared
  // memory, its chroma 4 of plane lane / 16 in shared memory
  uint2 src;
  {
    const int32_t* ys =
        a.y + (size_t)s * H * W + (size_t)(16 * r + row) * W + 16 * c + col;
    src = make_uint2(pack4(ld4(ys)), pack4(ld4(ys + 4)));
    w.src[2 * lane] = src.x, w.src[2 * lane + 1] = src.y;
    const int32_t* cs = (lane >> 4 ? a.v : a.u) + (size_t)s * Hc * Wc +
                        (size_t)(8 * r + crow) * Wc + 8 * c + ccol;
    (lane >> 4 ? w.sv : w.su)[lane & 15] = pack4(ld4(cs));
  }

  int best_cost = 0, best_mvx = 0, best_mvy = 0, best_sad = 0, best_ref = 0;
  int best_iy0 = 0, best_ix0 = 0, best_buf = 0;
  if constexpr (kT8) {
    for (int n = 0, cur = 0; n < a.N; ++n, cur = best_buf ^ 1) {
      int iy0, ix0, gqy, gqx;
      if (n < 2) {  // in flight in slot n since the warp's start
        iy0 = w.ref01[n][0], ix0 = w.ref01[n][1];
        gqy = w.ref01[n][2], gqx = w.ref01[n][3];
        if (n == 0)
          cp_async_wait<1>();
        else
          cp_async_wait<0>();
      } else {
        // reference n's windows go to the slot the best so far is not in
        const size_t am = (size_t)n * mbs + m;
        iy0 = a.iy0[am], ix0 = a.ix0[am];
        gqy = 4 * a.gy[n * a.S + s], gqx = 4 * a.gx[n * a.S + s];
        __syncwarp();  // the reads of the windows there are done
        fetch_windows(w.win[cur], a, n, s, r, c, iy0, ix0, lane);
        cp_async_commit();
        cp_async_wait<0>();
      }
      __syncwarp();  // every lane's copies and stores of the slot
      const Refined b =
          refine(w.win[cur], (16 * c + ix0 - 2 + a.pe) & 3, src, iy0, ix0,
                 gqy, gqx, a.lam, row, col);
      const int cost = b.cost + a.ref_cost[n];
      if (n == 0 || cost < best_cost) {
        best_cost = cost, best_mvx = b.mvx, best_mvy = b.mvy;
        best_sad = b.sad, best_ref = n, best_iy0 = iy0, best_ix0 = ix0;
        best_buf = cur;
      }
    }
  } else {
    for (int n = 0, cur = 0; n < a.N; ++n, cur = best_buf ^ 1) {
      // reference n's windows go to the buffer the best so far is not in
      const size_t am = (size_t)n * mbs + m;
      const int iy0 = a.iy0[am], ix0 = a.ix0[am];
      const int gqy = 4 * a.gy[n * a.S + s], gqx = 4 * a.gx[n * a.S + s];
      const uint32_t* win = w.win[cur];
      __syncwarp();  // the reads of the windows there are done
      load_windows(w.win[cur], a.pl[n] + lso, lstride, 16 * r + iy0 - 2 + a.pe,
                   16 * c + ix0 - 2 + a.pe, a.Hp, a.Wp, a.lp, lane);
      __syncwarp();

      // stage B: 3x3 full-pel refine on G, raster order, strict <
      int sad[9];
  #pragma unroll
      for (int k = 0; k < 9; ++k)
        sad[k] = (int)sad8(src, win8(win, 0, 1 + k / 3 + row, 1 + k % 3 + col));
  #pragma unroll
      for (int k = 0; k < 9; ++k) sad[k] = (int)__reduce_add_sync(kFull, sad[k]);
      int cost = 0, iy = 0, ix = 0, bsad = 0;
  #pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int my = iy0 - kRefine + k / 3, mx = ix0 - kRefine + k % 3;
        const int cand = sad[k] + a.lam * rate_q(4 * mx - gqx, 4 * my - gqy);
        if (k == 0 || cand < cost) cost = cand, iy = my, ix = mx, bsad = sad[k];
      }

      // stage C: the half-pel positions around (iy, ix), OFFSETS_HALF
      // order; the centre is stage B's winner.  Stage D: the quarter-pel
      // positions around the half-pel winner, OFFSETS_QUARTER order.
      const int oy = 2 + iy - iy0, ox = 2 + ix - ix0;  // (iy, ix) in the window
      int by = 0, bx = 0;
  #pragma unroll
      for (int half = 1; half >= 0; --half) {
        const int step = half ? 2 : 1, base_y = by, base_x = bx;
  #pragma unroll
        for (int k = 0; k < 8; ++k)
          sad[k] = (int)sad8(src, qpel8(win, oy, ox,
                                        base_y + step * (ring(k) / 3 - 1),
                                        base_x + step * (ring(k) % 3 - 1), row,
                                        col));
  #pragma unroll
        for (int k = 0; k < 8; ++k)
          sad[k] = (int)__reduce_add_sync(kFull, sad[k]);
  #pragma unroll
        for (int k = 0; k < 8; ++k) {
          const int py = base_y + step * (ring(k) / 3 - 1);
          const int px = base_x + step * (ring(k) % 3 - 1);
          const int cand =
              sad[k] + a.lam * rate_q(4 * ix + px - gqx, 4 * iy + py - gqy);
          if (cand < cost) cost = cand, by = py, bx = px, bsad = sad[k];
        }
      }
      cost += a.ref_cost[n];
      if (n == 0 || cost < best_cost) {
        best_cost = cost, best_mvx = 4 * ix + bx, best_mvy = 4 * iy + by;
        best_sad = bsad, best_ref = n, best_iy0 = iy0, best_ix0 = ix0;
        best_buf = cur;
      }
    }
  }

  // motion compensation from the chosen reference: luma from its
  // windows, chroma four samples a lane from plane lane / 16 (the t8
  // route: from its windows too)
  const int mvx = best_mvx, mvy = best_mvy;
  // the mvds' hand-off: lane 0 exchanges the final vector into its two
  // pairs' slots now, so that the round trips pass during MC and the
  // transforms; what it found is used at the end
  unsigned long long got_l = 0, got_r = 0;
  if (a.mvdx && lane == 0) {
    const unsigned long long word = mvd_word(mvx, mvy);
    if (c > 0) got_l = atomicExch(a.pairs + m, word);
    if (c + 1 < a.C) got_r = atomicExch(a.pairs + m + 1, word);
  }
  if constexpr (kT8) {
    const uint32_t* sl = w.win[best_buf];
    const uint2 p = qpel8p(
        sl, 2 - best_iy0, 2 - best_ix0 + ((16 * c + best_ix0 - 2 + a.pe) & 3),
        mvy, mvx, qpel_pair((mvy & 3) * 4 + (mvx & 3)), row, col);
    w.pred[2 * lane] = p.x, w.pred[2 * lane + 1] = p.y;
    const int cy = (4 * best_iy0 - 7) >> 3, cx = (4 * best_ix0 - 7) >> 3;
    (lane >> 4 ? w.pv : w.pu)[lane & 15] = mc_chroma4_win<kCRowW>(
        sl + kChromaW + (lane >> 4) * kCWin * kCRowW, (mvy >> 3) - cy,
        (mvx >> 3) - cx + ((8 * c + cx + a.cp) & 3), mvx & 7, mvy & 7, crow,
        ccol);
  } else {
    const uint2 p = qpel8(w.win[best_buf], 2 - best_iy0, 2 - best_ix0, mvy,
                          mvx, row, col);
    w.pred[2 * lane] = p.x, w.pred[2 * lane + 1] = p.y;
    const int y8 = 8 * r + (mvy >> 3) + a.cp, x8 = 8 * c + (mvx >> 3) + a.cp;
    const bool inside =
        y8 >= 0 && x8 >= 0 && y8 + 9 <= a.Hcp && x8 + 9 <= a.Wcp;
    const uint8_t* cref = (lane >> 4 ? a.pv : a.pu)[best_ref] + cso;
    (lane >> 4 ? w.pv : w.pu)[lane & 15] =
        mc_chroma4(cref, a.Hcp, a.Wcp, a.cpitch, y8, x8, mvx & 7, mvy & 7,
                   crow, ccol, inside);
  }
  __syncwarp();

  // the transforms: lanes 0-15 luma block lane (raster by * 4 + bx),
  // lanes 16-23 chroma block (lane - 16) & 3 of plane (lane - 16) >> 2
  const bool luma = lane < 16, chroma = lane >= 16 && lane < 24;
  const int cl = lane - 16, cpl = cl >> 2, cb = cl & 3;
  const int by = luma ? lane >> 2 : cb >> 1, bx = luma ? lane & 3 : cb & 1;
  const Quant Q = quantiser_inter(luma ? a.qp : a.qpc);  // the lane's plane's
  // the block's source and prediction words, a row a word
  const uint32_t* sw = luma ? w.src : cpl ? w.sv : w.su;
  const uint32_t* pp = luma ? w.pred : cpl ? w.pv : w.pu;
  const int o0 = 4 * by * (luma ? 4 : 2) + bx, wpr = luma ? 4 : 2;
  int x[16];  // the coefficients, then their dequantised levels
  bool nz_ac = false;
  int rate4 = 0;          // kT8: the block's `_rate_bits`
  uint32_t lkeep[2][4];   // kT8: its levels, stored once the choice is made
  if (luma || chroma) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t sword = sw[o0 + i * wpr], pword = pp[o0 + i * wpr];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        x[4 * i + j] = byte_of(sword, j) - byte_of(pword, j);
    }
    fwd4(x);
    // each coefficient quantised in zigzag order, its level stored (luma:
    // two a word, 16 bytes at a time; chroma AC: staged in shared memory)
    // and dequantised in place; the chroma DC goes through the Hadamard
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      uint32_t lw[4] = {};
#pragma unroll
      for (int k = 8 * half; k < 8 * half + 8; ++k) {
        const int i = zz(k), cls = pos_class(i);
        if (chroma && k == 0) {
          w.cdc[cpl][cb] = x[0];
          continue;
        }
        const int lv = q_ac(Q, x[i], cls);
        nz_ac |= lv != 0;
        if constexpr (kT8) rate4 += rate_bits(lv);
        if (luma)
          lw[(k >> 1) & 3] |= (uint32_t)(uint16_t)lv << (16 * (k & 1));
        else
          w.cac[60 * cpl + 15 * cb + k - 1] = (int16_t)lv;
        x[i] = dq_ac(Q, lv, cls);
      }
      if constexpr (kT8) {
#pragma unroll
        for (int j = 0; j < 4; ++j) lkeep[half][j] = lw[j];
      } else if (luma) {
        reinterpret_cast<int4*>(a.luma_ac + (size_t)m * 256 + 16 * lane)[half] =
            make_int4((int)lw[0], (int)lw[1], (int)lw[2], (int)lw[3]);
      }
    }
  }
  __syncwarp();
  int dcq = 0;
  if (chroma) w.cdq[cpl][cb] = dcq = q_cdc(Q, had2(w.cdc[cpl], cb));
  __syncwarp();
  // the chroma levels out, 16 bytes a lane: AC [2,4,15], DC [2,4]
  if (lane < 15)
    reinterpret_cast<int4*>(a.chroma_ac + (size_t)m * 120)[lane] =
        reinterpret_cast<const int4*>(w.cac)[lane];
  else if (lane == 15)
    *reinterpret_cast<int4*>(a.chroma_dc + (size_t)m * 8) = make_int4(
        (int)pack16(w.cdq[0][0], w.cdq[0][1]), (int)pack16(w.cdq[0][2], w.cdq[0][3]),
        (int)pack16(w.cdq[1][0], w.cdq[1][1]), (int)pack16(w.cdq[1][2], w.cdq[1][3]));
  const unsigned nzl = __ballot_sync(kFull, luma && nz_ac);
  const unsigned anyac = __ballot_sync(kFull, chroma && nz_ac);
  const unsigned anydc = __ballot_sync(kFull, chroma && dcq != 0);
  int cbp_l = ((nzl & 0x33u) ? 1 : 0) | ((nzl & 0xCCu) ? 2 : 0) |
              ((nzl & 0x3300u) ? 4 : 0) | ((nzl & 0xCC00u) ? 8 : 0);
  const int cbp_c = anyac ? 2 : anydc ? 1 : 0;

  // the reconstruction: uncoded 8x8 groups' and chroma's cbp-masked
  // levels dropped, dequantised, inverse transformed, added, clipped
  if (luma || chroma) {
    if (luma) {
      const bool coded = (cbp_l >> (((by >> 1) << 1) | (bx >> 1))) & 1;
#pragma unroll
      for (int i = 0; i < 16; ++i) x[i] = coded ? x[i] : 0;
    } else {
#pragma unroll
      for (int i = 1; i < 16; ++i) x[i] = cbp_c == 2 ? x[i] : 0;
      x[0] = cbp_c >= 1 ? dq_cdc(Q, had2(w.cdq[cpl], cb)) : 0;
    }
    const uint32_t pw[4] = {pp[o0], pp[o0 + wpr], pp[o0 + 2 * wpr],
                            pp[o0 + 3 * wpr]};
    inv4_add(x, pw);
  }
  int use8 = 0;  // the t8 symbol before P_Skip
  if constexpr (kT8) {
    // the 4x4 coding's J (8 SSD of its recon + lam8 rate of its levels)
    // against the 8x8 trial's: the 8x8 coding wins when strictly cheaper
    // and it codes a level; it then takes the cbp, recon and levels
    int ssd4 = 0;
    if (luma) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int d = x[i] - byte_of(sw[o0 + (i >> 2) * wpr], i & 3);
        ssd4 += d * d;
      }
    }
    const int j4 =
        8 * (int)__reduce_add_sync(kFull, (unsigned)ssd4) +
        a.lam8 * (int)__reduce_add_sync(kFull, luma ? (unsigned)rate4 : 0u);
    int* const t8m = reinterpret_cast<int*>(&w.win[0][0]);
    const Trial8 t = trial8(w, t8m, a.qp, a.lam8, lane);
    use8 = t.j8 < j4 && t.cbp8 > 0;
    __syncwarp();  // the trial's levels and recon, from every lane
    if (use8) {
      cbp_l = t.cbp8;
      if (luma) {
#pragma unroll
        for (int i = 0; i < 16; ++i)
          x[i] = t8m[kT8Rec + 16 * (4 * by + (i >> 2)) + 4 * bx + (i & 3)];
      }
      // the levels' row lane / 2 of [16, 16], half lane & 1: block blk's
      // 64 zigzag levels in raster block order (zz8.reshape(4, 64))
      const int blk = lane >> 3;
      const uint64_t zr = kZz8Row[lane & 7];  // levels 8 (lane & 7) ..
      const int* zb = t8m + kT8Lev + 64 * blk;
      uint32_t lw[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        lw[j] = pack16(zb[(zr >> (16 * j)) & 63],
                       zb[(zr >> (16 * j + 8)) & 63]);
      reinterpret_cast<int4*>(a.luma_ac + (size_t)m * 256)[lane] =
          make_int4((int)lw[0], (int)lw[1], (int)lw[2], (int)lw[3]);
    } else if (luma) {
#pragma unroll
      for (int half = 0; half < 2; ++half)
        reinterpret_cast<int4*>(a.luma_ac + (size_t)m * 256 + 16 * lane)[half] =
            make_int4((int)lkeep[half][0], (int)lkeep[half][1],
                      (int)lkeep[half][2], (int)lkeep[half][3]);
    }
  }
  if (luma || chroma) {
    const int n = luma ? 16 : 8;
    if (a.mb_out) {
      int32_t* o = static_cast<int32_t*>(luma ? a.ry : cpl ? a.rv : a.ru) +
                   (size_t)m * n * n + 4 * bx;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<int4*>(o + (4 * by + i) * n) =
            make_int4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    } else {
      const int pw_ = luma ? W : Wc, ph = luma ? H : Hc;
      uint8_t* o = static_cast<uint8_t*>(luma ? a.ry : cpl ? a.rv : a.ru) +
                   (size_t)s * ph * pw_ + (size_t)(n * r + 4 * by) * pw_ +
                   n * c + 4 * bx;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<uint32_t*>(o + (size_t)i * pw_) = pack_bytes(
            x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
    }
  }
  if (lane == 0) {
    const bool skip = cbp_l == 0 && cbp_c == 0 && mvx == 0 && mvy == 0 &&
                      best_ref + a.ref_base == 0;
    a.mvx[m] = mvx, a.mvy[m] = mvy, a.refsel[m] = best_ref;
    a.sad[m] = best_sad, a.kind[m] = skip ? 0 : 1;
    a.refidx[m] = skip ? 0 : best_ref + a.ref_base;
    a.cbp_l[m] = cbp_l, a.cbp_c[m] = cbp_c;
    if (a.mode) a.mode[m] = 0, a.cmode[m] = 0;
    if (a.t8) a.t8[m] = skip ? 0 : use8;
    if (a.mvdx) {  // column 0's mvd is its vector; the others' by pairs
      if (c == 0) a.mvdx[m] = mvx, a.mvdy[m] = mvy;
      mvd_finish(a, m, got_l, mvx, mvy, true);
      mvd_finish(a, m + 1, got_r, mvx, mvy, false);
    }
  }
  if (a.luma_dc && lane < 2)
    reinterpret_cast<int4*>(a.luma_dc + (size_t)m * 16)[lane] =
        make_int4(0, 0, 0, 0);
}

}  // namespace

#ifdef __CUDACC__  // the entry; tests/test_torch_pframe_kernel.py runs the
                   // rest above on CPU threads, compiled by g++ against
                   // shims

// p: kPtrs device pointers, n: kInts ints, in `enc_args`' order (host
// arrays); one warp a MB of the S * R * C.
extern "C" int th264_pframe_encode(void* const* p, const int* n,
                                   void* stream) {
  const EncArgs a = enc_args(p, n);
  const int mbs = a.S * a.R * a.C;
  const int blocks = (mbs + kWarps - 1) / kWarps;
  if (a.t8on)
    pframe_encode_kernel<true>
        <<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(a);
  else
    pframe_encode_kernel<false>
        <<<blocks, 32 * kWarps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// The warps an SM of each route that can be resident at once, out[0]
// without t8, out[1] the t8 route (the runtime's occupancy of their
// launches); returns the CUDA error.
extern "C" int th264_pframe_encode_resident(int* out) {
  int b[2];
  cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &b[0], pframe_encode_kernel<false>, 32 * kWarps, 0);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &b[1], pframe_encode_kernel<true>, 32 * kWarps, 0);
  out[0] = b[0] * kWarps, out[1] = b[1] * kWarps;
  return (int)e;
}

#endif  // __CUDACC__
