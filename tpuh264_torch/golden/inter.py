# Copy of tpuh264/golden/inter.py, so that the port imports nothing of tpuh264.
"""Inter prediction: MV prediction, motion search, motion compensation
(H.264 8.4) -- numpy oracle, integer-pel motion this round.

The search procedure is part of the *shared* encoder definition: the TPU
scan (kernels/pframe.py) must make bit-identical decisions, so the
candidate patterns, clamps and tie-breaks here are normative for us
(fixed-iteration masked search -- SURVEY.md section 7, hard part 4).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

# integer-pel search geometry (shared with the TPU kernels)
SEARCH_RANGE = 8          # stage-A full-search radius, integer pels
REFINE_RANGE = 1          # stage-B full-resolution refine radius, pels
SEARCH_PAD = 12           # reference padding needed (9 + subpel + margin)

# Motion cost: the search minimizes SAD + lambda*rate(mv), the standard
# rate-biased criterion (ties on flat content then resolve toward the
# zero vector, keeping P_Skip reachable, and the MV field stays cheap to
# code).  The rate proxy is the exact ue(v) length of 2*|v| -- an upper
# bound of the se(v) mvd bits against a zero predictor.  Integer-only so
# the TPU kernels reproduce decisions bit-exactly.  The scale is the
# standard SAD-domain lambda sqrt(0.85 * 2^((qp-12)/3)) ~ 2^((qp-12)/6);
# anything much larger stops the search from following real motion at
# high QP (the residual then costs far more than the mvd saved).
REF_COHERENCE_BITS = 2


def ref_idx_bits(ri: int, nra: int) -> int:
    """Bits of ref_idx_l0 as te(v) with cMax = nra-1 (7.3.5.1): the
    rate term of the per-MB reference choice.  Selecting a non-zero
    reference also breaks P_Skip eligibility (8.4.1.1), so an unbiased
    selection at high QP trades a few SAD points for a per-MB overhead
    floor -- the round-5 multi-ref RC finding (BENCH_NOTES)."""
    # REF_COHERENCE_BITS: beyond the te(v) bits, non-zero references
    # carry a small fixed penalty.  For nra == 2 the te bits are 1 for
    # BOTH indices (non-differential), yet choosing ref 1 forfeits
    # P_Skip eligibility (8.4.1.1) and decorrelates the left-neighbor
    # MV prediction chain -- measured at QP 45 the unbiased selection
    # flips 21% of MBs to ref 1 for noise-level SAD gains and sets a
    # per-MB mvd-overhead floor (BENCH_NOTES round 5).  +2 bits keeps
    # genuinely better references reachable (cuts churn to ~5%).
    extra = REF_COHERENCE_BITS if ri > 0 else 0
    if nra <= 1:
        return extra
    if nra == 2:
        return 1 + extra
    return 2 * (ri + 1).bit_length() - 1 + extra


LAMBDA_ME = [max(1, int(0.92 * 2.0 ** ((q - 12) / 6.0)))
             for q in range(52)]


def mv_rate_bits(vx_q: int, vy_q: int) -> int:
    """ue(2|v|) bit length summed over both quarter-pel components."""

    def one(v):
        return 2 * int(2 * abs(v) + 1).bit_length() - 1

    return one(vx_q) + one(vy_q)

MB_INTRA = 2
MB_INTER = 1
MB_SKIP = 0


def median3(a: int, b: int, c: int) -> int:
    return int(np.median([a, b, c]))


def predict_mv(
    mv: np.ndarray,         # [mbh, mbw, 2] stored MVs (quarter-pel)
    kind: np.ndarray,       # [mbh, mbw] MB_SKIP/MB_INTER/MB_INTRA
    slice_id: np.ndarray,   # [mbh, mbw], -1 = not yet decoded
    mbx: int,
    mby: int,
    sid: int,
    refidx: Optional[np.ndarray] = None,  # [mbh, mbw] per-MB refIdxL0
    cur_ref: int = 0,
) -> Tuple[int, int]:
    """Median MV prediction (H.264 8.4.1.3) for 16x16 partitions.

    With `refidx` absent every inter neighbor counts as refIdxL0 == 0
    (the single-reference behavior)."""
    mbw = mv.shape[1]

    def navail(x: int, y: int) -> bool:
        return 0 <= x < mbw and y >= 0 and slice_id[y, x] == sid

    a_ok = navail(mbx - 1, mby)
    b_ok = navail(mbx, mby - 1)
    c_ok = navail(mbx + 1, mby - 1)
    cx, cy = (mbx + 1, mby - 1)
    if not c_ok:  # substitute D (top-left)
        cx, cy = (mbx - 1, mby - 1)
        c_ok = navail(cx, cy)

    def mv_ref(ok: bool, x: int, y: int):
        if not ok:
            return (0, 0), -1
        if kind[y, x] == MB_INTRA:
            return (0, 0), -1
        r = 0 if refidx is None else int(refidx[y, x])
        return (int(mv[y, x, 0]), int(mv[y, x, 1])), r

    mva, refa = mv_ref(a_ok, mbx - 1, mby)
    mvb, refb = mv_ref(b_ok, mbx, mby - 1)
    mvc, refc = mv_ref(c_ok, cx, cy)

    if not b_ok and not c_ok and a_ok:
        return mva
    matches = [
        m for m, r in ((mva, refa), (mvb, refb), (mvc, refc)) if r == cur_ref
    ]
    if len(matches) == 1:
        return matches[0]
    return (
        median3(mva[0], mvb[0], mvc[0]),
        median3(mva[1], mvb[1], mvc[1]),
    )


def skip_mv(
    mv: np.ndarray, kind: np.ndarray, slice_id: np.ndarray,
    mbx: int, mby: int, sid: int,
    refidx: Optional[np.ndarray] = None,
) -> Tuple[int, int]:
    """P_Skip motion vector (H.264 8.4.1.1); P_Skip references index 0."""
    mbw = mv.shape[1]

    def navail(x: int, y: int) -> bool:
        return 0 <= x < mbw and y >= 0 and slice_id[y, x] == sid

    a_ok = navail(mbx - 1, mby)
    b_ok = navail(mbx, mby - 1)
    if not a_ok or not b_ok:
        return (0, 0)
    for x, y, ok in ((mbx - 1, mby, a_ok), (mbx, mby - 1, b_ok)):
        r = (
            -1 if kind[y, x] == MB_INTRA
            else (0 if refidx is None else int(refidx[y, x]))
        )
        if r == 0 and mv[y, x, 0] == 0 and mv[y, x, 1] == 0:
            return (0, 0)
    return predict_mv(mv, kind, slice_id, mbx, mby, sid, refidx, 0)


def mc_luma(ref: np.ndarray, mbx: int, mby: int, mvx_q: int, mvy_q: int) -> np.ndarray:
    """Integer-pel luma MC with edge clamping (8.4.2.2.1 Clip3 reads)."""
    assert mvx_q % 4 == 0 and mvy_q % 4 == 0, "integer-pel only this round"
    h, w = ref.shape
    x0 = 16 * mbx + mvx_q // 4
    y0 = 16 * mby + mvy_q // 4
    xs = np.clip(np.arange(x0, x0 + 16), 0, w - 1)
    ys = np.clip(np.arange(y0, y0 + 16), 0, h - 1)
    return ref[np.ix_(ys, xs)].astype(np.int32)


def mc_chroma(ref: np.ndarray, mbx: int, mby: int, mvx_q: int, mvy_q: int) -> np.ndarray:
    """Chroma MC for 4:2:0 (8.4.2.2.2): eighth-pel bilinear; with integer
    luma MVs the fractions are 0 or 4."""
    h, w = ref.shape
    x_int = 8 * mbx + (mvx_q >> 3)
    y_int = 8 * mby + (mvy_q >> 3)
    xf = mvx_q & 7
    yf = mvy_q & 7
    xs0 = np.clip(np.arange(x_int, x_int + 8), 0, w - 1)
    xs1 = np.clip(np.arange(x_int, x_int + 8) + 1, 0, w - 1)
    ys0 = np.clip(np.arange(y_int, y_int + 8), 0, h - 1)
    ys1 = np.clip(np.arange(y_int, y_int + 8) + 1, 0, h - 1)
    a = ref[np.ix_(ys0, xs0)].astype(np.int64)
    b = ref[np.ix_(ys0, xs1)].astype(np.int64)
    c = ref[np.ix_(ys1, xs0)].astype(np.int64)
    d = ref[np.ix_(ys1, xs1)].astype(np.int64)
    out = (
        (8 - xf) * (8 - yf) * a
        + xf * (8 - yf) * b
        + (8 - xf) * yf * c
        + xf * yf * d
        + 32
    ) >> 6
    return out.astype(np.int32)


def stage_a_sads(src_mb: np.ndarray, ref: np.ndarray, mbx: int, mby: int
                 ) -> np.ndarray:
    """Stage-A SAD table: stride-2 SAD at every integer offset of the
    +-SEARCH_RANGE grid, raster order (dy outer) -> [n*n]."""
    n = 2 * SEARCH_RANGE + 1
    out = np.empty(n * n, np.int32)
    i = 0
    for dy in range(-SEARCH_RANGE, SEARCH_RANGE + 1):
        for dx in range(-SEARCH_RANGE, SEARCH_RANGE + 1):
            win = mc_luma(ref, mbx, mby, 4 * dx, 4 * dy)
            out[i] = np.abs(src_mb[::2, ::2] - win[::2, ::2]).sum()
            i += 1
    return out


def global_mv(y: np.ndarray, ref: np.ndarray, qp: int) -> Tuple[int, int]:
    """Per-frame dominant integer MV (gy, gx) in pels.

    Phase 1 of the coherent-field search: every MB's stage-A winner
    under the zero-anchored rate bias, then the MODE over the frame
    (ties -> the raster-earliest candidate).  MV-rate in the actual
    search is then measured relative to this global vector, so near-tie
    MBs on panning content all land on the SAME vector and the mvd
    field costs ~nothing -- the parallel-encoder substitute for
    predictor-centered search (which would chain MBs sequentially)."""
    lam = LAMBDA_ME[min(max(qp, 0), 51)]
    n = 2 * SEARCH_RANGE + 1
    mbh, mbw = y.shape[0] // 16, y.shape[1] // 16
    r0 = np.asarray(
        [mv_rate_bits(4 * dx, 4 * dy)
         for dy in range(-SEARCH_RANGE, SEARCH_RANGE + 1)
         for dx in range(-SEARCH_RANGE, SEARCH_RANGE + 1)],
        np.int64,
    )
    counts = np.zeros(n * n, np.int64)
    for mby in range(mbh):
        for mbx in range(mbw):
            sads = stage_a_sads(
                y[16 * mby : 16 * mby + 16, 16 * mbx : 16 * mbx + 16],
                ref, mbx, mby,
            )
            counts[int(np.argmin(4 * sads.astype(np.int64) + lam * r0))] += 1
    g = int(np.argmax(counts))  # first max = raster-earliest
    return g // n - SEARCH_RANGE, g % n - SEARCH_RANGE


def motion_search(
    src_mb: np.ndarray,  # [16,16] current MB
    ref: np.ndarray,     # full reference luma plane
    mbx: int,
    mby: int,
    qp: int,
    gmv: Tuple[int, int] = (0, 0),  # (gy, gx) integer pels
) -> Tuple[int, int, int, int]:
    """Integer motion search: exhaustive stage A + full-res refine.

    Stage A: SAD over the full +-SEARCH_RANGE grid on the stride-2
    subsample (the TPU kernel evaluates the same field as shifted-plane
    slices), scaled x4 to stay commensurable with the full-resolution
    stages; the MV-rate bias is measured relative to the frame's global
    vector `gmv` (see global_mv).  Stage B: a 3x3 full-resolution
    refine around the stage-A winner.  Candidates enumerate in raster
    order (dy outer) with strict-< selection, so ties break toward the
    earlier candidate.  Returns (mvx_q, mvy_q, sad, cost): full-res SAD
    and rate-biased cost of the winner, MV in quarter-pel units.
    """
    lam = LAMBDA_ME[min(max(qp, 0), 51)]
    gy, gx = gmv
    best = None  # (cost, dy, dx)
    for dy in range(-SEARCH_RANGE, SEARCH_RANGE + 1):
        for dx in range(-SEARCH_RANGE, SEARCH_RANGE + 1):
            win = mc_luma(ref, mbx, mby, 4 * dx, 4 * dy)
            s = int(np.abs(src_mb[::2, ::2] - win[::2, ::2]).sum())
            cost = 4 * s + lam * mv_rate_bits(4 * (dx - gx), 4 * (dy - gy))
            if best is None or cost < best[0]:
                best = (cost, dy, dx)
    _, cy, cx = best
    best = None  # (cost, sad, dy, dx)
    for oy in range(-REFINE_RANGE, REFINE_RANGE + 1):
        for ox in range(-REFINE_RANGE, REFINE_RANGE + 1):
            dy, dx = cy + oy, cx + ox
            win = mc_luma(ref, mbx, mby, 4 * dx, 4 * dy)
            s = int(np.abs(src_mb - win).sum())
            cost = s + lam * mv_rate_bits(4 * (dx - gx), 4 * (dy - gy))
            if best is None or cost < best[0]:
                best = (cost, s, dy, dx)
    cost, s, by, bx = best
    return 4 * bx, 4 * by, s, cost


# ---------------------------------------------------------------------------
# Quarter-pel motion (H.264 8.4.2.2.1): normative 6-tap half-pel planes +
# quarter-sample averaging.  The 4-plane formulation below is shared with
# the TPU kernels (kernels/pframe.py) -- identical construction, identical
# candidate schedules.
# ---------------------------------------------------------------------------

def _tap6(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


def build_halfpel_planes(ref: np.ndarray, pad: int = SEARCH_PAD):
    """Edge-pad `ref` by pad+3 and build (G, b, h, j) planes, each
    [H+2p, W+2p] aligned so index (y, x) is the sample at integer (y, x)
    of the padded-by-`pad` grid.

    b(y,x) = half-sample at (y, x+1/2); h = (y+1/2, x); j = (y+1/2, x+1/2).
    """
    # effective pad is pad+1: quarter positions average with +1-offset
    # neighbors, so the extreme MV reach is pad integer samples plus one
    p_eff = pad + 1
    p3 = p_eff + 3
    r = np.pad(ref.astype(np.int64), p3, mode="edge")
    # horizontal intermediate b1 at (y, x+1/2): taps x-2..x+3
    b1 = _tap6(r[:, :-5], r[:, 1:-4], r[:, 2:-3], r[:, 3:-2], r[:, 4:-1],
               r[:, 5:])  # [H+2p3, W+2p3-5]
    # vertical intermediate h1 at (y+1/2, x): taps y-2..y+3
    h1 = _tap6(r[:-5, :], r[1:-4, :], r[2:-3, :], r[3:-2, :], r[4:-1, :],
               r[5:, :])
    # j1: vertical 6-tap over b1
    j1 = _tap6(b1[:-5, :], b1[1:-4, :], b1[2:-3, :], b1[3:-2, :],
               b1[4:-1, :], b1[5:, :])
    # align to the padded-by-`pad` grid: drop the 3-sample margins
    g_p = r[3:-3, 3:-3]
    b_p = np.clip((b1[3:-3, 1:] + 16) >> 5, 0, 255)
    h_p = np.clip((h1[1:, 3:-3] + 16) >> 5, 0, 255)
    j_p = np.clip((j1[1:, 1:] + 512) >> 10, 0, 255)
    hp2 = 2 * p_eff
    out = []
    for pl in (g_p, b_p, h_p, j_p):
        out.append(pl[: ref.shape[0] + hp2, : ref.shape[1] + hp2].astype(np.int32))
    return tuple(out)


# component table: (comp1, comp2) per (xf, yf); components are
# 0:G00 1:b00 2:h00 3:j00 4:G10 5:G01 6:b01 7:h10
QPEL_TBL = {
    (0, 0): (0, 0), (1, 0): (0, 1), (2, 0): (1, 1), (3, 0): (1, 4),
    (0, 1): (0, 2), (1, 1): (1, 2), (2, 1): (1, 3), (3, 1): (1, 7),
    (0, 2): (2, 2), (1, 2): (2, 3), (2, 2): (3, 3), (3, 2): (3, 7),
    (0, 3): (2, 5), (1, 3): (2, 6), (2, 3): (3, 6), (3, 3): (7, 6),
}


def mc_luma_qpel(
    planes, mbx: int, mby: int, mvx_q: int, mvy_q: int, pad: int = SEARCH_PAD
) -> np.ndarray:
    """Quarter-pel luma MC from precomputed half-pel planes."""
    g, b, h, j = planes
    x_int = mvx_q >> 2
    y_int = mvy_q >> 2
    xf = mvx_q & 3
    yf = mvy_q & 3
    y0 = 16 * mby + y_int + pad + 1
    x0 = 16 * mbx + x_int + pad + 1

    def win(pl, dy, dx):
        return pl[y0 + dy : y0 + dy + 16, x0 + dx : x0 + dx + 16]

    comps = {
        0: lambda: win(g, 0, 0), 1: lambda: win(b, 0, 0),
        2: lambda: win(h, 0, 0), 3: lambda: win(j, 0, 0),
        4: lambda: win(g, 0, 1), 5: lambda: win(g, 1, 0),
        6: lambda: win(b, 1, 0), 7: lambda: win(h, 0, 1),
    }
    c1, c2 = QPEL_TBL[(xf, yf)]
    a = comps[c1]().astype(np.int32)
    bb = comps[c2]().astype(np.int32)
    return (a + bb + 1) >> 1


OFFSETS_HALF = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
OFFSETS_QUARTER = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]


def motion_search_qpel(
    src_mb: np.ndarray,
    ref: np.ndarray,
    planes,
    mbx: int,
    mby: int,
    qp: int,
    gmv: Tuple[int, int] = (0, 0),
):
    """Integer search (motion_search) + half then quarter refinement.

    Subpel candidates minimize the same rate-biased cost as the integer
    stages (rate relative to the frame's global vector); all candidate
    orders/tie-breaks are shared with the TPU kernel (strict <,
    OFFSETS_HALF then OFFSETS_QUARTER raster order).
    Returns (mvx_q, mvy_q, sad, cost).
    """
    lam = LAMBDA_ME[min(max(qp, 0), 51)]
    gy, gx = gmv
    mvx, mvy, best_sad, best_cost = motion_search(
        src_mb, ref, mbx, mby, qp, gmv
    )
    best = (mvy, mvx)
    for offsets in (OFFSETS_HALF, OFFSETS_QUARTER):
        base = best
        for dy, dx in offsets:
            if (dy, dx) == (0, 0):
                continue
            cand = (base[0] + dy, base[1] + dx)
            pred = mc_luma_qpel(planes, mbx, mby, cand[1], cand[0])
            s = int(np.abs(src_mb - pred).sum())
            cost = s + lam * mv_rate_bits(cand[1] - 4 * gx, cand[0] - 4 * gy)
            if cost < best_cost:
                best, best_sad, best_cost = cand, s, cost
    return best[1], best[0], best_sad, best_cost


# ---------------------------------------------------------------------------
# Block-granular inter tools for GENERAL streams (third-party decode).
#
# Our encoder emits 16x16-only partitions, but a real decoder must accept
# anything a baseline encoder may emit (the reference decodes arbitrary
# streams via DecodeFrameNoDelay, reference/openh264_wrapper.cpp:
# 391-422): P_L0_16x8 / 8x16 / 8x8 with 8x4/4x8/4x4 sub-partitions,
# per-partition reference indices, and MV prediction at 4x4-block
# granularity (H.264 8.4.1.3).  These helpers operate on 4x4-granular
# mv/ref/availability grids; for 16x16-only content they reduce exactly
# to predict_mv/skip_mv above (tests enforce round-trip bit-exactness).
# ---------------------------------------------------------------------------


def _mv_ref_b4(mv4, ref4, avail4, gx, gy, sid):
    """(mv, ref) of the 4x4 block at global block coords; unavailable or
    intra neighbors yield ((0,0), -1) per 8.4.1.3."""
    h4, w4 = ref4.shape
    if not (0 <= gx < w4 and 0 <= gy < h4) or avail4[gy, gx] != sid:
        return (0, 0), -1, False
    r = int(ref4[gy, gx])
    if r < 0:  # intra
        return (0, 0), -1, True
    return (int(mv4[gy, gx, 0]), int(mv4[gy, gx, 1])), r, True


def predict_mv_block(
    mv4, ref4, avail4, gx, gy, w4, h4, sid, cur_ref, special=None
):
    """Luma MV prediction for a partition at 4x4-block coords (gx, gy) of
    size (w4, h4) blocks (H.264 8.4.1.3).  `special` marks the
    directional exceptions: '16x8_top'/'16x8_bot'/'8x16_left'/
    '8x16_right'."""
    mva, refa, a_ok = _mv_ref_b4(mv4, ref4, avail4, gx - 1, gy, sid)
    mvb, refb, b_ok = _mv_ref_b4(mv4, ref4, avail4, gx, gy - 1, sid)
    mvc, refc, c_ok = _mv_ref_b4(mv4, ref4, avail4, gx + w4, gy - 1, sid)
    if not c_ok:  # substitute D (above-left)
        mvc, refc, c_ok = _mv_ref_b4(mv4, ref4, avail4, gx - 1, gy - 1, sid)

    if special == "16x8_top" and refb == cur_ref:
        return mvb
    if special == "16x8_bot" and refa == cur_ref:
        return mva
    if special == "8x16_left" and refa == cur_ref:
        return mva
    if special == "8x16_right" and refc == cur_ref:
        return mvc

    if not b_ok and not c_ok and a_ok:
        return mva
    matches = [
        m for m, r in ((mva, refa), (mvb, refb), (mvc, refc)) if r == cur_ref
    ]
    if len(matches) == 1:
        return matches[0]
    return (
        median3(mva[0], mvb[0], mvc[0]),
        median3(mva[1], mvb[1], mvc[1]),
    )


def skip_mv_block(mv4, ref4, avail4, gx, gy, sid):
    """P_Skip MV (8.4.1.1) with 4x4-granular neighbor state."""
    mva, refa, a_ok = _mv_ref_b4(mv4, ref4, avail4, gx - 1, gy, sid)
    mvb, refb, b_ok = _mv_ref_b4(mv4, ref4, avail4, gx, gy - 1, sid)
    if not a_ok or not b_ok:
        return (0, 0)
    if (refa == 0 and mva == (0, 0)) or (refb == 0 and mvb == (0, 0)):
        return (0, 0)
    return predict_mv_block(mv4, ref4, avail4, gx, gy, 4, 4, sid, 0)


def mc_luma_qpel_at(
    planes, px: int, py: int, w: int, h: int, mvx_q: int, mvy_q: int,
    pad: int = SEARCH_PAD,
) -> np.ndarray:
    """Quarter-pel luma MC of an arbitrary w x h block at pixel (px, py).

    Uses the same precomputed half-pel planes as mc_luma_qpel; MVs
    reaching beyond the padded planes are handled by clamping the read
    window (normative Clip3 sample addressing, 8.4.2.2.1)."""
    g, b, hh, j = planes
    x_int = mvx_q >> 2
    y_int = mvy_q >> 2
    xf = mvx_q & 3
    yf = mvy_q & 3
    ph, pw = g.shape

    def win(pl, dy, dx):
        ys = np.clip(
            np.arange(py + y_int + pad + 1 + dy,
                      py + y_int + pad + 1 + dy + h), 0, ph - 1)
        xs = np.clip(
            np.arange(px + x_int + pad + 1 + dx,
                      px + x_int + pad + 1 + dx + w), 0, pw - 1)
        return pl[np.ix_(ys, xs)]

    comps = {
        0: lambda: win(g, 0, 0), 1: lambda: win(b, 0, 0),
        2: lambda: win(hh, 0, 0), 3: lambda: win(j, 0, 0),
        4: lambda: win(g, 0, 1), 5: lambda: win(g, 1, 0),
        6: lambda: win(b, 1, 0), 7: lambda: win(hh, 0, 1),
    }
    c1, c2 = QPEL_TBL[(xf, yf)]
    a = comps[c1]().astype(np.int32)
    bb = comps[c2]().astype(np.int32)
    return (a + bb + 1) >> 1


def mc_chroma_at(
    ref: np.ndarray, px: int, py: int, w: int, h: int,
    mvx_q: int, mvy_q: int,
) -> np.ndarray:
    """Eighth-pel bilinear chroma MC of a w x h block at chroma pixel
    (px, py) (8.4.2.2.2)."""
    hh, ww = ref.shape
    x_int = px + (mvx_q >> 3)
    y_int = py + (mvy_q >> 3)
    xf = mvx_q & 7
    yf = mvy_q & 7
    xs0 = np.clip(np.arange(x_int, x_int + w), 0, ww - 1)
    xs1 = np.clip(np.arange(x_int, x_int + w) + 1, 0, ww - 1)
    ys0 = np.clip(np.arange(y_int, y_int + h), 0, hh - 1)
    ys1 = np.clip(np.arange(y_int, y_int + h) + 1, 0, hh - 1)
    a = ref[np.ix_(ys0, xs0)].astype(np.int64)
    b = ref[np.ix_(ys0, xs1)].astype(np.int64)
    c = ref[np.ix_(ys1, xs0)].astype(np.int64)
    d = ref[np.ix_(ys1, xs1)].astype(np.int64)
    out = (
        (8 - xf) * (8 - yf) * a + xf * (8 - yf) * b
        + (8 - xf) * yf * c + xf * yf * d + 32
    ) >> 6
    return out.astype(np.int32)
