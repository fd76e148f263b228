# Copy of tpuh264/golden/deblock.py, so that the port imports nothing of tpuh264.
"""In-loop deblocking filter (H.264 8.7) -- numpy oracle.

Applied as a post-pass over the reconstructed picture in MB raster order
(vertical edges left->right, then horizontal edges top->bottom per MB),
which matches the normative sample dependencies.  Intra prediction reads
the *unfiltered* reconstruction (the in-frame decode loop), while the
reference picture stored for inter prediction is the *filtered* one.

bS derivation uses 16x16-uniform macroblock state (our encoder has no
sub-partitions yet): intra MBs give bS 4 on MB edges / 3 internally;
otherwise coded 4x4 blocks give 2; MV differences >= 4 quarter-pel or a
reference change give 1.

disable_deblocking_filter_idc semantics: 0 = filter everything,
1 = off, 2 = do not cross slice boundaries (our row-slice mode).
"""

from __future__ import annotations

import numpy as np

from .transform import chroma_qp

ALPHA = np.array(
    [0] * 16
    + [4, 4, 5, 6, 7, 8, 9, 10, 12, 13, 15, 17, 20, 22, 25, 28, 32, 36,
       40, 45, 50, 56, 63, 71, 80, 90, 101, 113, 127, 144, 162, 182, 203,
       226, 255, 255],
    dtype=np.int32,
)
BETA = np.array(
    [0] * 16
    + [2, 2, 2, 3, 3, 3, 3, 4, 4, 4, 6, 6, 7, 7, 8, 8, 9, 9, 10, 10, 11,
       11, 12, 12, 13, 13, 14, 14, 15, 15, 16, 16, 17, 17, 18, 18],
    dtype=np.int32,
)
# Table 8-17: tc0 by (index_a, bS-1)
TC0 = np.array(
    [[0, 0, 0]] * 16
    + [
        [0, 0, 0], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 0, 1], [0, 1, 1],
        [0, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 1], [1, 1, 2],
        [1, 1, 2], [1, 1, 2], [1, 1, 2], [1, 2, 3], [1, 2, 3], [2, 2, 3],
        [2, 2, 4], [2, 3, 4], [2, 3, 4], [3, 3, 5], [3, 4, 6], [3, 4, 6],
        [4, 5, 7], [4, 5, 8], [4, 6, 9], [5, 7, 10], [6, 8, 11], [6, 8, 13],
        [7, 10, 14], [8, 11, 16], [9, 12, 18], [10, 13, 20], [11, 15, 23],
        [13, 17, 25],
    ],
    dtype=np.int32,
)


def _clip3(lo, hi, x):
    return np.minimum(np.maximum(x, lo), hi)


def _filter_edge_luma(p: np.ndarray, bs: np.ndarray, qp: int):
    """Filter one luma edge.

    p: [N, 8] rows of samples [p3 p2 p1 p0 q0 q1 q2 q3] (modified in
    place); bs: [N] boundary strengths per row (already expanded from
    per-4-row groups); qp: average QP of the two blocks.
    """
    a = int(ALPHA[qp])
    b = int(BETA[qp])
    p3, p2, p1, p0 = (p[:, i].astype(np.int32) for i in range(4))
    q0, q1, q2, q3 = (p[:, i].astype(np.int32) for i in range(4, 8))
    filt = (
        (bs > 0)
        & (np.abs(p0 - q0) < a)
        & (np.abs(p1 - p0) < b)
        & (np.abs(q1 - q0) < b)
    )
    ap = np.abs(p2 - p0) < b
    aq = np.abs(q2 - q0) < b

    # --- bS < 4 ---
    tc0 = TC0[qp][np.clip(bs, 1, 3) - 1]
    tc = tc0 + ap.astype(np.int32) + aq.astype(np.int32)
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    np0 = np.clip(p0 + delta, 0, 255)
    nq0 = np.clip(q0 - delta, 0, 255)
    np1 = p1 + _clip3(-tc0, tc0, (p2 + ((p0 + q0 + 1) >> 1) - 2 * p1) >> 1)
    nq1 = q1 + _clip3(-tc0, tc0, (q2 + ((p0 + q0 + 1) >> 1) - 2 * q1) >> 1)

    # --- bS == 4 ---
    strongp = ap & (np.abs(p0 - q0) < ((a >> 2) + 2))
    strongq = aq & (np.abs(p0 - q0) < ((a >> 2) + 2))
    sp0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    sp1 = (p2 + p1 + p0 + q0 + 2) >> 2
    sp2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    wp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
    sq1 = (q2 + q1 + q0 + p0 + 2) >> 2
    sq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    wq0 = (2 * q1 + q0 + p1 + 2) >> 2

    is4 = bs == 4
    out_p0 = np.where(is4, np.where(strongp, sp0, wp0), np0)
    out_p1 = np.where(is4, np.where(strongp, sp1, p1), np.where(ap, np1, p1))
    out_p2 = np.where(is4 & strongp, sp2, p2)
    out_q0 = np.where(is4, np.where(strongq, sq0, wq0), nq0)
    out_q1 = np.where(is4, np.where(strongq, sq1, q1), np.where(aq, nq1, q1))
    out_q2 = np.where(is4 & strongq, sq2, q2)

    for col, val in ((1, out_p2), (2, out_p1), (3, out_p0),
                     (4, out_q0), (5, out_q1), (6, out_q2)):
        p[:, col] = np.where(filt, val, p[:, col])


def _filter_edge_chroma(p: np.ndarray, bs: np.ndarray, qpc: int):
    """Chroma edge: p [N, 4] = [p1 p0 q0 q1]; only p0/q0 move."""
    a = int(ALPHA[qpc])
    b = int(BETA[qpc])
    p1, p0, q0, q1 = (p[:, i].astype(np.int32) for i in range(4))
    filt = (
        (bs > 0)
        & (np.abs(p0 - q0) < a)
        & (np.abs(p1 - p0) < b)
        & (np.abs(q1 - q0) < b)
    )
    tc0 = TC0[qpc][np.clip(bs, 1, 3) - 1]
    tc = tc0 + 1
    delta = _clip3(-tc, tc, ((q0 - p0) * 4 + (p1 - q1) + 4) >> 3)
    np0 = np.clip(p0 + delta, 0, 255)
    nq0 = np.clip(q0 - delta, 0, 255)
    wp0 = (2 * p1 + p0 + q1 + 2) >> 2
    wq0 = (2 * q1 + q0 + p1 + 2) >> 2
    is4 = bs == 4
    p[:, 1] = np.where(filt, np.where(is4, wp0, np0), p[:, 1])
    p[:, 2] = np.where(filt, np.where(is4, wq0, nq0), p[:, 2])


def _expand_bs(bs4: np.ndarray, n: int = 4) -> np.ndarray:
    return np.repeat(bs4, n)


def deblock_frame(
    recon_y: np.ndarray,
    recon_u: np.ndarray,
    recon_v: np.ndarray,
    nnz_y: np.ndarray,       # [4*mbh, 4*mbw] per-4x4 coded-coeff counts
    kind: np.ndarray,        # [mbh, mbw] 0 skip / 1 inter / 2 intra
    mv: np.ndarray,          # [mbh, mbw, 2] quarter-pel
    slice_id: np.ndarray,    # [mbh, mbw]
    qp: int,
    idc: int = 0,
    chroma_qp_offset: int = 0,
    refidx: np.ndarray = None,  # [mbh, mbw] refIdxL0 (multi-ref DPB)
    t8: np.ndarray = None,      # [mbh, mbw] transform_size_8x8_flag
    qp_map: np.ndarray = None,  # [mbh, mbw] per-MB QP (mb_qp_delta streams)
    mv4: np.ndarray = None,     # [4*mbh, 4*mbw, 2] 4x4-granular MVs
    ref4: np.ndarray = None,    # [4*mbh, 4*mbw] 4x4-granular refIdx
) -> None:
    """Filter the picture in place (MB raster order per 8.7).

    General-stream extensions (third-party decode, 8.7.2): `qp_map`
    carries per-MB QP (mb_qp_delta / I_PCM-as-0) -- MB-boundary edges
    filter at qPav = (QPp + QPq + 1) >> 1, chroma via the per-MB QPc
    values; `mv4`/`ref4` carry 4x4-block-granular motion so bS = 1
    derivation compares the actual blocks across every edge (sub-16x16
    partitions).  With these omitted, the uniform per-MB state
    reproduces the original behavior exactly."""
    if idc == 1:
        return
    mbh, mbw = kind.shape
    if refidx is None:
        refidx = np.zeros((mbh, mbw), np.int32)
    if mv4 is None:
        mv4 = np.repeat(np.repeat(mv, 4, axis=0), 4, axis=1)
    if ref4 is None:
        ref4 = np.repeat(np.repeat(refidx, 4, axis=0), 4, axis=1)
    if qp_map is None:
        qp_map = np.full((mbh, mbw), qp, np.int32)
    qpc_map = np.asarray(
        [[int(chroma_qp(int(q), chroma_qp_offset)) for q in row]
         for row in qp_map],
        np.int32,
    )
    if t8 is None:
        t8 = np.zeros((mbh, mbw), np.int32)
    else:
        # 8x8-transform MBs: a 4x4 cell counts as coded iff its covering
        # 8x8 block has any coefficients (8.7.2.1)
        nnz_y = nnz_y.copy()
        for my in range(mbh):
            for mx in range(mbw):
                if t8[my, mx]:
                    for y8 in range(2):
                        for x8 in range(2):
                            cells = nnz_y[4*my + 2*y8 : 4*my + 2*y8 + 2,
                                          4*mx + 2*x8 : 4*mx + 2*x8 + 2]
                            cells[:] = 1 if cells.any() else 0
    intra = kind == 2

    def _bs_mv(aby, abx, bby, bbx):
        """bS 1/0 from 4x4-granular motion across one block pair."""
        dmv = np.abs(mv4[aby, abx] - mv4[bby, bbx])
        diff_ref = ref4[aby, abx] != ref4[bby, bbx]
        return 1 if (diff_ref or (dmv >= 4).any()) else 0

    def bs_pair(mby, mbx, nby, nbx, mb_edge, blocks_a, blocks_b):
        """bS per 4x4 pair along one edge; blocks_* are (by, bx) lists."""
        if intra[mby, mbx] or intra[nby, nbx]:
            return np.full(4, 4 if mb_edge else 3, np.int32)
        bs = np.zeros(4, np.int32)
        for k, ((aby, abx), (bby, bbx)) in enumerate(zip(blocks_a, blocks_b)):
            ga = (4 * mby + aby, 4 * mbx + abx)
            gb = (4 * nby + bby, 4 * nbx + bbx)
            if nnz_y[ga] > 0 or nnz_y[gb] > 0:
                bs[k] = 2
            else:
                bs[k] = _bs_mv(*ga, *gb)
        return bs

    def bs_internal(mby, mbx, blocks_a, blocks_b):
        if intra[mby, mbx]:
            return np.full(4, 3, np.int32)
        bs = np.zeros(4, np.int32)
        for k, ((aby, abx), (bby, bbx)) in enumerate(zip(blocks_a, blocks_b)):
            ga = (4 * mby + aby, 4 * mbx + abx)
            gb = (4 * mby + bby, 4 * mbx + bbx)
            if nnz_y[ga] > 0 or nnz_y[gb] > 0:
                bs[k] = 2
            else:
                bs[k] = _bs_mv(*ga, *gb)
        return bs

    for mby in range(mbh):
        for mbx in range(mbw):
            sid = slice_id[mby, mbx]
            y0, x0 = 16 * mby, 16 * mbx
            c0, cx0 = 8 * mby, 8 * mbx

            # ---- vertical edges (left->right) ----
            for e, xe in enumerate((0, 4, 8, 12)):
                if xe in (4, 12) and t8[mby, mbx]:
                    continue  # 8x8 transform: no 4-aligned internal edges
                if xe == 0:
                    if mbx == 0:
                        continue
                    if idc == 2 and slice_id[mby, mbx - 1] != sid:
                        continue
                    bs = bs_pair(
                        mby, mbx, mby, mbx - 1, True,
                        [(k, 0) for k in range(4)],
                        [(k, 3) for k in range(4)],
                    )
                else:
                    bx = xe // 4
                    bs = bs_internal(
                        mby, mbx,
                        [(k, bx) for k in range(4)],
                        [(k, bx - 1) for k in range(4)],
                    )
                if not bs.any():
                    continue
                if xe == 0:  # MB edge: average the two MBs' QPs (8.7.2)
                    qp_e = (int(qp_map[mby, mbx - 1])
                            + int(qp_map[mby, mbx]) + 1) >> 1
                    qpc_e = (int(qpc_map[mby, mbx - 1])
                             + int(qpc_map[mby, mbx]) + 1) >> 1
                else:
                    qp_e = int(qp_map[mby, mbx])
                    qpc_e = int(qpc_map[mby, mbx])
                gx = x0 + xe
                seg = recon_y[y0 : y0 + 16, gx - 4 : gx + 4]
                _filter_edge_luma(seg, _expand_bs(bs), qp_e)
                if xe in (0, 8):  # chroma vertical edges at 0 and 4
                    cgx = cx0 + xe // 2
                    cseg_u = recon_u[c0 : c0 + 8, cgx - 2 : cgx + 2]
                    cseg_v = recon_v[c0 : c0 + 8, cgx - 2 : cgx + 2]
                    cbs = _expand_bs(bs, 2)
                    _filter_edge_chroma(cseg_u, cbs, qpc_e)
                    _filter_edge_chroma(cseg_v, cbs, qpc_e)

            # ---- horizontal edges (top->bottom) ----
            for e, ye in enumerate((0, 4, 8, 12)):
                if ye in (4, 12) and t8[mby, mbx]:
                    continue  # 8x8 transform: no 4-aligned internal edges
                if ye == 0:
                    if mby == 0:
                        continue
                    if idc == 2 and slice_id[mby - 1, mbx] != sid:
                        continue
                    bs = bs_pair(
                        mby, mbx, mby - 1, mbx, True,
                        [(0, k) for k in range(4)],
                        [(3, k) for k in range(4)],
                    )
                else:
                    by = ye // 4
                    bs = bs_internal(
                        mby, mbx,
                        [(by, k) for k in range(4)],
                        [(by - 1, k) for k in range(4)],
                    )
                if not bs.any():
                    continue
                if ye == 0:
                    qp_e = (int(qp_map[mby - 1, mbx])
                            + int(qp_map[mby, mbx]) + 1) >> 1
                    qpc_e = (int(qpc_map[mby - 1, mbx])
                             + int(qpc_map[mby, mbx]) + 1) >> 1
                else:
                    qp_e = int(qp_map[mby, mbx])
                    qpc_e = int(qpc_map[mby, mbx])
                gy = y0 + ye
                seg = recon_y[gy - 4 : gy + 4, x0 : x0 + 16].T.copy()
                _filter_edge_luma(seg, _expand_bs(bs), qp_e)
                recon_y[gy - 4 : gy + 4, x0 : x0 + 16] = seg.T
                if ye in (0, 8):
                    cgy = c0 + ye // 2
                    cbs = _expand_bs(bs, 2)
                    for plane in (recon_u, recon_v):
                        cseg = plane[cgy - 2 : cgy + 2, cx0 : cx0 + 8].T.copy()
                        _filter_edge_chroma(cseg, cbs, qpc_e)
                        plane[cgy - 2 : cgy + 2, cx0 : cx0 + 8] = cseg.T
