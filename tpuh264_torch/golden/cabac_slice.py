# Copy of tpuh264/golden/cabac_slice.py, so that the port imports nothing of tpuh264.
# Two known traps are kept as the original has them (ROADMAP queue 3): the I_PCM
# offset in _cabac_ipcm relies on an unasserted byte alignment, and the Intra_8x8
# deblock nnz uses reshape(4, 16), not the [k::4] interleave (harmless for bS).
"""General CABAC slice-data decoder for the golden StreamDecoder.

Third-party Main/High-profile streams (libx264 default output) code
their slice data with CABAC; this module parses that syntax --
mb_skip_flag, full P mb_type binarization (16x16 / 16x8 / 8x16 / P_8x8
with sub-partitions), partition-granular ref_idx / mvd contexts,
mb_qp_delta, I_NxN / I_16x16 (in both I and P slices), Intra_8x8
(transform_size_8x8_flag=1 with the golden/intra8.py filtered-reference
prediction), I_PCM (byte-aligned raw samples + 9.3.1.2 engine re-init),
transform-8x8 residuals -- and reconstructs through the exact same
golden recon helpers as the CAVLC path (codec._recon_inter_mb /
_recon_i16_mb / _recon_i44_mb / _recon_i8_mb), so decoded pictures are
pixel-identical to libavcodec (tests/test_conformance_reverse.py CABAC
and High-profile variants).

Reference analog: the reference's decoder pool accepts any conformant
stream because it ships the complete OpenH264 decoder
(reference/openh264_wrapper.cpp:240-280, 391-422).  The CABAC
primitives (arithmetic engine, context init tables for I and all
cabac_init_idc, residual/mvd/ref_idx decoders) are shared with our own
CABAC encoder (entropy/cabac_pack.py); this module adds the context
state and binarizations our encoder never emits.

Clause references: 7.3.5/7.4.5 (macroblock layer), 9.3.2 (binarization),
9.3.3.1 (context index computation).
"""

from __future__ import annotations

import numpy as np

from ..entropy.cabac_arith import CabacDecoder
from ..entropy.cabac_tables import CTX_INIT_I, CTX_INIT_PB, init_contexts
from ..entropy.cabac_pack import (
    _Ctx,
    _cbf_inc_4x4,
    _cbf_inc_dc,
    _cbp_luma_incs,
    _dec_chroma_res,
    _dec_mvd,
    _decode_residual,
    _decode_residual8,
)
from ..core.sliceheader import SLICE_I, SLICE_P
from .codec import (
    BLK_SCAN,
    _apply_ipcm_samples,
    _apply_qp_delta,
    _apply_skip,
    _i44_pred_mode,
    _neighbors_luma,
    _recon_i16_mb,
    _recon_i44_mb,
    _recon_i8_mb,
    _recon_inter_mb,
    _set_blocks4,
)
from . import intra
from . import inter as inter_mod


class CabacFrameCtx(_Ctx):
    """Per-frame CABAC neighbor-context state, extended to the partition
    granularity third-party streams need (our encoder is 16x16-only, so
    the base _Ctx tracks MB-granular |mvd| and ref_idx)."""

    def __init__(self, mbw: int, mbh: int):
        super().__init__(mbw, mbh)
        # per-4x4 |mvd| components (9.3.3.1.1.7 reads the neighboring
        # PARTITION's absMvdComp; filling each partition's 4x4s makes
        # any neighbor lookup a grid read)
        self.amvd4x = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.amvd4y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        # per-8x8 refIdxL0 (-1 = intra; ref_idx ctx counts >0 only)
        self.ref8 = np.zeros((2 * mbh, 2 * mbw), np.int32)
        self.last_dqp_nz = 0  # mb_qp_delta ctx: previous MB's delta != 0


# -- scalar SE decoders -------------------------------------------------------


def _dec_qp_delta(dec, st, mps, C) -> int:
    """mb_qp_delta: unary bins at ctx 60+prev / 62 / 63, then the se(v)
    index mapping (9.3.2.7, Table 9-3)."""
    if not dec.decode(st, mps, 60 + (1 if C.last_dqp_nz else 0)):
        C.last_dqp_nz = 0
        return 0
    k = 1
    ctx = 62
    while dec.decode(st, mps, ctx):
        ctx = 63
        k += 1
        if k > 52:
            raise ValueError("mb_qp_delta overflow")
    C.last_dqp_nz = 1
    return (k + 1) // 2 if k % 2 else -(k // 2)


def _dec_sub_mb_type(dec, st, mps) -> int:
    """P sub_mb_type (Table 9-38): '1'=8x8, '00'=8x4, '011'=4x8,
    '010'=4x4; ctx 21/22/23."""
    if dec.decode(st, mps, 21):
        return 0
    if not dec.decode(st, mps, 22):
        return 1
    return 2 if dec.decode(st, mps, 23) else 3


def _ref_ctx_inc(C, gx8, gy8, left_ok, top_ok) -> int:
    """ref_idx_l0 bin0 ctxIdxInc from the neighboring partitions' refIdx
    (9.3.3.1.1.6); C.ref8 holds -1 for intra, so `> 0` covers the
    intra/skip condTermFlag-0 cases."""
    a = 1 if left_ok and C.ref8[gy8, gx8 - 1] > 0 else 0
    b = 1 if top_ok and C.ref8[gy8 - 1, gx8] > 0 else 0
    return a + 2 * b


def _dec_ref_idx_part(dec, st, mps, C, gx8, gy8, left_ok, top_ok) -> int:
    ctx = 54 + _ref_ctx_inc(C, gx8, gy8, left_ok, top_ok)
    ref = 0
    while dec.decode(st, mps, ctx):
        ctx = 58 if ref == 0 else 59
        ref += 1
        if ref > 32:
            raise ValueError("ref_idx overflow")
    return ref


def _amvd_sum(grid, gx, gy, left_ok, top_ok) -> int:
    a = int(grid[gy, gx - 1]) if left_ok else 0
    b = int(grid[gy - 1, gx]) if top_ok else 0
    return a + b


def _dec_mvd_part(dec, st, mps, C, gx, gy, mbx, mby, left_mb, top_mb):
    """One partition's (mvdx, mvdy) with partition-granular contexts;
    neighbor A = 4x4 left of (gx, gy), B = above."""
    l_ok = gx > 0 and (gx % 4 != 0 or left_mb)
    t_ok = gy > 0 and (gy % 4 != 0 or top_mb)
    mvdx = _dec_mvd(dec, st, mps, 40,
                    _amvd_sum(C.amvd4x, gx, gy, l_ok, t_ok))
    mvdy = _dec_mvd(dec, st, mps, 47,
                    _amvd_sum(C.amvd4y, gx, gy, l_ok, t_ok))
    return mvdx, mvdy


def _fill_part_state(C, gx, gy, w4, h4, mvdx, mvdy, ref) -> None:
    C.amvd4x[gy:gy + h4, gx:gx + w4] = abs(mvdx)
    C.amvd4y[gy:gy + h4, gx:gx + w4] = abs(mvdy)
    C.ref8[gy // 2:(gy + h4 + 1) // 2, gx // 2:(gx + w4 + 1) // 2] = ref


def _mb_zero_entropy(C, mbx, mby, intra_mb: bool) -> None:
    """Reset partition-granular entropy state for skip/intra MBs."""
    C.amvd4x[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
    C.amvd4y[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
    C.ref8[2 * mby:2 * mby + 2, 2 * mbx:2 * mbx + 2] = (
        -1 if intra_mb else 0
    )


# -- intra MB layers ----------------------------------------------------------


def _cabac_i44(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
               left_mb, top_mb, in_p: bool) -> None:
    """I_NxN (4x4 transform): pred modes, chroma mode, cbp, qp_delta,
    residuals; recon via codec._recon_i44_mb."""
    if getattr(ctx, "t8_enabled", False):
        # High-profile I_NxN starts with transform_size_8x8_flag
        fa = 1 if left_mb and C.t8[mby, mbx - 1] else 0
        fb = 1 if top_mb and C.t8[mby - 1, mbx] else 0
        if dec.decode(st, mps, 399 + fa + fb):
            _cabac_i8(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                      left_mb, top_mb)
            return
    modes = np.zeros(16, np.int32)
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        l_ok = gbx > 0 and (bx > 0 or left_mb)
        t_ok = gby > 0 and (by > 0 or top_mb)
        pm = _i44_pred_mode(ctx.i4modes, gbx, gby, l_ok, t_ok)
        if dec.decode(st, mps, 68):
            m = pm
        else:
            rem = 0
            for k in range(3):
                rem |= dec.decode(st, mps, 69) << k
            m = rem if rem < pm else rem + 1
        modes[bi] = m
        ctx.i4modes[gby, gbx] = m
        C.i4[gby, gbx] = m
    cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
        1 if top_mb and C.cmode[mby - 1, mbx] else 0
    )
    cmode = 0
    while cmode < 3 and dec.decode(
        st, mps, (64 + cinc) if cmode == 0 else 67
    ):
        cmode += 1
    bits = 0
    for i in range(4):
        inc_i = _cbp_luma_incs(C, mbx, mby, left_mb, top_mb, bits)[i]
        bits |= dec.decode(st, mps, 73 + inc_i) << i
    cbp_l = bits
    a0 = 1 if left_mb and C.cbp_c[mby, mbx - 1] else 0
    b0 = 1 if top_mb and C.cbp_c[mby - 1, mbx] else 0
    if dec.decode(st, mps, 77 + a0 + 2 * b0):
        a1 = 1 if left_mb and C.cbp_c[mby, mbx - 1] == 2 else 0
        b1 = 1 if top_mb and C.cbp_c[mby - 1, mbx] == 2 else 0
        cbp_c = 1 + dec.decode(st, mps, 81 + a1 + 2 * b1)
    else:
        cbp_c = 0
    if cbp_l or cbp_c:
        _apply_qp_delta(ctx, _dec_qp_delta(dec, st, mps, C))
    else:
        C.last_dqp_nz = 0

    coeffs = np.zeros((16, 16), np.int32)
    for i8 in range(4):
        for b in range(4 * i8, 4 * i8 + 4):
            bx, by = BLK_SCAN[b]
            gbx, gby = 4 * mbx + bx, 4 * mby + by
            if (cbp_l >> i8) & 1:
                inc = _cbf_inc_4x4(
                    C.nnz_y, gbx, gby, bx > 0 or left_mb,
                    by > 0 or top_mb,
                )
                blk, cbf = _decode_residual(dec, st, mps, 2, 16, inc)
                coeffs[b] = blk
                C.nnz_y[gby, gbx] = cbf
                ctx.nnz_y[gby, gbx] = int(np.count_nonzero(blk))
            else:
                C.nnz_y[gby, gbx] = 0
                ctx.nnz_y[gby, gbx] = 0
    C.dc_y[mby, mbx] = 0
    dcu, dcv, acu, acv = _cabac_chroma(
        dec, st, mps, C, ctx, mbx, mby, left_mb, top_mb, cbp_c, un=1
    )
    _recon_i44_mb(ctx, mbx, mby, sid, modes, coeffs, cmode,
                  dcu, dcv, acu, acv, cbp_c, left_mb, top_mb)
    _mb_zero_entropy(C, mbx, mby, intra_mb=True)
    C.skip[mby, mbx] = 0
    C.not_i4[mby, mbx] = 0
    C.cmode[mby, mbx] = cmode
    C.cbp_l[mby, mbx] = cbp_l
    C.cbp_c[mby, mbx] = cbp_c
    C.t8[mby, mbx] = 0


def _cabac_i8(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
              left_mb, top_mb) -> None:
    """Intra_8x8 (I_NxN + transform_size_8x8_flag=1, High profile):
    four 8x8 pred modes (same ctx 68/69 schedule as 4x4, prediction from
    the replicated-mode grid per 8.3.2.1), chroma mode, cbp, qp_delta,
    ctxBlockCat-5 residuals; recon via codec._recon_i8_mb."""
    modes = np.zeros(4, np.int32)
    for b8 in range(4):
        x8, y8 = b8 & 1, b8 >> 1
        gbx, gby = 4 * mbx + 2 * x8, 4 * mby + 2 * y8
        l_ok = gbx > 0 and (x8 > 0 or left_mb)
        t_ok = gby > 0 and (y8 > 0 or top_mb)
        pm = _i44_pred_mode(ctx.i4modes, gbx, gby, l_ok, t_ok)
        if dec.decode(st, mps, 68):
            m = pm
        else:
            rem = 0
            for k in range(3):
                rem |= dec.decode(st, mps, 69) << k
            m = rem if rem < pm else rem + 1
        modes[b8] = m
        # replicate into the 4x4 grid: any covering-cell lookup by a
        # later 4x4 OR 8x8 neighbor reads this block's mode (8.3.2.1)
        ctx.i4modes[gby : gby + 2, gbx : gbx + 2] = m
        C.i4[gby : gby + 2, gbx : gbx + 2] = m
    cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
        1 if top_mb and C.cmode[mby - 1, mbx] else 0
    )
    cmode = 0
    while cmode < 3 and dec.decode(
        st, mps, (64 + cinc) if cmode == 0 else 67
    ):
        cmode += 1
    bits = 0
    for i in range(4):
        inc_i = _cbp_luma_incs(C, mbx, mby, left_mb, top_mb, bits)[i]
        bits |= dec.decode(st, mps, 73 + inc_i) << i
    cbp_l = bits
    a0 = 1 if left_mb and C.cbp_c[mby, mbx - 1] else 0
    b0 = 1 if top_mb and C.cbp_c[mby - 1, mbx] else 0
    if dec.decode(st, mps, 77 + a0 + 2 * b0):
        a1 = 1 if left_mb and C.cbp_c[mby, mbx - 1] == 2 else 0
        b1 = 1 if top_mb and C.cbp_c[mby - 1, mbx] == 2 else 0
        cbp_c = 1 + dec.decode(st, mps, 81 + a1 + 2 * b1)
    else:
        cbp_c = 0
    if cbp_l or cbp_c:
        _apply_qp_delta(ctx, _dec_qp_delta(dec, st, mps, C))
    else:
        C.last_dqp_nz = 0

    zz8 = np.zeros((2, 2, 64), np.int32)
    for b8 in range(4):
        x8, y8 = b8 & 1, b8 >> 1
        if (cbp_l >> b8) & 1:
            zz8[y8, x8] = _decode_residual8(dec, st, mps)
            nz = np.count_nonzero(
                np.asarray(zz8[y8, x8]).reshape(4, 16), axis=1
            )
            C.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                    4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 1
            # deblock nnz: distribute the 8x8 count over its 4x4s
            ctx.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                      4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = (
                nz.reshape(2, 2)
            )
        else:
            C.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                    4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 0
            ctx.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                      4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 0
    C.dc_y[mby, mbx] = 0
    dcu, dcv, acu, acv = _cabac_chroma(
        dec, st, mps, C, ctx, mbx, mby, left_mb, top_mb, cbp_c, un=1
    )
    _recon_i8_mb(ctx, mbx, mby, sid, modes, zz8, cmode,
                 dcu, dcv, acu, acv, cbp_c, left_mb, top_mb)
    ctx.t8[mby, mbx] = 1  # deblock skips the internal 4/12 edges (8.7)
    _mb_zero_entropy(C, mbx, mby, intra_mb=True)
    C.skip[mby, mbx] = 0
    C.not_i4[mby, mbx] = 0
    C.cmode[mby, mbx] = cmode
    C.cbp_l[mby, mbx] = cbp_l
    C.cbp_c[mby, mbx] = cbp_c
    C.t8[mby, mbx] = 1


def _cabac_ipcm(dec, rbsp, C, ctx, mbx, mby, sid) -> None:
    """I_PCM inside a CABAC slice (7.3.5, 9.3.1.2): the raw samples
    start at the next byte boundary after the bits the arithmetic
    decoder has consumed (verified invariant of the 9.3.4.6 encoder
    flush: decoder pos == flushed stream bits), and the decoding engine
    re-initializes right after them."""
    off = (dec.pos + 7) // 8
    end = off + 384
    if end > len(rbsp):
        raise ValueError("I_PCM runs past the slice payload")
    raw = np.frombuffer(rbsp[off:end], np.uint8).astype(np.int32)
    _apply_ipcm_samples(
        ctx, mbx, mby, sid,
        raw[:256].reshape(16, 16),
        raw[256:320].reshape(8, 8),
        raw[320:].reshape(8, 8),
    )
    dec.__init__(rbsp, end)  # 9.3.1.2: engine re-init (contexts persist)
    # neighbor-context conventions for an I_PCM MB (9.3.3.1.1.x):
    # cbf 1 everywhere, cbp 15/2, not-I_NxN, chroma mode 0, delta-QP 0
    C.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 1
    C.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 1
    C.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 1
    C.dc_y[mby, mbx] = 1
    C.dc_u[mby, mbx] = 1
    C.dc_v[mby, mbx] = 1
    C.cbp_l[mby, mbx] = 15
    C.cbp_c[mby, mbx] = 2
    C.not_i4[mby, mbx] = 1
    C.cmode[mby, mbx] = 0
    C.t8[mby, mbx] = 0
    C.skip[mby, mbx] = 0
    C.last_dqp_nz = 0
    C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1
    _mb_zero_entropy(C, mbx, mby, intra_mb=True)


def _cabac_i16(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
               left_mb, top_mb, pred_mode, cbp_l16, cbp_c_sig,
               un: int) -> None:
    """I_16x16 body after the mb_type suffix decoded (pred_mode, the
    cbp-in-mb_type bits): chroma mode, qp_delta, residuals, recon."""
    cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
        1 if top_mb and C.cmode[mby - 1, mbx] else 0
    )
    cmode = 0
    while cmode < 3 and dec.decode(
        st, mps, (64 + cinc) if cmode == 0 else 67
    ):
        cmode += 1
    _apply_qp_delta(ctx, _dec_qp_delta(dec, st, mps, C))

    left_ok, top_ok, top, left, corner = _neighbors_luma(ctx, mbx, mby, sid)
    pred = intra.pred16(pred_mode, top, left, corner, top_ok, left_ok)

    inc = _cbf_inc_dc(C.dc_y, mbx, mby, left_mb, top_mb, un)
    dc_zz, cbf = _decode_residual(dec, st, mps, 0, 16, inc)
    dc_zz = np.asarray(dc_zz, np.int32)
    C.dc_y[mby, mbx] = cbf
    ac_zz = np.zeros((4, 4, 15), np.int32)
    if cbp_l16:
        for bx, by in BLK_SCAN:
            gbx, gby = 4 * mbx + bx, 4 * mby + by
            inc = _cbf_inc_4x4(
                C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb, un
            )
            blk, cbf = _decode_residual(dec, st, mps, 1, 15, inc)
            ac_zz[by, bx] = blk
            C.nnz_y[gby, gbx] = cbf
            ctx.nnz_y[gby, gbx] = int(np.count_nonzero(np.asarray(blk)))
    else:
        C.nnz_y[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
        ctx.nnz_y[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = 0
    dcu, dcv, acu, acv = _cabac_chroma(
        dec, st, mps, C, ctx, mbx, mby, left_mb, top_mb, cbp_c_sig, un=un
    )
    _recon_i16_mb(ctx, mbx, mby, sid, pred, cmode, dc_zz, ac_zz,
                  1 if cbp_l16 else 0, cbp_c_sig, dcu, dcv, acu, acv,
                  left_ok, top_ok)
    _mb_zero_entropy(C, mbx, mby, intra_mb=True)
    C.skip[mby, mbx] = 0
    C.not_i4[mby, mbx] = 1
    C.cmode[mby, mbx] = cmode
    C.cbp_l[mby, mbx] = 15 if cbp_l16 else 0
    C.cbp_c[mby, mbx] = cbp_c_sig
    C.t8[mby, mbx] = 0
    C.i4[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = -1
    ctx.i4modes[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = -1


def _cabac_chroma(dec, st, mps, C, ctx, mbx, mby, left_mb, top_mb,
                  cbp_c, un):
    """Chroma residuals via the shared cabac_pack decoder; mirrors the
    nnz counts into the golden ctx for deblocking."""
    cdc = np.zeros((1, 2, 4), np.int32)
    cac = np.zeros((1, 2, 4, 15), np.int32)
    _dec_chroma_res(dec, st, mps, C, mbx, mby, left_mb, top_mb,
                    cbp_c, cdc, cac, 0, un)
    acu = np.zeros((2, 2, 15), np.int32)
    acv = np.zeros((2, 2, 15), np.int32)
    for comp, (ac, nnz) in enumerate(
        ((acu, ctx.nnz_u), (acv, ctx.nnz_v))
    ):
        for bidx in range(4):
            bx, by = bidx % 2, bidx // 2
            ac[by, bx] = cac[0, comp, bidx]
            nnz[2 * mby + by, 2 * mbx + bx] = int(
                np.count_nonzero(cac[0, comp, bidx])
            ) if cbp_c == 2 else 0
    return cdc[0, 0], cdc[0, 1], acu, acv


def _intra_suffix(dec, st, mps, base: int):
    """Intra mb_type suffix after the shared prefix: returns
    (pred_mode, cbp_l16, cbp_c), or None for I_PCM (terminate bin 1) --
    ffmpeg-verified ctx schedule base/base+1/base+2/base+3 (base 3-area
    for I slices via explicit ctxs, 17..20 for P slices)."""
    if dec.terminate():
        return None  # I_PCM: caller reads the byte-aligned samples
    cbp_l = dec.decode(st, mps, base + 1)
    if dec.decode(st, mps, base + 2):
        cbp_c = 1 + dec.decode(st, mps, base + 2)
    else:
        cbp_c = 0
    mode = (dec.decode(st, mps, base + 3) << 1) | dec.decode(
        st, mps, base + 3
    )
    return mode, cbp_l, cbp_c


# -- inter MB layer -----------------------------------------------------------

_SUBGEO = {
    0: [(0, 0, 2, 2)],
    1: [(0, 0, 2, 1), (0, 1, 2, 1)],
    2: [(0, 0, 1, 2), (1, 0, 1, 2)],
    3: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
}


def _cabac_mb_p(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                left_mb, top_mb, rbsp) -> None:
    """Non-skip P macroblock: full mb_type binarization (Table 9-37 /
    the ffmpeg ctx schedule 14/15/16-17), partitions, residuals."""
    gx0, gy0 = 4 * mbx, 4 * mby
    if dec.decode(st, mps, 14):  # intra prefix
        if dec.decode(st, mps, 17) == 0:
            _cabac_i44(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                       left_mb, top_mb, in_p=True)
            return
        suffix = _intra_suffix(dec, st, mps, 17)
        if suffix is None:
            _cabac_ipcm(dec, rbsp, C, ctx, mbx, mby, sid)
            return
        pred_mode, cbp_l16, cbp_c = suffix
        _cabac_i16(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                   left_mb, top_mb, pred_mode, cbp_l16, cbp_c, un=1)
        return

    if dec.decode(st, mps, 15):
        # '01x': bin2 at ctx 17; 1 -> 16x8, 0 -> 8x16
        mb_kind = 1 if dec.decode(st, mps, 17) else 2
    else:
        # '00x': bin2 at ctx 16; 1 -> P_8x8, 0 -> 16x16
        mb_kind = 3 if dec.decode(st, mps, 16) else 0

    nra = getattr(ctx, "nra", 1)
    blocks = []
    if mb_kind in (0, 1, 2):
        geo = {
            0: [(0, 0, 4, 4, None)],
            1: [(0, 0, 4, 2, "16x8_top"), (0, 2, 4, 2, "16x8_bot")],
            2: [(0, 0, 2, 4, "8x16_left"), (2, 0, 2, 4, "8x16_right")],
        }[mb_kind]
        refs = []
        for (ox, oy, w4, h4, special) in geo:
            if nra > 1:
                l_ok = (gx0 + ox) > 0 and (ox > 0 or left_mb)
                t_ok = (gy0 + oy) > 0 and (oy > 0 or top_mb)
                ref = _dec_ref_idx_part(
                    dec, st, mps, C, (gx0 + ox) // 2, (gy0 + oy) // 2,
                    l_ok, t_ok,
                )
            else:
                ref = 0
            # in-MB neighbor state: the NEXT partition's ref_idx ctx
            # reads this partition's refIdx (9.3.3.1.1.6)
            C.ref8[(gy0 + oy) // 2:(gy0 + oy + h4 + 1) // 2,
                   (gx0 + ox) // 2:(gx0 + ox + w4 + 1) // 2] = ref
            refs.append(ref)
        for (ox, oy, w4, h4, special), ref in zip(geo, refs):
            gx, gy = gx0 + ox, gy0 + oy
            mvdx, mvdy = _dec_mvd_part(
                dec, st, mps, C, gx, gy, mbx, mby, left_mb, top_mb
            )
            pmv = inter_mod.predict_mv_block(
                ctx.mv4, ctx.ref4, ctx.avail4, gx, gy, w4, h4, sid, ref,
                special,
            )
            mv = (pmv[0] + mvdx, pmv[1] + mvdy)
            _set_blocks4(ctx, gx, gy, w4, h4, mv, ref, sid)
            _fill_part_state(C, gx, gy, w4, h4, mvdx, mvdy, ref)
            blocks.append((ox, oy, w4, h4, ref, mv))
        no_small_parts = True
    else:  # P_8x8
        subs = [_dec_sub_mb_type(dec, st, mps) for _ in range(4)]
        refs = []
        for i8 in range(4):
            ox8, oy8 = 2 * (i8 & 1), 2 * (i8 >> 1)
            if nra > 1:
                l_ok = (gx0 + ox8) > 0 and (ox8 > 0 or left_mb)
                t_ok = (gy0 + oy8) > 0 and (oy8 > 0 or top_mb)
                ref = _dec_ref_idx_part(
                    dec, st, mps, C, (gx0 + ox8) // 2, (gy0 + oy8) // 2,
                    l_ok, t_ok,
                )
            else:
                ref = 0
            C.ref8[(gy0 + oy8) // 2, (gx0 + ox8) // 2] = ref
            refs.append(ref)
        for i8 in range(4):
            ox8, oy8 = 2 * (i8 & 1), 2 * (i8 >> 1)
            for (sx, sy, w4, h4) in _SUBGEO[subs[i8]]:
                gx, gy = gx0 + ox8 + sx, gy0 + oy8 + sy
                mvdx, mvdy = _dec_mvd_part(
                    dec, st, mps, C, gx, gy, mbx, mby, left_mb, top_mb
                )
                pmv = inter_mod.predict_mv_block(
                    ctx.mv4, ctx.ref4, ctx.avail4, gx, gy, w4, h4, sid,
                    refs[i8],
                )
                mv = (pmv[0] + mvdx, pmv[1] + mvdy)
                _set_blocks4(ctx, gx, gy, w4, h4, mv, refs[i8], sid)
                _fill_part_state(C, gx, gy, w4, h4, mvdx, mvdy, refs[i8])
                blocks.append((ox8 + sx, oy8 + sy, w4, h4, refs[i8], mv))
        no_small_parts = all(t == 0 for t in subs)

    bits = 0
    for i in range(4):
        inc_i = _cbp_luma_incs(C, mbx, mby, left_mb, top_mb, bits)[i]
        bits |= dec.decode(st, mps, 73 + inc_i) << i
    cbp_l = bits
    a0 = 1 if left_mb and C.cbp_c[mby, mbx - 1] else 0
    b0 = 1 if top_mb and C.cbp_c[mby - 1, mbx] else 0
    if dec.decode(st, mps, 77 + a0 + 2 * b0):
        a1 = 1 if left_mb and C.cbp_c[mby, mbx - 1] == 2 else 0
        b1 = 1 if top_mb and C.cbp_c[mby - 1, mbx] == 2 else 0
        cbp_c = 1 + dec.decode(st, mps, 81 + a1 + 2 * b1)
    else:
        cbp_c = 0
    use_t8 = False
    if (getattr(ctx, "t8_enabled", False) and cbp_l > 0
            and no_small_parts):
        fa = 1 if left_mb and C.t8[mby, mbx - 1] else 0
        fb = 1 if top_mb and C.t8[mby - 1, mbx] else 0
        use_t8 = bool(dec.decode(st, mps, 399 + fa + fb))
    if cbp_l or cbp_c:
        _apply_qp_delta(ctx, _dec_qp_delta(dec, st, mps, C))
    else:
        C.last_dqp_nz = 0

    l_zz = np.zeros((4, 4, 16), np.int32)
    zz8 = np.zeros((2, 2, 64), np.int32)
    if use_t8:
        for i8 in range(4):
            y8, x8 = i8 >> 1, i8 & 1
            if (cbp_l >> i8) & 1:
                zz8[y8, x8] = _decode_residual8(dec, st, mps)
                nz = np.count_nonzero(
                    np.asarray(zz8[y8, x8]).reshape(4, 16), axis=1
                )
                C.nnz_y[4 * mby + 2 * y8:4 * mby + 2 * y8 + 2,
                        4 * mbx + 2 * x8:4 * mbx + 2 * x8 + 2] = 1
                # deblock nnz: distribute the 8x8 count over its 4x4s
                ctx.nnz_y[4 * mby + 2 * y8:4 * mby + 2 * y8 + 2,
                          4 * mbx + 2 * x8:4 * mbx + 2 * x8 + 2] = (
                    nz.reshape(2, 2)
                )
            else:
                C.nnz_y[4 * mby + 2 * y8:4 * mby + 2 * y8 + 2,
                        4 * mbx + 2 * x8:4 * mbx + 2 * x8 + 2] = 0
                ctx.nnz_y[4 * mby + 2 * y8:4 * mby + 2 * y8 + 2,
                          4 * mbx + 2 * x8:4 * mbx + 2 * x8 + 2] = 0
    else:
        for i8 in range(4):
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                if (cbp_l >> i8) & 1:
                    inc = _cbf_inc_4x4(
                        C.nnz_y, gbx, gby, bx > 0 or left_mb,
                        by > 0 or top_mb, 0
                    )
                    blk, cbf = _decode_residual(dec, st, mps, 2, 16, inc)
                    l_zz[by, bx] = blk
                    C.nnz_y[gby, gbx] = cbf
                    ctx.nnz_y[gby, gbx] = int(
                        np.count_nonzero(np.asarray(blk))
                    )
                else:
                    C.nnz_y[gby, gbx] = 0
                    ctx.nnz_y[gby, gbx] = 0
    C.dc_y[mby, mbx] = 0
    dcu, dcv, acu, acv = _cabac_chroma(
        dec, st, mps, C, ctx, mbx, mby, left_mb, top_mb, cbp_c, un=0
    )
    _recon_inter_mb(ctx, dpb, mbx, mby, sid, blocks, l_zz, zz8,
                    use_t8, dcu, dcv, acu, acv, cbp_c)
    C.skip[mby, mbx] = 0
    C.not_i4[mby, mbx] = 1
    C.cmode[mby, mbx] = 0
    C.cbp_l[mby, mbx] = cbp_l
    C.cbp_c[mby, mbx] = cbp_c
    C.t8[mby, mbx] = 1 if use_t8 else 0
    C.i4[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = -1
    ctx.i4modes[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = -1


def _cabac_mb_i(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                left_mb, top_mb, rbsp) -> None:
    """I-slice macroblock: mb_type prefix at ctx 3 + neighbor inc, then
    I_NxN or the I_16x16 suffix (explicit ctxs 6..10)."""
    inc = (1 if left_mb and C.not_i4[mby, mbx - 1] else 0) + (
        1 if top_mb and C.not_i4[mby - 1, mbx] else 0
    )
    if dec.decode(st, mps, 3 + inc) == 0:
        _cabac_i44(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                   left_mb, top_mb, in_p=False)
        return
    if dec.terminate():
        _cabac_ipcm(dec, rbsp, C, ctx, mbx, mby, sid)
        return
    cbp_l16 = dec.decode(st, mps, 6)
    if dec.decode(st, mps, 7):
        cbp_c = 1 + dec.decode(st, mps, 8)
    else:
        cbp_c = 0
    pred_mode = (dec.decode(st, mps, 9) << 1) | dec.decode(st, mps, 10)
    _cabac_i16(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
               left_mb, top_mb, pred_mode, cbp_l16, cbp_c, un=1)


# -- slice level --------------------------------------------------------------


def decode_slice_cabac(rbsp: bytes, header, sps, pps, ctx, dpb, sid,
                       C: CabacFrameCtx) -> None:
    """Decode one CABAC slice's data into the golden frame context.

    `rbsp` is the full slice NAL payload (emulation-prevention already
    removed); the CABAC engine starts at the byte boundary after the
    slice header (header.header_bits + cabac_alignment_one_bits)."""
    if header.slice_type not in (SLICE_I, SLICE_P):
        raise NotImplementedError(f"slice_type {header.slice_type}")
    qp = 26 + pps.pic_init_qp_minus26 + header.slice_qp_delta
    table = (
        CTX_INIT_I if header.slice_type == SLICE_I
        else CTX_INIT_PB[header.cabac_init_idc]
    )
    st, mps = init_contexts(table, qp)
    dec = CabacDecoder(rbsp, (header.header_bits + 7) // 8)
    mbw, mbh = sps.mb_width, sps.mb_height
    n_mbs = mbw * mbh
    slice_start = header.first_mb_in_slice
    addr = slice_start
    C.last_dqp_nz = 0
    is_p = header.slice_type == SLICE_P
    while True:
        if addr >= n_mbs:
            raise ValueError("CABAC slice ran past the last macroblock")
        mby, mbx = divmod(addr, mbw)
        left_mb = mbx > 0 and addr > slice_start
        top_mb = addr - mbw >= slice_start
        if is_p:
            sinc = (1 if left_mb and not C.skip[mby, mbx - 1] else 0) + (
                1 if top_mb and not C.skip[mby - 1, mbx] else 0
            )
            if dec.decode(st, mps, 11 + sinc):
                _apply_skip(ctx, dpb, mbx, mby, sid)
                C.skip[mby, mbx] = 1
                C.last_dqp_nz = 0
                C.not_i4[mby, mbx] = 0
                C.cmode[mby, mbx] = 0
                C.cbp_l[mby, mbx] = 0
                C.cbp_c[mby, mbx] = 0
                C.t8[mby, mbx] = 0
                C.i4[4 * mby:4 * mby + 4, 4 * mbx:4 * mbx + 4] = -1
                ctx.i4modes[4 * mby:4 * mby + 4,
                            4 * mbx:4 * mbx + 4] = -1
                from ..entropy.cabac_pack import _mb_zero_p

                _mb_zero_p(C, mbx, mby)
                _mb_zero_entropy(C, mbx, mby, intra_mb=False)
            else:
                _cabac_mb_p(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                            left_mb, top_mb, rbsp)
        else:
            _cabac_mb_i(dec, st, mps, C, ctx, dpb, mbx, mby, sid,
                        left_mb, top_mb, rbsp)
        addr += 1
        if dec.terminate():  # end_of_slice_flag
            break
