# Copy of tpuh264/golden/codec.py, so that the port imports nothing of tpuh264.
"""Golden (numpy) H.264 I-frame codec: baseline profile, Intra_16x16, CAVLC.

This is the reference-model implementation of BASELINE.json config 1
(I-frame-only encode->decode roundtrip).  It is deliberately scalar-clear:
the TPU encoder in tpuh264.kernels must produce bit-identical streams and
the TPU decoder identical reconstructions (tests enforce both), and
libavcodec must agree with our decoder on our streams.

The codec loop the reference outsources to libopenh264.a
(ISVCEncoder::EncodeFrame at reference/openh264_wrapper.cpp:351)
lives here in explicit form.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np

from ..core import nal
from ..core.bitstream import BitReader, BitWriter
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_I, SliceHeader
from ..entropy.cavlc import decode_residual_block, encode_residual_block
from . import intra
from .transform import (
    chroma_qp,
    dequant4x4,
    dequant_chroma_dc,
    dequant_luma_dc,
    forward4x4,
    hadamard2x2,
    hadamard4x4,
    idct_add,
    inverse_zigzag,
    quant4x4,
    quant_chroma_dc,
    quant_luma_dc,
    zigzag,
    blocks4_to_plane,
    plane_to_blocks4,
)

# luma4x4BlkIdx scan order (H.264 6.4.3): (bx, by) in 4x4-block units
BLK_SCAN = [
    (0, 0), (1, 0), (0, 1), (1, 1),
    (2, 0), (3, 0), (2, 1), (3, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
    (2, 2), (3, 2), (2, 3), (3, 3),
]


def pad_to_mb(plane: np.ndarray, mb: int = 16) -> np.ndarray:
    """Edge-replicate a plane to a multiple of ``mb`` in both dims."""
    h, w = plane.shape
    ph = (h + mb - 1) // mb * mb
    pw = (w + mb - 1) // mb * mb
    if ph == h and pw == w:
        return plane.astype(np.int32)
    return np.pad(
        plane.astype(np.int32), ((0, ph - h), (0, pw - w)), mode="edge"
    )


def _nc(nnz: np.ndarray, bx: int, by: int, left_ok: bool, top_ok: bool) -> int:
    """nC for a block at global block coords (bx, by) (H.264 9.2.1)."""
    na = int(nnz[by, bx - 1]) if left_ok else None
    nb = int(nnz[by - 1, bx]) if top_ok else None
    if na is not None and nb is not None:
        return (na + nb + 1) >> 1
    if na is not None:
        return na
    if nb is not None:
        return nb
    return 0


def _block_avail(b: int, mb_edge_avail: bool) -> Tuple[bool, bool]:
    """(left_ok-at-block-0, unused) helper replaced inline; kept for clarity."""
    raise NotImplementedError


def reconstruct_luma_mb(
    pred: np.ndarray, dc_zz: np.ndarray, ac_zz: np.ndarray, qp: int, cbp_luma: bool
) -> np.ndarray:
    """pred (16,16); dc_zz (16,) zigzag DC levels; ac_zz (4,4,15) per-block AC."""
    dcq = inverse_zigzag(dc_zz.astype(np.int32))  # (4,4) block raster [by][bx]
    dc_deq = dequant_luma_dc(dcq, qp)
    coeffs = np.zeros((4, 4, 16), dtype=np.int32)
    if cbp_luma:
        coeffs[:, :, 1:] = ac_zz
    blocks = inverse_zigzag(coeffs)  # (4,4,4,4)
    d = dequant4x4(blocks, qp)
    d[..., 0, 0] = dc_deq
    pred_blocks = plane_to_blocks4(pred)
    return blocks4_to_plane(idct_add(pred_blocks, d))


def reconstruct_chroma_mb(
    pred: np.ndarray, dc: np.ndarray, ac_zz: np.ndarray, qpc: int, cbp_chroma: int
) -> np.ndarray:
    """pred (8,8); dc (4,) raster DC levels; ac_zz (2,2,15)."""
    dcq = dc.astype(np.int32).reshape(2, 2)
    dc_deq = dequant_chroma_dc(dcq, qpc) if cbp_chroma >= 1 else np.zeros((2, 2), np.int32)
    coeffs = np.zeros((2, 2, 16), dtype=np.int32)
    if cbp_chroma == 2:
        coeffs[:, :, 1:] = ac_zz
    blocks = inverse_zigzag(coeffs)
    d = dequant4x4(blocks, qpc)
    d[..., 0, 0] = dc_deq
    pred_blocks = plane_to_blocks4(pred)
    return blocks4_to_plane(idct_add(pred_blocks, d))


@dataclasses.dataclass
class _MBContext:
    """Shared per-frame state for the causal MB scan."""

    recon_y: np.ndarray
    recon_u: np.ndarray
    recon_v: np.ndarray
    nnz_y: np.ndarray  # (4*mbh, 4*mbw)
    nnz_u: np.ndarray  # (2*mbh, 2*mbw)
    nnz_v: np.ndarray
    slice_id: np.ndarray  # (mbh, mbw) int, -1 = not yet coded
    qp: int
    qpc: int
    # inter state (P slices)
    mv: np.ndarray = None      # (mbh, mbw, 2) quarter-pel MVs
    kind: np.ndarray = None    # (mbh, mbw) inter.MB_SKIP/INTER/INTRA
    i4modes: np.ndarray = None  # (4*mbh, 4*mbw) I4x4 modes, -1 = n/a
    intra44: bool = False
    refidx: np.ndarray = None  # (mbh, mbw) per-MB refIdxL0 (multi-ref DPB)
    nra: int = 1               # num_ref_idx_l0_active
    force_ref: int = -1        # encoder: restrict ME to one DPB entry
    t8: np.ndarray = None      # (mbh, mbw) transform_size_8x8_flag per MB
    t8_enabled: bool = False   # PPS transform_8x8_mode_flag
    # 4x4-block-granular inter state for GENERAL streams (partitions
    # smaller than 16x16; H.264 8.4.1.3 predicts at this granularity)
    mv4: np.ndarray = None     # (4*mbh, 4*mbw, 2)
    ref4: np.ndarray = None    # (4*mbh, 4*mbw), -1 = intra
    avail4: np.ndarray = None  # (4*mbh, 4*mbw) slice id, -1 = undecoded
    cqp_off: int = 0           # PPS chroma_qp_index_offset
    qp_map: np.ndarray = None  # (mbh, mbw) per-MB QP as decoded (8.7.2)
    gmv: list = None           # per-DPB-entry (gy, gx) global MV (encoder)
    intra_in_p: bool = True    # encoder: consider intra16 MBs in P slices
    # explicit weighted prediction (decode, 8.4.2.3.2): per-slice list
    # [(luma_w, luma_o, [[cb_w, cb_o], [cr_w, cr_o]])] per refIdx, plus
    # the log2 denominators; None = unweighted
    wp: object = None
    wp_luma_d: int = 0
    wp_chroma_d: int = 0


def _new_ctx(mbw: int, mbh: int, qp: int, qpc: int,
             cqp_off: int = 0) -> "_MBContext":
    return _MBContext(
        recon_y=np.zeros((16 * mbh, 16 * mbw), np.int32),
        recon_u=np.zeros((8 * mbh, 8 * mbw), np.int32),
        recon_v=np.zeros((8 * mbh, 8 * mbw), np.int32),
        nnz_y=np.zeros((4 * mbh, 4 * mbw), np.int32),
        nnz_u=np.zeros((2 * mbh, 2 * mbw), np.int32),
        nnz_v=np.zeros((2 * mbh, 2 * mbw), np.int32),
        slice_id=np.full((mbh, mbw), -1, np.int32),
        qp=qp,
        qpc=qpc,
        mv=np.zeros((mbh, mbw, 2), np.int32),
        kind=np.full((mbh, mbw), 2, np.int32),
        i4modes=np.full((4 * mbh, 4 * mbw), -1, np.int32),
        refidx=np.zeros((mbh, mbw), np.int32),
        t8=np.zeros((mbh, mbw), np.int32),
        mv4=np.zeros((4 * mbh, 4 * mbw, 2), np.int32),
        ref4=np.full((4 * mbh, 4 * mbw), -1, np.int32),
        avail4=np.full((4 * mbh, 4 * mbw), -1, np.int32),
        cqp_off=cqp_off,
        qp_map=np.full((mbh, mbw), qp, np.int32),
    )


def _mb_grid_update(ctx: "_MBContext", mbx: int, mby: int, sid: int) -> None:
    """Mirror a whole-MB state write into the 4x4-granular grids
    (uniform partitions: skip / 16x16 inter / intra)."""
    k = int(ctx.kind[mby, mbx])
    ref = -1 if k == inter_mod.MB_INTRA else int(ctx.refidx[mby, mbx])
    ctx.mv4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = ctx.mv[mby, mbx]
    ctx.ref4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = ref
    ctx.avail4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = sid


def _set_blocks4(ctx, gx, gy, w4, h4, mv, ref, sid) -> None:
    ctx.mv4[gy : gy + h4, gx : gx + w4] = mv
    ctx.ref4[gy : gy + h4, gx : gx + w4] = ref
    ctx.avail4[gy : gy + h4, gx : gx + w4] = sid


def _apply_qp_delta(ctx: "_MBContext", delta: int) -> None:
    """mb_qp_delta accumulation (7.4.5: QPY = (QPY_prev + delta + 52) % 52)."""
    if delta:
        ctx.qp = (ctx.qp + delta + 52) % 52
        ctx.qpc = chroma_qp(ctx.qp, ctx.cqp_off)


def _neighbors_luma(ctx: _MBContext, mbx: int, mby: int, sid: int):
    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid
    y0, x0 = 16 * mby, 16 * mbx
    top = ctx.recon_y[y0 - 1, x0 : x0 + 16] if top_ok else np.zeros(16, np.int32)
    left = ctx.recon_y[y0 : y0 + 16, x0 - 1] if left_ok else np.zeros(16, np.int32)
    corner = int(ctx.recon_y[y0 - 1, x0 - 1]) if (top_ok and left_ok) else 0
    return left_ok, top_ok, top, left, corner


def _neighbors_chroma(plane, mbx, mby, left_ok, top_ok):
    y0, x0 = 8 * mby, 8 * mbx
    top = plane[y0 - 1, x0 : x0 + 8] if top_ok else np.zeros(8, np.int32)
    left = plane[y0 : y0 + 8, x0 - 1] if left_ok else np.zeros(8, np.int32)
    corner = int(plane[y0 - 1, x0 - 1]) if (top_ok and left_ok) else 0
    return top, left, corner


def _luma_nc(ctx, mbx, mby, bx, by, left_mb_ok, top_mb_ok):
    gbx, gby = 4 * mbx + bx, 4 * mby + by
    left_ok = bx > 0 or left_mb_ok
    top_ok = by > 0 or top_mb_ok
    return _nc(ctx.nnz_y, gbx, gby, left_ok, top_ok)


def _chroma_nc(nnz, mbx, mby, bx, by, left_mb_ok, top_mb_ok):
    gbx, gby = 2 * mbx + bx, 2 * mby + by
    left_ok = bx > 0 or left_mb_ok
    top_ok = by > 0 or top_mb_ok
    return _nc(nnz, gbx, gby, left_ok, top_ok)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------

def _encode_mb(
    w: BitWriter,
    ctx: _MBContext,
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    mbx: int,
    mby: int,
    sid: int,
) -> None:
    qp, qpc = ctx.qp, ctx.qpc
    left_ok, top_ok, top, left, corner = _neighbors_luma(ctx, mbx, mby, sid)
    y0, x0 = 16 * mby, 16 * mbx
    src = y[y0 : y0 + 16, x0 : x0 + 16]

    # --- luma mode decision (SAD over available modes) ---
    best_mode, best_pred, best_cost = None, None, None
    for mode in intra.luma16_available_modes(top_ok, left_ok):
        p = intra.pred16(mode, top, left, corner, top_ok, left_ok)
        cost = int(np.abs(src - p).sum())
        if best_cost is None or cost < best_cost:
            best_mode, best_pred, best_cost = mode, p, cost
    pred = best_pred

    if getattr(ctx, "intra44", False):
        _, _, coeffs44, _, rec44 = _code_i44_luma(ctx, y, mbx, mby, sid, False)
        # RD mode decision on reconstruction SSD + estimated rate
        # (JM-style lambda_mode = 0.85 * 2^((QP-12)/3), fixed-point x64).
        # The SAD+bias heuristic lost to I16's DC-Hadamard on smooth
        # content; comparing actual reconstructions fixes that.
        rec16, dcq16, acz16 = _trial_intra16(src, pred, qp)
        ssd16 = int(((rec16 - src).astype(np.int64) ** 2).sum())
        ssd44 = int(((rec44 - src).astype(np.int64) ** 2).sum())
        r16 = 8 + _coeff_bits(dcq16) + _coeff_bits(acz16)
        r44 = 96 + _coeff_bits(coeffs44)
        lam8 = LAMBDA8_MODE[min(max(qp, 0), 51)]
        if 8 * ssd44 + lam8 * r44 < 8 * ssd16 + lam8 * r16:
            _write_i44_mb(w, ctx, y, u, v, mbx, mby, sid)
            return

    # --- luma transform & quant ---
    resid = src - pred
    wblocks = forward4x4(plane_to_blocks4(resid))  # (4,4,4,4)
    dc = wblocks[..., 0, 0]
    dcq_zz = zigzag(quant_luma_dc(hadamard4x4(dc), qp))  # (16,)
    acq = quant4x4(wblocks, qp, intra=True)
    ac_zz = zigzag(acq)[..., 1:]  # (4,4,15)
    cbp_luma = bool(np.any(ac_zz))

    # --- chroma mode decision ---
    topu, leftu, corneru = _neighbors_chroma(ctx.recon_u, mbx, mby, left_ok, top_ok)
    topv, leftv, cornerv = _neighbors_chroma(ctx.recon_v, mbx, mby, left_ok, top_ok)
    c0, cx0 = 8 * mby, 8 * mbx
    srcu = u[c0 : c0 + 8, cx0 : cx0 + 8]
    srcv = v[c0 : c0 + 8, cx0 : cx0 + 8]
    best_cmode, best_cpred, best_ccost = None, None, None
    for mode in intra.chroma_available_modes(top_ok, left_ok):
        pu = intra.pred8(mode, topu, leftu, corneru, top_ok, left_ok)
        pv = intra.pred8(mode, topv, leftv, cornerv, top_ok, left_ok)
        cost = int(np.abs(srcu - pu).sum()) + int(np.abs(srcv - pv).sum())
        if best_ccost is None or cost < best_ccost:
            best_cmode, best_cpred, best_ccost = mode, (pu, pv), cost
    predu, predv = best_cpred

    # --- chroma transform & quant ---
    def chroma_fwd(srcc, predc):
        wc = forward4x4(plane_to_blocks4(srcc - predc))  # (2,2,4,4)
        dcc = quant_chroma_dc(hadamard2x2(wc[..., 0, 0]), qpc)
        acc = zigzag(quant4x4(wc, qpc, intra=True))[..., 1:]  # (2,2,15)
        return dcc, acc

    dcu, acu = chroma_fwd(srcu, predu)
    dcv, acv = chroma_fwd(srcv, predv)
    any_ac = bool(np.any(acu)) or bool(np.any(acv))
    any_dc = bool(np.any(dcu)) or bool(np.any(dcv))
    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)

    # --- reconstruction (must match the decoder exactly) ---
    rec_y = reconstruct_luma_mb(pred, dcq_zz, ac_zz, qp, cbp_luma)
    rec_u = reconstruct_chroma_mb(predu, dcu.reshape(4), acu, qpc, cbp_chroma)
    rec_v = reconstruct_chroma_mb(predv, dcv.reshape(4), acv, qpc, cbp_chroma)
    ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = rec_y
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = rec_u
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = rec_v

    # --- syntax ---
    mb_type = 1 + best_mode + 4 * cbp_chroma + 12 * (1 if cbp_luma else 0)
    w.ue(mb_type)
    w.ue(best_cmode)
    w.se(0)  # mb_qp_delta (always present for I16x16)

    # Intra16x16DCLevel: nC as for luma block 0
    nc0 = _luma_nc(ctx, mbx, mby, 0, 0, left_ok, top_ok)
    encode_residual_block(w, dcq_zz.tolist(), nc0, 16)

    # AC blocks in luma4x4BlkIdx scan order; update nnz as we go
    if cbp_luma:
        for bx, by in BLK_SCAN:
            ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
            block = ac_zz[by, bx]
            encode_residual_block(w, block.tolist(), ncb, 15)
            ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(np.count_nonzero(block))
    else:
        ctx.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0

    if cbp_chroma:
        encode_residual_block(w, dcu.reshape(4).tolist(), -1, 4)
        encode_residual_block(w, dcv.reshape(4).tolist(), -1, 4)
    if cbp_chroma == 2:
        for comp, (nnz_c, ac) in enumerate(((ctx.nnz_u, acu), (ctx.nnz_v, acv))):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                block = ac[by, bx]
                encode_residual_block(w, block.tolist(), ncb, 15)
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(np.count_nonzero(block))
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)


def encode_iframe(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    qp: int = 28,
    slice_mode: str = "rows",
    frame_num: int = 0,
    idr: bool = True,
    include_ps: bool = True,
    sps: Optional[SPS] = None,
    pps: Optional[PPS] = None,
    deblock: bool = False,
    intra44: bool = False,
) -> Tuple[bytes, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Encode one I-frame.  Returns (annexb bytes, padded recon planes)."""
    height, width = y.shape
    if sps is None:
        sps = SPS.for_size(width, height)
    if pps is None:
        pps = PPS()
    mbw, mbh = sps.mb_width, sps.mb_height
    yp, up, vp = pad_to_mb(y, 16), pad_to_mb(u, 8), pad_to_mb(v, 8)

    ctx = _new_ctx(mbw, mbh, qp, chroma_qp(qp, pps.chroma_qp_index_offset))
    ctx.intra44 = intra44

    out = bytearray()
    if include_ps:
        w = BitWriter()
        sps.write(w)
        out += nal.wrap_nal(nal.NAL_SPS, w.get_bytes())
        w = BitWriter()
        pps.write(w)
        out += nal.wrap_nal(nal.NAL_PPS, w.get_bytes())

    if slice_mode == "rows":
        slices = [(r, list((r, c) for c in range(mbw))) for r in range(mbh)]
    elif slice_mode == "single":
        slices = [(0, [(r, c) for r in range(mbh) for c in range(mbw)])]
    else:
        raise ValueError(slice_mode)

    slice_qp_delta = qp - 26 - pps.pic_init_qp_minus26
    idc = 2 if deblock else 1
    for sid, (_, mbs) in enumerate(slices):
        w = BitWriter()
        header = SliceHeader(
            first_mb_in_slice=mbs[0][0] * mbw + mbs[0][1],
            slice_type=SLICE_I,
            frame_num=frame_num,
            slice_qp_delta=slice_qp_delta,
            disable_deblocking_filter_idc=idc,
        )
        header.write(w, sps, pps, idr)
        for mby, mbx in mbs:
            _encode_mb(w, ctx, yp, up, vp, mbx, mby, sid)
        w.rbsp_trailing_bits()
        ntype = nal.NAL_SLICE_IDR if idr else nal.NAL_SLICE_NON_IDR
        out += nal.wrap_nal(ntype, w.get_bytes(), nal_ref_idc=3)

    if deblock:
        from .deblock import deblock_frame

        deblock_frame(
            ctx.recon_y, ctx.recon_u, ctx.recon_v, ctx.nnz_y,
            ctx.kind, ctx.mv, ctx.slice_id, qp, idc=idc,
            chroma_qp_offset=pps.chroma_qp_index_offset,
            refidx=ctx.refidx, t8=ctx.t8,
        )
    return bytes(out), (ctx.recon_y, ctx.recon_u, ctx.recon_v)


# ---------------------------------------------------------------------------
# Decoder
# ---------------------------------------------------------------------------

def _decode_mb(
    r: BitReader, ctx: _MBContext, mbx: int, mby: int, sid: int
) -> None:
    qp, qpc = ctx.qp, ctx.qpc
    mb_type = r.ue()
    if mb_type == 0:
        _decode_i44_mb(r, ctx, mbx, mby, sid)
        return
    if mb_type == 25:
        _decode_ipcm_mb(r, ctx, mbx, mby, sid)
        return
    if not 1 <= mb_type <= 24:
        raise NotImplementedError(f"mb_type {mb_type}")
    t = mb_type - 1
    pred_mode = t % 4
    cbp_chroma = (t // 4) % 3
    cbp_luma = t >= 12
    cmode = r.ue()
    _apply_qp_delta(ctx, r.se())
    qp, qpc = ctx.qp, ctx.qpc

    left_ok, top_ok, top, left, corner = _neighbors_luma(ctx, mbx, mby, sid)
    pred = intra.pred16(pred_mode, top, left, corner, top_ok, left_ok)

    nc0 = _luma_nc(ctx, mbx, mby, 0, 0, left_ok, top_ok)
    dc_zz = np.array(decode_residual_block(r, nc0, 16), dtype=np.int32)

    ac_zz = np.zeros((4, 4, 15), dtype=np.int32)
    if cbp_luma:
        for bx, by in BLK_SCAN:
            ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
            block = decode_residual_block(r, ncb, 15)
            ac_zz[by, bx] = block
            ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(
                np.count_nonzero(np.array(block))
            )
    else:
        ctx.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0

    dcu = np.zeros(4, np.int32)
    dcv = np.zeros(4, np.int32)
    acu = np.zeros((2, 2, 15), np.int32)
    acv = np.zeros((2, 2, 15), np.int32)
    if cbp_chroma:
        dcu = np.array(decode_residual_block(r, -1, 4), dtype=np.int32)
        dcv = np.array(decode_residual_block(r, -1, 4), dtype=np.int32)
    if cbp_chroma == 2:
        for nnz_c, ac in ((ctx.nnz_u, acu), (ctx.nnz_v, acv)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                block = decode_residual_block(r, ncb, 15)
                ac[by, bx] = block
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(np.array(block))
                )
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    topu, leftu, corneru = _neighbors_chroma(ctx.recon_u, mbx, mby, left_ok, top_ok)
    topv, leftv, cornerv = _neighbors_chroma(ctx.recon_v, mbx, mby, left_ok, top_ok)
    predu = intra.pred8(cmode, topu, leftu, corneru, top_ok, left_ok)
    predv = intra.pred8(cmode, topv, leftv, cornerv, top_ok, left_ok)

    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = reconstruct_luma_mb(
        pred, dc_zz, ac_zz, qp, cbp_luma
    )
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu, acu, qpc, cbp_chroma
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv, acv, qpc, cbp_chroma
    )
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)


def decode_annexb(
    data: bytes,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Decode an annex-B stream of one I-frame; returns cropped Y, U, V."""
    sps: Optional[SPS] = None
    pps: Optional[PPS] = None
    ctx: Optional[_MBContext] = None
    sid = 0
    for _, ntype, rbsp in nal.split_annexb(data):
        if ntype == nal.NAL_SPS:
            sps = SPS.parse(BitReader(rbsp))
        elif ntype == nal.NAL_PPS:
            pps = PPS.parse(BitReader(rbsp))
        elif ntype in (nal.NAL_SLICE_IDR, nal.NAL_SLICE_NON_IDR):
            assert sps is not None and pps is not None, "missing SPS/PPS"
            mbw, mbh = sps.mb_width, sps.mb_height
            if ctx is None:
                ctx = _new_ctx(
                    mbw, mbh, 0, 0, cqp_off=pps.chroma_qp_index_offset
                )
            r = BitReader(rbsp)
            header = SliceHeader.parse(r, sps, pps, ntype == nal.NAL_SLICE_IDR)
            qp = 26 + pps.pic_init_qp_minus26 + header.slice_qp_delta
            ctx.qp = qp
            ctx.qpc = chroma_qp(qp, pps.chroma_qp_index_offset)
            addr = header.first_mb_in_slice
            while r.more_rbsp_data():
                mby, mbx = divmod(addr, mbw)
                _decode_mb(r, ctx, mbx, mby, sid)
                addr += 1
            sid += 1
    assert ctx is not None and sps is not None, "no slice data"
    return (
        ctx.recon_y[: sps.height, : sps.width],
        ctx.recon_u[: sps.height // 2, : sps.width // 2],
        ctx.recon_v[: sps.height // 2, : sps.width // 2],
    )


# ---------------------------------------------------------------------------
# P-frames (BASELINE.json config 2): integer-pel single-reference inter
# prediction with P_Skip / P_L0_16x16 / Intra_16x16 macroblocks.
# ---------------------------------------------------------------------------

from ..core.sliceheader import SLICE_P  # noqa: E402
from ..entropy.cavlc_tables import CBP_INTER_INV, CBP_INTRA  # noqa: E402
from . import inter as inter_mod  # noqa: E402


def _intra16_decide(ctx, src, mbx, mby, sid):
    """Shared I16x16 mode decision; returns (mode, pred, sad)."""
    left_ok, top_ok, top, left, corner = _neighbors_luma(ctx, mbx, mby, sid)
    best_mode, best_pred, best_cost = None, None, None
    for mode in intra.luma16_available_modes(top_ok, left_ok):
        p = intra.pred16(mode, top, left, corner, top_ok, left_ok)
        cost = int(np.abs(src - p).sum())
        if best_cost is None or cost < best_cost:
            best_mode, best_pred, best_cost = mode, p, cost
    return best_mode, best_pred, best_cost


def _chroma_decide(ctx, u, v, mbx, mby, sid):
    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid
    topu, leftu, corneru = _neighbors_chroma(ctx.recon_u, mbx, mby, left_ok, top_ok)
    topv, leftv, cornerv = _neighbors_chroma(ctx.recon_v, mbx, mby, left_ok, top_ok)
    c0, cx0 = 8 * mby, 8 * mbx
    srcu = u[c0 : c0 + 8, cx0 : cx0 + 8]
    srcv = v[c0 : c0 + 8, cx0 : cx0 + 8]
    best_cmode, best_cpred, best_ccost = None, None, None
    for mode in intra.chroma_available_modes(top_ok, left_ok):
        pu = intra.pred8(mode, topu, leftu, corneru, top_ok, left_ok)
        pv = intra.pred8(mode, topv, leftv, cornerv, top_ok, left_ok)
        cost = int(np.abs(srcu - pu).sum()) + int(np.abs(srcv - pv).sum())
        if best_ccost is None or cost < best_ccost:
            best_cmode, best_cpred, best_ccost = mode, (pu, pv), cost
    return best_cmode, best_cpred


def _write_intra16_mb(w, ctx, y, u, v, mbx, mby, sid, in_p_slice):
    """I16x16 MB coding shared between I slices and intra MBs in P slices."""
    qp, qpc = ctx.qp, ctx.qpc
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    src = y[y0 : y0 + 16, x0 : x0 + 16]
    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid

    best_mode, pred, _ = _intra16_decide(ctx, src, mbx, mby, sid)
    resid = src - pred
    wblocks = forward4x4(plane_to_blocks4(resid))
    dcq_zz = zigzag(quant_luma_dc(hadamard4x4(wblocks[..., 0, 0]), qp))
    ac_zz = zigzag(quant4x4(wblocks, qp, intra=True))[..., 1:]
    cbp_luma = bool(np.any(ac_zz))

    best_cmode, (predu, predv) = _chroma_decide(ctx, u, v, mbx, mby, sid)
    srcu = u[c0 : c0 + 8, cx0 : cx0 + 8]
    srcv = v[c0 : c0 + 8, cx0 : cx0 + 8]

    def chroma_fwd(srcc, predc):
        wc = forward4x4(plane_to_blocks4(srcc - predc))
        dcc = quant_chroma_dc(hadamard2x2(wc[..., 0, 0]), qpc, intra=True)
        acc = zigzag(quant4x4(wc, qpc, intra=True))[..., 1:]
        return dcc, acc

    dcu, acu = chroma_fwd(srcu, predu)
    dcv, acv = chroma_fwd(srcv, predv)
    any_ac = bool(np.any(acu)) or bool(np.any(acv))
    any_dc = bool(np.any(dcu)) or bool(np.any(dcv))
    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)

    ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = reconstruct_luma_mb(
        pred, dcq_zz, ac_zz, qp, cbp_luma
    )
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu.reshape(4), acu, qpc, cbp_chroma
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv.reshape(4), acv, qpc, cbp_chroma
    )

    icode = 1 + best_mode + 4 * cbp_chroma + 12 * (1 if cbp_luma else 0)
    w.ue(icode + 5 if in_p_slice else icode)
    w.ue(best_cmode)
    w.se(0)  # mb_qp_delta

    nc0 = _luma_nc(ctx, mbx, mby, 0, 0, left_ok, top_ok)
    encode_residual_block(w, dcq_zz.tolist(), nc0, 16)
    if cbp_luma:
        for bx, by in BLK_SCAN:
            ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
            block = ac_zz[by, bx]
            encode_residual_block(w, block.tolist(), ncb, 15)
            ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(np.count_nonzero(block))
    else:
        ctx.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
    _write_chroma_residual(w, ctx, mbx, mby, left_ok, top_ok, cbp_chroma,
                           dcu, dcv, acu, acv)
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)
    ctx.kind[mby, mbx] = inter_mod.MB_INTRA
    ctx.mv[mby, mbx] = 0


def _write_chroma_residual(w, ctx, mbx, mby, left_ok, top_ok, cbp_chroma,
                           dcu, dcv, acu, acv):
    if cbp_chroma:
        encode_residual_block(w, dcu.reshape(4).tolist(), -1, 4)
        encode_residual_block(w, dcv.reshape(4).tolist(), -1, 4)
    if cbp_chroma == 2:
        for nnz_c, ac in ((ctx.nnz_u, acu), (ctx.nnz_v, acv)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                block = ac[by, bx]
                encode_residual_block(w, block.tolist(), ncb, 15)
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(np.count_nonzero(block))
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def _weight_pred(pred, w, o, d):
    """Explicit weighted-sample prediction (8.4.2.3.2) on one plane."""
    if d >= 1:
        v = ((pred * w + (1 << (d - 1))) >> d) + o
    else:
        v = pred * w + o
    return np.clip(v, 0, 255)


def _wp_apply(ctx, ref, predl, predu, predv):
    """Apply the slice's explicit weights for refIdx `ref` (no-op when
    the slice is unweighted).  Returns possibly-new pred arrays."""
    if ctx.wp is None:
        return predl, predu, predv
    lw, lo, cwo = ctx.wp[min(ref, len(ctx.wp) - 1)]
    predl = _weight_pred(predl, lw, lo, ctx.wp_luma_d)
    predu = _weight_pred(predu, cwo[0][0], cwo[0][1], ctx.wp_chroma_d)
    predv = _weight_pred(predv, cwo[1][0], cwo[1][1], ctx.wp_chroma_d)
    return predl, predu, predv


def _apply_skip(ctx, dpb, mbx, mby, sid):
    """Reconstruct a P_Skip MB and update all state (references DPB[0])."""
    refy, refu, refv, planes = dpb[0]
    mvx, mvy = inter_mod.skip_mv_block(
        ctx.mv4, ctx.ref4, ctx.avail4, 4 * mbx, 4 * mby, sid
    )
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    pl, pu, pv = _wp_apply(
        ctx, 0,
        inter_mod.mc_luma_qpel(planes, mbx, mby, mvx, mvy),
        inter_mod.mc_chroma(refu, mbx, mby, mvx, mvy),
        inter_mod.mc_chroma(refv, mbx, mby, mvx, mvy),
    )
    ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = pl
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = pu
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = pv
    ctx.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
    ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    ctx.mv[mby, mbx] = (mvx, mvy)
    ctx.kind[mby, mbx] = inter_mod.MB_SKIP
    ctx.refidx[mby, mbx] = 0
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)


def _encode_mb_p(w, skiprun, ctx, y, u, v, dpb, mbx, mby, sid):
    """Encode one MB of a P slice (may defer to the skip-run counter).

    dpb: list of (refy, refu, refv, halfpel planes), newest first.  With
    ctx.force_ref >= 0 the search is restricted to that DPB entry
    (temporal-layer referencing); otherwise every active reference is
    searched and the lowest SAD wins (ties to the smaller index)."""
    qp, qpc = ctx.qp, ctx.qpc
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    src = y[y0 : y0 + 16, x0 : x0 + 16]

    mv_skip = inter_mod.skip_mv(
        ctx.mv, ctx.kind, ctx.slice_id, mbx, mby, sid, ctx.refidx
    )
    cand_refs = (
        [ctx.force_ref] if ctx.force_ref >= 0 else list(range(len(dpb)))
    )
    best = None  # (biased cost, sad, ref, mvx, mvy)
    lam_me = inter_mod.LAMBDA_ME[min(max(qp, 0), 51)]
    for ri in cand_refs:
        gmv = ctx.gmv[ri] if ctx.gmv is not None else (0, 0)
        mvx_r, mvy_r, sad_r, cost_r = inter_mod.motion_search_qpel(
            src, dpb[ri][0], dpb[ri][3], mbx, mby, qp, gmv
        )
        # rate-bias the reference choice by its te(v) signaling cost
        # (inter_mod.ref_idx_bits): ties and near-ties stay on ref 0,
        # preserving P_Skip reachability
        cost_r = cost_r + lam_me * inter_mod.ref_idx_bits(ri, ctx.nra)
        if best is None or cost_r < best[0]:
            best = (cost_r, sad_r, ri, mvx_r, mvy_r)
    _, inter_sad, ref_i, mvx, mvy = best
    pmv = inter_mod.predict_mv(
        ctx.mv, ctx.kind, ctx.slice_id, mbx, mby, sid, ctx.refidx, ref_i
    )
    refy, refu, refv, planes = dpb[ref_i]
    if ctx.intra_in_p:
        # intra16 candidate (disabled by the RTC speed preset: the
        # kernels' intra_in_p=False fast path matches this bit-exactly)
        _, _, intra_sad = _intra16_decide(ctx, src, mbx, mby, sid)
        if intra_sad < inter_sad:
            w.ue(skiprun[0])
            skiprun[0] = 0
            _write_intra16_mb(w, ctx, y, u, v, mbx, mby, sid,
                              in_p_slice=True)
            return

    # inter residual: 4x4 transform, plus the 8x8 trial when enabled
    predl = inter_mod.mc_luma_qpel(planes, mbx, mby, mvx, mvy)
    resid = src - predl
    q = quant4x4(forward4x4(plane_to_blocks4(resid)), qp, intra=False)
    l_zz = zigzag(q)  # (4,4,16) full 16-coefficient blocks
    cbp_luma = 0
    for i8 in range(4):
        blocks = [l_zz[by, bx] for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]]
        if any(np.any(b) for b in blocks):
            cbp_luma |= 1 << i8

    use_t8 = False
    zz8 = None
    if ctx.t8_enabled:
        blk8 = resid.reshape(2, 8, 2, 8).swapaxes(1, 2)  # (y8, x8, 8, 8)
        z8 = t8mod.quant8x8(t8mod.forward8x8(blk8), qp, intra=False)
        zz8 = t8mod.zigzag8(z8)  # (2, 2, 64)
        cbp8 = 0
        for y8 in range(2):
            for x8 in range(2):
                if np.any(zz8[y8, x8]):
                    cbp8 |= 1 << (2 * y8 + x8)
        if cbp_luma or cbp8:  # flag only coded when cbp_luma > 0
            rec4 = blocks4_to_plane(
                idct_add(plane_to_blocks4(predl), dequant4x4(q, qp))
            )
            pred8 = predl.reshape(2, 8, 2, 8).swapaxes(1, 2)
            rec8 = t8mod.idct8_add(
                pred8, t8mod.dequant8x8(z8, qp)
            ).swapaxes(1, 2).reshape(16, 16)
            lam8 = LAMBDA8_MODE[min(max(qp, 0), 51)]
            j4 = 8 * int(((rec4 - src).astype(np.int64) ** 2).sum()) + \
                lam8 * _coeff_bits(l_zz)
            j8 = 8 * int(((rec8 - src).astype(np.int64) ** 2).sum()) + \
                lam8 * (_coeff_bits(zz8) + 1)
            use_t8 = j8 < j4 and cbp8 > 0
            if use_t8:
                cbp_luma = cbp8

    predu = inter_mod.mc_chroma(refu, mbx, mby, mvx, mvy)
    predv = inter_mod.mc_chroma(refv, mbx, mby, mvx, mvy)
    srcu = u[c0 : c0 + 8, cx0 : cx0 + 8]
    srcv = v[c0 : c0 + 8, cx0 : cx0 + 8]

    def chroma_fwd(srcc, predc):
        wc = forward4x4(plane_to_blocks4(srcc - predc))
        dcc = quant_chroma_dc(hadamard2x2(wc[..., 0, 0]), qpc, intra=False)
        acc = zigzag(quant4x4(wc, qpc, intra=False))[..., 1:]
        return dcc, acc

    dcu, acu = chroma_fwd(srcu, predu)
    dcv, acv = chroma_fwd(srcv, predv)
    any_ac = bool(np.any(acu)) or bool(np.any(acv))
    any_dc = bool(np.any(dcu)) or bool(np.any(dcv))
    cbp_chroma = 2 if any_ac else (1 if any_dc else 0)

    if (cbp_luma == 0 and cbp_chroma == 0 and ref_i == 0
            and (mvx, mvy) == mv_skip):
        skiprun[0] += 1
        _apply_skip(ctx, dpb, mbx, mby, sid)
        ctx.t8[mby, mbx] = 0
        return

    # reconstruction (zero out 4x4 blocks of uncoded 8x8s -- no-op by
    # construction, but mirror the decoder structure)
    if use_t8:
        d8 = t8mod.dequant8x8(t8mod.inverse_zigzag8(zz8), qp)
        pred8 = predl.reshape(2, 8, 2, 8).swapaxes(1, 2)
        rec8 = t8mod.idct8_add(pred8, d8).swapaxes(1, 2).reshape(16, 16)
        ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = rec8
    else:
        recon_q = np.zeros_like(l_zz)
        for i8 in range(4):
            if cbp_luma >> i8 & 1:
                for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                    recon_q[by, bx] = l_zz[by, bx]
        d = dequant4x4(inverse_zigzag(recon_q), qp)
        ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = blocks4_to_plane(
            idct_add(plane_to_blocks4(predl), d)
        )
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu.reshape(4), acu, qpc, cbp_chroma
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv.reshape(4), acv, qpc, cbp_chroma
    )

    # syntax
    w.ue(skiprun[0])
    skiprun[0] = 0
    w.ue(0)  # mb_type P_L0_16x16
    if ctx.nra > 1:  # ref_idx_l0, te(v) with cMax = nra-1
        if ctx.nra == 2:
            w.u(1, 1 - ref_i)
        else:
            w.ue(ref_i)
    w.se(mvx - pmv[0])
    w.se(mvy - pmv[1])
    w.ue(CBP_INTER_INV[cbp_luma | (cbp_chroma << 4)])
    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid
    if ctx.t8_enabled and cbp_luma > 0:
        w.u(1, 1 if use_t8 else 0)  # transform_size_8x8_flag
    if cbp_luma or cbp_chroma:
        w.se(0)  # mb_qp_delta
    for i8 in range(4):
        if cbp_luma >> i8 & 1:
            for k4, (bx, by) in enumerate(BLK_SCAN[4 * i8 : 4 * i8 + 4]):
                ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
                if use_t8:
                    # CAVLC 8x8: 4x4 block k gets every 4th 8x8 coeff
                    block = zz8[i8 >> 1, i8 & 1][k4::4]
                else:
                    block = l_zz[by, bx]
                encode_residual_block(w, block.tolist(), ncb, 16)
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(np.count_nonzero(block))
        else:
            for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = 0
    _write_chroma_residual(w, ctx, mbx, mby, left_ok, top_ok, cbp_chroma,
                           dcu, dcv, acu, acv)
    ctx.mv[mby, mbx] = (mvx, mvy)
    ctx.kind[mby, mbx] = inter_mod.MB_INTER
    ctx.refidx[mby, mbx] = ref_i
    ctx.t8[mby, mbx] = 1 if use_t8 else 0
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)


def as_dpb(refs):
    """Normalize reference input to a DPB list of 4-tuples with half-pel
    planes (newest first)."""
    if isinstance(refs, tuple) and len(refs) in (3, 4):
        refs = [refs]
    out = []
    for entry in refs:
        if len(entry) == 3:
            entry = (*entry, inter_mod.build_halfpel_planes(entry[0]))
        out.append(entry)
    return out


def encode_pframe(
    y: np.ndarray,
    u: np.ndarray,
    v: np.ndarray,
    refs,
    qp: int = 28,
    slice_mode: str = "rows",
    frame_num: int = 1,
    sps: Optional[SPS] = None,
    pps: Optional[PPS] = None,
    deblock: bool = False,
    ref: bool = True,
    force_ref: int = -1,
    intra_in_p: bool = True,
) -> Tuple[bytes, Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Encode one P-frame against a reference DPB.

    `refs` is a single (y, u, v[, planes]) tuple or a list of them
    (newest first); with more than one entry, ref_idx_l0 is signaled and
    num_ref_idx_l0_active is overridden in the slice headers.  `ref`
    False marks a non-reference (temporal enhancement layer) picture;
    `force_ref` restricts motion search to one DPB entry (temporal-layer
    prediction structure).  Returns (annexb bytes, recon planes)."""
    height, width = y.shape
    if sps is None:
        sps = SPS.for_size(width, height)
    if pps is None:
        pps = PPS()
    mbw, mbh = sps.mb_width, sps.mb_height
    yp, up, vp = pad_to_mb(y, 16), pad_to_mb(u, 8), pad_to_mb(v, 8)
    ctx = _new_ctx(mbw, mbh, qp, chroma_qp(qp, pps.chroma_qp_index_offset))
    dpb = as_dpb(refs)
    ctx.nra = len(dpb)
    ctx.force_ref = force_ref
    ctx.intra_in_p = intra_in_p
    ctx.t8_enabled = pps.transform_8x8_mode_flag == 1
    # phase 1 of the coherent-field search: per-reference global MV
    # (mode of stage-A winners; see inter.global_mv)
    ctx.gmv = [
        inter_mod.global_mv(yp, dpb[ri][0], qp) for ri in range(len(dpb))
    ]

    if slice_mode == "rows":
        slices = [(r, [(r, c) for c in range(mbw)]) for r in range(mbh)]
    elif slice_mode == "single":
        slices = [(0, [(r, c) for r in range(mbh) for c in range(mbw)])]
    else:
        raise ValueError(slice_mode)

    out = bytearray()
    slice_qp_delta = qp - 26 - pps.pic_init_qp_minus26
    idc = 2 if deblock else 1
    for sid, (_, mbs) in enumerate(slices):
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=mbs[0][0] * mbw + mbs[0][1],
            slice_type=SLICE_P,
            frame_num=frame_num % (1 << (sps.log2_max_frame_num_minus4 + 4)),
            slice_qp_delta=slice_qp_delta,
            disable_deblocking_filter_idc=idc,
            num_ref_idx_l0_active_minus1=ctx.nra - 1,
        ).write(w, sps, pps, idr=False, ref=ref)
        skiprun = [0]
        for mby, mbx in mbs:
            _encode_mb_p(w, skiprun, ctx, yp, up, vp, dpb, mbx, mby, sid)
        if skiprun[0]:
            w.ue(skiprun[0])
        w.rbsp_trailing_bits()
        out += nal.wrap_nal(
            nal.NAL_SLICE_NON_IDR, w.get_bytes(), nal_ref_idc=2 if ref else 0
        )
    if deblock:
        from .deblock import deblock_frame

        deblock_frame(
            ctx.recon_y, ctx.recon_u, ctx.recon_v, ctx.nnz_y,
            ctx.kind, ctx.mv, ctx.slice_id, qp, idc=idc,
            chroma_qp_offset=pps.chroma_qp_index_offset,
            refidx=ctx.refidx, t8=ctx.t8,
        )
    return bytes(out), (ctx.recon_y, ctx.recon_u, ctx.recon_v)


def _decode_mb_p(r, ctx, dpb, mbx, mby, sid):
    """Decode one P-slice MB: P_L0_16x16 / 16x8 / 8x16 / P_8x8[ref0] with
    8x4/4x8/4x4 sub-partitions (7.3.5.1, 8.4.1.3), plus the intra MB
    types legal in P slices (I_NxN / I_16x16 / I_PCM).  This is the
    general path a third-party stream exercises; our own encoder emits
    only the 16x16 subset (reference analog: DecodeFrameNoDelay accepts
    arbitrary baseline streams, openh264_wrapper.cpp:391-422)."""
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    mb_type = r.ue()
    if mb_type >= 5:
        icode = mb_type - 5
        if icode == 0:
            _decode_i44_mb(r, ctx, mbx, mby, sid, in_p_slice=True)
            return
        if icode == 25:
            _decode_ipcm_mb(r, ctx, mbx, mby, sid)
            return
        _decode_intra16_in_p(r, ctx, icode, mbx, mby, sid)
        return
    if mb_type > 4:
        raise NotImplementedError(f"P mb_type {mb_type}")

    gx0, gy0 = 4 * mbx, 4 * mby

    def read_ref() -> int:
        if ctx.nra <= 1:
            return 0
        return (1 - r.u(1)) if ctx.nra == 2 else r.ue()

    # partition geometry in 4x4-block units: (ox, oy, w4, h4, special)
    blocks = []  # (ox, oy, w4, h4, ref, (mvx, mvy))
    if mb_type in (0, 1, 2):
        geo = {
            0: [(0, 0, 4, 4, None)],
            1: [(0, 0, 4, 2, "16x8_top"), (0, 2, 4, 2, "16x8_bot")],
            2: [(0, 0, 2, 4, "8x16_left"), (2, 0, 2, 4, "8x16_right")],
        }[mb_type]
        refs = [read_ref() for _ in geo]
        for (ox, oy, w4, h4, special), ref in zip(geo, refs):
            mvdx, mvdy = r.se(), r.se()
            pmv = inter_mod.predict_mv_block(
                ctx.mv4, ctx.ref4, ctx.avail4,
                gx0 + ox, gy0 + oy, w4, h4, sid, ref, special,
            )
            mv = (pmv[0] + mvdx, pmv[1] + mvdy)
            _set_blocks4(ctx, gx0 + ox, gy0 + oy, w4, h4, mv, ref, sid)
            blocks.append((ox, oy, w4, h4, ref, mv))
        no_small_parts = mb_type in (0, 1, 2)
    else:  # P_8x8 (3) / P_8x8ref0 (4)
        subs = [r.ue() for _ in range(4)]
        if max(subs) > 3:
            raise NotImplementedError(f"sub_mb_type {max(subs)}")
        SUBGEO = {
            0: [(0, 0, 2, 2)],
            1: [(0, 0, 2, 1), (0, 1, 2, 1)],
            2: [(0, 0, 1, 2), (1, 0, 1, 2)],
            3: [(0, 0, 1, 1), (1, 0, 1, 1), (0, 1, 1, 1), (1, 1, 1, 1)],
        }
        refs = (
            [0] * 4 if mb_type == 4 else [read_ref() for _ in range(4)]
        )
        for i8 in range(4):
            ox8, oy8 = 2 * (i8 & 1), 2 * (i8 >> 1)
            for (sx, sy, w4, h4) in SUBGEO[subs[i8]]:
                mvdx, mvdy = r.se(), r.se()
                pmv = inter_mod.predict_mv_block(
                    ctx.mv4, ctx.ref4, ctx.avail4,
                    gx0 + ox8 + sx, gy0 + oy8 + sy, w4, h4, sid, refs[i8],
                )
                mv = (pmv[0] + mvdx, pmv[1] + mvdy)
                _set_blocks4(
                    ctx, gx0 + ox8 + sx, gy0 + oy8 + sy, w4, h4, mv,
                    refs[i8], sid,
                )
                blocks.append((ox8 + sx, oy8 + sy, w4, h4, refs[i8], mv))
        no_small_parts = all(t == 0 for t in subs)

    from ..entropy.cavlc_tables import CBP_INTER

    cbp = CBP_INTER[r.ue()]
    cbp_luma = cbp & 15
    cbp_chroma = cbp >> 4
    use_t8 = False
    if ctx.t8_enabled and cbp_luma > 0 and no_small_parts:
        use_t8 = bool(r.u(1))  # transform_size_8x8_flag
    if cbp:
        _apply_qp_delta(ctx, r.se())
    qp, qpc = ctx.qp, ctx.qpc
    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid

    l_zz = np.zeros((4, 4, 16), np.int32)
    zz8 = np.zeros((2, 2, 64), np.int32)
    for i8 in range(4):
        if cbp_luma >> i8 & 1:
            for k4, (bx, by) in enumerate(BLK_SCAN[4 * i8 : 4 * i8 + 4]):
                ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
                block = decode_residual_block(r, ncb, 16)
                if use_t8:
                    zz8[i8 >> 1, i8 & 1][k4::4] = block
                else:
                    l_zz[by, bx] = block
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
        else:
            for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = 0

    dcu = np.zeros(4, np.int32)
    dcv = np.zeros(4, np.int32)
    acu = np.zeros((2, 2, 15), np.int32)
    acv = np.zeros((2, 2, 15), np.int32)
    if cbp_chroma:
        dcu = np.array(decode_residual_block(r, -1, 4), np.int32)
        dcv = np.array(decode_residual_block(r, -1, 4), np.int32)
    if cbp_chroma == 2:
        for nnz_c, ac in ((ctx.nnz_u, acu), (ctx.nnz_v, acv)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                block = decode_residual_block(r, ncb, 15)
                ac[by, bx] = block
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    _recon_inter_mb(ctx, dpb, mbx, mby, sid, blocks, l_zz, zz8,
                    use_t8, dcu, dcv, acu, acv, cbp_chroma)


def _recon_inter_mb(ctx, dpb, mbx, mby, sid, blocks, l_zz, zz8, use_t8,
                    dcu, dcv, acu, acv, cbp_chroma):
    """Reconstruct an inter MB from parsed partitions + residuals.

    Shared by the CAVLC (_decode_mb_p) and CABAC (cabac_slice) slice
    decoders -- the entropy layers differ, the reconstruction (8.4.2,
    8.5) is identical.  `blocks` = [(ox, oy, w4, h4, ref, (mvx, mvy))]
    in 4x4-block units."""
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    qp, qpc = ctx.qp, ctx.qpc
    # motion compensation per partition, then residual reconstruction
    predl = np.zeros((16, 16), np.int32)
    predu = np.zeros((8, 8), np.int32)
    predv = np.zeros((8, 8), np.int32)
    for (ox, oy, w4, h4, ref, (mvx, mvy)) in blocks:
        refy, refu, refv, planes = dpb[min(ref, len(dpb) - 1)]
        pl, pu, pv = _wp_apply(
            ctx, ref,
            inter_mod.mc_luma_qpel_at(
                planes, x0 + 4 * ox, y0 + 4 * oy, 4 * w4, 4 * h4, mvx,
                mvy,
            ),
            inter_mod.mc_chroma_at(
                refu, cx0 + 2 * ox, c0 + 2 * oy, 2 * w4, 2 * h4, mvx, mvy
            ),
            inter_mod.mc_chroma_at(
                refv, cx0 + 2 * ox, c0 + 2 * oy, 2 * w4, 2 * h4, mvx, mvy
            ),
        )
        predl[4 * oy : 4 * oy + 4 * h4, 4 * ox : 4 * ox + 4 * w4] = pl
        predu[2 * oy : 2 * oy + 2 * h4, 2 * ox : 2 * ox + 2 * w4] = pu
        predv[2 * oy : 2 * oy + 2 * h4, 2 * ox : 2 * ox + 2 * w4] = pv

    if use_t8:
        d8 = t8mod.dequant8x8(t8mod.inverse_zigzag8(zz8), qp)
        pred8 = predl.reshape(2, 8, 2, 8).swapaxes(1, 2)
        ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = t8mod.idct8_add(
            pred8, d8
        ).swapaxes(1, 2).reshape(16, 16)
    else:
        d = dequant4x4(inverse_zigzag(l_zz), qp)
        ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = blocks4_to_plane(
            idct_add(plane_to_blocks4(predl), d)
        )
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu, acu, qpc, cbp_chroma
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv, acv, qpc, cbp_chroma
    )
    # per-MB summaries (deblock & legacy callers): last partition MV
    ctx.mv[mby, mbx] = blocks[-1][5]
    ctx.kind[mby, mbx] = inter_mod.MB_INTER
    ctx.refidx[mby, mbx] = blocks[0][4]
    ctx.t8[mby, mbx] = 1 if use_t8 else 0
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp


def _decode_ipcm_mb(r, ctx, mbx, mby, sid):
    """I_PCM (7.3.5, 8.3.5): byte-aligned raw samples; neighbors treat
    every block as having 16 coded coefficients (9.2.1)."""
    while not r.byte_aligned():
        r.u(1)  # pcm_alignment_zero_bit
    ymb = np.array([r.u(8) for _ in range(256)], np.int32).reshape(16, 16)
    umb = np.array([r.u(8) for _ in range(64)], np.int32).reshape(8, 8)
    vmb = np.array([r.u(8) for _ in range(64)], np.int32).reshape(8, 8)
    _apply_ipcm_samples(ctx, mbx, mby, sid, ymb, umb, vmb)


def _decode_intra16_in_p(r, ctx, icode, mbx, mby, sid):
    """Decode an I16x16 MB appearing inside a P slice."""
    if not 1 <= icode <= 24:
        raise NotImplementedError(f"intra code {icode} in P slice")
    t = icode - 1
    pred_mode = t % 4
    cbp_chroma = (t // 4) % 3
    cbp_luma = t >= 12
    cmode = r.ue()
    _apply_qp_delta(ctx, r.se())
    qp, qpc = ctx.qp, ctx.qpc
    left_ok, top_ok, top, left, corner = _neighbors_luma(ctx, mbx, mby, sid)
    pred = intra.pred16(pred_mode, top, left, corner, top_ok, left_ok)
    nc0 = _luma_nc(ctx, mbx, mby, 0, 0, left_ok, top_ok)
    dc_zz = np.array(decode_residual_block(r, nc0, 16), np.int32)
    ac_zz = np.zeros((4, 4, 15), np.int32)
    if cbp_luma:
        for bx, by in BLK_SCAN:
            ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
            block = decode_residual_block(r, ncb, 15)
            ac_zz[by, bx] = block
            ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(
                np.count_nonzero(np.asarray(block))
            )
    else:
        ctx.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
    dcu = np.zeros(4, np.int32)
    dcv = np.zeros(4, np.int32)
    acu = np.zeros((2, 2, 15), np.int32)
    acv = np.zeros((2, 2, 15), np.int32)
    if cbp_chroma:
        dcu = np.array(decode_residual_block(r, -1, 4), np.int32)
        dcv = np.array(decode_residual_block(r, -1, 4), np.int32)
    if cbp_chroma == 2:
        for nnz_c, ac in ((ctx.nnz_u, acu), (ctx.nnz_v, acv)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                block = decode_residual_block(r, ncb, 15)
                ac[by, bx] = block
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    _recon_i16_mb(ctx, mbx, mby, sid, pred, cmode, dc_zz, ac_zz,
                  cbp_luma, cbp_chroma, dcu, dcv, acu, acv,
                  left_ok, top_ok)


def _recon_i16_mb(ctx, mbx, mby, sid, pred, cmode, dc_zz, ac_zz,
                  cbp_luma, cbp_chroma, dcu, dcv, acu, acv,
                  left_ok, top_ok):
    """Reconstruct an I_16x16 MB from the parsed prediction + residuals
    (shared by the CAVLC and CABAC slice decoders)."""
    qp, qpc = ctx.qp, ctx.qpc
    topu, leftu, corneru = _neighbors_chroma(ctx.recon_u, mbx, mby, left_ok, top_ok)
    topv, leftv, cornerv = _neighbors_chroma(ctx.recon_v, mbx, mby, left_ok, top_ok)
    predu = intra.pred8(cmode, topu, leftu, corneru, top_ok, left_ok)
    predv = intra.pred8(cmode, topv, leftv, cornerv, top_ok, left_ok)
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = reconstruct_luma_mb(
        pred, dc_zz, ac_zz, qp, cbp_luma
    )
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu, acu, qpc, cbp_chroma
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv, acv, qpc, cbp_chroma
    )
    ctx.kind[mby, mbx] = inter_mod.MB_INTRA
    ctx.mv[mby, mbx] = 0
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)


class StreamDecoder:
    """Incremental annex-B stream decoder (the general path).

    Accepts any CAVLC baseline stream our golden toolset covers --
    including third-party (libx264/OpenH264) streams with P partitions,
    sub-partitions, mb_qp_delta, I_PCM and multiple slices (see
    tests/test_conformance_reverse.py) -- and maintains the DPB across
    feeds, so it can serve as the engine DecoderSession's fallback when
    a stream uses syntax outside the TPU fast path.  Reference analog:
    the per-stream ISVCDecoder instances behind DecodeFrameNoDelay
    (reference/openh264_wrapper.cpp:240-280, 391-422).
    """

    def __init__(self) -> None:
        self.sps: Optional[SPS] = None
        self.pps: Optional[PPS] = None
        self.ctx: Optional[_MBContext] = None
        self.cabac_ctx = None  # per-frame CABAC neighbor-context state
        self.dpb: List = []
        self.dpb_fnums: List[int] = []  # frame_num per DPB entry (PicNum)
        self.cur_frame_num = 0
        self.sid = 0
        self.frame_idc = 1
        self.frame_is_ref = True
        self.frame_is_idr = False

    def _finish(self):
        """Close the current picture: deblock, crop, DPB update."""
        ctx, sps, pps = self.ctx, self.sps, self.pps
        if ctx is None:
            return None
        if self.frame_idc != 1:
            from .deblock import deblock_frame

            deblock_frame(
                ctx.recon_y, ctx.recon_u, ctx.recon_v, ctx.nnz_y,
                ctx.kind, ctx.mv, ctx.slice_id, ctx.qp,
                idc=self.frame_idc,
                chroma_qp_offset=pps.chroma_qp_index_offset,
                refidx=ctx.refidx, t8=ctx.t8,
                # general-stream state: per-MB QP (mb_qp_delta / I_PCM)
                # and 4x4-granular motion for bS -- third-party streams
                # with adaptive quant + partitions deblock normatively
                # (advisor round-2 finding; ROADMAP deblock-granularity)
                qp_map=ctx.qp_map, mv4=ctx.mv4, ref4=ctx.ref4,
            )
        frame = (
            ctx.recon_y[: sps.height, : sps.width].copy(),
            ctx.recon_u[: sps.height // 2, : sps.width // 2].copy(),
            ctx.recon_v[: sps.height // 2, : sps.width // 2].copy(),
        )
        if self.frame_is_ref:
            if self.frame_is_idr:
                self.dpb = []  # IDR clears the reference buffer
                self.dpb_fnums = []
            ry = ctx.recon_y.copy()
            self.dpb.insert(0, (
                ry, ctx.recon_u.copy(), ctx.recon_v.copy(),
                inter_mod.build_halfpel_planes(ry),
            ))
            self.dpb_fnums.insert(0, self.cur_frame_num)
            del self.dpb[max(1, sps.max_num_ref_frames):]  # sliding window
            del self.dpb_fnums[max(1, sps.max_num_ref_frames):]
        self.ctx = None
        self.cabac_ctx = None
        return frame

    def _ref_list_l0(self, header, sps) -> List:
        """Per-slice L0 reference list (8.2.4): the DPB in default
        (descending-PicNum == insertion) order, permuted by the slice's
        ref_pic_list_modification ops (8.2.4.3.1).  Duplicate entries
        are legal and load-bearing: x264's smart weighted prediction
        (weightp=2) lists the same picture twice with different
        pred_weight_table rows."""
        if not header.ref_list_mods:
            return self.dpb
        max_fn = 1 << (sps.log2_max_frame_num_minus4 + 4)
        cur = header.frame_num
        nra = header.num_ref_idx_l0_active_minus1 + 1
        pnums = [fn if fn <= cur else fn - max_fn for fn in self.dpb_fnums]
        lst = list(range(len(self.dpb)))[:nra]
        pred, ridx = cur, 0
        for idc, diff in header.ref_list_mods:
            if idc == 0:
                nowrap = pred - (diff + 1)
                if nowrap < 0:
                    nowrap += max_fn
            else:
                nowrap = pred + (diff + 1)
                if nowrap >= max_fn:
                    nowrap -= max_fn
            pred = nowrap
            pnum = nowrap if nowrap <= cur else nowrap - max_fn
            if pnum not in pnums:
                raise ValueError(
                    f"ref_pic_list_modification: PicNum {pnum} not in DPB"
                )
            k = pnums.index(pnum)
            lst.insert(ridx, k)
            ridx += 1
            # purge later occurrences of the moved picture (8.2.4.3.1)
            lst = lst[:ridx] + [j for j in lst[ridx:] if j != k]
        return [self.dpb[i] for i in lst[:nra]]

    def feed(self, data: bytes) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Process annex-B bytes; returns frames COMPLETED by this feed
        (a picture completes when the next picture starts -- call
        flush() to retire the final/pending one)."""
        done: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for ridc, ntype, rbsp in nal.split_annexb(data):
            if ntype == nal.NAL_SPS:
                self.sps = SPS.parse(BitReader(rbsp))
            elif ntype == nal.NAL_PPS:
                self.pps = PPS.parse(BitReader(rbsp))
            elif ntype in (nal.NAL_SLICE_IDR, nal.NAL_SLICE_NON_IDR):
                sps, pps = self.sps, self.pps
                assert sps is not None and pps is not None
                mbw, mbh = sps.mb_width, sps.mb_height
                r = BitReader(rbsp)
                header = SliceHeader.parse(
                    r, sps, pps, ntype == nal.NAL_SLICE_IDR, ref=ridc != 0
                )
                if header.first_mb_in_slice == 0:
                    f = self._finish()
                    if f is not None:
                        done.append(f)
                    self.frame_is_ref = ridc != 0
                    self.frame_is_idr = ntype == nal.NAL_SLICE_IDR
                qp = 26 + pps.pic_init_qp_minus26 + header.slice_qp_delta
                if self.ctx is None:
                    self.ctx = _new_ctx(
                        mbw, mbh, qp,
                        chroma_qp(qp, pps.chroma_qp_index_offset),
                        cqp_off=pps.chroma_qp_index_offset,
                    )
                    self.ctx.t8_enabled = pps.transform_8x8_mode_flag == 1
                    self.sid = 0
                ctx = self.ctx
                # SliceQPY resets the mb_qp_delta accumulator (7.4.5)
                ctx.qp = qp
                ctx.qpc = chroma_qp(qp, pps.chroma_qp_index_offset)
                # explicit weighted prediction state (per slice)
                ctx.wp = header.weights_l0
                ctx.wp_luma_d = header.luma_log2_weight_denom
                ctx.wp_chroma_d = header.chroma_log2_weight_denom
                self.frame_idc = header.disable_deblocking_filter_idc
                self.cur_frame_num = header.frame_num
                addr = header.first_mb_in_slice
                sid = self.sid
                if pps.entropy_coding_mode_flag:
                    # CABAC slice data (third-party Main/High streams)
                    from .cabac_slice import (
                        CabacFrameCtx, decode_slice_cabac,
                    )

                    if self.cabac_ctx is None:
                        self.cabac_ctx = CabacFrameCtx(mbw, mbh)
                    dpb_l0 = self.dpb
                    if header.slice_type == SLICE_P:
                        assert self.dpb, "P slice without reference"
                        ctx.nra = (
                            header.num_ref_idx_l0_active_minus1 + 1
                        )
                        dpb_l0 = self._ref_list_l0(header, sps)
                    decode_slice_cabac(
                        rbsp, header, sps, pps, ctx, dpb_l0, sid,
                        self.cabac_ctx,
                    )
                elif header.slice_type == SLICE_P:
                    assert self.dpb, "P slice without reference"
                    ctx.nra = header.num_ref_idx_l0_active_minus1 + 1
                    dpb_l0 = self._ref_list_l0(header, sps)
                    while r.more_rbsp_data():
                        run = r.ue()
                        for _ in range(run):
                            mby, mbx = divmod(addr, mbw)
                            _apply_skip(ctx, dpb_l0, mbx, mby, sid)
                            addr += 1
                        if not r.more_rbsp_data():
                            break
                        mby, mbx = divmod(addr, mbw)
                        _decode_mb_p(r, ctx, dpb_l0, mbx, mby, sid)
                        addr += 1
                else:
                    while r.more_rbsp_data():
                        mby, mbx = divmod(addr, mbw)
                        _decode_mb(r, ctx, mbx, mby, sid)
                        addr += 1
                self.sid += 1
        return done

    def flush(self) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        f = self._finish()
        return [f] if f is not None else []

    def decode_au(self, data: bytes):
        """Decode one complete access unit -> (Y, U, V) planes."""
        frames = self.feed(data) + self.flush()
        return frames[-1] if frames else None


def decode_annexb_seq(data: bytes) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode an annex-B stream containing a sequence of I and P frames.

    Frames are delimited by frame_num / first_mb_in_slice==0 boundaries.
    Returns a list of cropped (Y, U, V) per decoded frame.
    """
    d = StreamDecoder()
    return d.feed(data) + d.flush()


def encode_sequence(
    frames,
    qp: int = 28,
    gop: int = 30,
    slice_mode: str = "rows",
    deblock: bool = False,
    temporal_layers: int = 1,
    num_ref: int = 1,
    transform8x8: bool = False,
) -> Tuple[bytes, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Encode (y, u, v) frames as IPPP... with IDR every `gop`.

    temporal_layers=2: odd in-GOP frames are non-reference T1 pictures
    predicting from the T0 base layer -- dropping every second frame
    still decodes.
    temporal_layers=3: hierarchical-P period 4 [T0 T2 T1 T2]; T2 frames
    are non-reference, T0 frames reference only the previous T0 through
    the 2-entry DPB (ref_idx 1 past a T1) -- the stream decodes at 3
    rates (BASELINE.json config 4).
    num_ref>1: a sliding-window DPB of that depth with per-MB reference
    search and ref_idx_l0 signaling (config 3's multi-reference)."""
    assert temporal_layers in (1, 2, 3)
    if temporal_layers == 3:
        num_ref = max(num_ref, 2)
    out = bytearray()
    recons = []
    dpb: List = []
    sps = pps = None
    h, w0 = frames[0][0].shape
    if transform8x8:
        from ..core.params import PROFILE_HIGH
        sps = SPS.for_size(w0, h, profile_idc=PROFILE_HIGH,
                           max_num_ref_frames=num_ref)
        pps = PPS(transform_8x8_mode_flag=1)
    elif num_ref > 1:
        sps = SPS.for_size(w0, h, max_num_ref_frames=num_ref)
        pps = PPS()
    for t, (y, u, v) in enumerate(frames):
        k = t % gop
        if k == 0 or not dpb:
            data, recon = encode_iframe(
                y, u, v, qp=qp, slice_mode=slice_mode, frame_num=0,
                idr=True, include_ps=True, sps=sps, pps=pps, deblock=deblock,
            )
            is_ref = True
            dpb = []
        else:
            if sps is None:
                sps = SPS.for_size(y.shape[1], y.shape[0])
                pps = PPS()
            force = -1
            if temporal_layers == 2:
                is_ref = k % 2 == 0
                fnum = (k + 1) // 2
            elif temporal_layers == 3:
                is_ref = k % 2 == 0  # T0/T1 are references, T2 is not
                fnum = (k + 1) // 2
                if k % 4 == 0:  # T0: reference the previous T0
                    force = min(1, len(dpb) - 1)
                else:  # T1/T2: nearest reference
                    force = 0
            else:
                is_ref = True
                fnum = k
            data, recon = encode_pframe(
                y, u, v, dpb[:num_ref] if num_ref > 1 else dpb[0],
                qp=qp, slice_mode=slice_mode,
                frame_num=fnum, sps=sps, pps=pps, deblock=deblock,
                ref=is_ref, force_ref=force,
            )
        out += data
        recons.append(recon)
        if is_ref:
            dpb.insert(0, as_dpb([recon])[0])
            del dpb[num_ref:]
    return bytes(out), recons


# ---------------------------------------------------------------------------
# Intra_4x4 macroblocks (H.264 8.3.1): 9-mode 4x4 prediction with causal
# in-MB reconstruction, prev_intra4x4_pred_mode signaling, Table 9-4 CBP.
# ---------------------------------------------------------------------------

from ..entropy.cavlc_tables import CBP_INTRA, CBP_INTRA_INV  # noqa: E402
from . import intra44 as i44  # noqa: E402
from . import intra8 as i8mod  # noqa: E402
from . import transform8 as t8mod  # noqa: E402

# JM-style mode-decision lambda (SSD domain), fixed point x8 (the scale
# keeps J = 8*SSD + lam8*R inside int32 for the TPU kernel's mirror)
LAMBDA8_MODE = [
    int(0.85 * 2.0 ** ((qp - 12) / 3.0) * 8) for qp in range(52)
]
_POW2_16 = 1 << np.arange(16, dtype=np.int64)


def _coeff_bits(arr) -> int:
    """Cheap rate proxy: sum over nonzero levels of 2*bit_length(|c|)+1
    (~Exp-Golomb length).  Integer-exact; mirrored by kernels/iframe."""
    a = np.abs(np.asarray(arr, np.int64)).ravel()
    a = a[a > 0]
    if a.size == 0:
        return 0
    bl = (a[:, None] >= _POW2_16[None, :]).sum(1)
    return int((2 * bl + 1).sum())


def _trial_intra16(src, pred, qp):
    """Luma-only I16 transform/quant/recon (no state change)."""
    resid = src - pred
    wblocks = forward4x4(plane_to_blocks4(resid))
    dcq_zz = zigzag(quant_luma_dc(hadamard4x4(wblocks[..., 0, 0]), qp))
    ac_zz = zigzag(quant4x4(wblocks, qp, intra=True))[..., 1:]
    cbp = bool(np.any(ac_zz))
    rec = reconstruct_luma_mb(pred, dcq_zz, ac_zz, qp, cbp)
    return rec, dcq_zz, ac_zz


def _i44_neighbors(ctx, gbx, gby, sid):
    """Neighbor samples for the 4x4 block at global block coords."""
    mbw = ctx.slice_id.shape[1]
    y0, x0 = 4 * gby, 4 * gbx

    def mb_ok(bx, by):
        if bx < 0 or by < 0 or bx >= 4 * mbw:
            return False
        return ctx.slice_id[by // 4, bx // 4] == sid or (
            bx // 4 == gbx // 4 and by // 4 == gby // 4
        )

    left_ok = gbx > 0 and mb_ok(gbx - 1, gby)
    top_ok = gby > 0 and mb_ok(gbx, gby - 1)
    # top-right: causal availability (z-scan within MB, raster across MBs)
    tr_ok = False
    if gby > 0 and gbx + 1 < 4 * mbw:
        nbx, nby = gbx + 1, gby - 1
        if nby // 4 < gby // 4:  # in the MB row above
            tr_ok = mb_ok(nbx, nby)
        elif nbx // 4 > gbx // 4:  # top-right MB on the same row: future
            tr_ok = False
        else:  # same MB: must precede in z-scan
            a = BLK_SCAN.index((gbx % 4, gby % 4))
            b = BLK_SCAN.index((nbx % 4, nby % 4))
            tr_ok = b < a
    L = ctx.recon_y[y0 : y0 + 4, x0 - 1] if left_ok else np.zeros(4, np.int32)
    T = ctx.recon_y[y0 - 1, x0 : x0 + 4] if top_ok else np.zeros(4, np.int32)
    if tr_ok:
        TR = ctx.recon_y[y0 - 1, x0 + 4 : x0 + 8].copy()
        if TR.shape[0] < 4:  # frame edge: replicate last available
            TR = np.pad(TR, (0, 4 - TR.shape[0]), mode="edge")
    elif top_ok:
        TR = np.full(4, int(T[3]), np.int32)
    else:
        TR = np.zeros(4, np.int32)
    X = (
        int(ctx.recon_y[y0 - 1, x0 - 1])
        if (left_ok and top_ok)
        else 0
    )
    return L, T, TR, X, left_ok, top_ok


def _i44_pred_mode(i4modes, gbx, gby, left_ok, top_ok):
    ma = i4modes[gby, gbx - 1] if left_ok else -1
    mb = i4modes[gby - 1, gbx] if top_ok else -1
    ma = 2 if ma < 0 else ma
    mb = 2 if mb < 0 else mb
    if not left_ok or not top_ok:
        return 2
    return min(ma, mb)


def _code_i44_luma(ctx, y, mbx, mby, sid, commit: bool):
    """Trial/commit the causal I4x4 luma loop; returns (sad, modes, coeffs,
    cbp_luma, recon_mb).  When commit=False, state is restored."""
    qp = ctx.qp
    y0, x0 = 16 * mby, 16 * mbx
    save = ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16].copy()
    modes = np.zeros(16, np.int32)
    coeffs = np.zeros((16, 16), np.int32)  # zigzag per block, scan order
    sad = 0
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        L, T, TR, X, l_ok, t_ok = _i44_neighbors(ctx, gbx, gby, sid)
        src = y[4 * gby : 4 * gby + 4, 4 * gbx : 4 * gbx + 4]
        best_m, best_p, best_c = None, None, None
        for m in i44.available_modes(l_ok, t_ok):
            p = i44.pred4(m, L, T, TR, X, l_ok, t_ok)
            c = int(np.abs(src - p).sum())
            if best_c is None or c < best_c:
                best_m, best_p, best_c = m, p, c
        sad += best_c
        modes[bi] = best_m
        w4 = forward4x4(src - best_p)
        q = quant4x4(w4, qp, intra=True)
        coeffs[bi] = zigzag(q)
        d = dequant4x4(inverse_zigzag(coeffs[bi]), qp)
        rec = idct_add(best_p, d)
        ctx.recon_y[4 * gby : 4 * gby + 4, 4 * gbx : 4 * gbx + 4] = rec
    cbp = 0
    for i8 in range(4):
        if any(np.any(coeffs[b]) for b in range(4 * i8, 4 * i8 + 4)):
            cbp |= 1 << i8
    rec_mb = ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16].copy()
    if not commit:
        ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = save
    # (committed recon already honors cbp gating: dropped 8x8s are zero)
    return sad, modes, coeffs, cbp, rec_mb


def _write_i44_mb(w, ctx, y, u, v, mbx, mby, sid, in_p_slice=False):
    """Encode one I_4x4 macroblock (luma loop already committed)."""
    qp, qpc = ctx.qp, ctx.qpc
    _, modes, coeffs, cbp_l, _ = _code_i44_luma(ctx, y, mbx, mby, sid, True)

    # chroma (same machinery as I16x16)
    best_cmode, (predu, predv) = _chroma_decide(ctx, u, v, mbx, mby, sid)
    c0, cx0 = 8 * mby, 8 * mbx
    srcu = u[c0 : c0 + 8, cx0 : cx0 + 8]
    srcv = v[c0 : c0 + 8, cx0 : cx0 + 8]

    def chroma_fwd(srcc, predc):
        wc = forward4x4(plane_to_blocks4(srcc - predc))
        dcc = quant_chroma_dc(hadamard2x2(wc[..., 0, 0]), qpc, intra=True)
        acc = zigzag(quant4x4(wc, qpc, intra=True))[..., 1:]
        return dcc, acc

    dcu, acu = chroma_fwd(srcu, predu)
    dcv, acv = chroma_fwd(srcv, predv)
    any_ac = bool(np.any(acu)) or bool(np.any(acv))
    any_dc = bool(np.any(dcu)) or bool(np.any(dcv))
    cbp_c = 2 if any_ac else (1 if any_dc else 0)
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu.reshape(4), acu, qpc, cbp_c
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv.reshape(4), acv, qpc, cbp_c
    )

    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid

    # --- syntax ---
    w.ue(5 if in_p_slice else 0)  # mb_type I_NxN
    if ctx.t8_enabled:
        w.u(1, 0)  # transform_size_8x8_flag: our intra stays 4x4
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        l_ok = gbx > 0 and (bx > 0 or left_ok)
        t_ok = gby > 0 and (by > 0 or top_ok)
        pm = _i44_pred_mode(ctx.i4modes, gbx, gby, l_ok, t_ok)
        m = int(modes[bi])
        if m == pm:
            w.u(1, 1)
        else:
            w.u(1, 0)
            w.u(3, m if m < pm else m - 1)
        ctx.i4modes[gby, gbx] = m
    w.ue(best_cmode)
    w.ue(CBP_INTRA_INV[cbp_l | (cbp_c << 4)])
    if cbp_l or cbp_c:
        w.se(0)  # mb_qp_delta
    for i8 in range(4):
        if cbp_l >> i8 & 1:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
                encode_residual_block(w, coeffs[b].tolist(), ncb, 16)
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(
                    np.count_nonzero(coeffs[b])
                )
        else:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = 0
    _write_chroma_residual(w, ctx, mbx, mby, left_ok, top_ok, cbp_c,
                           dcu, dcv, acu, acv)
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)
    ctx.kind[mby, mbx] = inter_mod.MB_INTRA
    ctx.mv[mby, mbx] = 0


def _decode_i44_mb(r, ctx, mbx, mby, sid, in_p_slice=False):
    qp, qpc = ctx.qp, ctx.qpc
    left_ok = mbx > 0 and ctx.slice_id[mby, mbx - 1] == sid
    top_ok = mby > 0 and ctx.slice_id[mby - 1, mbx] == sid
    if ctx.t8_enabled and r.u(1):  # transform_size_8x8_flag (7.3.5)
        _decode_i8_mb(r, ctx, mbx, mby, sid, left_ok, top_ok)
        return

    modes = np.zeros(16, np.int32)
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        l_ok = gbx > 0 and (bx > 0 or left_ok)
        t_ok = gby > 0 and (by > 0 or top_ok)
        pm = _i44_pred_mode(ctx.i4modes, gbx, gby, l_ok, t_ok)
        if r.u(1):
            m = pm
        else:
            rem = r.u(3)
            m = rem if rem < pm else rem + 1
        modes[bi] = m
        ctx.i4modes[gby, gbx] = m
    cmode = r.ue()
    cbp = CBP_INTRA[r.ue()]
    cbp_l = cbp & 15
    cbp_c = cbp >> 4
    if cbp:
        _apply_qp_delta(ctx, r.se())
    qp, qpc = ctx.qp, ctx.qpc

    coeffs = np.zeros((16, 16), np.int32)
    for i8 in range(4):
        if cbp_l >> i8 & 1:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
                coeffs[b] = decode_residual_block(r, ncb, 16)
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(
                    np.count_nonzero(coeffs[b])
                )
        else:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = 0

    dcu = np.zeros(4, np.int32)
    dcv = np.zeros(4, np.int32)
    acu = np.zeros((2, 2, 15), np.int32)
    acv = np.zeros((2, 2, 15), np.int32)
    if cbp_c:
        dcu = np.array(decode_residual_block(r, -1, 4), np.int32)
        dcv = np.array(decode_residual_block(r, -1, 4), np.int32)
    if cbp_c == 2:
        for nnz_c, ac in ((ctx.nnz_u, acu), (ctx.nnz_v, acv)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                ac[by, bx] = decode_residual_block(r, ncb, 15)
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(ac[by, bx])
                )
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    _recon_i44_mb(ctx, mbx, mby, sid, modes, coeffs, cmode,
                  dcu, dcv, acu, acv, cbp_c, left_ok, top_ok)


def _decode_i8_mb(r, ctx, mbx, mby, sid, left_ok, top_ok):
    """CAVLC Intra_8x8 (High profile): four 8.3.2 pred modes, then each
    coded 8x8's coefficients as 4 interleaved 4x4 CAVLC blocks (the
    8.5.6 zigzag split the inter-t8 path already uses)."""
    modes = np.zeros(4, np.int32)
    for b8 in range(4):
        x8, y8 = b8 & 1, b8 >> 1
        gbx, gby = 4 * mbx + 2 * x8, 4 * mby + 2 * y8
        l_ok = gbx > 0 and (x8 > 0 or left_ok)
        t_ok = gby > 0 and (y8 > 0 or top_ok)
        pm = _i44_pred_mode(ctx.i4modes, gbx, gby, l_ok, t_ok)
        if r.u(1):
            m = pm
        else:
            rem = r.u(3)
            m = rem if rem < pm else rem + 1
        modes[b8] = m
        # replicated-mode grid: neighbor lookups read the covering cell
        ctx.i4modes[gby : gby + 2, gbx : gbx + 2] = m
    cmode = r.ue()
    cbp = CBP_INTRA[r.ue()]
    cbp_l = cbp & 15
    cbp_c = cbp >> 4
    if cbp:
        _apply_qp_delta(ctx, r.se())

    zz8 = np.zeros((2, 2, 64), np.int32)
    for i8 in range(4):
        if cbp_l >> i8 & 1:
            for k4, (bx, by) in enumerate(BLK_SCAN[4 * i8 : 4 * i8 + 4]):
                ncb = _luma_nc(ctx, mbx, mby, bx, by, left_ok, top_ok)
                block = decode_residual_block(r, ncb, 16)
                zz8[i8 >> 1, i8 & 1][k4::4] = block
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
        else:
            for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                ctx.nnz_y[4 * mby + by, 4 * mbx + bx] = 0

    dcu = np.zeros(4, np.int32)
    dcv = np.zeros(4, np.int32)
    acu = np.zeros((2, 2, 15), np.int32)
    acv = np.zeros((2, 2, 15), np.int32)
    if cbp_c:
        dcu = np.array(decode_residual_block(r, -1, 4), np.int32)
        dcv = np.array(decode_residual_block(r, -1, 4), np.int32)
    if cbp_c == 2:
        for nnz_c, ac in ((ctx.nnz_u, acu), (ctx.nnz_v, acv)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = _chroma_nc(nnz_c, mbx, mby, bx, by, left_ok, top_ok)
                ac[by, bx] = decode_residual_block(r, ncb, 15)
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(ac[by, bx])
                )
    else:
        ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    _recon_i8_mb(ctx, mbx, mby, sid, modes, zz8, cmode,
                 dcu, dcv, acu, acv, cbp_c, left_ok, top_ok)
    ctx.t8[mby, mbx] = 1  # deblock skips the internal 4/12 edges (8.7)


def _recon_i44_mb(ctx, mbx, mby, sid, modes, coeffs, cmode,
                  dcu, dcv, acu, acv, cbp_c, left_ok, top_ok):
    """Causal I_NxN reconstruction from parsed modes + residuals
    (shared by the CAVLC and CABAC slice decoders)."""
    qp, qpc = ctx.qp, ctx.qpc
    ctx.slice_id[mby, mbx] = sid  # in-MB neighbor checks
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        L, T, TR, X, l_ok, t_ok = _i44_neighbors(ctx, gbx, gby, sid)
        p = i44.pred4(int(modes[bi]), L, T, TR, X, l_ok, t_ok)
        d = dequant4x4(inverse_zigzag(coeffs[bi]), qp)
        ctx.recon_y[4 * gby : 4 * gby + 4, 4 * gbx : 4 * gbx + 4] = idct_add(
            p, d
        )

    topu, leftu, corneru = _neighbors_chroma(ctx.recon_u, mbx, mby, left_ok, top_ok)
    topv, leftv, cornerv = _neighbors_chroma(ctx.recon_v, mbx, mby, left_ok, top_ok)
    predu = intra.pred8(cmode, topu, leftu, corneru, top_ok, left_ok)
    predv = intra.pred8(cmode, topv, leftv, cornerv, top_ok, left_ok)
    c0, cx0 = 8 * mby, 8 * mbx
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu, acu, qpc, cbp_c
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv, acv, qpc, cbp_c
    )
    ctx.kind[mby, mbx] = inter_mod.MB_INTRA
    ctx.mv[mby, mbx] = 0

def _i8_neighbors(ctx, gx8, gy8, sid):
    """Neighbor samples for the 8x8 luma block at global 8x8-block
    coords (the Intra_8x8 analog of _i44_neighbors): raw L[8]/T[8]/TR[8]
    /corner with the 8.3.2.2 top-right substitution applied; filtering
    happens inside intra8.pred8x8."""
    mbw = ctx.slice_id.shape[1]
    y0, x0 = 8 * gy8, 8 * gx8

    def mb_ok(bx8, by8):
        if bx8 < 0 or by8 < 0 or bx8 >= 2 * mbw:
            return False
        return ctx.slice_id[by8 // 2, bx8 // 2] == sid or (
            bx8 // 2 == gx8 // 2 and by8 // 2 == gy8 // 2
        )

    left_ok = gx8 > 0 and mb_ok(gx8 - 1, gy8)
    top_ok = gy8 > 0 and mb_ok(gx8, gy8 - 1)
    # top-right: causal availability (z-scan within MB, raster across)
    tr_ok = False
    if gy8 > 0 and gx8 + 1 < 2 * mbw:
        nbx, nby = gx8 + 1, gy8 - 1
        if nby // 2 < gy8 // 2:  # in the MB row above
            tr_ok = mb_ok(nbx, nby)
        elif nbx // 2 > gx8 // 2:  # top-right MB on same row: future
            tr_ok = False
        else:  # same MB: the only prior-in-z case is block 2 <- block 1
            tr_ok = (gx8 % 2, gy8 % 2) == (0, 1)
    L = (
        ctx.recon_y[y0 : y0 + 8, x0 - 1]
        if left_ok else np.zeros(8, np.int32)
    )
    T = (
        ctx.recon_y[y0 - 1, x0 : x0 + 8]
        if top_ok else np.zeros(8, np.int32)
    )
    if tr_ok:
        TR = ctx.recon_y[y0 - 1, x0 + 8 : x0 + 16].copy()
        if TR.shape[0] < 8:  # frame edge: replicate last available
            TR = np.pad(TR, (0, 8 - TR.shape[0]), mode="edge")
    elif top_ok:
        TR = np.full(8, int(T[7]), np.int32)
    else:
        TR = np.zeros(8, np.int32)
    X = (
        int(ctx.recon_y[y0 - 1, x0 - 1])
        if (left_ok and top_ok)
        else 0
    )
    return L, T, TR, X, left_ok, top_ok


def _recon_i8_mb(ctx, mbx, mby, sid, modes, zz8, cmode,
                 dcu, dcv, acu, acv, cbp_c, left_ok, top_ok):
    """Causal Intra_8x8 (I_NxN + transform_size_8x8_flag) reconstruction
    from parsed modes + 8x8 zigzag residuals (2,2,64)."""
    qp, qpc = ctx.qp, ctx.qpc
    ctx.slice_id[mby, mbx] = sid  # in-MB neighbor checks
    ctx.qp_map[mby, mbx] = ctx.qp
    _mb_grid_update(ctx, mbx, mby, sid)
    for b8 in range(4):
        x8, y8 = b8 & 1, b8 >> 1
        gx8, gy8 = 2 * mbx + x8, 2 * mby + y8
        L, T, TR, X, l_ok, t_ok = _i8_neighbors(ctx, gx8, gy8, sid)
        p = i8mod.pred8x8(int(modes[b8]), L, T, TR, X, l_ok, t_ok)
        d = t8mod.dequant8x8(t8mod.inverse_zigzag8(zz8[y8, x8]), qp)
        ctx.recon_y[8 * gy8 : 8 * gy8 + 8, 8 * gx8 : 8 * gx8 + 8] = (
            t8mod.idct8_add(p, d)
        )

    topu, leftu, corneru = _neighbors_chroma(ctx.recon_u, mbx, mby, left_ok, top_ok)
    topv, leftv, cornerv = _neighbors_chroma(ctx.recon_v, mbx, mby, left_ok, top_ok)
    predu = intra.pred8(cmode, topu, leftu, corneru, top_ok, left_ok)
    predv = intra.pred8(cmode, topv, leftv, cornerv, top_ok, left_ok)
    c0, cx0 = 8 * mby, 8 * mbx
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predu, dcu, acu, qpc, cbp_c
    )
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = reconstruct_chroma_mb(
        predv, dcv, acv, qpc, cbp_c
    )
    ctx.kind[mby, mbx] = inter_mod.MB_INTRA
    ctx.mv[mby, mbx] = 0


def _apply_ipcm_samples(ctx, mbx, mby, sid, ymb, umb, vmb):
    """Shared I_PCM macroblock application (8.3.5): raw samples into the
    reconstruction + neighbor-state conventions (every block treated as
    having 16 coded coefficients, QP 0 for deblocking per 8.7.2).  The
    bits come from the CAVLC bit reader or the CABAC byte-aligned run."""
    y0, x0 = 16 * mby, 16 * mbx
    c0, cx0 = 8 * mby, 8 * mbx
    ctx.recon_y[y0 : y0 + 16, x0 : x0 + 16] = ymb
    ctx.recon_u[c0 : c0 + 8, cx0 : cx0 + 8] = umb
    ctx.recon_v[c0 : c0 + 8, cx0 : cx0 + 8] = vmb
    ctx.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 16
    ctx.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 16
    ctx.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 16
    ctx.kind[mby, mbx] = inter_mod.MB_INTRA
    ctx.mv[mby, mbx] = 0
    ctx.i4modes[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1
    ctx.slice_id[mby, mbx] = sid
    ctx.qp_map[mby, mbx] = 0  # I_PCM filters as QP 0 (8.7.2)
    _mb_grid_update(ctx, mbx, mby, sid)
