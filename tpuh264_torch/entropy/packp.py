# Copy of tpuh264/entropy/packp.py, so that the port imports nothing of tpuh264.
"""Host-side P-slice packing/parsing from TPU symbol tensors (Python oracle).

Extends entropy.pack to P slices (P_Skip / P_L0_16x16 / Intra_16x16-in-P).
The C++ fast path mirrors this bit-for-bit.

Layouts (one stream; N MBs raster):
  mb_info  int32 [N, 8]: kind (0 skip / 1 inter / 2 intra), mode, cmode,
           cbp_luma (intra: 0/1 meaning 0/15; inter: 4-bit pattern),
           cbp_chroma, mvd_x, mvd_y, ref_idx_l0
  luma_dc  int16 [N, 16]     (intra MBs only)
  luma_ac  int16 [N, 16, 16] (intra: slots 1..15; inter: all 16)
  chroma_dc int16 [N, 2, 4]
  chroma_ac int16 [N, 2, 4, 15]
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core import nal
from ..core.bitstream import BitReader, BitWriter
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_P, SliceHeader
from .cavlc import decode_residual_block, encode_residual_block
from .cavlc_tables import CBP_INTER, CBP_INTER_INV
from .pack import BLK_SCAN, _NnzState, _mb_avail

KIND_SKIP = 0
KIND_INTER = 1
KIND_INTRA = 2


def _pack_intra16_in_p(w, nnz, addr, slice_start, mbw,
                       info, luma_dc, luma_ac, chroma_dc, chroma_ac):
    _, mode, cmode, cbp_l, cbp_c, _, _, _ = (int(x) for x in info)
    mby, mbx = divmod(addr, mbw)
    left_mb, top_mb = _mb_avail(addr, slice_start, mbw)
    w.ue(5 + 1 + mode + 4 * cbp_c + 12 * cbp_l)
    w.ue(cmode)
    w.se(0)
    nc0 = nnz.luma_nc(mbx, mby, 0, 0, left_mb, top_mb)
    encode_residual_block(w, luma_dc.tolist(), nc0, 16)
    if cbp_l:
        for bx, by in BLK_SCAN:
            ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
            block = luma_ac[4 * by + bx][1:]
            encode_residual_block(w, block.tolist(), ncb, 15)
            nnz.y[4 * mby + by, 4 * mbx + bx] = int(np.count_nonzero(block))
    else:
        nnz.y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
    _pack_chroma_residual(w, nnz, mbx, mby, left_mb, top_mb, cbp_c,
                          chroma_dc, chroma_ac)


def _pack_chroma_residual(w, nnz, mbx, mby, left_mb, top_mb, cbp_c,
                          chroma_dc, chroma_ac):
    if cbp_c:
        encode_residual_block(w, chroma_dc[0].tolist(), -1, 4)
        encode_residual_block(w, chroma_dc[1].tolist(), -1, 4)
    if cbp_c == 2:
        for comp in (0, 1):
            nnz_c = nnz.u if comp == 0 else nnz.v
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = nnz.chroma_nc(comp, mbx, mby, bx, by, left_mb, top_mb)
                block = chroma_ac[comp, bidx]
                encode_residual_block(w, block.tolist(), ncb, 15)
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(np.count_nonzero(block))
    else:
        nnz.u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        nnz.v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def pack_pslice(w, nnz, slice_start, slice_count, mbw,
                mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                nra: int = 1):
    """Pack `slice_count` MBs of a P slice (after the header bits).
    nra = num_ref_idx_l0_active; > 1 emits ref_idx_l0 as te(v)."""
    skiprun = 0
    for k in range(slice_count):
        addr = slice_start + k
        info = mb_info[addr]
        kind = int(info[0])
        mby, mbx = divmod(addr, mbw)
        if kind == KIND_SKIP:
            skiprun += 1
            nnz.y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
            nnz.u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
            nnz.v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
            continue
        w.ue(skiprun)
        skiprun = 0
        if kind == KIND_INTRA:
            _pack_intra16_in_p(w, nnz, addr, slice_start, mbw, info,
                               luma_dc[addr], luma_ac[addr],
                               chroma_dc[addr], chroma_ac[addr])
            continue
        # inter 16x16
        _, _, _, cbp_l, cbp_c, mvdx, mvdy, ref_i = (int(x) for x in info)
        left_mb, top_mb = _mb_avail(addr, slice_start, mbw)
        w.ue(0)  # P_L0_16x16
        if nra > 1:  # ref_idx_l0, te(v) with cMax = nra-1
            if nra == 2:
                w.u(1, 1 - ref_i)
            else:
                w.ue(ref_i)
        w.se(mvdx)
        w.se(mvdy)
        w.ue(CBP_INTER_INV[cbp_l | (cbp_c << 4)])
        if cbp_l or cbp_c:
            w.se(0)  # mb_qp_delta
        for i8 in range(4):
            if cbp_l >> i8 & 1:
                for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                    ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
                    block = luma_ac[addr, 4 * by + bx]
                    encode_residual_block(w, block.tolist(), ncb, 16)
                    nnz.y[4 * mby + by, 4 * mbx + bx] = int(
                        np.count_nonzero(block)
                    )
            else:
                for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                    nnz.y[4 * mby + by, 4 * mbx + bx] = 0
        _pack_chroma_residual(w, nnz, mbx, mby, left_mb, top_mb, cbp_c,
                              chroma_dc[addr], chroma_ac[addr])
    if skiprun:
        w.ue(skiprun)


def pack_pframe(
    mb_info: np.ndarray,
    luma_dc: np.ndarray,
    luma_ac: np.ndarray,
    chroma_dc: np.ndarray,
    chroma_ac: np.ndarray,
    sps: SPS,
    pps: PPS,
    qp: int,
    slice_mode: str = "rows",
    frame_num: int = 1,
    deblock_idc: int = 1,
    ref: bool = True,
    num_ref_active: int = 1,
) -> bytes:
    """Pack one P-frame's symbol arrays into annex-B slice NALs."""
    mbw, mbh = sps.mb_width, sps.mb_height
    nnz = _NnzState(mbw, mbh)
    if slice_mode == "rows":
        slices = [(r * mbw, mbw) for r in range(mbh)]
    elif slice_mode == "single":
        slices = [(0, mbw * mbh)]
    else:
        raise ValueError(slice_mode)
    out = bytearray()
    for start, count in slices:
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=start,
            slice_type=SLICE_P,
            frame_num=frame_num % (1 << (sps.log2_max_frame_num_minus4 + 4)),
            slice_qp_delta=qp - 26 - pps.pic_init_qp_minus26,
            disable_deblocking_filter_idc=deblock_idc,
            num_ref_idx_l0_active_minus1=num_ref_active - 1,
        ).write(w, sps, pps, idr=False, ref=ref)
        pack_pslice(w, nnz, start, count, mbw,
                    mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                    nra=num_ref_active)
        w.rbsp_trailing_bits()
        out += nal.wrap_nal(
            nal.NAL_SLICE_NON_IDR, w.get_bytes(), nal_ref_idc=2 if ref else 0
        )
    return bytes(out)


def parse_pslice(r, nnz, slice_start, mbw, max_mbs,
                 mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                 nra: int = 1) -> int:
    """Parse P-slice MBs; returns count.  Fills mb_info[...,0] kinds."""
    addr = slice_start
    count = 0
    while count < max_mbs and r.more_rbsp_data():
        run = r.ue()
        for _ in range(run):
            mby, mbx = divmod(addr, mbw)
            mb_info[addr] = 0
            mb_info[addr, 0] = KIND_SKIP
            nnz.y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
            nnz.u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
            nnz.v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
            addr += 1
            count += 1
        if count >= max_mbs or not r.more_rbsp_data():
            break
        mby, mbx = divmod(addr, mbw)
        left_mb, top_mb = _mb_avail(addr, slice_start, mbw)
        mb_type = r.ue()
        info = mb_info[addr]
        info[:] = 0
        if mb_type >= 5:
            icode = mb_type - 5
            if not 1 <= icode <= 24:
                raise NotImplementedError(f"intra code {icode} in P slice")
            t = icode - 1
            info[0] = KIND_INTRA
            info[1] = t % 4
            info[3] = 1 if t >= 12 else 0
            info[4] = (t // 4) % 3
            info[2] = r.ue()  # cmode
            r.se()  # mb_qp_delta
            nc0 = nnz.luma_nc(mbx, mby, 0, 0, left_mb, top_mb)
            luma_dc[addr] = decode_residual_block(r, nc0, 16)
            if info[3]:
                for bx, by in BLK_SCAN:
                    ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
                    block = decode_residual_block(r, ncb, 15)
                    luma_ac[addr, 4 * by + bx, 1:] = block
                    nnz.y[4 * mby + by, 4 * mbx + bx] = int(
                        np.count_nonzero(np.asarray(block))
                    )
            else:
                nnz.y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
            _parse_chroma_residual(r, nnz, mbx, mby, left_mb, top_mb,
                                   int(info[4]), chroma_dc[addr], chroma_ac[addr])
        elif mb_type == 0:
            info[0] = KIND_INTER
            if nra > 1:
                info[7] = (1 - r.u(1)) if nra == 2 else r.ue()
            info[5] = r.se()
            info[6] = r.se()
            cbp = CBP_INTER[r.ue()]
            info[3] = cbp & 15
            info[4] = cbp >> 4
            if cbp:
                r.se()  # mb_qp_delta
            for i8 in range(4):
                if info[3] >> i8 & 1:
                    for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                        ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
                        block = decode_residual_block(r, ncb, 16)
                        luma_ac[addr, 4 * by + bx] = block
                        nnz.y[4 * mby + by, 4 * mbx + bx] = int(
                            np.count_nonzero(np.asarray(block))
                        )
                else:
                    for bx, by in BLK_SCAN[4 * i8 : 4 * i8 + 4]:
                        nnz.y[4 * mby + by, 4 * mbx + bx] = 0
            _parse_chroma_residual(r, nnz, mbx, mby, left_mb, top_mb,
                                   int(info[4]), chroma_dc[addr], chroma_ac[addr])
        else:
            raise NotImplementedError(f"P mb_type {mb_type}")
        addr += 1
        count += 1
    return count


def _parse_chroma_residual(r, nnz, mbx, mby, left_mb, top_mb, cbp_c,
                           chroma_dc, chroma_ac):
    if cbp_c:
        chroma_dc[0] = decode_residual_block(r, -1, 4)
        chroma_dc[1] = decode_residual_block(r, -1, 4)
    if cbp_c == 2:
        for comp in (0, 1):
            nnz_c = nnz.u if comp == 0 else nnz.v
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = nnz.chroma_nc(comp, mbx, mby, bx, by, left_mb, top_mb)
                block = decode_residual_block(r, ncb, 15)
                chroma_ac[comp, bidx] = block
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
    else:
        nnz.u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        nnz.v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def parse_pframe_slices(slices, sps: SPS, pps: PPS, nra: int = 1):
    """Parse P slices (list of (rbsp, start_bit, first_mb)) -> arrays + qp."""
    mbw, mbh = sps.mb_width, sps.mb_height
    n = mbw * mbh
    mb_info = np.zeros((n, 8), np.int32)
    luma_dc = np.zeros((n, 16), np.int16)
    luma_ac = np.zeros((n, 16, 16), np.int16)
    chroma_dc = np.zeros((n, 2, 4), np.int16)
    chroma_ac = np.zeros((n, 2, 4, 15), np.int16)
    nnz = _NnzState(mbw, mbh)
    for rbsp, start_bit, first_mb in slices:
        r = BitReader(rbsp)
        r._pos = start_bit
        parse_pslice(r, nnz, first_mb, mbw, n - first_mb,
                     mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                     nra=nra)
    return mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac
