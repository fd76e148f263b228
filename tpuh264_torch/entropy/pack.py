# Copy of tpuh264/entropy/pack.py, so that the port imports nothing of tpuh264.
"""Host-side slice packing/parsing from TPU symbol tensors (Python oracle).

The TPU scan (kernels/iframe.py) emits per-MB symbol tensors; this module
walks them in slice order and emits the CAVLC bitstream (and the inverse:
parses a stream back into symbol tensors for the TPU decoder).  The C++
fast path in native/cavlc.cpp implements exactly this logic; tests require
byte equality between the two and against the golden codec.

Layouts (one stream; N = mbh*mbw MBs, raster order):
  mb_info   int32 [N, 4]  : mode, cmode, cbp_luma, cbp_chroma
  luma_dc   int32 [N, 16] : zigzag DC levels
  luma_ac   int16 [N, 16, 16] : per 4x4 block (raster by*4+bx), zigzag;
              slot 0 is unused for intra MBs (DC coded separately)
  chroma_dc int32 [N, 2, 4]
  chroma_ac int32 [N, 2, 4, 15]
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core import nal
from ..core.bitstream import BitReader, BitWriter
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_I, SliceHeader
from .cavlc import decode_residual_block, encode_residual_block
from .cavlc_tables import CBP_INTRA, CBP_INTRA_INV

# luma4x4BlkIdx scan order as (bx, by)
BLK_SCAN = [
    (0, 0), (1, 0), (0, 1), (1, 1),
    (2, 0), (3, 0), (2, 1), (3, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
    (2, 2), (3, 2), (2, 3), (3, 3),
]


class _NnzState:
    def __init__(self, mbw: int, mbh: int):
        self.y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.u = np.zeros((2 * mbh, 2 * mbw), np.int32)
        self.v = np.zeros((2 * mbh, 2 * mbw), np.int32)
        # per-4x4-block Intra_4x4 modes; -1 = not an I4x4 block (-> DC in
        # the most-probable-mode rule, golden/codec.py:_i44_pred_mode)
        self.i4 = np.full((4 * mbh, 4 * mbw), -1, np.int32)

    @staticmethod
    def _nc(nnz, bx, by, left_ok, top_ok):
        na = int(nnz[by, bx - 1]) if left_ok else None
        nb = int(nnz[by - 1, bx]) if top_ok else None
        if na is not None and nb is not None:
            return (na + nb + 1) >> 1
        if na is not None:
            return na
        if nb is not None:
            return nb
        return 0

    def luma_nc(self, mbx, mby, bx, by, left_mb, top_mb):
        return self._nc(self.y, 4 * mbx + bx, 4 * mby + by,
                        bx > 0 or left_mb, by > 0 or top_mb)

    def chroma_nc(self, comp, mbx, mby, bx, by, left_mb, top_mb):
        nnz = self.u if comp == 0 else self.v
        return self._nc(nnz, 2 * mbx + bx, 2 * mby + by,
                        bx > 0 or left_mb, by > 0 or top_mb)


def _mb_avail(addr: int, slice_start: int, mbw: int) -> Tuple[bool, bool]:
    mbx = addr % mbw
    left_mb = mbx > 0 and addr - 1 >= slice_start
    top_mb = addr - mbw >= slice_start
    return left_mb, top_mb


def _i4_pred_mode(i4, gbx, gby, left_ok, top_ok) -> int:
    """Most-probable Intra_4x4 mode (H.264 8.3.1.1; golden/codec.py
    _i44_pred_mode): min of left/top block modes, DC when a neighbor is
    missing or not I4x4-coded."""
    if not left_ok or not top_ok:
        return 2
    ma = int(i4[gby, gbx - 1])
    mb = int(i4[gby - 1, gbx])
    ma = 2 if ma < 0 else ma
    mb = 2 if mb < 0 else mb
    return min(ma, mb)


def _pack_mb_i4(
    w: BitWriter,
    nnz: _NnzState,
    addr: int,
    mbx: int,
    mby: int,
    left_mb: bool,
    top_mb: bool,
    cmode: int,
    cbp_l: int,
    cbp_c: int,
    i4modes: np.ndarray,
    luma_ac: np.ndarray,
    chroma_dc: np.ndarray,
    chroma_ac: np.ndarray,
) -> None:
    """I_NxN macroblock syntax (golden/codec.py:_write_i44_mb)."""
    w.ue(0)  # mb_type I_NxN
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        l_ok = bx > 0 or left_mb
        t_ok = by > 0 or top_mb
        pm = _i4_pred_mode(nnz.i4, gbx, gby, l_ok, t_ok)
        m = int(i4modes[bi])
        if m == pm:
            w.u(1, 1)
        else:
            w.u(1, 0)
            w.u(3, m if m < pm else m - 1)
        nnz.i4[gby, gbx] = m
    w.ue(cmode)
    w.ue(CBP_INTRA_INV[cbp_l | (cbp_c << 4)])
    if cbp_l or cbp_c:
        w.se(0)  # mb_qp_delta
    for i8 in range(4):
        if cbp_l >> i8 & 1:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
                block = luma_ac[4 * by + bx]
                encode_residual_block(w, block.tolist(), ncb, 16)
                nnz.y[4 * mby + by, 4 * mbx + bx] = int(np.count_nonzero(block))
        else:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                nnz.y[4 * mby + by, 4 * mbx + bx] = 0
    _pack_chroma_residual(
        w, nnz, mbx, mby, left_mb, top_mb, cbp_c, chroma_dc, chroma_ac
    )


def _pack_chroma_residual(
    w, nnz, mbx, mby, left_mb, top_mb, cbp_c, chroma_dc, chroma_ac
) -> None:
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


def pack_mb(
    w: BitWriter,
    nnz: _NnzState,
    addr: int,
    slice_start: int,
    mbw: int,
    mb_info: np.ndarray,
    luma_dc: np.ndarray,
    luma_ac: np.ndarray,
    chroma_dc: np.ndarray,
    chroma_ac: np.ndarray,
    i4modes: Optional[np.ndarray] = None,
) -> None:
    mode, cmode, cbp_l, cbp_c = (int(x) for x in mb_info)
    mby, mbx = divmod(addr, mbw)
    left_mb, top_mb = _mb_avail(addr, slice_start, mbw)

    if mode == 4:  # Intra_4x4 MB (kernels/iframe.py MBSymbols contract)
        _pack_mb_i4(
            w, nnz, addr, mbx, mby, left_mb, top_mb, cmode, cbp_l, cbp_c,
            i4modes, luma_ac, chroma_dc, chroma_ac,
        )
        return

    w.ue(1 + mode + 4 * cbp_c + 12 * cbp_l)
    w.ue(cmode)
    w.se(0)  # mb_qp_delta

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

    _pack_chroma_residual(
        w, nnz, mbx, mby, left_mb, top_mb, cbp_c, chroma_dc, chroma_ac
    )


def pack_iframe(
    mb_info: np.ndarray,
    luma_dc: np.ndarray,
    luma_ac: np.ndarray,
    chroma_dc: np.ndarray,
    chroma_ac: np.ndarray,
    sps: SPS,
    pps: PPS,
    qp: int,
    slice_mode: str = "rows",
    frame_num: int = 0,
    idr: bool = True,
    include_ps: bool = True,
    deblock_idc: int = 1,
    i4modes: Optional[np.ndarray] = None,
) -> bytes:
    """Pack one frame's symbol arrays into an annex-B stream.

    i4modes [N, 16] (z-scan per-block modes) is required when any MB has
    mode 4 (Intra_4x4)."""
    mbw, mbh = sps.mb_width, sps.mb_height
    nnz = _NnzState(mbw, mbh)
    out = bytearray()
    if include_ps:
        w = BitWriter()
        sps.write(w)
        out += nal.wrap_nal(nal.NAL_SPS, w.get_bytes())
        w = BitWriter()
        pps.write(w)
        out += nal.wrap_nal(nal.NAL_PPS, w.get_bytes())

    if slice_mode == "rows":
        slice_starts = [r * mbw for r in range(mbh)]
        slice_counts = [mbw] * mbh
    elif slice_mode == "single":
        slice_starts, slice_counts = [0], [mbw * mbh]
    else:
        raise ValueError(slice_mode)

    for start, count in zip(slice_starts, slice_counts):
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=start,
            slice_type=SLICE_I,
            frame_num=frame_num,
            slice_qp_delta=qp - 26 - pps.pic_init_qp_minus26,
            disable_deblocking_filter_idc=deblock_idc,
        ).write(w, sps, pps, idr)
        for addr in range(start, start + count):
            pack_mb(
                w, nnz, addr, start, mbw,
                mb_info[addr], luma_dc[addr], luma_ac[addr],
                chroma_dc[addr], chroma_ac[addr],
                i4modes[addr] if i4modes is not None else None,
            )
        w.rbsp_trailing_bits()
        ntype = nal.NAL_SLICE_IDR if idr else nal.NAL_SLICE_NON_IDR
        out += nal.wrap_nal(ntype, w.get_bytes(), nal_ref_idc=3)
    return bytes(out)


def parse_iframe(
    data: bytes,
) -> Tuple[SPS, PPS, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, np.ndarray]:
    """Parse an annex-B I-frame back into symbol arrays.

    Returns (sps, pps, qp, mb_info, luma_dc, luma_ac, chroma_dc,
    chroma_ac, i4modes); i4modes [N, 16] is -1 except for I_NxN MBs.
    """
    sps: Optional[SPS] = None
    pps: Optional[PPS] = None
    arrays = None
    qp = 26
    nnz = None
    for _, ntype, rbsp in nal.split_annexb(data):
        if ntype == nal.NAL_SPS:
            sps = SPS.parse(BitReader(rbsp))
        elif ntype == nal.NAL_PPS:
            pps = PPS.parse(BitReader(rbsp))
        elif ntype in (nal.NAL_SLICE_IDR, nal.NAL_SLICE_NON_IDR):
            assert sps is not None and pps is not None
            mbw, mbh = sps.mb_width, sps.mb_height
            n = mbw * mbh
            if arrays is None:
                arrays = (
                    np.zeros((n, 4), np.int32),
                    np.zeros((n, 16), np.int16),
                    np.zeros((n, 16, 16), np.int16),
                    np.zeros((n, 2, 4), np.int16),
                    np.zeros((n, 2, 4, 15), np.int16),
                    np.full((n, 16), -1, np.int16),
                )
                nnz = _NnzState(mbw, mbh)
            r = BitReader(rbsp)
            header = SliceHeader.parse(r, sps, pps, ntype == nal.NAL_SLICE_IDR)
            qp = 26 + pps.pic_init_qp_minus26 + header.slice_qp_delta
            addr = header.first_mb_in_slice
            start = addr
            while r.more_rbsp_data():
                parse_mb(r, nnz, addr, start, mbw, *arrays)
                addr += 1
    assert arrays is not None and sps is not None and pps is not None
    return (sps, pps, qp) + arrays


def parse_mb(
    r: BitReader,
    nnz: _NnzState,
    addr: int,
    slice_start: int,
    mbw: int,
    mb_info: np.ndarray,
    luma_dc: np.ndarray,
    luma_ac: np.ndarray,
    chroma_dc: np.ndarray,
    chroma_ac: np.ndarray,
    i4modes: Optional[np.ndarray] = None,
) -> None:
    mby, mbx = divmod(addr, mbw)
    left_mb, top_mb = _mb_avail(addr, slice_start, mbw)

    mb_type = r.ue()
    if mb_type == 0:  # I_NxN
        _parse_mb_i4(
            r, nnz, addr, mbx, mby, left_mb, top_mb,
            mb_info, luma_ac, chroma_dc, chroma_ac, i4modes,
        )
        return
    if not 1 <= mb_type <= 24:
        raise NotImplementedError(f"mb_type {mb_type}")
    t = mb_type - 1
    mode = t % 4
    cbp_c = (t // 4) % 3
    cbp_l = 1 if t >= 12 else 0
    cmode = r.ue()
    r.se()  # mb_qp_delta

    mb_info[addr] = (mode, cmode, cbp_l, cbp_c)

    nc0 = nnz.luma_nc(mbx, mby, 0, 0, left_mb, top_mb)
    luma_dc[addr] = decode_residual_block(r, nc0, 16)

    if cbp_l:
        for bx, by in BLK_SCAN:
            ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
            block = decode_residual_block(r, ncb, 15)
            luma_ac[addr, 4 * by + bx, 1:] = block
            nnz.y[4 * mby + by, 4 * mbx + bx] = int(
                np.count_nonzero(np.asarray(block))
            )
    else:
        nnz.y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0

    _parse_chroma_residual(
        r, nnz, addr, mbx, mby, left_mb, top_mb, cbp_c, chroma_dc, chroma_ac
    )


def _parse_chroma_residual(
    r, nnz, addr, mbx, mby, left_mb, top_mb, cbp_c, chroma_dc, chroma_ac
) -> None:
    if cbp_c:
        chroma_dc[addr, 0] = decode_residual_block(r, -1, 4)
        chroma_dc[addr, 1] = decode_residual_block(r, -1, 4)
    if cbp_c == 2:
        for comp in (0, 1):
            nnz_c = nnz.u if comp == 0 else nnz.v
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                ncb = nnz.chroma_nc(comp, mbx, mby, bx, by, left_mb, top_mb)
                block = decode_residual_block(r, ncb, 15)
                chroma_ac[addr, comp, bidx] = block
                nnz_c[2 * mby + by, 2 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
    else:
        nnz.u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        nnz.v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def _parse_mb_i4(
    r: BitReader,
    nnz: _NnzState,
    addr: int,
    mbx: int,
    mby: int,
    left_mb: bool,
    top_mb: bool,
    mb_info: np.ndarray,
    luma_ac: np.ndarray,
    chroma_dc: np.ndarray,
    chroma_ac: np.ndarray,
    i4modes: np.ndarray,
) -> None:
    """Inverse of _pack_mb_i4 (golden/codec.py:_decode_i44_mb syntax)."""
    for bi, (bx, by) in enumerate(BLK_SCAN):
        gbx, gby = 4 * mbx + bx, 4 * mby + by
        l_ok = bx > 0 or left_mb
        t_ok = by > 0 or top_mb
        pm = _i4_pred_mode(nnz.i4, gbx, gby, l_ok, t_ok)
        if r.u(1):
            m = pm
        else:
            rem = r.u(3)
            m = rem if rem < pm else rem + 1
        i4modes[addr, bi] = m
        nnz.i4[gby, gbx] = m
    cmode = r.ue()
    cbp = CBP_INTRA[r.ue()]
    cbp_l, cbp_c = cbp & 15, cbp >> 4
    if cbp:
        r.se()  # mb_qp_delta
    mb_info[addr] = (4, cmode, cbp_l, cbp_c)

    for i8 in range(4):
        if cbp_l >> i8 & 1:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                ncb = nnz.luma_nc(mbx, mby, bx, by, left_mb, top_mb)
                block = decode_residual_block(r, ncb, 16)
                luma_ac[addr, 4 * by + bx] = block
                nnz.y[4 * mby + by, 4 * mbx + bx] = int(
                    np.count_nonzero(np.asarray(block))
                )
        else:
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                nnz.y[4 * mby + by, 4 * mbx + bx] = 0

    _parse_chroma_residual(
        r, nnz, addr, mbx, mby, left_mb, top_mb, cbp_c, chroma_dc, chroma_ac
    )
