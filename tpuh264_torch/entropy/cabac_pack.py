# Copy of tpuh264/entropy/cabac_pack.py, so that the port imports nothing of tpuh264.
"""CABAC host entropy backend: I-slice packing/parsing over the same
per-MB symbol arrays as the CAVLC packer (entropy/pack.py), so the TPU
scan kernels feed either coder unchanged (PPS entropy_coding_mode_flag
selects at the session level).

Syntax per 7.3.5 (macroblock_layer) + 9.3 (CABAC): context-adaptive
mb_type / intra modes / CBP / mb_qp_delta binarizations and the
residual_block_cabac coding (coded_block_flag, significance map in scan
order, levels in reverse scan order with the UEG0 binarization and the
node-context state machine).  Neighbor context rules follow clause
9.3.3.1; unavailable-macroblock conventions (intra slices):
coded_block_flag -> condTermFlag 1, CBP luma -> 0 ("treated coded"),
CBP chroma / chroma pred mode / mb_type -> 0.

Conformance oracle: every stream is decoded bit-exactly by libavcodec
(tests/test_cabac.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from ..core import nal
from ..core.bitstream import BitReader, BitWriter
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_I, SLICE_P, SliceHeader
from .cabac_arith import CabacDecoder, CabacEncoder
from .cabac_tables import CTX_INIT_I, CTX_INIT_PB, init_contexts
from .pack import BLK_SCAN, _i4_pred_mode, _mb_avail
from .packp import KIND_INTER, KIND_INTRA, KIND_SKIP

# Table 9-40 ctxBlockCatOffsets for cat 0..4 (Intra16x16DC, Intra16x16AC,
# Luma4x4, ChromaDC, ChromaAC)
_CBF_OFF = (0, 4, 8, 12, 16)
_SIG_OFF = (0, 15, 29, 44, 47)
_ABS_OFF = (0, 10, 20, 30, 39)
# coeff_abs_level_minus1 node-context machine (9.3.3.1.3)
_LVL1_CTX = (1, 2, 3, 4, 0, 0, 0, 0)
_GT1_CTX = (5, 5, 5, 5, 6, 7, 8, 9)
_GT1_CTX_DC = (5, 5, 5, 5, 6, 7, 8, 8)
_NODE_EQ1 = (1, 2, 3, 3, 4, 5, 6, 7)
_NODE_GT1 = (4, 4, 4, 4, 5, 6, 7, 7)

# 8x8 (ctxBlockCat 5) residuals: sig base 402, last base 417, abs base
# 426; per-scan-position ctx maps (Tables 9-43, frame coding), verified
# against the system libavcodec
_SIG8_MAP = (
    0, 1, 2, 3, 4, 5, 5, 4, 4, 3, 3, 4, 4, 4, 5, 5,
    4, 4, 4, 4, 3, 3, 6, 7, 7, 7, 8, 9, 10, 9, 8, 7,
    7, 6, 11, 12, 13, 11, 6, 7, 8, 9, 14, 10, 9, 8, 6, 11,
    12, 13, 11, 6, 9, 14, 10, 9, 11, 12, 13, 11, 14, 10, 12,
)
_LAST8_MAP = (
    0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
    2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2,
    3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4, 4, 4, 4, 4, 4,
    5, 5, 5, 5, 6, 6, 6, 6, 7, 7, 7, 7, 8, 8, 8,
)


class _Ctx:
    """Per-frame neighbor-context state (grids persist across slices of a
    frame; slice availability gates their use, like pack.py::_NnzState)."""

    def __init__(self, mbw: int, mbh: int):
        self.nnz_y = np.zeros((4 * mbh, 4 * mbw), np.int32)
        self.nnz_u = np.zeros((2 * mbh, 2 * mbw), np.int32)
        self.nnz_v = np.zeros((2 * mbh, 2 * mbw), np.int32)
        self.dc_y = np.zeros((mbh, mbw), np.int32)   # luma DC cbf (I16)
        self.dc_u = np.zeros((mbh, mbw), np.int32)
        self.dc_v = np.zeros((mbh, mbw), np.int32)
        self.cbp_l = np.zeros((mbh, mbw), np.int32)  # 4-bit (I16: 0/15)
        self.cbp_c = np.zeros((mbh, mbw), np.int32)
        self.not_i4 = np.zeros((mbh, mbw), np.int32)
        self.cmode = np.zeros((mbh, mbw), np.int32)
        self.i4 = np.full((4 * mbh, 4 * mbw), -1, np.int32)
        # P-slice state: skip flags, per-MB |mvd| (zero for skip/intra),
        # and refIdxL0 (zero for skip/intra -- matching the ref_idx
        # neighbor-context convention)
        self.skip = np.zeros((mbh, mbw), np.int32)
        self.amvd = np.zeros((mbh, mbw, 2), np.int32)
        self.refidx = np.zeros((mbh, mbw), np.int32)
        self.t8 = np.zeros((mbh, mbw), np.int32)


# -- residual block (7.3.5.3.3) ---------------------------------------------

def _encode_residual(enc, st, mps, cat: int, coeffs, cbf_inc: int) -> int:
    """Encode one scan-ordered coefficient list; returns its cbf."""
    n = len(coeffs)
    last = -1
    for i in range(n):
        if coeffs[i]:
            last = i
    cbf = 1 if last >= 0 else 0
    enc.encode(st, mps, 85 + _CBF_OFF[cat] + cbf_inc, cbf)
    if not cbf:
        return 0

    for i in range(min(last + 1, n - 1)):
        inc = min(i, 2) if cat == 3 else i
        sig = 1 if coeffs[i] else 0
        enc.encode(st, mps, 105 + _SIG_OFF[cat] + inc, sig)
        if sig:
            enc.encode(st, mps, 166 + _SIG_OFF[cat] + inc, 1 if i == last else 0)

    gt1_tab = _GT1_CTX_DC if cat == 3 else _GT1_CTX
    node = 0
    for i in range(last, -1, -1):
        c = int(coeffs[i])
        if c == 0:
            continue
        absm1 = abs(c) - 1
        enc.encode(
            st, mps, 227 + _ABS_OFF[cat] + _LVL1_CTX[node], 1 if absm1 else 0
        )
        if absm1 == 0:
            node = _NODE_EQ1[node]
        else:
            gt1 = 227 + _ABS_OFF[cat] + gt1_tab[node]
            if absm1 < 14:
                for _ in range(absm1 - 1):
                    enc.encode(st, mps, gt1, 1)
                enc.encode(st, mps, gt1, 0)
            else:
                for _ in range(13):
                    enc.encode(st, mps, gt1, 1)
                w = absm1 - 13  # EG0 suffix value + 1 (>= 1)
                j = w.bit_length() - 1
                for _ in range(j):
                    enc.bypass(1)
                enc.bypass(0)
                for k in range(j - 1, -1, -1):
                    enc.bypass((w >> k) & 1)
            node = _NODE_GT1[node]
        enc.bypass(1 if c < 0 else 0)
    return 1


def _encode_residual8(enc, st, mps, coeffs) -> None:
    """ctxBlockCat 5 (Luma8x8) residual: 64 zigzag coefficients, no
    coded_block_flag (inferred from CBP); Table 9-43 ctx maps."""
    last = -1
    for i in range(64):
        if coeffs[i]:
            last = i
    for i in range(min(last + 1, 63)):
        sig = 1 if coeffs[i] else 0
        enc.encode(st, mps, 402 + _SIG8_MAP[i], sig)
        if sig:
            enc.encode(st, mps, 417 + _LAST8_MAP[i], 1 if i == last else 0)
    node = 0
    for i in range(last, -1, -1):
        c = int(coeffs[i])
        if c == 0:
            continue
        absm1 = abs(c) - 1
        enc.encode(st, mps, 426 + _LVL1_CTX[node], 1 if absm1 else 0)
        if absm1 == 0:
            node = _NODE_EQ1[node]
        else:
            gt1 = 426 + _GT1_CTX[node]
            if absm1 < 14:
                for _ in range(absm1 - 1):
                    enc.encode(st, mps, gt1, 1)
                enc.encode(st, mps, gt1, 0)
            else:
                for _ in range(13):
                    enc.encode(st, mps, gt1, 1)
                w = absm1 - 13
                j = w.bit_length() - 1
                for _ in range(j):
                    enc.bypass(1)
                enc.bypass(0)
                for k in range(j - 1, -1, -1):
                    enc.bypass((w >> k) & 1)
            node = _NODE_GT1[node]
        enc.bypass(1 if c < 0 else 0)


def _decode_residual8(dec, st, mps):
    coeffs = [0] * 64
    sig = [False] * 64
    last = -1
    for i in range(63):
        if dec.decode(st, mps, 402 + _SIG8_MAP[i]):
            sig[i] = True
            if dec.decode(st, mps, 417 + _LAST8_MAP[i]):
                last = i
                break
    if last < 0:
        sig[63] = True
        last = 63
    node = 0
    for i in range(last, -1, -1):
        if not sig[i]:
            continue
        if not dec.decode(st, mps, 426 + _LVL1_CTX[node]):
            level = 1
            node = _NODE_EQ1[node]
        else:
            gt1 = 426 + _GT1_CTX[node]
            level = 2
            while level < 15 and dec.decode(st, mps, gt1):
                level += 1
            if level == 15:
                j = 0
                while dec.bypass():
                    j += 1
                w = 1
                for _ in range(j):
                    w = (w << 1) | dec.bypass()
                level = 14 + w
            node = _NODE_GT1[node]
        if dec.bypass():
            level = -level
        coeffs[i] = level
    return coeffs


def _decode_residual(dec, st, mps, cat: int, n: int, cbf_inc: int):
    """Decode one block; returns (coeff list length n, cbf)."""
    coeffs = [0] * n
    if not dec.decode(st, mps, 85 + _CBF_OFF[cat] + cbf_inc):
        return coeffs, 0

    sig = [False] * n
    last = -1
    for i in range(n - 1):
        inc = min(i, 2) if cat == 3 else i
        if dec.decode(st, mps, 105 + _SIG_OFF[cat] + inc):
            sig[i] = True
            if dec.decode(st, mps, 166 + _SIG_OFF[cat] + inc):
                last = i
                break
    if last < 0:
        sig[n - 1] = True
        last = n - 1

    gt1_tab = _GT1_CTX_DC if cat == 3 else _GT1_CTX
    node = 0
    for i in range(last, -1, -1):
        if not sig[i]:
            continue
        if not dec.decode(st, mps, 227 + _ABS_OFF[cat] + _LVL1_CTX[node]):
            level = 1
            node = _NODE_EQ1[node]
        else:
            gt1 = 227 + _ABS_OFF[cat] + gt1_tab[node]
            level = 2
            while level < 15 and dec.decode(st, mps, gt1):
                level += 1
            if level == 15:
                j = 0
                while dec.bypass():
                    j += 1
                w = 1
                for _ in range(j):
                    w = (w << 1) | dec.bypass()
                level = 14 + w
            node = _NODE_GT1[node]
        if dec.bypass():
            level = -level
        coeffs[i] = level
    return coeffs, 1


# -- neighbor-context increments ---------------------------------------------

def _cbf_inc_4x4(grid, gbx, gby, left_ok, top_ok, un=1):
    """coded_block_flag ctxIdxInc; `un` is the unavailable-neighbor
    condTermFlag: 1 for intra macroblocks, 0 for inter (9.3.3.1.1.9)."""
    a = (1 if grid[gby, gbx - 1] else 0) if left_ok else un
    b = (1 if grid[gby - 1, gbx] else 0) if top_ok else un
    return a + 2 * b


def _cbf_inc_dc(grid, mbx, mby, left_mb, top_mb, un=1):
    a = (1 if grid[mby, mbx - 1] else 0) if left_mb else un
    b = (1 if grid[mby - 1, mbx] else 0) if top_mb else un
    return a + 2 * b


def _cbp_luma_incs(C, mbx, mby, left_mb, top_mb, cur_bits):
    """ctxIdxInc for the four coded_block_pattern luma bins; cur_bits is
    the (partially known) current MB pattern used by in-MB neighbors."""
    incs = []
    for i in range(4):
        x8, y8 = i & 1, i >> 1
        if x8 == 1:
            a = 1 if ((cur_bits >> (i - 1)) & 1) == 0 else 0
        elif left_mb:
            a = 1 if ((C.cbp_l[mby, mbx - 1] >> (2 * y8 + 1)) & 1) == 0 else 0
        else:
            a = 0  # unavailable: treated as coded
        if y8 == 1:
            b = 1 if ((cur_bits >> (i - 2)) & 1) == 0 else 0
        elif top_mb:
            b = 1 if ((C.cbp_l[mby - 1, mbx] >> (2 + x8)) & 1) == 0 else 0
        else:
            b = 0
        incs.append(a + 2 * b)
    return incs


# -- macroblock layer ---------------------------------------------------------

def _mb_common_ctx(C, addr, slice_start, mbw):
    mby, mbx = divmod(addr, mbw)
    left_mb, top_mb = _mb_avail(addr, slice_start, mbw)
    return mby, mbx, left_mb, top_mb


def _enc_mb(enc, st, mps, C, addr, slice_start, mbw,
            info, ldc, lac, cdc, cac, i4m, t8en: bool = False) -> None:
    mode, cmode, cbp_l, cbp_c = (int(x) for x in info)
    mby, mbx, left_mb, top_mb = _mb_common_ctx(C, addr, slice_start, mbw)
    i4 = mode == 4

    # mb_type (I slice): bin0 neighbor ctx, then terminate(0) + I16 bins
    inc = (1 if left_mb and C.not_i4[mby, mbx - 1] else 0) + (
        1 if top_mb and C.not_i4[mby - 1, mbx] else 0
    )
    enc.encode(st, mps, 3 + inc, 0 if i4 else 1)
    if i4:
        if t8en:
            # High-profile PPS: I_NxN opens with transform_size_8x8_flag
            # (7.3.5); our intra tooling stays 4x4
            fa = 1 if left_mb and C.t8[mby, mbx - 1] else 0
            fb = 1 if top_mb and C.t8[mby - 1, mbx] else 0
            enc.encode(st, mps, 399 + fa + fb, 0)
        cbp_bits = cbp_l
        for bi, (bx, by) in enumerate(BLK_SCAN):
            gbx, gby = 4 * mbx + bx, 4 * mby + by
            l_ok = bx > 0 or left_mb
            t_ok = by > 0 or top_mb
            pm = _i4_pred_mode(C.i4, gbx, gby, l_ok, t_ok)
            m = int(i4m[bi])
            if m == pm:
                enc.encode(st, mps, 68, 1)
            else:
                enc.encode(st, mps, 68, 0)
                rem = m if m < pm else m - 1
                for k in range(3):  # rem_intra4x4_pred_mode: FL, LSB first
                    enc.encode(st, mps, 69, (rem >> k) & 1)
            C.i4[gby, gbx] = m
    else:
        enc.terminate(0)  # not I_PCM
        enc.encode(st, mps, 6, 1 if cbp_l else 0)
        if cbp_c == 0:
            enc.encode(st, mps, 7, 0)
        else:
            enc.encode(st, mps, 7, 1)
            enc.encode(st, mps, 8, 1 if cbp_c == 2 else 0)
        enc.encode(st, mps, 9, (mode >> 1) & 1)
        enc.encode(st, mps, 10, mode & 1)
        cbp_bits = 15 if cbp_l else 0
        C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1

    # intra_chroma_pred_mode: TU cMax 3
    cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
        1 if top_mb and C.cmode[mby - 1, mbx] else 0
    )
    for k in range(cmode):
        enc.encode(st, mps, (64 + cinc) if k == 0 else 67, 1)
    if cmode < 3:
        enc.encode(st, mps, (64 + cinc) if cmode == 0 else 67, 0)

    # coded_block_pattern (I_NxN only)
    if i4:
        bits = 0
        for i in range(4):
            inc_i = _cbp_luma_incs(C, mbx, mby, left_mb, top_mb, bits)[i]
            b = (cbp_l >> i) & 1
            enc.encode(st, mps, 73 + inc_i, b)
            bits |= b << i
        a0 = 1 if left_mb and C.cbp_c[mby, mbx - 1] else 0
        b0 = 1 if top_mb and C.cbp_c[mby - 1, mbx] else 0
        enc.encode(st, mps, 77 + a0 + 2 * b0, 1 if cbp_c else 0)
        if cbp_c:
            a1 = 1 if left_mb and C.cbp_c[mby, mbx - 1] == 2 else 0
            b1 = 1 if top_mb and C.cbp_c[mby - 1, mbx] == 2 else 0
            enc.encode(st, mps, 81 + a1 + 2 * b1, 1 if cbp_c == 2 else 0)

    # mb_qp_delta (always 0 here; ctx bin0 = prev delta != 0, always 0)
    if (not i4) or cbp_l or cbp_c:
        enc.encode(st, mps, 60, 0)

    # -- residuals ------------------------------------------------------------
    ys = C.nnz_y.shape[1]
    if i4:
        for i8 in range(4):
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                if (cbp_l >> i8) & 1:
                    inc = _cbf_inc_4x4(
                        C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb
                    )
                    cbf = _encode_residual(
                        enc, st, mps, 2, lac[4 * by + bx].tolist(), inc
                    )
                    C.nnz_y[gby, gbx] = cbf
                else:
                    C.nnz_y[gby, gbx] = 0
        C.dc_y[mby, mbx] = 0
    else:
        inc = _cbf_inc_dc(C.dc_y, mbx, mby, left_mb, top_mb)
        C.dc_y[mby, mbx] = _encode_residual(
            enc, st, mps, 0, ldc.tolist(), inc
        )
        if cbp_l:
            for bx, by in BLK_SCAN:
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                inc = _cbf_inc_4x4(
                    C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb
                )
                cbf = _encode_residual(
                    enc, st, mps, 1, lac[4 * by + bx][1:].tolist(), inc
                )
                C.nnz_y[gby, gbx] = cbf
        else:
            C.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0

    if cbp_c:
        for comp, dc_grid in ((0, C.dc_u), (1, C.dc_v)):
            inc = _cbf_inc_dc(dc_grid, mbx, mby, left_mb, top_mb)
            dc_grid[mby, mbx] = _encode_residual(
                enc, st, mps, 3, cdc[comp].tolist(), inc
            )
    else:
        C.dc_u[mby, mbx] = 0
        C.dc_v[mby, mbx] = 0
    if cbp_c == 2:
        for comp, grid in ((0, C.nnz_u), (1, C.nnz_v)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                gbx, gby = 2 * mbx + bx, 2 * mby + by
                inc = _cbf_inc_4x4(
                    grid, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb
                )
                cbf = _encode_residual(
                    enc, st, mps, 4, cac[comp, bidx].tolist(), inc
                )
                grid[gby, gbx] = cbf
    else:
        C.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        C.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    C.not_i4[mby, mbx] = 0 if i4 else 1
    C.cmode[mby, mbx] = cmode
    C.cbp_l[mby, mbx] = cbp_bits
    C.cbp_c[mby, mbx] = cbp_c


def _dec_mb(dec, st, mps, C, addr, slice_start, mbw,
            mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac, i4modes,
            t8en: bool = False) -> None:
    mby, mbx, left_mb, top_mb = _mb_common_ctx(C, addr, slice_start, mbw)

    inc = (1 if left_mb and C.not_i4[mby, mbx - 1] else 0) + (
        1 if top_mb and C.not_i4[mby - 1, mbx] else 0
    )
    i4 = dec.decode(st, mps, 3 + inc) == 0
    if i4:
        if t8en:
            fa = 1 if left_mb and C.t8[mby, mbx - 1] else 0
            fb = 1 if top_mb and C.t8[mby - 1, mbx] else 0
            if dec.decode(st, mps, 399 + fa + fb):
                raise NotImplementedError(
                    "Intra_8x8 in the symbol-array parser (our encoder "
                    "emits 4x4 intra only; use golden cabac_slice for "
                    "third-party streams)"
                )
        for bi, (bx, by) in enumerate(BLK_SCAN):
            gbx, gby = 4 * mbx + bx, 4 * mby + by
            l_ok = bx > 0 or left_mb
            t_ok = by > 0 or top_mb
            pm = _i4_pred_mode(C.i4, gbx, gby, l_ok, t_ok)
            if dec.decode(st, mps, 68):
                m = pm
            else:
                rem = 0
                for k in range(3):
                    rem |= dec.decode(st, mps, 69) << k
                m = rem if rem < pm else rem + 1
            i4modes[addr, bi] = m
            C.i4[gby, gbx] = m
        mode = 4
        cbp_l = cbp_c = None  # read after chroma mode
    else:
        if dec.terminate():
            raise NotImplementedError("I_PCM")
        cbp_l = dec.decode(st, mps, 6)
        if dec.decode(st, mps, 7):
            cbp_c = 1 + dec.decode(st, mps, 8)
        else:
            cbp_c = 0
        mode = (dec.decode(st, mps, 9) << 1) | dec.decode(st, mps, 10)
        C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1

    cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
        1 if top_mb and C.cmode[mby - 1, mbx] else 0
    )
    cmode = 0
    while cmode < 3 and dec.decode(
        st, mps, (64 + cinc) if cmode == 0 else 67
    ):
        cmode += 1

    if i4:
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
        cbp_bits = cbp_l
        info_cbp_l = cbp_l
    else:
        cbp_bits = 15 if cbp_l else 0
        info_cbp_l = cbp_l

    if (not i4) or cbp_l or cbp_c:
        if dec.decode(st, mps, 60):
            raise NotImplementedError("nonzero mb_qp_delta")

    mb_info[addr] = (mode, cmode, info_cbp_l, cbp_c)

    if i4:
        for i8 in range(4):
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                if (cbp_l >> i8) & 1:
                    inc = _cbf_inc_4x4(
                        C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb
                    )
                    coeffs, cbf = _decode_residual(dec, st, mps, 2, 16, inc)
                    luma_ac[addr, 4 * by + bx] = coeffs
                    C.nnz_y[gby, gbx] = cbf
                else:
                    C.nnz_y[gby, gbx] = 0
        C.dc_y[mby, mbx] = 0
    else:
        inc = _cbf_inc_dc(C.dc_y, mbx, mby, left_mb, top_mb)
        coeffs, cbf = _decode_residual(dec, st, mps, 0, 16, inc)
        luma_dc[addr] = coeffs
        C.dc_y[mby, mbx] = cbf
        if cbp_l:
            for bx, by in BLK_SCAN:
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                inc = _cbf_inc_4x4(
                    C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb
                )
                coeffs, cbf = _decode_residual(dec, st, mps, 1, 15, inc)
                luma_ac[addr, 4 * by + bx, 1:] = coeffs
                C.nnz_y[gby, gbx] = cbf
        else:
            C.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0

    if cbp_c:
        for comp, dc_grid in ((0, C.dc_u), (1, C.dc_v)):
            inc = _cbf_inc_dc(dc_grid, mbx, mby, left_mb, top_mb)
            coeffs, cbf = _decode_residual(dec, st, mps, 3, 4, inc)
            chroma_dc[addr, comp] = coeffs
            dc_grid[mby, mbx] = cbf
    else:
        C.dc_u[mby, mbx] = 0
        C.dc_v[mby, mbx] = 0
    if cbp_c == 2:
        for comp, grid in ((0, C.nnz_u), (1, C.nnz_v)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                gbx, gby = 2 * mbx + bx, 2 * mby + by
                inc = _cbf_inc_4x4(
                    grid, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb
                )
                coeffs, cbf = _decode_residual(dec, st, mps, 4, 15, inc)
                chroma_ac[addr, comp, bidx] = coeffs
                grid[gby, gbx] = cbf
    else:
        C.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        C.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0

    C.not_i4[mby, mbx] = 0 if i4 else 1
    C.cmode[mby, mbx] = cmode
    C.cbp_l[mby, mbx] = cbp_bits
    C.cbp_c[mby, mbx] = cbp_c


# -- frame level ---------------------------------------------------------------

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
    """Pack one frame's symbol arrays into a CABAC annex-B stream."""
    assert pps.entropy_coding_mode_flag == 1
    mbw, mbh = sps.mb_width, sps.mb_height
    out = bytearray()
    if include_ps:
        w = BitWriter()
        sps.write(w)
        out += nal.wrap_nal(nal.NAL_SPS, w.get_bytes())
        w = BitWriter()
        pps.write(w)
        out += nal.wrap_nal(nal.NAL_PPS, w.get_bytes())

    if slice_mode == "rows":
        slices = [(r * mbw, mbw) for r in range(mbh)]
    elif slice_mode == "single":
        slices = [(0, mbw * mbh)]
    else:
        raise ValueError(slice_mode)

    C = _Ctx(mbw, mbh)
    for start, count in slices:
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=start,
            slice_type=SLICE_I,
            frame_num=frame_num,
            slice_qp_delta=qp - 26 - pps.pic_init_qp_minus26,
            disable_deblocking_filter_idc=deblock_idc,
        ).write(w, sps, pps, idr)
        while w.bit_length % 8:
            w.u(1, 1)  # cabac_alignment_one_bit
        st, mps = init_contexts(CTX_INIT_I, qp)
        enc = CabacEncoder()
        for k in range(count):
            addr = start + k
            _enc_mb(
                enc, st, mps, C, addr, start, mbw,
                mb_info[addr], luma_dc[addr], luma_ac[addr],
                chroma_dc[addr], chroma_ac[addr],
                i4modes[addr] if i4modes is not None else None,
                t8en=pps.transform_8x8_mode_flag == 1,
            )
            enc.terminate(1 if k == count - 1 else 0)  # end_of_slice_flag
        rbsp = w.get_bytes() + enc.get_bytes()
        ntype = nal.NAL_SLICE_IDR if idr else nal.NAL_SLICE_NON_IDR
        out += nal.wrap_nal(ntype, rbsp, nal_ref_idc=3)
    return bytes(out)


def parse_iframe(
    data: bytes,
) -> Tuple[SPS, PPS, int, np.ndarray, np.ndarray, np.ndarray, np.ndarray,
           np.ndarray, np.ndarray]:
    """Parse a CABAC annex-B I-frame back into symbol arrays (same tuple
    contract as pack.parse_iframe)."""
    sps: Optional[SPS] = None
    pps: Optional[PPS] = None
    arrays = None
    qp = 26
    C = None
    for _, ntype, rbsp in nal.split_annexb(data):
        if ntype == nal.NAL_SPS:
            sps = SPS.parse(BitReader(rbsp))
        elif ntype == nal.NAL_PPS:
            pps = PPS.parse(BitReader(rbsp))
        elif ntype in (nal.NAL_SLICE_IDR, nal.NAL_SLICE_NON_IDR):
            assert sps is not None and pps is not None
            assert pps.entropy_coding_mode_flag == 1
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
                C = _Ctx(mbw, mbh)
            r = BitReader(rbsp)
            header = SliceHeader.parse(r, sps, pps, ntype == nal.NAL_SLICE_IDR)
            qp = 26 + pps.pic_init_qp_minus26 + header.slice_qp_delta
            byte0 = (r.bit_position + 7) // 8  # skip cabac alignment ones
            st, mps = init_contexts(CTX_INIT_I, qp)
            dec = CabacDecoder(rbsp, byte0)
            addr = header.first_mb_in_slice
            start = addr
            while True:
                _dec_mb(dec, st, mps, C, addr, start, mbw, *arrays,
                        t8en=pps.transform_8x8_mode_flag == 1)
                addr += 1
                if dec.terminate():
                    break
                if addr >= n:
                    raise ValueError("slice overruns frame")
    assert arrays is not None and sps is not None and pps is not None
    return (sps, pps, qp) + arrays


# ===========================================================================
# P slices (P_Skip / P_L0_16x16 / Intra_16x16-in-P), CTX_INIT_PB tables.
# Same symbol-array contract as entropy/packp.py.
# ===========================================================================

def _enc_mvd(enc, st, mps, base: int, amvd: int, mvd: int) -> None:
    """mvd_l0 component: UEG3 (prefix TU cMax 9, ctx base+{0..2} for bin0
    by neighbor |mvd| sum, base+3..6 for prefix bins), EG3 bypass suffix,
    bypass sign (9.3.3.1.1.7)."""
    inc = 0 if amvd < 3 else (1 if amvd < 33 else 2)
    a = abs(mvd)
    if a == 0:
        enc.encode(st, mps, base + inc, 0)
        return
    enc.encode(st, mps, base + inc, 1)
    k = min(a, 9)
    ctx = base + 3
    n = 1
    while n < k:
        enc.encode(st, mps, ctx, 1)
        if n < 4:
            ctx += 1
        n += 1
    if a < 9:
        enc.encode(st, mps, ctx, 0)
    else:
        v = a - 9
        kk = 3
        while v >= (1 << kk):
            enc.bypass(1)
            v -= 1 << kk
            kk += 1
        enc.bypass(0)
        for b in range(kk - 1, -1, -1):
            enc.bypass((v >> b) & 1)
    enc.bypass(1 if mvd < 0 else 0)


def _dec_mvd(dec, st, mps, base: int, amvd: int) -> int:
    inc = 0 if amvd < 3 else (1 if amvd < 33 else 2)
    if not dec.decode(st, mps, base + inc):
        return 0
    a = 1
    ctx = base + 3
    while a < 9 and dec.decode(st, mps, ctx):
        if a < 4:
            ctx += 1
        a += 1
    if a >= 9:
        kk = 3
        while dec.bypass():
            a += 1 << kk
            kk += 1
        while kk:
            kk -= 1
            a += dec.bypass() << kk
    return -a if dec.bypass() else a


def _enc_chroma_res(enc, st, mps, C, mbx, mby, left_mb, top_mb,
                    cbp_c, cdc, cac, un) -> None:
    if cbp_c:
        for comp, dc_grid in ((0, C.dc_u), (1, C.dc_v)):
            inc = _cbf_inc_dc(dc_grid, mbx, mby, left_mb, top_mb, un)
            dc_grid[mby, mbx] = _encode_residual(
                enc, st, mps, 3, cdc[comp].tolist(), inc
            )
    else:
        C.dc_u[mby, mbx] = 0
        C.dc_v[mby, mbx] = 0
    if cbp_c == 2:
        for comp, grid in ((0, C.nnz_u), (1, C.nnz_v)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                gbx, gby = 2 * mbx + bx, 2 * mby + by
                inc = _cbf_inc_4x4(
                    grid, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb, un
                )
                grid[gby, gbx] = _encode_residual(
                    enc, st, mps, 4, cac[comp, bidx].tolist(), inc
                )
    else:
        C.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        C.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def _dec_chroma_res(dec, st, mps, C, mbx, mby, left_mb, top_mb,
                    cbp_c, chroma_dc, chroma_ac, addr, un) -> None:
    if cbp_c:
        for comp, dc_grid in ((0, C.dc_u), (1, C.dc_v)):
            inc = _cbf_inc_dc(dc_grid, mbx, mby, left_mb, top_mb, un)
            coeffs, cbf = _decode_residual(dec, st, mps, 3, 4, inc)
            chroma_dc[addr, comp] = coeffs
            dc_grid[mby, mbx] = cbf
    else:
        C.dc_u[mby, mbx] = 0
        C.dc_v[mby, mbx] = 0
    if cbp_c == 2:
        for comp, grid in ((0, C.nnz_u), (1, C.nnz_v)):
            for bidx in range(4):
                bx, by = bidx % 2, bidx // 2
                gbx, gby = 2 * mbx + bx, 2 * mby + by
                inc = _cbf_inc_4x4(
                    grid, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb, un
                )
                coeffs, cbf = _decode_residual(dec, st, mps, 4, 15, inc)
                chroma_ac[addr, comp, bidx] = coeffs
                grid[gby, gbx] = cbf
    else:
        C.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
        C.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0


def _mb_zero_p(C, mbx, mby):
    C.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
    C.nnz_u[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    C.nnz_v[2 * mby : 2 * mby + 2, 2 * mbx : 2 * mbx + 2] = 0
    C.dc_y[mby, mbx] = 0
    C.dc_u[mby, mbx] = 0
    C.dc_v[mby, mbx] = 0


def _enc_ref_idx(enc, st, mps, C, mbx, mby, left_mb, top_mb, ref_i):
    """ref_idx_l0: unary bins, bin0 ctx 54 + (refA>0) + 2*(refB>0),
    later bins at 58 then 59 (ffmpeg-verified ctx schedule)."""
    a = 1 if left_mb and C.refidx[mby, mbx - 1] > 0 else 0
    b = 1 if top_mb and C.refidx[mby - 1, mbx] > 0 else 0
    ctx = 54 + a + 2 * b
    for k in range(ref_i):
        enc.encode(st, mps, ctx, 1)
        ctx = 58 if k == 0 else 59
    enc.encode(st, mps, ctx, 0)


def _dec_ref_idx(dec, st, mps, C, mbx, mby, left_mb, top_mb) -> int:
    a = 1 if left_mb and C.refidx[mby, mbx - 1] > 0 else 0
    b = 1 if top_mb and C.refidx[mby - 1, mbx] > 0 else 0
    ctx = 54 + a + 2 * b
    ref = 0
    while dec.decode(st, mps, ctx):
        ctx = 58 if ref == 0 else 59
        ref += 1
        if ref > 32:
            raise ValueError("ref_idx overflow")
    return ref


def _enc_mb_p(enc, st, mps, C, addr, slice_start, mbw,
              info, ldc, lac, cdc, cac, nra: int = 1,
              t8en: bool = False, t8f: int = 0) -> None:
    kind = int(info[0])
    mby, mbx, left_mb, top_mb = _mb_common_ctx(C, addr, slice_start, mbw)

    # mb_skip_flag: condTermFlagN = mbN available and not skipped
    sinc = (1 if left_mb and not C.skip[mby, mbx - 1] else 0) + (
        1 if top_mb and not C.skip[mby - 1, mbx] else 0
    )
    enc.encode(st, mps, 11 + sinc, 1 if kind == KIND_SKIP else 0)
    if kind == KIND_SKIP:
        _mb_zero_p(C, mbx, mby)
        C.skip[mby, mbx] = 1
        C.amvd[mby, mbx] = 0
        C.refidx[mby, mbx] = 0
        C.t8[mby, mbx] = 0
        C.not_i4[mby, mbx] = 0
        C.cmode[mby, mbx] = 0
        C.cbp_l[mby, mbx] = 0
        C.cbp_c[mby, mbx] = 0
        C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1
        return
    C.skip[mby, mbx] = 0

    if kind == KIND_INTRA:
        _, mode, cmode, cbp_l, cbp_c, _, _, _ = (int(x) for x in info)
        # P mb_type prefix '1' (intra), then I16 suffix at ctx base 17
        enc.encode(st, mps, 14, 1)
        enc.encode(st, mps, 17, 1)  # not I_NxN
        enc.terminate(0)  # not I_PCM
        enc.encode(st, mps, 18, 1 if cbp_l else 0)
        if cbp_c == 0:
            enc.encode(st, mps, 19, 0)
        else:
            enc.encode(st, mps, 19, 1)
            enc.encode(st, mps, 19, 1 if cbp_c == 2 else 0)
        enc.encode(st, mps, 20, (mode >> 1) & 1)
        enc.encode(st, mps, 20, mode & 1)
        cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
            1 if top_mb and C.cmode[mby - 1, mbx] else 0
        )
        for k in range(cmode):
            enc.encode(st, mps, (64 + cinc) if k == 0 else 67, 1)
        if cmode < 3:
            enc.encode(st, mps, (64 + cinc) if cmode == 0 else 67, 0)
        enc.encode(st, mps, 60, 0)  # mb_qp_delta (always coded for I16)
        inc = _cbf_inc_dc(C.dc_y, mbx, mby, left_mb, top_mb, 1)
        C.dc_y[mby, mbx] = _encode_residual(enc, st, mps, 0, ldc.tolist(), inc)
        if cbp_l:
            for bx, by in BLK_SCAN:
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                inc = _cbf_inc_4x4(
                    C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb, 1
                )
                C.nnz_y[gby, gbx] = _encode_residual(
                    enc, st, mps, 1, lac[4 * by + bx][1:].tolist(), inc
                )
        else:
            C.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
        _enc_chroma_res(enc, st, mps, C, mbx, mby, left_mb, top_mb,
                        cbp_c, cdc, cac, 1)
        C.amvd[mby, mbx] = 0
        C.refidx[mby, mbx] = 0
        C.t8[mby, mbx] = 0
        C.not_i4[mby, mbx] = 1
        C.cmode[mby, mbx] = cmode
        C.cbp_l[mby, mbx] = 15 if cbp_l else 0
        C.cbp_c[mby, mbx] = cbp_c
        C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1
        return

    # P_L0_16x16: mb_type bins '0' (14), '0' (15), '0' (16)
    _, _, _, cbp_l, cbp_c, mvdx, mvdy, ref_i = (int(x) for x in info)
    enc.encode(st, mps, 14, 0)
    enc.encode(st, mps, 15, 0)
    enc.encode(st, mps, 16, 0)
    if nra > 1:
        _enc_ref_idx(enc, st, mps, C, mbx, mby, left_mb, top_mb, ref_i)
    amvx = (int(C.amvd[mby, mbx - 1, 0]) if left_mb else 0) + (
        int(C.amvd[mby - 1, mbx, 0]) if top_mb else 0
    )
    amvy = (int(C.amvd[mby, mbx - 1, 1]) if left_mb else 0) + (
        int(C.amvd[mby - 1, mbx, 1]) if top_mb else 0
    )
    _enc_mvd(enc, st, mps, 40, amvx, mvdx)
    _enc_mvd(enc, st, mps, 47, amvy, mvdy)
    C.amvd[mby, mbx] = (abs(mvdx), abs(mvdy))
    C.refidx[mby, mbx] = ref_i if nra > 1 else 0
    # coded_block_pattern
    bits = 0
    for i in range(4):
        inc_i = _cbp_luma_incs(C, mbx, mby, left_mb, top_mb, bits)[i]
        b = (cbp_l >> i) & 1
        enc.encode(st, mps, 73 + inc_i, b)
        bits |= b << i
    a0 = 1 if left_mb and C.cbp_c[mby, mbx - 1] else 0
    b0 = 1 if top_mb and C.cbp_c[mby - 1, mbx] else 0
    enc.encode(st, mps, 77 + a0 + 2 * b0, 1 if cbp_c else 0)
    if cbp_c:
        a1 = 1 if left_mb and C.cbp_c[mby, mbx - 1] == 2 else 0
        b1 = 1 if top_mb and C.cbp_c[mby - 1, mbx] == 2 else 0
        enc.encode(st, mps, 81 + a1 + 2 * b1, 1 if cbp_c == 2 else 0)
    if t8en and cbp_l > 0:  # transform_size_8x8_flag, ctx 399 + nbrs
        fa = 1 if left_mb and C.t8[mby, mbx - 1] else 0
        fb = 1 if top_mb and C.t8[mby - 1, mbx] else 0
        enc.encode(st, mps, 399 + fa + fb, t8f)
    else:
        t8f = 0
    if cbp_l or cbp_c:
        enc.encode(st, mps, 60, 0)  # mb_qp_delta
    if t8f:
        # luma residual: cat 5 per coded 8x8 (coeffs: lac flat [256] =
        # four zigzag8 blocks in raster 8x8 order)
        flat = lac.reshape(256)
        for i8 in range(4):
            y8, x8 = i8 >> 1, i8 & 1
            if (cbp_l >> i8) & 1:
                _encode_residual8(
                    enc, st, mps, flat[64 * i8 : 64 * i8 + 64].tolist()
                )
                C.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                        4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 1
            else:
                C.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                        4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 0
    else:
        # luma residual: cat 2, 16 coeffs, gated per 8x8
        for i8 in range(4):
            for b in range(4 * i8, 4 * i8 + 4):
                bx, by = BLK_SCAN[b]
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                if (cbp_l >> i8) & 1:
                    inc = _cbf_inc_4x4(
                        C.nnz_y, gbx, gby, bx > 0 or left_mb,
                        by > 0 or top_mb, 0
                    )
                    C.nnz_y[gby, gbx] = _encode_residual(
                        enc, st, mps, 2, lac[4 * by + bx].tolist(), inc
                    )
                else:
                    C.nnz_y[gby, gbx] = 0
    C.dc_y[mby, mbx] = 0
    _enc_chroma_res(enc, st, mps, C, mbx, mby, left_mb, top_mb,
                    cbp_c, cdc, cac, 0)
    C.not_i4[mby, mbx] = 1
    C.cmode[mby, mbx] = 0
    C.cbp_l[mby, mbx] = cbp_l
    C.cbp_c[mby, mbx] = cbp_c
    C.t8[mby, mbx] = t8f
    C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1


def _dec_mb_p(dec, st, mps, C, addr, slice_start, mbw,
              mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
              nra: int = 1, t8en: bool = False, t8out=None) -> None:
    mby, mbx, left_mb, top_mb = _mb_common_ctx(C, addr, slice_start, mbw)
    info = mb_info[addr]
    info[:] = 0

    sinc = (1 if left_mb and not C.skip[mby, mbx - 1] else 0) + (
        1 if top_mb and not C.skip[mby - 1, mbx] else 0
    )
    if dec.decode(st, mps, 11 + sinc):
        info[0] = KIND_SKIP
        _mb_zero_p(C, mbx, mby)
        C.skip[mby, mbx] = 1
        C.amvd[mby, mbx] = 0
        C.refidx[mby, mbx] = 0
        C.t8[mby, mbx] = 0
        C.refidx[mby, mbx] = 0
        C.not_i4[mby, mbx] = 0
        C.cmode[mby, mbx] = 0
        C.cbp_l[mby, mbx] = 0
        C.cbp_c[mby, mbx] = 0
        C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1
        return
    C.skip[mby, mbx] = 0

    if dec.decode(st, mps, 14):  # intra in P
        if dec.decode(st, mps, 17) == 0:
            raise NotImplementedError("I_NxN in P slice")
        if dec.terminate():
            raise NotImplementedError("I_PCM")
        cbp_l = dec.decode(st, mps, 18)
        if dec.decode(st, mps, 19):
            cbp_c = 1 + dec.decode(st, mps, 19)
        else:
            cbp_c = 0
        mode = (dec.decode(st, mps, 20) << 1) | dec.decode(st, mps, 20)
        cinc = (1 if left_mb and C.cmode[mby, mbx - 1] else 0) + (
            1 if top_mb and C.cmode[mby - 1, mbx] else 0
        )
        cmode = 0
        while cmode < 3 and dec.decode(
            st, mps, (64 + cinc) if cmode == 0 else 67
        ):
            cmode += 1
        if dec.decode(st, mps, 60):
            raise NotImplementedError("nonzero mb_qp_delta")
        info[0], info[1], info[2], info[3], info[4] = (
            KIND_INTRA, mode, cmode, cbp_l, cbp_c
        )
        inc = _cbf_inc_dc(C.dc_y, mbx, mby, left_mb, top_mb, 1)
        coeffs, cbf = _decode_residual(dec, st, mps, 0, 16, inc)
        luma_dc[addr] = coeffs
        C.dc_y[mby, mbx] = cbf
        if cbp_l:
            for bx, by in BLK_SCAN:
                gbx, gby = 4 * mbx + bx, 4 * mby + by
                inc = _cbf_inc_4x4(
                    C.nnz_y, gbx, gby, bx > 0 or left_mb, by > 0 or top_mb, 1
                )
                coeffs, cbf = _decode_residual(dec, st, mps, 1, 15, inc)
                luma_ac[addr, 4 * by + bx, 1:] = coeffs
                C.nnz_y[gby, gbx] = cbf
        else:
            C.nnz_y[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = 0
        _dec_chroma_res(dec, st, mps, C, mbx, mby, left_mb, top_mb,
                        cbp_c, chroma_dc, chroma_ac, addr, 1)
        C.amvd[mby, mbx] = 0
        C.refidx[mby, mbx] = 0
        C.t8[mby, mbx] = 0
        C.not_i4[mby, mbx] = 1
        C.cmode[mby, mbx] = cmode
        C.cbp_l[mby, mbx] = 15 if cbp_l else 0
        C.cbp_c[mby, mbx] = cbp_c
        C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1
        return

    if dec.decode(st, mps, 15):
        raise NotImplementedError("P 16x8/8x16 partitions")
    if dec.decode(st, mps, 16):
        raise NotImplementedError("P_8x8")
    ref_i = 0
    if nra > 1:
        ref_i = _dec_ref_idx(dec, st, mps, C, mbx, mby, left_mb, top_mb)
    amvx = (int(C.amvd[mby, mbx - 1, 0]) if left_mb else 0) + (
        int(C.amvd[mby - 1, mbx, 0]) if top_mb else 0
    )
    amvy = (int(C.amvd[mby, mbx - 1, 1]) if left_mb else 0) + (
        int(C.amvd[mby - 1, mbx, 1]) if top_mb else 0
    )
    mvdx = _dec_mvd(dec, st, mps, 40, amvx)
    mvdy = _dec_mvd(dec, st, mps, 47, amvy)
    C.amvd[mby, mbx] = (abs(mvdx), abs(mvdy))
    C.refidx[mby, mbx] = ref_i
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
    t8f = 0
    if t8en and cbp_l > 0:
        fa = 1 if left_mb and C.t8[mby, mbx - 1] else 0
        fb = 1 if top_mb and C.t8[mby - 1, mbx] else 0
        t8f = dec.decode(st, mps, 399 + fa + fb)
    if cbp_l or cbp_c:
        if dec.decode(st, mps, 60):
            raise NotImplementedError("nonzero mb_qp_delta")
    info[0], info[3], info[4], info[5], info[6] = (
        KIND_INTER, cbp_l, cbp_c, mvdx, mvdy
    )
    info[7] = ref_i
    if t8out is not None:
        t8out[addr] = t8f
    if t8f:
        flat = luma_ac[addr].reshape(256)
        for i8 in range(4):
            y8, x8 = i8 >> 1, i8 & 1
            if (cbp_l >> i8) & 1:
                flat[64 * i8 : 64 * i8 + 64] = _decode_residual8(dec, st, mps)
                C.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                        4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 1
            else:
                C.nnz_y[4 * mby + 2 * y8 : 4 * mby + 2 * y8 + 2,
                        4 * mbx + 2 * x8 : 4 * mbx + 2 * x8 + 2] = 0
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
                    coeffs, cbf = _decode_residual(dec, st, mps, 2, 16, inc)
                    luma_ac[addr, 4 * by + bx] = coeffs
                    C.nnz_y[gby, gbx] = cbf
                else:
                    C.nnz_y[gby, gbx] = 0
    C.dc_y[mby, mbx] = 0
    _dec_chroma_res(dec, st, mps, C, mbx, mby, left_mb, top_mb,
                    cbp_c, chroma_dc, chroma_ac, addr, 0)
    C.not_i4[mby, mbx] = 1
    C.cmode[mby, mbx] = 0
    C.cbp_l[mby, mbx] = cbp_l
    C.cbp_c[mby, mbx] = cbp_c
    C.t8[mby, mbx] = t8f
    C.i4[4 * mby : 4 * mby + 4, 4 * mbx : 4 * mbx + 4] = -1


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
    t8flags=None,
) -> bytes:
    """Pack one P-frame's symbol arrays into CABAC annex-B slice NALs
    (cabac_init_idc 0; same contract as packp.pack_pframe).  t8flags [N]
    carries per-MB transform_size_8x8_flag when the PPS enables the 8x8
    transform."""
    assert pps.entropy_coding_mode_flag == 1
    mbw, mbh = sps.mb_width, sps.mb_height
    if slice_mode == "rows":
        slices = [(r * mbw, mbw) for r in range(mbh)]
    elif slice_mode == "single":
        slices = [(0, mbw * mbh)]
    else:
        raise ValueError(slice_mode)
    C = _Ctx(mbw, mbh)
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
        while w.bit_length % 8:
            w.u(1, 1)  # cabac_alignment_one_bit
        st, mps = init_contexts(CTX_INIT_PB[0], qp)
        enc = CabacEncoder()
        t8en = pps.transform_8x8_mode_flag == 1
        for k in range(count):
            addr = start + k
            _enc_mb_p(
                enc, st, mps, C, addr, start, mbw,
                mb_info[addr], luma_dc[addr], luma_ac[addr],
                chroma_dc[addr], chroma_ac[addr], nra=num_ref_active,
                t8en=t8en,
                t8f=int(t8flags[addr]) if t8flags is not None else 0,
            )
            enc.terminate(1 if k == count - 1 else 0)
        rbsp = w.get_bytes() + enc.get_bytes()
        out += nal.wrap_nal(
            nal.NAL_SLICE_NON_IDR, rbsp, nal_ref_idc=2 if ref else 0
        )
    return bytes(out)


def parse_pframe_slices(slices, sps: SPS, pps: PPS, qp: Optional[int] = None,
                        nra: int = 1):
    """Parse CABAC P slices (list of (rbsp, header_bit_pos, first_mb)) ->
    symbol arrays + per-MB transform_size_8x8_flags (packp contract plus
    the slice QP, which CABAC context initialization needs)."""
    assert pps.entropy_coding_mode_flag == 1
    assert qp is not None, "CABAC P parse needs the slice QP"
    mbw, mbh = sps.mb_width, sps.mb_height
    n = mbw * mbh
    mb_info = np.zeros((n, 8), np.int32)
    luma_dc = np.zeros((n, 16), np.int16)
    luma_ac = np.zeros((n, 16, 16), np.int16)
    chroma_dc = np.zeros((n, 2, 4), np.int16)
    chroma_ac = np.zeros((n, 2, 4, 15), np.int16)
    t8arr = np.zeros(n, np.int32)
    C = _Ctx(mbw, mbh)
    t8en = pps.transform_8x8_mode_flag == 1
    for rbsp, start_bit, first_mb in slices:
        byte0 = (start_bit + 7) // 8  # skip cabac alignment ones
        st, mps = init_contexts(CTX_INIT_PB[0], qp)
        dec = CabacDecoder(rbsp, byte0)
        addr = first_mb
        while True:
            _dec_mb_p(dec, st, mps, C, addr, first_mb, mbw,
                      mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                      nra=nra, t8en=t8en, t8out=t8arr)
            addr += 1
            if dec.terminate():
                break
            if addr >= n:
                raise ValueError("slice overruns frame")
    return mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac, t8arr
