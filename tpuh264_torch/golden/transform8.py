# Copy of tpuh264/golden/transform8.py, so that the port imports nothing of tpuh264.
"""High-profile 8x8 integer transform + quantization (H.264 8.5.13) --
numpy oracle, shared tables for the TPU kernels.

The inverse transform and dequantization are normative; the forward pair
is the standard JM/x264 butterfly with MF chosen so that
quant(forward(x)) dequantizes back through the normative path.  The 8x8
zigzag (Table 8-8) is generated algorithmically.
"""

from __future__ import annotations

import numpy as np

# normative dequant scale classes (levelScale8x8, cross-checked against
# the system libavcodec's dequant8_coeff_init tables)
_DQ8_INIT = np.array(
    [
        [20, 18, 32, 19, 25, 24],
        [22, 19, 35, 21, 28, 26],
        [26, 23, 42, 24, 33, 31],
        [28, 25, 45, 26, 35, 33],
        [32, 28, 51, 30, 40, 38],
        [36, 32, 58, 34, 46, 43],
    ],
    np.int32,
)
_DQ8_SCAN = np.array(
    [0, 3, 4, 3, 3, 1, 5, 1, 4, 5, 2, 5, 3, 1, 5, 1], np.int32
)

# V8[m][i][j]: dequant scale per qp%6 and position
V8_TABLE = np.zeros((6, 8, 8), np.int32)
for _m in range(6):
    for _i in range(8):
        for _j in range(8):
            V8_TABLE[_m, _i, _j] = _DQ8_INIT[
                _m, _DQ8_SCAN[(_i & 3) * 4 + (_j & 3)]
            ]

# forward quant MF8: the JM multipliers satisfying MF*V ~= 2^22 per class
# (class values from the JM reference software quant tables)
_MF8_INIT = np.array(
    [
        [13107, 11428, 20972, 12222, 16777, 15481],
        [11916, 10826, 19174, 11058, 14980, 14290],
        [10082, 8943, 15978, 9675, 12710, 11985],
        [9362, 8228, 14913, 8931, 11984, 11259],
        [8192, 7346, 13159, 7740, 10486, 9777],
        [7282, 6428, 11570, 6830, 9118, 8640],
    ],
    np.int32,
)
MF8_TABLE = np.zeros((6, 8, 8), np.int32)
for _m in range(6):
    for _i in range(8):
        for _j in range(8):
            MF8_TABLE[_m, _i, _j] = _MF8_INIT[
                _m, _DQ8_SCAN[(_i & 3) * 4 + (_j & 3)]
            ]


def _zigzag8_order() -> np.ndarray:
    """8x8 zigzag scan order (Table 8-8) as raster indices: diagonal d
    runs top-right -> bottom-left for odd d, reversed for even d."""
    out = []
    for d in range(15):
        cells = [(r, d - r) for r in range(max(0, d - 7), min(d, 7) + 1)]
        if d % 2 == 0:
            cells = cells[::-1]
        out.extend(cells)
    return np.array([r * 8 + c for r, c in out], np.int32)


# empirically calibrated against libavcodec: the scan addresses the
# TRANSPOSED raster relative to the butterfly-axis convention
ZIGZAG8 = np.array(
    [(i % 8) * 8 + (i // 8) for i in _zigzag8_order()], np.int32
)
INV_ZIGZAG8 = np.argsort(ZIGZAG8)


def forward8x8(resid: np.ndarray) -> np.ndarray:
    """Forward 8x8 butterfly over [..., 8, 8] (int, exact), emitting
    coefficients in the NORMATIVE (column-major) layout the 8.5.13
    inverse expects (empirically calibrated against libavcodec's
    idct8)."""
    x = resid.astype(np.int64)

    def stage(s):  # transform along the last axis
        a = [None] * 8
        s07 = s[..., 0] + s[..., 7]
        d07 = s[..., 0] - s[..., 7]
        s16 = s[..., 1] + s[..., 6]
        d16 = s[..., 1] - s[..., 6]
        s25 = s[..., 2] + s[..., 5]
        d25 = s[..., 2] - s[..., 5]
        s34 = s[..., 3] + s[..., 4]
        d34 = s[..., 3] - s[..., 4]
        a0 = s07 + s34
        a1 = s16 + s25
        a2 = s07 - s34
        a3 = s16 - s25
        a4 = d16 + d25 + (d07 + (d07 >> 1))
        a5 = d07 - d34 - (d25 + (d25 >> 1))
        a6 = d07 + d34 - (d16 + (d16 >> 1))
        a7 = d16 - d25 + (d34 + (d34 >> 1))
        out = np.empty_like(s)
        out[..., 0] = a0 + a1
        out[..., 4] = a0 - a1
        out[..., 2] = a2 + (a3 >> 1)
        out[..., 6] = (a2 >> 1) - a3
        out[..., 1] = a4 + (a7 >> 2)
        out[..., 3] = a5 + (a6 >> 2)
        out[..., 5] = a6 - (a5 >> 2)
        out[..., 7] = (a4 >> 2) - a7
        return out

    w = stage(x)                       # rows
    w = stage(w.swapaxes(-1, -2)).swapaxes(-1, -2)  # columns
    return w.swapaxes(-1, -2)          # normative coefficient layout


def inverse8x8(d: np.ndarray) -> np.ndarray:
    """Normative inverse 8x8 transform (8.5.13.2) over [..., 8, 8];
    bit-exact against libavcodec's ff_h264_idct8_add (the coefficient
    layout is column-major relative to the butterfly axes)."""
    x = d.swapaxes(-1, -2).astype(np.int64)

    def stage(s):  # 1-D inverse along the last axis
        a0 = s[..., 0] + s[..., 4]
        a4 = s[..., 0] - s[..., 4]
        a2 = (s[..., 2] >> 1) - s[..., 6]
        a6 = s[..., 2] + (s[..., 6] >> 1)
        b0 = a0 + a6
        b2 = a4 + a2
        b4 = a4 - a2
        b6 = a0 - a6
        a1 = -s[..., 3] + s[..., 5] - s[..., 7] - (s[..., 7] >> 1)
        a3 = s[..., 1] + s[..., 7] - s[..., 3] - (s[..., 3] >> 1)
        a5 = -s[..., 1] + s[..., 7] + s[..., 5] + (s[..., 5] >> 1)
        a7 = s[..., 3] + s[..., 5] + s[..., 1] + (s[..., 1] >> 1)
        b1 = a1 + (a7 >> 2)
        b7 = a7 - (a1 >> 2)
        b3 = a3 + (a5 >> 2)
        b5 = (a3 >> 2) - a5
        out = np.empty_like(s)
        out[..., 0] = b0 + b7
        out[..., 7] = b0 - b7
        out[..., 1] = b2 + b5
        out[..., 6] = b2 - b5
        out[..., 2] = b4 + b3
        out[..., 5] = b4 - b3
        out[..., 3] = b6 + b1
        out[..., 4] = b6 - b1
        return out

    e = stage(x)                       # horizontal (rows)
    e = stage(e.swapaxes(-1, -2)).swapaxes(-1, -2)  # vertical
    return e


def quant8x8(w: np.ndarray, qp: int, intra: bool = False) -> np.ndarray:
    """level = sign * ((|W| * MF8 + f) >> (16 + qp/6)).

    Standard JM convention (qbits 16); |W|*MF stays inside int32 for
    the TPU kernel."""
    qbits = 16 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    mf = MF8_TABLE[qp % 6]
    z = (np.abs(w.astype(np.int64)) * mf + f) >> qbits
    return (np.sign(w) * z).astype(np.int64)


def dequant8x8(z: np.ndarray, qp: int) -> np.ndarray:
    """Normative 8x8 scaling (8.5.13.1); the shift base is 2
    (empirically calibrated against libavcodec's decode)."""
    v = V8_TABLE[qp % 6]
    z = z.astype(np.int64)
    if qp >= 12:
        return (z * v) << (qp // 6 - 2)
    shift = 2 - qp // 6
    return (z * v + (1 << (shift - 1))) >> shift


def idct8_add(pred: np.ndarray, d: np.ndarray) -> np.ndarray:
    r = (inverse8x8(d) + 32) >> 6
    return np.clip(pred.astype(np.int64) + r, 0, 255).astype(np.int32)


def zigzag8(block: np.ndarray) -> np.ndarray:
    flat = block.reshape(*block.shape[:-2], 64)
    return flat[..., ZIGZAG8]


def inverse_zigzag8(coeffs: np.ndarray) -> np.ndarray:
    out = coeffs[..., INV_ZIGZAG8]
    return out.reshape(*coeffs.shape[:-1], 8, 8)
