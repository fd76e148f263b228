# Copy of tpuh264/golden/transform.py, so that the port imports nothing of tpuh264.
"""H.264 4x4 integer transform, Hadamard, quantization (numpy oracle).

Decoder-side math is normative (H.264 8.5.10-8.5.12); encoder-side
forward transform/quant follows the classic JM/x264 integer formulation.
The reference delegates all of this to libopenh264.a (its wrapper only
calls EncodeFrame/DecodeFrameNoDelay, reference/openh264_wrapper.cpp:351,407);
here it is the heart of the engine.

Conventions: arrays are int32 numpy; blocks are [..., 4, 4] so everything
is batched over leading axes.
"""

from __future__ import annotations

import numpy as np

# Forward core transform matrix Cf (H.264 spec derivation; JM `forward4x4`)
CF = np.array(
    [[1, 1, 1, 1], [2, 1, -1, -2], [1, -1, -1, 1], [1, -2, 2, -1]], dtype=np.int32
)
# 4x4 Hadamard (luma DC), symmetric, H @ H = 4 I
H4 = np.array(
    [[1, 1, 1, 1], [1, 1, -1, -1], [1, -1, -1, 1], [1, -1, 1, -1]], dtype=np.int32
)
# 2x2 Hadamard (chroma DC), H2 @ H2 = 2 I
H2 = np.array([[1, 1], [1, -1]], dtype=np.int32)

# Quant multiplier MF[qp%6][i][j] and dequant scale V[qp%6][i][j],
# positions classed a=(0,0),(0,2),(2,0),(2,2); b=(1,1),(1,3),(3,1),(3,3); c=rest.
_MF_A = [13107, 11916, 10082, 9362, 8192, 7282]
_MF_B = [5243, 4660, 4194, 3647, 3355, 2893]
_MF_C = [8066, 7490, 6554, 5825, 5243, 4559]
_V_A = [10, 11, 13, 14, 16, 18]
_V_B = [16, 18, 20, 23, 25, 29]
_V_C = [13, 14, 16, 18, 20, 23]


def _pos_table(a, b, c):
    t = np.zeros((6, 4, 4), dtype=np.int32)
    for m in range(6):
        t[m, :, :] = c[m]
        for i, j in ((0, 0), (0, 2), (2, 0), (2, 2)):
            t[m, i, j] = a[m]
        for i, j in ((1, 1), (1, 3), (3, 1), (3, 3)):
            t[m, i, j] = b[m]
    return t


MF_TABLE = _pos_table(_MF_A, _MF_B, _MF_C)  # (6,4,4)
V_TABLE = _pos_table(_V_A, _V_B, _V_C)  # (6,4,4)

# Chroma QP mapping, H.264 Table 8-15 (qPi 30..51)
_CHROMA_QP_TAIL = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                   37, 37, 37, 38, 38, 38, 39, 39, 39, 39]
CHROMA_QP_TABLE = np.array(list(range(30)) + _CHROMA_QP_TAIL, dtype=np.int32)


def chroma_qp(qp_y: int, chroma_qp_index_offset: int = 0) -> int:
    qpi = int(np.clip(qp_y + chroma_qp_index_offset, 0, 51))
    return int(CHROMA_QP_TABLE[qpi])


def forward4x4(residual: np.ndarray) -> np.ndarray:
    """Forward 4x4 core transform: W = Cf @ X @ Cf^T over [..., 4, 4]."""
    x = residual.astype(np.int32)
    return np.einsum("ij,...jk,lk->...il", CF, x, CF)


def hadamard4x4(dc: np.ndarray) -> np.ndarray:
    x = dc.astype(np.int32)
    return np.einsum("ij,...jk,lk->...il", H4, x, H4)


def hadamard2x2(dc: np.ndarray) -> np.ndarray:
    x = dc.astype(np.int32)
    return np.einsum("ij,...jk,lk->...il", H2, x, H2)


def quant4x4(w: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Scalar quantization of 4x4 transform coefficients [..., 4, 4]."""
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    mf = MF_TABLE[qp % 6]
    w = w.astype(np.int64)
    z = (np.abs(w) * mf + f) >> qbits
    return (np.sign(w) * z).astype(np.int32)


def quant_luma_dc(wdc_hadamard: np.ndarray, qp: int) -> np.ndarray:
    """Quantize Hadamard-transformed luma DC [..., 4, 4].

    Levels approximate (H W H)/4 / qstep so that the normative inverse
    (8.5.10: f = H Z H; dc = f*V0 << (qp/6 - 2)) lands on the AC-path scale.
    """
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf0 = int(MF_TABLE[qp % 6, 0, 0])
    w = wdc_hadamard.astype(np.int64)
    z = (np.abs(w) * mf0 + (f << 2)) >> (qbits + 2)
    return (np.sign(w) * z).astype(np.int32)


def quant_chroma_dc(wdc_hadamard: np.ndarray, qp: int, intra: bool = True) -> np.ndarray:
    """Quantize 2x2 Hadamard chroma DC [..., 2, 2] (levels ~ (H W H)/2 / qstep)."""
    qbits = 15 + qp // 6
    f = ((1 << qbits) // 3) if intra else ((1 << qbits) // 6)
    mf0 = int(MF_TABLE[qp % 6, 0, 0])
    w = wdc_hadamard.astype(np.int64)
    z = (np.abs(w) * mf0 + (f << 1)) >> (qbits + 1)
    return (np.sign(w) * z).astype(np.int32)


def dequant4x4(z: np.ndarray, qp: int) -> np.ndarray:
    """Normative AC dequant (8.5.12.1 flat scaling): d = z * V * 2^(qp/6)."""
    v = V_TABLE[qp % 6]
    return (z.astype(np.int32) * v) << (qp // 6)


def dequant_luma_dc(z: np.ndarray, qp: int) -> np.ndarray:
    """Normative luma DC scaling (8.5.10): inverse Hadamard then scale."""
    f = hadamard4x4(z)
    v0 = int(V_TABLE[qp % 6, 0, 0])
    if qp >= 12:
        return (f * v0) << (qp // 6 - 2)
    shift = 2 - qp // 6
    return (f * v0 + (1 << (shift - 1))) >> shift


def dequant_chroma_dc(z: np.ndarray, qp: int) -> np.ndarray:
    """Normative chroma DC scaling (8.5.11): dc = ((H z H) * V0 << qp/6) >> 1."""
    f = hadamard2x2(z)
    v0 = int(V_TABLE[qp % 6, 0, 0])
    return ((f * v0) << (qp // 6)) >> 1


def inverse4x4(d: np.ndarray) -> np.ndarray:
    """Normative inverse core transform (8.5.12.2), output BEFORE (x+32)>>6.

    Input d: dequantized coefficients [..., 4, 4] with DC already substituted
    for I16x16/chroma blocks.
    """
    d = d.astype(np.int32)
    # Stage 1 operates within each row i (combining d[i][0..3]); stage 2
    # within each column.  The >>1 makes the order normative (8.5.12.2):
    # rows first, then columns -- libavcodec agrees bit-exactly.
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f0 = e0 + e3
    f1 = e1 + e2
    f2 = e1 - e2
    f3 = e0 - e3
    f = np.stack([f0, f1, f2, f3], axis=-1)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    h0 = g0 + g3
    h1 = g1 + g2
    h2 = g1 - g2
    h3 = g0 - g3
    return np.stack([h0, h1, h2, h3], axis=-2)


def idct_add(pred: np.ndarray, d: np.ndarray) -> np.ndarray:
    """Reconstruct: clip1(pred + (inverse4x4(d) + 32) >> 6) over [..., 4, 4]."""
    r = (inverse4x4(d) + 32) >> 6
    return np.clip(pred.astype(np.int32) + r, 0, 255)


# ---------------------------------------------------------------------------
# Block <-> plane reshaping helpers (MB-major layouts used everywhere)
# ---------------------------------------------------------------------------

def plane_to_blocks4(plane: np.ndarray) -> np.ndarray:
    """[H, W] -> [H//4, W//4, 4, 4] raster-ordered 4x4 blocks."""
    h, w = plane.shape[-2:]
    return (
        plane.reshape(*plane.shape[:-2], h // 4, 4, w // 4, 4)
        .swapaxes(-3, -2)
    )


def blocks4_to_plane(blocks: np.ndarray) -> np.ndarray:
    """[H//4, W//4, 4, 4] -> [H, W]."""
    nb_h, nb_w = blocks.shape[-4], blocks.shape[-3]
    return (
        blocks.swapaxes(-3, -2).reshape(*blocks.shape[:-4], nb_h * 4, nb_w * 4)
    )


# Zigzag scan for 4x4 blocks (Table 8-13 inverse: coeff order -> (i,j))
ZIGZAG4 = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], dtype=np.int32
)


def zigzag(block: np.ndarray) -> np.ndarray:
    """[..., 4, 4] -> [..., 16] in zigzag scan order."""
    flat = block.reshape(*block.shape[:-2], 16)
    return flat[..., ZIGZAG4]


def inverse_zigzag(coeffs: np.ndarray) -> np.ndarray:
    """[..., 16] zigzag order -> [..., 4, 4]."""
    out = np.zeros_like(coeffs)
    out[..., ZIGZAG4] = coeffs
    return out.reshape(*coeffs.shape[:-1], 4, 4)
