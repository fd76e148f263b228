"""H.264 4x4 integer transform / quant in PyTorch (int32, any device).

Port of tpuh264/kernels/transform.py, bit-exact with it and with the
numpy oracle tpuh264.golden.transform (its tables are copied into
golden/transform.py).  Every value fits int32 (worst
case |W|*MF ~ 2.1e8 < 2^31).  Batched over arbitrary leading axes.

`qp` is a Python int: eager PyTorch has no trace to keep stable, so the
table row for a QP is a view of a cached device table and every shift
amount is a host integer -- no device synchronisation anywhere.
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.transform import (
    CHROMA_QP_TABLE,
    MF_TABLE,
    V_TABLE,
    ZIGZAG4,
)
from . import tables

tables.register("mf", lambda: MF_TABLE.astype(np.int32))          # [6,4,4]
tables.register("v_flat", lambda: V_TABLE.reshape(6, 16).astype(np.int32))
tables.register("zz", lambda: np.asarray(ZIGZAG4, np.int64))
tables.register("inv_zz", lambda: np.argsort(ZIGZAG4).astype(np.int64))


def forward4x4(x: torch.Tensor) -> torch.Tensor:
    """Forward core transform over [..., 4, 4] via butterflies (exact)."""
    x = x.to(torch.int32)
    a0 = x[..., 0, :] + x[..., 3, :]
    a1 = x[..., 1, :] + x[..., 2, :]
    a2 = x[..., 1, :] - x[..., 2, :]
    a3 = x[..., 0, :] - x[..., 3, :]
    s = torch.stack([a0 + a1, 2 * a3 + a2, a0 - a1, a3 - 2 * a2], dim=-2)
    b0 = s[..., :, 0] + s[..., :, 3]
    b1 = s[..., :, 1] + s[..., :, 2]
    b2 = s[..., :, 1] - s[..., :, 2]
    b3 = s[..., :, 0] - s[..., :, 3]
    return torch.stack([b0 + b1, 2 * b3 + b2, b0 - b1, b3 - 2 * b2], dim=-1)


def hadamard4x4(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32)
    a0 = x[..., 0, :] + x[..., 3, :]
    a1 = x[..., 1, :] + x[..., 2, :]
    a2 = x[..., 1, :] - x[..., 2, :]
    a3 = x[..., 0, :] - x[..., 3, :]
    s = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-2)
    b0 = s[..., :, 0] + s[..., :, 3]
    b1 = s[..., :, 1] + s[..., :, 2]
    b2 = s[..., :, 1] - s[..., :, 2]
    b3 = s[..., :, 0] - s[..., :, 3]
    return torch.stack([b0 + b1, b3 + b2, b0 - b1, b3 - b2], dim=-1)


def hadamard2x2(x: torch.Tensor) -> torch.Tensor:
    x = x.to(torch.int32)
    a = x[..., 0, :] + x[..., 1, :]
    b = x[..., 0, :] - x[..., 1, :]
    s = torch.stack([a, b], dim=-2)
    return torch.stack(
        [s[..., :, 0] + s[..., :, 1], s[..., :, 0] - s[..., :, 1]], dim=-1
    )


def _mf(qp: int, device) -> torch.Tensor:
    return tables.get("mf", device)[qp % 6]


def quant4x4(w: torch.Tensor, qp: int, intra: bool = True) -> torch.Tensor:
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    z = (w.abs() * _mf(qp, w.device) + f) >> qbits
    return torch.sign(w) * z


def quant_luma_dc(wdc: torch.Tensor, qp: int) -> torch.Tensor:
    qbits = 15 + qp // 6
    f = (1 << qbits) // 3
    mf0 = int(MF_TABLE[qp % 6, 0, 0])
    z = (wdc.abs() * mf0 + (f << 2)) >> (qbits + 2)
    return torch.sign(wdc) * z


def quant_chroma_dc(wdc: torch.Tensor, qp: int,
                    intra: bool = True) -> torch.Tensor:
    qbits = 15 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    mf0 = int(MF_TABLE[qp % 6, 0, 0])
    z = (wdc.abs() * mf0 + (f << 1)) >> (qbits + 1)
    return torch.sign(wdc) * z


def dequant_luma_dc(z: torch.Tensor, qp: int) -> torch.Tensor:
    f = hadamard4x4(z)
    v0 = int(V_TABLE[qp % 6, 0, 0])
    if qp >= 12:
        return (f * v0) << (qp // 6 - 2)
    shift_dn = 2 - qp // 6
    return (f * v0 + (1 << (shift_dn - 1))) >> shift_dn


def dequant_chroma_dc(z: torch.Tensor, qp: int) -> torch.Tensor:
    f = hadamard2x2(z)
    v0 = int(V_TABLE[qp % 6, 0, 0])
    return ((f * v0) << (qp // 6)) >> 1


def inverse4x4(d: torch.Tensor) -> torch.Tensor:
    """Normative inverse transform (8.5.12.2): rows first, then columns."""
    d = d.to(torch.int32)
    e0 = d[..., :, 0] + d[..., :, 2]
    e1 = d[..., :, 0] - d[..., :, 2]
    e2 = (d[..., :, 1] >> 1) - d[..., :, 3]
    e3 = d[..., :, 1] + (d[..., :, 3] >> 1)
    f = torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], dim=-1)
    g0 = f[..., 0, :] + f[..., 2, :]
    g1 = f[..., 0, :] - f[..., 2, :]
    g2 = (f[..., 1, :] >> 1) - f[..., 3, :]
    g3 = f[..., 1, :] + (f[..., 3, :] >> 1)
    return torch.stack([g0 + g3, g1 + g2, g1 - g2, g0 - g3], dim=-2)


def idct_add(pred: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    r = (inverse4x4(d) + 32) >> 6
    return torch.clamp(pred.to(torch.int32) + r, 0, 255)


def zigzag(block: torch.Tensor) -> torch.Tensor:
    """[..., 4, 4] raster -> [..., 16] zigzag order."""
    flat = block.reshape(*block.shape[:-2], 16)
    return flat[..., tables.get("zz", flat.device)]


def zigzag_flat(flat: torch.Tensor) -> torch.Tensor:
    """[..., 16] raster -> [..., 16] zigzag order."""
    return flat[..., tables.get("zz", flat.device)]


def inverse_zigzag(coeffs: torch.Tensor) -> torch.Tensor:
    """[..., 16] zigzag order -> [..., 4, 4] raster."""
    out = coeffs[..., tables.get("inv_zz", coeffs.device)]
    return out.reshape(*coeffs.shape[:-1], 4, 4)


def dequant_flat(z_flat: torch.Tensor, qp: int) -> torch.Tensor:
    """Dequant on raster-flat [..., 16] coefficient vectors."""
    return (z_flat * tables.get("v_flat", z_flat.device)[qp % 6]) << (qp // 6)


def chroma_qp_from_luma(qp: int, offset: int = 0) -> int:
    """Chroma QP (H.264 Table 8-15)."""
    return int(CHROMA_QP_TABLE[min(max(qp + offset, 0), 51)])
