"""H.264 8x8 integer transform / quant in PyTorch (int32, any device).

Port of tpuh264/kernels/transform8.py, bit-exact with it and with the
numpy oracle golden/transform8.py (whose tables it takes).  Butterflies
and gathers only: no integer matmul, which CUDA tensors lack.  Every
intermediate fits int32 for encoder-produced levels (|W| <= 16320, max
MF 20972 -> |W*MF| < 2^29).  Batched over arbitrary leading axes; `qp`
is a Python int, as in transform.py.
"""

from __future__ import annotations

import numpy as np
import torch

from ..golden.transform8 import INV_ZIGZAG8, MF8_TABLE, V8_TABLE, ZIGZAG8
from . import tables

I32 = torch.int32

tables.register("mf8", lambda: MF8_TABLE.astype(np.int32))   # [6, 8, 8]
tables.register("v8", lambda: V8_TABLE.astype(np.int32))     # [6, 8, 8]
tables.register("zz8", lambda: np.asarray(ZIGZAG8, np.int64))
tables.register("inv_zz8", lambda: np.asarray(INV_ZIGZAG8, np.int64))


def _fwd_stage(s: torch.Tensor) -> torch.Tensor:
    """One 1-D forward pass along the last axis."""
    x = s.unbind(-1)
    s07, d07 = x[0] + x[7], x[0] - x[7]
    s16, d16 = x[1] + x[6], x[1] - x[6]
    s25, d25 = x[2] + x[5], x[2] - x[5]
    s34, d34 = x[3] + x[4], x[3] - x[4]
    a0, a1 = s07 + s34, s16 + s25
    a2, a3 = s07 - s34, s16 - s25
    a4 = d16 + d25 + (d07 + (d07 >> 1))
    a5 = d07 - d34 - (d25 + (d25 >> 1))
    a6 = d07 + d34 - (d16 + (d16 >> 1))
    a7 = d16 - d25 + (d34 + (d34 >> 1))
    return torch.stack(
        [a0 + a1, a4 + (a7 >> 2), a2 + (a3 >> 1), a5 + (a6 >> 2),
         a0 - a1, a6 - (a5 >> 2), (a2 >> 1) - a3, (a4 >> 2) - a7], dim=-1)


def forward8x8(resid: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] residual -> coefficients in the normative layout."""
    w = _fwd_stage(resid.to(I32))
    w = _fwd_stage(w.transpose(-1, -2)).transpose(-1, -2)
    return w.transpose(-1, -2)


def _inv_stage(s: torch.Tensor) -> torch.Tensor:
    """One 1-D inverse pass along the last axis (8.5.13)."""
    x = s.unbind(-1)
    a0, a4 = x[0] + x[4], x[0] - x[4]
    a2 = (x[2] >> 1) - x[6]
    a6 = x[2] + (x[6] >> 1)
    b0, b2, b4, b6 = a0 + a6, a4 + a2, a4 - a2, a0 - a6
    a1 = -x[3] + x[5] - x[7] - (x[7] >> 1)
    a3 = x[1] + x[7] - x[3] - (x[3] >> 1)
    a5 = -x[1] + x[7] + x[5] + (x[5] >> 1)
    a7 = x[3] + x[5] + x[1] + (x[1] >> 1)
    b1, b7 = a1 + (a7 >> 2), a7 - (a1 >> 2)
    b3, b5 = a3 + (a5 >> 2), (a3 >> 2) - a5
    return torch.stack(
        [b0 + b7, b2 + b5, b4 + b3, b6 + b1,
         b6 - b1, b4 - b3, b2 - b5, b0 - b7], dim=-1)


def inverse8x8(d: torch.Tensor) -> torch.Tensor:
    """Normative inverse of [..., 8, 8] scaled coefficients."""
    e = _inv_stage(d.transpose(-1, -2).to(I32))
    return _inv_stage(e.transpose(-1, -2)).transpose(-1, -2)


def quant8x8(w: torch.Tensor, qp: int, intra: bool = False) -> torch.Tensor:
    qbits = 16 + qp // 6
    f = (1 << qbits) // (3 if intra else 6)
    mf = tables.get("mf8", w.device)[qp % 6]
    return torch.sign(w) * ((w.abs() * mf + f) >> qbits)


def dequant8x8(z: torch.Tensor, qp: int) -> torch.Tensor:
    zv = z.to(I32) * tables.get("v8", z.device)[qp % 6]
    if qp >= 12:
        return zv << (qp // 6 - 2)
    shift_dn = 2 - qp // 6
    return (zv + (1 << (shift_dn - 1))) >> shift_dn


def idct8_add(pred: torch.Tensor, d: torch.Tensor) -> torch.Tensor:
    r = (inverse8x8(d) + 32) >> 6
    return torch.clamp(pred.to(I32) + r, 0, 255)


def zigzag8(block: torch.Tensor) -> torch.Tensor:
    """[..., 8, 8] raster -> [..., 64] zigzag (frame) order."""
    flat = block.reshape(*block.shape[:-2], 64)
    return flat[..., tables.get("zz8", flat.device)]


def inverse_zigzag8(coeffs: torch.Tensor) -> torch.Tensor:
    """[..., 64] zigzag order -> [..., 8, 8] raster."""
    out = coeffs[..., tables.get("inv_zz8", coeffs.device)]
    return out.reshape(*coeffs.shape[:-1], 8, 8)
