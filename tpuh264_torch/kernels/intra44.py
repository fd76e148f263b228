"""Intra_4x4 luma prediction and the causal in-MB scan (H.264 8.3.1), in
PyTorch.

Port of tpuh264/kernels/intra44.py (plain XLA there, outside any Pallas
kernel), specialised like it to the row-slice layout of iframe.py: the
MB row above is another slice, so only in-MB top neighbours exist
(blocks with by > 0) and the one cross-MB dependency is the left column,
which the iframe column loop carries.

All nine modes are affine forms over the 13 neighbour samples n = [L0..3,
X, T0..3, TR0..3]: pred = (W . n + R) >> S with per-(mode, pixel)
integer tables, built once by `_build_tables` (a copy of the JAX
module's numpy builder).  The JAX version contracts n with W in an int32
einsum; integer matmul is not implemented for CUDA tensors in PyTorch
(it is on the CPU, so CPU tests would not show it), so here it is a
broadcast multiply and an int32 sum over the 13 neighbours, exact on
every device.  DC (availability-dependent) goes into mode slot 2 with a
one-hot mask.  The 16-block z-scan is unrolled in Python.

Mode decision matches the golden encoder: SAD over the available modes,
the lowest mode index on ties (`argmin_first`, never a backend's
argmin).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from . import tables
from . import transform as T

I32 = torch.int32

# luma4x4BlkIdx scan order as (bx, by) -- must match the CAVLC packer
BLK_SCAN = [
    (0, 0), (1, 0), (0, 1), (1, 1),
    (2, 0), (3, 0), (2, 1), (3, 1),
    (0, 2), (1, 2), (0, 3), (1, 3),
    (2, 2), (3, 2), (2, 3), (3, 3),
]

# neighbour vector layout: [L0..3, X, T0..3, TR0..3]
_IL = list(range(0, 4))
_IX = 4
_IT = list(range(5, 9))
_ITR = list(range(9, 13))


def _build_tables() -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(W [9,16,13], R [9,16], S [9,16]) int32 tables; the mode-2 row is
    zero (DC is availability-dependent and handled separately).  Copy of
    tpuh264/kernels/intra44.py `_build_tables`."""
    W = np.zeros((9, 16, 13), np.int64)
    R = np.zeros((9, 16), np.int64)
    S = np.zeros((9, 16), np.int64)

    def t(k):  # T/TR joint index, k in 0..7
        return _IT[k] if k < 4 else _ITR[k - 4]

    def tq(k):  # p[k,-1] with k >= -1
        return t(k) if k >= 0 else _IX

    def lq(k):  # p[-1,k] with k >= -1
        return _IL[k] if k >= 0 else _IX

    for yy in range(4):
        for xx in range(4):
            p = 4 * yy + xx
            # mode 0: Vertical
            W[0, p, _IT[xx]] = 1
            # mode 1: Horizontal
            W[1, p, _IL[yy]] = 1
            # mode 3: Diagonal down-left (8.3.1.2.4)
            i = xx + yy
            if i == 6:
                W[3, p, t(6)] += 1
                W[3, p, t(7)] += 3
            else:
                W[3, p, t(i)] += 1
                W[3, p, t(i + 1)] += 2
                W[3, p, t(i + 2)] += 1
            R[3, p], S[3, p] = 2, 2
            # mode 4: Diagonal down-right (8.3.1.2.5)
            if xx > yy:
                d = xx - yy
                for k, c in ((d - 2, 1), (d - 1, 2), (d, 1)):
                    W[4, p, tq(k)] += c
            elif xx < yy:
                d = yy - xx
                for k, c in ((d - 2, 1), (d - 1, 2), (d, 1)):
                    W[4, p, lq(k)] += c
            else:
                W[4, p, tq(0)] += 1
                W[4, p, _IX] += 2
                W[4, p, lq(0)] += 1
            R[4, p], S[4, p] = 2, 2
            # mode 5: Vertical-right (8.3.1.2.6)
            z = 2 * xx - yy
            k = xx - (yy >> 1)
            if z >= 0 and z % 2 == 0:
                W[5, p, tq(k - 1)] += 1
                W[5, p, tq(k)] += 1
                R[5, p], S[5, p] = 1, 1
            elif z >= 0:
                W[5, p, tq(k - 2)] += 1
                W[5, p, tq(k - 1)] += 2
                W[5, p, tq(k)] += 1
                R[5, p], S[5, p] = 2, 2
            elif z == -1:
                W[5, p, lq(0)] += 1
                W[5, p, _IX] += 2
                W[5, p, tq(0)] += 1
                R[5, p], S[5, p] = 2, 2
            else:
                W[5, p, lq(yy - 1)] += 1
                W[5, p, lq(yy - 2)] += 2
                W[5, p, lq(yy - 3)] += 1
                R[5, p], S[5, p] = 2, 2
            # mode 6: Horizontal-down (8.3.1.2.7)
            z = 2 * yy - xx
            k = yy - (xx >> 1)
            if z >= 0 and z % 2 == 0:
                W[6, p, lq(k - 1)] += 1
                W[6, p, lq(k)] += 1
                R[6, p], S[6, p] = 1, 1
            elif z >= 0:
                W[6, p, lq(k - 2)] += 1
                W[6, p, lq(k - 1)] += 2
                W[6, p, lq(k)] += 1
                R[6, p], S[6, p] = 2, 2
            elif z == -1:
                W[6, p, tq(0)] += 1
                W[6, p, _IX] += 2
                W[6, p, lq(0)] += 1
                R[6, p], S[6, p] = 2, 2
            else:
                W[6, p, tq(xx - 1)] += 1
                W[6, p, tq(xx - 2)] += 2
                W[6, p, tq(xx - 3)] += 1
                R[6, p], S[6, p] = 2, 2
            # mode 7: Vertical-left (8.3.1.2.8)
            i = xx + (yy >> 1)
            if yy % 2 == 0:
                W[7, p, t(i)] += 1
                W[7, p, t(i + 1)] += 1
                R[7, p], S[7, p] = 1, 1
            else:
                W[7, p, t(i)] += 1
                W[7, p, t(i + 1)] += 2
                W[7, p, t(i + 2)] += 1
                R[7, p], S[7, p] = 2, 2
            # mode 8: Horizontal-up (8.3.1.2.9)
            z = xx + 2 * yy
            if z % 2 == 0 and z <= 4:
                i = yy + (xx >> 1)
                W[8, p, _IL[i]] += 1
                W[8, p, _IL[i + 1]] += 1
                R[8, p], S[8, p] = 1, 1
            elif z <= 3:
                i = yy + (xx >> 1)
                W[8, p, _IL[i]] += 1
                W[8, p, _IL[i + 1]] += 2
                W[8, p, _IL[i + 2]] += 1
                R[8, p], S[8, p] = 2, 2
            elif z == 5:
                W[8, p, _IL[2]] += 1
                W[8, p, _IL[3]] += 3
                R[8, p], S[8, p] = 2, 2
            else:
                W[8, p, _IL[3]] += 1
    return W.astype(np.int32), R.astype(np.int32), S.astype(np.int32)


_W_NP, _R_NP, _S_NP = _build_tables()
tables.register("i44_w", lambda: _W_NP)
tables.register("i44_r", lambda: _R_NP)
tables.register("i44_s", lambda: _S_NP)
tables.register("i44_dc", lambda: (np.arange(9) == 2).astype(np.int32)[:, None])


def tap_words() -> np.ndarray:
    """W, R and S as the kernels read them (csrc/intra44_common.cuh): one
    word a (mode, pixel), int32 [9 * 16]; its at most three nonzero taps'
    neighbour indices in bits 0-3, 4-7, 8-11, their weights in 12-13,
    14-15, 16-17, then R in 18-19 and S in 20-21.  Mode 2 (DC) is zero."""
    words = np.zeros((9, 16), np.int64)
    for m in range(9):
        for p in range(16):
            taps = np.flatnonzero(_W_NP[m, p])
            assert len(taps) <= 3 and _W_NP[m, p].max(initial=0) <= 3
            assert 0 <= _R_NP[m, p] <= 3 and 0 <= _S_NP[m, p] <= 3
            for j, k in enumerate(taps):
                words[m, p] |= (int(k) << (4 * j)
                                | int(_W_NP[m, p, k]) << (12 + 2 * j))
            words[m, p] |= int(_R_NP[m, p]) << 18 | int(_S_NP[m, p]) << 20
    return words.reshape(-1).astype(np.int32)


tables.register("i44_taps", tap_words)


def argmin_first(x: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis (< 16 entries, values < 2^40), the first
    index on ties, on any device."""
    key = x.long() * 16 + torch.arange(x.shape[-1], device=x.device)
    return torch.remainder(key.amin(-1), 16)


def pred_directional(n: torch.Tensor) -> torch.Tensor:
    """All directional modes at once: n [..., 13] int -> int32 [..., 9, 16].
    The mode-2 slot is zero (filled by the caller from pred_dc)."""
    dev = n.device
    acc = (n.to(I32)[..., None, None, :]
           * tables.get("i44_w", dev)).sum(-1, dtype=I32)
    return (acc + tables.get("i44_r", dev)) >> tables.get("i44_s", dev)


def pred_dc(L: torch.Tensor, Tv: torch.Tensor, l_ok: torch.Tensor,
            t_ok: bool) -> torch.Tensor:
    """DC prediction value [...]; L / Tv [..., 4]; l_ok bool [...]; t_ok a
    Python bool (static per block in row-slice mode)."""
    sl = L.sum(-1, dtype=I32)
    if t_ok:
        st = Tv.sum(-1, dtype=I32)
        return torch.where(l_ok, (st + sl + 4) >> 3, (st + 2) >> 2)
    return torch.where(l_ok, (sl + 2) >> 2, 128)


def merge_dc(preds: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """Insert the DC value into mode slot 2 of [..., 9, 16]."""
    onehot = tables.get("i44_dc", preds.device)
    return preds * (1 - onehot) + dc[..., None, None] * onehot


def _static_tr_kind(bi: int) -> str:
    """Top-right availability in rows-slice mode, static per z-scan index:
    'real' (in-MB samples), 'repl' (T[3] replicated) or 'none' (by == 0)."""
    bx, by = BLK_SCAN[bi]
    if by == 0:
        return "none"
    if bx == 3:
        return "repl"  # the top-right MB is on this row: later in raster
    nb = BLK_SCAN.index((bx + 1, by - 1))
    return "real" if nb < bi else "repl"


def _avail9(l_ok: torch.Tensor, t_ok: bool) -> torch.Tensor:
    """[..., 9] bool availability of the nine modes."""
    one = torch.ones_like(l_ok)
    top = one if t_ok else torch.zeros_like(l_ok)
    both = l_ok if t_ok else top
    return torch.stack([top, l_ok, one, top, both, both, both, top, l_ok],
                       dim=-1)


def _gather_neighbors(cur, leftcol, l_ok_mb, bi: int):
    """Neighbour vector n [..., 13], L, Tv and (l_ok, t_ok) of block bi.

    cur: [..., 16, 16] partial MB reconstruction (int32); leftcol:
    [..., 16] right column of the left MB; l_ok_mb: [...] bool."""
    bx, by = BLK_SCAN[bi]
    if bx > 0:
        L = cur[..., 4 * by:4 * by + 4, 4 * bx - 1]
        l_ok = torch.ones_like(l_ok_mb)
    else:
        L = leftcol[..., 4 * by:4 * by + 4]
        l_ok = l_ok_mb
    t_ok = by > 0
    if t_ok:
        Tv = cur[..., 4 * by - 1, 4 * bx:4 * bx + 4]
        if _static_tr_kind(bi) == "real":
            TR = cur[..., 4 * by - 1, 4 * bx + 4:4 * bx + 8]
        else:
            TR = Tv[..., 3:4].expand(Tv.shape)
        X = (cur[..., 4 * by - 1, 4 * bx - 1] if bx > 0
             else leftcol[..., 4 * by - 1])
    else:
        Tv = torch.zeros_like(L)
        TR = Tv
        X = torch.zeros(L.shape[:-1], dtype=I32, device=L.device)
    n = torch.cat([L, X[..., None], Tv, TR], dim=-1)
    return n, L, Tv, l_ok, t_ok


def _select(preds: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """The prediction of mode m [...] from preds [..., 9, 16] -> [..., 4, 4]
    (m -1, an Intra_16x16 MB's i4modes entry, reads mode 0: the caller
    discards those MBs)."""
    m = m.long().clamp(0, 8)
    pick = preds.gather(-2, m[..., None, None].expand(*m.shape, 1, 16))
    return pick[..., 0, :].reshape(*m.shape, 4, 4)


def encode_mb(src_mb, leftcol, l_ok_mb, qp: int):
    """Causal I4x4 trial over one MB batch (encode side).

    src_mb [..., 16, 16] int32; leftcol [..., 16] int32; l_ok_mb [...]
    bool.  Returns (sad [...], modes [..., 16] z-scan, coeffs [..., 16,
    16] raster blocks x zigzag (int32), cbp [...] 4-bit, rec [..., 16, 16]
    int32), as tpuh264.kernels.intra44.encode_mb."""
    lead = src_mb.shape[:-2]
    dev = src_mb.device
    cur = torch.zeros(src_mb.shape, dtype=I32, device=dev)
    sad = torch.zeros(lead, dtype=I32, device=dev)
    maxi = torch.iinfo(torch.int32).max
    modes = [None] * 16
    coeffs = [None] * 16  # raster index 4*by+bx
    nz = [None] * 16      # per z-scan block: any nonzero coefficient
    for bi, (bx, by) in enumerate(BLK_SCAN):
        n, L, Tv, l_ok, t_ok = _gather_neighbors(cur, leftcol, l_ok_mb, bi)
        preds = merge_dc(pred_directional(n), pred_dc(L, Tv, l_ok, t_ok))
        src = src_mb[..., 4 * by:4 * by + 4, 4 * bx:4 * bx + 4].to(I32)
        cost = (src.reshape(*lead, 1, 16) - preds).abs().sum(-1, dtype=I32)
        cost = torch.where(_avail9(l_ok, t_ok), cost, maxi)
        m = argmin_first(cost)
        sad = sad + cost.gather(-1, m[..., None])[..., 0]
        pred = _select(preds, m)
        q = T.quant4x4(T.forward4x4(src - pred), qp, intra=True)
        zz = T.zigzag(q)
        rec = T.idct_add(pred, T.dequant_flat(q.reshape(*lead, 16), qp)
                         .reshape(*lead, 4, 4))
        cur[..., 4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = rec
        modes[bi] = m.to(I32)
        coeffs[4 * by + bx] = zz
        nz[bi] = (zz != 0).any(-1)
    cbp = torch.zeros(lead, dtype=I32, device=dev)
    for i8 in range(4):
        bit = nz[4 * i8] | nz[4 * i8 + 1] | nz[4 * i8 + 2] | nz[4 * i8 + 3]
        cbp = cbp | (bit.to(I32) << i8)
    return (sad, torch.stack(modes, dim=-1), torch.stack(coeffs, dim=-2),
            cbp, cur)


def decode_mb(coeffs, modes, leftcol, l_ok_mb, qp: int):
    """Causal I4x4 reconstruction from parsed symbols (decode side).

    coeffs [..., 16, 16] raster blocks x zigzag; modes [..., 16] z-scan;
    leftcol [..., 16]; l_ok_mb [...] bool.  Returns rec [..., 16, 16]
    int32, as tpuh264.kernels.intra44.decode_mb."""
    lead = modes.shape[:-1]
    dev = modes.device
    cur = torch.zeros((*lead, 16, 16), dtype=I32, device=dev)
    for bi, (bx, by) in enumerate(BLK_SCAN):
        n, L, Tv, l_ok, t_ok = _gather_neighbors(cur, leftcol, l_ok_mb, bi)
        preds = merge_dc(pred_directional(n), pred_dc(L, Tv, l_ok, t_ok))
        pred = _select(preds, modes[..., bi])
        zz = coeffs[..., 4 * by + bx, :].to(I32)
        d = T.dequant_flat(T.inverse_zigzag(zz).reshape(*lead, 16), qp)
        cur[..., 4 * by:4 * by + 4, 4 * bx:4 * bx + 4] = T.idct_add(
            pred, d.reshape(*lead, 4, 4))
    return cur
