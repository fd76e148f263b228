"""Single-slice I frames in PyTorch: the anti-diagonal wavefront scan.

Port of tpuh264/kernels/wavefront.py (plain XLA there, outside any
Pallas kernel).  A single-slice stream predicts across MB rows (the V
and Plane Intra_16x16 modes, top neighbours everywhere), so MB (r, c)
depends on (r, c-1), (r-1, c) and (r-1, c-1).

On the card each direction is one kernel launch a frame: the encode
`encode_iframe_single` is K7 and the reconstruction
`decode_iframe_single` K8 (csrc/wavefront.cu: a thread-block cluster per
stream, a team of warps per MB row walking it left to right, each row
handing its MBs' bottom samples down to the next through shared memory).
CUDA tensors launch them or raise; CPU tensors take the plain versions
`_encode_iframe_single_plain` / `_decode_iframe_single_plain`, which
follow the JAX scan's waves.

The plain versions order the MBs by wave w = 2r + c: every dependency
is strictly earlier, so 2(R-1) + C waves cover the frame, each batched
over streams and the rows it reaches.  Their carried state is the
dependency frontier: per column the bottom row of its last reconstructed
MB (top neighbours), per row the right column of its last MB (left
neighbours), and per column the saved corner p[-1,-1] (the frontier
entry before the row below overwrote it).

The JAX scan advances every row lane each wave and sends the lanes
outside the frame to a dump column C of its C+1-wide frontier
(`mode="drop"`).  Here a wave processes only the rows it reaches, a
contiguous range: their columns w - 2r are distinct, so every frontier
and output write of a wave lands on its own index, with no dump column
(duplicate indices in one `index_put_` would be nondeterministic on
CUDA).  Outputs are written in place at (row, column), so no wave-to-
raster gather is needed.

The plain decode reuses iframe.py's batched residuals: only the
prediction follows the waves.  K8 takes the parsed levels and decodes the
residuals itself, off its chain.  Bit-exact
with the JAX version (tests/test_torch_wavefront.py); mode decision
order mirrors the golden encoder (luma DC, V, H, Plane; chroma DC, H, V,
Plane; the first strict minimum wins).
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import cuda_lib
from . import transform as T
from .iframe import (
    MBSymbols,
    _blocks_to_mb,
    _cblocks_to_mb,
    _chroma_blocks,
    _chroma_cbp,
    _encode_chroma,
    _encode_luma,
    _intra_residuals,
    _luma_blocks,
    _recon_chroma,
)
from .intra44 import argmin_first

I32 = torch.int32
_BIG = torch.iinfo(torch.int32).max


def _plane_pred(top, left, corner, n: int, scale: int) -> torch.Tensor:
    """Plane prediction (8.3.3.4 / 8.3.4.4): top/left [..., n], corner
    [...]; n = 16 luma (scale 5) or 8 chroma (scale 34)."""
    half = n // 2
    px = torch.cat([corner[..., None], top], dim=-1)  # index x + 1
    py = torch.cat([corner[..., None], left], dim=-1)
    h = sum((x + 1) * (px[..., half + x + 1] - px[..., half - 1 - x])
            for x in range(half))
    v = sum((x + 1) * (py[..., half + x + 1] - py[..., half - 1 - x])
            for x in range(half))
    a = 16 * (top[..., n - 1] + left[..., n - 1])
    b = (scale * h + 32) >> 6
    c = (scale * v + 32) >> 6
    k = torch.arange(n, dtype=I32, device=top.device) - (half - 1)
    out = (a[..., None, None] + b[..., None, None] * k
           + c[..., None, None] * k[:, None] + 16) >> 5
    return torch.clamp(out, 0, 255)


def _luma_preds(top, left, corner, t_av, l_av):
    """(V, H, DC, Plane) Intra_16x16 predictions [..., 16, 16]."""
    shape = (*top.shape[:-1], 16, 16)
    pv = top[..., None, :].expand(shape)
    ph = left[..., :, None].expand(shape)
    st, sl = top.sum(-1, dtype=I32), left.sum(-1, dtype=I32)
    dc = torch.where(t_av & l_av, (st + sl + 16) >> 5,
                     torch.where(t_av, (st + 8) >> 4,
                                 torch.where(l_av, (sl + 8) >> 4, 128)))
    pdc = dc[..., None, None].expand(shape)
    return pv, ph, pdc, _plane_pred(top, left, corner, 16, 5)


def _chroma_dc_pred(top, left, t_av, l_av) -> torch.Tensor:
    """Per-quadrant chroma DC (8.3.4.1) [..., 8, 8]; top/left [..., 8]."""
    ts = top.reshape(*top.shape[:-1], 2, 4).sum(-1, dtype=I32)  # per bx
    ls = left.reshape(*left.shape[:-1], 2, 4).sum(-1, dtype=I32)  # per by
    w = torch.where

    def corner_dc(t, l):  # blocks (0,0), (1,1)
        return w(t_av & l_av, (t + l + 4) >> 3,
                 w(t_av, (t + 2) >> 2, w(l_av, (l + 2) >> 2, 128)))

    def top_pref(t, l):  # block (1,0)
        return w(t_av, (t + 2) >> 2, w(l_av, (l + 2) >> 2, 128))

    def left_pref(t, l):  # block (0,1)
        return w(l_av, (l + 2) >> 2, w(t_av, (t + 2) >> 2, 128))

    q = torch.stack([
        torch.stack([corner_dc(ts[..., 0], ls[..., 0]),
                     top_pref(ts[..., 1], ls[..., 0])], -1),
        torch.stack([left_pref(ts[..., 0], ls[..., 1]),
                     corner_dc(ts[..., 1], ls[..., 1])], -1)], -2)
    return q.repeat_interleave(4, -2).repeat_interleave(4, -1)


def _chroma_preds(top, left, corner, t_av, l_av):
    """Chroma predictions by mode number (DC, H, V, Plane) [..., 8, 8]."""
    shape = (*top.shape[:-1], 8, 8)
    return (_chroma_dc_pred(top, left, t_av, l_av),
            left[..., :, None].expand(shape), top[..., None, :].expand(shape),
            _plane_pred(top, left, corner, 8, 34))


def _take(preds, idx) -> torch.Tensor:
    """preds [..., M, n, n] at idx [...] -> [..., n, n]."""
    n = preds.shape[-1]
    return preds.gather(-3, idx.long()[..., None, None, None].expand(
        *idx.shape, 1, n, n))[..., 0, :, :]


class _Frontier:
    """The wavefront's carried state for S streams over an R x C MB grid:
    per column the bottom sample row of its last MB (`top`) and the
    saved corner (`corner`), per row the right column of its last MB
    (`left`); luma, Cb, Cr each."""

    def __init__(self, s: int, r: int, c: int, device):
        z = lambda *sh: torch.zeros(sh, dtype=I32, device=device)
        self.top = [z(s, c, 16), z(s, c, 8), z(s, c, 8)]
        self.corner = [z(s, c), z(s, c), z(s, c)]
        self.left = [z(s, r, 16), z(s, r, 8), z(s, r, 8)]
        self.c = c

    def neighbours(self, rows, ci):
        """(top, left, corner) per plane of the MBs (rows, ci)."""
        cim1 = (ci - 1).clamp(0, self.c - 1)
        return [(t[:, ci], lf[:, rows], cn[:, cim1])
                for t, lf, cn in zip(self.top, self.left, self.corner)]

    def advance(self, rows, ci, nb, rec) -> None:
        """Record the reconstructed MBs `rec` (y [S,n,16,16], u/v [S,n,8,8])
        at (rows, ci); `nb` is what `neighbours` returned for them."""
        for i, (t_old, _, _) in enumerate(nb):
            n = rec[i].shape[-1]
            self.left[i][:, rows] = rec[i][..., :, n - 1]
            self.corner[i][:, ci] = t_old[..., n - 1]
            self.top[i][:, ci] = rec[i][..., n - 1, :]


def _waves(r: int, c: int, device):
    """Per wave w = 2r + c: the rows it reaches and their columns."""
    for w in range(2 * (r - 1) + c):
        r0, r1 = max(0, (w - c + 2) // 2), min(r - 1, w // 2)
        rows = torch.arange(r0, r1 + 1, device=device)
        yield rows, w - 2 * rows


def _avail(rows, ci, s: int):
    """(top available, left available) [S, n] of the MBs (rows, ci)."""
    return ((rows > 0).expand(s, -1), (ci > 0).expand(s, -1))


def encode_iframe_single(y, u, v, qp: int
                         ) -> Tuple[MBSymbols, Tuple[torch.Tensor, ...]]:
    """Encode [S, H, W] frames (u, v [S, H/2, W/2]) as single-slice I
    frames; the output contract of iframe.encode_iframe_scan, exactly as
    tpuh264.kernels.wavefront.encode_iframe_single.

    CPU tensors take the plain version; CUDA tensors launch K7
    (csrc/wavefront.cu) or raise: uint8 planes, or others taken as int32
    (the session's RGBA conversion gives int32 samples in 0..255)."""
    if y.device.type == "cpu":
        return _encode_iframe_single_plain(y, u, v, qp)
    out = _k7_launch(y, u, v, qp)
    encode_iframe_single.launches += 1
    return out


encode_iframe_single.launches = 0  # launches of K7


def _frame_shape(name: str, shape, qp: int):
    """(S, R, C) of luma frames of `shape` [S, H, W], whole MBs high and
    wide; raises on any other shape or a QP outside 0..51."""
    s, h, w = shape
    if not s * h * w or h % 16 or w % 16:
        raise ValueError(f"{name}: frames {tuple(shape)} are not whole MBs")
    if not 0 <= qp <= 51:
        raise ValueError(f"{name}: QP {qp} outside 0..51")
    return s, h // 16, w // 16


def _aligned(xs):
    """The tensors of `xs`, each at a 16-byte aligned address (the kernels'
    vector loads): a view at another offset is copied to fresh storage."""
    return [x if x.data_ptr() % 16 == 0 else x.clone() for x in xs]


def _k7_launch(y, u, v, qp: int):
    """One launch of K7 over source planes on the card (uint8 if all three
    are, else int32); raises on a bad input or a failed build or
    launch."""
    name = "encode_iframe_single"
    s, r, c = _frame_shape(name, y.shape, qp)
    dev = y.device
    u8 = all(p.dtype == torch.uint8 for p in (y, u, v))
    planes = [p.contiguous() if u8 else p.to(I32).contiguous()
              for p in (y, u, v)]
    shapes = [(s, 16 * r, 16 * c), (s, 8 * r, 8 * c), (s, 8 * r, 8 * c)]
    cuda_lib.check_inputs(name, dev, list(zip(planes, shapes)),
                          dtype=torch.uint8 if u8 else I32)
    planes = _aligned(planes)
    mb = (s, r, c)
    new = lambda sh, dt: torch.empty(sh, dtype=dt, device=dev)
    i16 = torch.int16
    sym = MBSymbols(mode=new(mb, I32), cmode=new(mb, I32),
                    cbp_luma=new(mb, I32), cbp_chroma=new(mb, I32),
                    luma_dc=new((*mb, 16), i16),
                    luma_ac=new((*mb, 16, 16), i16),
                    chroma_dc=new((*mb, 2, 4), i16),
                    chroma_ac=new((*mb, 2, 4, 15), i16),
                    i4modes=new((*mb, 16), i16))
    rec = tuple(new(sh, torch.uint8) for sh in shapes)
    lib = cuda_lib.load()
    ptr = lambda x: x.data_ptr()
    err = lib.th264_wavefront_encode(
        *map(ptr, planes), int(u8), *map(ptr, [*sym, *rec]), s, r, c, qp,
        T.chroma_qp_from_luma(qp), cuda_lib.stream(dev))
    cuda_lib.check(err, "th264_wavefront_encode")
    return sym, rec


def _encode_iframe_single_plain(y, u, v, qp: int
                                ) -> Tuple[MBSymbols,
                                           Tuple[torch.Tensor, ...]]:
    """Plain version of `encode_iframe_single` (same arguments): the waves
    2r + c in a Python loop, batched over streams and rows."""
    qpc = T.chroma_qp_from_luma(qp)
    s, hgt, wid = y.shape
    r, c = hgt // 16, wid // 16
    dev = y.device
    tiles = lambda p, n: p.to(I32).reshape(s, r, n, c, n).permute(
        0, 1, 3, 2, 4)
    y_t, u_t, v_t = tiles(y, 16), tiles(u, 8), tiles(v, 8)
    z = lambda dt, *sh: torch.zeros((s, r, c, *sh), dtype=dt, device=dev)
    i16 = torch.int16
    out = MBSymbols(mode=z(I32), cmode=z(I32), cbp_luma=z(I32),
                    cbp_chroma=z(I32), luma_dc=z(i16, 16),
                    luma_ac=z(i16, 16, 16), chroma_dc=z(i16, 2, 4),
                    chroma_ac=z(i16, 2, 4, 15),
                    i4modes=torch.full((s, r, c, 16), -1, dtype=i16,
                                       device=dev))
    rec_out = [z(torch.uint8, 16, 16), z(torch.uint8, 8, 8),
               z(torch.uint8, 8, 8)]
    luma_map = torch.tensor([2, 0, 1, 3], dtype=I32, device=dev)
    fr = _Frontier(s, r, c, dev)
    for rows, ci in _waves(r, c, dev):
        n = rows.shape[0]
        ymb, umb, vmb = y_t[:, rows, ci], u_t[:, rows, ci], v_t[:, rows, ci]
        t_av, l_av = _avail(rows, ci, s)
        nb = fr.neighbours(rows, ci)
        both = t_av & l_av

        # luma, golden order DC, V, H, Plane (mode numbers 2, 0, 1, 3)
        pv, ph, pdc, pp = _luma_preds(*nb[0], t_av, l_av)
        preds = torch.stack([pdc, pv, ph, pp], dim=-3)
        cost = (ymb[..., None, :, :] - preds).abs().sum((-1, -2), dtype=I32)
        avail = torch.stack([torch.ones_like(t_av), t_av, l_av, both], -1)
        idx = argmin_first(torch.where(avail, cost, _BIG))
        mode = luma_map[idx]
        dc_zz, ac_zz, cbp_luma, rec_y = _encode_luma(ymb, _take(preds, idx),
                                                     qp)

        # chroma, golden order DC, H, V, Plane (= mode numbers)
        pus = torch.stack(_chroma_preds(*nb[1], t_av, l_av), dim=-3)
        pvs = torch.stack(_chroma_preds(*nb[2], t_av, l_av), dim=-3)
        ccost = ((umb[..., None, :, :] - pus).abs().sum((-1, -2), dtype=I32)
                 + (vmb[..., None, :, :] - pvs).abs().sum((-1, -2),
                                                          dtype=I32))
        cavail = torch.stack([torch.ones_like(t_av), l_av, t_av, both], -1)
        cmode = argmin_first(torch.where(cavail, ccost, _BIG))
        predu, predv = _take(pus, cmode), _take(pvs, cmode)
        dcu, acu, qu = _encode_chroma(umb, predu, qpc)
        dcv, acv, qv = _encode_chroma(vmb, predv, qpc)
        cbp_chroma = _chroma_cbp(dcu, acu, dcv, acv)
        rec = (rec_y, _recon_chroma(predu, dcu, qu, cbp_chroma, qpc),
               _recon_chroma(predv, dcv, qv, cbp_chroma, qpc))
        fr.advance(rows, ci, nb, rec)

        at = (slice(None), rows, ci)
        out.mode[at] = mode
        out.cmode[at] = cmode.to(I32)
        out.cbp_luma[at] = cbp_luma.to(I32)
        out.cbp_chroma[at] = cbp_chroma
        out.luma_dc[at] = dc_zz.to(i16)
        out.luma_ac[at] = ac_zz.reshape(s, n, 16, 16).to(i16)
        out.chroma_dc[at] = torch.stack(
            [dcu.reshape(s, n, 4), dcv.reshape(s, n, 4)], -2).to(i16)
        out.chroma_ac[at] = torch.stack(
            [acu.reshape(s, n, 4, 15), acv.reshape(s, n, 4, 15)], -3).to(i16)
        for o, x in zip(rec_out, rec):
            o[at] = x.to(torch.uint8)
    return out, tuple(_plane(x) for x in rec_out)


def _plane(tiles: torch.Tensor) -> torch.Tensor:
    """[S, R, C, n, n] -> [S, R*n, C*n]."""
    s, r, c, n, _ = tiles.shape
    return tiles.permute(0, 1, 3, 2, 4).reshape(s, r * n, c * n)


def decode_iframe_single(symbols: MBSymbols, qp: int
                         ) -> Tuple[torch.Tensor, ...]:
    """Wavefront reconstruction of single-slice I frames from parsed
    symbols -> uint8 (y, u, v), exactly as
    tpuh264.kernels.wavefront.decode_iframe_single.

    CPU tensors take the plain version; on the card K8
    (csrc/wavefront.cu) decodes the residuals from the levels, predicts,
    sums and clips in one launch, or the call raises."""
    if symbols.mode.device.type == "cpu":
        return _decode_iframe_single_plain(symbols, qp)
    rec = _k8_launch(symbols, qp)
    decode_iframe_single.launches += 1
    return rec


decode_iframe_single.launches = 0  # launches of K8


def _k8_launch(symbols: MBSymbols, qp: int):
    """One launch of K8 on the card: int32 mode, cmode, cbp_luma,
    cbp_chroma [S, R, C] and the int16 levels as MBSymbols holds them ->
    uint8 planes; raises on a bad input or a failed build or launch."""
    name = "decode_iframe_single"
    s, r, c = symbols.mode.shape
    _frame_shape(name, (s, 16 * r, 16 * c), qp)
    dev = symbols.mode.device
    mb = (s, r, c)
    flags = [x.to(I32).contiguous() for x in (
        symbols.mode, symbols.cmode, symbols.cbp_luma, symbols.cbp_chroma)]
    levels = [x.contiguous() for x in (symbols.luma_dc, symbols.luma_ac,
                                       symbols.chroma_dc, symbols.chroma_ac)]
    cuda_lib.check_inputs(name, dev, [(x, mb) for x in flags])
    cuda_lib.check_inputs(name, dev, list(zip(levels, [
        (*mb, 16), (*mb, 16, 16), (*mb, 2, 4), (*mb, 2, 4, 15)])),
        dtype=torch.int16)
    flags, levels = _aligned(flags), _aligned(levels)
    rec = tuple(torch.empty(sh, dtype=torch.uint8, device=dev)
                for sh in ((s, 16 * r, 16 * c), (s, 8 * r, 8 * c),
                           (s, 8 * r, 8 * c)))
    ptr = lambda x: x.data_ptr()
    err = cuda_lib.load().th264_wavefront_decode(
        *map(ptr, [*flags, *levels, *rec]), s, r, c, qp,
        T.chroma_qp_from_luma(qp), cuda_lib.stream(dev))
    cuda_lib.check(err, "th264_wavefront_decode")
    return rec


def launch_plan(r: int, c: int):
    """K7's and K8's launch shapes for R x C MBs a stream on the card (the
    kernel library chooses them): ((cluster size, MB rows a CTA, teams a
    CTA, shared memory a CTA in bytes) of K7, the same of K8)."""
    out = (ctypes.c_int * 8)()
    lib = cuda_lib.load()
    cuda_lib.check(lib.th264_wavefront_plan(r, c, out),
                   "th264_wavefront_plan")
    return tuple(out[:4]), tuple(out[4:])


def _decode_iframe_single_plain(symbols: MBSymbols, qp: int
                                ) -> Tuple[torch.Tensor, ...]:
    """Plain version of `decode_iframe_single` (same arguments): the waves
    2r + c in a Python loop, the residuals batched."""
    qpc = T.chroma_qp_from_luma(qp)
    s, r, c = symbols.mode.shape
    dev = symbols.mode.device
    res = _intra_residuals(symbols, qp, qpc)  # prediction-independent
    mode, cmode = symbols.mode.to(I32), symbols.cmode.to(I32)
    rec_out = [torch.zeros((s, r, c, n, n), dtype=torch.uint8, device=dev)
               for n in (16, 8, 8)]
    fr = _Frontier(s, r, c, dev)
    for rows, ci in _waves(r, c, dev):
        t_av, l_av = _avail(rows, ci, s)
        nb = fr.neighbours(rows, ci)
        pred = _take(torch.stack(_luma_preds(*nb[0], t_av, l_av), dim=-3),
                     mode[:, rows, ci])
        cm = cmode[:, rows, ci]
        predu = _take(torch.stack(_chroma_preds(*nb[1], t_av, l_av), -3), cm)
        predv = _take(torch.stack(_chroma_preds(*nb[2], t_av, l_av), -3), cm)
        rec = (
            _blocks_to_mb(torch.clamp(_luma_blocks(pred)
                                      + res[0][:, rows, ci], 0, 255)),
            _cblocks_to_mb(torch.clamp(_chroma_blocks(predu)
                                       + res[1][:, rows, ci], 0, 255)),
            _cblocks_to_mb(torch.clamp(_chroma_blocks(predv)
                                       + res[2][:, rows, ci], 0, 255)),
        )
        fr.advance(rows, ci, nb, rec)
        for o, x in zip(rec_out, rec):
            o[:, rows, ci] = x.to(torch.uint8)
    return tuple(_plane(x) for x in rec_out)
