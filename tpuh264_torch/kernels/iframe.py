"""I-frame encoder/decoder core in PyTorch: row-slice parallel MB scans.

Port of tpuh264/kernels/iframe.py.  Each MB row is its own slice, so the
only causal chain is the left neighbour within a row: the column
`lax.scan` of the JAX version becomes one CUDA kernel a scan on the card
(a warp per (stream, MB row) lane walking its C columns), and a Python
loop over the C MB columns, batched over all lanes, in the plain
versions.  The first column has no left neighbour: the encode predicts
it by DC at 128 only; the decode, as the JAX scans with their zero
carry, takes DC at 128 where its mode says DC and 0 (H against zeros)
where it says H, which no legal stream codes there.

The encode's column scan, `encode_iframe_scan`, is D3: K6
(csrc/intra16_enc.cu, `_intra16_launch`) for CUDA tensors, with
`intra44` its Intra_4x4 route (the kernel's kI44 instance); its plain
version `_encode_iframe_scan_plain` (`_intra16_mb` a column) takes CPU
tensors.  With `intra44` every column also runs the causal Intra_4x4
trial (intra44.py) and keeps, per MB, whichever of Intra_16x16 and
Intra_4x4 has the lower Lagrangian cost J = 8*SSD + lam8[qp]*rate, with
the JAX module's integer `_LAMBDA8` table and rate proxy `_rate_bits`.

`_intra16_mb` and `_intra16_launch` are shared with the intra-in-P scan
of pframe.py (D4, the same kernel), and `_intra_residuals` /
`_intra_recon_scan` (the decode) with the P decoder's intra MBs.

The decode's column scan, `_intra_recon_scan`, is D2, a CUDA kernel
(K5, csrc/intra_recon.cu: a block per MB row, decoding the intra MBs'
residuals from the levels itself; with `i44`, its Intra_4x4 route) for
CUDA tensors, with its plain version `_intra_recon_scan_plain`
(`_intra_residuals`, then the column loop) for CPU tensors.

Bit-exact with the JAX version (tests/test_torch_transform_iframe_deblock.py,
tests/test_torch_intra44.py, tests/test_torch_intra_recon.py,
tests/test_torch_intra_enc.py).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from . import cuda_lib, tables
from . import intra44 as I44
from . import transform as T

I32 = torch.int32

# mode-decision lambda table and rate proxy of the I16-vs-I4x4 decision:
# the integer values of tpuh264/kernels/iframe.py `_LAMBDA8` (the golden
# codec's LAMBDA8_MODE), computed by the same Python float expression
_LAMBDA8 = [int(0.85 * 2.0 ** ((qp - 12) / 3.0) * 8) for qp in range(52)]
tables.register("pow2_16", lambda: np.asarray([1 << k for k in range(16)],
                                               np.int32))


class MBSymbols(NamedTuple):
    """Per-MB entropy symbols, layouts shared with native/cavlc.cpp and
    tpuh264.kernels.iframe.MBSymbols.  `mode` 4 marks an Intra_4x4 MB:
    then `i4modes` holds its block modes, `cbp_luma` its 4-bit per-8x8
    pattern, `luma_ac` full 16-coefficient zigzag blocks, and `luma_dc`
    is unused."""

    mode: torch.Tensor        # [S, R, C] int32 luma pred mode (4 = I4x4)
    cmode: torch.Tensor       # [S, R, C] int32 chroma pred mode
    cbp_luma: torch.Tensor    # [S, R, C] int32 0/1 (I16) or 0..15 (I4x4)
    cbp_chroma: torch.Tensor  # [S, R, C] int32 0..2
    luma_dc: torch.Tensor     # [S, R, C, 16] int16 zigzag levels
    luma_ac: torch.Tensor     # [S, R, C, 16, 16] int16 zigzag (slot 0 unused)
    chroma_dc: torch.Tensor   # [S, R, C, 2, 4] int16 (Cb, Cr) raster DC
    chroma_ac: torch.Tensor   # [S, R, C, 2, 4, 15] int16 block raster
    i4modes: Optional[torch.Tensor] = None  # [S, R, C, 16] int16, -1 = n/a


def _mb_view(plane: torch.Tensor, mb: int) -> torch.Tensor:
    """[S, H, W] -> [C, S, R, mb, mb] (scan axis first)."""
    s, h, w = plane.shape
    r, c = h // mb, w // mb
    return plane.reshape(s, r, mb, c, mb).permute(3, 0, 1, 2, 4)


def _unscan(x: torch.Tensor) -> torch.Tensor:
    """[C, S, R, ...] -> [S, R, C, ...]."""
    return torch.movedim(x, 0, 2)


def _mbs_to_plane(mbs: torch.Tensor) -> torch.Tensor:
    """[S, R, C, mb, mb] -> [S, R*mb, C*mb]."""
    s, r, c, mb, _ = mbs.shape
    return mbs.permute(0, 1, 3, 2, 4).reshape(s, r * mb, c * mb)


def _plane_to_mbs(plane: torch.Tensor, mb: int) -> torch.Tensor:
    """[S, H, W] -> [S, R, C, mb, mb]."""
    s, h, w = plane.shape
    return plane.reshape(s, h // mb, mb, w // mb, mb).permute(0, 1, 3, 2, 4)


def _pred_luma(left: Optional[torch.Tensor], first: bool, lead, device):
    """DC and H predictions [., 16, 16] from the left column [., 16]; the
    first column has only DC at 128 (H is None)."""
    if first:
        return torch.full((*lead, 16, 16), 128, dtype=I32, device=device), None
    dc = (left.sum(-1, dtype=I32) + 8) >> 4
    pred_dc = dc[..., None, None].expand(*dc.shape, 16, 16)
    pred_h = left[..., :, None].expand(*left.shape, 16)
    return pred_dc, pred_h


def _pred_chroma(left: Optional[torch.Tensor], first: bool, lead, device):
    """Chroma DC (per 4-row half from the left) and H predictions [., 8, 8]."""
    if first:
        return torch.full((*lead, 8, 8), 128, dtype=I32, device=device), None
    halves = left.reshape(*left.shape[:-1], 2, 4)
    dcs = (halves.sum(-1, dtype=I32) + 2) >> 2  # [., 2]
    pred_dc = dcs[..., :, None, None].expand(*dcs.shape, 4, 8).reshape(
        *left.shape[:-1], 8, 8)
    pred_h = left[..., :, None].expand(*left.shape, 8)
    return pred_dc, pred_h


def _sad(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a - b).abs().sum((-1, -2), dtype=I32)


def _luma_blocks(mb16: torch.Tensor) -> torch.Tensor:
    """[., 16, 16] -> [., 4, 4, 4, 4] as (by, bx, y, x)."""
    lead = mb16.shape[:-2]
    return mb16.reshape(*lead, 4, 4, 4, 4).transpose(-3, -2)


def _blocks_to_mb(blocks: torch.Tensor) -> torch.Tensor:
    lead = blocks.shape[:-4]
    return blocks.transpose(-3, -2).reshape(*lead, 16, 16)


def _chroma_blocks(mb8: torch.Tensor) -> torch.Tensor:
    lead = mb8.shape[:-2]
    return mb8.reshape(*lead, 2, 4, 2, 4).transpose(-3, -2)


def _cblocks_to_mb(blocks: torch.Tensor) -> torch.Tensor:
    lead = blocks.shape[:-4]
    return blocks.transpose(-3, -2).reshape(*lead, 8, 8)


def _subst_dc(d_flat: torch.Tensor, dc: torch.Tensor) -> torch.Tensor:
    """Replace raster element 0 of [..., 16] with dc [...] and reshape to
    [..., 4, 4]."""
    d = torch.cat([dc[..., None].to(d_flat.dtype), d_flat[..., 1:]], dim=-1)
    return d.reshape(*d.shape[:-1], 4, 4)


def _encode_luma(src, pred, qp: int):
    """Transform+quant+recon of one luma MB batch. Returns symbols+recon."""
    w = T.forward4x4(_luma_blocks(src - pred))  # [., 4,4,4,4]
    dc_zz = T.zigzag(T.quant_luma_dc(T.hadamard4x4(w[..., 0, 0]), qp))
    q_flat = T.quant4x4(w, qp, intra=True).reshape(*w.shape[:-2], 16)
    ac_zz = T.zigzag_flat(q_flat).clone()
    ac_zz[..., 0] = 0  # slot 0 = DC, coded separately
    cbp = (ac_zz != 0).flatten(-3).any(-1)  # [.]
    dc_deq = T.dequant_luma_dc(T.inverse_zigzag(dc_zz), qp)
    dq = T.dequant_flat(torch.where(cbp[..., None, None, None], q_flat, 0), qp)
    rec = _blocks_to_mb(T.idct_add(_luma_blocks(pred), _subst_dc(dq, dc_deq)))
    return dc_zz, ac_zz, cbp, rec


def _encode_chroma(src, pred, qpc: int, intra: bool = True):
    """One chroma component: quantized DC (2,2), AC (2,2,15), flat coeffs."""
    w = T.forward4x4(_chroma_blocks(src - pred))  # [., 2,2,4,4]
    dcq = T.quant_chroma_dc(T.hadamard2x2(w[..., 0, 0]), qpc, intra=intra)
    q_flat = T.quant4x4(w, qpc, intra=intra).reshape(*w.shape[:-2], 16)
    ac_zz = T.zigzag_flat(q_flat)[..., 1:]
    return dcq, ac_zz, q_flat


def _recon_chroma(pred, dcq, q_flat, cbp_chroma, qpc: int):
    dc_deq = torch.where((cbp_chroma >= 1)[..., None, None],
                         T.dequant_chroma_dc(dcq, qpc), 0)
    dq = T.dequant_flat(
        torch.where((cbp_chroma == 2)[..., None, None, None], q_flat, 0), qpc)
    d = _subst_dc(dq, dc_deq)
    return _cblocks_to_mb(T.idct_add(_chroma_blocks(pred), d))


def _chroma_cbp(dcu, acu, dcv, acv):
    any_ac = acu.flatten(-3).ne(0).any(-1) | acv.flatten(-3).ne(0).any(-1)
    any_dc = dcu.flatten(-2).ne(0).any(-1) | dcv.flatten(-2).ne(0).any(-1)
    return torch.where(any_ac, 2, torch.where(any_dc, 1, 0)).to(I32)


class Intra16(NamedTuple):
    """One column of Intra_16x16 MBs [S, R, ...] (see `_intra16_mb`)."""

    mode: torch.Tensor        # [S, R] 2 = DC, 1 = H
    cmode: torch.Tensor       # [S, R] 0 = DC, 1 = H
    sad: torch.Tensor         # [S, R] luma SAD of the chosen prediction
    dc_zz: torch.Tensor       # [S, R, 16]
    ac_zz: torch.Tensor       # [S, R, 4, 4, 16] (slot 0 = 0)
    cbp_luma: torch.Tensor    # [S, R] 0/1
    chroma_dc: torch.Tensor   # [S, R, 2, 4] (Cb, Cr)
    chroma_ac: torch.Tensor   # [S, R, 2, 4, 15]
    cbp_chroma: torch.Tensor  # [S, R] 0..2
    rec: Tuple[torch.Tensor, ...]  # [S, R, 16, 16], [S, R, 8, 8] x 2


def _intra16_mb(ymb, umb, vmb, left, first: bool, qp: int, qpc: int
                ) -> Intra16:
    """Encode one MB column as Intra_16x16 against the left neighbours'
    reconstructed edge columns `left` (y [S,R,16], u/v [S,R,8]; unused on
    the first column, which has DC at 128 only).  Luma and chroma each
    choose DC or H by SAD, ties to DC."""
    s, r = ymb.shape[:2]
    lead, dev = (s, r), ymb.device
    pred_dc, pred_h = _pred_luma(left[0], first, lead, dev)
    cost_dc = _sad(ymb, pred_dc)
    pu_dc, pu_h = _pred_chroma(left[1], first, lead, dev)
    pv_dc, pv_h = _pred_chroma(left[2], first, lead, dev)
    if first:
        mode = torch.full(lead, 2, dtype=I32, device=dev)
        cmode = torch.zeros(lead, dtype=I32, device=dev)
        pred, predu, predv, sad = pred_dc, pu_dc, pv_dc, cost_dc
    else:
        cost_h = _sad(ymb, pred_h)
        use_dc = cost_dc <= cost_h
        mode = torch.where(use_dc, 2, 1).to(I32)
        pred = torch.where(use_dc[..., None, None], pred_dc, pred_h)
        sad = torch.minimum(cost_dc, cost_h)
        use_cdc = (_sad(umb, pu_dc) + _sad(vmb, pv_dc)
                   <= _sad(umb, pu_h) + _sad(vmb, pv_h))
        cmode = torch.where(use_cdc, 0, 1).to(I32)
        sel = use_cdc[..., None, None]
        predu = torch.where(sel, pu_dc, pu_h)
        predv = torch.where(sel, pv_dc, pv_h)
    dc_zz, ac_zz, cbp_luma, rec_y = _encode_luma(ymb, pred, qp)
    dcu, acu, qu = _encode_chroma(umb, predu, qpc)
    dcv, acv, qv = _encode_chroma(vmb, predv, qpc)
    cbp_chroma = _chroma_cbp(dcu, acu, dcv, acv)
    rec_u = _recon_chroma(predu, dcu, qu, cbp_chroma, qpc)
    rec_v = _recon_chroma(predv, dcv, qv, cbp_chroma, qpc)
    return Intra16(
        mode, cmode, sad, dc_zz, ac_zz, cbp_luma.to(I32),
        torch.stack([dcu.reshape(s, r, 4), dcv.reshape(s, r, 4)], dim=-2),
        torch.stack([acu.reshape(s, r, 4, 15), acv.reshape(s, r, 4, 15)],
                    dim=-3),
        cbp_chroma, (rec_y, rec_u, rec_v))


def _left_edges(rec):
    """The last sample column of each reconstructed MB plane: the next
    column's left neighbours."""
    return rec[0][..., :, 15], rec[1][..., :, 7], rec[2][..., :, 7]


def _rate_bits(coeffs: torch.Tensor, dims) -> torch.Tensor:
    """Sum of 2*bit_length(|c|)+1 over the nonzero levels along `dims`
    (the JAX module's rate proxy, integer only)."""
    a = coeffs.to(I32).abs()
    bl = (a[..., None] >= tables.get("pow2_16", a.device)).sum(-1, dtype=I32)
    return torch.where(a > 0, 2 * bl + 1, 0).sum(dims, dtype=I32)


def _intra44_choice(m: Intra16, ymb, left_y, first: bool, qp: int):
    """The Intra_4x4 trial of one MB column [S, R] against the Intra_16x16
    result `m`: per MB the lower J = 8*SSD + lam8[qp]*rate wins, Intra_16x16
    on ties.  Returns (m with the I4x4 MBs' luma fields and recon
    substituted, i4modes [S, R, 16] int16 (-1 for Intra_16x16 MBs))."""
    s, r = ymb.shape[:2]
    if first:  # no left MB: zeros stand in, and no mode reads them
        left_y = torch.zeros((s, r, 16), dtype=I32, device=ymb.device)
    l_ok = torch.full((s, r), not first, dtype=torch.bool, device=ymb.device)
    _, m44, coef44, cbp44, rec44 = I44.encode_mb(ymb, left_y, l_ok, qp)
    rec_y = m.rec[0]
    d16 = rec_y - ymb
    d44 = rec44 - ymb
    ssd16 = (d16 * d16).sum((-1, -2), dtype=I32)
    ssd44 = (d44 * d44).sum((-1, -2), dtype=I32)
    r16 = 8 + _rate_bits(m.dc_zz, (-1,)) + _rate_bits(m.ac_zz, (-1, -2, -3))
    r44 = 96 + _rate_bits(coef44, (-1, -2))
    lam8 = _LAMBDA8[min(max(qp, 0), 51)]
    use = 8 * ssd44 + lam8 * r44 < 8 * ssd16 + lam8 * r16
    u1, u2 = use[..., None], use[..., None, None]
    m = m._replace(
        mode=torch.where(use, 4, m.mode).to(I32),
        cbp_luma=torch.where(use, cbp44, m.cbp_luma).to(I32),
        dc_zz=torch.where(u1, 0, m.dc_zz),
        ac_zz=torch.where(u2[..., None], coef44.reshape(s, r, 4, 4, 16),
                          m.ac_zz),
        rec=(torch.where(u2, rec44, rec_y), *m.rec[1:]))
    return m, torch.where(u1, m44, -1).to(torch.int16)


class K6Out(NamedTuple):
    """What `_intra16_launch` returns: the Intra_16x16 fields [S, R, C,
    ...] (levels int16, in the MBSymbols layouts), then D3's i4modes (all
    -1) and uint8 raster recon planes, or D4's intra SAD, choice `use`
    (bool) and int32 final recon [S,R,C,16,16], [S,R,C,8,8] x 2."""

    mode: torch.Tensor
    cmode: torch.Tensor
    cbp_luma: torch.Tensor
    cbp_chroma: torch.Tensor
    luma_dc: torch.Tensor     # [S, R, C, 16] int16
    luma_ac: torch.Tensor     # [S, R, C, 16, 16] int16, blocks by*4+bx
    chroma_dc: torch.Tensor   # [S, R, C, 2, 4] int16
    chroma_ac: torch.Tensor   # [S, R, C, 2, 4, 15] int16
    i4modes: Optional[torch.Tensor]
    sad: Optional[torch.Tensor]
    use: Optional[torch.Tensor]
    rec: Tuple[torch.Tensor, ...]


def _intra16_launch(name: str, planes, qp: int, qpc: int, inter_sad=None,
                    rec_inter=None, i44: bool = False) -> K6Out:
    """One launch of K6 (csrc/intra16_enc.cu) over source planes y [S, H,
    W], u, v [S, H/2, W/2] on the card (uint8, else taken as int32) at
    luma / chroma QPs qp, qpc: the I encode's scan (D3; with `i44`, its
    Intra_4x4 route, which takes the tap words of intra44.py and
    `_LAMBDA8[qp]`) or, with `inter_sad` [S, R, C] and `rec_inter` (int32
    [S,R,C,16,16], [S,R,C,8,8] x 2), the intra-in-P scan (D4).  Raises on
    a bad input or a failed build or launch; the caller counts the
    launch."""
    y = planes[0]
    s, h, w = y.shape
    r, c = h // 16, w // 16
    if not s * r * c or h % 16 or w % 16:
        raise ValueError(f"{name}: frames {tuple(y.shape)} hold no whole MB")
    if not (0 <= qp <= 51 and 0 <= qpc <= 51):
        raise ValueError(f"{name}: QP {qp} / {qpc} outside 0..51")
    dev = y.device
    u8 = all(p.dtype == torch.uint8 for p in planes)
    planes = [p.contiguous() if u8 else p.to(I32).contiguous()
              for p in planes]
    shapes = [(s, h, w), (s, h // 2, w // 2), (s, h // 2, w // 2)]
    mb = (s, r, c)
    d4 = inter_sad is not None
    if d4 != (rec_inter is not None):
        raise ValueError(f"{name}: `inter_sad` and `rec_inter` go together")
    if d4 and i44:
        raise ValueError(f"{name}: the Intra_4x4 route is the I encode's")
    side = []
    if d4:
        side = [x.to(I32).contiguous() for x in (inter_sad, *rec_inter)]
    cuda_lib.check_inputs(name, dev, list(zip(planes, shapes)),
                          dtype=torch.uint8 if u8 else I32)
    cuda_lib.check_inputs(name, dev, list(zip(side, [
        mb, (*mb, 16, 16), (*mb, 8, 8), (*mb, 8, 8)])))
    # 16-byte loads: a view at an odd offset is copied to fresh storage
    planes, side = ([x if x.data_ptr() % 16 == 0 else x.clone() for x in xs]
                    for xs in (planes, side))
    new = lambda sh, dt: torch.empty(sh, dtype=dt, device=dev)
    i16 = torch.int16
    out = dict(mode=new(mb, I32), cmode=new(mb, I32),
               cbp_luma=new(mb, I32), cbp_chroma=new(mb, I32),
               luma_dc=new((*mb, 16), i16), luma_ac=new((*mb, 16, 16), i16),
               chroma_dc=new((*mb, 2, 4), i16),
               chroma_ac=new((*mb, 2, 4, 15), i16),
               i4modes=None, sad=None, use=None)
    lib = cuda_lib.load()
    ptr = lambda x: x.data_ptr()
    fields = [out[f] for f in ("mode", "cmode", "cbp_luma", "cbp_chroma")]
    levels = [out[f] for f in ("luma_dc", "luma_ac", "chroma_dc",
                               "chroma_ac")]
    if d4:
        out.update(sad=new(mb, I32), use=new(mb, torch.uint8),
                   rec=(new((*mb, 16, 16), I32), new((*mb, 8, 8), I32),
                        new((*mb, 8, 8), I32)))
        err = lib.th264_intra16_in_p_rows(
            *map(ptr, [*planes]), int(u8), *map(ptr, side),
            *map(ptr, [*fields, out["sad"], out["use"], *levels,
                       *out["rec"]]),
            s * r, c, qp, qpc, cuda_lib.stream(dev))
        entry = "th264_intra16_in_p_rows"
        out["use"] = out["use"].view(torch.bool)
    else:
        out.update(i4modes=new((*mb, 16), i16),
                   rec=tuple(new(sh, torch.uint8) for sh in shapes))
        args = [*map(ptr, planes), int(u8),
                *map(ptr, [*fields, *levels, out["i4modes"], *out["rec"]]),
                s * r, c, qp, qpc]
        if i44:
            entry = "th264_intra44_encode_rows"
            args += [ptr(tables.get("i44_taps", dev)), _LAMBDA8[qp]]
        else:
            entry = "th264_intra16_encode_rows"
        err = getattr(lib, entry)(*args, cuda_lib.stream(dev))
    cuda_lib.check(err, entry)
    return K6Out(**out)


def encode_iframe_scan(y, u, v, qp: int, intra44: bool = False
                       ) -> Tuple[MBSymbols, Tuple[torch.Tensor, ...]]:
    """Encode [S, H, W] frames (u, v [S, H/2, W/2]) as I frames with one
    slice per MB row, with the Intra_4x4 trial where `intra44`.  Returns
    (symbols, (recon_y, recon_u, recon_v)) with uint8 recon, exactly as
    tpuh264.kernels.iframe.encode_iframe_scan.

    CPU tensors take the plain version; CUDA tensors launch K6
    (csrc/intra16_enc.cu; with `intra44`, its Intra_4x4 route) or
    raise."""
    if y.device.type == "cpu":
        return _encode_iframe_scan_plain(y, u, v, qp, intra44)
    o = _intra16_launch("encode_iframe_scan", (y, u, v), qp,
                        T.chroma_qp_from_luma(qp), i44=intra44)
    encode_iframe_scan.launches += 1
    encode_iframe_scan.i44_launches += bool(intra44)
    return MBSymbols(*o[:9]), o.rec


encode_iframe_scan.launches = 0  # launches of K6 for D3
encode_iframe_scan.i44_launches = 0  # of them, its Intra_4x4 route's


def _encode_iframe_scan_plain(y, u, v, qp: int, intra44: bool = False
                              ) -> Tuple[MBSymbols, Tuple[torch.Tensor, ...]]:
    """Plain version of `encode_iframe_scan` (same arguments): a Python
    loop of `_intra16_mb` over the MB columns, batched over [S, R]."""
    qpc = T.chroma_qp_from_luma(qp)
    s, h, w = y.shape
    r, c = h // 16, w // 16
    y_mbs = _mb_view(y.to(I32), 16)  # [C, S, R, 16, 16]
    u_mbs = _mb_view(u.to(I32), 8)
    v_mbs = _mb_view(v.to(I32), 8)
    i16 = torch.int16
    no_i4 = torch.full((s, r, 16), -1, dtype=i16, device=y.device)

    left = (None, None, None)
    outs = []
    for col in range(c):
        m = _intra16_mb(y_mbs[col], u_mbs[col], v_mbs[col], left, col == 0,
                        qp, qpc)
        i4m = no_i4
        if intra44:
            m, i4m = _intra44_choice(m, y_mbs[col], left[0], col == 0, qp)
        left = _left_edges(m.rec)
        outs.append((
            m.mode, m.cmode, m.cbp_luma, m.cbp_chroma, m.dc_zz.to(i16),
            m.ac_zz.reshape(s, r, 16, 16).to(i16), m.chroma_dc.to(i16),
            m.chroma_ac.to(i16), i4m, *(x.to(torch.uint8) for x in m.rec)))

    cols = [torch.stack(f, dim=2) for f in zip(*outs)]  # [S, R, C, ...]
    symbols = MBSymbols(*cols[:9])
    recon = tuple(_mbs_to_plane(x) for x in cols[9:])
    return symbols, recon


def encode_iframe_rows(y, u, v, qp: int):
    """I16-only encode scan (the devpipe fast path)."""
    return encode_iframe_scan(y, u, v, qp, intra44=False)


def _intra_residuals(symbols, qp: int, qpc: int):
    """The prediction-independent half of Intra_16x16 reconstruction,
    batched over [S, R, C]: the inverse-transformed residuals (luma
    [S,R,C,4,4,4,4], chroma [S,R,C,2,2,4,4] each) from parsed symbols
    (MBSymbols or MBSymbolsP layout)."""
    s, r, c = symbols.cbp_luma.shape
    cbp_l = symbols.cbp_luma.to(I32)
    cbp_c = symbols.cbp_chroma.to(I32)
    ac4 = symbols.luma_ac.to(I32).reshape(s, r, c, 4, 4, 16)
    dc_deq = T.dequant_luma_dc(T.inverse_zigzag(symbols.luma_dc.to(I32)), qp)
    iq = torch.where((cbp_l == 1)[..., None, None, None], ac4, 0)
    iq_flat = T.inverse_zigzag(iq).reshape(s, r, c, 4, 4, 16)
    res_y = (T.inverse4x4(_subst_dc(T.dequant_flat(iq_flat, qp), dc_deq))
             + 32) >> 6
    cdc = symbols.chroma_dc.to(I32)
    cac = symbols.chroma_ac.to(I32)

    def chroma(i):
        dcq = cdc[..., i, :].reshape(s, r, c, 2, 2)
        ac = torch.nn.functional.pad(cac[..., i, :, :], (1, 0))
        q_flat = T.inverse_zigzag(ac).reshape(s, r, c, 2, 2, 16)
        dc_d = torch.where((cbp_c >= 1)[..., None, None],
                           T.dequant_chroma_dc(dcq, qpc), 0)
        dq = torch.where((cbp_c == 2)[..., None, None, None], q_flat, 0)
        return (T.inverse4x4(_subst_dc(T.dequant_flat(dq, qpc), dc_d))
                + 32) >> 6

    return res_y, chroma(0), chroma(1)


def _intra_recon_scan(mode, cmode, levels, qp: int, qpc: int, other=None,
                      is_intra=None, i44=None):
    """Left-neighbour prediction of intra MBs, column by column, plus the
    residuals that `_intra_residuals` decodes from `levels` (anything
    with MBSymbols' cbp_luma, cbp_chroma, luma_dc, luma_ac, chroma_dc and
    chroma_ac: the parsed symbols) at luma / chroma QPs qp, qpc.  Where
    `is_intra` [S,R,C] is False an MB takes its reconstruction from
    `other` ([S,R,C,16,16], [S,R,C,8,8] x 2) instead, and serves as the
    next MB's left neighbour.  With `i44` = (luma_ac [S,R,C,16,16],
    i4modes [S,R,C,16], qp) the MBs of mode 4 take the causal Intra_4x4
    reconstruction.  Returns int32 [S,R,C,16,16], [S,R,C,8,8] x 2.

    CPU tensors take the plain version; CUDA tensors launch the D2 kernel
    (csrc/intra_recon.cu, which decodes the residuals of the intra MBs
    itself; with `i44`, its Intra_4x4 route, `other` or not) or raise."""
    if mode.device.type == "cpu":
        return _intra_recon_scan_plain(mode, cmode, levels, qp, qpc, other,
                                       is_intra, i44)
    s, r, c = mode.shape
    if not s * r * c:
        raise ValueError(f"_intra_recon_scan: no MB ({s}, {r}, {c})")
    qps = (qp, qpc) + (() if i44 is None else (i44[2],))
    if not all(0 <= q <= 51 for q in qps):
        raise ValueError(f"_intra_recon_scan: QPs {qps} outside 0..51")
    if (other is None) != (is_intra is None):
        raise ValueError("_intra_recon_scan: `other` and `is_intra` go "
                         "together")
    cuda_lib.check_devices("_intra_recon_scan", mode.device, (
        mode, cmode, *(getattr(levels, f) for f in _LEVELS),
        *(() if other is None else (*other, is_intra)),
        *(() if i44 is None else i44[:2])))
    ins, outs, ints = _k5_operands(mode, cmode, levels, qp, qpc, other,
                                   is_intra, i44)
    err = cuda_lib.load().th264_intra_recon_rows(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(mode.device))
    cuda_lib.check(err, "th264_intra_recon_rows")
    _intra_recon_scan.launches += 1
    _intra_recon_scan.i44_launches += i44 is not None
    return tuple(outs)


_intra_recon_scan.launches = 0  # launches of the D2 kernel
_intra_recon_scan.i44_launches = 0  # of them, its Intra_4x4 route's


# the fields of `levels` K5 reads: the cbps, then the levels
_LEVELS = ("cbp_luma", "cbp_chroma", "luma_dc", "luma_ac", "chroma_dc",
           "chroma_ac")


def _mb_strided(x: torch.Tensor, mb, inner, dtype, align: int):
    """(tensor, MB stride in elements) of a per-MB field x [*mb, *inner]
    for a kernel that reads MB m at element m * stride: x itself where
    its inner elements are contiguous, its MBs one stride apart and it
    (with the stride in bytes) is `align`-byte aligned (a strided view of
    one record buffer, as the GOP decode's); else a contiguous copy."""
    shape = (*mb, *inner)
    if tuple(x.shape) != shape:
        raise ValueError(f"_intra_recon_scan: shape {tuple(x.shape)} != "
                         f"{shape}")
    x = x.to(dtype)
    n_in = math.prod(inner)
    st = x.stride()
    # the stride of the innermost MB axis longer than 1 (those inside it
    # have length 1)
    k = next((st[d] for d in (2, 1, 0) if mb[d] > 1), n_in)
    want, step = [], 1
    for n in reversed(inner):
        want.append(step)
        step *= n
    step = k
    for n in reversed(mb):
        want.append(step)
        step *= n
    laid_out = all(a == b for a, b, n in zip(st, reversed(want), shape)
                   if n > 1)
    if not (laid_out and k >= n_in and x.data_ptr() % align == 0
            and (k * x.element_size()) % align == 0):
        x, k = x.contiguous(), n_in
        if x.data_ptr() % align:
            x = x.clone()
    return x, k


def _k5_operands(mode, cmode, levels, qp: int, qpc: int, other=None,
                 is_intra=None, i44=None):
    """K5's operands in its entry's order (csrc/intra_recon.cu `k5_args`):
    (input tensors, output tensors, ints).  The per-MB flags and levels
    go as the views they are where the kernel can read them so (each
    with its MB stride), else as contiguous copies; a missing `other` /
    `is_intra` as None (a null pointer), and so a missing `i44` (its
    i4modes, levels and the tap words of the Intra_4x4 predictor).
    i4modes go as int16: another type is first clamped to -1..8, which
    changes no mode the reconstruction reads (`intra44._select` clamps
    to 0..8)."""
    s, r, c = mb = tuple(mode.shape)
    dev = mode.device
    flags = [_mb_strided(x, mb, (), I32, 4)
             for x in (mode, cmode, levels.cbp_luma, levels.cbp_chroma)]
    lev = [_mb_strided(getattr(levels, f), mb, inner, torch.int16, 16)
           for f, inner in zip(_LEVELS[2:], ((16,), (16, 16), (2, 4),
                                              (2, 4, 15)))]
    shapes = [(*mb, 16, 16), (*mb, 8, 8), (*mb, 8, 8)]
    if other is None:
        side = [None] * 4
    else:
        if tuple(is_intra.shape) != mb:
            raise ValueError(f"_intra_recon_scan: is_intra "
                             f"{tuple(is_intra.shape)} != {mb}")
        planes = [x.to(I32).contiguous() for x in other]
        for x, sh in zip(planes, shapes):
            if tuple(x.shape) != sh:
                raise ValueError(f"_intra_recon_scan: shape "
                                 f"{tuple(x.shape)} != {sh}")
        # 16-byte loads: a view at an odd offset is copied to fresh storage
        side = [is_intra.to(torch.bool).contiguous().view(torch.uint8),
                *[x if x.data_ptr() % 16 == 0 else x.clone()
                  for x in planes]]
    if i44 is None:
        i4, i44_ints = [None] * 3, [0, 0, 0]
    else:
        coef, i4m, qp44 = i44
        if i4m.dtype != torch.int16:
            i4m = i4m.clamp(-1, 8)
        (i4m, si4), (ac44, sac44) = (
            _mb_strided(i4m, mb, (16,), torch.int16, 16),
            _mb_strided(coef, mb, (16, 16), torch.int16, 16))
        i4 = [i4m, ac44, tables.get("i44_taps", dev)]
        i44_ints = [qp44, si4, sac44]
    outs = [torch.empty(sh, dtype=I32, device=dev) for sh in shapes]
    ins = ([x for x, _ in flags] + side[:1] + [x for x, _ in lev] + side[1:]
           + i4)
    return ins, outs, [s * r, c, qp, qpc, *[k for _, k in flags + lev],
                       *i44_ints]


def _intra_recon_scan_plain(mode, cmode, levels, qp: int, qpc: int,
                            other=None, is_intra=None, i44=None):
    """Plain version of `_intra_recon_scan` (same arguments):
    `_intra_residuals` of every MB, then a Python loop over the MB
    columns, batched over [S, R]."""
    res = _intra_residuals(levels, qp, qpc)
    s, r, c = mode.shape
    lead, dev = (s, r), mode.device
    left = (None, None, None)
    outs = []
    for col in range(c):
        first = col == 0
        pred_dc, pred_h = _pred_luma(left[0], first, lead, dev)
        pu_dc, pu_h = _pred_chroma(left[1], first, lead, dev)
        pv_dc, pv_h = _pred_chroma(left[2], first, lead, dev)
        if first:  # H predicts from the JAX scans' zero carry: 0
            pred_h = pu_h = pv_h = 0
        lsel = (mode[:, :, col] == 2)[..., None, None]
        csel = (cmode[:, :, col] == 0)[..., None, None]
        pred = torch.where(lsel, pred_dc, pred_h)
        predu = torch.where(csel, pu_dc, pu_h)
        predv = torch.where(csel, pv_dc, pv_h)
        rec = (
            _blocks_to_mb(torch.clamp(_luma_blocks(pred) + res[0][:, :, col],
                                      0, 255)),
            _cblocks_to_mb(torch.clamp(_chroma_blocks(predu)
                                       + res[1][:, :, col], 0, 255)),
            _cblocks_to_mb(torch.clamp(_chroma_blocks(predv)
                                       + res[2][:, :, col], 0, 255)),
        )
        if i44 is not None:
            coef, i4m, qp = i44
            left_y = (torch.zeros((s, r, 16), dtype=I32, device=dev) if first
                      else left[0])
            l_ok = torch.full(lead, not first, dtype=torch.bool, device=dev)
            rec44 = I44.decode_mb(coef[:, :, col], i4m[:, :, col], left_y,
                                  l_ok, qp)
            rec = (torch.where((mode[:, :, col] == 4)[..., None, None],
                               rec44, rec[0]), *rec[1:])
        if other is not None:
            sel = is_intra[:, :, col][..., None, None]
            rec = tuple(torch.where(sel, a, b[:, :, col])
                        for a, b in zip(rec, other))
        left = _left_edges(rec)
        outs.append(rec)
    return tuple(torch.stack(o, dim=2) for o in zip(*outs))


def decode_iframe_scan(symbols: MBSymbols, qp: int, intra44: bool = False
                       ) -> Tuple[torch.Tensor, ...]:
    """Reconstruct I frames from parsed symbols (the inverse of the
    encode scan; `intra44`: some MBs may be Intra_4x4): uint8 (recon_y,
    recon_u, recon_v), exactly as tpuh264.kernels.iframe.decode_iframe_scan."""
    qpc = T.chroma_qp_from_luma(qp)
    i44 = (symbols.luma_ac, symbols.i4modes, qp) if intra44 else None
    rec = _intra_recon_scan(symbols.mode.to(I32), symbols.cmode.to(I32),
                            symbols, qp, qpc, i44=i44)
    return tuple(_mbs_to_plane(x.to(torch.uint8)) for x in rec)


def decode_iframe_rows(symbols: MBSymbols, qp: int):
    """I16-only decode scan (the DevicePipeline path)."""
    return decode_iframe_scan(symbols, qp, intra44=False)


# ---------------------------------------------------------------------------
# Fused symbol transport: the symbol tensors travel to the host as ONE flat
# int16 buffer (one device-to-host copy instead of nine).
# ---------------------------------------------------------------------------


def symbol_sizes(s: int, r: int, c: int, i4: bool = False):
    """(field, shape, size) table of the flat layout (as the JAX module's)."""
    n = s * r * c
    sizes = [
        ("mode", (s, r, c), n),
        ("cmode", (s, r, c), n),
        ("cbp_luma", (s, r, c), n),
        ("cbp_chroma", (s, r, c), n),
        ("luma_dc", (s, r, c, 16), n * 16),
        ("luma_ac", (s, r, c, 16, 16), n * 256),
        ("chroma_dc", (s, r, c, 2, 4), n * 8),
        ("chroma_ac", (s, r, c, 2, 4, 15), n * 120),
    ]
    if i4:
        sizes.append(("i4modes", (s, r, c, 16), n * 16))
    return sizes


def flatten_symbols(symbols: MBSymbols, i4: bool = False) -> torch.Tensor:
    """All symbol tensors in one flat int16 tensor, `i4modes` last where
    `i4` (the layout of `symbol_sizes`)."""
    names = [f for f, _, _ in symbol_sizes(1, 1, 1, i4)]
    return torch.cat([getattr(symbols, f).to(torch.int16).reshape(-1)
                      for f in names])


def unflatten_symbols_np(flat: np.ndarray, s: int, r: int, c: int,
                         i4: bool = False) -> dict:
    """Host-side inverse of flatten_symbols: a dict of numpy views."""
    out, off = {}, 0
    for name, shape, size in symbol_sizes(s, r, c, i4):
        out[name] = flat[off:off + size].reshape(shape)
        off += size
    return out
