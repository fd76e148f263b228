"""In-loop deblocking filter (H.264 8.7), row-slice mode (idc=2): D1, a
CUDA kernel, plus its plain PyTorch version.

Port of tpuh264/kernels/deblock.py `deblock_frame_rows` (a jax.lax.scan
over MB columns).  The kernel (csrc/deblock.cu) runs two MB rows a
block, one warp for their luma lines and one for their chroma, and walks
the columns in order with the lines in registers.  The plain version,
`_deblock_rows_plain`, is a Python loop over MB columns, batched over
[S, R]: each step filters the vertical MB-boundary edge against the
previous MB (modifying its last columns -- the normative order), then
the current MB's internal vertical edges, then its internal horizontal
edges.  With idc=2 and row
slices the horizontal MB-boundary edges sit on slice boundaries and are
not filtered, which keeps rows independent.  tc0 is a table gather by
bS (the JAX version's select chain was a TPU workaround).  The first
column's left edge has bS 0 everywhere (no left MB in the slice) and is
skipped outright.  For MBs coded with the 8x8 transform (`t8`) the
4-aligned internal luma edges get bS 0; the chroma internal edge keeps
the bS of luma edge 2.

`deblock_frame_rows` takes the plain version only for tensors on the
CPU; for a CUDA tensor it launches the kernel or raises.  It takes the
per-4x4 coded counts of `deblock_nnz` and int32 planes (the kernel's
first entry).

`deblock_ring` is the kernel's second entry, which every caller of
`deblock_i` / `deblock_p` reaches: uint8 planes, as every reconstruction
of the codec's paths is, the per-MB fields read in place with their MB
strides, the coded
4x4 blocks worked out by the kernel from the MBs' luma_ac levels (the
8x8 rule for t8 MBs), no fields at all for an all-intra frame, and the
filtered planes written into a caller-given output (the GOP pipeline's
DPB ring slot).  Its plain version `_deblock_ring_plain` is
`_deblock_rows_plain` on `deblock_nnz`'s grid, copied into that output.

Also home of `deblock_nnz` (was engine/encoder.py `_deblock_nnz`) and of
the pipeline's two call shapes `deblock_i` / `deblock_p`.

The plain version is bit-exact with the JAX version
(tests/test_torch_deblock.py, _transform_iframe_deblock.py), the kernel
with the plain version (chip_smoke.py phase 2, tests/test_torch_cuda.py).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..golden.deblock import ALPHA, BETA, TC0
from . import cuda_lib, tables
from . import transform as T
from .iframe import _mb_strided, _mb_view, _mbs_to_plane

I32 = torch.int32
tables.register("tc0", lambda: np.asarray(TC0, np.int32))  # [52, 3]


def _tc0(qp: int, bs: torch.Tensor) -> torch.Tensor:
    """tc0 by bS (rows of Table 8-17 for bS 1, 2, >=3; bS 0 is masked)."""
    row = tables.get("tc0", bs.device)[qp]
    return row[(bs.clamp(1, 3) - 1).long()]


def _filter_luma(seg: torch.Tensor, bs: torch.Tensor, qp: int) -> torch.Tensor:
    """seg [..., N, 8] rows [p3..p0 q0..q3]; bs [..., N]; returns filtered."""
    a = int(ALPHA[qp])
    b = int(BETA[qp])
    p3, p2, p1, p0, q0, q1, q2, q3 = seg.unbind(-1)
    filt = ((bs > 0) & ((p0 - q0).abs() < a) & ((p1 - p0).abs() < b)
            & ((q1 - q0).abs() < b))
    ap = (p2 - p0).abs() < b
    aq = (q2 - q0).abs() < b

    tc0 = _tc0(qp, bs)
    tc = tc0 + ap.to(I32) + aq.to(I32)
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    avg = (p0 + q0 + 1) >> 1
    np1 = p1 + torch.clamp((p2 + avg - 2 * p1) >> 1, -tc0, tc0)
    nq1 = q1 + torch.clamp((q2 + avg - 2 * q1) >> 1, -tc0, tc0)

    strong = (p0 - q0).abs() < ((a >> 2) + 2)
    strongp = ap & strong
    strongq = aq & strong
    sp0 = (p2 + 2 * p1 + 2 * p0 + 2 * q0 + q1 + 4) >> 3
    sp1 = (p2 + p1 + p0 + q0 + 2) >> 2
    sp2 = (2 * p3 + 3 * p2 + p1 + p0 + q0 + 4) >> 3
    wp0 = (2 * p1 + p0 + q1 + 2) >> 2
    sq0 = (q2 + 2 * q1 + 2 * q0 + 2 * p0 + p1 + 4) >> 3
    sq1 = (q2 + q1 + q0 + p0 + 2) >> 2
    sq2 = (2 * q3 + 3 * q2 + q1 + q0 + p0 + 4) >> 3
    wq0 = (2 * q1 + q0 + p1 + 2) >> 2

    w = torch.where
    is4 = bs == 4
    o_p0 = w(is4, w(strongp, sp0, wp0), np0)
    o_p1 = w(is4, w(strongp, sp1, p1), w(ap, np1, p1))
    o_p2 = w(is4 & strongp, sp2, p2)
    o_q0 = w(is4, w(strongq, sq0, wq0), nq0)
    o_q1 = w(is4, w(strongq, sq1, q1), w(aq, nq1, q1))
    o_q2 = w(is4 & strongq, sq2, q2)
    return torch.stack([
        p3, w(filt, o_p2, p2), w(filt, o_p1, p1), w(filt, o_p0, p0),
        w(filt, o_q0, q0), w(filt, o_q1, q1), w(filt, o_q2, q2), q3,
    ], dim=-1)


def _filter_chroma(seg: torch.Tensor, bs: torch.Tensor, qpc: int):
    """seg [..., N, 4] = [p1 p0 q0 q1]."""
    a = int(ALPHA[qpc])
    b = int(BETA[qpc])
    p1, p0, q0, q1 = seg.unbind(-1)
    filt = ((bs > 0) & ((p0 - q0).abs() < a) & ((p1 - p0).abs() < b)
            & ((q1 - q0).abs() < b))
    tc = _tc0(qpc, bs) + 1
    delta = torch.clamp(((q0 - p0) * 4 + (p1 - q1) + 4) >> 3, -tc, tc)
    np0 = torch.clamp(p0 + delta, 0, 255)
    nq0 = torch.clamp(q0 - delta, 0, 255)
    is4 = bs == 4
    o_p0 = torch.where(is4, (2 * p1 + p0 + q1 + 2) >> 2, np0)
    o_q0 = torch.where(is4, (2 * q1 + q0 + p1 + 2) >> 2, nq0)
    return torch.stack([p1, torch.where(filt, o_p0, p0),
                        torch.where(filt, o_q0, q0), q1], dim=-1)


def _edge(left_cols, right_cols, bs4, qp: int, chroma: bool):
    """Filter across a vertical edge: left/right [S,R,N,4], bs4 [S,R,4]
    per 4-row group -> the filtered (left, right) column groups."""
    bs = bs4.repeat_interleave(left_cols.shape[-2] // 4, dim=-1)
    if chroma:
        seg = torch.cat([left_cols[..., 2:], right_cols[..., :2]], dim=-1)
        seg = _filter_chroma(seg, bs, qp)
        return (torch.cat([left_cols[..., :2], seg[..., :2]], dim=-1),
                torch.cat([seg[..., 2:], right_cols[..., 2:]], dim=-1))
    seg = _filter_luma(torch.cat([left_cols, right_cols], dim=-1), bs, qp)
    return seg[..., :4], seg[..., 4:]


def _internal(mb: torch.Tensor, intra, qp: int, chroma: bool,
              edges, t8=None) -> torch.Tensor:
    """Filter the internal vertical edges of [S,R,n,n] MBs; `edges` lists
    (sample column, (nnz of the block column left, right)).  Where `t8`
    [S,R] is given, its MBs skip the 4-aligned edges (columns 4 and 12)."""
    for xe, (nl, nr) in edges:
        bs4 = torch.where(intra[..., None], 3,
                          torch.where((nl > 0) | (nr > 0), 2, 0))
        if t8 is not None and xe in (4, 12):
            bs4 = torch.where(t8[..., None], 0, bs4)
        lc, rc = _edge(mb[..., xe - 4:xe], mb[..., xe:xe + 4], bs4, qp, chroma)
        mb = torch.cat([mb[..., :xe - 4], lc, rc, mb[..., xe + 4:]], dim=-1)
    return mb


def _deblock_rows_plain(y, u, v, kind, mvx, mvy, nnz, qp: int,
                        refidx=None, t8=None) -> Tuple[torch.Tensor, ...]:
    """Plain version of `deblock_frame_rows` (same arguments)."""
    qpc = T.chroma_qp_from_luma(qp)
    s, h, w = y.shape
    r, c = h // 16, w // 16
    if refidx is None:
        refidx = torch.zeros((s, r, c), dtype=I32, device=y.device)
    y_mbs = _mb_view(y.to(I32), 16)  # [C, S, R, 16, 16]
    u_mbs = _mb_view(u.to(I32), 8)
    v_mbs = _mb_view(v.to(I32), 8)
    kind_c = torch.movedim(kind.to(I32), 2, 0)
    mvx_c = torch.movedim(mvx.to(I32), 2, 0)
    mvy_c = torch.movedim(mvy.to(I32), 2, 0)
    ref_c = torch.movedim(refidx.to(I32), 2, 0)
    nnz_c = torch.movedim(nnz.to(I32), 2, 0)  # [C, S, R, 4, 4]
    t8_c = None if t8 is None else torch.movedim(t8 == 1, 2, 0)

    out_y, out_u, out_v = [], [], []
    prev = None
    for col in range(c):
        ymb, umb, vmb = y_mbs[col], u_mbs[col], v_mbs[col]
        k, nz = kind_c[col], nnz_c[col]
        tf = None if t8_c is None else t8_c[col]
        intra = k == 2
        if prev is not None:
            # ---- vertical MB-boundary edge (prev | cur) ----
            py_, pu_, pv_, pk, pmx, pmy, pnz, pref = prev
            coded = (pnz[..., 3] > 0) | (nz[..., 0] > 0)  # [S,R,4] rows
            mvdiff = (((mvx_c[col] - pmx).abs() >= 4)
                      | ((mvy_c[col] - pmy).abs() >= 4)
                      | (ref_c[col] != pref))
            bs_edge = torch.where(
                (intra | (pk == 2))[..., None], 4,
                torch.where(coded, 2, torch.where(mvdiff[..., None], 1, 0)))
            l, rr = _edge(py_[..., 12:16], ymb[..., 0:4], bs_edge, qp, False)
            out_y.append(torch.cat([py_[..., :12], l], dim=-1))
            ymb = torch.cat([rr, ymb[..., 4:]], dim=-1)
            l, rr = _edge(pu_[..., 4:8], umb[..., 0:4], bs_edge, qpc, True)
            out_u.append(torch.cat([pu_[..., :4], l], dim=-1))
            umb = torch.cat([rr, umb[..., 4:]], dim=-1)
            l, rr = _edge(pv_[..., 4:8], vmb[..., 0:4], bs_edge, qpc, True)
            out_v.append(torch.cat([pv_[..., :4], l], dim=-1))
            vmb = torch.cat([rr, vmb[..., 4:]], dim=-1)

        # ---- internal vertical edges x = 4, 8, 12 (chroma: x = 4) ----
        cols = [(4 * bx, (nz[..., :, bx - 1], nz[..., :, bx]))
                for bx in (1, 2, 3)]
        ccols = [(4, cols[1][1])]  # chroma edge x=4 shares luma x=8's bS
        ymb = _internal(ymb, intra, qp, False, cols, tf)
        umb = _internal(umb, intra, qpc, True, ccols)
        vmb = _internal(vmb, intra, qpc, True, ccols)
        # ---- internal horizontal edges y = 4, 8, 12 (transposed) ----
        rows = [(4 * by, (nz[..., by - 1, :], nz[..., by, :]))
                for by in (1, 2, 3)]
        crows = [(4, rows[1][1])]
        ymb = _internal(ymb.transpose(-1, -2), intra, qp, False,
                        rows, tf).transpose(-1, -2)
        umb = _internal(umb.transpose(-1, -2), intra, qpc, True,
                        crows).transpose(-1, -2)
        vmb = _internal(vmb.transpose(-1, -2), intra, qpc, True,
                        crows).transpose(-1, -2)
        prev = (ymb, umb, vmb, k, mvx_c[col], mvy_c[col], nz, ref_c[col])

    out_y.append(prev[0])
    out_u.append(prev[1])
    out_v.append(prev[2])
    return tuple(
        _mbs_to_plane(torch.stack(o, dim=2)).to(torch.uint8)
        for o in (out_y, out_u, out_v)
    )


def deblock_frame_rows(y, u, v, kind, mvx, mvy, nnz, qp: int,
                       refidx=None, t8=None) -> Tuple[torch.Tensor, ...]:
    """Filter [S, H, W] frames in row-slice (idc=2) mode; returns uint8
    planes.  kind/mvx/mvy/refidx/t8 [S, R, C]; nnz [S, R, C, 4, 4] per-4x4
    luma coded-coefficient counts (by, bx), 8x8-effective for t8 MBs
    (`deblock_nnz`).

    Precondition of the kernel: every sample of y, u and v lies in
    [0, 255] -- true of every reconstruction the callers pass (the
    encoder's and decoders' clamped recon).  Inputs of another integer
    dtype are taken as int32 copies."""
    if y.device.type == "cpu":
        return _deblock_rows_plain(y, u, v, kind, mvx, mvy, nnz, qp,
                                   refidx, t8)
    s, h, w = y.shape
    if h % 16 or w % 16 or not s * h * w:
        raise ValueError(f"deblock_frame_rows: frame {h}x{w} x {s} is not "
                         f"whole MBs")
    qp = int(qp)
    if not 0 <= qp <= 51:
        raise ValueError(f"deblock_frame_rows: qp {qp} outside 0..51")
    r, c = h // 16, w // 16
    planes = [p.to(I32).contiguous() for p in (y, u, v)]
    side = [x.to(I32).contiguous() for x in (kind, mvx, mvy)]
    nz = nnz.to(I32).contiguous()
    opt = [None if x is None else x.to(I32).contiguous()
           for x in (refidx, t8)]
    cuda_lib.check_inputs("deblock_frame_rows", y.device, [
        (planes[0], (s, h, w)), (planes[1], (s, h // 2, w // 2)),
        (planes[2], (s, h // 2, w // 2)), (nz, (s, r, c, 4, 4)),
        *[(x, (s, r, c)) for x in side + opt if x is not None]])
    if any(p.data_ptr() % 16 for p in planes):
        raise ValueError("deblock_frame_rows: planes must be 16-byte "
                         "aligned")
    out = [torch.empty(p.shape, dtype=torch.uint8, device=y.device)
           for p in planes]
    ptr = lambda x: None if x is None else x.data_ptr()
    err = cuda_lib.load().th264_deblock_rows(
        *map(ptr, planes + side + opt + [nz] + out), s * r, c, qp,
        T.chroma_qp_from_luma(qp), cuda_lib.stream(y.device))
    cuda_lib.check(err, "th264_deblock_rows")
    deblock_frame_rows.launches += 1
    return tuple(out)


deblock_frame_rows.launches = 0  # launches of the D1 kernel


def _levels_nnz(luma_ac: torch.Tensor, t8=None) -> torch.Tensor:
    """Per-4x4 coded-coefficient grid [S, R, C, 4, 4] from the MBs' luma
    AC levels [S, R, C, 16, 16]: each 4x4 block's count of nonzero
    levels; where `t8` [S, R, C] is given, a 4x4 cell of an 8x8-transform
    MB (t8 == 1) counts as coded iff its covering 8x8 block has any
    coefficient (8.7.2.1; the 64 levels of 8x8 block q are luma_ac[4q ..
    4q + 3])."""
    sh = luma_ac.shape[:-2]
    nnz4 = luma_ac.ne(0).sum(-1, dtype=I32).reshape(*sh, 4, 4)
    if t8 is None:
        return nnz4
    any8 = luma_ac.reshape(*sh, 4, 64).ne(0).any(-1).to(I32).reshape(
        *sh, 2, 2)
    cells8 = any8.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)
    return torch.where((t8 == 1)[..., None, None], cells8, nnz4)


def deblock_nnz(symbols, t8_enabled: bool = False) -> torch.Tensor:
    """Per-4x4 coded-coefficient grid [S, R, C, 4, 4] for the bS
    derivation (port of engine/encoder.py `_deblock_nnz`).  With
    `t8_enabled`, a 4x4 cell of an 8x8-transform MB counts as coded iff
    its covering 8x8 block has any coefficient (8.7.2.1)."""
    return _levels_nnz(symbols.luma_ac,
                       symbols.t8 if t8_enabled else None)


def _deblock_ring_plain(y, u, v, kind, mvx, mvy, luma_ac, qp: int,
                        refidx=None, t8=None, out=None):
    """Plain version of `deblock_ring` (same arguments):
    `_deblock_rows_plain` on `_levels_nnz`'s grid (zero grids and every
    MB intra where `kind` is None), copied into `out` where given."""
    if kind is None:
        s, h, w = y.shape
        sh = (s, h // 16, w // 16)
        mvx = mvy = torch.zeros(sh, dtype=I32, device=y.device)
        kind = torch.full(sh, 2, dtype=I32, device=y.device)
        nnz = torch.zeros((*sh, 4, 4), dtype=I32, device=y.device)
        refidx = t8 = None
    else:
        nnz = _levels_nnz(luma_ac, t8)
    planes = _deblock_rows_plain(y, u, v, kind, mvx, mvy, nnz, qp, refidx,
                                 t8)
    if out is None:
        return planes
    for o, p in zip(out, planes):
        o.copy_(p)
    return tuple(out)


def _ring_ready(p: torch.Tensor) -> bool:
    """True where the ring entry reads plane p as it is: uint8,
    contiguous, 16-byte aligned (every reconstruction the codec's paths
    pass)."""
    return (p.dtype == torch.uint8 and p.is_contiguous()
            and p.data_ptr() % 16 == 0)


def _plane_copy(p: torch.Tensor) -> torch.Tensor:
    """A copy of plane p as the ring entry reads it (see `_ring_ready`):
    samples in [0, 255] narrowed to uint8."""
    p = p.to(torch.uint8).contiguous()
    return p if p.data_ptr() % 16 == 0 else p.clone()


def _k4_ring_operands(planes, kind, mvx, mvy, luma_ac, qp: int, refidx,
                      t8, out):
    """The ring entry's operands in its order (csrc/deblock.cu
    `ring_args`): (input tensors, output tensors, ints).  Each per-MB
    field goes as it lies with its MB stride (`iframe._mb_strided`: the
    GOP decode's record views take no copy); a missing field as None (a
    null pointer), every field None for an all-intra frame."""
    s, h, w = planes[0].shape
    mb = (s, h // 16, w // 16)
    if kind is None:
        fields = [(None, 0)] * 5
        lev = (None, 0)
    else:
        fields = [(None, 0) if x is None else _mb_strided(x, mb, (), I32, 4)
                  for x in (kind, mvx, mvy, refidx, t8)]
        lev = _mb_strided(luma_ac, mb, (16, 16), torch.int16, 16)
    ins = list(planes) + [x for x, _ in fields] + [None, lev[0]]
    ints = [s * mb[1], mb[2], qp, T.chroma_qp_from_luma(qp),
            *[k for _, k in fields], lev[1]]
    return ins, list(out), ints


def deblock_ring(y, u, v, kind, mvx, mvy, luma_ac, qp: int, refidx=None,
                 t8=None, out=None) -> Tuple[torch.Tensor, ...]:
    """Filter [S, H, W] frames in row-slice (idc=2) mode into `out` (three
    uint8 planes of their shapes, e.g. a DPB ring slot's views; fresh
    planes where None), returned.  kind/mvx/mvy/refidx/t8 [S, R, C] (any
    int dtype and strides), luma_ac [S, R, C, 16, 16] the MBs' luma
    levels, whose nonzero ones make a 4x4 block coded (with `t8` given,
    by the 8x8 rule for its MBs, as `deblock_nnz(symbols, True)`).
    `kind` None: every MB intra (an IDR; mvx, mvy, luma_ac, refidx and t8
    are not read).  Samples in [0, 255]; the kernel reads uint8 planes
    (a plane of another dtype is narrowed first, `_plane_copy`).  CPU
    tensors take `_deblock_ring_plain`; CUDA tensors launch the kernel's
    ring entry; anything else raises."""
    if y.device.type == "cpu":
        return _deblock_ring_plain(y, u, v, kind, mvx, mvy, luma_ac, qp,
                                   refidx, t8, out)
    name = "deblock_ring"
    if y.device.type != "cuda":
        raise ValueError(f"{name}: planes on {y.device}, neither the CPU "
                         f"nor a CUDA device")
    s, h, w = y.shape
    if h % 16 or w % 16 or not s * h * w:
        raise ValueError(f"{name}: frame {h}x{w} x {s} is not whole MBs")
    qp = int(qp)
    if not 0 <= qp <= 51:
        raise ValueError(f"{name}: qp {qp} outside 0..51")
    planes = [p if _ring_ready(p) else _plane_copy(p) for p in (y, u, v)]
    shapes = [(s, h, w), (s, h // 2, w // 2), (s, h // 2, w // 2)]
    if out is None:
        out = [torch.empty(sh, dtype=torch.uint8, device=y.device)
               for sh in shapes]
    cuda_lib.check_inputs(name, y.device, list(zip(planes, shapes)),
                          dtype=torch.uint8)
    cuda_lib.check_inputs(name, y.device, list(zip(out, shapes)),
                          dtype=torch.uint8)
    if any(p.data_ptr() % 16 for p in list(out)):
        raise ValueError(f"{name}: output planes must be 16-byte aligned")
    others = [x for x in (kind, mvx, mvy, luma_ac, refidx, t8)
              if x is not None]
    if any(x.device != y.device for x in others):
        raise ValueError(f"{name}: every input must be on {y.device}")
    ins, outs, ints = _k4_ring_operands(planes, kind, mvx, mvy, luma_ac, qp,
                                        refidx, t8, out)
    err = cuda_lib.load().th264_deblock_ring(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(y.device))
    cuda_lib.check(err, "th264_deblock_ring")
    deblock_ring.launches += 1
    return tuple(out)


deblock_ring.launches = 0  # launches of the D1 kernel's ring entry


def deblock_i(recon, qp: int, out=None):
    """In-loop deblock of an all-intra frame (every MB intra, bS 3/4),
    into `out` where given (see `deblock_ring`)."""
    return deblock_ring(recon[0], recon[1], recon[2], None, None, None,
                        None, qp, out=out)


def deblock_p(recon, sym, motion, qp: int, t8: bool = False, out=None):
    """In-loop deblock of a P frame from its symbols and motion field;
    `t8` where the stream enables the 8x8 transform; into `out` where
    given (see `deblock_ring`)."""
    return deblock_ring(
        recon[0], recon[1], recon[2], sym.kind, motion[0], motion[1],
        sym.luma_ac, qp, refidx=sym.refidx, t8=sym.t8 if t8 else None,
        out=out)
