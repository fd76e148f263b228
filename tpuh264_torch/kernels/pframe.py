"""P-frame encoder/decoder core in PyTorch (row-slice parallel, rate-biased ME).

Port of tpuh264/kernels/pframe.py: `encode_pframe_rows_multi` (1..4
references; `intra_in_p` True or False; `t8` True or False; `halo`) and
`decode_pframe_rows_multi`.  Decisions are bit-identical to the JAX
version (tests/test_torch_pframe.py, tests/test_torch_intra_in_p.py,
tests/test_torch_t8.py, tests/test_torch_halo.py):

  1. stage A: the exact SAD table over the +-8 grid on the stride-2
     subsample -- K1, `me_cuda.sad_field` (CUDA kernel on the card, its
     plain version on the CPU) -- then the two-phase rate-biased winner
     with a per-stream global vector (with a process `group`, the
     winner counts are summed over it first: a row-sharded band takes
     the frame's vector, dist/mesh.py);
  2. stage B: a 3x3 full-resolution refine around the winner;
  3. stages C/D: all 49 reachable quarter-pel positions as static
     slices of an 18x18 four-plane window, then the normative
     half -> quarter selection;
  4. motion compensation, transforms, quant and reconstruction batched
     over [S, R, C];
  5. with `t8`, the 8x8 transform of every inter MB beside the 4x4 one:
     the lower J = 8*SSD + lambda8*rate wins (`_t8_choice`), and P_Skip,
     the symbols and the recon follow the chosen transform;
  6. with `intra_in_p`, a Python loop over the MB columns (the JAX
     column `lax.scan`; its TPU unroll factor is not carried over)
     tries Intra_16x16 against each MB's left reconstruction.

Per-MB windows and the motion-compensated predictions are gathers from
the padded planes at per-MB origins (the JAX version's masked sums over
static shifts were a TPU workaround).  Ties keep the first candidate in
raster order everywhere (`_argmin_first`), on every backend.

The decoder resolves the MV chain mv_c = g_c * (mv_{c-1} + mvd_c) with a
cumulative sum and a running reset index (the JAX associative_scan),
reconstructs inter MBs batched, and runs the left-neighbour intra
prediction of intra MBs as a Python loop over MB columns (GOP-start
dispatches decode the I frame as all-intra P records).

With `halo=True` the references arrive vertically pre-extended by
HALO_Y / HALO_C rows per side: the neighbour bands' rows a row-sharded
DPB exchanges (dist/mesh.py), edge-replicated at the frame's edges.
The planes then take only the 6-tap margin vertically, and a band's
result equals the rows of the unsharded encode.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..golden.inter import (
    LAMBDA_ME,
    OFFSETS_HALF,
    OFFSETS_QUARTER,
    QPEL_TBL,
    REFINE_RANGE,
    SEARCH_PAD,
    SEARCH_RANGE,
    mv_rate_bits,
    ref_idx_bits,
)
from ..dist.collectives import all_reduce
from . import me_cuda, tables
from . import transform as T
from . import transform8 as T8
from .iframe import (
    _LAMBDA8,
    Intra16,
    _blocks_to_mb,
    _chroma_cbp,
    _encode_chroma,
    _intra16_mb,
    _intra_recon_scan,
    _intra_residuals,
    _left_edges,
    _luma_blocks,
    _mbs_to_plane,
    _plane_to_mbs,
    _rate_bits,
    _recon_chroma,
)

I32 = torch.int32
KIND_SKIP = 0
KIND_INTER = 1
KIND_INTRA = 2

_PE = SEARCH_PAD + 1  # half-pel plane pad (13)
_CP = SEARCH_PAD // 2 + 2  # chroma reference pad (8)
_N = 2 * SEARCH_RANGE + 1
_NN = _N * _N

_CAND = np.stack(np.meshgrid(np.arange(-SEARCH_RANGE, SEARCH_RANGE + 1),
                             np.arange(-SEARCH_RANGE, SEARCH_RANGE + 1),
                             indexing="ij"), -1).reshape(_NN, 2)  # (dy, dx)
tables.register("cand_dy", lambda: _CAND[:, 0].astype(np.int32))
tables.register("cand_dx", lambda: _CAND[:, 1].astype(np.int32))
tables.register("rate0", lambda: np.asarray(
    [mv_rate_bits(4 * int(dx), 4 * int(dy)) for dy, dx in _CAND], np.int32))
tables.register("pow2_8", lambda: (1 << np.arange(8)).astype(np.int32))

# quarter-pel component table: id -> (plane, dy, dx); ids are
# golden.inter QPEL_TBL's [G00 b00 h00 j00 G10 G01 b01 h10]
_COMP_PL = (0, 1, 2, 3, 0, 0, 1, 2)
_COMP_DY = (0, 0, 0, 0, 0, 1, 1, 0)
_COMP_DX = (0, 0, 0, 0, 1, 0, 0, 1)


def _qpel_lut() -> np.ndarray:
    """[16 (fy*4+fx), 2 (component), 3 (plane, dy, dx)]."""
    out = np.zeros((16, 2, 3), np.int64)
    for fy in range(4):
        for fx in range(4):
            for i, k in enumerate(QPEL_TBL[(fx, fy)]):
                out[fy * 4 + fx, i] = (_COMP_PL[k], _COMP_DY[k], _COMP_DX[k])
    return out


tables.register("qpel_lut", _qpel_lut)


class MBSymbolsP(NamedTuple):
    """Per-MB P-slice symbols (layout of tpuh264.kernels.pframe.MBSymbolsP,
    shared with entropy/packp.py)."""

    kind: torch.Tensor        # [S, R, C] int32 0 skip / 1 inter / 2 intra
    mode: torch.Tensor        # [S, R, C] int32 intra luma mode
    cmode: torch.Tensor       # [S, R, C] int32 intra chroma mode
    cbp_luma: torch.Tensor    # [S, R, C] int32 (intra 0/1, inter 4-bit)
    cbp_chroma: torch.Tensor  # [S, R, C] int32 0..2
    mvdx: torch.Tensor        # [S, R, C] int32 quarter-pel
    mvdy: torch.Tensor        # [S, R, C] int32
    luma_dc: torch.Tensor     # [S, R, C, 16] int16
    luma_ac: torch.Tensor     # [S, R, C, 16, 16] int16
    chroma_dc: torch.Tensor   # [S, R, C, 2, 4] int16
    chroma_ac: torch.Tensor   # [S, R, C, 2, 4, 15] int16
    refidx: Optional[torch.Tensor] = None  # [S, R, C] int32
    t8: Optional[torch.Tensor] = None      # [S, R, C] int32 8x8 transform


# ---------------------------------------------------------------------------
# Reference planes and per-MB windows.
# ---------------------------------------------------------------------------


def _edge_pad(x: torch.Tensor, pad_y: int, pad_x: int) -> torch.Tensor:
    """Edge-replicate [S, H, W] by pad_y rows and pad_x columns per side
    (the normative Clip3 sample clamp of 8.4.2.2)."""
    h, w = x.shape[-2:]
    dev = x.device
    ri = torch.arange(-pad_y, h + pad_y, device=dev).clamp(0, h - 1)
    ci = torch.arange(-pad_x, w + pad_x, device=dev).clamp(0, w - 1)
    return x.index_select(-2, ri).index_select(-1, ci)


def _tap6(a, b, c, d, e, f):
    return a - 5 * b + 20 * c + 20 * d - 5 * e + f


# vertical reach of inter prediction into a reference, in rows: the halo a
# row-sharded DPB exchanges with each neighbour band (dist/mesh.py)
HALO_Y = SEARCH_PAD + 1   # 13: ME range + refine + subpel + 6-tap margin
HALO_C = SEARCH_PAD // 2 + 2  # 8: chroma eighth-pel reach


def build_halfpel_planes_ext(ref_ext: torch.Tensor, pad: int = SEARCH_PAD):
    """Half-pel planes of a vertically pre-extended reference: ref_ext
    [S, H + 2*(pad+1), W] carries pad+1 real (or edge-replicated) rows
    above and below the band -> 4 int32 planes [S, H+2(pad+1), W+2(pad+1)]
    (G, b, h, j).  Only the 6-tap margin is added vertically, the full
    edge pad horizontally.  Equal to the full frame's planes where the
    halo rows are the frame's continuation rows (or its edge rows at the
    frame's edges), but for the outer 3 rows, whose 6-tap reads pass the
    halo (motion never reaches them)."""
    p3 = pad + 4
    r = _edge_pad(ref_ext.to(I32), 3, p3)
    b1 = _tap6(r[:, :, :-5], r[:, :, 1:-4], r[:, :, 2:-3], r[:, :, 3:-2],
               r[:, :, 4:-1], r[:, :, 5:])
    h1 = _tap6(r[:, :-5], r[:, 1:-4], r[:, 2:-3], r[:, 3:-2], r[:, 4:-1],
               r[:, 5:])
    j1 = _tap6(b1[:, :-5], b1[:, 1:-4], b1[:, 2:-3], b1[:, 3:-2],
               b1[:, 4:-1], b1[:, 5:])
    g_p = r[:, 3:-3, 3:-3]
    b_p = torch.clamp((b1[:, 3:-3, 1:] + 16) >> 5, 0, 255)
    h_p = torch.clamp((h1[:, 1:, 3:-3] + 16) >> 5, 0, 255)
    j_p = torch.clamp((j1[:, 1:, 1:] + 512) >> 10, 0, 255)
    h2 = ref_ext.shape[1]
    w2 = ref_ext.shape[2] + 2 * (pad + 1)
    return tuple(pl[:, :h2, :w2].contiguous() for pl in (g_p, b_p, h_p, j_p))


def build_halfpel_planes(ref: torch.Tensor, pad: int = SEARCH_PAD):
    """[S,H,W] -> 4 int32 planes [S, H+2(pad+1), W+2(pad+1)] (G, b, h, j),
    bit-exact with golden.inter.build_halfpel_planes: the planes of the
    frame extended by its edge rows (the normative Clip3 clamp)."""
    return build_halfpel_planes_ext(_edge_pad(ref.to(I32), pad + 1, 0), pad)


def _pad_ref_ext(plane_ext: torch.Tensor, pad: int) -> torch.Tensor:
    """Horizontal-only edge pad of a vertically pre-extended chroma
    reference [S, H/2 + 2*pad, W/2]."""
    return _edge_pad(plane_ext.to(I32), 0, pad).contiguous()


def _mb_origin(s, r, c, mb, device):
    """Frame coordinates of every MB's top-left sample, [1,R,1], [1,1,C]."""
    oy = (torch.arange(r, device=device) * mb).view(1, r, 1)
    ox = (torch.arange(c, device=device) * mb).view(1, 1, c)
    return oy, ox


def _gather_win(planes: torch.Tensor, y0: torch.Tensor, x0: torch.Tensor,
                win: int) -> torch.Tensor:
    """Per-MB windows: planes [P, S, Hp, Wp]; y0/x0 [S,R,C] plane-space
    top-left corners -> [P, S, R, C, win, win] (indices clamped in-plane;
    legal motion never reaches the clamp)."""
    p, s, hp, wp = planes.shape
    dev = planes.device
    k = torch.arange(win, device=dev)
    rows = (y0.long()[..., None] + k).clamp(0, hp - 1)        # [S,R,C,win]
    cols = (x0.long()[..., None] + k).clamp(0, wp - 1)
    base = (torch.arange(s, device=dev) * (hp * wp)).view(s, 1, 1, 1, 1)
    flat = base + rows[..., :, None] * wp + cols[..., None, :]
    return planes.reshape(p, -1)[:, flat]


def _luma_win(planes, iy, ix, off: int, win: int):
    """Window of `win` luma samples per MB whose top-left is the MB origin
    + (iy, ix) + off, from half-pel planes [P, S, Hp, Wp] (pad _PE)."""
    s, r, c = iy.shape
    oy, ox = _mb_origin(s, r, c, 16, iy.device)
    return _gather_win(planes, oy + iy + off + _PE, ox + ix + off + _PE, win)


# ---------------------------------------------------------------------------
# Motion search.
# ---------------------------------------------------------------------------


def _rate_q(vx: torch.Tensor, vy: torch.Tensor) -> torch.Tensor:
    """Vectorised golden.inter.mv_rate_bits (ue(2|v|) lengths summed),
    exact for |v| <= 127 quarter-pels."""
    pow2 = tables.get("pow2_8", vx.device)

    def one(v):
        x = 2 * v.abs() + 1
        return 2 * (x[..., None] >= pow2).sum(-1, dtype=I32) - 1

    return one(vx) + one(vy)


def _argmin_first(x: torch.Tensor) -> torch.Tensor:
    """argmin over the last axis, first index on ties, on any backend."""
    n = x.shape[-1]
    key = x.long() * 512 + torch.arange(n, device=x.device)
    return torch.remainder(key.amin(-1), 512)


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """argmax over the last axis, first index on ties, on any backend."""
    n = x.shape[-1]
    key = x.long() * 512 + (511 - torch.arange(n, device=x.device))
    return 511 - torch.remainder(key.amax(-1), 512)


def _int_winner(sads: torch.Tensor, lam: int, group=None):
    """Two-phase stage-A selection on the SAD table [S,R,C,NN].

    Phase 1: zero-anchored rate bias -> per-MB winner; per-stream global
    MV = mode of the winners (raster-earliest on ties).  Phase 2:
    re-select with the rate measured relative to the global vector.
    Returns (iy0, ix0 [S,R,C], gy, gx [S]).

    group: the process group the MB rows are sharded over (the JAX
    version's axis_name).  The winner mode is a frame-global statistic,
    so a row-sharded call sums the counts over the group; otherwise each
    band would take its own global vector and the phase-2 selection
    would diverge from the unsharded encode."""
    dev = sads.device
    s = sads.shape[0]
    cost1 = 4 * sads + lam * tables.get("rate0", dev)
    win1 = _argmin_first(cost1)  # [S,R,C]
    counts = torch.zeros((s, _NN), dtype=torch.int64, device=dev)
    counts.scatter_add_(1, win1.reshape(s, -1),
                        torch.ones_like(win1.reshape(s, -1)))
    if group is not None:
        all_reduce(counts, group)
    gidx = _argmax_first(counts)  # [S]
    gy = (gidx // _N - SEARCH_RANGE).to(I32)
    gx = (gidx % _N - SEARCH_RANGE).to(I32)
    rate_rel = _rate_q(4 * (tables.get("cand_dx", dev)[None, :] - gx[:, None]),
                       4 * (tables.get("cand_dy", dev)[None, :] - gy[:, None]))
    win = _argmin_first(4 * sads + lam * rate_rel[:, None, None, :])
    return ((win // _N - SEARCH_RANGE).to(I32),
            (win % _N - SEARCH_RANGE).to(I32), gy, gx)


def _int_refine(gplane, src_mbs, iy0, ix0, lam: int, gqx, gqy):
    """Stage B: 3x3 full-resolution refine around the stage-A winner
    (raster order, strict <; rate relative to the global vector).
    gplane [S, Hp, Wp]; gq* [S,1,1] quarter-pel.  Returns (iy, ix)."""
    w19 = _luma_win(gplane[None], iy0, ix0, -REFINE_RANGE,
                    16 + 2 * REFINE_RANGE)[0]
    best_cost = biy = bix = None
    for oy in range(2 * REFINE_RANGE + 1):
        for ox in range(2 * REFINE_RANGE + 1):
            pred = w19[..., oy:oy + 16, ox:ox + 16]
            sad = (src_mbs - pred).abs().sum((-1, -2), dtype=I32)
            my = iy0 - REFINE_RANGE + oy
            mx = ix0 - REFINE_RANGE + ox
            cost = sad + lam * _rate_q(4 * mx - gqx, 4 * my - gqy)
            if best_cost is None:
                best_cost, biy, bix = cost, my, mx
            else:
                better = cost < best_cost
                best_cost = torch.where(better, cost, best_cost)
                biy = torch.where(better, my, biy)
                bix = torch.where(better, mx, bix)
    return biy, bix


def _comp_slice(w2, k: int, y_int: int, x_int: int):
    """Static 16x16 component read from the [.., 4, 18, 18] window stack
    (integer sample (0,0) of the winner sits at [1,1])."""
    dy = 1 + y_int + _COMP_DY[k]
    dx = 1 + x_int + _COMP_DX[k]
    return w2[..., _COMP_PL[k], dy:dy + 16, dx:dx + 16]


def _extract_w2(planes4, iy, ix):
    """[S,R,C,4,18,18] half-pel plane windows at the integer winner."""
    return torch.movedim(_luma_win(planes4, iy, ix, -1, 18), 0, 3)


def _subpel_refine(w2, src_mbs, iy, ix, lam: int, gqx, gqy):
    """Stages C/D: all 49 reachable quarter-pel positions, then the
    normative half -> quarter two-stage selection on the cost table.
    Returns (mvx_q, mvy_q, sad, cost) absolute quarter-pel MVs."""
    costs, sads = [], []
    for py in range(-3, 4):
        y_int, yf = py >> 2, py & 3
        for px in range(-3, 4):
            x_int, xf = px >> 2, px & 3
            c1, c2 = QPEL_TBL[(xf, yf)]
            pred = (_comp_slice(w2, c1, y_int, x_int)
                    + _comp_slice(w2, c2, y_int, x_int) + 1) >> 1
            sad = (src_mbs - pred).abs().sum((-1, -2), dtype=I32)
            costs.append(sad + lam * _rate_q(4 * ix + px - gqx,
                                             4 * iy + py - gqy))
            sads.append(sad)
    cost49 = torch.stack(costs, dim=-1)  # [S,R,C,49]
    sad49 = torch.stack(sads, dim=-1)

    best_cost = cost49[..., 24]  # centre (0, 0)
    by = torch.zeros_like(iy)
    bx = torch.zeros_like(ix)
    for hy, hx in OFFSETS_HALF:
        if (hy, hx) == (0, 0):
            continue
        cand = cost49[..., (3 + hy) * 7 + 3 + hx]
        better = cand < best_cost
        best_cost = torch.where(better, cand, best_cost)
        by = torch.where(better, hy, by)
        bx = torch.where(better, hx, bx)
    base_y, base_x = by, bx
    for qy, qx in OFFSETS_QUARTER:
        if (qy, qx) == (0, 0):
            continue
        idx = (3 + base_y + qy) * 7 + (3 + base_x + qx)
        cand = cost49.gather(-1, idx.long()[..., None])[..., 0]
        better = cand < best_cost
        best_cost = torch.where(better, cand, best_cost)
        by = torch.where(better, base_y + qy, by)
        bx = torch.where(better, base_x + qx, bx)
    fidx = (3 + by) * 7 + 3 + bx
    sad = sad49.gather(-1, fidx.long()[..., None])[..., 0]
    return 4 * ix + bx, 4 * iy + by, sad, best_cost


# ---------------------------------------------------------------------------
# Motion compensation.
# ---------------------------------------------------------------------------


def _mc_luma(planes4, mvx, mvy):
    """Quarter-pel luma prediction [S,R,C,16,16]: each sample is the
    rounded average of two half-pel plane components (8.4.2.2.1), read
    by per-MB gathers at the (plane, offset) the fraction selects."""
    s, r, c = mvx.shape
    _, _, hp, wp = planes4.shape
    dev = mvx.device
    lut = tables.get("qpel_lut", dev)[((mvy & 3) * 4 + (mvx & 3)).long()]
    oy, ox = _mb_origin(s, r, c, 16, dev)
    y0 = oy + (mvy >> 2).long() + _PE
    x0 = ox + (mvx >> 2).long() + _PE
    k = torch.arange(16, device=dev)
    flat_planes = planes4.reshape(-1)
    sbase = (torch.arange(s, device=dev) * (hp * wp)).view(s, 1, 1)
    comps = []
    for i in range(2):
        pl, dy, dx = lut[..., i, 0], lut[..., i, 1], lut[..., i, 2]
        base = pl * (s * hp * wp) + sbase
        rows = ((y0 + dy)[..., None] + k).clamp(0, hp - 1)
        cols = ((x0 + dx)[..., None] + k).clamp(0, wp - 1)
        flat = (base[..., None, None] + rows[..., :, None] * wp
                + cols[..., None, :])
        comps.append(flat_planes[flat])
    return (comps[0] + comps[1] + 1) >> 1


def _mc_chroma(ref_p, mvx, mvy):
    """Eighth-pel bilinear chroma MC (8.4.2.2.2) from a reference padded
    by _CP: mv in luma quarter-pel units -> [S,R,C,8,8]."""
    s, r, c = mvx.shape
    oy, ox = _mb_origin(s, r, c, 8, mvx.device)
    w9 = _gather_win(ref_p[None], oy + (mvy >> 3) + _CP,
                     ox + (mvx >> 3) + _CP, 9)[0]
    xf = (mvx & 7)[..., None, None]
    yf = (mvy & 7)[..., None, None]
    return ((8 - xf) * (8 - yf) * w9[..., :8, :8]
            + xf * (8 - yf) * w9[..., :8, 1:9]
            + (8 - xf) * yf * w9[..., 1:9, :8]
            + xf * yf * w9[..., 1:9, 1:9] + 32) >> 6


def _mc_all(planes_l, refs_up, refs_vp, mvx, mvy, refsel):
    """Luma + chroma MC at per-MB quarter-pel MVs, selecting among the
    references by `refsel`."""
    out = None
    for n in range(len(planes_l)):
        pred = (_mc_luma(planes_l[n], mvx, mvy),
                _mc_chroma(refs_up[n], mvx, mvy),
                _mc_chroma(refs_vp[n], mvx, mvy))
        if out is None:
            out = pred
        else:
            m = (refsel == n)[..., None, None]
            out = tuple(torch.where(m, pred[i], out[i]) for i in range(3))
    return out


def _references(refs_y, refs_u, refs_v, halo: bool):
    """Per reference: stacked half-pel planes [4,S,Hp,Wp] and padded
    chroma.  Without `halo` the frame's edge rows stand in for the halo
    (the normative Clip3 clamp), so both cases take one path."""
    if not halo:
        refs_y = _edge_pad(refs_y, HALO_Y, 0)
        refs_u = _edge_pad(refs_u, HALO_C, 0)
        refs_v = _edge_pad(refs_v, HALO_C, 0)
    n_refs = refs_y.shape[0]
    return ([torch.stack(build_halfpel_planes_ext(refs_y[n]), 0)
             for n in range(n_refs)],
            [_pad_ref_ext(refs_u[n], _CP) for n in range(n_refs)],
            [_pad_ref_ext(refs_v[n], _CP) for n in range(n_refs)])


# ---------------------------------------------------------------------------
# Transforms (batched over arbitrary leading dims).
# ---------------------------------------------------------------------------


def _transform_inter_luma(src, pred, qp: int):
    """Inter luma residual: full 16-coeff blocks -> (l_zz, q_flat, cbp4)."""
    w = T.forward4x4(_luma_blocks(src - pred))  # [., 4,4,4,4]
    q_flat = T.quant4x4(w, qp, intra=False).reshape(*w.shape[:-2], 16)
    l_zz = T.zigzag_flat(q_flat)  # [., 4, 4, 16]
    nz = (l_zz != 0).any(-1)  # [., 4(by), 4(bx)]
    gb = nz.reshape(*nz.shape[:-2], 2, 2, 2, 2).any(-1).any(-2)  # [., gy, gx]
    cbp4 = (gb[..., 0, 0].to(I32) | (gb[..., 0, 1].to(I32) << 1)
            | (gb[..., 1, 0].to(I32) << 2) | (gb[..., 1, 1].to(I32) << 3))
    return l_zz, q_flat, cbp4


def _nzmask8(cbp: torch.Tensor) -> torch.Tensor:
    """4-bit 8x8 CBP -> [., 4, 4] per-4x4-block coded mask."""
    bit = torch.arange(4, device=cbp.device).reshape(2, 2)
    m = ((cbp[..., None, None] >> bit) & 1) == 1  # [., 2, 2]
    return m.repeat_interleave(2, dim=-1).repeat_interleave(2, dim=-2)


def _recon_inter_luma(pred, q_flat, nzmask8, qp: int):
    """Recon from flat-raster quantized coeffs, masked by coded 8x8s."""
    dq = T.dequant_flat(torch.where(nzmask8[..., None], q_flat, 0), qp)
    d = dq.reshape(*dq.shape[:-1], 4, 4)
    return _blocks_to_mb(T.idct_add(_luma_blocks(pred), d))


def _to8(x: torch.Tensor) -> torch.Tensor:
    """[..., 16, 16] MBs -> [..., 2 (by), 2 (bx), 8, 8] 8x8 blocks."""
    return x.reshape(*x.shape[:-2], 2, 8, 2, 8).transpose(-3, -2)


def _from8(x: torch.Tensor) -> torch.Tensor:
    """[..., 2, 2, 8, 8] 8x8 blocks -> [..., 16, 16] MBs."""
    return x.transpose(-3, -2).reshape(*x.shape[:-4], 16, 16)


def _t8_choice(src_mbs, predl, qp: int, l_zz, cbp4, rec4):
    """The 8x8-vs-4x4 choice of every inter MB: J = 8*SSD + lambda8*rate
    (the 8x8 one pays one more bit for its flag); the 8x8 transform wins
    when strictly cheaper and it codes a coefficient.  Returns (use_t8,
    chosen 4-bit luma cbp, chosen luma recon, chosen luma levels in the
    [., 4, 4, 16] layout: the 8x8 blocks' 64 zigzag levels in raster
    block order)."""
    z8 = T8.quant8x8(T8.forward8x8(_to8(src_mbs - predl)), qp, intra=False)
    zz8 = T8.zigzag8(z8)  # [., 2, 2, 64]
    nz8 = (zz8 != 0).any(-1).to(I32)
    cbp8 = (nz8[..., 0, 0] | (nz8[..., 0, 1] << 1) | (nz8[..., 1, 0] << 2)
            | (nz8[..., 1, 1] << 3))
    rec8 = _from8(T8.idct8_add(_to8(predl), T8.dequant8x8(z8, qp)))
    lam8 = _LAMBDA8[min(max(qp, 0), 51)]
    d4 = rec4 - src_mbs
    d8 = rec8 - src_mbs
    j4 = (8 * (d4 * d4).sum((-1, -2), dtype=I32)
          + lam8 * _rate_bits(l_zz, (-1, -2, -3)))
    j8 = (8 * (d8 * d8).sum((-1, -2), dtype=I32)
          + lam8 * (_rate_bits(zz8, (-1, -2, -3)) + 1))
    use = (j8 < j4) & (cbp8 > 0)
    return (use, torch.where(use, cbp8, cbp4),
            torch.where(use[..., None, None], rec8, rec4),
            torch.where(use[..., None, None, None],
                        zz8.reshape(l_zz.shape), l_zz))


def _intra_in_p_scan(src_mbs, u_mbs, v_mbs, inter_sad, rec_inter, qp: int,
                     qpc: int):
    """The intra-in-P column scan: left to right along each MB row, the
    Intra_16x16 candidate of every MB (predicted from the left MB's
    final reconstruction, intra or inter) replaces the inter choice when
    its luma SAD is strictly below the inter SAD.  Only the decision and
    the reconstruction chain are sequential; the symbols are assembled
    batched afterwards.  Returns (use_intra [S,R,C], the stacked
    `iframe.Intra16` fields [S,R,C,...], final recon [S,R,C,...] x 3)."""
    c = inter_sad.shape[2]
    left = (None, None, None)
    outs = []
    for col in range(c):
        m = _intra16_mb(src_mbs[:, :, col], u_mbs[:, :, col],
                        v_mbs[:, :, col], left, col == 0, qp, qpc)
        use = m.sad < inter_sad[:, :, col]  # inter wins a tie
        sel = use[..., None, None]
        rec = tuple(torch.where(sel, a, b[:, :, col])
                    for a, b in zip(m.rec, rec_inter))
        left = _left_edges(rec)
        outs.append((use, m._replace(rec=None), rec))
    use_intra = torch.stack([o[0] for o in outs], dim=2)
    intra = Intra16(*[
        None if f[0] is None else torch.stack(f, dim=2)
        for f in zip(*[tuple(o[1]) for o in outs])])
    rec = tuple(torch.stack(f, dim=2) for f in zip(*[o[2] for o in outs]))
    return use_intra, intra, rec


def encode_pframe_rows_multi(
    y, u, v, refs_y, refs_u, refs_v, qp: int, ref_base: int = 0,
    halo: bool = False, t8: bool = False, intra_in_p: bool = True,
    group=None,
) -> Tuple[MBSymbolsP, Tuple[torch.Tensor, ...], Tuple[torch.Tensor, ...]]:
    """Encode P frames [S, H, W] against a DPB refs_* [N, S, H, W]
    (newest first).  Per MB every reference is searched; the lowest
    rate-biased cost wins, ties to the smaller index.  With `t8` each
    inter MB also tries the 8x8 transform (`_t8_choice`).  With
    `intra_in_p` each MB also tries Intra_16x16 (`_intra_in_p_scan`);
    without it (the RTC preset) the frame stays batched.  Returns
    (symbols, uint8 recon planes, (mvx, mvy) with zero motion for intra
    MBs).  With `halo` the references arrive vertically pre-extended by
    (HALO_Y, HALO_C) rows per side (a row-sharded DPB, dist/mesh.py), and
    `group` is the process group of the row bands (see `_int_winner`):
    the band's result is bit-identical to its rows of the unsharded
    encode."""
    qpc = T.chroma_qp_from_luma(qp)
    n_refs = refs_y.shape[0]
    s, h, w = y.shape
    r, c = h // 16, w // 16
    lam = int(LAMBDA_ME[min(max(qp, 0), 51)])
    planes_l, refs_up, refs_vp = _references(refs_y, refs_u, refs_v, halo)

    y32 = y.to(I32).contiguous()
    src_mbs = _plane_to_mbs(y32, 16)
    u_mbs = _plane_to_mbs(u.to(I32), 8)
    v_mbs = _plane_to_mbs(v.to(I32), 8)

    # ---- motion search per reference, batched over all MBs ----
    mvx = mvy = inter_sad = inter_cost = refsel = None
    for n in range(n_refs):
        sads = me_cuda.sad_field(y32, planes_l[n][0])
        iy0, ix0, gy, gx = _int_winner(sads, lam, group)
        del sads
        gqx = (4 * gx)[:, None, None]
        gqy = (4 * gy)[:, None, None]
        iy, ix = _int_refine(planes_l[n][0], src_mbs, iy0, ix0, lam, gqx, gqy)
        w2 = _extract_w2(planes_l[n], iy, ix)
        mvx_n, mvy_n, sad_n, cost_n = _subpel_refine(w2, src_mbs, iy, ix,
                                                     lam, gqx, gqy)
        # reference signalling rate bias (golden ref_idx_bits)
        cost_n = cost_n + lam * ref_idx_bits(n + ref_base, ref_base + n_refs)
        if n == 0:
            mvx, mvy, inter_sad, inter_cost = mvx_n, mvy_n, sad_n, cost_n
            refsel = torch.zeros_like(cost_n)
        else:
            better = cost_n < inter_cost
            mvx = torch.where(better, mvx_n, mvx)
            mvy = torch.where(better, mvy_n, mvy)
            inter_sad = torch.where(better, sad_n, inter_sad)
            inter_cost = torch.where(better, cost_n, inter_cost)
            refsel = torch.where(better, n, refsel)

    # ---- inter MC + transforms, batched ----
    predl, predcu, predcv = _mc_all(planes_l, refs_up, refs_vp, mvx, mvy,
                                    refsel)
    l_zz, ql_flat, cbp4 = _transform_inter_luma(src_mbs, predl, qp)
    rec_y = _recon_inter_luma(predl, ql_flat, _nzmask8(cbp4), qp)
    if t8:
        use_t8, cbp_l, rec_y, l_zz = _t8_choice(src_mbs, predl, qp, l_zz,
                                                cbp4, rec_y)
    else:
        use_t8, cbp_l = torch.zeros_like(cbp4, dtype=torch.bool), cbp4

    dcu, acu, qu = _encode_chroma(u_mbs, predcu, qpc, intra=False)
    dcv, acv, qv = _encode_chroma(v_mbs, predcv, qpc, intra=False)
    cbp_c = _chroma_cbp(dcu, acu, dcv, acv)
    rec_u = _recon_chroma(predcu, dcu, qu, cbp_c, qpc)
    rec_v = _recon_chroma(predcv, dcv, qv, cbp_c, qpc)

    skip = ((cbp_l == 0) & (cbp_c == 0) & (mvx == 0) & (mvy == 0)
            & (refsel + ref_base == 0))
    cdc = torch.stack([dcu.reshape(s, r, c, 4), dcv.reshape(s, r, c, 4)], -2)
    cac = torch.stack([acu.reshape(s, r, c, 4, 15),
                       acv.reshape(s, r, c, 4, 15)], -3)
    zero = torch.zeros_like(mvx)
    fields = dict(kind=torch.where(skip, KIND_SKIP, KIND_INTER), mode=zero,
                  cmode=zero, cbp_luma=cbp_l, cbp_chroma=cbp_c,
                  luma_dc=torch.zeros((s, r, c, 16), dtype=I32,
                                      device=y.device),
                  luma_ac=l_zz, chroma_dc=cdc, chroma_ac=cac,
                  refidx=torch.where(skip, 0, refsel + ref_base),
                  t8=torch.where(skip, 0, use_t8.to(I32)))
    rec = (rec_y, rec_u, rec_v)
    if intra_in_p:
        use, intra, rec = _intra_in_p_scan(src_mbs, u_mbs, v_mbs, inter_sad,
                                           rec, qp, qpc)
        sel = {0: use}
        for d in range(1, 4):
            sel[d] = sel[d - 1][..., None]
        for name, val in (("mode", intra.mode), ("cmode", intra.cmode),
                          ("cbp_luma", intra.cbp_luma),
                          ("cbp_chroma", intra.cbp_chroma),
                          ("luma_dc", intra.dc_zz), ("luma_ac", intra.ac_zz),
                          ("chroma_dc", intra.chroma_dc),
                          ("chroma_ac", intra.chroma_ac),
                          ("kind", KIND_INTRA), ("refidx", 0),
                          ("t8", 0)):
            old = fields[name]
            fields[name] = torch.where(sel[old.dim() - 3], val, old)
        mvx = torch.where(use, 0, mvx)
        mvy = torch.where(use, 0, mvy)
    # the MV predictor is the left MB's MV (row-slice 8.4.1.3 form; zero
    # left of column 0 and for an intra left MB): a shift of the batched
    # MV field, so the symbols assemble without a column scan
    pmvx = torch.nn.functional.pad(mvx, (1, 0))[..., :-1]
    pmvy = torch.nn.functional.pad(mvy, (1, 0))[..., :-1]
    is_intra = fields["kind"] == KIND_INTRA
    i16 = torch.int16
    symbols = MBSymbolsP(
        kind=fields["kind"].to(I32),
        mode=fields["mode"].to(I32), cmode=fields["cmode"].to(I32),
        cbp_luma=fields["cbp_luma"].to(I32),
        cbp_chroma=fields["cbp_chroma"].to(I32),
        mvdx=torch.where(is_intra, 0, mvx - pmvx).to(I32),
        mvdy=torch.where(is_intra, 0, mvy - pmvy).to(I32),
        luma_dc=fields["luma_dc"].to(i16),
        luma_ac=fields["luma_ac"].reshape(s, r, c, 16, 16).to(i16),
        chroma_dc=fields["chroma_dc"].to(i16),
        chroma_ac=fields["chroma_ac"].to(i16),
        refidx=fields["refidx"].to(I32),
        t8=fields["t8"].to(I32),
    )
    recon = tuple(_mbs_to_plane(x.to(torch.uint8)) for x in rec)
    return symbols, recon, (mvx.to(I32), mvy.to(I32))


def _mv_chain(g: torch.Tensor, mvd: torch.Tensor) -> torch.Tensor:
    """mv_c = g_c * (mv_{c-1} + mvd_c) along the MB columns (g in {0,1}):
    a cumulative sum restarted after every g = 0."""
    cs = torch.cumsum(g * mvd, dim=-1, dtype=I32)
    idx = torch.arange(g.shape[-1], device=g.device).expand_as(g)
    last0 = torch.cummax(torch.where(g == 0, idx, -1), dim=-1).values
    base = torch.where(last0 >= 0, cs.gather(-1, last0.clamp(min=0)), 0)
    return (g * (cs - base)).to(I32)


def decode_pframe_rows_multi(symbols: MBSymbolsP, refs_y, refs_u, refs_v,
                             qp: int, halo: bool = False, t8: bool = False):
    """Reconstruct P frames from parsed symbols and a DPB refs_*
    [N, S, H, W] (newest first; per-MB symbols.refidx; with `t8`, the
    MBs whose symbols.t8 is 1 reconstruct through the 8x8 transform).
    Returns (uint8 recon planes, (mvx, mvy)).  `halo`: the references
    arrive vertically pre-extended (a row-sharded DPB)."""
    qpc = T.chroma_qp_from_luma(qp)
    s, r, c = symbols.kind.shape
    planes_l, refs_up, refs_vp = _references(refs_y, refs_u, refs_v, halo)

    kind = symbols.kind.to(I32)
    refidx = (symbols.refidx.to(I32) if symbols.refidx is not None
              else torch.zeros_like(kind))
    is_intra = kind == KIND_INTRA
    is_skip = kind == KIND_SKIP

    g = (kind == KIND_INTER).to(I32)
    mvx = _mv_chain(g, symbols.mvdx.to(I32))
    mvy = _mv_chain(g, symbols.mvdy.to(I32))

    # ---- batched MC + inter residual reconstruction ----
    predl, predcu, predcv = _mc_all(planes_l, refs_up, refs_vp, mvx, mvy,
                                    refidx)
    ac4 = symbols.luma_ac.to(I32).reshape(s, r, c, 4, 4, 16)
    q_flat = T.inverse_zigzag(ac4).reshape(s, r, c, 4, 4, 16)
    inter_cbp = torch.where(is_skip, 0, symbols.cbp_luma.to(I32))
    rec_y_inter = _recon_inter_luma(predl, q_flat, _nzmask8(inter_cbp), qp)
    if t8 and symbols.t8 is not None:
        zz8 = symbols.luma_ac.to(I32).reshape(s, r, c, 2, 2, 64)
        rec8 = _from8(T8.idct8_add(
            _to8(predl), T8.dequant8x8(T8.inverse_zigzag8(zz8), qp)))
        rec_y_inter = torch.where((symbols.t8 == 1)[..., None, None], rec8,
                                  rec_y_inter)

    cbp_c = symbols.cbp_chroma.to(I32)
    ccbp = torch.where(is_skip, 0, cbp_c)
    cdc = symbols.chroma_dc.to(I32)
    cac = symbols.chroma_ac.to(I32)

    def q_from_zz(ac_zz15):
        coeffs = torch.nn.functional.pad(ac_zz15, (1, 0))
        return T.inverse_zigzag(coeffs).reshape(s, r, c, 2, 2, 16)

    dcu = cdc[..., 0, :].reshape(s, r, c, 2, 2)
    dcv = cdc[..., 1, :].reshape(s, r, c, 2, 2)
    qu = q_from_zz(cac[..., 0, :, :].reshape(s, r, c, 2, 2, 15))
    qv = q_from_zz(cac[..., 1, :, :].reshape(s, r, c, 2, 2, 15))
    rec_u_inter = _recon_chroma(predcu, dcu, qu, ccbp, qpc)
    rec_v_inter = _recon_chroma(predcv, dcv, qv, ccbp, qpc)

    # ---- intra MBs: batched residuals, then left-neighbour prediction
    # column by column (inter MBs pass through as left neighbours) ----
    rec = _intra_recon_scan(symbols.mode.to(I32), symbols.cmode.to(I32),
                            _intra_residuals(symbols, qp, qpc),
                            (rec_y_inter, rec_u_inter, rec_v_inter), is_intra)
    recon = tuple(_mbs_to_plane(x.to(torch.uint8)) for x in rec)
    return recon, (torch.where(is_intra, 0, mvx), torch.where(is_intra, 0, mvy))
