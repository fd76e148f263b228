"""P-frame encoder/decoder core in PyTorch (row-slice parallel, rate-biased ME).

Port of tpuh264/kernels/pframe.py: `encode_pframe_rows_multi` (1..4
references; `intra_in_p` True or False; `t8` True or False; `halo`) and
`decode_pframe_rows_multi`.  Decisions are bit-identical to the JAX
version (tests/test_torch_pframe.py, tests/test_torch_intra_in_p.py,
tests/test_torch_t8.py, tests/test_torch_halo.py,
tests/test_torch_pframe_kernel.py):

  1. stage A, per reference: the exact SAD table over the +-8 grid on
     the stride-2 subsample -- K1, `me_cuda.sad_field` (CUDA kernel on
     the card, its plain version on the CPU) -- then the two-phase
     rate-biased winner with a per-stream global vector (with a process
     `group`, the winner counts are summed over it first: a row-sharded
     band takes the frame's vector, dist/mesh.py);
  2. then over all references at once, `_inter_encode`: K9 on the card
     (csrc/pframe_enc.cu, `t8` its second route), its plain version
     `_inter_encode_plain` for CPU tensors:
     a. stage B: a 3x3 full-resolution refine around the winner;
     b. stages C/D: the normative half -> quarter selection (the plain
        version tabulates all 49 reachable quarter-pel positions of an
        18x18 four-plane window; K9 computes the 17 the selections read);
     c. the reference choice, motion compensation, transforms, quant,
        reconstruction and P_Skip;
     d. with `t8`, the 8x8 transform of every inter MB beside the 4x4
        one: the lower J = 8*SSD + lambda8*rate wins (`_t8_choice`), and
        P_Skip, the symbols and the recon follow the chosen transform;
  3. with `intra_in_p`, the column scan (the JAX column `lax.scan`,
     D4) tries Intra_16x16 against each MB's left reconstruction:
     `_intra_in_p_scan`, K6 on the card (csrc/intra16_enc.cu, the I
     encode's kernel), its plain version `_intra_in_p_scan_plain` (a
     Python loop over the MB columns) for CPU tensors.
  4. the symbols: given `out` buffers (`empty_symbols`, the GOP
     pipeline's dispatch-wide ones), K9 writes every MBSymbolsP field
     there itself, the mvds by a second pass; the other routes assemble
     them in PyTorch and copy them in.

In the plain versions, per-MB windows and the motion-compensated
predictions are gathers from the padded planes at per-MB origins (the
JAX version's masked sums over static shifts were a TPU workaround).
Ties keep the first candidate in raster order everywhere
(`_argmin_first`), on every backend.

The references come as [N, S, H, W] tensors or as the N references'
planes newest first (a DPB ring's slots), which K11 reads by pointer.
Their half-pel and chroma planes (`_references`) are uint8 with every row
16-byte aligned, its pitch the width rounded up to 16 bytes: K1, K9 and
K10 read them as bytes, 16 (or 4) at a time, and take the pitches as
arguments; the plain versions widen them to int32 before any sum.

The decoder's inter part, `_inter_decode` (K10 on the card,
csrc/pframe_dec.cu, reading each symbol field with its MB stride,
`t8` its second route; `_inter_decode_plain` for CPU tensors),
resolves the MV chain mv_c = g_c * (mv_{c-1} + mvd_c) (the plain
version with a cumulative sum and a running reset index, the JAX
associative_scan) and reconstructs every MB as inter; then the
left-neighbour intra prediction of intra MBs runs as a column scan (K5,
`_intra_recon_scan`; GOP-start dispatches decode the I frame as
all-intra P records).

With `halo=True` the references arrive vertically pre-extended by
HALO_Y / HALO_C rows per side: the neighbour bands' rows a row-sharded
DPB exchanges (dist/mesh.py), edge-replicated at the frame's edges.
The planes then take only the 6-tap margin vertically, and a band's
result equals the rows of the unsharded encode.
"""

from __future__ import annotations

import ctypes
import functools
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
from . import cuda_lib, me_cuda, tables
from . import transform as T
from . import transform8 as T8
from .iframe import (
    _LAMBDA8,
    Intra16,
    _blocks_to_mb,
    _chroma_cbp,
    _encode_chroma,
    _intra16_launch,
    _intra16_mb,
    _intra_recon_scan,
    _left_edges,
    _mb_strided,
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
    """Per-MB windows: planes [P, S, Hp, Wp] (any strides: the uint8 views
    `_references` returns); y0/x0 [S,R,C] plane-space top-left corners ->
    int32 [P, S, R, C, win, win] (indices clamped in-plane; legal motion
    never reaches the clamp)."""
    p, s, hp, wp = planes.shape
    dev = planes.device
    k = torch.arange(win, device=dev)
    rows = (y0.long()[..., None] + k).clamp(0, hp - 1)        # [S,R,C,win]
    cols = (x0.long()[..., None] + k).clamp(0, wp - 1)
    sidx = torch.arange(s, device=dev).view(s, 1, 1, 1, 1)
    return planes[:, sidx, rows[..., :, None], cols[..., None, :]].to(I32)


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
    Returns (iy0, ix0 [S,R,C], gy, gx [S]), int32.

    group: the process group the MB rows are sharded over (the JAX
    version's axis_name).  The winner mode is a frame-global statistic,
    so a row-sharded call sums the counts over the group; otherwise each
    band would take its own global vector and the phase-2 selection
    would diverge from the unsharded encode.

    CPU tensors take the plain version; CUDA tensors launch K12
    (csrc/me_winner.cu: phase 1 with the counts, then phase 2, the
    counts summed over `group` between the two) or raise.  `launches`
    counts the calls, two CUDA launches each."""
    if sads.device.type == "cpu":
        return _int_winner_plain(sads, lam, group)
    out = _k12_launch(sads, lam, group)
    _int_winner.launches += 1
    return out


_int_winner.launches = 0  # calls of K12 (two launches each)


# K12's grid: blocks an SM of the card (a 256-thread block; the kernel
# walks a contiguous chunk of MBs a block), and the SMs assumed for a
# table that is not on a CUDA device (the CPU-thread tests: an H100 SXM's)
_K12_BLOCKS_PER_SM = 2
_K12_SMS_OFF_CARD = 132


@functools.lru_cache(maxsize=None)
def _k12_sms(dev: torch.device) -> int:
    """The SMs of `dev` (`_K12_SMS_OFF_CARD` off a CUDA device)."""
    if dev.type != "cuda":
        return _K12_SMS_OFF_CARD
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _k12_operands(sads: torch.Tensor, lam: int, blocks=None):
    """K12's operands in its entry's order (csrc/me_winner.cu `win_args`):
    (input tensors, output tensors, ints without the phase); the counts
    zeroed, the rest freshly allocated on the table's device.  `blocks`:
    the most blocks a launch (None: `_K12_BLOCKS_PER_SM` an SM)."""
    if sads.dim() != 4 or sads.shape[-1] != _NN or not sads.numel():
        raise ValueError(f"_int_winner: a SAD table [S, R, C, {_NN}], got "
                         f"{tuple(sads.shape)}")
    s, r, c, _ = sads.shape
    dev = sads.device
    if blocks is None:
        blocks = _k12_sms(dev) * _K12_BLOCKS_PER_SM
    ins = [sads.to(I32).contiguous()]
    outs = [torch.zeros((s, _NN), dtype=I32, device=dev)]
    outs += [torch.empty((s, r, c), dtype=I32, device=dev) for _ in range(2)]
    outs += [torch.empty(s, dtype=I32, device=dev) for _ in range(2)]
    return ins, outs, [s, r, c, int(lam), int(blocks)]


def _k12_launch(sads: torch.Tensor, lam: int, group=None, blocks=None):
    """K12's two launches (see `_int_winner`; `blocks` as
    `_k12_operands`'); raises on a bad input or a failed build or
    launch."""
    ins, outs, ints = _k12_operands(sads, lam, blocks)
    dev = sads.device
    cuda_lib.check_inputs("_int_winner", dev, [(ins[0], ins[0].shape)])
    lib = cuda_lib.load()
    ptrs = cuda_lib.pointers(ins + outs)
    for phase in (1, 2):
        if phase == 2 and group is not None:
            all_reduce(outs[0], group)
        err = lib.th264_me_winner(ptrs, cuda_lib.ints(ints + [phase]),
                                  cuda_lib.stream(dev))
        cuda_lib.check(err, "th264_me_winner")
    return tuple(outs[1:])


def _int_winner_plain(sads: torch.Tensor, lam: int, group=None):
    """Plain version of `_int_winner` (same arguments)."""
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
    by per-MB gathers at the (plane, offset) the fraction selects and
    widened to int32 before the sum (the planes are uint8)."""
    s, r, c = mvx.shape
    _, _, hp, wp = planes4.shape
    dev = mvx.device
    lut = tables.get("qpel_lut", dev)[((mvy & 3) * 4 + (mvx & 3)).long()]
    oy, ox = _mb_origin(s, r, c, 16, dev)
    y0 = oy + (mvy >> 2).long() + _PE
    x0 = ox + (mvx >> 2).long() + _PE
    k = torch.arange(16, device=dev)
    sidx = torch.arange(s, device=dev).view(s, 1, 1, 1, 1)
    comps = []
    for i in range(2):
        pl, dy, dx = lut[..., i, 0], lut[..., i, 1], lut[..., i, 2]
        rows = ((y0 + dy)[..., None] + k).clamp(0, hp - 1)
        cols = ((x0 + dx)[..., None] + k).clamp(0, wp - 1)
        comps.append(planes4[pl[..., None, None], sidx, rows[..., :, None],
                             cols[..., None, :]].to(I32))
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
    """Per reference of the DPB refs_y [N, S, Hs, W], refs_u / refs_v [N,
    S, Hcs, W/2] (int32 or uint8, samples 0..255; or each a sequence of
    the N references' [S, ...] planes, newest first, e.g. the slots of a
    DPB ring): the stacked half-pel planes [4, S, Hp, Wp] (G, b, h, j; pad
    _PE) and the chroma planes [S, Hcp, Wcp] (pad _CP), as three lists.
    Without `halo` the frame's edge rows stand in for the halo (the
    normative Clip3 clamp); with it the references arrive extended by
    HALO_Y / HALO_C rows a side.

    The planes are uint8 views of one [N, 4, S, Hp, pitch] and one [N, 2,
    S, Hcp, pitch_c] buffer (`_plane_buffers`): every row starts 16-byte
    aligned, its pitch the plane's width rounded up to 16 bytes; the bytes
    past the width are no samples.  Both routes return that layout.

    CPU tensors take the plain version; CUDA tensors launch K11
    (csrc/halfpel.cu, one launch over all N references, each read by its
    own pointer) or raise."""
    if refs_y[0].device.type == "cpu":
        return _references_plain(refs_y, refs_u, refs_v, halo)
    out = _k11_launch(refs_y, refs_u, refs_v, halo)
    _references.launches += 1
    return out


_references.launches = 0  # launches of K11


def _pitch(width: int) -> int:
    """A plane row's bytes: `width` rounded up to a multiple of 16."""
    return -(-width // 16) * 16


def _plane_buffers(n: int, s: int, hp: int, wp: int, hcp: int, wcp: int,
                   device):
    """The uninitialised uint8 buffers of N references' planes: luma [N,
    4, S, Hp, _pitch(Wp)] and chroma [N, 2, S, Hcp, _pitch(Wcp)]."""
    u8 = torch.uint8
    return (torch.empty((n, 4, s, hp, _pitch(wp)), dtype=u8, device=device),
            torch.empty((n, 2, s, hcp, _pitch(wcp)), dtype=u8, device=device))


def _plane_views(luma: torch.Tensor, chroma: torch.Tensor, wp: int,
                 wcp: int):
    """`_references`' three lists: the views of `_plane_buffers`' buffers
    that hold samples (the first wp / wcp bytes of every row)."""
    n = luma.shape[0]
    return ([luma[i, ..., :wp] for i in range(n)],
            [chroma[i, 0, :, :, :wcp] for i in range(n)],
            [chroma[i, 1, :, :, :wcp] for i in range(n)])


def _k11_operands(refs_y, refs_u, refs_v, halo: bool):
    """K11's operands in its entry's order (csrc/halfpel.cu `ref_args`):
    (input tensors -- _MAX_REFS of each plane, None past the N references
    --, output tensors -- `_plane_buffers`' two --, ints); the outputs
    freshly allocated on the inputs' device.  Raises where the planes
    disagree."""
    name = "_references"
    ys, us, vs = list(refs_y), list(refs_u), list(refs_v)
    n = len(ys)
    if not 1 <= n <= _MAX_REFS or len(us) != n or len(vs) != n or any(
            x.dim() != 3 for x in ys + us + vs):
        raise ValueError(f"{name}: 1 to {_MAX_REFS} references of [S, H, "
                         f"W] planes, got {[tuple(x.shape) for x in ys]}")
    s, hs, w = ys[0].shape
    hcs, wc = us[0].shape[-2:]
    oy, oyc = (0, 0) if halo else (HALO_Y, HALO_C)
    h = hs - 2 * (HALO_Y - oy)
    if (not n * s * hs * w or h <= 0 or h % 2 or w % 16
            or tuple(us[0].shape) != (s, h // 2 + 2 * (HALO_C - oyc),
                                      w // 2)
            or any(x.shape != ys[0].shape for x in ys)
            or any(x.shape != us[0].shape for x in us + vs)):
        raise ValueError(f"{name}: references {[tuple(x.shape) for x in ys]}"
                         f", {[tuple(x.shape) for x in us + vs]} (halo "
                         f"{halo}) are no DPB")
    u8 = all(x.dtype == torch.uint8 for x in ys + us + vs)
    fill = [None] * (_MAX_REFS - n)
    ins = [None if x is None else x.contiguous() if u8
           else x.to(I32).contiguous() for p in (ys, us, vs) for x in p + fill]
    hp, wp, hcp, wcp = hs + 2 * oy, w + 2 * _PE, hcs + 2 * oyc, wc + 2 * _CP
    outs = list(_plane_buffers(n, s, hp, wp, hcp, wcp, ys[0].device))
    return ins, outs, [n, s, hs, w, oy, hcs, wc, oyc, int(u8),
                       outs[0].shape[-1], outs[1].shape[-1]]


def _k11_launch(refs_y, refs_u, refs_v, halo: bool):
    """One launch of K11 (see `_references`); raises on a bad input (a
    reference plane not 16-byte aligned among them: the kernel reads
    them 8 and 16 bytes at a time) or a failed build or launch."""
    ins, outs, ints = _k11_operands(refs_y, refs_u, refs_v, halo)
    live = [x for x in ins if x is not None]
    cuda_lib.check_inputs("_references", live[0].device, [
        (x, x.shape) for x in live], dtype=live[0].dtype)
    if any(x.data_ptr() % 16 for x in live):
        raise ValueError("_references: every reference plane must be "
                         "16-byte aligned")
    err = cuda_lib.load().th264_halfpel_refs(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(live[0].device))
    cuda_lib.check(err, "th264_halfpel_refs")
    return _plane_views(*outs, ints[3] + 2 * _PE, ints[6] + 2 * _CP)


def _references_plain(refs_y, refs_u, refs_v, halo: bool):
    """Plain version of `_references` (same arguments): the references
    stacked newest first, the edge pad, then per reference
    `build_halfpel_planes_ext` and `_pad_ref_ext` in int32, narrowed to
    uint8 into `_plane_buffers`' layout."""
    refs_y, refs_u, refs_v = (x if torch.is_tensor(x) else torch.stack(
        list(x)) for x in (refs_y, refs_u, refs_v))
    if not halo:
        refs_y = _edge_pad(refs_y, HALO_Y, 0)
        refs_u = _edge_pad(refs_u, HALO_C, 0)
        refs_v = _edge_pad(refs_v, HALO_C, 0)
    n, s, hp, w = refs_y.shape
    hcp, wc = refs_u.shape[-2:]
    wp, wcp = w + 2 * _PE, wc + 2 * _CP
    luma, chroma = _plane_buffers(n, s, hp, wp, hcp, wcp, refs_y.device)
    for i in range(n):
        luma[i, ..., :wp] = torch.stack(build_halfpel_planes_ext(refs_y[i]))
        chroma[i, 0, ..., :wcp] = _pad_ref_ext(refs_u[i], _CP)
        chroma[i, 1, ..., :wcp] = _pad_ref_ext(refs_v[i], _CP)
    return _plane_views(luma, chroma, wp, wcp)


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
    """The intra-in-P column scan (D4): left to right along each MB row,
    the Intra_16x16 candidate of every MB (predicted from the left MB's
    final reconstruction, intra or inter) replaces the inter choice when
    its luma SAD is strictly below the inter SAD.  Only the decision and
    the reconstruction chain are sequential; the symbols are assembled
    batched afterwards.  Returns (use_intra [S,R,C], the stacked
    `iframe.Intra16` fields [S,R,C,...] with rec None, final int32
    recon [S,R,C,16,16], [S,R,C,8,8] x 2).

    CPU tensors take the plain version; CUDA tensors launch K6
    (csrc/intra16_enc.cu, the I encode's kernel with the inter choice)
    or raise.  The kernel's levels are int16 (the plain version's int32:
    the same values, which the symbols store as int16)."""
    if inter_sad.device.type == "cpu":
        return _intra_in_p_scan_plain(src_mbs, u_mbs, v_mbs, inter_sad,
                                      rec_inter, qp, qpc)
    o = _intra16_launch("_intra_in_p_scan", [
        _mbs_to_plane(x) for x in (src_mbs, u_mbs, v_mbs)], qp, qpc,
        inter_sad, rec_inter)
    _intra_in_p_scan.launches += 1
    s, r, c = inter_sad.shape
    return o.use, Intra16(
        o.mode, o.cmode, o.sad, o.luma_dc, o.luma_ac.view(s, r, c, 4, 4, 16),
        o.cbp_luma, o.chroma_dc, o.chroma_ac, o.cbp_chroma, None), o.rec


_intra_in_p_scan.launches = 0  # launches of K6 for D4


def _intra_in_p_scan_plain(src_mbs, u_mbs, v_mbs, inter_sad, rec_inter,
                           qp: int, qpc: int):
    """Plain version of `_intra_in_p_scan` (same arguments): a Python
    loop of `iframe._intra16_mb` over the MB columns, batched over
    [S, R]."""
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


class InterEnc(NamedTuple):
    """What the P encode's inter part (`_inter_encode`, K9) returns per MB
    [S, R, C]: the chosen motion, reference and SAD, the symbols of the
    inter coding, and its reconstruction."""

    mvx: torch.Tensor         # int32 quarter-pel
    mvy: torch.Tensor
    refsel: torch.Tensor      # int32 reference index among the N
    sad: torch.Tensor         # int32 luma SAD of the chosen prediction
    kind: torch.Tensor        # int32 KIND_SKIP / KIND_INTER
    refidx: torch.Tensor      # int32 0 for a skip, else refsel + ref_base
    cbp_luma: torch.Tensor    # int32 4-bit
    cbp_chroma: torch.Tensor  # int32 0..2
    luma_ac: torch.Tensor     # [S,R,C,16,16] int16 zigzag, blocks raster
    chroma_dc: torch.Tensor   # [S,R,C,2,4] int16
    chroma_ac: torch.Tensor   # [S,R,C,2,4,15] int16
    t8: torch.Tensor          # int32 1 where the 8x8 transform was chosen
    rec: Tuple[torch.Tensor, ...]  # int32 MBs (intra_in_p) or uint8 planes


def _inter_encode(y32, u, v, planes_l, refs_up, refs_vp, iy0, ix0, gy, gx,
                  qp: int, ref_base: int, t8: bool, intra_in_p: bool,
                  out: Optional[MBSymbolsP] = None) -> InterEnc:
    """The P encode after stage A, over every reference at once: from the
    stage-A winners iy0, ix0 [N, S, R, C] and global vectors gy, gx [N, S]
    (int32), the source y32 [S, H, W] int32, u, v and the references'
    planes (`_references`), stages B-D per reference, the reference
    choice, MC, the inter transforms, the reconstruction (int32 MBs with
    `intra_in_p`, for the intra-in-P scan; else uint8 planes) and P_Skip.

    CPU tensors take the plain version; CUDA tensors launch K9
    (csrc/pframe_enc.cu; with `t8`, the 8x8 transform's choice of the
    CABAC + 8x8 session path, its t8 route) or raise.  With `out` (views
    of the frame's symbols, `empty_symbols`), K9 writes its fields there
    and completes them: the mvds, mode, cmode, t8 and luma_dc; the
    result's fields are then out's own tensors.  The plain version leaves
    `out` to its caller."""
    if y32.device.type == "cpu":
        return _inter_encode_plain(y32, u, v, planes_l, refs_up, refs_vp,
                                   iy0, ix0, gy, gx, qp, ref_base, t8,
                                   intra_in_p)
    res = _k9_launch(y32, u, v, planes_l, refs_up, refs_vp, iy0, ix0, gy,
                     gx, qp, ref_base, intra_in_p, out, t8)
    _inter_encode.launches += 1
    _inter_encode.t8_launches += int(t8)
    return res


_inter_encode.launches = 0  # launches of K9
_inter_encode.t8_launches = 0  # ... of them its t8 route


_MAX_REFS = 16  # the kernels' kMaxRefs: H.264's most references


def _ref_planes(planes_l, refs_up, refs_vp):
    """The references' planes as a kernel entry lists them: _MAX_REFS of
    each kind, the unused ones repeating reference 0's."""
    fill = lambda x: list(x) + [x[0]] * (_MAX_REFS - len(x))
    return fill(planes_l) + fill(refs_up) + fill(refs_vp)


def _check_refs(name, dev, planes_l, refs_up, refs_vp, s, h: int, w: int):
    """Raise unless there are 1 to _MAX_REFS references whose planes have
    the geometry and the layout `_references` gives (pads _PE and _CP,
    uint8, 16-byte aligned rows, one pitch for every luma plane and one
    for every chroma plane) for [s, h, w] frames."""
    n = len(planes_l)
    if not 1 <= n <= _MAX_REFS or len(refs_up) != n or len(refs_vp) != n:
        raise ValueError(f"{name}: 1 to {_MAX_REFS} references, got {n}")
    luma = (4, s, h + 2 * _PE, w + 2 * _PE)
    chroma = (s, h // 2 + 2 * _CP, w // 2 + 2 * _CP)
    lp = {cuda_lib.check_plane(name, dev, p, luma) for p in planes_l}
    cp = {cuda_lib.check_plane(name, dev, p, chroma)
          for p in (*refs_up, *refs_vp)}
    if len(lp) != 1 or len(cp) != 1:
        raise ValueError(f"{name}: the references' planes differ in pitch "
                         f"(luma {sorted(lp)}, chroma {sorted(cp)})")


def _k9_operands(y32, u, v, planes_l, refs_up, refs_vp, iy0, ix0, gy, gx,
                 qp: int, ref_base: int, intra_in_p: bool,
                 out: Optional[MBSymbolsP] = None, t8: bool = False,
                 pairs: Optional[torch.Tensor] = None):
    """K9's operands in its entry's order (csrc/pframe_enc.cu `enc_args`):
    (input tensors, output tensors, ints); the outputs freshly allocated
    on the inputs' device, or, with `out`, the symbol fields out's
    tensors (then also its mvdx, mvdy, mode, cmode, t8 and luma_dc; else
    those six are None, null pointers, but t8, which the t8 route writes
    into a tensor of its own), and last the mvds' pair slots: `pairs`
    (int64, one a MB, zero) or `_mvd_pairs`' (None without `out`).  `t8`
    and lam8 are the last two ints."""
    s, h, w = y32.shape
    r, c = h // 16, w // 16
    n = len(planes_l)
    dev = y32.device
    mb = (s, r, c)
    i32 = lambda *sh: torch.empty(sh, dtype=I32, device=dev)
    lev = lambda *sh: torch.empty((*mb, *sh), dtype=torch.int16, device=dev)
    outs = [i32(*mb) for _ in range(8)] + [lev(16, 16), lev(2, 4),
                                           lev(2, 4, 15)]
    if out is not None:
        outs[4:] = [out.kind, out.refidx, out.cbp_luma, out.cbp_chroma,
                    out.luma_ac, out.chroma_dc, out.chroma_ac]
    if intra_in_p:
        outs += [i32(*mb, 16, 16), i32(*mb, 8, 8), i32(*mb, 8, 8)]
    else:
        outs += [torch.empty(sh, dtype=torch.uint8, device=dev) for sh in
                 ((s, h, w), (s, h // 2, w // 2), (s, h // 2, w // 2))]
    lam = int(LAMBDA_ME[min(max(qp, 0), 51)])
    ref_cost = [lam * ref_idx_bits(k + ref_base, ref_base + n)
                for k in range(n)] + [0] * (_MAX_REFS - n)
    src = [x if x.data_ptr() % 16 == 0 else x.clone()  # 16-byte loads
           for x in (y32, u.to(I32).contiguous(), v.to(I32).contiguous())]
    ins = [*src, iy0, ix0, gy, gx, *_ref_planes(planes_l, refs_up, refs_vp)]
    ints = [s, r, c, n, h + 2 * _PE, w + 2 * _PE, h // 2 + 2 * _CP,
            w // 2 + 2 * _CP, _PE, _CP, qp, T.chroma_qp_from_luma(qp), lam,
            ref_base, int(intra_in_p), planes_l[0].stride(-2),
            refs_up[0].stride(-2), *ref_cost]
    outs += ([None] * 4 + [i32(*mb) if t8 else None, None] if out is None
             else [out.mvdx, out.mvdy, out.mode, out.cmode, out.t8,
                   out.luma_dc])
    if out is not None and pairs is None:
        pairs = _mvd_pairs(dev, s * r * c)
    outs.append(None if out is None else pairs)
    ints += [int(t8), _LAMBDA8[min(max(qp, 0), 51)]]
    return ins, outs, ints


_PAIRS = {}  # (device, stream) -> K9's mvd pair slots


def _mvd_pairs(dev: torch.device, mbs: int) -> torch.Tensor:
    """K9's pair slots for `mbs` MBs on `dev`'s current stream: one int64
    a MB, allocated zeroed once per device and stream (again only for a
    larger frame).  Every launch leaves them zero, so the launches of a
    stream, which run in order, share them."""
    key = (dev, cuda_lib.stream(dev).value if dev.type == "cuda" else None)
    buf = _PAIRS.get(key)
    if buf is None or buf.numel() < mbs:
        buf = _PAIRS[key] = torch.zeros(mbs, dtype=torch.int64, device=dev)
    return buf[:mbs]


def _k9_launch(y32, u, v, planes_l, refs_up, refs_vp, iy0, ix0, gy, gx,
               qp: int, ref_base: int, intra_in_p: bool,
               out: Optional[MBSymbolsP] = None,
               t8: bool = False) -> InterEnc:
    """One launch of K9 (see `_inter_encode`); raises on a bad input or a
    failed build or launch."""
    name = "encode_pframe_rows_multi"
    s, h, w = y32.shape
    r, c = h // 16, w // 16
    if not s * r * c or h % 16 or w % 16:
        raise ValueError(f"{name}: frames {tuple(y32.shape)} hold no whole MB")
    if not 0 <= qp <= 51:
        raise ValueError(f"{name}: QP {qp} outside 0..51")
    dev = y32.device
    _check_refs(name, dev, planes_l, refs_up, refs_vp, s, h, w)
    ins, outs, ints = _k9_operands(y32, u, v, planes_l, refs_up, refs_vp,
                                   iy0, ix0, gy, gx, qp, ref_base,
                                   intra_in_p, out, t8)
    n, mb = len(planes_l), (s, r, c)
    if out is not None:
        _check_symbols(name, dev, out, mb)
    cuda_lib.check_inputs(name, dev, [
        (ins[0], (s, h, w)), (ins[1], (s, h // 2, w // 2)),
        (ins[2], (s, h // 2, w // 2)), (iy0, (n, *mb)), (ix0, (n, *mb)),
        (gy, (n, s)), (gx, (n, s))])
    err = cuda_lib.load().th264_pframe_encode(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(dev))
    cuda_lib.check(err, "th264_pframe_encode")
    return InterEnc(*outs[:11],
                    torch.zeros_like(outs[0]) if outs[18] is None
                    else outs[18], tuple(outs[11:14]))


def resident_warps() -> dict:
    """The warps an SM of K9's and K10's routes that can be resident at
    once on the card (the runtime's occupancy of their launches): {"K9",
    "K9-t8", "K10", "K10-t8": warps}."""
    lib, out = cuda_lib.load(), {}
    for key, fn in (("K9", lib.th264_pframe_encode_resident),
                    ("K10", lib.th264_pframe_decode_resident)):
        got = (ctypes.c_int * 2)()
        cuda_lib.check(fn(got), fn.__name__)
        out[key], out[f"{key}-t8"] = got[0], got[1]
    return out


def empty_symbols(lead, r: int, c: int, device) -> MBSymbolsP:
    """Uninitialised MBSymbolsP buffers [*lead, R, C, ...] (every field,
    refidx and t8 included) in their final types, e.g. a dispatch's P
    frames' [P * S, R, C] that the P encode fills frame by frame."""
    mb = (*lead, r, c)
    i32 = lambda: torch.empty(mb, dtype=I32, device=device)
    lev = lambda *sh: torch.empty((*mb, *sh), dtype=torch.int16,
                                  device=device)
    return MBSymbolsP(
        kind=i32(), mode=i32(), cmode=i32(), cbp_luma=i32(),
        cbp_chroma=i32(), mvdx=i32(), mvdy=i32(), luma_dc=lev(16),
        luma_ac=lev(16, 16), chroma_dc=lev(2, 4), chroma_ac=lev(2, 4, 15),
        refidx=i32(), t8=i32())


_SYM_INNER = dict(luma_dc=(16,), luma_ac=(16, 16), chroma_dc=(2, 4),
                  chroma_ac=(2, 4, 15))


def _check_symbols(name, dev, out: MBSymbolsP, mb) -> None:
    """Raise unless `out` holds every MBSymbolsP field for the MBs `mb` as
    `empty_symbols` makes them: contiguous, int32 or int16, the level
    arrays 16-byte aligned (K9 stores them 16 bytes at a time)."""
    cuda_lib.check_inputs(name, dev, [
        (getattr(out, f), mb) for f in MBSymbolsP._fields
        if f not in _SYM_INNER])
    lev = [(getattr(out, f), (*mb, *sh)) for f, sh in _SYM_INNER.items()]
    cuda_lib.check_inputs(name, dev, lev, dtype=torch.int16)
    if any(x.data_ptr() % 16 for x, _ in lev):
        raise ValueError(f"{name}: the symbols' level arrays must be "
                         "16-byte aligned")


def _inter_encode_plain(y32, u, v, planes_l, refs_up, refs_vp, iy0, ix0,
                        gy, gx, qp: int, ref_base: int, t8: bool,
                        intra_in_p: bool) -> InterEnc:
    """Plain version of `_inter_encode` (same arguments): per reference
    the batched stages B-D, the choice among the references, then MC,
    the transforms (with `t8`, the 8x8 choice) and P_Skip batched over
    [S, R, C]."""
    qpc = T.chroma_qp_from_luma(qp)
    n_refs = len(planes_l)
    s, h, w = y32.shape
    r, c = h // 16, w // 16
    lam = int(LAMBDA_ME[min(max(qp, 0), 51)])
    src_mbs = _plane_to_mbs(y32, 16)
    u_mbs = _plane_to_mbs(u.to(I32), 8)
    v_mbs = _plane_to_mbs(v.to(I32), 8)

    mvx = mvy = inter_sad = inter_cost = refsel = None
    for n in range(n_refs):
        gqx = (4 * gx[n])[:, None, None]
        gqy = (4 * gy[n])[:, None, None]
        iy, ix = _int_refine(planes_l[n][0], src_mbs, iy0[n], ix0[n], lam,
                             gqx, gqy)
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
    rec = (rec_y, rec_u, rec_v)
    if not intra_in_p:
        rec = tuple(_mbs_to_plane(x.to(torch.uint8)) for x in rec)
    i16 = torch.int16
    return InterEnc(
        mvx.to(I32), mvy.to(I32), refsel.to(I32), inter_sad.to(I32),
        torch.where(skip, KIND_SKIP, KIND_INTER).to(I32),
        torch.where(skip, 0, refsel + ref_base).to(I32), cbp_l.to(I32),
        cbp_c.to(I32), l_zz.reshape(s, r, c, 16, 16).to(i16), cdc.to(i16),
        cac.to(i16), torch.where(skip, 0, use_t8.to(I32)).to(I32), rec)


def encode_pframe_rows_multi(
    y, u, v, refs_y, refs_u, refs_v, qp: int, ref_base: int = 0,
    halo: bool = False, t8: bool = False, intra_in_p: bool = True,
    group=None, out: Optional[MBSymbolsP] = None,
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
    encode.

    Stage A (K1 and `_int_winner`) runs for every reference first, then
    the rest at once (`_inter_encode`: K9 on the card).

    `out` (`empty_symbols` buffers [S, R, C, ...], e.g. views of a
    dispatch's) receives the symbols, which are then returned: on the
    card without `intra_in_p` K9 writes them there itself; on
    the other routes they are assembled as before and copied in."""
    qpc = T.chroma_qp_from_luma(qp)
    n_refs = len(refs_y)
    s, h, w = y.shape
    r, c = h // 16, w // 16
    lam = int(LAMBDA_ME[min(max(qp, 0), 51)])
    planes_l, refs_up, refs_vp = _references(refs_y, refs_u, refs_v, halo)
    y32 = y.to(I32).contiguous()

    # ---- stage A per reference, batched over all MBs ----
    iy0, ix0, gy, gx = (torch.stack(f) for f in zip(*[
        _int_winner(me_cuda.sad_field(y32, planes_l[n][0]), lam, group)
        for n in range(n_refs)]))
    o = _inter_encode(y32, u, v, planes_l, refs_up, refs_vp, iy0, ix0, gy,
                      gx, qp, ref_base, t8, intra_in_p,
                      None if intra_in_p else out)
    if out is not None and o.kind is out.kind:  # K9 wrote every field
        return out, o.rec, (o.mvx, o.mvy)

    zero = torch.zeros_like(o.mvx)
    fields = dict(kind=o.kind, mode=zero, cmode=zero, cbp_luma=o.cbp_luma,
                  cbp_chroma=o.cbp_chroma,
                  luma_dc=torch.zeros((s, r, c, 16), dtype=torch.int16,
                                      device=y.device),
                  luma_ac=o.luma_ac, chroma_dc=o.chroma_dc,
                  chroma_ac=o.chroma_ac, refidx=o.refidx, t8=o.t8)
    mvx, mvy, rec = o.mvx, o.mvy, o.rec
    if intra_in_p:
        use, intra, rec = _intra_in_p_scan(
            _plane_to_mbs(y32, 16), _plane_to_mbs(u.to(I32), 8),
            _plane_to_mbs(v.to(I32), 8), o.sad, rec, qp, qpc)
        sel = {0: use}
        for d in range(1, 4):
            sel[d] = sel[d - 1][..., None]
        for name, val in (("mode", intra.mode), ("cmode", intra.cmode),
                          ("cbp_luma", intra.cbp_luma),
                          ("cbp_chroma", intra.cbp_chroma),
                          ("luma_dc", intra.dc_zz),
                          ("luma_ac", intra.ac_zz.reshape(s, r, c, 16, 16)),
                          ("chroma_dc", intra.chroma_dc),
                          ("chroma_ac", intra.chroma_ac),
                          ("kind", KIND_INTRA), ("refidx", 0),
                          ("t8", 0)):
            old = fields[name]
            fields[name] = torch.where(sel[old.dim() - 3], val, old)
        mvx = torch.where(use, 0, mvx)
        mvy = torch.where(use, 0, mvy)
        rec = tuple(_mbs_to_plane(x.to(torch.uint8)) for x in rec)
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
        luma_ac=fields["luma_ac"].to(i16),
        chroma_dc=fields["chroma_dc"].to(i16),
        chroma_ac=fields["chroma_ac"].to(i16),
        refidx=fields["refidx"].to(I32),
        t8=fields["t8"].to(I32),
    )
    if out is not None:
        for dst, src in zip(out, symbols):
            dst.copy_(src)
        symbols = out
    return symbols, rec, (mvx.to(I32), mvy.to(I32))


def _mv_chain(g: torch.Tensor, mvd: torch.Tensor) -> torch.Tensor:
    """mv_c = g_c * (mv_{c-1} + mvd_c) along the MB columns (g in {0,1}):
    a cumulative sum restarted after every g = 0."""
    cs = torch.cumsum(g * mvd, dim=-1, dtype=I32)
    idx = torch.arange(g.shape[-1], device=g.device).expand_as(g)
    last0 = torch.cummax(torch.where(g == 0, idx, -1), dim=-1).values
    base = torch.where(last0 >= 0, cs.gather(-1, last0.clamp(min=0)), 0)
    return (g * (cs - base)).to(I32)


def _inter_decode(symbols: MBSymbolsP, planes_l, refs_up, refs_vp,
                  qp: int, t8: bool):
    """The P decode's inter reconstruction from parsed symbols: the MV
    chain, MC from each MB's reference, the inter residuals.  Returns
    (int32 recon [S,R,C,16,16], [S,R,C,8,8] x 2 of every MB, as if inter:
    `_intra_recon_scan`'s `other`; (mvx, mvy) [S, R, C], zero for skip
    and intra MBs).

    CPU tensors take the plain version; CUDA tensors launch K10
    (csrc/pframe_dec.cu; with `t8`, the CABAC + 8x8 session path, its t8
    route) or raise."""
    if symbols.kind.device.type == "cpu":
        return _inter_decode_plain(symbols, planes_l, refs_up, refs_vp, qp,
                                   t8)
    out = _k10_launch(symbols, planes_l, refs_up, refs_vp, qp, t8)
    _inter_decode.launches += 1
    _inter_decode.t8_launches += int(t8)
    return out


_inter_decode.launches = 0  # launches of K10
_inter_decode.t8_launches = 0  # ... of them its t8 route


def _k10_operands(symbols: MBSymbolsP, planes_l, refs_up, refs_vp,
                  qp: int, t8: bool = False):
    """K10's operands in its entry's order (csrc/pframe_dec.cu
    `dec_args`): (input tensors, output tensors, ints).  Each symbol field
    goes as it lies with its MB stride (`iframe._mb_strided`: the GOP
    decode's record views, MB fields [.., 9] int32 and level slots [..,
    400] int16, take no copy), a copy only where a field is not so laid
    out, not of the kernel's type or not aligned (4 bytes, the levels 16).
    symbols.t8 is the last input (None, a null pointer, without `t8` or
    where the symbols hold none: the kernel then takes its route without
    t8), its MB stride int 14."""
    s, r, c = mb = tuple(symbols.kind.shape)
    dev = symbols.kind.device
    refidx = (symbols.refidx if symbols.refidx is not None
              else torch.zeros(mb, dtype=I32, device=dev))
    fields = [_mb_strided(x, mb, (), I32, 4) for x in (
        symbols.kind, symbols.mvdx, symbols.mvdy, refidx, symbols.cbp_luma,
        symbols.cbp_chroma)]
    fields += [_mb_strided(x, mb, inner, torch.int16, 16)
               for x, inner in ((symbols.luma_ac, (16, 16)),
                                (symbols.chroma_dc, (2, 4)),
                                (symbols.chroma_ac, (2, 4, 15)))]
    t8f, st8 = ((None, 1) if not t8 or symbols.t8 is None
                else _mb_strided(symbols.t8, mb, (), I32, 4))
    ins = ([x for x, _ in fields] + _ref_planes(planes_l, refs_up, refs_vp)
           + [t8f])
    outs = [torch.empty((*mb, k, k), dtype=I32, device=dev)
            for k in (16, 8, 8)]
    outs += [torch.empty(mb, dtype=I32, device=dev) for _ in range(2)]
    h, w = 16 * r, 16 * c
    ints = [s, r, c, len(planes_l), h + 2 * _PE, w + 2 * _PE,
            h // 2 + 2 * _CP, w // 2 + 2 * _CP, _PE, _CP, qp,
            T.chroma_qp_from_luma(qp), planes_l[0].stride(-2),
            refs_up[0].stride(-2), st8, *[k for _, k in fields]]
    return ins, outs, ints


def _k10_launch(symbols: MBSymbolsP, planes_l, refs_up, refs_vp, qp: int,
                t8: bool = False):
    """One launch of K10 (see `_inter_decode`); raises on a bad input or a
    failed build or launch."""
    name = "decode_pframe_rows_multi"
    s, r, c = mb = tuple(symbols.kind.shape)
    if not s * r * c:
        raise ValueError(f"{name}: no MB {mb}")
    if not 0 <= qp <= 51:
        raise ValueError(f"{name}: QP {qp} outside 0..51")
    dev = symbols.kind.device
    _check_refs(name, dev, planes_l, refs_up, refs_vp, s, 16 * r, 16 * c)
    ins, outs, ints = _k10_operands(symbols, planes_l, refs_up, refs_vp, qp,
                                    t8)
    for x in ins[:9] + [y for y in ins[-1:] if y is not None]:
        if x.device != dev:
            raise ValueError(f"{name}: symbols on {x.device}, not {dev}")
    err = cuda_lib.load().th264_pframe_decode(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(dev))
    cuda_lib.check(err, "th264_pframe_decode")
    return tuple(outs[:3]), tuple(outs[3:])


def _inter_decode_plain(symbols: MBSymbolsP, planes_l, refs_up, refs_vp,
                        qp: int, t8: bool):
    """Plain version of `_inter_decode` (same arguments): the MV chain by
    a cumulative sum with a running reset index, then MC and the inter
    residuals batched over [S, R, C] (with `t8`, the MBs whose symbols.t8
    is 1 through the 8x8 transform)."""
    qpc = T.chroma_qp_from_luma(qp)
    s, r, c = symbols.kind.shape
    kind = symbols.kind.to(I32)
    refidx = (symbols.refidx.to(I32) if symbols.refidx is not None
              else torch.zeros_like(kind))
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
    return (rec_y_inter, rec_u_inter, rec_v_inter), (mvx, mvy)


def decode_pframe_rows_multi(symbols: MBSymbolsP, refs_y, refs_u, refs_v,
                             qp: int, halo: bool = False, t8: bool = False):
    """Reconstruct P frames from parsed symbols and a DPB refs_*
    [N, S, H, W] (newest first; per-MB symbols.refidx; with `t8`, the
    MBs whose symbols.t8 is 1 reconstruct through the 8x8 transform).
    Returns (uint8 recon planes, (mvx, mvy)).  `halo`: the references
    arrive vertically pre-extended (a row-sharded DPB).  The inter part
    is `_inter_decode` (K10 on the card), the intra MBs'
    column scan `_intra_recon_scan` (K5)."""
    qpc = T.chroma_qp_from_luma(qp)
    planes_l, refs_up, refs_vp = _references(refs_y, refs_u, refs_v, halo)
    rec_inter, motion = _inter_decode(symbols, planes_l, refs_up, refs_vp,
                                      qp, t8)
    # ---- intra MBs: their residuals and left-neighbour prediction column
    # by column (inter MBs pass through as left neighbours) ----
    rec = _intra_recon_scan(symbols.mode.to(I32), symbols.cmode.to(I32),
                            symbols, qp, qpc, rec_inter,
                            symbols.kind == KIND_INTRA)
    recon = tuple(_mbs_to_plane(x.to(torch.uint8)) for x in rec)
    return recon, motion
