"""On-device CAVLC: symbol tensors -> slice payload bits, on the GPU.

Port of tpuh264/kernels/entropy_tpu.py (its counterpart on the TPU).
The stage (`encode_slices`, under `encode_bits_iframe` /
`encode_bits_pframe`) reads the symbols where they lie, in four launches:

  1. K13, `cavlc_prologue` (csrc/cavlc_prologue.cu): per chunk of every
     MB (MB header + I16 luma DC, 16 luma AC in z-order, 2 chroma DC, 8
     chroma AC) its nC (row-slice neighbour rules: left block, top block
     only within the MB), maxc, code_residual and presence, the MB's
     header slots, and each P row's trailing skip_run;
  2. K2's symbols entry, `cavlc_cuda.pack_symbols`: each chunk
     symbolised and packed from the symbols' level arrays;
  3. K3, `cavlc_cuda.merge_tree`: the 27 chunk strings of every MB
     merged into one;
  4. K3's slice entry, `cavlc_cuda.merge_slices`: per slice (one MB
     row), header + MBs (+ the trailing P skip_run) + the rbsp trailing
     bits, each read from its own buffer.

Each router takes its plain version for CPU tensors: `_prologue_plain`
(on `pframe_pack_inputs` / `iframe_pack_inputs`, the joined-buffer
stage's inputs), `_pack_symbols_plain`, `tree_merge`,
`_merge_slices_plain`.  The joined-buffer stage itself
(`pframe_slice_parts` / `iframe_slice_parts`, `_finish_slices`: K2's
block entry and K3 over [.., 27, 16] levels and joined slice strings)
stays for the tests and the smoke's K2 / K3 comparisons.

Byte-identical to the JAX version and to the host packers
(tests/test_torch_cavlc.py, tests/test_torch_cavlc_prologue.py).
Capacity caps (BLOCK_W / MB_W / SLICE_W words) are enforced by one
overflow flag a dispatch (int32 [1], set by the kernels), returned as a
device tensor; an overflowing dispatch is repacked on the host by the
pipeline.
"""

from __future__ import annotations

import numpy as np
import torch

from ..entropy import cavlc_tables as tbl
from . import cavlc_cuda, cuda_lib, tables
from .cavlc_cuda import M32, _bit_length, _i32, pack_blocks

I32 = torch.int32
BLOCK_W = 20    # 640 bits per residual block (incl. MB header slots)
MB_W = 128      # 4096 bits per MB
SLICE_W = 8192  # 32 KB per slice

tables.register("cbp_inter_inv", lambda: np.asarray(
    [tbl.CBP_INTER_INV[i] for i in range(48)], np.int64))
tables.register("maxc27_i", lambda: np.asarray(
    [16] + [15] * 16 + [4, 4] + [15] * 8, np.int32))


def _ue_slot(v: torch.Tensor):
    """(len, val) of Exp-Golomb ue(v)."""
    code = v.to(torch.int64) + 1
    return (2 * _bit_length(code) - 1).to(I32), code.to(I32)


def _se_val(v: torch.Tensor) -> torch.Tensor:
    """Exp-Golomb se(v) code number (9.1.1)."""
    return torch.where(v > 0, 2 * v - 1, -2 * v)


def _nc_grid(nnz: torch.Tensor, nb: int) -> torch.Tensor:
    """nnz [S, R, C, nb, nb] (by, bx per MB) -> nC per block, row-slice
    rules: left neighbour across MBs, top neighbour only within the MB."""
    s, r, c = nnz.shape[:3]
    grid = nnz.permute(0, 1, 3, 2, 4).reshape(s, nb * r, nb * c)
    na = torch.nn.functional.pad(grid, (1, 0))[:, :, :-1]
    nt = torch.nn.functional.pad(grid, (0, 0, 1, 0))[:, :-1, :]
    dev = nnz.device
    a_ok = (torch.arange(nb * c, device=dev) > 0)[None, None, :]
    b_ok = (torch.arange(nb * r, device=dev) % nb > 0)[None, :, None]
    nc = torch.where(a_ok & b_ok, (na + nt + 1) >> 1,
                     torch.where(a_ok, na, torch.where(b_ok, nt, 0)))
    return nc.reshape(s, r, nb, c, nb).permute(0, 1, 3, 2, 4)


def _shift_ac(levels15: torch.Tensor) -> torch.Tensor:
    """[..., 15] AC coefficients -> [..., 16] position-indexed vector."""
    return torch.nn.functional.pad(levels15, (0, 1))


def _chunk_levels(s, r, c, dc_lv, ac_vec, cdc, cac, nc_y, nc_u, nc_v):
    """The 27 chunks' levels [S,R,C,27,16] and nC [S,R,C,27]."""
    dev = dc_lv.device
    scan = tables.get("blk_scan", dev)
    ac_vec = ac_vec.reshape(s, r, c, 16, 16)[..., scan, :]
    cdc_vec = torch.nn.functional.pad(cdc, (0, 12))  # [S,R,C,2,16]
    cac_vec = _shift_ac(cac).reshape(s, r, c, 8, 16)
    levels27 = torch.cat([dc_lv[..., None, :], ac_vec, cdc_vec, cac_vec],
                         dim=-2).to(I32).contiguous()
    nc_flat = nc_y.reshape(s, r, c, 16)[..., scan]
    nc27 = torch.cat([
        nc_y[..., 0, 0][..., None], nc_flat,
        torch.full((s, r, c, 2), -1, dtype=nc_y.dtype, device=dev),
        nc_u.reshape(s, r, c, 4), nc_v.reshape(s, r, c, 4),
    ], dim=-1).to(I32).contiguous()
    return levels27, nc27


def _chunk_headers(slots_len, slots_val, s, r, c):
    """Header slots on chunk 0 only: [S,R,C,27,nh] lengths and values."""
    hl = torch.stack(slots_len, -1).to(I32)  # [S,R,C,nh]
    hv = torch.stack(slots_val, -1).to(I32)
    nh = hl.shape[-1]
    z = torch.zeros((s, r, c, 26, nh), dtype=I32, device=hl.device)
    return (torch.cat([hl[..., None, :], z], -2).contiguous(),
            torch.cat([hv[..., None, :], z], -2).contiguous())


def slice_strings(parts_w, parts_b):
    """K3's slice-level inputs: the per-slice string parts ([S,R,k,MB_W]
    int32 words, [S,R,k] bits, in slice order) joined along k, then the
    rbsp trailing string -- a stop bit and zeros up to the byte boundary,
    its length from the body's bit total -> (words [S,R,K,MB_W], bits
    [S,R,K], overflow bool tensor)."""
    body_bits = sum(b.sum(-1, dtype=I32) for b in parts_b)
    overflow = (body_bits > 32 * SLICE_W - 64).any()
    tl = 1 + ((8 - ((body_bits + 1) % 8)) % 8)
    t_w = torch.zeros((*body_bits.shape, 1, MB_W), dtype=I32,
                      device=body_bits.device)
    t_w[..., 0, 0] = -(1 << 31)  # word 0 = 1 << 31 (int32 view)
    return (torch.cat([*parts_w, t_w], -2),
            torch.cat([*parts_b, tl.to(I32)[..., None]], -1), overflow)


def _finish_slices(parts_w, parts_b):
    """One K3 call per dispatch: each slice's parts and its rbsp trailing
    bits -> (slice words [S,R,SLICE_W] int32 MSB-first, slice_bytes [S,R]
    int32, overflow bool tensor)."""
    words, bits, overflow = slice_strings(parts_w, parts_b)
    slice_w, slice_bits = cavlc_cuda.merge_tree(words, bits, SLICE_W)
    return slice_w, (slice_bits // 8).to(I32), overflow


def _merge_mbs(chunks_hw, chunks_bits, present):
    """Absent chunks become empty strings; K3 merges each MB's 27 chunks.
    Overflow: an MB past MB_W words, or a chunk past BLOCK_W words (its
    string was truncated by K2)."""
    chunks_bits = torch.where(present, chunks_bits, 0).contiguous()
    chunks_hw = torch.where(present[..., None], chunks_hw, 0).contiguous()
    mb_hw, mb_bits = cavlc_cuda.merge_tree(chunks_hw, chunks_bits, MB_W)
    overflow = ((mb_bits > 32 * MB_W).any()
                | (chunks_bits > 32 * BLOCK_W).any())
    return mb_hw, mb_bits, overflow


def _slice_parts(mb_hw, mb_bits, hdr_hw, hdr_len, tail=None):
    """Each slice's parts in order: its header, its MBs, and (P) the
    trailing skip_run string."""
    hdr_pad = torch.nn.functional.pad(hdr_hw.to(I32),
                                      (0, MB_W - hdr_hw.shape[-1]))
    parts_w = [hdr_pad[..., None, :], mb_hw]
    parts_b = [hdr_len.to(I32)[..., None], mb_bits]
    if tail is not None:
        parts_w.append(tail[0][..., None, :])
        parts_b.append(tail[1][..., None])
    return parts_w, parts_b


def iframe_pack_inputs(symbols):
    """K2's inputs for I slices: ((levels27, nc27, maxc27, hdr_l, hdr_v),
    code_residual, chunk presence [S,R,C,27])."""
    s, r, c = symbols.mode.shape
    dev = symbols.mode.device
    lac = symbols.luma_ac.to(I32).reshape(s, r, c, 4, 4, 16)
    cbp_l = symbols.cbp_luma.to(I32)
    cbp_c = symbols.cbp_chroma.to(I32)

    ac_nz = lac[..., 1:].ne(0).sum(-1, dtype=I32)  # [S,R,C,4,4]
    nc_y = _nc_grid(torch.where(cbp_l[..., None, None] == 1, ac_nz, 0), 4)
    cac = symbols.chroma_ac.to(I32)  # [S,R,C,2,4,15]
    cac_nz = cac.ne(0).sum(-1, dtype=I32).reshape(s, r, c, 2, 2, 2)
    coded_c = cbp_c[..., None, None] == 2
    nc_u = _nc_grid(torch.where(coded_c, cac_nz[..., 0, :, :], 0), 2)
    nc_v = _nc_grid(torch.where(coded_c, cac_nz[..., 1, :, :], 0), 2)

    mode = symbols.mode.to(I32)
    h1l, h1v = _ue_slot(1 + mode + 4 * cbp_c + 12 * cbp_l)  # mb_type
    h2l, h2v = _ue_slot(symbols.cmode.to(I32))
    one = torch.ones_like(h1l)  # mb_qp_delta se(0): one bit '1'
    hdr_l, hdr_v = _chunk_headers([h1l, h2l, one], [h1v, h2v, one], s, r, c)

    levels27, nc27 = _chunk_levels(
        s, r, c, symbols.luma_dc.to(I32), _shift_ac(lac[..., 1:]),
        symbols.chroma_dc.to(I32), cac, nc_y, nc_u, nc_v)
    maxc27 = tables.get("maxc27_i", dev).expand(s, r, c, 27).contiguous()
    code_res = torch.ones((s, r, c, 27), dtype=I32, device=dev)
    present = torch.cat([
        torch.ones((s, r, c, 1), dtype=torch.bool, device=dev),
        (cbp_l == 1)[..., None].expand(s, r, c, 16),
        (cbp_c >= 1)[..., None].expand(s, r, c, 2),
        (cbp_c == 2)[..., None].expand(s, r, c, 8),
    ], -1)
    return (levels27, nc27, maxc27, hdr_l, hdr_v), code_res, present


def iframe_slice_parts(symbols, hdr_hw, hdr_len):
    """K2 and the MB-level K3 on I symbols, then each slice's parts
    (`_slice_parts`) -> (parts_w, parts_b, overflow bool tensor)."""
    args, code_res, present = iframe_pack_inputs(symbols)
    chunks_hw, chunks_bits = pack_blocks(*args, BLOCK_W, 3,
                                         code_residual=code_res)
    del args
    mb_hw, mb_bits, overflow = _merge_mbs(chunks_hw, chunks_bits, present)
    parts_w, parts_b = _slice_parts(mb_hw, mb_bits, hdr_hw, hdr_len)
    return parts_w, parts_b, overflow


def pframe_pack_inputs(symbols, nra: int = 1):
    """K2's inputs for P slices: ((levels27, nc27, maxc27, hdr_l, hdr_v),
    code_residual, chunk presence [S,R,C,27], coded-MB marks [S,R,C])."""
    s, r, c = symbols.kind.shape
    dev = symbols.kind.device
    kind = symbols.kind.to(I32)
    coded = kind != 0
    intra = kind == 2
    inter = kind == 1
    lac = symbols.luma_ac.to(I32).reshape(s, r, c, 4, 4, 16)
    cbp_l = symbols.cbp_luma.to(I32)
    cbp_c = torch.where(coded, symbols.cbp_chroma.to(I32), 0)

    # nnz: intra counts slots 1..15 when cbp_luma==1; inter counts all 16
    # when the block's 8x8 group bit is set
    nz_intra = lac[..., 1:].ne(0).sum(-1, dtype=I32)
    nz_inter = lac.ne(0).sum(-1, dtype=I32)
    b4 = torch.arange(4, device=dev)
    i8 = (b4[:, None] // 2) * 2 + (b4[None, :] // 2)
    gbit = ((cbp_l[..., None, None] >> i8) & 1) == 1
    nnz_y = torch.where(
        intra[..., None, None] & (cbp_l[..., None, None] == 1), nz_intra,
        torch.where(inter[..., None, None] & gbit, nz_inter, 0))
    nc_y = _nc_grid(nnz_y, 4)
    cac = symbols.chroma_ac.to(I32)
    cac_nz = cac.ne(0).sum(-1, dtype=I32).reshape(s, r, c, 2, 2, 2)
    coded_c = cbp_c[..., None, None] == 2
    nc_u = _nc_grid(torch.where(coded_c, cac_nz[..., 0, :, :], 0), 2)
    nc_v = _nc_grid(torch.where(coded_c, cac_nz[..., 1, :, :], 0), 2)

    # ---- header slots (6 per MB, zero-length when absent) ----
    # coded: [skip_run] then intra: [mb_type][cmode][dqp]
    #                      inter: [ue(0)][mvdx][mvdy][cbp][dqp?]
    idxc = torch.arange(c, device=dev)
    marked = torch.where(coded, idxc, -1)
    prev = torch.cummax(torch.nn.functional.pad(marked, (1, 0), value=-1)
                        [..., :-1], -1).values
    h0l, h0v = _ue_slot(idxc - prev - 1)  # skip_run before this MB

    mode = symbols.mode.to(I32)
    cmode = symbols.cmode.to(I32)
    mvdx = symbols.mvdx.to(I32)
    mvdy = symbols.mvdy.to(I32)
    h1l, h1v = _ue_slot(torch.where(intra, 6 + mode + 4 * cbp_c + 12 * cbp_l,
                                    0))
    if nra > 1:
        # inter slot 1 becomes mb_type ue(0) ++ ref_idx_l0 te(v)
        refs = (symbols.refidx.to(I32) if symbols.refidx is not None
                else torch.zeros_like(mvdx))
        if nra == 2:
            te_l, te_v = torch.ones_like(refs), 1 - refs
        else:
            te_l, te_v = _ue_slot(refs)
        h1l = torch.where(intra, h1l, 1 + te_l)
        h1v = torch.where(intra, h1v, (1 << te_l) | te_v)
    h2l, h2v = _ue_slot(torch.where(intra, cmode, _se_val(mvdx)))
    # intra slot 3 is dqp: se(0) == ue(0), the same 1-bit code
    h3l, h3v = _ue_slot(torch.where(intra, 0, _se_val(mvdy)))
    cbp_sym = tables.get("cbp_inter_inv", dev)[(cbp_l | (cbp_c << 4)).long()]
    h4l, h4v = _ue_slot(cbp_sym)
    h4l = torch.where(inter, h4l, 0)
    h5l = torch.where(inter & ((cbp_l | cbp_c) > 0), 1, 0).to(I32)
    cg = coded.to(I32)
    hdr_l, hdr_v = _chunk_headers(
        [h0l * cg, h1l * cg, h2l * cg, h3l * cg, h4l * cg, h5l * cg],
        [h0v, h1v, h2v, h3v, h4v, torch.ones_like(h0v)], s, r, c)

    # ---- residual chunk levels (27 chunks, as the I-frame layout) ----
    dc_lv = torch.where(intra[..., None], symbols.luma_dc.to(I32), 0)
    ac_vec = torch.where(intra[..., None, None, None], _shift_ac(lac[..., 1:]),
                         lac)
    levels27, nc27 = _chunk_levels(s, r, c, dc_lv, ac_vec,
                                   symbols.chroma_dc.to(I32), cac,
                                   nc_y, nc_u, nc_v)
    maxc27 = torch.cat([
        torch.full((s, r, c, 1), 16, dtype=I32, device=dev),
        torch.where(intra, 15, 16).to(I32)[..., None].expand(s, r, c, 16),
        torch.full((s, r, c, 2), 4, dtype=I32, device=dev),
        torch.full((s, r, c, 8), 15, dtype=I32, device=dev),
    ], -1).contiguous()
    # inter/skip MBs have no luma-DC chunk: chunk 0 codes its header only
    code_res = torch.ones((s, r, c, 27), dtype=I32, device=dev)
    code_res[..., 0] = intra.to(I32)
    grp = torch.arange(16, device=dev) // 4  # z-order chunk -> 8x8 group
    pres_luma = torch.where(intra[..., None], (cbp_l == 1)[..., None],
                            ((cbp_l[..., None] >> grp) & 1) == 1) \
        & coded[..., None]
    present = torch.cat([
        coded[..., None], pres_luma,
        (cbp_c >= 1)[..., None].expand(s, r, c, 2),
        (cbp_c == 2)[..., None].expand(s, r, c, 8),
    ], -1)
    return (levels27, nc27, maxc27, hdr_l, hdr_v), code_res, present, marked


def pframe_slice_parts(symbols, hdr_hw, hdr_len, nra: int = 1):
    """K2 and the MB-level K3 on P symbols, then each slice's parts
    (`_slice_parts`, with the trailing skip_run) -> (parts_w, parts_b,
    overflow bool tensor)."""
    s, r, c = symbols.kind.shape
    dev = symbols.kind.device
    args, code_res, present, marked = pframe_pack_inputs(symbols, nra)
    chunks_hw, chunks_bits = pack_blocks(*args, BLOCK_W, 6,
                                         code_residual=code_res)
    del args, code_res
    mb_hw, mb_bits, overflow = _merge_mbs(chunks_hw, chunks_bits, present)

    t_word, tll = _trailing_run(marked, c)
    # single-word emission caps rows at 65534 MBs (ue > 32 bits)
    overflow = overflow | (tll > 32).any()
    t_hw = torch.zeros((s, r, MB_W), dtype=I32, device=dev)
    t_hw[..., 0] = t_word
    parts_w, parts_b = _slice_parts(mb_hw, mb_bits, hdr_hw, hdr_len,
                                    tail=(t_hw, tll))
    return parts_w, parts_b, overflow


def _trailing_run(marked, c: int):
    """Each slice's trailing skip_run from its coded-MB marks [..., C]
    (the column, -1 where skipped): (its ue(v) string as one MSB-first
    int32 word, its bit length) [...], both 0 where the last MB is
    coded."""
    trail = c - 1 - marked.amax(-1)
    tll, tlv = _ue_slot(trail)
    tll = torch.where(trail > 0, tll, 0)
    word = torch.where(
        trail > 0, (tlv.long() << torch.clamp(32 - tll, 0, 31).long()) & M32,
        0)
    return _i32(word), tll


def _prologue_plain(symbols, ovf, nra: int = 1, pslice: bool = True):
    """Plain version of `cavlc_prologue` (same arguments):
    `pframe_pack_inputs` / `iframe_pack_inputs` and `_trailing_run`, their
    chunk fields packed into the chunk ints."""
    if pslice:
        args, code_res, present, marked = pframe_pack_inputs(symbols, nra)
        intra = (symbols.kind == 2).to(I32)[..., None]
    else:
        args, code_res, present = iframe_pack_inputs(symbols)
        intra = torch.ones_like(code_res[..., :1])
    _, nc27, maxc27, hdr_l, hdr_v = args
    lead = code_res.shape[:-1]
    m = int(np.prod(lead))
    shift = torch.nn.functional.pad(intra.expand(*lead, 16), (1, 10))
    meta = ((nc27 + 1) | (maxc27 << 8) | (code_res << 13)
            | (present.to(I32) << 14) | (shift << 15))
    nh = hdr_l.shape[-1]
    tail = None
    if pslice:
        word, tll = _trailing_run(marked, lead[-1])
        ovf |= (tll > 32).any().to(I32)
        tail = torch.stack([word, tll.to(I32)], -1)
    return (meta.reshape(m, 27), hdr_l[..., 0, :].reshape(m, nh).contiguous(),
            hdr_v[..., 0, :].reshape(m, nh).contiguous(), tail)


_PRO_FIELDS = ("kind", "mode", "cmode", "cbp_luma", "cbp_chroma", "mvdx",
               "mvdy", "refidx")


def _k13_operands(symbols, ovf, nra: int = 1, pslice: bool = True):
    """K13's operands in its entry's order (csrc/cavlc_prologue.cu
    `pro_args`): (input tensors, output tensors, ints); the outputs
    freshly allocated, `ovf` last (set to 1 on an overflow).  I symbols
    have no kind, mvds and refidx (null pointers)."""
    lead = tuple(symbols.mode.shape)
    rows, c = int(np.prod(lead[:-1])), lead[-1]
    m = rows * c
    dev = symbols.mode.device
    fields = [getattr(symbols, f, None) for f in _PRO_FIELDS]
    if not pslice:  # MBSymbols: no kind, mvds or refidx
        fields = [None, *fields[1:5], None, None, None]
    ins = [None if x is None else x.to(I32).reshape(m).contiguous()
           for x in fields]
    levels = cavlc_cuda._level_arrays(symbols, m)
    ins += [levels[1], levels[3]]
    nh = 6 if pslice else 3
    outs = [torch.empty((m, 27), dtype=I32, device=dev),
            torch.empty((m, nh), dtype=I32, device=dev),
            torch.empty((m, nh), dtype=I32, device=dev),
            torch.empty((rows, 2), dtype=I32, device=dev), ovf]
    return ins, outs, [rows, c, int(pslice), nra]


def cavlc_prologue(symbols, ovf: torch.Tensor, nra: int = 1,
                   pslice: bool = True):
    """K13: the CAVLC prologue of P (`pslice`, MBSymbolsP) or I
    (MBSymbols) slices [..., R, C] -> (chunk ints [M, 27] int32 (nC + 1,
    maxc, code_residual, presence, the intra AC shift; `cavlc_cuda.
    chunk_fields`), header slot lengths and values [M, nh] (6 P, 3 I),
    trailing skip_runs [..., R, 2] (word, bits; None for I)); `ovf` (int32
    [1]) is set to 1 where a trailing run passes 32 bits.  CPU tensors
    take the plain version, CUDA tensors launch the kernel
    (csrc/cavlc_prologue.cu) or raise."""
    lead = tuple(symbols.mode.shape)
    if symbols.mode.device.type == "cpu":
        out = _prologue_plain(symbols, ovf, nra, pslice)
        return (*out[:3], None if out[3] is None
                else out[3].reshape(*lead[:-1], 2))
    dev = symbols.mode.device
    if pslice and not 1 <= nra <= 16:
        raise ValueError(f"cavlc_prologue: nra {nra} outside 1..16")
    ins, outs, ints = _k13_operands(symbols, ovf, nra, pslice)
    cuda_lib.check_inputs("cavlc_prologue", dev, [
        (x, x.shape) for x in ins[:8] if x is not None] + [(ovf, (1,))])
    cuda_lib.check_inputs("cavlc_prologue", dev, [
        (x, x.shape) for x in ins[8:]], dtype=torch.int16)
    err = cuda_lib.load().th264_cavlc_prologue(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(dev))
    cuda_lib.check(err, "th264_cavlc_prologue")
    cavlc_prologue.launches += 1
    return (*outs[:3], outs[3].reshape(*lead[:-1], 2) if pslice else None)


cavlc_prologue.launches = 0  # launches of K13


def encode_slices(symbols, hdr_hw, hdr_len, ovf, nra: int = 1,
                  pslice: bool = True):
    """The slice stage on the symbols in place: K13, K2's symbols entry,
    K3 at the MB level, K3's slice entry -> (slice_hw [..., R, SLICE_W]
    int32, slice_bytes [..., R] int32); `ovf` (int32 [1]) is set to 1
    where a cap is passed (the caller repacks on the host)."""
    lead = tuple(symbols.mode.shape)
    meta, hl, hv, tail = cavlc_prologue(symbols, ovf, nra, pslice)
    words, bits = cavlc_cuda.pack_symbols(symbols, meta, hl, hv, BLOCK_W,
                                          ovf)
    del meta, hl, hv
    mb_hw, mb_bits = cavlc_cuda.merge_tree(
        words.reshape(*lead, 27, BLOCK_W), bits.reshape(*lead, 27), MB_W)
    del words, bits
    return cavlc_cuda.merge_slices(hdr_hw, hdr_len, mb_hw, mb_bits, tail,
                                   SLICE_W, ovf)


def _flagged(symbols, hdr_hw, hdr_len, nra, pslice, ovf):
    if ovf is not None:
        return (*encode_slices(symbols, hdr_hw, hdr_len, ovf, nra, pslice),
                ovf)
    ovf = torch.zeros(1, dtype=I32, device=hdr_len.device)
    out = encode_slices(symbols, hdr_hw, hdr_len, ovf, nra, pslice)
    return (*out, ovf[0] != 0)


def encode_bits_iframe(symbols, qp: int, hdr_hw, hdr_len, ovf=None):
    """I-slice payload bits on the device.

    symbols: iframe.MBSymbols [S, R, C, ...]; hdr_hw [S, R, 4] int32
    MSB-aligned words of each slice header, hdr_len [S, R] bit counts.
    Returns (slice_hw [S, R, SLICE_W] int32, slice_bytes [S, R] int32,
    overflow bool tensor); given `ovf` (int32 [1], a dispatch's flag), the
    stage sets it to 1 on an overflow and returns it as the third."""
    del qp  # slice QP lives in the header; mb_qp_delta is always 0
    return _flagged(symbols, hdr_hw, hdr_len, 1, False, ovf)


def encode_bits_pframe(symbols, qp: int, hdr_hw, hdr_len, nra: int = 1,
                       ovf=None):
    """P-slice payload bits on the device (rows slice mode), bit for bit
    the entropy/packp.py emission: per coded MB a skip_run, then
    Intra_16x16-in-P or P_L0_16x16 syntax (ref_idx_l0 as te(v) when
    nra > 1), plus each slice's trailing skip_run.  The skip runs -- the
    only cross-MB sequential syntax -- are K13's row scan (its plain
    version a running maximum of each row's coded-MB indices).  `ovf` as
    in `encode_bits_iframe`."""
    del qp
    return _flagged(symbols, hdr_hw, hdr_len, nra, True, ovf)
