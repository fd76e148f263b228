"""K2 and K3: the CAVLC block pack and the chunk -> MB bit-string merge,
as CUDA kernels plus their plain PyTorch versions.

K2 replaces tpuh264/kernels/cavlc_pallas.py `_cavlc_kernel` (pallas_call
at cavlc_pallas.py:425 in `_pack_blocks_dev`, entry `pack_blocks` :329):
per 4x4 block, up to `nh` MB-header slots, then coeff_token, trailing-one
signs, the level prefix/suffix chain with escapes, total_zeros (chroma
DC included) and run_before, packed MSB-first into 32-bit words.  Its
plain version is `block_slots` + `pack_slots` (tpuh264 entropy_tpu.py
:119, :295).

K3 replaces cavlc_pallas.py `_merge_kernel` (pallas_call at :570 in
`_merge_tree_dev`, entry `merge_tree` :508): K variable-length MSB-first
strings per lane concatenated into one string of `n_out` words, at the
MB level (27 chunks -> MB_W) and the slice level (header, MBs, tails ->
SLICE_W).  Its plain version is `tree_merge` (entropy_tpu.py :389).

Word strings are int32 tensors holding the two's-complement view of
MSB-first uint32 words.  The plain versions compute in int64 holding
uint32 values (torch has no uint32 shifts): `>>` is then the logical
shift of jax.lax.shift_right_logical, and a left shift is masked back
to 32 bits.  A string is all-zero past its bit length; a string longer
than its word budget is truncated there (the caller's overflow flags
route such dispatches to the host packer).

The wrappers `pack_blocks` / `merge_tree` take the plain version only
for tensors on the CPU; for a CUDA tensor they launch the kernel or
raise.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..entropy import cavlc_tables as tbl
from . import cuda_lib, tables

I32 = torch.int32
I64 = torch.int64
M32 = (1 << 32) - 1
NSLOT = 1 + 32 + 1 + 15  # token, 16 x (zeros_hi, merged), total_zeros, runs

def _tzc_dense() -> np.ndarray:
    return np.array([[(l << 16) | b for l, b in row] + [0] * (4 - len(row))
                     for row in tbl.TOTAL_ZEROS_CHROMA_DC], np.int64)


tables.register("ct", lambda: tbl.coeff_token_dense().astype(np.int64)
                .reshape(-1))                               # [5*17*4]
tables.register("tz", lambda: tbl.total_zeros_dense().astype(np.int64)
                .reshape(-1))                               # [15*16]
tables.register("tzc", lambda: _tzc_dense().reshape(-1))   # [3*4]
tables.register("rb", lambda: tbl.run_before_dense().astype(np.int64)
                .reshape(-1))                               # [7*15]
tables.register("blk_scan", lambda: np.asarray(
    [0, 1, 4, 5, 2, 3, 6, 7, 8, 9, 12, 13, 10, 11, 14, 15], np.int64))


def _u32(x: torch.Tensor) -> torch.Tensor:
    """int32 words -> int64 holding the uint32 value."""
    return x.to(I64) & M32


def _i32(x: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 values -> int32 two's-complement words."""
    return torch.where(x >= (1 << 31), x - (1 << 32), x).to(I32)


def _bit_length(x: torch.Tensor) -> torch.Tensor:
    """Bit length of non-negative ints < 2^53 (0 -> 0); clz's complement."""
    return torch.frexp(x.to(torch.float64))[1].to(I64)


# ---------------------------------------------------------------------------
# K2 plain version: block_slots + pack_slots.
# ---------------------------------------------------------------------------


def block_slots(levels: torch.Tensor, nc, maxc):
    """Per-block VLC slots.

    levels [..., 16] zigzag coefficients (entries >= maxc are 0); nc [...]
    (-1 selects the chroma-DC token table); maxc int or [...].  Returns
    (slot_len [..., NSLOT], slot_val [..., NSLOT]) int64 with every slot
    <= 32 bits, and the per-block total_coeff [...]."""
    lead = levels.shape[:-1]
    dev = levels.device
    lv = levels.to(I64).reshape(-1, 16)
    n = lv.shape[0]
    nc = torch.as_tensor(nc, device=dev).to(I64).expand(lead).reshape(n)
    maxc = torch.as_tensor(maxc, device=dev).to(I64).expand(lead).reshape(n)
    nz = lv != 0
    nz_i = nz.to(I64)
    absd = lv.abs()
    total = nz_i.sum(-1)
    pos = torch.arange(16, device=dev)

    above = total[:, None] - torch.cumsum(nz_i, -1)  # nonzeros above j
    last_big = torch.where(nz & (absd > 1), pos, -1).amax(-1)
    tail = nz & (pos > last_big[:, None])
    t1 = torch.clamp(tail.sum(-1), max=3)
    is_t1 = tail & (above < t1[:, None])

    ctx = torch.where(nc < 0, 4, torch.where(nc < 2, 0, torch.where(
        nc < 4, 1, torch.where(nc < 8, 2, 3))))
    tok = tables.get("ct", dev)[(ctx * 17 + total) * 4 + t1]

    # ---- level chain (descending positions): only the suffix length is
    # sequential, so the 16 steps are unrolled over whole lanes ----
    sl = torch.where((total > 10) & (t1 < 3), 1, 0)
    active16 = nz & ~is_t1
    zhis, mlens, mvals = [], [], []
    for j in range(15, -1, -1):
        l, a, active, sign = lv[:, j], absd[:, j], active16[:, j], is_t1[:, j]
        first = active & (above[:, j] == t1)
        lc = 2 * a - 2 + (l < 0).to(I64)
        lc = torch.clamp(torch.where(first & (t1 < 3), lc - 2, lc), min=0)
        base0 = torch.where(sl == 0, 30, 15 << sl)
        small0 = (sl == 0) & (lc < 14)
        mid0 = (sl == 0) & (lc >= 14) & (lc < 30)
        smallp = (sl > 0) & (lc < (15 << sl))
        rem0 = torch.clamp(lc - base0, min=0)
        p = torch.clamp(3 + _bit_length(rem0 + 4096) - 1, min=15)
        w = torch.where
        plen = w(small0, lc + 1, w(mid0, 15, w(smallp, (lc >> sl) + 1, p + 1)))
        sufl = w(small0, 0, w(mid0, 4, w(smallp, sl, p - 3)))
        sufv = w(small0, 0, w(mid0, lc - 14, w(
            smallp, lc & ((1 << sl) - 1), rem0 - ((1 << (p - 3)) - 4096))))
        zhi = w(active, torch.clamp(plen - 16, min=0), 0)
        tail_len = w(sign, 1, w(active, plen - zhi, 0))
        tail_val = w(sign, (l < 0).to(I64), w(active, 1, 0))
        sufl = w(active, sufl, 0)
        sufv = w(active, sufv, 0)
        new_sl = torch.clamp(sl, min=1)
        new_sl = w((a > (3 << (new_sl - 1))) & (new_sl < 6), new_sl + 1,
                   new_sl)
        sl = w(active, new_sl, sl)
        zhis.append(zhi)
        mlens.append(tail_len + sufl)
        mvals.append((tail_val << sufl) | sufv)
    zhi16 = torch.stack(zhis, -1)
    lev_len = torch.stack([zhi16, torch.stack(mlens, -1)], -1).reshape(n, 32)
    lev_val = torch.stack([torch.zeros_like(zhi16), torch.stack(mvals, -1)],
                          -1).reshape(n, 32)

    # ---- total_zeros ----
    idx_hi = torch.where(nz, pos, -1).amax(-1)
    tz = idx_hi + 1 - total
    have_tz = (total > 0) & (total < maxc)
    tz_reg = tables.get("tz", dev)[torch.clamp(total - 1, 0, 14) * 16
                                   + torch.clamp(tz, 0, 15)]
    tz_cdc = tables.get("tzc", dev)[torch.clamp(total - 1, 0, 2) * 4
                                    + torch.clamp(tz, 0, 3)]
    tz_e = torch.where(maxc == 4, tz_cdc, tz_reg)
    tz_len = torch.where(have_tz, tz_e >> 16, 0)
    tz_val = torch.where(have_tz, tz_e & 0xFFFF, 0)

    # ---- run_before (positions 15..1, descending) ----
    marked = torch.where(nz, pos, -1)
    pnb = torch.cummax(torch.nn.functional.pad(marked, (1, 0), value=-1)
                       [:, :-1], -1).values  # previous nonzero below j
    zeros_below = pos - (total[:, None] - above - nz_i)
    emit = nz & (above < total[:, None] - 1) & (zeros_below > 0)
    run = pos - pnb - 1
    e = tables.get("rb", dev)[(torch.clamp(zeros_below, 1, 7) - 1) * 15
                              + torch.clamp(run, 0, 14)]
    desc = torch.arange(15, 0, -1, device=dev)
    run_len = torch.where(emit, e >> 16, 0)[:, desc]
    run_val = torch.where(emit, e & 0xFFFF, 0)[:, desc]

    slot_len = torch.cat([(tok >> 16)[:, None], lev_len, tz_len[:, None],
                          run_len], -1)
    slot_val = torch.cat([(tok & 0xFFFF)[:, None], lev_val, tz_val[:, None],
                          run_val], -1)
    return (slot_len.reshape(*lead, NSLOT), slot_val.reshape(*lead, NSLOT),
            total.reshape(lead))


def pack_slots(slot_len: torch.Tensor, slot_val: torch.Tensor, n_w: int):
    """Pack slot streams [..., NS] into (words [..., n_w] int32 MSB-first,
    bitlen [...] int32).  A slot of <= 32 bits starting at bit b touches at
    most two words; pieces landing in one word are disjoint bit ranges, so
    a scatter-add assembles the OR exactly.  Emissions past n_w words are
    dropped (the string is truncated; bitlen still counts every bit)."""
    ns = slot_len.shape[-1]
    lead = slot_len.shape[:-1]
    ln = slot_len.reshape(-1, ns).to(I64)
    val = slot_val.reshape(-1, ns).to(I64) & M32
    incl = torch.cumsum(ln, -1)
    bitlen = incl[:, -1]
    off = incl - ln
    end = (off & 31) + ln
    c_hi = torch.where(end <= 32,
                       (val << torch.clamp(32 - end, 0, 31)) & M32,
                       val >> torch.clamp(end - 32, 0, 31))
    c_lo = torch.where(end > 32,
                       (val << torch.clamp(64 - end, 1, 31)) & M32, 0)
    live = ln > 0
    h0 = off >> 5
    ix_hi = torch.where(live, h0, n_w).clamp(max=n_w)
    ix_lo = torch.where(live & (c_lo != 0), h0 + 1, n_w).clamp(max=n_w)
    out = torch.zeros((ln.shape[0], n_w + 1), dtype=I64, device=ln.device)
    out.scatter_add_(1, ix_hi, torch.where(live, c_hi, 0))
    out.scatter_add_(1, ix_lo, c_lo)
    return (_i32(out[:, :n_w]).reshape(*lead, n_w),
            bitlen.to(I32).reshape(lead))


_CHUNK = 1 << 20  # lanes per plain-version chunk (bounds its temporaries)


def _pack_blocks_plain(levels, nc, maxc, hdr_len, hdr_val, n_w,
                       code_residual):
    lead = levels.shape[:-1]
    n = int(np.prod(lead)) if lead else 1
    flat = lambda x, inner: x.expand(*lead, *inner).reshape(n, *inner)
    lv = flat(levels, (16,))
    nc = flat(torch.as_tensor(nc, device=levels.device), ())
    maxc = flat(torch.as_tensor(maxc, device=levels.device), ())
    cr = flat(code_residual, ())
    nh = hdr_len.shape[-1]
    hl = flat(hdr_len, (nh,))
    hv = flat(hdr_val, (nh,))
    words, bits = [], []
    for i in range(0, n, _CHUNK):
        sl_, sv_, _ = block_slots(lv[i:i + _CHUNK], nc[i:i + _CHUNK],
                                  maxc[i:i + _CHUNK])
        sl_ = torch.where(cr[i:i + _CHUNK, None] != 0, sl_, 0)
        w, b = pack_slots(torch.cat([hl[i:i + _CHUNK].to(I64), sl_], -1),
                          torch.cat([hv[i:i + _CHUNK].to(I64), sv_], -1), n_w)
        words.append(w)
        bits.append(b)
    return (torch.cat(words).reshape(*lead, n_w),
            torch.cat(bits).reshape(lead))


def pack_blocks(levels: torch.Tensor, nc: torch.Tensor, maxc: torch.Tensor,
                hdr_len: torch.Tensor, hdr_val: torch.Tensor, n_w: int,
                nh: int, code_residual: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused block_slots + pack_slots (K2).

    levels [..., 16]; nc, maxc, code_residual [...] (code_residual False =
    header slots only); hdr_len / hdr_val [..., nh] leading header slots
    (zero-length where absent; values under a zero length are ignored,
    others must fit their length, as every value the pipeline makes does).
    Returns (words [..., n_w] int32 MSB-first, bitlen [...] int32)."""
    if code_residual is None:
        code_residual = torch.ones(levels.shape[:-1], dtype=I32,
                                   device=levels.device)
    if hdr_len.shape[-1] != nh:
        raise ValueError(f"pack_blocks: hdr slots {hdr_len.shape[-1]} != {nh}")
    if levels.device.type == "cpu":
        return _pack_blocks_plain(levels, nc, maxc, hdr_len, hdr_val, n_w,
                                  code_residual)
    lead = levels.shape[:-1]
    cuda_lib.check_inputs("pack_blocks", levels.device, [
        (levels, (*lead, 16)), (nc, lead), (maxc, lead),
        (code_residual, lead), (hdr_len, (*lead, nh)), (hdr_val, (*lead, nh))])
    if not 1 <= n_w <= 32 or not 0 <= nh <= 8:
        raise ValueError("pack_blocks: kernel takes n_w <= 32, nh <= 8")
    if levels.data_ptr() % 16:
        raise ValueError("pack_blocks: levels must be 16-byte aligned "
                         "(the kernel reads rows as 16-byte vectors)")
    n = int(np.prod(lead)) if lead else 1
    words = torch.empty((*lead, n_w), dtype=I32, device=levels.device)
    bitlen = torch.empty(lead, dtype=I32, device=levels.device)
    err = cuda_lib.load().th264_pack_blocks(
        levels.data_ptr(), nc.data_ptr(), maxc.data_ptr(),
        code_residual.data_ptr(), hdr_len.data_ptr(), hdr_val.data_ptr(),
        words.data_ptr(), bitlen.data_ptr(), n, nh, n_w,
        cuda_lib.stream(levels.device))
    cuda_lib.check(err, "th264_pack_blocks")
    pack_blocks.launches += 1
    return words, bitlen


pack_blocks.launches = 0  # launches of the K2 kernel


# ---------------------------------------------------------------------------
# K3 plain version: tree_merge.
# ---------------------------------------------------------------------------


def merge_strings(a, la, b, lb, n_out: int):
    """Concatenate bit strings a [..., Wa] (la bits) and b [..., Wb] (lb
    bits), int64 uint32-valued words -> ([..., n_out], la + lb); the
    result is truncated at n_out words."""
    wb = b.shape[-1]
    sh = (la & 31)[..., None]
    pos = sh > 0
    b_hi = torch.nn.functional.pad(b, (1, 0))[..., :-1]
    b_sh = torch.where(pos, (b >> sh) | ((b_hi << (32 - sh)) & M32), b)
    spill = torch.where(pos, (b[..., -1:] << (32 - sh)) & M32, 0)
    b_ext = torch.cat([b_sh, spill], -1)  # [..., wb+1]
    src = torch.arange(n_out, device=b.device) - (la >> 5)[..., None]
    valid = (src >= 0) & (src <= wb)
    x = torch.where(valid, b_ext.gather(-1, src.clamp(0, wb)), 0)
    wa = a.shape[-1]
    a_pad = (torch.nn.functional.pad(a, (0, n_out - wa)) if n_out > wa
             else a[..., :n_out])
    return a_pad | x, la + lb


def tree_merge(strings: torch.Tensor, lens: torch.Tensor, n_out: int):
    """Pairwise-merge [..., K, W] strings (lens [..., K]) into one
    ([..., n_out] int32 words, [...] int32 bits); K is padded to a power
    of two with empty strings.  (The JAX version returns a lone string
    untruncated; here K = 1 is cut at n_out words like any K.)"""
    k = strings.shape[-2]
    kp = 1 << (k - 1).bit_length()
    s = _u32(strings)
    ln = lens.to(I64)
    if kp != k:
        s = torch.nn.functional.pad(s, (0, 0, 0, kp - k))
        ln = torch.nn.functional.pad(ln, (0, kp - k))
    w = s.shape[-1]
    while kp > 1:
        kp //= 2
        w2 = min(2 * w, n_out)
        s, ln = merge_strings(s[..., 0::2, :], ln[..., 0::2],
                              s[..., 1::2, :], ln[..., 1::2], w2)
        w = w2
    out = s[..., 0, :n_out]
    if out.shape[-1] < n_out:
        out = torch.nn.functional.pad(out, (0, n_out - out.shape[-1]))
    return _i32(out), ln[..., 0].to(I32)


MERGE_MAX_OUT = 8192  # K3's widest output (SLICE_W): a 32 KB shared tile
MERGE_MAX_K = 1024    # strings a lane (their prefix sums share the 48 KB)


def merge_tree(words: torch.Tensor, bits: torch.Tensor, n_out: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K3: words [..., K, W] int32 MSB-first strings (zero past their bit
    length), bits [..., K] -> ([..., n_out] int32, [...] int32 total bits),
    for 1 <= n_out <= 8192.

    The kernel equals the plain `tree_merge` where every string fits its
    budget (bits <= 32 * W), lanes truncated at n_out words included; a
    longer string is truncated by its producer and flagged as an overflow
    by the pipeline, whose dispatch then goes to the host packer."""
    if not 1 <= n_out <= MERGE_MAX_OUT:
        raise ValueError(f"merge_tree: n_out {n_out} outside 1.."
                         f"{MERGE_MAX_OUT}")
    if words.device.type == "cpu":
        return tree_merge(words, bits, n_out)
    lead = words.shape[:-2]
    k, w = words.shape[-2:]
    cuda_lib.check_inputs("merge_tree", words.device, [
        (words, (*lead, k, w)), (bits, (*lead, k))])
    if not 1 <= k <= MERGE_MAX_K or w < 1:
        raise ValueError(f"merge_tree: kernel takes 1 <= K <= {MERGE_MAX_K} "
                         f"strings of W >= 1 words, got K={k}, W={w}")
    n = int(np.prod(lead)) if lead else 1
    out = torch.empty((*lead, n_out), dtype=I32, device=words.device)
    out_bits = torch.empty(lead, dtype=I32, device=words.device)
    err = cuda_lib.load().th264_merge_tree(
        words.data_ptr(), bits.data_ptr(), out.data_ptr(),
        out_bits.data_ptr(), n, k, w, n_out, cuda_lib.stream(words.device))
    cuda_lib.check(err, "th264_merge_tree")
    merge_tree.launches += 1
    return out, out_bits


merge_tree.launches = 0  # launches of the K3 kernel


# ---------------------------------------------------------------------------
# K2's symbols entry and K3's slice entry: the P / I slice stage reads the
# symbols and K13's chunk ints in place (entropy_gpu.encode_bits_*).
# ---------------------------------------------------------------------------

NCHUNK = 27  # chunks an MB: luma DC / header, 16 luma AC, 2 + 8 chroma


def chunk_fields(meta: torch.Tensor):
    """K13's chunk ints [..., 27] -> (nc, maxc, code_residual, present,
    shift) int32 tensors: bits 0-7 nC + 1, 8-12 maxc, 13 code_residual,
    14 present, 15 the intra AC shift (levels from slot 1)."""
    return ((meta & 255) - 1, (meta >> 8) & 31, (meta >> 13) & 1,
            (meta >> 14) & 1, (meta >> 15) & 1)


def chunk_levels(symbols, shift: torch.Tensor) -> torch.Tensor:
    """The 27 chunks' levels [M, 27, 16] int32 of every MB of `symbols`
    (MB-major, [M] = the symbols' leading MB axes flattened): the luma DC,
    the luma AC blocks in z-order (an MB whose chunk shift bit is set
    codes slots 1-15, as Intra_16x16 AC), the chroma DC and AC zero
    padded to 16."""
    m = shift.shape[0]
    scan = tables.get("blk_scan", shift.device)
    lac = symbols.luma_ac.reshape(m, 16, 16).to(I32)[:, scan]
    sh = shift[:, 1:17, None] == 1
    ac = torch.where(sh, torch.nn.functional.pad(lac[..., 1:], (0, 1)), lac)
    pad = lambda x, n, w: torch.nn.functional.pad(
        x.reshape(m, n, w).to(I32), (0, 16 - w))
    return torch.cat([symbols.luma_dc.reshape(m, 1, 16).to(I32), ac,
                      pad(symbols.chroma_dc, 2, 4),
                      pad(symbols.chroma_ac, 8, 15)], 1)


def _pack_symbols_plain(symbols, meta, hdr_len, hdr_val, n_w: int, ovf):
    """Plain version of `pack_symbols` (same arguments): `chunk_levels`,
    then `_pack_blocks_plain` with the header slots on chunk 0, absent
    chunks emptied."""
    m, nh = hdr_len.shape
    nc, maxc, code, present, shift = chunk_fields(meta)
    hl = torch.zeros((m, NCHUNK, nh), dtype=I32, device=meta.device)
    hv = torch.zeros_like(hl)
    hl[:, 0] = hdr_len
    hv[:, 0] = hdr_val
    words, bits = _pack_blocks_plain(chunk_levels(symbols, shift), nc, maxc,
                                     hl, hv, n_w, code)
    bits = torch.where(present == 1, bits, 0)
    words = torch.where(present[..., None] == 1, words, 0)
    ovf |= (bits > 32 * n_w).any().to(I32)
    return words, bits


def _level_arrays(symbols, m: int):
    """The symbols' four level arrays as K2's and K13's kernels read them:
    int16, [M, n] contiguous, 16-byte aligned (a copy only where a tensor
    is not so)."""
    out = []
    for f, n in (("luma_dc", 16), ("luma_ac", 256), ("chroma_dc", 8),
                 ("chroma_ac", 120)):
        x = getattr(symbols, f).to(torch.int16).reshape(m, n).contiguous()
        out.append(x if x.data_ptr() % 16 == 0 else x.clone())
    return out


def _k2_symbol_operands(symbols, meta, hdr_len, hdr_val, n_w: int, ovf):
    """K2's symbols entry's operands in its order (csrc/cavlc_pack.cu
    `sym_args`): (input tensors, output tensors, ints); the outputs
    freshly allocated, `ovf` last (set to 1 on an overflow)."""
    m, nh = hdr_len.shape
    dev = meta.device
    ins = _level_arrays(symbols, m) + [meta, hdr_len, hdr_val]
    outs = [torch.empty((m, NCHUNK, n_w), dtype=I32, device=dev),
            torch.empty((m, NCHUNK), dtype=I32, device=dev), ovf]
    return ins, outs, [m * NCHUNK, nh, n_w]


def pack_symbols(symbols, meta: torch.Tensor, hdr_len: torch.Tensor,
                 hdr_val: torch.Tensor, n_w: int, ovf: torch.Tensor):
    """K2 on the symbols: every MB's 27 chunks (levels straight from the
    symbols' level arrays, nC / maxc / code_residual / presence from K13's
    chunk ints `meta` [M, 27], the MB's header slots `hdr_len` / `hdr_val`
    [M, nh] on chunk 0) packed to (words [M, 27, n_w] int32, bits [M,
    27] int32), an absent chunk empty; `ovf` (int32 [1]) is set to 1 where
    a chunk passes n_w words.  CPU tensors take the plain version, CUDA
    tensors launch the kernel or raise."""
    m = meta.shape[0]
    if meta.device.type == "cpu":
        return _pack_symbols_plain(symbols, meta, hdr_len, hdr_val, n_w, ovf)
    nh = hdr_len.shape[-1]
    if not 1 <= n_w <= 32 or not 0 <= nh <= 8:
        raise ValueError("pack_symbols: kernel takes n_w <= 32, nh <= 8")
    ins, outs, ints = _k2_symbol_operands(symbols, meta, hdr_len, hdr_val,
                                          n_w, ovf)
    cuda_lib.check_inputs("pack_symbols", meta.device, [
        (meta, (m, NCHUNK)), (hdr_len, (m, nh)), (hdr_val, (m, nh)),
        (ovf, (1,))])
    cuda_lib.check_inputs("pack_symbols", meta.device, [
        (x, (m, n)) for x, n in zip(ins[:4], (16, 256, 8, 120))],
        dtype=torch.int16)
    err = cuda_lib.load().th264_pack_symbols(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(meta.device))
    cuda_lib.check(err, "th264_pack_symbols")
    pack_symbols.launches += 1
    return outs[0], outs[1]


pack_symbols.launches = 0  # launches of K2's symbols entry


def _merge_slices_plain(hdr_hw, hdr_len, mb_hw, mb_bits, tail, n_out: int,
                        ovf):
    """Plain version of `merge_slices` (same arguments): the parts joined
    with the rbsp trailer (`entropy_gpu.slice_strings`), then
    `tree_merge`."""
    from .entropy_gpu import _slice_parts, slice_strings

    mb_w = mb_hw.shape[-1]
    t = None
    if tail is not None:
        t_hw = torch.zeros((*tail.shape[:-1], mb_w), dtype=I32,
                           device=tail.device)
        t_hw[..., 0] = tail[..., 0]
        t = (t_hw, tail[..., 1])
    parts_w, parts_b = _slice_parts(mb_hw, mb_bits, hdr_hw, hdr_len, t)
    words, bits, over = slice_strings(parts_w, parts_b)
    ovf |= (over | (mb_bits > 32 * mb_w).any()).to(I32)
    out, out_bits = tree_merge(words, bits, n_out)
    return out, (out_bits // 8).to(I32)


def _k3_slice_operands(hdr_hw, hdr_len, mb_hw, mb_bits, tail, n_out: int,
                       ovf):
    """K3's slice entry's operands in its order (csrc/cavlc_merge.cu
    `slice_args`): (input tensors, output tensors, ints)."""
    lead = hdr_len.shape
    c, mb_w = mb_hw.shape[-2:]
    dev = hdr_len.device
    outs = [torch.empty((*lead, n_out), dtype=I32, device=dev),
            torch.empty(lead, dtype=I32, device=dev), ovf]
    ins = [hdr_hw, hdr_len, mb_hw, mb_bits, tail]
    return ins, outs, [int(np.prod(lead)), c, hdr_hw.shape[-1], mb_w, n_out]


def merge_slices(hdr_hw: torch.Tensor, hdr_len: torch.Tensor,
                 mb_hw: torch.Tensor, mb_bits: torch.Tensor,
                 tail: Optional[torch.Tensor], n_out: int,
                 ovf: torch.Tensor):
    """K3 at the slice level, each slice's strings read where they lie:
    its header hdr_hw [..., hdr_w] (hdr_len [...] bits), its C MB strings
    mb_hw [..., C, mb_w] (mb_bits [..., C]), the trailing skip_run tail
    [..., 2] (word, bits; None for I slices) and the rbsp trailing bits ->
    (slice words [..., n_out] int32, slice bytes [...] int32); `ovf`
    (int32 [1]) is set to 1 where an MB passes mb_w words or a body 32 *
    n_out - 64 bits.  CPU tensors take the plain version, CUDA tensors
    launch the kernel or raise."""
    if not 1 <= n_out <= MERGE_MAX_OUT:
        raise ValueError(f"merge_slices: n_out {n_out} outside 1.."
                         f"{MERGE_MAX_OUT}")
    if hdr_len.device.type == "cpu":
        return _merge_slices_plain(hdr_hw, hdr_len, mb_hw, mb_bits, tail,
                                   n_out, ovf)
    lead = tuple(hdr_len.shape)
    c, mb_w = mb_hw.shape[-2:]
    if not 1 <= c <= MERGE_MAX_K - 3:
        raise ValueError(f"merge_slices: kernel takes 1 <= C <= "
                         f"{MERGE_MAX_K - 3} MBs a slice, got {c}")
    ins, outs, ints = _k3_slice_operands(hdr_hw, hdr_len, mb_hw, mb_bits,
                                         tail, n_out, ovf)
    cuda_lib.check_inputs("merge_slices", hdr_len.device, [
        (hdr_hw, (*lead, hdr_hw.shape[-1])), (hdr_len, lead),
        (mb_hw, (*lead, c, mb_w)), (mb_bits, (*lead, c)), (ovf, (1,)),
        *([] if tail is None else [(tail, (*lead, 2))])])
    err = cuda_lib.load().th264_merge_slices(
        cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
        cuda_lib.stream(hdr_len.device))
    cuda_lib.check(err, "th264_merge_slices")
    merge_slices.launches += 1
    return outs[0], outs[1]


merge_slices.launches = 0  # launches of K3's slice entry


def merge_slices_resident(lib=None) -> Tuple[int, int]:
    """K3's slice entry's blocks an SM that can be resident at once on the
    card, and its threads a block (the runtime's occupancy of its launch),
    from the kernel library `lib` (the port's where None)."""
    import ctypes

    lib = cuda_lib.load() if lib is None else lib
    got = (ctypes.c_int * 2)()
    cuda_lib.check(lib.th264_merge_slices_resident(got),
                   "th264_merge_slices_resident")
    return got[0], got[1]
