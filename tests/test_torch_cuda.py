"""The port's CUDA kernels (K1, K2, K3, the deblock D1 and its ring entry,
the intra reconstruction D2, the Intra_16x16 encode scans D3 / D4, the
single-slice wavefront's encode K7 and decode K8, the P encode after
stage A K9, the P decode's inter part K10, the reference build K11, the
stage-A winner K12, the device source K15 and the toolchain probe's P1
and P2) against their plain PyTorch versions, on the card, plus the
wrappers' no-fallback rule.

This file imports no JAX, so it also runs where only PyTorch is
installed.  On a machine with a card and nvcc:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

The tests marked `cuda` skip where no card is present; the rest run on
the CPU too.  Every comparison is exact (an integer codec).
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
from tpuh264_torch.engine import sources
from tpuh264_torch.kernels import cavlc_cuda, cuda_lib, me_cuda
from tpuh264_torch.kernels import deblock as DB
from tpuh264_torch.kernels import iframe as IF
from tpuh264_torch.kernels import pframe as TP
from tpuh264_torch.kernels import probe
from tpuh264_torch.kernels import wavefront as WF


def _launches():
    """The kernels' launch counters, by kernel (D3 / D4: K6's two
    routers)."""
    return {"K1": me_cuda.sad_field.launches,
            "K2": cavlc_cuda.pack_blocks.launches,
            "K3": cavlc_cuda.merge_tree.launches,
            "K4": (DB.deblock_frame_rows.launches
                   + DB.deblock_ring.launches),
            "K5": IF._intra_recon_scan.launches,
            "D3": IF.encode_iframe_scan.launches,
            "D4": TP._intra_in_p_scan.launches,
            "K9": TP._inter_encode.launches,
            "K10": TP._inter_decode.launches,
            "K11": TP._references.launches,
            "K12": TP._int_winner.launches,
            "K15": sources.device_source_gop.launches}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda", 0)


def _levels_case(rng, n, nh, sparse, amp, hdr_bits):
    """Random 4x4 blocks in the pack_blocks input layout."""
    levels = rng.integers(-amp, amp + 1, size=(n, 16)).astype(np.int32)
    levels[rng.random((n, 16)) < sparse] = 0
    maxc = rng.choice((16, 15, 4), size=(n,)).astype(np.int32)
    levels[np.arange(16)[None, :] >= maxc[:, None]] = 0
    nc = rng.integers(0, 17, size=(n,)).astype(np.int32)
    nc[maxc == 4] = -1
    hdr_len = rng.integers(0, hdr_bits, size=(n, nh)).astype(np.int32)
    hdr_val = rng.integers(0, 1 << 20, size=(n, nh))
    # a value fits its slot's length; under a zero length it is stale
    hdr_val = np.where(hdr_len > 0, hdr_val & ((1 << hdr_len) - 1), hdr_val)
    return levels, nc, maxc, hdr_len, hdr_val.astype(np.int32)


def _strings(rng, n, k, w, max_bits):
    """K MSB-first strings per lane, zero past their bit length."""
    bits = rng.integers(0, max_bits + 1, size=(n, k)).astype(np.int32)
    raw = rng.integers(0, 1 << 32, size=(n, k, w), dtype=np.uint64)
    keep = np.clip(bits[..., None] - 32 * np.arange(w), 0, 32)
    mask = np.where(keep > 0, (1 << 32) - (1 << (32 - keep).astype(np.uint64)),
                    0).astype(np.uint64)
    return (raw & mask).astype(np.uint32).view(np.int32), bits


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,w", [(2, 64, 128), (1, 48, 80), (4, 1088, 1920)])
def test_sad_field_kernel_matches_plain(dev, s, h, w):
    rng = np.random.default_rng(h + w)
    y = torch.from_numpy(rng.integers(0, 256, (s, h, w)).astype(np.int32))
    ref = torch.from_numpy(rng.integers(0, 256, (s, h, w)).astype(np.int32))
    yd = y.to(dev)
    g = chip_smoke.k1_plane(torch, ref.to(dev))
    got = me_cuda.sad_field(yd, g)
    plain = me_cuda._sad_field(yd[:, ::2, ::2], g, h, w)
    torch.cuda.synchronize()
    assert got.shape == (s, h // 16, w // 16, 289)
    assert torch.equal(got, plain)


@pytest.mark.cuda
def test_int_winner_first_index_ties_on_card(dev):
    rng = np.random.default_rng(3)
    sads = torch.from_numpy(
        (rng.integers(0, 4, (4, 6, 7, 289)) * 4).astype(np.int32))
    sads[..., ::3] = 0  # plateaus of exact ties
    for lam in (0, 4, 30):
        for a, b in zip(TP._int_winner(sads.to(dev), lam),
                        TP._int_winner(sads, lam)):
            assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("n_w", [20, 6])
def test_cavlc_kernels_match_plain_on_card(dev, n_w):
    rng = np.random.default_rng(5 + n_w)
    arrs = _levels_case(rng, 5000, nh=6, sparse=0.5, amp=2000, hdr_bits=20)
    cu = [torch.from_numpy(a).to(dev) for a in arrs]
    g = torch.from_numpy((rng.random(5000) < 0.7).astype(np.int32)).to(dev)
    kw, kb = cavlc_cuda.pack_blocks(*cu, n_w, 6, code_residual=g)
    pw, pb = cavlc_cuda._pack_blocks_plain(*cu, n_w, g)
    torch.cuda.synchronize()
    assert torch.equal(kb, pb) and torch.equal(kw, pw)
    words, bits = _strings(rng, 3000, 27, 20, 200)
    wd = torch.from_numpy(words).to(dev)
    bd = torch.from_numpy(bits).to(dev)
    for n_out in (128, 16):  # 16 words truncates most lanes
        ko, kbits = cavlc_cuda.merge_tree(wd, bd, n_out)
        po, pbits = cavlc_cuda.tree_merge(wd, bd, n_out)
        torch.cuda.synchronize()
        assert torch.equal(kbits, pbits) and torch.equal(ko, po)


@pytest.mark.cuda
@pytest.mark.parametrize("s,h,w,kind", [
    (4, 1088, 1920, "0/255"), (1, 480, 864, "0/255"), (1, 480, 864, "uniform"),
    (4, 48, 80, "max"), (1, 48, 80, "0/255")])
def test_sad_field_edge_cases_on_card(dev, s, h, w, kind):
    """Samples only 0 and 255, the maximum SAD (16,320 everywhere), ragged
    tiles (54 and 5 MB columns), S = 1 and 4 (chip_smoke phase 2)."""
    rng = np.random.default_rng(h * w + s)
    if kind == "max":
        y = np.full((s, h, w), 255, np.int32)
        ref = np.zeros((s, h, w), np.int32)
    elif kind == "0/255":
        y, ref = (rng.integers(0, 2, (2, s, h, w)) * 255).astype(np.int32)
    else:
        y, ref = rng.integers(0, 256, (2, s, h, w)).astype(np.int32)
    yd = torch.from_numpy(y).to(dev)
    g = chip_smoke.k1_plane(torch, torch.from_numpy(ref).to(dev))
    got = me_cuda.sad_field(yd, g)
    plain = me_cuda._sad_field(yd[:, ::2, ::2], g, h, w)
    torch.cuda.synchronize()
    assert torch.equal(got, plain)
    if kind == "max":
        assert bool((got == 16320).all())


@pytest.mark.cuda
@pytest.mark.parametrize("nh", range(9))
def test_pack_blocks_edge_cases_on_card(dev, nh):
    """Escape-size levels, 16 nonzeros, chroma DC, code_residual 0, header
    slots of 0..32 bits, n_w 1 / 6 / 20 / 32 (truncating), a ragged last
    block (chip_smoke phase 2's generator)."""
    from chip_smoke import k2_case

    rng = np.random.default_rng(100 + nh)
    for n_w in (1, 6, 20, 32):
        lv, nc, mc, cr, hl, hv = [torch.from_numpy(a).to(dev)
                                  for a in k2_case(rng, np, 4096 + 77, nh)]
        kw, kb = cavlc_cuda.pack_blocks(lv, nc, mc, hl, hv, n_w, nh,
                                        code_residual=cr)
        pw, pb = cavlc_cuda._pack_blocks_plain(lv, nc, mc, hl, hv, n_w, cr)
        torch.cuda.synchronize()
        assert torch.equal(kb, pb) and torch.equal(kw, pw), n_w


def test_pack_blocks_edge_inputs_on_cpu():
    """The edge-case generator covers what it claims, and the plain
    version packs it (the CPU side of the card test above)."""
    from chip_smoke import k2_case

    rng = np.random.default_rng(7)
    lv, nc, mc, cr, hl, hv = k2_case(rng, np, 4096 + 77, 8)
    nz = (lv != 0).sum(-1)
    assert (nz == 16).any() and (nz == 0).any()
    assert np.abs(lv).max() > 20000          # escape-size levels
    assert ((mc == 4) & (nc == -1)).any() and (nc[mc == 4] == -1).all()
    assert (cr == 0).any() and (hl == 32).any() and (hl == 0).any()
    assert (lv[:, 4:][mc == 4] == 0).all()
    args = [torch.from_numpy(a) for a in (lv, nc, mc, hl, hv)]
    w, b = cavlc_cuda.pack_blocks(*args, 6, 8,
                                  code_residual=torch.from_numpy(cr))
    assert w.shape == (4096 + 77, 6) and bool((b > 32 * 6).any())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 27, 123])
@pytest.mark.parametrize("n_out", [1, 16, 128, 8192])
def test_merge_tree_edge_cases_on_card(dev, k, n_out):
    """All-ones strings of 0, 1, 31, 32, 33 and 32*W bits, empty lanes,
    lanes truncated at n_out, W 1 / 20 / 128, a ragged last block
    (chip_smoke phase 2's generator)."""
    from chip_smoke import K3_LANES, k3_case

    rng = np.random.default_rng(1000 * k + n_out)
    for w in (1, 20, 128):
        wd, bd = [torch.from_numpy(a).to(dev)
                  for a in k3_case(rng, np, K3_LANES, k, w)]
        ko, kbits = cavlc_cuda.merge_tree(wd, bd, n_out)
        po, pbits = cavlc_cuda.tree_merge(wd, bd, n_out)
        torch.cuda.synchronize()
        assert torch.equal(kbits, pbits) and torch.equal(ko, po), w


def test_merge_tree_edge_inputs_on_cpu():
    """The K3 edge-case generator covers what it claims (the CPU side of
    the card test above; tests/test_torch_merge.py holds the plain version
    to the JAX package's on the same inputs)."""
    from chip_smoke import K3_LANES, k3_case

    assert K3_LANES % 4 != 0  # a ragged last warp (4 lanes) and block (32)
    rng = np.random.default_rng(9)
    words, bits = k3_case(rng, np, K3_LANES, 27, 20)
    assert words.shape == (K3_LANES, 27, 20) and bits.shape == (K3_LANES, 27)
    assert bits.min() >= 0 and bits.max() <= 32 * 20  # within the budget
    for b in (0, 1, 31, 32, 33, 640):
        assert (bits == b).any(), b
    u = words.view(np.uint32).astype(np.uint64)
    keep = np.clip(bits[..., None] - 32 * np.arange(20), 0, 32)
    full = (((np.uint64(1) << keep.astype(np.uint64)) - np.uint64(1))
            << (32 - keep).astype(np.uint64))
    assert not (u & ~full & np.uint64(0xFFFFFFFF)).any()  # zero past bits
    all_ones = (u == full).all((-2, -1))
    assert all_ones.sum() >= K3_LANES // 2           # edge + near-full lanes
    assert ((bits == 0).all(-1)).any()               # every string empty
    assert (bits.sum(-1) > 32 * 128).any()           # past 32*n_out at 128
    _, b1 = k3_case(rng, np, 24, 1, 1)  # W = 1: the edge lengths <= 32
    assert b1.max() <= 32 and set(np.unique(b1[1::4])) == {0, 1, 31, 32}


def _sequential_merge(words, bits, n_out):
    """Bit-level reference: each lane's strings appended in order as one
    integer, cut at n_out words -> ([n, n_out] int32, [n] total bits)."""
    w = words.shape[-1]
    u = words.view(np.uint32)
    out = np.zeros((len(bits), n_out), np.uint32)
    for i in range(len(bits)):
        acc, total = 0, 0
        for k, lb in enumerate(bits[i].tolist()):
            v = int.from_bytes(u[i, k].astype(">u4").tobytes(), "big")
            acc = (acc << lb) | (v >> (32 * w - lb))
            total += lb
        acc = acc << (32 * n_out) >> total if total <= 32 * n_out \
            else acc >> (total - 32 * n_out)
        out[i] = np.frombuffer(acc.to_bytes(4 * n_out, "big"), ">u4")
    return out.view(np.int32), bits.sum(-1)


@pytest.mark.parametrize("k,w,n_out", [
    (1, 20, 16), (1, 1, 1), (27, 20, 16), (27, 20, 128), (27, 1, 1),
    (123, 128, 8192), (123, 20, 128), (123, 1, 16)])
def test_merge_tree_plain_matches_sequential_reference(k, w, n_out):
    """The plain version equals plain concatenation on every lane of the
    K3 edge cases, lanes cut at n_out words included -- what the kernel
    computes, so the card test above may demand equality everywhere."""
    from chip_smoke import k3_case

    words, bits = k3_case(np.random.default_rng(k + w + n_out), np, 13, k, w)
    got_w, got_b = cavlc_cuda.merge_tree(torch.from_numpy(words),
                                         torch.from_numpy(bits), n_out)
    ref_w, ref_b = _sequential_merge(words, bits, n_out)
    np.testing.assert_array_equal(got_b.numpy(), ref_b)
    np.testing.assert_array_equal(got_w.numpy(), ref_w)


def test_merge_tree_rejects_n_out_outside_range():
    """n_out outside 1..8192 raises before the plain version or a launch,
    on every device."""
    words = torch.zeros((4, 3, 2), dtype=torch.int32)
    bits = torch.zeros((4, 3), dtype=torch.int32)
    for n_out in (0, -1, 8193):
        with pytest.raises(ValueError):
            cavlc_cuda.merge_tree(words, bits, n_out)
    out, total = cavlc_cuda.merge_tree(words, bits, 1)
    assert out.shape == (4, 1) and total.shape == (4,)


@pytest.mark.cuda
def test_wrappers_check_inputs_on_card(dev):
    y = torch.zeros((1, 32, 32), dtype=torch.int32, device=dev)
    g = chip_smoke.k1_plane(torch, y)
    with pytest.raises(TypeError):
        me_cuda.sad_field(y.to(torch.int16), g)
    with pytest.raises(ValueError):
        me_cuda.sad_field(y, g[:, :57])
    with pytest.raises(ValueError):
        me_cuda.sad_field(y, g.transpose(1, 2).contiguous().transpose(1, 2))
    # the G plane in another layout: int32, or uint8 rows without the pitch
    with pytest.raises(TypeError):
        me_cuda.sad_field(y, g.to(torch.int32))
    with pytest.raises(ValueError):
        me_cuda.sad_field(y, g.contiguous())
    words = torch.zeros((4, 3, 2), dtype=torch.int32, device=dev)
    bits = torch.zeros((4, 3), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):
        cavlc_cuda.merge_tree(words, bits.cpu(), 8)
    before = cavlc_cuda.merge_tree.launches
    for n_out in (0, 8193):  # outside the kernel's 1..8192 words
        with pytest.raises(ValueError):
            cavlc_cuda.merge_tree(words, bits, n_out)
    assert cavlc_cuda.merge_tree.launches == before
    out, total = cavlc_cuda.merge_tree(words, bits, 8192)
    torch.cuda.synchronize()
    assert out.shape == (4, 8192) and not bool(out.any())
    assert not bool(total.any())
    z = lambda *sh: torch.zeros(sh, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # levels not 16-byte aligned
        cavlc_cuda.pack_blocks(z(9 * 16)[1:129].reshape(8, 16), z(8), z(8),
                               z(8, 2), z(8, 2), 20, 2)


def _deblock_both(dev, case):
    """The deblock kernel and its plain version on the card, one input."""
    args = [None if a is None else torch.from_numpy(a).to(dev)
            for a in chip_smoke.d1_case(np, *case)]
    y, u, v, kind, mvx, mvy, nnz, ref, t8 = args
    qp = case[2]
    before = DB.deblock_frame_rows.launches
    got = DB.deblock_frame_rows(y, u, v, kind, mvx, mvy, nnz, qp, refidx=ref,
                                t8=t8)
    plain = DB._deblock_rows_plain(y, u, v, kind, mvx, mvy, nnz, qp, ref, t8)
    torch.cuda.synchronize()
    assert DB.deblock_frame_rows.launches == before + 1
    return got, plain


@pytest.mark.cuda
@pytest.mark.parametrize("shape,variant,qp", chip_smoke.D1_CASES)
def test_deblock_kernel_matches_plain_edge_cases(dev, shape, variant, qp):
    """C = 1, odd S / R / C, an even C of 16, MV steps 3 / 4 / 5, refidx
    0..3, random t8, all-intra, qp 0 .. 51 (chip_smoke phase 2's
    generator)."""
    got, plain = _deblock_both(dev, (shape, variant, qp))
    for a, b in zip(got, plain):
        assert a.dtype == torch.uint8 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("variant", chip_smoke.D1_VARIANTS)
def test_deblock_kernel_matches_plain_480p(dev, variant):
    got, plain = _deblock_both(dev, ((2, 480, 864), variant, 30))
    for a, b in zip(got, plain):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", chip_smoke.D1_RING_LAYOUTS)
@pytest.mark.parametrize("variant", chip_smoke.D1_VARIANTS)
def test_deblock_ring_matches_plain(dev, variant, layout):
    """K4's ring entry on every D1 case of the variant, the fields laid
    out as record views or apart, uint8 planes and int32 ones (narrowed
    first by the router): equal to the plain deblock on deblock_nnz's
    grid, written into a ring slot (the other slot untouched), one launch
    each."""
    for case in chip_smoke.D1_CASES:
        if case[1] != variant:
            continue
        for u8 in (True, False):
            args, kw = chip_smoke.d1_ring_args(torch, np, case, layout, u8,
                                               dev)
            before = DB.deblock_ring.launches
            chip_smoke.k4_ring_equal(args, kw, torch, str(case))
            assert DB.deblock_ring.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rigid", "noise", "moving_gradient"])
def test_source_kernel_matches_plain(dev, kind):
    """K15 against the plain version's chain of ATen ops on the card,
    sample for sample (the float kinds too), at the main path's 1080p x 4,
    k = 4, and on every K15_EDGES case."""
    for case in (chip_smoke.K15_MAIN,) + chip_smoke.K15_EDGES:
        before = sources.device_source_gop.launches
        got = sources.device_source_gop(*case[:4], kind, case[4], dev)
        want = sources._device_source_gop_plain(*case[:4], kind, case[4],
                                                dev)
        assert sources.device_source_gop.launches == before + 1
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8 and torch.equal(a, b), case


@pytest.mark.cuda
def test_deblock_wrapper_on_card(dev):
    """Planes of another dtype (uint8, as decoders pass them) and a bool
    t8 are taken as int32 copies; a plane of the wrong shape, a misaligned
    plane or a qp past 51 raises before any launch."""
    args = [None if a is None else torch.from_numpy(a).to(dev)
            for a in chip_smoke.d1_case(np, (2, 32, 48), "t8", 33)]
    y, u, v, kind, mvx, mvy, nnz, ref, t8 = args
    want = DB.deblock_frame_rows(y, u, v, kind, mvx, mvy, nnz, 33,
                                 refidx=ref, t8=t8)
    got = DB.deblock_frame_rows(y.to(torch.uint8), u.to(torch.uint8),
                                v.to(torch.uint8), kind, mvx, mvy, nnz, 33,
                                refidx=ref, t8=t8 == 1)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = DB.deblock_frame_rows.launches
    with pytest.raises(ValueError):
        DB.deblock_frame_rows(y, u[:, :8], v, kind, mvx, mvy, nnz, 33)
    with pytest.raises(ValueError):
        DB.deblock_frame_rows(y, u, v, kind, mvx, mvy, nnz, 52)
    with pytest.raises(ValueError):
        DB.deblock_frame_rows(y, u, v, kind.cpu(), mvx, mvy, nnz, 33)
    flat = torch.zeros(y.numel() + 1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError):  # not 16-byte aligned
        DB.deblock_frame_rows(flat[1:].view(y.shape), u, v, kind, mvx, mvy,
                              nnz, 33)
    assert DB.deblock_frame_rows.launches == before


def _intra_both(kw):
    """The intra-reconstruction kernel and its plain version, one input."""
    before = IF._intra_recon_scan.launches
    got = IF._intra_recon_scan(**kw)
    plain = IF._intra_recon_scan_plain(**kw)
    torch.cuda.synchronize()
    assert IF._intra_recon_scan.launches == before + 1
    for a, b in zip(got, plain):
        assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [(*c, chip_smoke.D2_QP)
                                  for c in chip_smoke.D2_CASES
                                  + chip_smoke.D2_RING_CASES]
                         + chip_smoke.D2_QP_CASES, ids=str)
def test_intra_recon_kernel_matches_plain_edge_cases(dev, case):
    """C = 1, 2, 3, 61 and 97, S and R 1 to 4, intra shares 0 / ~1% / 50%
    / 100%, runs of intra and `other` columns, and the I decode, DC / H
    mixes, clips at 0 and 255, levels the cbps mask out, QPs 0, 32 and 51
    (chip_smoke phase 2's generator)."""
    _intra_both(chip_smoke.d2_args(torch, chip_smoke.d2_case(np, *case),
                                   dev))


@pytest.mark.cuda
def test_intra_recon_kernel_matches_plain_1080p(dev):
    """The P decode's and the I decode's own inputs of the scan at 1080p
    x 4: a pipeline P frame of "rigid" and its I frame."""
    y, u, v, sym, _, _ = chip_smoke.pframe_1080p(dev, torch)
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    sym_i, _ = IF.encode_iframe_rows(y[0], u[0], v[0], 30)
    calls = chip_smoke.d2_capture(
        lambda: TP.decode_pframe_rows_multi(sym, *refs, 30))
    calls += chip_smoke.d2_capture(lambda: IF.decode_iframe_scan(sym_i, 30))
    assert len(calls) == 2 and "other" in calls[0] and "other" not in calls[1]
    for kw in calls:
        _intra_both(kw)


@pytest.mark.cuda
def test_intra_recon_wrapper_on_card(dev):
    """A bool is_intra and int32 levels are taken as copies, a level view
    at an offset that is not 16-byte aligned as an aligned copy, the
    record buffers' strided views as they are; a wrong shape, `other`
    without is_intra or a tensor on the CPU raises before any launch."""
    import types

    from tpuh264_torch.engine import devpipe

    kw = chip_smoke.d2_args(torch, chip_smoke.d2_case(np, (2, 3, 5), "half"),
                            dev)
    want = IF._intra_recon_scan_plain(**kw)
    t = kw["levels"]
    flat = torch.zeros(t.luma_ac.numel() + 1, dtype=torch.int16, device=dev)
    odd = flat[1:].view(t.luma_ac.shape)
    odd.copy_(t.luma_ac)
    lev = types.SimpleNamespace(**{**vars(t), "luma_ac": odd,
                                   "chroma_ac": t.chroma_ac.to(torch.int32)})
    got = IF._intra_recon_scan(**{**kw, "levels": lev})
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    mb = tuple(t.mode.shape)
    m = torch.stack([t.kind, t.mode, t.cmode, t.cbp_luma, t.cbp_chroma,
                     t.mvdx, t.mvdy, t.refidx, t.refidx], -1)
    cf = torch.cat([t.luma_dc, t.luma_ac.reshape(*mb, 256),
                    t.chroma_dc.reshape(*mb, 8),
                    t.chroma_ac.reshape(*mb, 120)], -1)
    sym = devpipe.record_symbols(m.contiguous(), cf.contiguous())
    got = IF._intra_recon_scan(**{**kw, "mode": sym.mode,
                                  "cmode": sym.cmode, "levels": sym})
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    before = IF._intra_recon_scan.launches
    bad = [{**kw, "levels": types.SimpleNamespace(
               **{**vars(t), "luma_dc": t.luma_dc[:, :1]})},
           {**kw, "is_intra": None},
           {**kw, "cmode": kw["cmode"].cpu()},
           {**kw, "qp": 52}]
    for b in bad:
        with pytest.raises(ValueError):
            IF._intra_recon_scan(**b)
    assert IF._intra_recon_scan.launches == before


@pytest.mark.cuda
def test_intra_recon_raises_without_fallback(dev, monkeypatch):
    """A kernel library that cannot be built, or an entry that reports a
    CUDA error at launch, raises: the plain version is never taken."""
    kw = chip_smoke.d2_args(torch, chip_smoke.d2_case(np, (2, 2, 3), "half"),
                            dev)
    lib = cuda_lib.load()
    plain = []
    monkeypatch.setattr(IF, "_intra_recon_scan_plain",
                        lambda *a, **k: plain.append(1))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        IF._intra_recon_scan(**kw)

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def th264_intra_recon_rows(*args):
            return 9  # cudaErrorInvalidConfiguration

    monkeypatch.setattr(cuda_lib, "load", lambda: Refusing())
    with pytest.raises(RuntimeError, match="th264_intra_recon_rows"):
        IF._intra_recon_scan(**kw)
    assert not plain


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.K11_CASES, ids=str)
def test_references_kernel_matches_plain(dev, case):
    """K11 equals its plain version on the seeded cases: every plane of
    every reference, halo on and off, uint8 and int32 references."""
    refs_y, refs_u, refs_v, halo = chip_smoke.k11_case(np, *case)
    kw = dict(refs_y=torch.from_numpy(refs_y).to(dev),
              refs_u=torch.from_numpy(refs_u).to(dev),
              refs_v=torch.from_numpy(refs_v).to(dev), halo=halo)
    before = TP._references.launches
    chip_smoke.k11_equal(kw, torch, str(case))
    assert TP._references.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.K12_CASES, ids=str)
def test_int_winner_kernel_matches_plain(dev, case, monkeypatch):
    """K12 equals its plain version on the seeded cases (first-index ties
    of both phases, tied counts); with a group, both sum a second
    table's counts in between the phases."""
    sads, lam, other = chip_smoke.k12_case(np, *case)
    kw = dict(sads=torch.from_numpy(sads).to(dev), lam=lam)
    if other is not None:
        extra = chip_smoke.k12_counts(torch, torch.from_numpy(other).to(dev),
                                      lam)
        monkeypatch.setattr(TP, "all_reduce",
                            lambda x, g: x.add_(extra.to(x.dtype)))
        kw["group"] = "another band"
    before = TP._int_winner.launches
    chip_smoke.k12_equal(kw, torch, str(case), case[4])
    assert TP._int_winner.launches == before + (case[4] is None)


@pytest.mark.cuda
def test_refs_and_winner_raise_without_fallback(dev, monkeypatch):
    """K11 and K12 with a library that cannot be built raise: their plain
    versions are never taken."""
    refs_y, refs_u, refs_v, halo = chip_smoke.k11_case(
        np, *chip_smoke.K11_CASES[2])
    sads, lam, _ = chip_smoke.k12_case(np, *chip_smoke.K12_CASES[3])
    plain = []
    monkeypatch.setattr(TP, "_references_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(TP, "_int_winner_plain",
                        lambda *a, **k: plain.append(1))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        TP._references(*[torch.from_numpy(x).to(dev)
                         for x in (refs_y, refs_u, refs_v)], halo)
    with pytest.raises(RuntimeError, match="nvcc"):
        TP._int_winner(torch.from_numpy(sads).to(dev), lam)
    assert not plain


def _i16_both(planes, qp):
    """K6 as the I encode's scan (D3) and its plain version, one input."""
    before = IF.encode_iframe_scan.launches
    got = IF.encode_iframe_scan(*planes, qp)
    want = IF._encode_iframe_scan_plain(*planes, qp)
    torch.cuda.synchronize()
    assert IF.encode_iframe_scan.launches == before + 1
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _i16_in_p_both(kw):
    """K6 as the intra-in-P scan (D4) and its plain version, one input:
    the kernel's levels are int16, the plain version's int32."""
    before = TP._intra_in_p_scan.launches
    use, m, rec = TP._intra_in_p_scan(**kw)
    puse, pm, prec = TP._intra_in_p_scan_plain(**kw)
    torch.cuda.synchronize()
    assert TP._intra_in_p_scan.launches == before + 1
    assert use.dtype == torch.bool and torch.equal(use, puse)
    for f in IF.Intra16._fields[:-1]:
        assert torch.equal(getattr(m, f).to(torch.int32), getattr(pm, f)), f
    for a, b in zip(rec, prec):
        assert a.dtype == torch.int32 and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.D3_CASES)
def test_intra16_kernel_matches_plain_d3_cases(dev, case):
    """D3 on chip_smoke phase 2's seeded frames (C = 1, 2, 3 and 61; flat,
    noise, rows, 0 / 255; QP 0, 11, 12, 28, 51), uint8 and int32."""
    y, u, v, qp = chip_smoke.d3_case(np, *case)
    planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
    _i16_both(planes, qp)
    _i16_both([p.to(torch.int32) for p in planes], qp)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.D4_CASES)
def test_intra16_kernel_matches_plain_d4_cases(dev, case):
    """D4 on the seeded cases: intra shares 0 / ~1% / 50% / 100% and
    exact ties of the intra and inter SADs."""
    _i16_in_p_both(chip_smoke.d4_args(torch, case, dev))


@pytest.mark.cuda
def test_intra16_kernel_matches_plain_1080p(dev):
    """D3 on a 1080p x 4 frame of "rigid", and D4 on the intra-in-P P
    encode's own inputs of the scan at 480p x 8."""
    y, u, v, _, _, _ = chip_smoke.pframe_1080p(dev, torch)
    _i16_both((y[0], u[0], v[0]), 30)
    calls = chip_smoke.d4_capture(lambda: chip_smoke.pframe_480p(
        dev, torch, t8=False, gap=8))
    assert len(calls) == 1
    _i16_in_p_both(calls[0])


@pytest.mark.cuda
def test_intra16_raises_without_fallback(dev, monkeypatch):
    """A kernel library that cannot be built, or an entry that reports a
    CUDA error at launch, raises: the plain versions are never taken;
    with intra44 the I encode takes its plain version by argument."""
    y, u, v, qp = chip_smoke.d3_case(np, (2, 2, 3), "noise", 28)
    planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
    kw = chip_smoke.d4_args(torch, chip_smoke.D4_CASES[7], dev)
    lib = cuda_lib.load()
    plain = []
    monkeypatch.setattr(IF, "_encode_iframe_scan_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(TP, "_intra_in_p_scan_plain",
                        lambda *a, **k: plain.append(1))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        IF.encode_iframe_scan(*planes, qp)
    with pytest.raises(RuntimeError, match="nvcc"):
        TP._intra_in_p_scan(**kw)

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def th264_intra16_encode_rows(*args):
            return 9  # cudaErrorInvalidConfiguration

        @staticmethod
        def th264_intra16_in_p_rows(*args):
            return 9

    monkeypatch.setattr(cuda_lib, "load", lambda: Refusing())
    with pytest.raises(RuntimeError, match="th264_intra16_encode_rows"):
        IF.encode_iframe_scan(*planes, qp)
    with pytest.raises(RuntimeError, match="th264_intra16_in_p_rows"):
        TP._intra_in_p_scan(**kw)
    assert not plain
    IF.encode_iframe_scan(*planes, qp, intra44=True)
    assert plain == [1]


def _wave_both(planes, qp):
    """K7 and its plain version on one input, and K8 and its plain version
    on K7's symbols: equal, and the decode equal to the recon."""
    before = (WF.encode_iframe_single.launches,
              WF.decode_iframe_single.launches)
    sym, rec = WF.encode_iframe_single(*planes, qp)
    psym, prec = WF._encode_iframe_single_plain(*planes, qp)
    dec = WF.decode_iframe_single(sym, qp)
    pdec = WF._decode_iframe_single_plain(sym, qp)
    torch.cuda.synchronize()
    assert (WF.encode_iframe_single.launches,
            WF.decode_iframe_single.launches) == (before[0] + 1,
                                                  before[1] + 1)
    for a, b in zip((*sym, *rec), (*psym, *prec)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    for a, b, c in zip(dec, pdec, rec):
        assert a.dtype == torch.uint8 and torch.equal(a, b)
        assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.W_CASES)
def test_wavefront_kernels_match_plain_cases(dev, case):
    """K7 / K8 on chip_smoke phase 2's seeded frames (one MB, one row, one
    column, R > C, several rows a CTA; ramps, mixed MB kinds, flat and
    saturated frames; QP 0 to 51), K7 from uint8 and from int32 planes;
    K8 also on any modes (0-3 at every MB) and on random cbp over the
    levels."""
    y, u, v, qp = chip_smoke.wave_case(np, *case)
    planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
    _wave_both(planes, qp)
    _wave_both([p.to(torch.int32) for p in planes], qp)
    sym, _ = WF.encode_iframe_single(*planes, qp)
    rng = lambda k: np.random.default_rng(sum(case[0]) + qp + k)
    mode, cmode = chip_smoke.any_modes(np, rng(1), tuple(sym.mode.shape))
    cbl, cbc = chip_smoke.masked_cbp(np, rng(0), tuple(sym.mode.shape))
    on = lambda x: torch.from_numpy(x).to(dev)
    for other in (sym._replace(mode=on(mode), cmode=on(cmode)),
                  sym._replace(cbp_luma=on(cbl), cbp_chroma=on(cbc))):
        got = WF.decode_iframe_single(other, qp)
        want = WF._decode_iframe_single_plain(other, qp)
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_wavefront_session_from_rgba_matches_cpu(dev):
    """EncoderSession.encode_frame (RGBA, whose colour conversion gives
    int32 planes) with a single slice emits on the card, through K7, the
    bytes of the same session on the CPU."""
    from tpuh264_torch.engine import CodecConfig, EncoderSession

    cfg = CodecConfig(width=160, height=104, streams=2, qp=28,
                      slice_mode="single", gop_size=1)
    frames = np.random.default_rng(5).integers(0, 256, (2, 2, 104, 160, 4),
                                               dtype=np.uint8)
    cpu = EncoderSession(cfg, device="cpu")
    card = EncoderSession(cfg, device=dev)
    before = WF.encode_iframe_single.launches
    for f in frames:
        want = [a.data for a in cpu.encode_frame(f)]
        assert [a.data for a in card.encode_frame(f)] == want
    assert WF.encode_iframe_single.launches == before + len(frames)


@pytest.mark.cuda
@pytest.mark.parametrize("w,h,s", [(640, 360, 1), (854, 480, 8)])
def test_wavefront_kernels_match_plain_frames(dev, w, h, s, monkeypatch):
    """K7 / K8 on BASELINE config 1's frame size and on phase 12's 480p x
    8 frames of the "meeting" clip, edge-padded as the session pads; the
    decode router decodes no residual in torch (K8 does)."""
    planes = chip_smoke.wave_frames(dev, torch, np, w, h, s)
    _wave_both(planes, 28)
    sym, rec = WF.encode_iframe_single(*planes, 28)

    def no_residuals(*a, **k):
        raise AssertionError("the card route decoded residuals in torch")

    monkeypatch.setattr(WF, "_intra_residuals", no_residuals)
    assert all(torch.equal(a, b)
               for a, b in zip(WF.decode_iframe_single(sym, 28), rec))


@pytest.mark.cuda
def test_wavefront_raises_without_fallback(dev, monkeypatch):
    """A kernel library that cannot be built, or an entry that reports a
    CUDA error at launch, raises: the plain versions are never taken."""
    y, u, v, qp = chip_smoke.wave_case(np, (2, 3, 4), "mix", 28)
    planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
    sym, _ = WF.encode_iframe_single(*planes, qp)
    lib = cuda_lib.load()
    plain = []
    monkeypatch.setattr(WF, "_encode_iframe_single_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(WF, "_decode_iframe_single_plain",
                        lambda *a, **k: plain.append(1))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        WF.encode_iframe_single(*planes, qp)
    with pytest.raises(RuntimeError, match="nvcc"):
        WF.decode_iframe_single(sym, qp)

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def th264_wavefront_encode(*args):
            return 9  # cudaErrorInvalidConfiguration

        @staticmethod
        def th264_wavefront_decode(*args):
            return 9

    monkeypatch.setattr(cuda_lib, "load", lambda: Refusing())
    with pytest.raises(RuntimeError, match="th264_wavefront_encode"):
        WF.encode_iframe_single(*planes, qp)
    with pytest.raises(RuntimeError, match="th264_wavefront_decode"):
        WF.decode_iframe_single(sym, qp)
    with pytest.raises(RuntimeError, match="th264_wavefront_encode"):
        WF.encode_iframe_single(*(p.to(torch.int32) for p in planes), qp)
    assert not plain


def test_wrappers_raise_off_cpu_without_fallback():
    """A tensor that is not on the CPU never reaches a plain version: on a
    device the kernel cannot take, the wrapper raises."""
    meta = torch.device("meta")
    before = _launches()
    y = torch.zeros((1, 32, 32), dtype=torch.int32, device=meta)
    g = torch.zeros((1, 58, 58), dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        me_cuda.sad_field(y, g)
    z = lambda *sh: torch.zeros(sh, dtype=torch.int32, device=meta)
    with pytest.raises(ValueError):
        cavlc_cuda.pack_blocks(z(8, 16), z(8), z(8), z(8, 2), z(8, 2), 20, 2)
    with pytest.raises(ValueError):
        cavlc_cuda.merge_tree(z(8, 3, 2), z(8, 3), 8)
    with pytest.raises(ValueError):
        DB.deblock_frame_rows(z(1, 32, 32), z(1, 16, 16), z(1, 16, 16),
                              z(1, 2, 2), z(1, 2, 2), z(1, 2, 2),
                              z(1, 2, 2, 4, 4), 30)
    with pytest.raises(ValueError):
        DB.deblock_i((z(1, 32, 32), z(1, 16, 16), z(1, 16, 16)), 30)
    assert _launches() == before


def test_library_rebuilt_when_vlc_tables_change(tmp_path, monkeypatch):
    """The built library is reused only while its generated table header
    matches the tables the plain versions read, and no source or shared
    header (csrc/*.cuh) is newer."""
    from tpuh264_torch.kernels import cuda_lib

    lib, header = tmp_path / "lib.so", tmp_path / "cavlc_tables.cuh"
    monkeypatch.setattr(cuda_lib, "LIB", str(lib))
    monkeypatch.setattr(cuda_lib, "HEADER", str(header))
    text = cuda_lib._tables_header()
    assert "__constant__ int kCT[" in text
    assert cuda_lib._stale(text)  # nothing built yet
    header.write_text(text)
    lib.write_bytes(b"")
    assert any(p.endswith(".cuh") for p in cuda_lib._deps())
    newest = max(map(os.path.getmtime, cuda_lib._deps()))
    os.utime(lib, (newest + 10, newest + 10))
    assert not cuda_lib._stale(text)
    assert cuda_lib._stale(text.replace("kRB", "kRB_changed"))
    os.utime(lib, (newest - 10, newest - 10))
    assert cuda_lib._stale(text)  # a source newer than the library


@pytest.mark.cuda
def test_pipeline_gpu_bytes_equal_cpu_bytes(dev):
    """64x48 x 2 streams, fixed QP, two dispatches: the pipeline on the
    card (kernels) gives the bytes and decoder planes of the pipeline on
    the CPU (plain versions), and launches every kernel."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline

    before = _launches()
    pipes = []
    for d in (dev, "cpu"):
        p = GOPDevicePipeline(CodecConfig(width=64, height=48, qp=28,
                                          streams=2, intra_in_p=False),
                              gop_size=8, source_kind="noise", device=d)
        p.pump_frame()
        p.pump_frame()
        pipes.append(p)
    gpu, cpu = pipes
    for si in range(2):
        assert gpu.stream_bytes(si) == cpu.stream_bytes(si)
    for a, b in zip(gpu.decoded_planes(), cpu.decoded_planes()):
        np.testing.assert_array_equal(a, b)
    after = _launches()
    # the RTC preset (intra_in_p=False) runs no intra-in-P scan (D4)
    assert all(after[k] > before[k] for k in after if k != "D4")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rigid", "moving_gradient"])
def test_float_sources_card_vs_cpu_within_one_level(dev, kind):
    """CUDA's sinf/cosf against the CPU's: the float sources may flip a
    truncated sample by one level, on at most 0.1% of samples; the
    integer "noise" source is exact."""
    from tpuh264_torch.engine.sources import device_source_gop

    for t in (0, 37):
        for a, b in zip(device_source_gop(1920, 1088, 4, 2, kind, t, dev),
                        device_source_gop(1920, 1088, 4, 2, kind, t, "cpu")):
            d = (a.cpu().int() - b.int()).abs()
            assert int(d.max()) <= 1
            assert float((d > 0).float().mean()) <= 1e-3
    for a, b in zip(device_source_gop(96, 64, 4, 3, "noise", 5, dev),
                    device_source_gop(96, 64, 4, 3, "noise", 5, "cpu")):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
def test_intra44_pred_directional_on_card(dev):
    """Integer matmul/einsum is not implemented for CUDA int tensors; the
    port's broadcast-and-sum form runs there and equals the CPU, as do
    the tie-breaking argmin and the causal MB encode / decode."""
    from tpuh264_torch.kernels import intra44 as I44

    rng = np.random.default_rng(11)
    n = torch.from_numpy(rng.integers(0, 256, (3, 50, 13)).astype(np.int32))
    got = I44.pred_directional(n.to(dev))
    torch.cuda.synchronize()
    assert got.dtype == torch.int32 and torch.equal(got.cpu(),
                                                    I44.pred_directional(n))
    ties = torch.from_numpy(rng.integers(0, 3, (500, 9)).astype(np.int32))
    assert torch.equal(I44.argmin_first(ties.to(dev)).cpu(),
                       I44.argmin_first(ties))
    src = torch.from_numpy(rng.integers(0, 256, (2, 6, 16, 16)).astype(
        np.int32))
    left = torch.from_numpy(rng.integers(0, 256, (2, 6, 16)).astype(np.int32))
    l_ok = torch.from_numpy(rng.random((2, 6)) < 0.6)
    for qp in (12, 30, 45):
        a = I44.encode_mb(src.to(dev), left.to(dev), l_ok.to(dev), qp)
        b = I44.encode_mb(src, left, l_ok, qp)
        for x, y in zip(a, b):
            assert torch.equal(x.cpu(), y)
        rec = I44.decode_mb(a[2], a[1], left.to(dev), l_ok.to(dev), qp)
        assert torch.equal(rec.cpu(), b[4])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["intra44 deblock", "2 refs", "temporal 3",
                                  "single slice"])
def test_session_on_card_equals_cpu(dev, case):
    """64x48 x 2 streams, 5 frames across an IDR: the session on the card
    (K1 in every P frame) emits the CPU session's bytes, and a pool on the
    card decodes them to the encoder's recon."""
    from tpuh264_torch.engine import CodecConfig, DecoderPool, EncoderSession
    from tpuh264_torch.engine import sources

    kw = {"intra44 deblock": dict(intra44=True, deblock=True, gop_size=3),
          "2 refs": dict(num_ref_frames=2, gop_size=4),
          "temporal 3": dict(temporal_layers=3, gop_size=4),
          "single slice": dict(slice_mode="single", gop_size=1)}[case]
    cfg = CodecConfig(width=64, height=48, streams=2, qp=28, **kw)
    encs = [EncoderSession(cfg, device=d) for d in (dev, "cpu")]
    pool = DecoderPool(device=dev)
    for i in range(2):
        pool.init_decoder(i)
    before = me_cuda.sad_field.launches
    for t in range(5):
        y, u, v = zip(*(sources.yuv_frame(64, 48, t, "noise", seed=s)
                        for s in range(2)))
        frame = [np.stack(p).astype(np.uint8) for p in (y, u, v)]
        gpu, cpu = (e.encode_frame_yuv(*frame) for e in encs)
        assert [f.data for f in gpu] == [f.data for f in cpu], t
        out = pool.decode_batch([(i, f.data) for i, f in enumerate(gpu)])
        for i in range(2):
            for p, r in zip(out[i], encs[0].recon):
                np.testing.assert_array_equal(p, r[i].cpu().numpy())
    assert (me_cuda.sad_field.launches > before) == (case != "single slice")


@pytest.mark.cuda
def test_general_stream_decodes_on_card(dev):
    """A stream whose P frame carries a 20-pel MV: on the card the session
    decodes the I frame on its fast path, then switches to the golden
    decoder, seeded from the card's DPB; both pictures equal the golden
    decode of the bytes, as uint8."""
    import chip_smoke
    from tpuh264_torch.engine import DecoderSession
    from tpuh264_torch.golden import codec as gcodec

    i_bytes, p_bytes = chip_smoke.general_stream(np)
    sess = DecoderSession(device=dev)
    outs = [sess.decode(i_bytes)]
    assert not sess._general
    outs.append(sess.decode(p_bytes))
    assert sess._general and sess.frames_concealed == 0
    for got, ref in zip(outs, gcodec.decode_annexb_seq(i_bytes + p_bytes)):
        for g, r in zip(got, ref):
            assert g.dtype == np.uint8
            np.testing.assert_array_equal(g, r)


@pytest.mark.cuda
def test_gate_small_on_card(dev):
    """The conformance gate at its smallest shape and its extended paths,
    on the card, against whichever oracle loads there."""
    from tpuh264_torch.conformance import gate

    before = _launches()
    a = gate.run_gate(((64, 48, 2, True),), device=dev, workers=2,
                      verbose=False)
    b = gate.run_gate_extended(device=dev, workers=2, verbose=False)
    assert (a["compared"], b["compared"]) == (2, 16)
    after = _launches()
    assert all(after[k] > before[k] for k in after)


def _flat_enc(o):
    return [*o[:-1], *o.rec]


def _p_both(kw, enc: bool):
    """K9 (enc) or K10 and its plain version on one input: one launch,
    every output equal (dtype and values)."""
    fn = TP._inter_encode if enc else TP._inter_decode
    plain = TP._inter_encode_plain if enc else TP._inter_decode_plain
    flat = _flat_enc if enc else (lambda o: [*o[0], *o[1]])
    before = fn.launches
    got, want = flat(fn(**kw)), flat(plain(**chip_smoke.plain_args(kw)))
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.K9_CASES, ids=str)
def test_pframe_encode_kernel_matches_plain_cases(dev, case):
    _p_both(chip_smoke.k9_args(torch, chip_smoke.k9_case(np, *case), dev),
            True)


@pytest.mark.cuda
@pytest.mark.parametrize("case", chip_smoke.K10_CASES, ids=str)
def test_pframe_decode_kernel_matches_plain_cases(dev, case):
    _p_both(chip_smoke.k10_args(torch, chip_smoke.k10_case(np, *case), dev),
            False)


@pytest.mark.cuda
def test_pframe_kernels_match_plain_1080p(dev):
    """The 1080p x 4 RTC P frame: its encode makes one K9 launch and its
    decode one K10 launch, neither calls a plain version, and each
    kernel equals its plain version on the captured inputs."""
    out, plain = [], []
    enc, = chip_smoke.capture(TP, "_inter_encode", lambda: out.append(
        chip_smoke.pframe_1080p(dev, torch)))
    y, u, v, sym, rec, mot = out[0]
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    real = (TP._inter_encode_plain, TP._inter_decode_plain)
    TP._inter_encode_plain = TP._inter_decode_plain = (
        lambda *a, **k: plain.append(1))
    try:
        dec, = chip_smoke.capture(TP, "_inter_decode", lambda: out.append(
            TP.decode_pframe_rows_multi(sym, *refs, 30)))
    finally:
        TP._inter_encode_plain, TP._inter_decode_plain = real
    assert not plain
    for a, b in zip((*out[1][0], *out[1][1]), (*rec, *mot)):
        assert torch.equal(a, b)
    _p_both(enc, True)
    _p_both(dec, False)


@pytest.mark.cuda
def test_pframe_wrappers_check_inputs_on_card(dev):
    """A bad dtype or shape raises before any launch."""
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(
        np, *chip_smoke.K9_CASES[17]), dev)
    dkw = chip_smoke.k10_args(torch, chip_smoke.k10_case(
        np, *chip_smoke.K10_CASES[9]), dev)
    before = (TP._inter_encode.launches, TP._inter_decode.launches)
    with pytest.raises(TypeError):
        TP._inter_encode(**{**kw, "iy0": kw["iy0"].long()})
    with pytest.raises(ValueError):
        TP._inter_encode(**{**kw, "gx": kw["gx"][:, :1]})
    with pytest.raises(ValueError):
        TP._inter_encode(**{**kw, "planes_l": [p[:, :, 1:] for p in
                                               kw["planes_l"]]})
    with pytest.raises(ValueError):
        TP._inter_decode(**{**dkw, "refs_up": dkw["refs_up"][:0]})
    with pytest.raises(TypeError):
        TP._inter_decode(**{**dkw, "planes_l": [p.float() for p in
                                                dkw["planes_l"]]})
    # planes of `_references`' shapes in another layout: int32, or uint8
    # rows without the 16-byte pitch
    with pytest.raises(TypeError):
        TP._inter_encode(**{**kw, "planes_l": [p.to(torch.int32) for p in
                                               kw["planes_l"]]})
    with pytest.raises(ValueError):
        TP._inter_decode(**{**dkw, "planes_l": [p.contiguous() for p in
                                                dkw["planes_l"]]})
    assert (TP._inter_encode.launches, TP._inter_decode.launches) == before


@pytest.mark.cuda
def test_pframe_raises_without_fallback(dev, monkeypatch):
    """A kernel library that cannot be built, or an entry that reports a
    CUDA error at launch, raises: the plain versions are never taken;
    with t8 both take them by argument (the CABAC + 8x8 route)."""
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(
        np, *chip_smoke.K9_CASES[20]), dev)
    dkw = chip_smoke.k10_args(torch, chip_smoke.k10_case(
        np, *chip_smoke.K10_CASES[12]), dev)
    lib = cuda_lib.load()
    plain = []
    monkeypatch.setattr(TP, "_inter_encode_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(TP, "_inter_decode_plain",
                        lambda *a, **k: plain.append(1))

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        TP._inter_encode(**kw)
    with pytest.raises(RuntimeError, match="nvcc"):
        TP._inter_decode(**dkw)

    class Refusing:
        def __getattr__(self, name):
            return getattr(lib, name)

        @staticmethod
        def th264_pframe_encode(*args):
            return 9  # cudaErrorInvalidConfiguration

        @staticmethod
        def th264_pframe_decode(*args):
            return 9

    monkeypatch.setattr(cuda_lib, "load", lambda: Refusing())
    with pytest.raises(RuntimeError, match="th264_pframe_encode"):
        TP._inter_encode(**kw)
    with pytest.raises(RuntimeError, match="th264_pframe_decode"):
        TP._inter_decode(**dkw)
    assert not plain
    TP._inter_encode(**{**kw, "t8": True})
    TP._inter_decode(**{**dkw, "t8": True})
    assert plain == [1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("kind,case", [("P1", c) for c in chip_smoke.P1_CASES]
                         + [("P2", c) for c in chip_smoke.P2_CASES], ids=str)
def test_probe_kernels_match_plain_cases(dev, kind, case):
    """P1 / P2 on the card == their plain versions on every seeded case:
    tails, offset views (16-byte aligned and not: the scalar route),
    ragged M * L, edge values, sums that wrap."""
    kernel, plain, make = ((probe.probe_bits, probe._probe_bits_plain,
                            chip_smoke.p1_case) if kind == "P1" else
                           (probe.slab_sum, probe._slab_sum_plain,
                            chip_smoke.p2_case))
    x = chip_smoke.offset_view(torch, make(np, *case[:2]), case[2], dev)
    assert torch.equal(kernel(x).cpu(), plain(x.cpu()))


@pytest.mark.cuda
def test_probe_entry_point_on_card(dev, capsys):
    """The probe's entry point on the card: both match lines, P1 and P2
    launched once each."""
    before = (probe.probe_bits.launches, probe.slab_sum.launches)
    assert probe.main(["--device", "cuda"]) == 0
    assert capsys.readouterr().out.splitlines() == [
        "match: True", "grid sum match: True"]
    assert (probe.probe_bits.launches - before[0],
            probe.slab_sum.launches - before[1]) == (1, 1)


@pytest.mark.cuda
def test_probe_wrappers_check_inputs_on_card(dev):
    """Another dtype, a strided view or another slab count raises before
    any launch."""
    x = torch.arange(64, dtype=torch.int32, device=dev)
    before = (probe.probe_bits.launches, probe.slab_sum.launches)
    with pytest.raises(TypeError):
        probe.probe_bits(x.long())
    with pytest.raises(ValueError):
        probe.probe_bits(x[::2])
    with pytest.raises(ValueError):
        probe.slab_sum(x.view(4, 4, 4))
    with pytest.raises(TypeError):
        probe.slab_sum(x.repeat(4).view(16, 4, 4).float())
    assert (probe.probe_bits.launches, probe.slab_sum.launches) == before
