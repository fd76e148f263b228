"""The decoders' intra-reconstruction column scan (D2): the port's
decoders against the JAX package's on seeded symbols, the kernel's
source run on CPU threads against the plain version (its Intra_4x4 route
too), and the router's routes.

The inputs come from `chip_smoke.d2_case` and `d2_i44_case`, the
generators chip_smoke.py phase 2 holds the kernel to its plain version
with on the card.  Every comparison is exact (array_equal): this is an
integer codec.
"""

import concurrent.futures
import os
import subprocess
import types

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.kernels import iframe as jif
from tpuh264.kernels import pframe as jpf
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import iframe as tif
from tpuh264_torch.kernels import intra44 as I44
from tpuh264_torch.kernels import pframe as tpf

SOURCE = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc",
                      "intra_recon.cu")
CSRC = os.path.dirname(SOURCE)
I_FIELDS = [f for f in tif.MBSymbols._fields if f != "i4modes"]
# the instance the entry launches: the Intra_4x4 route where i4modes is
# given
KERNEL = "(a.i4m ? intra_recon_kernel<true> : intra_recon_kernel<false>)"


def _case(case):
    return chip_smoke.d2_case(np, *case)


def _plain(case):
    """The plain scan's int32 output on the case's CPU inputs."""
    return tif._intra_recon_scan_plain(**chip_smoke.d2_args(torch, case,
                                                            "cpu"))


@pytest.mark.parametrize("shape,variant,qp", [
    (*c, chip_smoke.D2_QP) for c in chip_smoke.D2_CASES]
    + chip_smoke.D2_QP_CASES)
def test_decode_matches_jax(shape, variant, qp):
    """The port's P decode (`decode_pframe_rows_multi`: skip, inter and
    intra MBs at the case's share) and I decode (`decode_iframe_scan`,
    the "iframe" variant) equal the JAX package's on the same symbols, at
    QP 32 and at QPs 0 and 51."""
    sym, _, refs, qp = _case((shape, variant, qp))
    if refs is None:
        j = jif.decode_iframe_scan(
            jif.MBSymbols(**{f: sym[f] for f in I_FIELDS}), qp)
        t = tif.decode_iframe_scan(
            tif.MBSymbols(**{f: torch.from_numpy(sym[f]) for f in I_FIELDS}),
            qp)
    else:
        j, jm = jpf.decode_pframe_rows_multi(jpf.MBSymbolsP(**sym), *refs,
                                             qp)
        t, tm = tpf.decode_pframe_rows_multi(
            tpf.MBSymbolsP(**{k: torch.from_numpy(v)
                              for k, v in sym.items()}),
            *map(torch.from_numpy, refs), qp)
        for a, b in zip(jm, tm):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(j, t):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_cases_cover_what_they_claim():
    """C = 1, 2, 3 and a long lane of C >= 54; S and R from 1 to 4; intra
    shares 0, ~1% (at least one MB), 50% and 100%, and the I decode
    without `other`; legal modes (column 0 DC) but in the two "-col0"
    variants, whose column 0 is all intra with luma H, chroma H and both;
    luma and chroma DC and H both chosen in later columns; prediction +
    residual past 0 and past 255 (the clip), and inter MBs with MVs."""
    shapes = set(chip_smoke.D2_SHAPES)
    assert {1, 2, 3} <= {c for _, _, c in shapes}
    assert any(c >= 54 for _, _, c in shapes)
    assert {s for s, _, _ in shapes} == {1, 2, 3, 4}
    assert {r for _, r, _ in shapes} == {1, 2, 3, 4}
    long = max(shapes, key=lambda x: x[2])
    lmodes, cmodes, clipped = set(), set(), set()
    for variant in chip_smoke.D2_VARIANTS:
        sym, other, refs, _ = _case((long, variant))
        intra = sym["kind"] == 2
        share = intra.mean()
        want = chip_smoke.D2_SHARE[variant]
        assert ((other is None) == (refs is None)
                == variant.startswith("iframe"))
        if variant == "sparse":
            assert 0 < share < 0.05
        else:
            assert share == pytest.approx(want, abs=0.1)
        modes0 = set(zip(sym["mode"][..., 0][intra[..., 0]],
                         sym["cmode"][..., 0][intra[..., 0]]))
        if variant.endswith("col0"):
            assert intra[..., 0].all()
            assert modes0 == {(1, 1), (1, 0), (2, 1), (2, 0)}
        else:
            assert modes0 <= {(2, 0)}
        assert set(np.unique(sym["mode"][intra])) <= {1, 2}
        assert set(np.unique(sym["cmode"][intra])) <= {0, 1}
        lmodes |= set(np.unique(sym["mode"][..., 1:][intra[..., 1:]]))
        cmodes |= set(np.unique(sym["cmode"][..., 1:][intra[..., 1:]]))
        if variant == "half":
            assert (sym["mvdx"][sym["kind"] == 1] != 0).any()
            assert (sym["kind"] == 0).any() and (sym["kind"] == 1).any()
        out = _plain((sym, other, refs, chip_smoke.D2_QP))
        for o in out:
            o = o.numpy()[intra]
            clipped |= {v for v in (0, 255) if (o == v).any()}
    assert lmodes == {1, 2} and cmodes == {0, 1}
    assert clipped == {0, 255}


def _decode_both(sym, refs, qp):
    """The JAX package's decode of the symbols and the port's (the I
    decode where `refs` is None, else the P decode): their planes."""
    if refs is None:
        f = {k: sym[k] for k in I_FIELDS}
        j = jif.decode_iframe_scan(jif.MBSymbols(**f), qp)
        t = tif.decode_iframe_scan(tif.MBSymbols(
            **{k: torch.from_numpy(v) for k, v in f.items()}), qp)
    else:
        j, _ = jpf.decode_pframe_rows_multi(jpf.MBSymbolsP(**sym), *refs, qp)
        t, _ = tpf.decode_pframe_rows_multi(
            tpf.MBSymbolsP(**{k: torch.from_numpy(v) for k, v in sym.items()}),
            *map(torch.from_numpy, refs), qp)
    return [np.asarray(a) for a in j], [b.numpy() for b in t]


@pytest.mark.parametrize("variant", ("col0", "iframe-col0"))
def test_column0_h_modes_match_jax(variant):
    """Streams no encoder of the codec emits: intra MBs in column 0 with
    luma H (mode 1), chroma H (cmode 1), and both, lane by lane.  The JAX
    scans start from a zero carry, so H predicts 0 there and DC 128; the
    port's P decode (`decode_pframe_rows_multi`) and I decode
    (`decode_iframe_scan`) give the same pixels.  Against the same
    symbols with DC in column 0, column 0 differs exactly in the lanes
    and planes that code H there."""
    sym, _, refs, qp = _case(((2, 4, 2), variant))
    j, t = _decode_both(sym, refs, qp)
    for a, b in zip(j, t):
        np.testing.assert_array_equal(a, b)
    first = (sym["kind"] == 2) & (np.arange(2) == 0)
    dc = dict(sym, mode=np.where(first, 2, sym["mode"]),
              cmode=np.where(first, 0, sym["cmode"]))
    _, t_dc = _decode_both(dc, refs, qp)
    s, r = sym["mode"].shape[:2]
    for plane, n, want in ((0, 16, sym["mode"][..., 0] == 1),
                           (1, 8, sym["cmode"][..., 0] == 1),
                           (2, 8, sym["cmode"][..., 0] == 1)):
        assert want.any() and not want.all()
        diff = (t[plane] != t_dc[plane])[..., :n]
        diff = diff.reshape(s, r, n, n).any((-1, -2))
        np.testing.assert_array_equal(diff, want)


def _build(tmp_path_factory, name, defines=(), csrc=CSRC):
    return cuda_threads.build_entry(
        tmp_path_factory.mktemp(name), csrc, "intra_recon.cu", "k5_args",
        KERNEL, "a.lanes", "kThreads", defines)


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """csrc/intra_recon.cu (all but its launch entry) built with g++
    against the shims of cuda_threads.py: the kernel's own source, a
    lane's block (the prediction warp and the workers) as fibers, its
    shuffles, warp barriers and ring waits switching between them."""
    return _build(tmp_path_factory, "intra_recon_cpu")


@pytest.fixture(scope="module")
def cpu_kernel_small(tmp_path_factory):
    """The same with a ring of 3 columns and 2 workers (`K5_RING`,
    `K5_WORKERS`): short lanes wrap the ring many times over, and a
    worker waits for its slot."""
    return _build(tmp_path_factory, "intra_recon_cpu_small",
                  ("K5_RING=3", "K5_WORKERS=2"))


def _source_equals_plain(exe, kw, what):
    """The kernel's source on CPU threads over `_k5_operands` of the
    arguments `kw` equals the plain version's output."""
    ins, outs, ints = tif._k5_operands(**kw)
    got = cuda_threads.run_entry(exe, ins, outs, ints)
    for g, w in zip(got, tif._intra_recon_scan_plain(**kw)):
        assert g.dtype == w.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=what)


@pytest.mark.parametrize("case", [(*c, chip_smoke.D2_QP)
                                  for c in chip_smoke.D2_CASES]
                         + chip_smoke.D2_QP_CASES, ids=str)
def test_kernel_source_on_cpu_threads_matches_plain(cpu_kernel, case):
    """The kernel's chunk layout, level loads masked by the cbps, the
    residual decode through shared memory (a 4x4 block a lane), shuffles,
    flag windows and ring of columns in flight, run a lane's 32 threads
    at a time, equal the plain version (`_intra_residuals`, then the
    column loop) on the case: I frames, P frames of skip, inter and intra
    MBs, levels that the cbps mask out, QPs 0, 32 and 51."""
    _source_equals_plain(cpu_kernel, chip_smoke.d2_args(
        torch, _case(case), "cpu"), str(case))


@pytest.mark.parametrize("small", (False, True), ids=("ring8", "ring3"))
@pytest.mark.parametrize("case", chip_smoke.D2_RING_CASES, ids=str)
def test_kernel_source_wraps_the_ring(cpu_kernel, cpu_kernel_small, case,
                                      small):
    """The prediction warp and the workers meet through the ring of
    columns (ready counts a slot, one consumed count) as the plain
    version's column loop: all-intra lanes of 97 columns, runs of intra
    and `other` columns (a worker leaves the left samples of an `other`
    column before an intra one), C = 1; with the default ring and with a
    ring of 3 columns and 2 workers."""
    exe = cpu_kernel_small if small else cpu_kernel
    _source_equals_plain(exe, chip_smoke.d2_args(torch, _case(case), "cpu"),
                         str(case))


def test_ring_cases_cover_what_they_claim():
    """D2_RING_CASES: an all-intra P decode and an I decode of 97 columns
    (past the ring of 8 and a worker's window of 32 columns); lanes of
    runs of intra and `other` columns, runs of 1 to 13 (longer than the
    ring) starting on either kind; C = 1."""
    seen = set()
    for case in chip_smoke.D2_RING_CASES:
        sym, other, _, _ = _case(case)
        intra = sym["kind"] == 2
        c = intra.shape[-1]
        if c == 97 and intra.all():
            seen.add("iframe" if other is None else "intra")
        if case[1] == "runs" and c > 1:
            edges = np.diff(intra.astype(np.int8), axis=-1)
            assert (edges == 1).any() and (edges == -1).any()
            assert intra[..., 0].any() and (~intra[..., 0]).any()
            seen.add("runs")
            if c >= 2 * max(chip_smoke.D2_RUNS):
                seen.add("long runs")
        if c == 1:
            seen.add("C = 1")
    assert seen == {"iframe", "intra", "runs", "long runs", "C = 1"}


@pytest.mark.parametrize("variant", ("half", "iframe"))
def test_kernel_source_reads_record_slots(cpu_kernel, variant):
    """The GOP decode's symbols are strided views of its records (MB
    fields [.., 9] int32, levels [.., 400] int16 slots,
    `devpipe.record_symbols`): the router passes them as they are, each
    field with its MB stride (9 and 400, no copy), and the kernel reads
    them so, equal to the plain version."""
    from tpuh264_torch.engine import devpipe

    kw = chip_smoke.d2_args(torch, _case(((2, 2, 61), variant)), "cpu")
    t = kw["levels"]
    mb = tuple(t.mode.shape)
    m = torch.stack([t.kind, t.mode, t.cmode, t.cbp_luma, t.cbp_chroma,
                     t.mvdx, t.mvdy, t.refidx, t.refidx], -1)
    cf = torch.cat([t.luma_dc, t.luma_ac.reshape(*mb, 256),
                    t.chroma_dc.reshape(*mb, 8),
                    t.chroma_ac.reshape(*mb, 120)], -1)
    sym = devpipe.record_symbols(m.contiguous(), cf.contiguous())
    kw = dict(kw, mode=sym.mode, cmode=sym.cmode, levels=sym)
    ins, _, ints = tif._k5_operands(**kw)
    assert ints[4:12] == [9, 9, 9, 9, 400, 400, 400, 400]
    assert ins[0].data_ptr() == sym.mode.data_ptr()
    assert ins[6].data_ptr() == sym.luma_ac.data_ptr()
    _source_equals_plain(cpu_kernel, kw, variant)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On CPU tensors the router (and both decoders through it) takes the
    plain version: the kernel library is never loaded and the launch
    counter does not move."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = tif._intra_recon_scan.launches
    case = _case(((2, 2, 3), "half"))
    kw = chip_smoke.d2_args(torch, case, "cpu")
    out = tif._intra_recon_scan(**kw)
    for a, b in zip(out, tif._intra_recon_scan_plain(**kw)):
        assert a.dtype == torch.int32 and torch.equal(a, b)
    sym, _, refs, qp = case
    tpf.decode_pframe_rows_multi(
        tpf.MBSymbolsP(**{k: torch.from_numpy(v) for k, v in sym.items()}),
        *map(torch.from_numpy, refs), qp)
    tif.decode_iframe_scan(
        tif.MBSymbols(**{f: torch.from_numpy(sym[f]) for f in I_FIELDS}), qp)
    assert tif._intra_recon_scan.launches == before


def _meta(case):
    def on(v):
        if isinstance(v, tuple):
            return tuple(on(x) for x in v)
        if isinstance(v, types.SimpleNamespace):
            return types.SimpleNamespace(**{k: on(x)
                                            for k, x in vars(v).items()})
        return v.to("meta") if torch.is_tensor(v) else v
    return {k: on(v) for k, v in chip_smoke.d2_args(torch, case,
                                                    "cpu").items()}


def test_i44_calls_reach_the_kernel(monkeypatch):
    """With `i44` (the Intra_4x4 reconstruction) a tensor off the CPU
    never reaches the plain version: on a device the kernel cannot take,
    or at a QP outside 0..51 (the scan's or i44's), the router raises
    before any launch; where the device checks pass, it reaches K5's entry
    with the route's operands (i4modes, the i44 levels, the tap words, the
    i44 QP and strides) and counts a launch of the route."""
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran off the CPU")

    monkeypatch.setattr(tif, "_intra_recon_scan_plain", refuse)
    kw = _meta(_i44_case(((1, 2, 3), "mix", 30)))
    before = (tif._intra_recon_scan.launches,
              tif._intra_recon_scan.i44_launches)
    coef, i4m, _ = kw["i44"]
    for bad in (kw, dict(kw, qp=52), dict(kw, i44=(coef, i4m, -1))):
        with pytest.raises(ValueError):
            tif._intra_recon_scan(**bad)
    # past the device checks (meta tensors standing in for the card's)
    entries, ops = [], []

    class Lib:
        def __getattr__(self, name):
            return lambda p, n, stream: entries.append((name, list(n))) or 0

    real = tif._k5_operands
    monkeypatch.setattr(tif, "_k5_operands", lambda *a, **k: (
        ops.append(real(*a, **k)) or ops[-1]))
    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "check_devices", lambda *a: None)
    monkeypatch.setattr(cuda_lib, "stream", lambda dev: None)
    tif._intra_recon_scan(**dict(kw, i44=(coef, i4m, 29)))
    ins, _, ints = ops[0]
    assert [e[0] for e in entries] == ["th264_intra_recon_rows"]
    assert ins[12] is i4m and ins[13] is coef and ins[14] is not None
    assert ints[12:] == [29, 16, 256]
    assert (tif._intra_recon_scan.launches,
            tif._intra_recon_scan.i44_launches) == (before[0] + 1,
                                                    before[1] + 1)


# -- the Intra_4x4 route (`i44`) ---------------------------------------------

def _i44_case(case):
    return chip_smoke.d2_i44_case(np, *case)


def _i44_args(case):
    return chip_smoke.d2_args(torch, _i44_case(case), "cpu")


@pytest.mark.parametrize("case", chip_smoke.D2_I44_CASES
                         + [chip_smoke.D2_I44_LEVEL_CASE], ids=str)
def test_i44_source_on_cpu_threads_matches_plain(cpu_kernel, case):
    """The Intra_4x4 route's source on CPU threads (every luma level of a
    mode-4 MB loaded whatever its cbps, the block modes clamped, the 16
    blocks walked by their dependency levels through shared memory, a
    half-warp a block, their neighbours and taps by shuffles within the
    half) equals `_intra_recon_scan_plain` with `i44`: every MB of mode 4,
    Intra_16x16 and Intra_4x4 mixed, both beside `other`, at QPs 0, 12,
    32 and 51, and the level case (the two blocks of every two-block
    level of different modes)."""
    _source_equals_plain(cpu_kernel, _i44_args(case), str(case))


@pytest.mark.parametrize("small", (False, True), ids=("ring8", "ring3"))
@pytest.mark.parametrize("case", chip_smoke.D2_I44_RING_CASES, ids=str)
def test_i44_source_wraps_the_ring(cpu_kernel, cpu_kernel_small, case,
                                   small):
    """The route through the ring of columns (each slot's block modes
    beside its residuals): lanes of 97 and 40 columns, with the default
    ring and with a ring of 3 columns and 2 workers."""
    _source_equals_plain(cpu_kernel_small if small else cpu_kernel,
                         _i44_args(case), str(case))


def test_i44_source_takes_i4modes_of_any_type(cpu_kernel):
    """int32 block modes, beyond int16 too: the router clamps them before
    the kernel reads them as int16, as the plain version's `_select`
    clamps, and the results are equal."""
    kw = _i44_args(((2, 2, 9), "mix", 30))
    coef, i4m, qp = kw["i44"]
    i4m = i4m.to(torch.int32)
    i4m[..., ::5] = torch.tensor([70000, -70000, 8, 65536])[
        torch.arange(i4m[..., ::5].numel()) % 4].reshape(i4m[..., ::5].shape)
    _source_equals_plain(cpu_kernel, dict(kw, i44=(coef, i4m, qp)),
                         "int32 i4modes")


def test_i44_source_matches_jax(cpu_kernel):
    """The route's source on CPU threads equals JAX's
    `decode_iframe_scan(intra44=True)` on the same symbols (modes in 0..8:
    JAX does not clamp), Intra_16x16 and Intra_4x4 MBs mixed."""
    sym, _, _, qp = _i44_case(((3, 2, 3), "mix", 32))
    sym = dict(sym, i4modes=np.clip(sym["i4modes"], 0, 8))
    want = jif.decode_iframe_scan(jif.MBSymbols(
        **{f: sym[f] for f in tif.MBSymbols._fields}), qp, intra44=True)
    kw = chip_smoke.d2_args(torch, (sym, None, None, qp), "cpu")
    got = cuda_threads.run_entry(cpu_kernel, *tif._k5_operands(**kw))
    for a, b in zip(want, got):
        np.testing.assert_array_equal(
            np.asarray(a), tif._mbs_to_plane(b.to(torch.uint8)).numpy())


def test_i44_cases_cover_what_they_claim():
    """D2_I44_CASES and D2_I44_RING_CASES: all-Intra_4x4 lanes and columns
    mixing Intra_16x16 and Intra_4x4 MBs, with and without `other`; mode
    4 in column 0; every mode 0-8 at every block position among the mode-4
    MBs (the top row, where T is zero, included) and modes outside 0..8;
    DC where only T is available (column 0, blocks below the top row);
    nonzero levels in blocks that the 4-bit cbp_luma does not code, slot 0
    included; QPs 0, 12 and 51; recon at 0 and 255; lanes past the ring."""
    seen, pairs, qps, clipped = set(), set(), set(), set()
    for case in chip_smoke.D2_I44_CASES + chip_smoke.D2_I44_RING_CASES:
        sym, other, _, qp = _i44_case(case)
        qps.add(qp)
        i4 = sym["mode"] == 4
        m = sym["i4modes"][i4]
        for bi in range(16):
            pairs |= {(bi, int(x)) for x in np.unique(m[:, bi]) if 0 <= x <= 8}
        if ((m < 0) | (m > 8)).any():
            seen.add("wild")
        if i4.all():
            seen.add("all i4")
        if (i4.any(axis=(0, 1)) & (~i4 & (sym["kind"] == 2)).any(
                axis=(0, 1))).any():
            seen.add("mixed column")
        if other is not None and i4.any():
            seen.add("other")
        if i4[..., 0].any():
            seen.add("column 0")
        dc_t = sym["i4modes"][..., 0, :][i4[..., 0]][:, [2, 3, 8, 10]] == 2
        if dc_t.any():  # z-scan blocks 2, 3, 8, 10: bx 0, by > 0
            seen.add("DC from T alone")
        blk = np.arange(16)  # raster 4 by + bx, in 8x8 (by >> 1, bx >> 1)
        i8 = ((blk >> 3) << 1) | ((blk >> 1) & 1)
        coded = (sym["cbp_luma"][i4][:, None] >> i8) & 1
        if ((sym["luma_ac"][i4] != 0).any(-1) & (coded == 0)).any():
            seen.add("levels outside cbp")
        if (sym["luma_ac"][i4][..., 0] != 0).any():
            seen.add("slot 0")
        if case[0][2] > 8:
            seen.add("past the ring")
        out = tif._intra_recon_scan_plain(**chip_smoke.d2_args(
            torch, (sym, other, None, qp), "cpu"))[0].numpy()[i4]
        clipped |= {v for v in (0, 255) if (out == v).any()}
    assert pairs == {(bi, m) for bi in range(16) for m in range(9)}
    assert seen == {"wild", "all i4", "mixed column", "other", "column 0",
                    "DC from T alone", "levels outside cbp", "slot 0",
                    "past the ring"}
    assert {0, 12, 51} <= qps and clipped == {0, 255}


def test_i44_level_case_covers_what_it_claims():
    """D2_I44_LEVEL_CASE: every MB of mode 4, block modes in 0..8, and the
    two blocks of each two-block level of the header's table
    (I44_LEVEL_PAIRS, held to it in the header test) of different modes
    in every MB, DC beside a directional mode among them."""
    sym, other, _, _ = _i44_case(chip_smoke.D2_I44_LEVEL_CASE)
    m = sym["i4modes"]
    assert other is None and (sym["mode"] == 4).all()
    assert set(np.unique(m)) == set(range(9))
    for a, b in chip_smoke.I44_LEVEL_PAIRS:
        assert (m[..., a] != m[..., b]).all()
        assert ((m[..., a] == 2) != (m[..., b] == 2)).any()


def test_tap_words_are_the_tables():
    """The tap words the kernel takes as its operand (`intra44.tap_words`)
    decode to the port's own W, R and S of the eight directional modes
    (`_build_tables`), and mode 2 (DC) to nothing."""
    w = I44.tap_words().astype(np.int64).reshape(9, 16)
    m, p = np.meshgrid(np.arange(9), np.arange(16), indexing="ij")
    W = np.zeros((9, 16, 13), np.int64)
    for j in range(3):
        np.add.at(W, (m, p, (w >> (4 * j)) & 15), (w >> (12 + 2 * j)) & 3)
    np.testing.assert_array_equal(W, I44._W_NP)
    np.testing.assert_array_equal((w >> 18) & 3, I44._R_NP)
    np.testing.assert_array_equal((w >> 20) & 3, I44._S_NP)
    assert not w[2].any() and not (w >> 22).any()
    # the kernels tell DC by its word of 0: every other word has a tap
    assert np.delete(w, 2, 0).all()


FORM_HARNESS = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include "intra44_common.cuh"
int main() {
  for (int k = 0; k < 13; ++k)
    printf("%d %d\n", i44_ring_prev(k), i44_ring_next(k));
  unsigned w;
  while (scanf("%u", &w) == 1) printf("%u\n", i44_form(w));
}
"""


def test_tap_word_forms_are_the_tables(tmp_path):
    """The encoder's trial takes each directional prediction as one byte
    of a neighbour's packed word (intra44_common.cuh `i44_form`,
    `i44_filtered`): the neighbour itself, its 2-tap mean with its ring
    successor or its 3-tap filter, along the ring L3 .. L0, X, T0 .. TR3
    (an end its own neighbour).  The header's ring is that one, and the
    form of every directional tap word gives the tap formula's value (the
    port's W, R and S) on random 0..255 neighbours."""
    exe = cuda_threads.build(tmp_path, FORM_HARNESS, CSRC, "i44_forms")
    words = I44.tap_words().astype(np.int64)
    out = subprocess.run([exe], input=" ".join(map(str, words)),
                         capture_output=True, check=True, text=True).stdout
    rows = out.split("\n")
    prev, nxt = zip(*(map(int, r.split()) for r in rows[:13]))
    ring = [3, 2, 1, 0] + list(range(4, 13))
    for i, k in enumerate(ring):
        assert prev[k] == ring[max(i - 1, 0)] and nxt[k] == ring[min(i + 1,
                                                                    12)]
    form = np.array(list(map(int, rows[13:13 + 144])), np.int64)
    assert ((form & 0xfff0) == 0x4440).all() and (form & 0xf).max() <= 2
    n = np.random.default_rng(29).integers(0, 256, (500, 13))
    pv, nx = n[:, list(prev)], n[:, list(nxt)]
    packed = np.stack([n, (n + nx + 1) >> 1, (pv + 2 * n + nx + 2) >> 2], 1)
    for m in (0, 1, 3, 4, 5, 6, 7, 8):
        for p in range(16):
            x = int(words[16 * m + p])
            want = (sum(n[:, (x >> 4 * j) & 15] * ((x >> 12 + 2 * j) & 3)
                        for j in range(3)) + ((x >> 18) & 3)) >> (
                            (x >> 20) & 3)
            f = int(form[16 * m + p])
            np.testing.assert_array_equal(packed[:, f & 3, f >> 16], want,
                                          err_msg=f"mode {m} pixel {p}")


def edit(text, old, new):
    """`text` with the replacement old -> new, each exactly once where
    old and new are tuples of replacements."""
    olds, news = ((old,), (new,)) if isinstance(old, str) else (old, new)
    for o, n in zip(olds, news):
        assert text.count(o) == 1, o
        text = text.replace(o, n)
    return text


# the level table of intra44_common.cuh with block 4 one level early,
# beside block 1 (block 2 then alone on level 2): the second blocks'
# nibbles
LEVEL_TABLE_EDIT = ("0xfedc985410ull", "0xfedc985240ull")


def _levels_of_scan():
    """The dependency levels of the 16 blocks, derived from the port's
    z-scan order (BLK_SCAN) and `_static_tr_kind`: a block one level above
    the highest block it reads (L, T, X and TR where "real", inside the
    MB).  Returns (each block's level, each block's blocks read)."""
    at = {xy: bi for bi, xy in enumerate(I44.BLK_SCAN)}
    level, reads = [], []
    for bi, (bx, by) in enumerate(I44.BLK_SCAN):
        nb = [(bx - 1, by), (bx, by - 1), (bx - 1, by - 1)]
        if I44._static_tr_kind(bi) == "real":
            nb.append((bx + 1, by - 1))
        reads.append([at[xy] for xy in nb if xy in at])
        assert all(b < bi for b in reads[-1])  # decoded before it
        level.append(1 + max((level[b] for b in reads[-1]), default=-1))
    return level, reads


LEVEL_HARNESS = (
    "#include <cuda_runtime.h>\n#include <cstdio>\n"
    '#include "intra44_common.cuh"\n'
    "int main() {\n  for (int bi = 0; bi < 16; ++bi) {\n"
    '    printf("%d %d %d", blk_x(bi), blk_y(bi), (int)tr_real(bi));\n'
    '    for (int k = 0; k < 13; ++k) printf(" %d", i44_neighbour(bi, k));\n'
    '    printf("\\n");\n  }\n'
    '  printf("%d %d\\n", kI44Levels, (int)i44_levels_hold());\n'
    "  for (int l = 0; l < kI44Levels; ++l)\n"
    '    printf("%d %d\\n", i44_level_block(l, 0), i44_level_block(l, 1));\n'
    "}\n")


def test_header_block_rules_are_the_plain_versions(tmp_path):
    """intra44_common.cuh's z-scan position, top-right kind and neighbour
    samples of every block, compiled by g++ against the shims, are
    BLK_SCAN, `_static_tr_kind` and the samples `_gather_neighbors`
    reads (L, X, T, TR; row -1 the zeros above the slice); and its level
    table, which the kernels walk, is the dependency levels of that scan
    order and those TR rules: 10 levels of at most two blocks, every block
    a block reads on a lower level.  A table that moves a block one level
    early does not compile (its static_assert)."""
    exe = cuda_threads.build(tmp_path, LEVEL_HARNESS, CSRC, "i44_rules")
    rows = subprocess.run([exe], capture_output=True, check=True,
                          text=True).stdout.split("\n")
    at = lambda x, y: (y + 1) * 20 + x + 4
    for bi, (bx, by) in enumerate(I44.BLK_SCAN):
        real = I44._static_tr_kind(bi) == "real"
        x0, y0 = 4 * bx, 4 * by
        want = ([bx, by, int(real)]
                + [at(x0 - 1, y0 + k) for k in range(4)]
                + [at(x0 - 1, y0 - 1)] + [at(x0 + k, y0 - 1) for k in range(4)]
                + [at(x0 + (4 + k if real else 3), y0 - 1) for k in range(4)])
        assert list(map(int, rows[bi].split())) == want, bi
    level, reads = _levels_of_scan()
    assert max(level) + 1 == 10
    assert all(level[b] < level[bi] for bi in range(16) for b in reads[bi])
    groups = [[bi for bi in range(16) if level[bi] == lv] for lv in range(10)]
    assert max(map(len, groups)) == 2
    assert rows[16].split() == ["10", "1"]
    table = [list(map(int, r.split())) for r in rows[17:27]]
    assert [sorted(set(t)) for t in table] == groups
    assert tuple(tuple(g) for g in groups if len(g) == 2) == (
        chip_smoke.I44_LEVEL_PAIRS)
    # the static_assert refuses a table with block 4 beside block 1
    bad = tmp_path / "bad"
    bad.mkdir()
    with open(os.path.join(CSRC, "intra44_common.cuh")) as fh:
        (bad / "intra44_common.cuh").write_text(edit(fh.read(),
                                                     *LEVEL_TABLE_EDIT))
    with pytest.raises(subprocess.CalledProcessError):
        cuda_threads.build(bad, LEVEL_HARNESS, str(bad), "i44_bad")


# mutants of the Intra_4x4 route, each a replacement in a source (or a
# tuple of them): TR real where `_static_tr_kind` repeats T3; DC of 128
# where only T is available; the blocks walked in raster order, not
# z-scan; the 4-bit cbp_luma masking a mode-4 MB's levels; block 4 one
# level early, beside block 1 (the table's static_assert taken out, which
# would refuse it); no hand-off between levels (the warp barrier after a
# level's stores)
I44_MUTANTS = {
    "TR real where repeated": (
        "intra44_common.cuh",
        "  return blk_y(bi) > 0 && blk_x(bi) < 3 &&\n"
        "         blk_z(blk_x(bi) + 1, blk_y(bi) - 1) < bi;",
        "  return blk_y(bi) > 0 && blk_x(bi) < 3;"),
    "DC 128 with T alone": (
        "intra44_common.cuh",
        "if (l_ok || t_ok) return (int)((l_ok ? sl : st) + 2u) >> 2;",
        "if (l_ok) return (int)(sl + 2u) >> 2;"),
    "raster order": (
        "intra44_common.cuh",
        "  return (bi & 1) | ((bi >> 1) & 2);\n}\n"
        "__host__ __device__ constexpr int blk_y(int bi) {\n"
        "  return ((bi >> 1) & 1) | ((bi >> 2) & 2);",
        "  return bi & 3;\n}\n"
        "__host__ __device__ constexpr int blk_y(int bi) {\n"
        "  return bi >> 2;"),
    "cbp_luma mask": (
        "intra_recon.cu", "i4 ? ld16(a.ac44 + m * a.sac44 + 8 * t)",
        "i4 ? (((a.cbp_l[m * a.scl] >> (((t >> 4) << 1) | ((t >> 2) & 1)))"
        " & 1) ? ld16(a.ac44 + m * a.sac44 + 8 * t) : z)"),
    "block 4 beside block 1": (
        "intra44_common.cuh",
        (LEVEL_TABLE_EDIT[0], "static_assert(i44_levels_hold(),"),
        (LEVEL_TABLE_EDIT[1], "static_assert(true || i44_levels_hold(),")),
    "no hand-off between levels": (
        "intra_recon.cu", "    __syncwarp();  // the level is written\n", ""),
}


@pytest.fixture(scope="module")
def i44_mutants(tmp_path_factory):
    """The I44_MUTANTS, each a copy of csrc with its replacement, built
    all at once (the directories made first: tmp_path_factory is not
    thread-safe)."""
    jobs = []
    for name, (src, old, new) in I44_MUTANTS.items():
        d = tmp_path_factory.mktemp("i44_mutant_src")
        for f in os.listdir(CSRC):
            with open(os.path.join(CSRC, f)) as fh:
                text = fh.read()
            if f == src:
                text = edit(text, old, new)
            (d / f).write_text(text)
        jobs.append((name, tmp_path_factory.mktemp("i44_mutant"), str(d)))

    def one(job):
        name, out, csrc = job
        return name, cuda_threads.build_entry(
            out, csrc, "intra_recon.cu", "k5_args", KERNEL, "a.lanes",
            "kThreads")

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(one, jobs))


@pytest.mark.parametrize("name", I44_MUTANTS)
def test_i44_mutants_fail(i44_mutants, name):
    """Each mutant of the Intra_4x4 route differs from the plain version
    on some case of D2_I44_CASES."""
    for case in chip_smoke.D2_I44_CASES:
        kw = _i44_args(case)
        got = cuda_threads.run_entry(i44_mutants[name], *tif._k5_operands(
            **kw))
        want = tif._intra_recon_scan_plain(**kw)
        if any(not torch.equal(g, w) for g, w in zip(got, want)):
            return
    pytest.fail(f"mutant {name!r} passed every case")
