"""The decoders' intra-reconstruction column scan (D2): the port's
decoders against the JAX package's on seeded symbols, the kernel's
source run on CPU threads against the plain version, and the router's
routes.

The inputs come from `chip_smoke.d2_case`, the generator chip_smoke.py
phase 2 holds the kernel to its plain version with on the card.  Every
comparison is exact (array_equal): this is an integer codec.
"""

import os
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
from tpuh264_torch.kernels import pframe as tpf

SOURCE = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc",
                      "intra_recon.cu")
I_FIELDS = [f for f in tif.MBSymbols._fields if f != "i4modes"]


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


def _build(tmp_path_factory, name, defines=()):
    return cuda_threads.build_entry(
        tmp_path_factory.mktemp(name), os.path.dirname(SOURCE),
        "intra_recon.cu", "k5_args", "intra_recon_kernel", "a.lanes",
        "kThreads", defines)


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
    assert ints[4:] == [9, 9, 9, 9, 400, 400, 400, 400]
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
            return tuple(x.to("meta") for x in v)
        if isinstance(v, types.SimpleNamespace):
            return types.SimpleNamespace(**{k: on(x)
                                            for k, x in vars(v).items()})
        return v.to("meta") if torch.is_tensor(v) else v
    return {k: on(v) for k, v in chip_smoke.d2_args(torch, case,
                                                    "cpu").items()}


def test_i44_goes_to_the_plain_version(monkeypatch):
    """With `i44` (the Intra_4x4 reconstruction, D5's work) the router
    takes the plain version by argument, on any device, without loading
    the kernel library; without it, a tensor off the CPU never reaches
    the plain version: on a device the kernel cannot take it raises."""
    calls = []

    def plain(*a, **kw):
        calls.append(a)
        return "plain"

    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(tif, "_intra_recon_scan_plain", plain)
    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = tif._intra_recon_scan.launches
    kw = _meta(_case(((1, 2, 3), "iframe")))
    s, r, c = kw["mode"].shape
    i44 = (torch.zeros((s, r, c, 16, 16), dtype=torch.int32, device="meta"),
           torch.zeros((s, r, c, 16), dtype=torch.int32, device="meta"), 30)
    assert tif._intra_recon_scan(**kw, i44=i44) == "plain"
    assert len(calls) == 1 and calls[0][7] is i44
    for k in (kw, _meta(_case(((1, 2, 3), "half")))):
        with pytest.raises(ValueError):
            tif._intra_recon_scan(**k)
    assert len(calls) == 1
    assert tif._intra_recon_scan.launches == before
