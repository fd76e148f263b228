"""K9 (the P encode after stage A) and K10 (the P decode's inter part):
their sources run on CPU threads against the plain versions, both
routes (the 8x8 transform's, t8, too), the plain paths against the JAX
package's P encode and decode, and the routers.

The kernels' inputs come from `chip_smoke.k9_case` / `k10_case`, the
generators chip_smoke.py phase 2 holds the kernels to their plain
versions with on the card (`K9_CASES`, `K10_CASES`, and for t8
`K9_T8_CASES`, `K10_T8_CASES`).  Every comparison is exact
(array_equal): this is an integer codec.
"""

import concurrent.futures
import functools
import os

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.kernels import pframe as jpf
from tpuh264_torch.kernels import cuda_lib, iframe
from tpuh264_torch.kernels import pframe as tpf
from tpuh264_torch.kernels import transform8 as T8

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")

GRID = ("(a.S * a.R * a.C + kWarps - 1) / kWarps", "32 * kWarps")
KERNELS = {  # K9's routes are template instances, K10's kernels apart
    "k9": ("pframe_enc.cu", "enc_args", "pframe_encode_kernel<false>", *GRID),
    "k9t8": ("pframe_enc.cu", "enc_args", "pframe_encode_kernel<true>", *GRID),
    "k10": ("pframe_dec.cu", "dec_args", "pframe_decode_kernel",
            *GRID),
    "k10t8": ("pframe_dec.cu", "dec_args", "pframe_decode_t8_kernel",
              *GRID),
}

# mutants of the t8 routes, each a replacement in a source and built as
# that route: a J tie taking the 8x8 transform; the 8x8 transform taken
# where it codes no level; K9 storing an 8x8 MB's levels, and K10 loading
# them, as the 4x4 layout would (4x4 block 4 by + bx's 16 in row 4 by +
# bx), not block k // 4's 16 consecutive zigzag levels in row k.  And the
# hand-offs of the copies in flight: K9 searching reference 0, 1 or a
# later one before its windows' copies land, reference 1's windows copied
# into reference 0's slot, MC's chroma read from the window's first byte
# and not the row's offset in its first word; K10 taking the t8 flag of
# the MB before and reading the levels before their copies land.
MUTANTS = {
    "K9 reference 0 before its copies": (
        "k9t8", "        cp_async_wait<1>();\n", "        cp_async_wait<2>();\n"),
    "K9 reference 1 before its copies": (
        "k9t8", "else\n          cp_async_wait<0>();\n",
        "else\n          cp_async_wait<1>();\n"),
    "K9 a later reference before its copies": (
        "k9t8", "        cp_async_commit();\n        cp_async_wait<0>();\n",
        "        cp_async_commit();\n"),
    "K9 reference 1 in reference 0's slot": (
        "k9t8", "fetch_windows(w.win[n], a, n,", "fetch_windows(w.win[0], a, n,"),
    "K9 chroma window offset dropped": (
        "k9t8", "(mvx >> 3) - cx + ((8 * c + cx + a.cp) & 3),",
        "(mvx >> 3) - cx,"),
    "K10 t8 flag of the MB before": (
        "k10t8", "a.t8[m * a.st8] == 1;", "a.t8[(m - (m > 0)) * a.st8] == 1;"),
    "K10 levels before their copies": (
        "k10t8", "  cp_async_wait<0>();\n  __syncwarp();",
        "  __syncwarp();"),
    "j8 <= j4": ("k9t8", "use8 = t.j8 < j4 && t.cbp8 > 0;",
                 "use8 = t.j8 <= j4 && t.cbp8 > 0;"),
    "cbp8 > 0 dropped": ("k9t8", "use8 = t.j8 < j4 && t.cbp8 > 0;",
                         "use8 = t.j8 < j4;"),
    "K9 4x4 level layout": (
        "k9t8", "const int blk = lane >> 3;\n"
        "      const uint64_t zr = kZz8Row[lane & 7];",
        "const int blk = ((lane >> 4) << 1) | ((lane >> 2) & 1);\n"
        "      const uint64_t zr = kZz8Row[2 * (((lane >> 3) & 1) * 2 + "
        "((lane >> 1) & 1)) + (lane & 1)];"),
    "K10 4x4 level layout": (
        "k10t8",
        "x[u] = dq8(lev[64 * b + (int)((zc >> (8 * u)) & 63)], sc[u & 3], a.qp);",
        "{ const int L = (int)((zc >> (8 * u)) & 63), q = L >> 3; x[u] = "
        "dq8(lev[16 * (4 * (2 * (b >> 1) + (q >> 2)) + 2 * (b & 1) + ((q >> "
        "1) & 1)) + 8 * (q & 1) + (L & 7)], sc[u & 3], a.qp); }"),
}


# mutants of K9's mvd hand-off (`mvd_pair`), each built as the route
# without t8: {name: (old text, new text, the arrival orders -- False
# forward, True reverse -- in which a case must catch it)}.  The first to
# arrive at a pair subtracts (its partner's vector not yet stored); the
# right MB, arriving second, subtracts the wrong way; the left MB,
# arriving second, does.  The last two show that each order is met.
MVD_MUTANTS = {
    "mvd by the first arriver": (
        "  if (!got) return;", "  if (got) return;", (False, True)),
    "mvd of a right MB arriving second": (
        "a.mvdx[m] = right ? mx - ox : ox - mx;",
        "a.mvdx[m] = right ? ox - mx : ox - mx;", (False,)),
    "mvd of a left MB arriving second": (
        "a.mvdx[m] = right ? mx - ox : ox - mx;",
        "a.mvdx[m] = right ? mx - ox : mx - ox;", (True,)),
}


def _build(tmp_path_factory, jobs):
    """{name: executable} of (name, key, csrc) jobs, KERNELS[key] built from
    the sources in csrc, all at once (the build directories made first:
    tmp_path_factory is not thread-safe)."""
    dirs = [tmp_path_factory.mktemp("build") for _ in jobs]

    def one(job, d):
        name, key, csrc = job
        return name, cuda_threads.build_entry(d, csrc, *KERNELS[key])

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(one, jobs, dirs))


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """csrc/pframe_enc.cu and pframe_dec.cu (all but their launch entries)
    built with g++ against the shims of cuda_threads.py, each route (t8
    and not): each block's warps as fibers (`run_block_fibers`), its
    shuffles, ballots and block barriers switching between them."""
    return _build(tmp_path_factory, [(k, k, CSRC) for k in KERNELS])


@pytest.fixture(scope="module")
def mutants(tmp_path_factory):
    """The t8 routes' MUTANTS and K9's MVD_MUTANTS, each source a copy
    with its replacement."""
    jobs = []
    edits = {**MUTANTS, **{name: ("k9", old, new) for name, (old, new, _)
                           in MVD_MUTANTS.items()}}
    for name, (key, old, new) in edits.items():
        d = tmp_path_factory.mktemp("t8_mutant_src")
        for f in os.listdir(CSRC):
            with open(os.path.join(CSRC, f)) as src:
                text = src.read()
            if f == KERNELS[key][0]:
                assert text.count(old) == 1, name
                text = text.replace(old, new)
            (d / f).write_text(text)
        jobs.append((name, key, str(d)))
    return _build(tmp_path_factory, jobs)


def _eq(got, want, what):
    assert got.dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want.numpy(), err_msg=what)


@pytest.mark.parametrize("case", chip_smoke.K9_CASES, ids=str)
def test_k9_source_on_cpu_threads_matches_plain(cpu_kernels, case):
    """K9's byte windows, redux-reduced SADs of the 17 sub-pel positions,
    sequential selections (stage B raster, half then quarter, references
    by index), MC, transforms, ballots and 16-byte stores, a block's warps
    at a time, equal the plain version on the case: every field and the
    reconstruction."""
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(np, *case), "cpu")
    want = tpf._inter_encode_plain(**kw)
    args = {k: v for k, v in kw.items() if k != "t8"}
    outs = cuda_threads.run_entry(cpu_kernels["k9"], *tpf._k9_operands(**args))
    for f, got in zip(tpf.InterEnc._fields, outs[:11]):
        _eq(got, getattr(want, f), f)
    assert not want.t8.any()
    for i, (got, w) in enumerate(zip(outs[11:], want.rec)):
        _eq(got, w, f"rec {i}")


@functools.lru_cache(maxsize=None)
def _k9_t8_plain(case):
    """A K9_T8_CASES case's arguments, its plain version's output and the
    corners of the 8x8 choice that run met (`_t8_corners`): once a case,
    for every test that reads it."""
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(np, *case), "cpu",
                            t8=True)
    return (kw, *_t8_corners(kw))


def _k9_t8(exe, case):
    """K9's t8 route (`exe`) and its plain version on a K9_T8_CASES case:
    (the kernel's InterEnc fields, t8 and recon; the plain version's)."""
    kw, want, _ = _k9_t8_plain(case)
    outs = cuda_threads.run_entry(exe, *tpf._k9_operands(**kw))
    return [*outs[:11], outs[18], *outs[11:14]], [*want[:12], *want.rec]


def _k10_t8(exe, case, views=False):
    """K10's t8 route (`exe`) and its plain version on a K10_T8_CASES
    case (with `views`, the symbols as the GOP decode's record views, t8
    beside them): (the kernel's recon and motion; the plain version's)."""
    kw = chip_smoke.k10_args(torch, chip_smoke.k10_case(np, *case, t8=True),
                             "cpu", t8=True)
    if views:
        sym = kw["symbols"]
        kw["symbols"] = chip_smoke.record_views(sym, torch)._replace(
            t8=sym.t8)
    rec, mv = tpf._inter_decode_plain(**kw)
    outs = cuda_threads.run_entry(exe, *tpf._k10_operands(**kw))
    return outs, [*rec, *mv]


@pytest.mark.parametrize("case", chip_smoke.K9_T8_CASES, ids=str)
def test_k9_t8_source_on_cpu_threads_matches_plain(cpu_kernels, case):
    """K9's t8 route (the 8x8 trial of every MB: forward8x8, quant8x8,
    zigzag8, cbp8, the recon through dequant8x8 and the inverse, J of
    both codings, the choice, the levels in the 8x8 layout) equals the
    plain version (`_t8_choice`) on the case: every field, t8 and the
    recon."""
    got, want = _k9_t8(cpu_kernels["k9t8"], case)
    names = [*tpf.InterEnc._fields[:12], "rec y", "rec u", "rec v"]
    for name, g, w in zip(names, got, want):
        _eq(g, w.to(g.dtype) if name == "t8" else w, name)


def _t8_corners(kw):
    """`_inter_encode_plain` (t8) on `k9_args(..., t8=True)`, and the
    corners of the 8x8 choice it meets there: counts of the MBs where J8
    == J4 with a coded 8x8 level ("tie", 4x4 kept), J8 < J4 with none
    ("cbp8 0", 4x4 kept), and the 8x8 chosen where the 4x4 coding codes
    nothing ("8x8 only"), from `_t8_choice`'s own inputs."""
    got = {}
    choice = tpf._t8_choice

    def spy(src, pred, qp, l_zz, cbp4, rec4):
        z8 = T8.quant8x8(T8.forward8x8(tpf._to8(src - pred)), qp)
        zz8 = T8.zigzag8(z8)
        cbp8 = (zz8 != 0).any(-1).flatten(-2).any(-1)
        rec8 = tpf._from8(T8.idct8_add(tpf._to8(pred), T8.dequant8x8(z8, qp)))
        lam8 = iframe._LAMBDA8[qp]
        ssd = lambda d: 8 * (d * d).sum((-1, -2), dtype=torch.int32)
        j4 = ssd(rec4 - src) + lam8 * iframe._rate_bits(l_zz, (-1, -2, -3))
        j8 = ssd(rec8 - src) + lam8 * (iframe._rate_bits(zz8, (-1, -2, -3))
                                       + 1)
        got.update({"tie": int(((j8 == j4) & cbp8).sum()),
                    "cbp8 0": int(((j8 < j4) & ~cbp8).sum()),
                    "8x8 only": int(((j8 < j4) & cbp8 & (cbp4 == 0)).sum())})
        return choice(src, pred, qp, l_zz, cbp4, rec4)

    tpf._t8_choice = spy
    try:
        out = tpf._inter_encode_plain(**kw)
    finally:
        tpf._t8_choice = choice
    return out, got


def test_k9_t8_cases_meet_the_corners():
    """Over K9_T8_CASES the plain version meets each corner of the choice
    that a mutant below gets wrong: J ties with a coded 8x8 level, an 8x8
    coding of no level at a lower J, and the 8x8 transform chosen where
    the 4x4 one codes nothing; and both choices, with and without
    intra-in-P, at QPs on both sides of dequant8x8's branch."""
    seen, chose = {}, set()
    for case in chip_smoke.K9_T8_CASES:
        _, out, corners = _k9_t8_plain(case)
        for k, n in corners.items():
            seen[k] = seen.get(k, 0) + n
        if out.t8.any():
            chose.add((case[4] >= 12, case[6]))
    assert all(seen[k] for k in ("tie", "cbp8 0", "8x8 only")), seen
    assert chose == {(a, b) for a in (False, True) for b in (False, True)}


def test_k9_t8_cases_reach_the_window_corners():
    """K9_T8_CASES meet the corners of the t8 route's windows: 1, 2, 3 and
    4 references; references 1 and 2 chosen (the second one's copies in
    flight during the first's search; a later one copied in after them);
    each of the references copied in at the warp's start (0 and 1) with
    luma windows past the planes' border (the clamp) at some MBs and
    inside at others; chroma windows past the pads, and inside but
    exactly at them."""
    ns, chosen, luma = set(), set(), set()
    chroma_out = chroma_edge = False
    for case in chip_smoke.K9_T8_CASES:
        kw, out, _ = _k9_t8_plain(case)
        n = len(kw["planes_l"])
        ns.add(n)
        chosen |= set(out.refsel.unique().tolist())
        _, r, c = case[0]
        hp, wp = kw["planes_l"][0].shape[-2:]
        hc, wc = kw["refs_up"][0].shape[-2:]
        rows, cols = torch.arange(r)[:, None], torch.arange(c)[None, :]
        for k in range(n):
            iy0, ix0 = kw["iy0"][k], kw["ix0"][k]
            y0 = 16 * rows + iy0 - 2 + tpf._PE
            x0 = 16 * cols + ix0 - 2 + tpf._PE
            out = (y0 < 0) | (y0 + 20 > hp) | (x0 < 0) | (x0 + 20 > wp)
            if out.any() and (~out).any():
                luma.add(k)
            cy = 8 * rows + ((4 * iy0 - 7) >> 3) + tpf._CP
            cx = 8 * cols + ((4 * ix0 - 7) >> 3) + tpf._CP
            cout = (cy < 0) | (cy + 11 > hc) | (cx < 0) | (cx + 11 > wc)
            edge = (cy == 0) | (cy + 11 == hc) | (cx == 0) | (cx + 11 == wc)
            chroma_out |= bool(cout.any())
            chroma_edge |= bool((edge & ~cout).any())
    assert {1, 2, 3, 4} <= ns and {1, 2} <= chosen, (ns, chosen)
    assert {0, 1} <= luma and chroma_out and chroma_edge


@pytest.mark.parametrize("case", chip_smoke.K10_T8_CASES, ids=str)
def test_k10_t8_source_on_cpu_threads_matches_plain(cpu_kernels, case):
    """K10's t8 route (a t8 MB's luma through inverse_zigzag8,
    dequant8x8 and the 8x8 inverse, no cbp mask, whatever its kind; the
    others as the route without t8) equals the plain version on the
    case: the recon and the motion."""
    got, want = _k10_t8(cpu_kernels["k10t8"], case)
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {i}")


@pytest.mark.parametrize("case", chip_smoke.K10_T8_CASES[::3], ids=str)
def test_k10_t8_record_views_on_cpu_threads_match_plain(cpu_kernels, case):
    """K10's t8 route copies each MB's levels in by 16-byte copies from
    where they lie: from the record views' 800-byte slots too, equal to
    the plain version."""
    got, want = _k10_t8(cpu_kernels["k10t8"], case, views=True)
    for i, (g, w) in enumerate(zip(got, want)):
        _eq(g, w, f"output {i}")


def test_k10_t8_cases_cover_the_kinds():
    """K10_T8_CASES put t8 on skip, inter and intra MBs, with levels of a
    t8 MB's 8x8 blocks outside its cbp_luma, at QPs on both sides of
    dequant8x8's branch."""
    kinds, outside, qps = set(), False, set()
    for case in chip_smoke.K10_T8_CASES:
        sym = chip_smoke.k10_case(np, *case, t8=True)[0]
        t8 = sym["t8"] == 1
        kinds |= set(sym["kind"][t8].tolist())
        blocks = sym["luma_ac"].reshape(*t8.shape, 4, 64) != 0
        coded = (sym["cbp_luma"][..., None] >> np.arange(4)) & 1
        outside |= bool((blocks.any(-1) & (coded == 0) & t8[..., None]).any())
        qps.add(case[3] >= 12)
    assert kinds == {0, 1, 2} and outside and qps == {False, True}


@pytest.mark.parametrize("name", MUTANTS)
def test_t8_mutants_fail(mutants, name):
    """Each mutant of the t8 routes differs from the plain version on some
    case of its kernel's t8 cases."""
    key = MUTANTS[name][0]
    run, cases = ((_k9_t8, chip_smoke.K9_T8_CASES) if key == "k9t8"
                  else (_k10_t8, chip_smoke.K10_T8_CASES))
    for case in cases:
        got, want = run(mutants[name], case)
        if any(not torch.equal(g, w.to(g.dtype)) for g, w in zip(got, want)):
            return
    pytest.fail(f"mutant {name!r} passed every case")


# K9 writing the symbols, the mvds by pairs: cases whose rows span
# several blocks (4 MBs each) with moving content, a row of 121 MBs, and
# the t8 route
MVD_CASES = [("k9", chip_smoke.K9_CASES[i]) for i in (26, 32, 44)] + [
    ("k9t8", chip_smoke.K9_T8_CASES[11])]


def _k9_mvds(exe, key, case, reverse):
    """K9 (`exe`, the route `key`) writing the symbols of a MVD_CASES case
    into `empty_symbols`, its blocks and each block's warps forward or
    last first (`reverse`), its pair slots from zero: (its mvdx, mvdy,
    whether the slots are empty after; the plain version's mvds, its
    vectors less the left MB's)."""
    t8 = key == "k9t8"
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(np, *case), "cpu",
                            t8=t8)
    want = tpf._inter_encode_plain(**kw)
    out = tpf.empty_symbols(want.kind.shape[:1], *want.kind.shape[1:],
                            "cpu")
    pairs = torch.zeros(want.kind.numel(), dtype=torch.int64)
    args = kw if t8 else {k: v for k, v in kw.items() if k != "t8"}
    ins, outs, ints = tpf._k9_operands(**args, out=out, pairs=pairs)
    cuda_threads.run_entry(exe, ins, outs, ints, inout=(len(outs) - 1,),
                           reverse=reverse)
    left = lambda mv: torch.nn.functional.pad(mv, (1, 0))[..., :-1]
    return ((out.mvdx, out.mvdy, not pairs.any()),
            (want.mvx - left(want.mvx), want.mvy - left(want.mvy)))


@pytest.mark.parametrize("reverse", (False, True), ids=("forward",
                                                        "reverse"))
@pytest.mark.parametrize("key,case", MVD_CASES, ids=str)
def test_k9_mvds_in_both_arrival_orders(cpu_kernels, key, case, reverse):
    """K9 writes each MB's mvd itself (column 0 its vector, the others by
    the second warp of each pair to exchange its vector), with its blocks
    and warps run forward (a pair's left MB mostly first) and last first
    (its right MB first): the mvds equal the plain version's and every
    pair's slot is empty again."""
    (mvdx, mvdy, empty), want = _k9_mvds(cpu_kernels[key], key, case,
                                         reverse)
    _eq(mvdx, want[0], "mvdx")
    _eq(mvdy, want[1], "mvdy")
    assert want[0].any() and empty


@pytest.mark.parametrize("name", MVD_MUTANTS)
def test_k9_mvd_mutants_fail(mutants, name):
    """Each mutant of K9's mvd hand-off differs from the plain version on
    some case without t8, in each arrival order it names."""
    for reverse in MVD_MUTANTS[name][2]:
        for key, case in MVD_CASES[:-1]:
            (mvdx, mvdy, _), want = _k9_mvds(mutants[name], key, case,
                                             reverse)
            if (not torch.equal(mvdx, want[0])
                    or not torch.equal(mvdy, want[1])):
                break
        else:
            pytest.fail(f"mutant {name!r} passed every case "
                        f"({'reverse' if reverse else 'forward'})")


def test_time_pframe_edits_apply():
    """tools/time_pframe.py's builds of the sources with clock reads
    (`PHASE_EDITS`) and with one part of the design undone (`VARIANTS`)
    still find every text they edit, each once edited."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "time_pframe.py")
    spec = importlib.util.spec_from_file_location("time_pframe", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    src = {}
    for f in tool.SOURCES:
        with open(os.path.join(CSRC, f)) as fh:
            src[f] = fh.read()
    for f, edits in tool.PHASE_EDITS.items():
        out = tool.edited(src[f], edits)
        assert out.count("tick(") >= len(tool.PHASES[f]), f
    for name, (_, f, _, edits) in tool.VARIANTS.items():
        assert tool.edited(src[f], edits) != src[f], name
    with pytest.raises(ValueError):
        tool.edited(src["pframe_enc.cu"], [("no such text", "")])


@pytest.mark.parametrize("case", [c for c in chip_smoke.K9_CASES
                                  if c[5] == "subpel"], ids=str)
def test_k9_subpel_cases_reach_the_window_edges(case):
    """The "subpel" cases choose what they are built for, so that the
    kernel's 17 sub-pel positions meet the choices the plain version's 49
    could make: most MBs take the far +-1 of stage B and the quarter-pel
    ring beyond a corner half-pel winner (mv - 4 (iy0, ix0) = (+-7, +-7):
    the last rows and columns of the 20x20 window), and the windows lie
    past the planes' border (the clamp) at the frame's edge and inside
    them (no clamp) elsewhere, where the frame has an inner MB."""
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(np, *case), "cpu")
    o = tpf._inter_encode_plain(**kw)
    iy0, ix0 = kw["iy0"][0], kw["ix0"][0]
    ring = ((o.mvy - 4 * iy0).abs() == 7) & ((o.mvx - 4 * ix0).abs() == 7)
    assert (o.refsel == 0).all()
    assert 2 * int(ring.sum()) > ring.numel()
    s, r, c = case[0]
    hp, wp = kw["planes_l"][0].shape[-2:]
    y0 = (16 * torch.arange(r)[:, None] + iy0 - 2 + tpf._PE)
    x0 = (16 * torch.arange(c)[None, :] + ix0 - 2 + tpf._PE)
    edge = (y0 < 0) | (y0 + 20 > hp) | (x0 < 0) | (x0 + 20 > wp)
    assert (edge & ring).any()
    assert (~edge & ring).any() == (r > 2 and c > 2)


@pytest.mark.parametrize("case", chip_smoke.K10_CASES, ids=str)
def test_k10_source_on_cpu_threads_matches_plain(cpu_kernels, case):
    """K10's MV look-back (ballot and redux, 32 columns at a time), MC and
    residuals, a block's warps at a time, equal the plain version on the
    case."""
    kw = chip_smoke.k10_args(torch, chip_smoke.k10_case(np, *case), "cpu")
    rec, mv = tpf._inter_decode_plain(**kw)
    args = {k: v for k, v in kw.items() if k != "t8"}
    outs = cuda_threads.run_entry(cpu_kernels["k10"], *tpf._k10_operands(**args))
    for i, (got, w) in enumerate(zip(outs, (*rec, *mv))):
        _eq(got, w, f"output {i}")


# The plain path against the JAX package: (references, halo, intra-in-P,
# ref_base), each setting met twice over the four; each case is a JAX
# compile of its own.  Stream 0 moves (the motion content), stream 1 is
# noise (intra MBs win there with intra-in-P).
JAX_CASES = [(1, False, False, 0), (2, True, True, 0), (3, False, True, 1),
             (4, True, False, 1)]


def _jax_inputs(n, halo, iip, ref_base):
    """The source [2, 32, 48] (+ chroma) and references [n, 2, ...] (with
    `halo`, HALO_Y / HALO_C more rows a side) as numpy uint8."""
    cases = [chip_smoke.k9_case(np, (2, 2, 3), n, ref_base, content, 28,
                                "stageA", iip, halo)
             for content in ("motion", "noise")]
    keys = ("y", "u", "v", "refs_y", "refs_u", "refs_v")
    cat = [np.concatenate([cases[0][k][..., :1, :, :],
                           cases[1][k][..., 1:, :, :]], axis=-3)
           for k in keys]
    return cat[:3], cat[3:]


@pytest.fixture(scope="module", params=JAX_CASES,
                ids=[f"n{n}-{'halo' if h else 'frame'}-"
                     f"{'iip' if i else 'rtc'}-base{b}"
                     for n, h, i, b in JAX_CASES])
def jax_encoded(request):
    n, halo, iip, ref_base = request.param
    cur, refs = _jax_inputs(*request.param)
    jout = jpf.encode_pframe_rows_multi(*cur, *refs, 28, ref_base=ref_base,
                                        halo=halo, intra_in_p=iip)
    tout = tpf.encode_pframe_rows_multi(
        *map(torch.from_numpy, cur), *map(torch.from_numpy, refs), 28,
        ref_base=ref_base, halo=halo, intra_in_p=iip)
    return request.param, refs, jout, tout


def test_plain_encode_matches_jax(jax_encoded):
    """The port's P encode on CPU tensors (stage A, then the plain version
    of K9, `_inter_encode_plain`, then the intra-in-P scan and the
    symbols) equals the JAX package's: every symbol field, the recon and
    the motion."""
    (n, halo, iip, ref_base), _, (jsym, jrec, jmv), (tsym, trec, tmv) = (
        jax_encoded)
    for name in tpf.MBSymbolsP._fields:
        np.testing.assert_array_equal(np.asarray(getattr(jsym, name)),
                                      getattr(tsym, name).numpy(), name)
    for a, b in zip((*jrec, *jmv), (*trec, *tmv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    kind = tsym.kind.numpy()
    assert (kind == tpf.KIND_INTRA).any() == iip
    assert (kind == tpf.KIND_INTER).any()


def test_plain_decode_matches_jax(jax_encoded):
    """The port's P decode of those symbols on CPU tensors (the plain
    version of K10, `_inter_decode_plain`, then the intra scan) equals
    the JAX package's decode, and the encoder's recon and motion.  With
    ref_base 1 the encoder searched DPB[1:], so the decoder takes the
    whole DPB: another frame in front as DPB[0]."""
    (n, halo, _, base), refs, (jsym, _, _), (tsym, trec, tmv) = jax_encoded
    refs = [np.concatenate([r[-1:][..., ::-1, :]] * base + [r]) for r in refs]
    jdec, jmv = jpf.decode_pframe_rows_multi(jsym, *refs, 28, halo=halo)
    tdec, dmv = tpf.decode_pframe_rows_multi(
        tsym, *map(torch.from_numpy, refs), 28, halo=halo)
    for a, b, want in zip((*jdec, *jmv), (*tdec, *dmv), (*trec, *tmv)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        assert torch.equal(b, want)


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On CPU tensors both routers (and the P encode and decode through
    them) take the plain versions: the kernel library is never loaded and
    the launch counters do not move."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = (tpf._inter_encode.launches, tpf._inter_decode.launches)
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(
        np, *chip_smoke.K9_CASES[9]), "cpu")
    for a, b in zip(tpf._inter_encode(**kw), tpf._inter_encode_plain(**kw)):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert torch.equal(x, y)
    dkw = chip_smoke.k10_args(torch, chip_smoke.k10_case(
        np, *chip_smoke.K10_CASES[4]), "cpu")
    for a, b in zip(tpf._inter_decode(**dkw), tpf._inter_decode_plain(**dkw)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    cur, refs = _jax_inputs(2, False, True, 0)
    sym, _, _ = tpf.encode_pframe_rows_multi(
        *map(torch.from_numpy, cur), *map(torch.from_numpy, refs), 28)
    tpf.decode_pframe_rows_multi(sym, *map(torch.from_numpy, refs), 28)
    assert (tpf._inter_encode.launches,
            tpf._inter_decode.launches) == before


def _meta(kw):
    on = lambda x: (x.to("meta") if torch.is_tensor(x) else
                    type(x)(*[None if y is None else y.to("meta")
                              for y in x]) if isinstance(x, tpf.MBSymbolsP)
                    else [y.to("meta") for y in x] if isinstance(x, list)
                    else x)
    return {k: on(v) for k, v in kw.items()}


def test_t8_calls_reach_the_kernels(monkeypatch):
    """With `t8` (the CABAC + 8x8 session path) a tensor off the CPU
    never reaches a plain version: on a device the kernels cannot take,
    or at a QP outside 0..51, both routers raise before any launch; where
    the device checks pass, each reaches its kernel's entry with the t8
    route's operands (K9: the flag and lam8; K10: symbols.t8) and counts
    a launch of that route."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version ran off the CPU")

    monkeypatch.setattr(tpf, "_inter_encode_plain", refuse)
    monkeypatch.setattr(tpf, "_inter_decode_plain", refuse)
    enc = {**_meta(chip_smoke.k9_args(torch, chip_smoke.k9_case(
        np, *chip_smoke.K9_CASES[12]), "cpu")), "t8": True}
    dec = {**_meta(chip_smoke.k10_args(torch, chip_smoke.k10_case(
        np, *chip_smoke.K10_T8_CASES[4], t8=True), "cpu")), "t8": True}
    before = (tpf._inter_encode.launches, tpf._inter_decode.launches)
    for fn, kw in ((tpf._inter_encode, enc), (tpf._inter_decode, dec)):
        with pytest.raises(ValueError):
            fn(**kw)
        with pytest.raises(ValueError):
            fn(**{**kw, "qp": 52})
    assert (tpf._inter_encode.launches,
            tpf._inter_decode.launches) == before
    # past the device checks (meta tensors standing in for the card's),
    # each call reaches its entry
    entries = []

    class Lib:
        def __getattr__(self, name):
            return lambda p, n, stream: entries.append((name, list(n))) or 0

    ops = {}
    for name in ("_k9_operands", "_k10_operands"):
        real = getattr(tpf, name)
        monkeypatch.setattr(tpf, name, lambda *a, _f=real, _n=name, **kw: (
            ops.setdefault(_n, _f(*a, **kw))))
    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "check_inputs", lambda *a, **kw: None)
    monkeypatch.setattr(cuda_lib, "check_plane",
                        lambda name, dev, t, shape: t.stride(-2))
    monkeypatch.setattr(cuda_lib, "stream", lambda dev: None)
    t8_before = (tpf._inter_encode.t8_launches,
                 tpf._inter_decode.t8_launches)
    tpf._inter_encode(**enc)
    tpf._inter_decode(**dec)
    assert [e[0] for e in entries] == ["th264_pframe_encode",
                                       "th264_pframe_decode"]
    assert entries[0][1][-2:] == [1, tpf._LAMBDA8[enc["qp"]]]
    assert ops["_k10_operands"][0][-1] is dec["symbols"].t8
    assert ops["_k9_operands"][1][18] is not None  # the t8 field written
    assert (tpf._inter_encode.launches, tpf._inter_decode.launches) == (
        before[0] + 1, before[1] + 1)
    assert (tpf._inter_encode.t8_launches,
            tpf._inter_decode.t8_launches) == (t8_before[0] + 1,
                                               t8_before[1] + 1)
