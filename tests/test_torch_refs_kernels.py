"""K11 (the P frame's reference build) and K12 (the stage-A winner):
their sources run on CPU threads against the plain versions, the plain
reference build against the JAX package's, and the routers.

The kernels' inputs come from `chip_smoke.k11_case` / `k12_case`, the
generators chip_smoke.py phase 2 holds the kernels to their plain
versions with on the card.  Every comparison is exact (array_equal):
this is an integer codec.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.kernels import pframe as jpf
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import pframe as tpf

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")


@pytest.fixture(scope="module")
def k11_cpu(tmp_path_factory):
    """csrc/halfpel.cu (all but its launch entry) built with g++ against
    the shims of cuda_threads.py: a block's 128 threads as fibers, its
    warp barriers switching between them."""
    return cuda_threads.build_entry(tmp_path_factory.mktemp("k11_cpu"),
                                    CSRC, "halfpel.cu", "ref_args",
                                    "halfpel_kernel", "a.blocks", "kThreads")


@pytest.fixture(scope="module")
def k12_cpu(tmp_path_factory):
    """csrc/me_winner.cu (all but its launch entry) built likewise, a
    block's warps as fibers, its block barriers switching between them,
    `redux.sync` min / max through their exchanges, the shared and global
    atomics as host atomics; the grid `win_args` plans."""
    return cuda_threads.build_entry(
        tmp_path_factory.mktemp("k12_cpu"), CSRC, "me_winner.cu", "win_args",
        "me_winner_kernel", "a.blocks", "32 * kWarps")


def _k11_inputs(case):
    """`_references`' arguments for a `k11_case` on the CPU."""
    refs_y, refs_u, refs_v, halo = chip_smoke.k11_case(np, *case)
    return [torch.from_numpy(x) for x in (refs_y, refs_u, refs_v)] + [halo]


@pytest.mark.parametrize("case", chip_smoke.K11_CASES, ids=str)
def test_k11_source_on_cpu_threads_matches_plain(k11_cpu, case):
    """K11's strips (16-byte source chunks staged a row at a time, the
    clamps, the 6-tap history in registers, the fp32 roundings, the
    16-byte stores of the four planes) and chroma chunks, a block at a
    time, equal the plain version on the case: every plane of every
    reference, in the plain version's layout."""
    args = _k11_inputs(case)
    planes, up, vp = tpf._references_plain(*args)
    ins, outs, ints = tpf._k11_operands(*args)
    got = tpf._plane_views(*cuda_threads.run_entry(k11_cpu, ins, outs, ints),
                           ints[3] + 2 * tpf._PE, ints[6] + 2 * tpf._CP)
    for want_l, got_l in zip((planes, up, vp), got):
        for n, (w, g) in enumerate(zip(want_l, got_l)):
            assert g.dtype == w.dtype == torch.uint8
            assert g.stride() == w.stride(), f"reference {n}"
            np.testing.assert_array_equal(g.numpy(), w.numpy(),
                                          err_msg=f"reference {n}")


def test_k11_cases_cover_what_they_claim():
    """S = 1 and 3; one MB, a row, a column and 97 columns; N = 1, 2 and
    4; halo on and off; uint8 and int32 references; every content."""
    shapes = {c[0] for c in chip_smoke.K11_CASES}
    assert {s for s, _, _ in shapes} == {1, 3}
    assert {(1, 1, 1), (1, 4, 1)} <= shapes
    assert any(r == 1 and c > 1 for _, r, c in shapes)
    assert any(c == 97 for _, _, c in shapes)
    assert {c[1] for c in chip_smoke.K11_CASES} == {1, 2, 4}
    assert {c[2] for c in chip_smoke.K11_CASES} == {False, True}
    assert {c[3] for c in chip_smoke.K11_CASES} == {False, True}
    assert {c[4] for c in chip_smoke.K11_CASES} == set(chip_smoke.K11_CONTENT)


@pytest.mark.parametrize("case", chip_smoke.K11_CASES, ids=str)
def test_plain_references_match_jax(case):
    """The plain reference build equals the JAX package's: without `halo`
    `build_halfpel_planes` and `_pad_ref`, with it the `_ext` pair (a
    row-sharded DPB); luma and chroma, every reference."""
    refs_y, refs_u, refs_v, halo = chip_smoke.k11_case(np, *case)
    planes, up, vp = tpf._references_plain(
        *[torch.from_numpy(x) for x in (refs_y, refs_u, refs_v)], halo)
    build = jpf.build_halfpel_planes_ext if halo else jpf.build_halfpel_planes
    if halo:
        pad = lambda x: jpf._pad_ref_ext(x, tpf._CP)
    else:
        pad = lambda x: jpf._pad_ref(x, tpf._CP)
    i32 = lambda t: t.to(torch.int32).numpy()
    for n in range(refs_y.shape[0]):
        want = build(jnp.asarray(refs_y[n]))
        for k in range(4):
            np.testing.assert_array_equal(i32(planes[n][k]),
                                          np.asarray(want[k]))
        np.testing.assert_array_equal(i32(up[n]),
                                      np.asarray(pad(jnp.asarray(refs_u[n]))))
        np.testing.assert_array_equal(i32(vp[n]),
                                      np.asarray(pad(jnp.asarray(refs_v[n]))))


@pytest.mark.parametrize("case", chip_smoke.K11_CASES, ids=str)
def test_references_layout(case):
    """`_references` on the CPU returns the kernel's layout: uint8 views
    of one luma and one chroma buffer, every plane's base 16-byte
    aligned, its rows a pitch apart that is a multiple of 16 and the
    width rounded up to 16 (luma Wp = W + 26 is 10 mod 16: Wp + 6;
    chroma Wcp = W/2 + 16 is 8 mod 16 for an odd MB column count), its
    planes and streams one after another; odd and even MB column
    counts."""
    args = _k11_inputs(case)
    planes, up, vp = tpf._references(*args)
    w = args[0].shape[-1]
    wp, wcp = w + 2 * tpf._PE, w // 2 + 2 * tpf._CP
    assert wp % 16 == 10 and (wcp % 16 == 8) == (w // 16) % 2
    lp, cp = wp + 6, wcp + (8 if (w // 16) % 2 else 0)
    bases = set()
    for t, width, pitch in [(p, wp, lp) for p in planes] + [
            (p, wcp, cp) for p in up + vp]:
        assert t.dtype == torch.uint8 and t.shape[-1] == width
        assert pitch % 16 == 0 and t.stride(-2) == pitch
        assert t.stride(-3) == pitch * t.shape[-2]
        if t.dim() == 4:
            assert t.stride(0) == t.stride(1) * t.shape[1]
        assert t.data_ptr() % 16 == 0
        bases.add(t.untyped_storage().data_ptr())
    assert len(bases) == 2  # one luma and one chroma buffer


def _consumers(planes, up, mvx, mvy, iy, ix, src):
    """What the plain consumers make of the planes: `_mc_luma`,
    `_mc_chroma`, `_extract_w2`, `_int_refine` and `_sad_field`."""
    from tpuh264_torch.kernels import me_cuda

    s, h, w = src.shape
    src_mbs = tpf._plane_to_mbs(src, 16)
    gq = torch.zeros((s, 1, 1), dtype=torch.int32)
    return [tpf._mc_luma(planes, mvx, mvy), tpf._mc_chroma(up, mvx, mvy),
            tpf._extract_w2(planes, iy, ix),
            *tpf._int_refine(planes[0], src_mbs, iy, ix, 20, gq, gq),
            me_cuda._sad_field(src[:, ::2, ::2], planes[0], h, w)]


def test_plain_consumers_widen_uint8_planes():
    """On "saturate" planes (samples 0 and 255: sums of two components
    past 255, which uint8 arithmetic would wrap) every plain consumer of
    the uint8 planes gives int32 results equal to its results on int32
    copies of the same planes."""
    case = next(c for c in chip_smoke.K11_CASES if c[4] == "saturate"
                and c[0][1] * c[0][2] > 1)
    args = _k11_inputs(case)
    planes, up, _ = tpf._references(*args)
    assert (planes[0] == 255).any() and (planes[0] == 0).any()
    s, r, c = args[0].shape[1], *case[0][1:]
    rng = np.random.default_rng(7)
    t = lambda lo, hi: torch.from_numpy(rng.integers(lo, hi, (s, r, c))
                                        .astype(np.int32))
    mvx, mvy, iy, ix = t(-40, 40), t(-40, 40), t(-8, 9), t(-8, 9)
    src = torch.from_numpy(rng.choice([0, 255], (s, 16 * r, 16 * c))
                           .astype(np.int32))
    got = _consumers(planes[0], up[0], mvx, mvy, iy, ix, src)
    want = _consumers(planes[0].to(torch.int32), up[0].to(torch.int32),
                      mvx, mvy, iy, ix, src)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == torch.int32
        assert torch.equal(g, w)
    # the means of two 255 components stay 255 (uint8 sums would wrap)
    assert (got[0] == 255).any()


_MUTANTS = {
    "j rounding off by one": ("1.f / 1024)", "1.f / 1024) + 1u"),
    "row pitch off by one": ("out + (size_t)y * a.lp)",
                             "out + (size_t)y * (a.lp - 1))"),
}


@pytest.mark.parametrize("mutant", sorted(_MUTANTS))
def test_k11_mutant_fails_a_case(mutant, tmp_path):
    """A copy of K11's source whose j rounding, or whose output row pitch,
    is off by one differs from the plain version on a seeded case: the
    CPU-thread comparison sees both."""
    old, new = _MUTANTS[mutant]
    src = open(os.path.join(CSRC, "halfpel.cu")).read()
    assert src.count(old) == 1
    (tmp_path / "halfpel.cu").write_text(src.replace(old, new))
    exe = cuda_threads.build_entry(tmp_path, str(tmp_path), "halfpel.cu",
                                   "ref_args", "halfpel_kernel", "a.blocks",
                                   "kThreads")
    for case in chip_smoke.K11_CASES:
        args = _k11_inputs(case)
        want = tpf._references_plain(*args)
        ins, outs, ints = tpf._k11_operands(*args)
        got = tpf._plane_views(*cuda_threads.run_entry(exe, ins, outs, ints),
                               ints[3] + 2 * tpf._PE, ints[6] + 2 * tpf._CP)
        if not all(torch.equal(g, w) for a, b in zip(got, want)
                   for g, w in zip(a, b)):
            return
    pytest.fail(f"the mutant ({mutant}) equals the plain version on every "
                "case")


def _k12_source(exe, sads, lam, other=None, blocks=None):
    """K12's two phases on CPU threads, at most `blocks` blocks a launch:
    phase 1 (the counts), the counts of `other` summed in where given (as
    an all_reduce over a group of two would), phase 2: (iy0, ix0, gy,
    gx)."""
    ins, outs, ints = tpf._k12_operands(sads, lam, blocks)
    cuda_threads.run_entry(exe, ins, outs, ints + [1], inout=(0,))
    if other is not None:
        o_ins, o_outs, _ = tpf._k12_operands(other, lam, blocks)
        cuda_threads.run_entry(exe, o_ins, o_outs, ints + [1], inout=(0,))
        outs[0] += o_outs[0]
    cuda_threads.run_entry(exe, ins, outs, ints + [2], inout=(0,))
    return outs[1:]


@pytest.mark.parametrize("case", chip_smoke.K12_CASES, ids=str)
def test_k12_source_on_cpu_threads_matches_plain(k12_cpu, case,
                                                 monkeypatch):
    """K12's two phases (a block's chunk walked stream segment by segment,
    forwards then backwards, the next row loaded under the current one,
    lane minima, `redux.sync` first-index rules, the counts by shared
    histogram and one global atomic a bin, the mode once a segment, the
    rate relative to it) equal the plain version on the case, at the
    case's grid; with a group, both sum in the other band's counts
    between the phases."""
    sads, lam, other = chip_smoke.k12_case(np, *case)
    sads = torch.from_numpy(sads)
    group = None
    if other is not None:
        other = torch.from_numpy(other)
        extra = chip_smoke.k12_counts(torch, other, lam)
        monkeypatch.setattr(tpf, "all_reduce",
                            lambda t, g: t.add_(extra.to(t.dtype)))
        group = "the other band"
    want = tpf._int_winner_plain(sads, lam, group)
    got = _k12_source(k12_cpu, sads, lam, other, case[4])
    for g, w, name in zip(got, want, ("iy0", "ix0", "gy", "gx")):
        assert g.dtype == w.dtype == torch.int32, name
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=name)


def _k12_chunks(shape, blocks):
    """The streams of each block's chunk as the kernel plans them
    (`win_args`, the kernel's chunk), `blocks` as `_k12_operands`'."""
    s, r, c = shape
    mbs, per = s * r * c, r * c
    ints = tpf._k12_operands(torch.zeros((s, r, c, tpf._NN),
                                         dtype=torch.int32), 4, blocks)[2]
    n_blocks = min(max(ints[4], 1), -(-mbs // 8))
    chunk = -(-mbs // n_blocks)
    return [sorted({m // per for m in range(lo, min(mbs, lo + chunk))})
            for lo in range(0, mbs, chunk)]


def test_k12_cases_tie():
    """The "tied" tables tie the phase-1 cost of some MB's best
    candidates; the "counts" and "split" tables tie two candidates'
    counts in a stream, the later one won first ("split": the two halves
    in different blocks); the "one" tables give every MB of a stream one
    winner.  The grids put a stream across several blocks and several
    streams (three, once) in one block; the first-index rules decide."""
    spans = set()
    for case in chip_smoke.K12_CASES:
        shape, content = case[:2]
        sads, lam, _ = chip_smoke.k12_case(np, *case)
        t = torch.from_numpy(sads)
        cost = (4 * t + lam * tpf.tables.get("rate0", "cpu")).reshape(
            -1, tpf._NN)
        ties = (cost == cost.min(-1, keepdim=True).values).sum(-1)
        win = tpf._argmin_first(cost).reshape(t.shape[0], -1)
        chunks = _k12_chunks(shape, case[4])
        per = win.shape[1]
        spans |= {len(x) for x in chunks}
        if any(sum(s in x for x in chunks) > 1 for s in range(shape[0])):
            spans.add("stream over blocks")
        if content == "tied":
            assert (ties > 1).all()
        if content in ("counts", "split") and per % 2 == 0:
            counts = torch.bincount(win[0], minlength=tpf._NN)
            assert counts[17] == counts[200] == counts.max()
            assert win[0, 0] == 200
            assert tpf._argmax_first(counts[None])[0] == 17
            if content == "split" and len(chunks) > 1:
                spans.add("split tie")
        if content == "one":
            assert (win == win[:, :1]).all() and (win[0] == 144).all()
    assert {1, 2, 3, "stream over blocks", "split tie"} <= spans


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On CPU tensors both routers (and the P encode and decode through
    them) take the plain versions: the kernel library is never loaded
    and the launch counters do not move."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = (tpf._references.launches, tpf._int_winner.launches)
    args = _k11_inputs(chip_smoke.K11_CASES[3])
    for a, b in zip(tpf._references(*args), tpf._references_plain(*args)):
        assert all(torch.equal(x, y) for x, y in zip(a, b))
    sads, lam, _ = chip_smoke.k12_case(np, *chip_smoke.K12_CASES[4])
    sads = torch.from_numpy(sads)
    for a, b in zip(tpf._int_winner(sads, lam),
                    tpf._int_winner_plain(sads, lam)):
        assert torch.equal(a, b)
    case = chip_smoke.k9_case(np, *chip_smoke.K9_CASES[9])
    t = torch.from_numpy
    sym, _, _ = tpf.encode_pframe_rows_multi(
        t(case["y"]), t(case["u"]), t(case["v"]), t(case["refs_y"]),
        t(case["refs_u"]), t(case["refs_v"]), case["qp"],
        halo=case["halo"])
    tpf.decode_pframe_rows_multi(sym, t(case["refs_y"]), t(case["refs_u"]),
                                 t(case["refs_v"]), case["qp"],
                                 halo=case["halo"])
    assert (tpf._references.launches, tpf._int_winner.launches) == before


def test_routers_raise_off_the_cpu(monkeypatch):
    """A tensor off the CPU never reaches a plain version: on a device the
    kernels cannot take (meta), or where the inputs are no DPB or no SAD
    table, both routers raise before any launch."""
    def refuse(*a, **kw):
        raise AssertionError("a plain version or the library was called")

    monkeypatch.setattr(tpf, "_references_plain", refuse)
    monkeypatch.setattr(tpf, "_int_winner_plain", refuse)
    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = (tpf._references.launches, tpf._int_winner.launches)
    args = [x.to("meta") for x in _k11_inputs(chip_smoke.K11_CASES[3])[:3]]
    for halo in (False, True):
        with pytest.raises(ValueError):
            tpf._references(*args, halo)
    with pytest.raises(ValueError):
        tpf._references(args[0], args[1][:, :, 1:], args[2], False)
    sads = torch.zeros((1, 2, 3, tpf._NN), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        tpf._int_winner(sads, 4)
    with pytest.raises(ValueError):
        tpf._int_winner(sads[..., 1:], 4)
    assert (tpf._references.launches, tpf._int_winner.launches) == before
