"""K4's ring entry (`kernels/deblock.py` `deblock_ring`): its source on CPU
threads against the plain deblock on `deblock_nnz`'s grid, mutants of its
coded-block rule, and the router's CPU route into a given output.

The inputs come from `chip_smoke.d1_ring_args`: PR 10's `D1_SHAPES` and
every D1 variant and QP, the per-MB fields as the GOP decode's record
views (each with its own MB stride, the levels at slot 16 of a 400-slot
record whose luma DC slots are noise) or as separate tensors, `t8` MBs, an inter MB coded in one 4x4 block alone every
7th MB, and all-intra frames passed as deblock_i passes them (no
fields).  chip_smoke.py phase 2 holds the kernel to the same plain
version on the card.  Every comparison is exact.
"""

import concurrent.futures
import os

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import deblock as tdb

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")
KERNEL = "deblock_rows_kernel<uint8_t, true>"
# mutants of the coded-block rule, each by a replacement in the source:
# the 8x8 rule dropped; the block before the thread's read (the luma DC
# for block 0 in a record); the blocks read in transposed order
MUTANTS = {
    "no 8x8 rule": ("if (kLev && in.t8 == 1) m = rule8x8(m);", ""),
    "luma DC counted": ("a.lev + mb * a.slev + 16 * j)",
                        "a.lev + mb * a.slev + 16 * j - 16)"),
    "blocks transposed": ("a.lev + mb * a.slev + 16 * j)",
                          "a.lev + mb * a.slev + 16 * ((j & 3) * 4 + j / 4))"),
}


def _build(d, src_dir):
    return cuda_threads.build_entry(d, src_dir, "deblock.cu", "ring_args",
                                    KERNEL, "(a.lanes + 1) / 2", "64")


@pytest.fixture(scope="module")
def ring_cpu(tmp_path_factory):
    """csrc/deblock.cu (all but its entries) built with g++ against the
    shims: a block's two warps as fibers, the ballot through their
    exchanges."""
    return _build(tmp_path_factory.mktemp("k4_ring_cpu"), CSRC)


def _run(exe, args, kw):
    y, u, v, kind, mvx, mvy, lac, qp = args
    out = [torch.zeros(p.shape, dtype=torch.uint8) for p in (y, u, v)]
    ins, outs, ints = tdb._k4_ring_operands(
        [y, u, v], kind, mvx, mvy, lac, qp, kw.get("refidx"), kw.get("t8"),
        out)
    return cuda_threads.run_entry(exe, ins, outs, ints)


def _cases(variant):
    return [c for c in chip_smoke.D1_CASES if c[1] == variant]


@pytest.mark.parametrize("layout", chip_smoke.D1_RING_LAYOUTS)
@pytest.mark.parametrize("variant", chip_smoke.D1_VARIANTS)
def test_ring_source_on_cpu_threads_matches_plain(ring_cpu, variant, layout):
    """The ring entry's byte rows, its fields read in place with
    their MB strides and its coded blocks from the levels (one ballot a
    column, the 8x8 rule for t8 MBs) equal `_deblock_rows_plain` on
    `deblock_nnz`'s grid, on every shape and QP of the variant."""
    for case in _cases(variant):
        args, kw = chip_smoke.d1_ring_args(torch, np, case, layout, True,
                                           "cpu")
        got = _run(ring_cpu, args, kw)
        want = chip_smoke.d1_ring_plain(args, kw)
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=str(case))


def test_cases_cover_what_they_claim():
    """The levels code MBs of every count of coded blocks, MBs coded in
    one 4x4 block alone, and t8 MBs whose 8x8 rule changes the grid; the
    records hold nonzero luma DC beside the levels."""
    case = ((3, 80, 112), "t8", 30)
    args, kw = chip_smoke.d1_ring_args(torch, np, case, "records", True,
                                       "cpu")
    lac, t8 = args[6], kw["t8"]
    coded = lac.ne(0).any(-1)  # [S, R, C, 16]
    per_mb = coded.sum(-1)
    assert int(per_mb.min()) == 0 and int(per_mb.max()) >= 8
    one = (per_mb == 1) & (lac.ne(0).sum((-1, -2)) == 1)
    assert bool(one.any())
    import types

    rule = tdb.deblock_nnz(types.SimpleNamespace(luma_ac=lac, t8=t8), True)
    plain = tdb.deblock_nnz(types.SimpleNamespace(luma_ac=lac, t8=t8), False)
    assert bool(((rule > 0) != (plain > 0)).any())
    slots = chip_smoke.d1_ring_case(np, case, "records")[4]
    assert (slots[..., :16] != 0).any()


@pytest.fixture(scope="module")
def mutants(tmp_path_factory):
    """The source with each MUTANTS replacement, built in parallel."""
    with open(os.path.join(CSRC, "deblock.cu")) as f:
        src = f.read()

    def one(name):
        old, new = MUTANTS[name]
        assert old in src
        d = tmp_path_factory.mktemp("k4_mutant")
        (d / "deblock.cu").write_text(src.replace(old, new))
        return name, _build(d, str(d))

    with concurrent.futures.ThreadPoolExecutor(len(MUTANTS)) as ex:
        return dict(ex.map(one, MUTANTS))


def test_coded_rule_mutants_fail(mutants):
    """Each mutant of the coded-block rule differs from the plain deblock
    on some case (the record layout, uint8 planes, QP 30)."""
    cases = [(shape, var, 30) for shape in chip_smoke.D1_SHAPES
             for var in ("inter", "t8")]
    for name, exe in mutants.items():
        caught = False
        for case in cases:
            args, kw = chip_smoke.d1_ring_args(torch, np, case, "records",
                                               True, "cpu")
            got = _run(exe, args, kw)
            want = chip_smoke.d1_ring_plain(args, kw)
            if any(not torch.equal(a, b) for a, b in zip(got, want)):
                caught = True
                break
        assert caught, f"mutant {name!r} passed every case"


def test_cpu_route_writes_the_given_output(monkeypatch):
    """On CPU tensors deblock_i / deblock_p take the plain version into the
    given output (a ring slot's views: the other slot untouched) without
    loading the library, int32 planes too; a meta tensor raises."""
    monkeypatch.setattr(cuda_lib, "load", lambda: pytest.fail("loaded"))
    args, kw = chip_smoke.d1_ring_args(torch, np, ((2, 32, 48), "t8", 30),
                                       "records", True, "cpu")
    ring = [torch.zeros((2, *p.shape), dtype=torch.uint8) for p in args[:3]]
    slot = tuple(r[1] for r in ring)
    n = tdb.deblock_ring.launches
    got = tdb.deblock_ring(*args, out=slot, **kw)
    assert all(g is s for g, s in zip(got, slot))
    for r, w in zip(ring, chip_smoke.d1_ring_plain(args, kw)):
        assert torch.equal(r[1], w) and not bool(r[0].any())
    rec = args[:3]
    intra = tdb.deblock_i(rec, 30, out=tuple(r[0] for r in ring))
    for a, b in zip(intra, tdb.deblock_i(rec, 30)):
        assert torch.equal(a, b)
    i32 = chip_smoke.d1_ring_args(torch, np, ((2, 32, 48), "t8", 30),
                                  "records", False, "cpu")
    for a, b in zip(tdb.deblock_ring(*i32[0], **i32[1]), got):
        assert torch.equal(a, b)
    assert tdb.deblock_ring.launches == n
    meta = [torch.zeros(p.shape, dtype=torch.uint8, device="meta")
            for p in rec]
    with pytest.raises(ValueError):
        tdb.deblock_i(meta, 30)
