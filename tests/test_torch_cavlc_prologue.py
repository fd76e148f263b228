"""K13 (the CAVLC prologue), K2's symbols entry and K3's slice entry.

Their sources run on CPU threads (tests/cuda_threads.py) against the
plain versions on every `chip_smoke.K13_CASES` case; the plain versions
equal the code they replace (`pframe_pack_inputs` / `iframe_pack_inputs`
with `_pack_blocks_plain` and `_merge_mbs`, `slice_strings` with
`tree_merge`); the whole slice stage equals the JAX package's
`entropy_tpu.encode_bits_pframe` / `encode_bits_iframe` on seeded
symbols; a source with the skip-run carry or the nC border rule broken
fails a case.  Every comparison is exact.
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.kernels import entropy_tpu
from tpuh264.kernels import iframe as jif
from tpuh264.kernels import pframe as jpf
from tpuh264_torch.entropy import cavlc_tables as tbl
from tpuh264_torch.kernels import cavlc_cuda, cuda_lib, entropy_gpu

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")

ENTRIES = {
    "k13": ("cavlc_prologue.cu", "pro_args", "prologue_kernel",
            "(a.rows + kWarps - 1) / kWarps", "32 * kWarps", ()),
    "k2": ("cavlc_pack.cu", "sym_args", "pack_symbols_kernel",
           "(a.rows + kRowsPB - 1) / kRowsPB", "kRowsPB",
           ("kPtrs=kSymPtrs",)),
    "k3": ("cavlc_merge.cu", "slice_args", "merge_slices_kernel", "a.L",
           "kBlockThreads", ("kPtrs=kSlicePtrs",)),
}


def _build(d, key, csrc=CSRC):
    src, args, kernel, blocks, threads, defines = ENTRIES[key]
    (d / "cavlc_tables.cuh").write_text(cuda_lib._tables_header())
    return cuda_threads.build_entry(d, csrc, src, args, kernel, blocks,
                                    threads, defines)


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """The three sources (all but their launch entries) built with g++
    against the shims: a block's warps as fibers, shuffles, ballots,
    shared atomics and block barriers switching between them."""
    return {k: _build(tmp_path_factory.mktemp(f"{k}_cpu"), k)
            for k in ENTRIES}


def _case(case, seed=0):
    return chip_smoke.k13_symbols(torch, chip_smoke.k13_case(np, *case,
                                                             seed=seed),
                                  "cpu")


def _zero():
    return torch.zeros(1, dtype=torch.int32)


def _prologue_on_threads(exe, sym, nra, pslice):
    ins, outs, ints = entropy_gpu._k13_operands(sym, _zero(), nra, pslice)
    return cuda_threads.run_entry(exe, ins, outs, ints, inout=(4,))


@pytest.mark.parametrize("case", chip_smoke.K13_CASES, ids=str)
def test_k13_source_on_cpu_threads_matches_plain(cpu_kernels, case):
    """K13's warp a row -- ballots for the skip runs, the left MB's
    right-column counts by a shuffle and a carry across passes of 32, the
    staged coalesced stores -- equals its plain version: chunk ints, header
    slots, trailing runs and the overflow flag."""
    _, _, nra, pslice = case
    sym = _case(case)
    ovf = _zero()
    want = entropy_gpu._prologue_plain(sym, ovf, nra, pslice)
    got = _prologue_on_threads(cpu_kernels["k13"], sym, nra, pslice)
    for what, g, w in zip(("chunk ints", "slot lengths", "slot values"),
                          got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=what)
    if pslice:
        np.testing.assert_array_equal(got[3].numpy(),
                                      want[3].reshape(-1, 2).numpy())
        assert int(got[4]) == int(ovf)


@pytest.mark.parametrize("case", chip_smoke.K13_CASES, ids=str)
def test_k2_symbols_and_k3_slices_on_cpu_threads_match_plain(cpu_kernels,
                                                             case):
    """K2's symbols entry (levels from the symbol arrays, the intra AC
    shift, absent chunks empty) and K3's slice entry (header, MB strings,
    tail and trailer each from its own buffer) equal their plain
    versions on the case, overflow flag included."""
    (lead, r, c), _, nra, pslice = case
    sym = _case(case)
    meta, hl, hv, tail = entropy_gpu._prologue_plain(sym, _zero(), nra,
                                                     pslice)
    o_plain = _zero()
    ww, wb = cavlc_cuda._pack_symbols_plain(sym, meta, hl, hv, 20, o_plain)
    ins, outs, ints = cavlc_cuda._k2_symbol_operands(sym, meta, hl, hv, 20,
                                                     _zero())
    gw, gb, go = cuda_threads.run_entry(cpu_kernels["k2"], ins, outs, ints,
                                        inout=(2,))
    np.testing.assert_array_equal(gb.numpy(), wb.numpy())
    np.testing.assert_array_equal(gw.numpy(), ww.numpy())
    assert int(go) == int(o_plain)

    mw, mb = cavlc_cuda.tree_merge(ww.reshape(lead, r, c, 27, 20),
                                   wb.reshape(lead, r, c, 27), 128)
    hdr = chip_smoke.k13_headers(torch, np, lead, r, "cpu")
    t = None if tail is None else tail.reshape(lead, r, 2)
    o_plain = _zero()
    sw, sb = cavlc_cuda._merge_slices_plain(*hdr, mw, mb, t, 8192, o_plain)
    ins, outs, ints = cavlc_cuda._k3_slice_operands(*hdr, mw, mb, t, 8192,
                                                    _zero())
    gw, gb, go = cuda_threads.run_entry(cpu_kernels["k3"], ins, outs, ints,
                                        inout=(2,))
    np.testing.assert_array_equal(gb.numpy(), sb.numpy())
    np.testing.assert_array_equal(gw.numpy(), sw.numpy())
    assert int(go) == int(o_plain)


def _k3s(name):
    """A K3S_CASES case as K3's slice entry's arguments (CPU tensors) and
    its n_out."""
    *parts, n_out = chip_smoke.k3s_case(np, name)
    return [None if x is None else torch.from_numpy(x) for x in parts], n_out


def _k3s_on_threads(exe, parts, n_out):
    """K3's slice entry (`exe`) and its plain version on one input: their
    (words, bytes, overflow flag)."""
    want_ovf = _zero()
    want = cavlc_cuda._merge_slices_plain(*parts, n_out, want_ovf)
    ins, outs, ints = cavlc_cuda._k3_slice_operands(*parts, n_out, _zero())
    got = cuda_threads.run_entry(exe, ins, outs, ints, inout=(2,))
    return got, [*want, want_ovf]


@pytest.mark.parametrize("name", chip_smoke.K3S_CASES)
def test_k3_slice_edges_on_cpu_threads_match_plain(cpu_kernels, name):
    """K3's slice entry equals its plain version on the edge case: every
    word of every row (the zero tail included), the byte counts and the
    flag."""
    got, want = _k3s_on_threads(cpu_kernels["k3"], *_k3s(name))
    for what, g, w in zip(("words", "bytes", "overflow flag"), got, want):
        np.testing.assert_array_equal(g.numpy(), w.numpy(), err_msg=what)


def test_k3_slice_edges_meet_their_corners():
    """The edge cases are what they claim: bodies that end on a word
    boundary and bodies whose trailer does, empty MB strings, words that
    hold many strings, bodies exactly at 32 * 8192 - 64 bits (no flag),
    one past it and past the row (the flag), an MB past its 128 words,
    1,024 strings a slice, and rows that start off a 16-byte boundary."""
    body = {}
    for name in chip_smoke.K3S_CASES:
        (_, hl, _, mb, t), n_out = _k3s(name)
        body[name] = (hl + mb.sum(-1) + (0 if t is None else t[:, 1]), mb,
                      t, n_out)
    b = body["aligned"][0]
    assert ((b % 32) == 0).any() and (((b + 8) % 32) == 0).any()
    assert not body["empty"][1].any() and body["empty-i"][2] is None
    mb = body["short"][1]
    assert (mb > 0).all(-1).any() or ((mb > 0) & (mb < 8)).sum() > 1000
    assert body["short"][3] % 4
    limit = 32 * 8192 - 64
    assert (body["limit"][0] == limit).all()
    b, mb = body["overflow"][:2]
    assert b[0] == limit + 1 and b[1] > 32 * 8192 and (mb > 32 * 128).any()
    assert body["k1024"][1].shape[-1] + 3 == 1024


@pytest.mark.parametrize("case", chip_smoke.K13_CASES, ids=str)
def test_plain_stage_equals_the_code_it_replaces(case):
    """The stage on the symbols (K13's, K2's and K3's new plain versions)
    gives the slice words, bytes and overflow flag of the joined-buffer
    stage it replaces: `pframe_slice_parts` / `iframe_slice_parts`
    (levels27, `_merge_mbs`' masks) and `_finish_slices`."""
    (lead, r, c), _, nra, pslice = case
    sym = _case(case)
    hdr = chip_smoke.k13_headers(torch, np, lead, r, "cpu")
    if pslice:
        got = entropy_gpu.encode_bits_pframe(sym, 28, *hdr, nra=nra)
        parts = entropy_gpu.pframe_slice_parts(sym, *hdr, nra)
    else:
        got = entropy_gpu.encode_bits_iframe(sym, 28, *hdr)
        parts = entropy_gpu.iframe_slice_parts(sym, *hdr)
    old = entropy_gpu._finish_slices(*parts[:2])
    np.testing.assert_array_equal(got[0].numpy(), old[0].numpy())
    np.testing.assert_array_equal(got[1].numpy(), old[1].numpy())
    assert bool(got[2]) == bool(parts[2] | old[2])


def _jax_sym(sym, cls):
    return cls(**{f: None if getattr(sym, f) is None
                  else jnp.asarray(getattr(sym, f).numpy())
                  for f in cls._fields if hasattr(sym, f)})


# nra 1, 2 and 3 on mixed rows (skip, inter and intra-in-P MBs, an
# all-skip row), a row whose only coded MB is its last, all-skip rows, the
# inter / intra borders, and I slices
JAX_CASES = [((3, 2, 5), "mixed", 1, True), ((3, 2, 5), "mixed", 2, True),
             ((3, 2, 5), "mixed", 3, True), ((1, 2, 33), "last", 1, True),
             ((2, 1, 33), "skip", 2, True), ((2, 3, 5), "border", 1, True),
             ((3, 2, 5), "intra", 1, False)]


@pytest.mark.parametrize("case", JAX_CASES, ids=str)
def test_stage_matches_jax(case):
    """The port's slice stage (its plain versions) equals JAX's
    `encode_bits_pframe` / `encode_bits_iframe` on the seeded symbols:
    the bytes of every slice, its words up to them, the overflow flag."""
    (lead, r, c), _, nra, pslice = case
    sym = _case(case, seed=5)
    hdr = chip_smoke.k13_headers(torch, np, lead, r, "cpu")
    jh = tuple(jnp.asarray(x.numpy()) for x in hdr)
    if pslice:
        ref = entropy_tpu.encode_bits_pframe(_jax_sym(sym, jpf.MBSymbolsP),
                                             28, *jh, nra=nra)
        got = entropy_gpu.encode_bits_pframe(sym, 28, *hdr, nra=nra)
    else:
        ref = entropy_tpu.encode_bits_iframe(_jax_sym(sym, jif.MBSymbols),
                                             28, *jh)
        got = entropy_gpu.encode_bits_iframe(sym, 28, *hdr)
    assert bool(ref[2]) == bool(got[2])
    nb = np.asarray(ref[1])
    np.testing.assert_array_equal(nb, got[1].numpy())
    rw, gw = np.asarray(ref[0]), got[0].numpy()
    for i in np.ndindex(nb.shape):
        nw = (int(nb[i]) + 3) // 4
        np.testing.assert_array_equal(rw[i][:nw], gw[i][:nw])


def test_k13_inter_cbp_table_is_the_ports():
    """K13's __constant__ me(v) table is tbl.CBP_INTER_INV."""
    src = open(os.path.join(CSRC, "cavlc_prologue.cu")).read()
    body = re.search(r"kCbpInterInv\[48\] = \{([^}]*)\}", src).group(1)
    assert [int(x) for x in body.split(",")] == [
        tbl.CBP_INTER_INV[i] for i in range(48)]


# Mutations of K13's source, each of which a case must catch: the skip
# run forgets the carry across passes of 32 columns; the nC rule takes
# the left MB's counts as unavailable (the top block's rule at the MB
# border); lane 0 ignores the carried counts.
MUTATIONS = {
    "skip-run carry": ("const int prev = below ? c0 + 31 - __clz((int)below) "
                       ": carry_prev;",
                       "const int prev = below ? c0 + 31 - __clz((int)below) "
                       ": (c0 ? c0 - 1 : -1);"),
    "nC border rule": ("ncy[b] = nc_of(bx > 0 || a_mb, na,",
                       "ncy[b] = nc_of(bx > 0, na,"),
    "nC carry": ("if (lane == 0) left_y = carry_y, left_v = carry_v;",
                 "if (lane == 0) left_y = 0, left_v = 0;"),
}


@pytest.mark.parametrize("name", MUTATIONS)
def test_a_broken_k13_fails_a_case(tmp_path, name):
    """K13's source with one rule broken (built from a copy in a
    temporary directory) differs from the plain version on some case: the
    cases reach the skip-run carry and the nC rules at MB borders and
    across passes of 32 columns."""
    old, new = MUTATIONS[name]
    src = open(os.path.join(CSRC, "cavlc_prologue.cu")).read()
    assert src.count(old) == 1
    (tmp_path / "cavlc_prologue.cu").write_text(src.replace(old, new))
    exe = _build(tmp_path, "k13", csrc=str(tmp_path))
    for case in chip_smoke.K13_CASES:
        _, _, nra, pslice = case
        sym = _case(case)
        want = entropy_gpu._prologue_plain(sym, _zero(), nra, pslice)
        got = _prologue_on_threads(exe, sym, nra, pslice)
        if any(not torch.equal(g, w) for g, w in zip(got[:3], want[:3])):
            return
    pytest.fail(f"no case caught the mutation {name!r}")


# K3's slice entry with its search off by one word: a used word that is
# a string's first is taken as a word past the end of the string before.
K3_SEARCH_OFF_BY_ONE = (
    "  const int n_used = used[K];\n"
    "  for (int j = tid; j < n_used; j += kBlockThreads) {\n"
    "    int lo = 0, hi = K - 1;  // the last string k with used[k] <= j\n"
    "    while (lo < hi) {\n"
    "      const int mid = (lo + hi + 1) >> 1;\n"
    "      if (used[mid] <= j) {\n",
    "  const int n_used = used[K];\n"
    "  for (int j = tid; j < n_used; j += kBlockThreads) {\n"
    "    int lo = 0, hi = K - 1;  // the last string k with used[k] <= j\n"
    "    while (lo < hi) {\n"
    "      const int mid = (lo + hi + 1) >> 1;\n"
    "      if (used[mid] < j) {\n")


def test_a_broken_k3_search_fails_a_case(tmp_path):
    """K3's slice entry with its search off by one word (built from a copy
    in a temporary directory) differs from the plain version on an edge
    case."""
    old, new = K3_SEARCH_OFF_BY_ONE
    src = open(os.path.join(CSRC, "cavlc_merge.cu")).read()
    assert src.count(old) == 1
    (tmp_path / "cavlc_merge.cu").write_text(src.replace(old, new))
    exe = _build(tmp_path, "k3", csrc=str(tmp_path))
    for name in chip_smoke.K3S_CASES:
        got, want = _k3s_on_threads(exe, *_k3s(name))
        if not torch.equal(got[0], want[0]):
            return
    pytest.fail("no edge case caught the search's off-by-one")


def test_cpu_tensors_never_reach_the_kernels(monkeypatch):
    """On CPU tensors the three routers take their plain versions and
    never load the library; a tensor on another device raises rather
    than falling back."""
    monkeypatch.setattr(cuda_lib, "load", lambda: pytest.fail("loaded"))
    sym = _case(((2, 2, 3), "mixed", 2, True))
    hdr = chip_smoke.k13_headers(torch, np, 2, 2, "cpu")
    launches = (entropy_gpu.cavlc_prologue.launches,
                cavlc_cuda.pack_symbols.launches,
                cavlc_cuda.merge_slices.launches)
    entropy_gpu.encode_bits_pframe(sym, 28, *hdr, nra=2)
    assert launches == (entropy_gpu.cavlc_prologue.launches,
                        cavlc_cuda.pack_symbols.launches,
                        cavlc_cuda.merge_slices.launches)
    meta = type(sym)(*[None if x is None else x.to("meta") for x in sym])
    with pytest.raises((ValueError, TypeError, RuntimeError,
                        NotImplementedError)):
        entropy_gpu.cavlc_prologue(meta, _zero().to("meta"), 2)


def test_time_entropy_names_its_source():
    """tools/time_entropy.py builds the source that holds K3's slice
    entry and calls the entries it names there."""
    import importlib.util

    path = os.path.join(os.path.dirname(__file__), os.pardir, "tools",
                        "time_entropy.py")
    spec = importlib.util.spec_from_file_location("time_entropy", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    with open(os.path.join(CSRC, tool.SOURCE)) as f:
        src = f.read()
    for entry in (tool.ENTRY, tool.RESIDENT):
        assert f'extern "C" int {entry}(' in src, entry
    assert "merge_slices_kernel" in src
