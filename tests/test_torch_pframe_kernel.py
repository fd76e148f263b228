"""K9 (the P encode after stage A) and K10 (the P decode's inter part):
their sources run on CPU threads against the plain versions, the plain
paths against the JAX package's P encode and decode, and the routers.

The kernels' inputs come from `chip_smoke.k9_case` / `k10_case`, the
generators chip_smoke.py phase 2 holds the kernels to their plain
versions with on the card.  Every comparison is exact (array_equal):
this is an integer codec.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.kernels import pframe as jpf
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import pframe as tpf

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")

KERNELS = {
    "k9": ("pframe_enc.cu", "enc_args", "pframe_encode_kernel",
           "(a.S * a.R * a.C + kWarps - 1) / kWarps", "32 * kWarps"),
    "k10": ("pframe_dec.cu", "dec_args", "pframe_decode_kernel",
            "(a.S * a.R * a.C + kWarps - 1) / kWarps", "32 * kWarps"),
}


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """csrc/pframe_enc.cu and pframe_dec.cu (all but their launch entries)
    built with g++ against the shims of cuda_threads.py: each block's
    warps as fibers (`run_block_fibers`), its shuffles, ballots and block
    barriers switching between them."""
    return {key: cuda_threads.build_entry(
        tmp_path_factory.mktemp(f"{key}_cpu"), CSRC, *spec)
        for key, spec in KERNELS.items()}


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


def test_t8_routes_to_the_plain_versions(monkeypatch):
    """With `t8` (the CABAC + 8x8 session path) both routers take the
    plain versions by argument, on any device, without loading the kernel
    library; without it a tensor off the CPU never reaches a plain
    version: on a device the kernels cannot take, or at a QP outside
    0..51, it raises before any launch."""
    calls = []

    def plain(*a, **kw):
        calls.append(kw.get("t8", a[12] if len(a) > 12 else a[-1]))
        return "plain"

    def refuse():
        raise AssertionError("the kernel library was loaded")

    monkeypatch.setattr(tpf, "_inter_encode_plain", plain)
    monkeypatch.setattr(tpf, "_inter_decode_plain", plain)
    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = (tpf._inter_encode.launches, tpf._inter_decode.launches)
    enc = _meta(chip_smoke.k9_args(torch, chip_smoke.k9_case(
        np, *chip_smoke.K9_CASES[12]), "cpu"))
    dec = _meta(chip_smoke.k10_args(torch, chip_smoke.k10_case(
        np, *chip_smoke.K10_CASES[6]), "cpu"))
    assert tpf._inter_encode(**{**enc, "t8": True}) == "plain"
    assert tpf._inter_decode(**{**dec, "t8": True}) == "plain"
    assert len(calls) == 2
    for fn, kw in ((tpf._inter_encode, enc), (tpf._inter_decode, dec)):
        with pytest.raises(ValueError):
            fn(**kw)
        with pytest.raises(ValueError):
            fn(**{**kw, "qp": 52})
    assert len(calls) == 2
    assert (tpf._inter_encode.launches,
            tpf._inter_decode.launches) == before
