"""The DPB halo path of the port's P encode and decode against the JAX
package, on the CPU, exactly: a band of MB rows 1-3 of an 80-row frame,
its references vertically extended by the frame's real neighbour rows
(HALO_Y / HALO_C each side), through `encode_pframe_rows_multi(halo=
True)` and `decode_pframe_rows_multi(halo=True)` of both packages, with
t8 and intra-in-P off and on and 1 and 2 references (each pair of those
settings in one of four cases: each case is a JAX compile of its own);
`build_halfpel_planes_ext` against JAX's; and a negative control: the
band's edge rows replicated in place of the real rows change the
boundary rows' result, so what a row-sharded DPB exchanges matters."""

import numpy as np
import pytest
import torch

from tests.test_golden_pframe import moving_sequence
from tpuh264.kernels import pframe as JP
from tpuh264_torch.engine import sources
from tpuh264_torch.kernels import pframe as TP

S, H, W, QP = 2, 80, 64, 28
R0, R1 = 1, 4  # the band: MB rows 1..3 (luma rows 16..63)
# (t8, intra_in_p, references): every pair of values of two settings
CASES = [(False, False, 1), (True, True, 1), (False, True, 2),
         (True, False, 2)]


def _frames():
    """Three frames [S, H, W] (+ chroma) int32: stream 0 a gradient with a
    moving block, shifting by (2t, t) pels (vertical motion crosses the
    band's edges); stream 1 the "noise" source (intra MBs win in P)."""
    seq = moving_sequence(H, W, 3, seed=7)
    return [[np.stack([a, b]).astype(np.int32) for a, b in zip(
        seq[f], sources.yuv_frame(W, H, f, "noise", seed=3))]
        for f in range(3)]


FRAMES = _frames()


def _band(plane, mb: int):
    return plane[:, R0 * mb:R1 * mb]


def _ext(plane, mb: int, halo: int, real: bool = True):
    """The band's rows plus `halo` rows each side: the frame's real rows,
    or (real=False) the band's edge rows replicated."""
    lo, hi = R0 * mb, R1 * mb
    if real:
        return plane[:, lo - halo:hi + halo]
    band = plane[:, lo:hi]
    return np.concatenate([np.repeat(band[:, :1], halo, 1), band,
                           np.repeat(band[:, -1:], halo, 1)], 1)


def _inputs(n_refs: int, real: bool = True):
    cur = [_band(p, m) for p, m in zip(FRAMES[2], (16, 8, 8))]
    refs = [np.stack([_ext(FRAMES[1 - k][i], m, h, real)
                      for k in range(n_refs)])
            for i, (m, h) in enumerate(((16, JP.HALO_Y), (8, JP.HALO_C),
                                        (8, JP.HALO_C)))]
    return cur, refs


def _eq(j, t, msg=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(),
                                  err_msg=msg)


def _t(arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{'t8' if a else 't4'}-{'iip' if b else 'rtc'}-n{n}"
                     for a, b, n in CASES])
def encoded(request):
    t8, iip, n = request.param
    cur, refs = _inputs(n)
    jout = JP.encode_pframe_rows_multi(*cur, *refs, QP, halo=True, t8=t8,
                                       intra_in_p=iip)
    tout = TP.encode_pframe_rows_multi(*_t(cur), *_t(refs), QP, halo=True,
                                       t8=t8, intra_in_p=iip)
    return request.param, refs, jout, tout


def test_halo_encode_matches_jax(encoded):
    (t8, iip, n), _, (jsym, jrec, jmv), (tsym, trec, tmv) = encoded
    for name in TP.MBSymbolsP._fields:
        _eq(getattr(jsym, name), getattr(tsym, name), name)
    for a, b in zip(jrec, trec):
        _eq(a, b, "recon")
    for a, b in zip(jmv, tmv):
        _eq(a, b, "motion")
    kind = tsym.kind.numpy()
    assert (kind == TP.KIND_INTRA).any() == iip
    assert (tsym.t8.numpy() == 1).any() == t8
    # stream 0's content moves up: MVs of the band's bottom MB row point
    # down, across the band's edge into the halo rows
    assert (tmv[1][0, -1] > 0).any()


def test_halo_decode_matches_jax(encoded):
    (t8, _, _), refs, (jsym, jrec, _), (tsym, trec, _) = encoded
    jdec, _ = JP.decode_pframe_rows_multi(jsym, *refs, QP, halo=True, t8=t8)
    tdec, _ = TP.decode_pframe_rows_multi(tsym, *_t(refs), QP, halo=True,
                                          t8=t8)
    for a, b, r in zip(jdec, tdec, trec):
        _eq(a, b, "decode")
        assert torch.equal(b, r)


def test_build_halfpel_planes_ext_matches_jax():
    _, refs = _inputs(1)
    j = JP.build_halfpel_planes_ext(refs[0][0])
    t = TP.build_halfpel_planes_ext(torch.from_numpy(refs[0][0]))
    assert t[0].shape == (S, (R1 - R0) * 16 + 2 * TP.HALO_Y,
                          W + 2 * TP.HALO_Y)
    for a, b in zip(j, t):
        _eq(a, b, "plane")
    # equal to the full frame's planes over the band and its halo, but for
    # the vertical 6-tap margin of the outermost 3 rows (the filter reads
    # rows past the halo there; motion never reaches them)
    full = TP.build_halfpel_planes(torch.from_numpy(FRAMES[1][0]))
    for a, b in zip(full, t):
        a = a[:, R0 * 16:R1 * 16 + 2 * TP.HALO_Y]
        assert torch.equal(a[:, 3:-3], b[:, 3:-3])
    assert torch.equal(full[0][:, R0 * 16:R1 * 16 + 2 * TP.HALO_Y], t[0])


def test_edge_halo_in_place_of_real_rows_changes_the_result():
    """The negative control: with the band's edge rows replicated where
    the neighbour bands' rows belong, the boundary MB rows code another
    result, so the exchange carries information."""
    outs = []
    for real in (True, False):
        cur, refs = _inputs(1, real)
        outs.append(TP.encode_pframe_rows_multi(
            *_t(cur), *_t(refs), QP, halo=True, intra_in_p=False))
    (sym_a, rec_a, _), (sym_b, rec_b, _) = outs
    edge = [0, -1]
    assert not torch.equal(rec_a[0][:, [0, 15, -16, -1]],
                           rec_b[0][:, [0, 15, -16, -1]])
    assert not all(torch.equal(getattr(sym_a, f)[:, edge],
                               getattr(sym_b, f)[:, edge])
                   for f in ("kind", "mvdx", "mvdy", "luma_ac"))


def test_halo_references_are_byte_planes_equal_to_jax():
    """The halo band's references through `_references(halo=True)` (the
    route of K11's halo geometry: oy = 0, the 3 margin rows replicated)
    are uint8 planes with 16-byte-aligned rows whose samples, cast to
    int32, equal the JAX package's `build_halfpel_planes_ext` and
    `_pad_ref_ext` of the same extended band, every reference."""
    _, refs = _inputs(2)
    planes, up, vp = TP._references(*_t(refs), True)
    for n in range(2):
        want = JP.build_halfpel_planes_ext(refs[0][n])
        for k in range(4):
            _eq(want[k], planes[n][k].to(torch.int32), f"plane {k}")
        for got, ref in ((up[n], refs[1][n]), (vp[n], refs[2][n])):
            _eq(JP._pad_ref_ext(ref, TP._CP), got.to(torch.int32), "chroma")
        for t in (planes[n], up[n], vp[n]):
            assert t.dtype == torch.uint8 and t.data_ptr() % 16 == 0
            assert t.stride(-2) % 16 == 0 and t.stride(-2) >= t.shape[-1]
