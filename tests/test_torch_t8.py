"""The 8x8 transform in the port's P path against the JAX package, on the
CPU, exactly: `encode_pframe_rows_multi(t8=True)` at 64x48 x 2 (stream 0
a smooth textured field moving by a few pels, its left half brightening,
where the 8x8 transform wins, its right half flashing in the middle
frame, where reference 1 wins; stream 1 the "noise" source), with
intra-in-P on and off and with 1 and 2 references;
`decode_pframe_rows_multi(t8=True)` on those symbols;
`deblock_nnz(..., True)` and `deblock_frame_rows(t8=...)` on seeded
symbols that mix t8, intra, skip and coded MBs, and on the encoder's."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuh264.engine.encoder import _deblock_nnz as j_deblock_nnz
from tpuh264.kernels import deblock as jdb
from tpuh264.kernels import pframe as JP
from tpuh264_torch.engine import sources
from tpuh264_torch.kernels import deblock as tdb
from tpuh264_torch.kernels import pframe as TP

S, H, W, QP = 2, 48, 64, 28
# (references, intra_in_p): each is a JAX compile of its own
CASES = [(1, True), (1, False), (2, True), (2, False)]


def _frames():
    """Three frames [S, H, W] (+ chroma) uint8: stream 0 a smooth texture
    moving by (t, 2t) pels, its left half 4t levels brighter and its right
    half 10 levels brighter at t = 1 only; stream 1 the "noise" source."""
    rng = np.random.default_rng(7)
    t = rng.normal(0, 1, (H + 32, W + 32))
    for _ in range(4):
        t = (t + np.roll(t, 1, 0) + np.roll(t, -1, 0) + np.roll(t, 1, 1)
             + np.roll(t, -1, 1)) / 5.0
    tex = 128 + 100 * t / np.abs(t).max()
    out = []
    for f in range(3):
        y0 = tex[8 + f:8 + f + H, 8 + 2 * f:8 + 2 * f + W]
        y0 = y0 + rng.normal(0, 1.0, y0.shape)
        y0[:, :W // 2] += 4 * f
        y0[:, W // 2:] += (0, 10, 0)[f]
        c0 = [tex[8 + f:8 + f + H:2, 8 + 2 * f:8 + 2 * f + W:2] * 0.5 + 64,
              tex[9 + f:9 + f + H:2, 9 + 2 * f:9 + 2 * f + W:2] * 0.4 + 77]
        noise = sources.yuv_frame(W, H, f, "noise", seed=1)
        out.append([np.stack([np.clip(a, 0, 255), b]).astype(np.uint8)
                    for a, b in zip((y0, *c0), noise)])
    return out


FRAMES = _frames()


def _eq(j, t, msg=""):
    np.testing.assert_array_equal(np.asarray(j), t.cpu().numpy(),
                                  err_msg=msg)


@pytest.fixture(scope="module", params=CASES,
                ids=[f"n{n}-{'iip' if i else 'rtc'}" for n, i in CASES])
def encoded(request):
    n, iip = request.param
    cur = FRAMES[2]
    refs = [np.stack([FRAMES[1 - k][p] for k in range(n)]) for p in range(3)]
    jout = JP.encode_pframe_rows_multi(*cur, *refs, QP, t8=True,
                                       intra_in_p=iip)
    tout = TP.encode_pframe_rows_multi(
        *(torch.from_numpy(x) for x in (*cur, *refs)), QP, t8=True,
        intra_in_p=iip)
    return n, iip, refs, jout, tout


def test_encode_t8_matches_jax(encoded):
    n, iip, _, (jsym, jrec, jmv), (tsym, trec, tmv) = encoded
    for name in TP.MBSymbolsP._fields:
        _eq(getattr(jsym, name), getattr(tsym, name), name)
    for a, b in zip(jrec, trec):
        assert b.dtype == torch.uint8
        _eq(a, b, "recon")
    for a, b in zip(jmv, tmv):
        _eq(a, b, "motion")
    kind, t8 = tsym.kind.numpy(), tsym.t8.numpy()
    inter = kind == TP.KIND_INTER
    assert t8[inter].any() and not t8[inter].all(), "no t8 / 4x4 mix"
    assert not t8[kind != TP.KIND_INTER].any()
    assert (kind == TP.KIND_INTRA).any() == iip
    if n == 2:
        assert (tsym.refidx.numpy()[inter] == 1).any()


def test_decode_t8_matches_jax_and_the_recon(encoded):
    n, iip, refs, (jsym, _, jmv), (tsym, trec, tmv) = encoded
    jdec, jdmv = JP.decode_pframe_rows_multi(jsym, *refs, QP, t8=True)
    tdec, tdmv = TP.decode_pframe_rows_multi(
        tsym, *(torch.from_numpy(r) for r in refs), QP, t8=True)
    for a, b, r in zip(jdec, tdec, trec):
        _eq(a, b, "decode")
        assert torch.equal(b, r)
    for a, b, m in zip(jdmv, tdmv, tmv):
        _eq(a, b, "decoded motion")
        assert torch.equal(b, m)


def test_deblock_of_the_t8_encode_matches_jax(encoded):
    _, _, _, (jsym, jrec, jmv), (tsym, trec, tmv) = encoded
    jnnz = j_deblock_nnz(jsym, True)
    _eq(jnnz, tdb.deblock_nnz(tsym, True), "nnz")
    j = jdb.deblock_frame_rows(*jrec, jsym.kind, *jmv, jnnz, QP,
                               refidx=jsym.refidx, t8=jsym.t8)
    t = tdb.deblock_p(trec, tsym, tmv, QP, t8=True)
    for a, b in zip(j, t):
        _eq(a, b)


def _mixed_symbols(seed, s, r, c):
    """Seeded P symbols: skip / inter / intra MBs, t8 on about half the
    inter ones, sparse levels (zero for skip MBs)."""
    rng = np.random.default_rng(seed)
    kind = rng.integers(0, 3, (s, r, c)).astype(np.int32)
    t8 = ((kind == 1) & (rng.random((s, r, c)) < 0.5)).astype(np.int32)
    lac = rng.integers(-3, 4, (s, r, c, 16, 16))
    lac[rng.random(lac.shape) < 0.93] = 0
    lac[kind == 0] = 0
    z = np.zeros((s, r, c), np.int32)
    sym = dict(kind=kind, mode=z, cmode=z, cbp_luma=z, cbp_chroma=z,
               mvdx=z, mvdy=z, luma_dc=np.zeros((s, r, c, 16), np.int16),
               luma_ac=lac.astype(np.int16),
               chroma_dc=np.zeros((s, r, c, 2, 4), np.int16),
               chroma_ac=np.zeros((s, r, c, 2, 4, 15), np.int16),
               refidx=rng.integers(0, 2, (s, r, c)).astype(np.int32), t8=t8)
    return (JP.MBSymbolsP(**{k: jnp.asarray(v) for k, v in sym.items()}),
            TP.MBSymbolsP(**{k: torch.from_numpy(v) for k, v in sym.items()}))


@pytest.mark.parametrize("h,w,qp", [(48, 64, 30), (64, 96, 40), (48, 64, 51)])
def test_deblock_t8_mixed_symbols_match_jax(h, w, qp):
    s, r, c = 2, h // 16, w // 16
    jsym, tsym = _mixed_symbols(h + w + qp, s, r, c)
    assert (tsym.t8 == 1).any() and ((tsym.kind == 1) & (tsym.t8 == 0)).any()
    for en in (False, True):
        _eq(j_deblock_nnz(jsym, en), tdb.deblock_nnz(tsym, en), f"nnz {en}")
    rng = np.random.default_rng(qp)
    planes = [rng.integers(0, 256, (s, hh, ww)).astype(np.uint8)
              for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2))]
    planes[0] = np.clip(planes[0] // 4 + 100, 0, 255).astype(np.uint8)
    mvx = rng.integers(-9, 10, (s, r, c)).astype(np.int32)
    mvy = rng.integers(-9, 10, (s, r, c)).astype(np.int32)
    jnnz = j_deblock_nnz(jsym, True)
    j = jdb.deblock_frame_rows(*planes, jsym.kind, mvx, mvy, jnnz, qp,
                               refidx=jsym.refidx, t8=jsym.t8)
    t = tdb.deblock_frame_rows(
        *(torch.from_numpy(p) for p in planes), tsym.kind,
        torch.from_numpy(mvx), torch.from_numpy(mvy),
        tdb.deblock_nnz(tsym, True), qp, refidx=tsym.refidx, t8=tsym.t8)
    for a, b in zip(j, t):
        _eq(a, b)
    # the t8 edges matter: without the flags the port filters otherwise
    t0 = tdb.deblock_frame_rows(
        *(torch.from_numpy(p) for p in planes), tsym.kind,
        torch.from_numpy(mvx), torch.from_numpy(mvy),
        tdb.deblock_nnz(tsym, True), qp, refidx=tsym.refidx)
    assert not all(torch.equal(a, b) for a, b in zip(t, t0))
