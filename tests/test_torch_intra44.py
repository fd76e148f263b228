"""The port's Intra_4x4 (tpuh264_torch.kernels.intra44) and the I scan with
`intra44=True` against the JAX package, on the CPU, exactly: the tables,
the directional predictions and the causal MB encode / decode on seeded
neighbours, then `encode_iframe_scan` / `decode_iframe_scan` at 64x48 x 2
streams on noise and gradient content at QP 20 / 32 / 44 (symbols,
i4modes and recon identical; Intra_4x4 actually chosen)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuh264.kernels import iframe as j_iframe
from tpuh264.kernels import intra44 as j_i44
from tpuh264_torch.kernels import iframe as t_iframe
from tpuh264_torch.kernels import intra44 as t_i44


def _eq(a, b, what=""):
    a = np.asarray(a)
    b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
    assert a.shape == b.shape, (what, a.shape, b.shape)
    np.testing.assert_array_equal(a.astype(np.int64), b.astype(np.int64),
                                  err_msg=what)


def test_tables_and_rate_proxy_match():
    for a, b in zip(j_i44._build_tables(), t_i44._build_tables()):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert t_iframe._LAMBDA8 == [int(x) for x in np.asarray(j_iframe._LAMBDA8)]
    rng = np.random.default_rng(5)
    c = rng.integers(-40000, 40000, (7, 4, 16)).astype(np.int32)
    c[rng.random(c.shape) < 0.5] = 0
    c[0, 0, :5] = [1, -1, 32767, -32768, 65535]
    for dims in ((-1,), (-1, -2)):
        _eq(j_iframe._rate_bits(jnp.asarray(c), dims),
            t_iframe._rate_bits(torch.from_numpy(c), dims), str(dims))


def test_pred_directional_matches():
    rng = np.random.default_rng(1)
    n = rng.integers(0, 256, (3, 50, 13)).astype(np.int32)
    n[0, 0] = 255
    n[0, 1] = 0
    got = t_i44.pred_directional(torch.from_numpy(n))
    assert got.dtype == torch.int32
    _eq(j_i44.pred_directional(jnp.asarray(n)), got)
    for i in range(5):
        ref = j_i44.pred_all_np(n[0, i], True, True).reshape(9, 16)
        _eq(ref[[0, 1, 3, 4, 5, 6, 7, 8]],
            got[0, i][[0, 1, 3, 4, 5, 6, 7, 8]], f"vector {i}")


def _mb_inputs(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        src = rng.integers(0, 256, (2, 6, 16, 16))
    else:  # directional structure, so the I4x4 modes differ per block
        yy, xx = np.mgrid[0:16, 0:16]
        src = (np.stack([[(xx * a + yy * b + 7 * k) % 256
                          for k, (a, b) in enumerate(
                              rng.integers(-9, 10, (6, 2)))]
                         for _ in range(2)]) + rng.integers(0, 5, (2, 6, 16, 16)))
    src = np.clip(src, 0, 255).astype(np.int32)
    left = rng.integers(0, 256, (2, 6, 16)).astype(np.int32)
    l_ok = rng.random((2, 6)) < 0.6
    return src, left, l_ok


@pytest.mark.parametrize("kind", ["noise", "structured"])
@pytest.mark.parametrize("qp", [12, 30, 45])
def test_encode_mb_decode_mb_match(kind, qp):
    src, left, l_ok = _mb_inputs(qp, kind)
    j = j_i44.encode_mb(jnp.asarray(src), jnp.asarray(left),
                        jnp.asarray(l_ok), jnp.int32(qp))
    t = t_i44.encode_mb(torch.from_numpy(src), torch.from_numpy(left),
                        torch.from_numpy(l_ok), qp)
    for name, a, b in zip(("sad", "modes", "coeffs", "cbp", "rec"), j, t):
        _eq(a, b, name)
    assert len(np.unique(np.asarray(j[1]))) > 3  # several modes chosen
    d = t_i44.decode_mb(t[2], t[1], torch.from_numpy(left),
                        torch.from_numpy(l_ok), qp)
    _eq(j_i44.decode_mb(j[2], j[1], jnp.asarray(left), jnp.asarray(l_ok),
                        jnp.int32(qp)), d, "decode")
    _eq(t[4], d, "decode == encoder recon")


def _frames(kind, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "noise":
        y = rng.integers(0, 256, (2, 48, 64))
    else:
        yy, xx = np.mgrid[0:48, 0:64]
        y = np.stack([(3 * xx + 2 * yy) % 256, (xx * yy // 7) % 256])
        y = y + rng.integers(0, 3, (2, 48, 64))
    u = rng.integers(60, 200, (2, 24, 32))
    v = rng.integers(60, 200, (2, 24, 32))
    return [np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v)]


@pytest.mark.parametrize("kind", ["noise", "gradient"])
@pytest.mark.parametrize("qp", [20, 32, 44])
def test_iframe_scan_intra44_matches(kind, qp):
    y, u, v = _frames(kind, qp)
    js, jr = j_iframe.encode_iframe_scan(jnp.asarray(y), jnp.asarray(u),
                                         jnp.asarray(v), jnp.int32(qp),
                                         intra44=True)
    ts, tr = t_iframe.encode_iframe_scan(torch.from_numpy(y),
                                         torch.from_numpy(u),
                                         torch.from_numpy(v), qp,
                                         intra44=True)
    for name in j_iframe.MBSymbols._fields:
        a, b = getattr(js, name), getattr(ts, name)
        assert np.asarray(a).dtype == b.numpy().dtype, name
        _eq(a, b, name)
    for a, b in zip(jr, tr):
        assert b.dtype == torch.uint8
        _eq(a, b, "recon")
    if kind == "gradient":  # full-range noise keeps Intra_16x16 everywhere
        assert int((ts.mode == 4).sum()) > 0, "Intra_4x4 never chosen"
    # the decode of the encoder's symbols, both packages, equals the recon
    dec = t_iframe.decode_iframe_scan(ts, qp, intra44=True)
    jdec = j_iframe.decode_iframe_scan(js, jnp.int32(qp), intra44=True)
    for a, b, c in zip(jdec, dec, tr):
        _eq(a, b, "decode")
        _eq(c, b, "decode == recon")


def test_flat_symbol_transport_matches():
    y, u, v = _frames("gradient")
    ts, _ = t_iframe.encode_iframe_scan(*(torch.from_numpy(p)
                                          for p in (y, u, v)), 24,
                                        intra44=True)
    js = j_iframe.MBSymbols(*(jnp.asarray(x.numpy()) for x in ts))
    for i4 in (False, True):
        assert t_iframe.symbol_sizes(2, 3, 4, i4) == j_iframe.symbol_sizes(
            2, 3, 4, i4)
        flat = t_iframe.flatten_symbols(ts, i4=i4)
        jflat = j_iframe.flatten_symbols(
            js if i4 else js._replace(i4modes=None))
        _eq(jflat, flat)
        back = t_iframe.unflatten_symbols_np(flat.numpy(), 2, 3, 4, i4)
        jback = j_iframe.unflatten_symbols_np(np.asarray(jflat), 2, 3, 4, i4)
        assert back.keys() == jback.keys()
        for k in back:
            _eq(jback[k], back[k], k)
