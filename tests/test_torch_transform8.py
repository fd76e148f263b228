"""The port's 8x8 transform (tpuh264_torch.kernels.transform8) against the
JAX package's (tpuh264.kernels.transform8) on the CPU, exactly: random
residuals of seeded numpy draws with the extremes (+-255 blocks and
checkerboards), QP 0, 26 and 51, and levels up to the bound of the
original's header (|W| <= 16320, so each QP's largest level is the
quant of 16320)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpuh264.kernels import transform8 as J8
from tpuh264_torch.golden import transform8 as G8
from tpuh264_torch.kernels import transform8 as T8

QPS = (0, 26, 51)
W_MAX = 16320  # the original's bound on |W| of encoder residuals


def residuals(seed: int, n: int = 96) -> np.ndarray:
    """[n + 4, 8, 8] int32 residuals in [-255, 255], the last four the
    extremes: all +255, all -255 and the two checkerboards."""
    rng = np.random.default_rng(seed)
    r = rng.integers(-255, 256, (n, 8, 8))
    yy, xx = np.mgrid[0:8, 0:8]
    cb = np.where((yy + xx) % 2, 255, -255)
    ext = np.stack([np.full((8, 8), 255), np.full((8, 8), -255), cb, -cb])
    return np.concatenate([r, ext]).astype(np.int32)


def levels(seed: int, qp: int, n: int = 96) -> np.ndarray:
    """[n + 2, 8, 8] levels: random within +-(quant of W_MAX at qp), and
    the largest of each sign in every position."""
    top = int(np.abs(G8.quant8x8(np.full((8, 8), W_MAX), qp)).max())
    rng = np.random.default_rng(seed)
    z = rng.integers(-top, top + 1, (n, 8, 8))
    z[rng.random(z.shape) < 0.5] = 0  # sparse, as real levels are
    ext = np.stack([np.full((8, 8), top), np.full((8, 8), -top)])
    return np.concatenate([z, ext]).astype(np.int32)


def same(j, t):
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(np.asarray(j), t.numpy())


@pytest.mark.parametrize("seed", [0, 1])
def test_forward8x8_matches(seed):
    r = residuals(seed)
    w = T8.forward8x8(torch.from_numpy(r))
    same(J8.forward8x8(jnp.asarray(r)), w)
    np.testing.assert_array_equal(G8.forward8x8(r), w.numpy())
    assert int(w.abs().max()) <= W_MAX


@pytest.mark.parametrize("intra", [False, True])
@pytest.mark.parametrize("qp", QPS)
def test_quant8x8_matches(qp, intra):
    w = G8.forward8x8(residuals(qp + 2)).astype(np.int32)
    w[0] = W_MAX  # the bound itself, both signs
    w[1] = -W_MAX
    z = T8.quant8x8(torch.from_numpy(w), qp, intra=intra)
    same(J8.quant8x8(jnp.asarray(w), qp, intra=intra), z)
    np.testing.assert_array_equal(G8.quant8x8(w, qp, intra=intra), z.numpy())


@pytest.mark.parametrize("qp", QPS)
def test_dequant8x8_matches(qp):
    z = levels(qp, qp)
    d = T8.dequant8x8(torch.from_numpy(z), qp)
    same(J8.dequant8x8(jnp.asarray(z), qp), d)
    np.testing.assert_array_equal(G8.dequant8x8(z, qp), d.numpy())


@pytest.mark.parametrize("qp", QPS)
def test_inverse8x8_and_idct8_add_match(qp):
    d = G8.dequant8x8(levels(qp + 7, qp), qp).astype(np.int32)
    rng = np.random.default_rng(qp)
    pred = rng.integers(0, 256, d.shape).astype(np.int32)
    pred[-2], pred[-1] = 0, 255
    td = torch.from_numpy(d)
    same(J8.inverse8x8(jnp.asarray(d)), T8.inverse8x8(td))
    out = T8.idct8_add(torch.from_numpy(pred), td)
    same(J8.idct8_add(jnp.asarray(pred), jnp.asarray(d)), out)
    np.testing.assert_array_equal(G8.idct8_add(pred, d), out.numpy())
    assert 0 <= int(out.min()) and int(out.max()) <= 255


def test_round_trip_through_quant_matches():
    """Residual -> forward -> quant -> dequant -> idct8_add, per QP, the
    port's chain equal to the JAX chain at every step."""
    r = residuals(9)
    pred = np.full(r.shape, 128, np.int32)
    for qp in QPS:
        t = T8.quant8x8(T8.forward8x8(torch.from_numpy(r)), qp)
        j = J8.quant8x8(J8.forward8x8(jnp.asarray(r)), qp)
        same(j, t)
        same(J8.idct8_add(jnp.asarray(pred), J8.dequant8x8(j, qp)),
             T8.idct8_add(torch.from_numpy(pred), T8.dequant8x8(t, qp)))


@pytest.mark.parametrize("lead", [(), (3,), (2, 2, 5)])
def test_zigzag8_matches(lead):
    rng = np.random.default_rng(len(lead))
    b = rng.integers(-999, 1000, (*lead, 8, 8)).astype(np.int32)
    zz = T8.zigzag8(torch.from_numpy(b))
    same(J8.zigzag8(jnp.asarray(b)), zz)
    assert zz.shape == (*lead, 64)
    back = T8.inverse_zigzag8(zz)
    same(J8.inverse_zigzag8(jnp.asarray(np.asarray(zz))), back)
    np.testing.assert_array_equal(back.numpy(), b)
