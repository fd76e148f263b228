"""The port's single-slice wavefront (tpuh264_torch.kernels.wavefront)
against tpuh264.kernels.wavefront on the CPU, exactly: encode symbols and
recon, and the decode of those symbols, at 64x48 and 48x32 x 2 streams on
noise and gradient content, and on chip_smoke.py's seeded `W_CASES` (one
MB, one row, one column, R > C; ramps, mixed MB kinds, flat and
saturated frames; QP 0 to 51): every luma and chroma mode chosen
somewhere over the cases, Plane included.  The kernels K7 / K8 against
these plain versions: tests/test_torch_wavefront_kernel.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from tpuh264.kernels import wavefront as j_wf
from tpuh264_torch.kernels import wavefront as t_wf

CASES = [("noise", 30), ("gradient", 16), ("gradient", 36)]


def _frames(w, h, kind, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    if kind == "noise":
        y = rng.integers(0, 256, (2, h, w))
    else:  # ramps in different directions: V, H and Plane all win somewhere
        y = np.stack([(5 * xx + 3 * yy) % 256, np.where(yy < h // 2, 7 * xx,
                                                        9 * yy) % 256])
        y = y + rng.integers(0, 4, (2, h, w))
    u = np.stack([(4 * xx[::2, ::2]) % 256, (6 * yy[::2, ::2]) % 256])
    v = rng.integers(100, 140, (2, h // 2, w // 2))
    return [np.clip(p, 0, 255).astype(np.uint8) for p in (y, u, v)]


@pytest.mark.parametrize("w,h", [(64, 48), (48, 32)])
@pytest.mark.parametrize("kind,qp", CASES)
def test_wavefront_encode_decode_match(w, h, kind, qp):
    y, u, v = _frames(w, h, kind, qp + w)
    js, jr = j_wf.encode_iframe_single(jnp.asarray(y), jnp.asarray(u),
                                       jnp.asarray(v), jnp.int32(qp))
    ts, tr = t_wf.encode_iframe_single(*(torch.from_numpy(p)
                                         for p in (y, u, v)), qp)
    for name in js._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(jr, tr):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    dec = t_wf.decode_iframe_single(ts, qp)
    jdec = j_wf.decode_iframe_single(js, jnp.int32(qp))
    for a, b, c in zip(jdec, dec, tr):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(c.numpy(), b.numpy())


def _match_jax(planes, qp):
    """The port's encode and decode of `planes` (numpy [S, H, W] x 3) equal
    JAX's; returns the port's symbols."""
    js, jr = j_wf.encode_iframe_single(*map(jnp.asarray, planes),
                                       jnp.int32(qp))
    ts, tr = t_wf.encode_iframe_single(*map(torch.from_numpy, planes), qp)
    for name in js._fields:
        a, b = np.asarray(getattr(js, name)), getattr(ts, name).numpy()
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(jr, tr):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    jdec = j_wf.decode_iframe_single(js, jnp.int32(qp))
    for a, b in zip(jdec, t_wf.decode_iframe_single(ts, qp)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    return ts


@pytest.mark.parametrize("case", chip_smoke.W_CASES,
                         ids=[f"{s}-{c}-qp{q}" for s, c, q in
                              chip_smoke.W_CASES])
def test_wavefront_seeded_cases_match_jax(case):
    """The seeded cases phase 2 of chip_smoke.py holds K7 and K8 to their
    plain versions with: the port's plain versions equal JAX's."""
    y, u, v, qp = chip_smoke.wave_case(np, *case)
    _match_jax((y, u, v), qp)


def test_the_cases_exercise_every_mode():
    """Over the cases above the port picks every Intra_16x16 luma mode (V,
    H, DC, Plane) and every chroma mode (DC, H, V, Plane) somewhere."""
    modes, cmodes = set(), set()
    frames = [(_frames(w, h, kind, qp + w), qp) for w, h in ((64, 48),
                                                             (48, 32))
              for kind, qp in CASES]
    frames += [(f[:3], f[3]) for f in (chip_smoke.wave_case(np, *case)
                                       for case in chip_smoke.W_CASES)]
    for planes, qp in frames:
        ts, _ = t_wf.encode_iframe_single(*map(torch.from_numpy, planes), qp)
        modes.update(ts.mode.unique().tolist())
        cmodes.update(ts.cmode.unique().tolist())
    assert modes == {0, 1, 2, 3}, modes
    assert cmodes == {0, 1, 2, 3}, cmodes
