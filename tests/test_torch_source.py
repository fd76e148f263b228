"""K15 (the device source, `engine/sources.py` `device_source_gop`): its
source on CPU threads against the plain version, the DevicePipeline's
source as the one-stream case, and the router.

On the card K15 must equal the plain version's chain of float32 ATen ops
sample for sample (chip_smoke.py phase 2).  Here the kernel's source runs
on CPU threads, where the host's sinf / cosf are not CUDA's and ATen's
CPU division is a true division (on the card it is a product with the
divisor's float32 reciprocal, which the kernel follows): "noise" is held
exact; "rigid" and "moving_gradient" within one level on at most 0.1% of
samples against the plain version where t is small, and against the
plain chain in the card's form (`_card_chain`: each division a product
with the reciprocal) at every t, the large ones included.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.engine import sources as jsrc
from tpuh264_torch.engine import sources as tsrc
from tpuh264_torch.kernels import cuda_lib

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")


@pytest.fixture(scope="module")
def k15_cpu(tmp_path_factory):
    """csrc/source.cu (all but its launch entry) built with g++ against the
    shims: a block's 256 threads as fibers."""
    return cuda_threads.build_entry(tmp_path_factory.mktemp("k15_cpu"), CSRC,
                                    "source.cu", "source_args",
                                    "source_kernel", "a.blocks", "kThreads")


def _kernel(exe, case, kind):
    w, h, k, s, t = case
    ins, outs, ints = tsrc._k15_operands(w, h, k, s, kind, t, "cpu")
    return cuda_threads.run_entry(exe, ins, outs, ints)


def _card_chain(w, h, k, s, kind, t):
    """The plain version's float chain as ATen runs it on the card: each
    division by a Python scalar a product with its float32 reciprocal."""
    i32, f32 = torch.int32, torch.float32
    inv = lambda c: torch.tensor(np.float32(1) / np.float32(c))
    ti = (t + torch.arange(k, dtype=i32))[:, None, None, None]
    si = torch.arange(s, dtype=i32)[None, :, None, None]
    yy = torch.arange(h, dtype=i32)[None, None, :, None]
    xx = torch.arange(w, dtype=i32)[None, None, None, :]
    sin, cos = torch.sin, torch.cos
    if kind == "rigid":
        xf, yf = (xx - 2.0 * ti).to(f32), (yy - 1.0 * ti).to(f32)
        ph = si.to(f32) * 1.7
        y = (128.0 + 46.0 * sin(xf * inv(17.0) + ph) * cos(yf * inv(23.0))
             + 34.0 * sin((xf + yf) * inv(7.1) + ph)
             + 18.0 * cos(xf * inv(3.3)) * sin(yf * inv(4.7) + ph))
        y = torch.clamp(y, 0, 255).to(torch.uint8)
        x2 = (xx[..., ::2] - 1.0 * ti).to(f32)
        y2 = (yy[:, :, ::2] - 0.5 * ti).to(f32)
        u = 128.0 + 44.0 * sin(x2 * inv(19.0) + ph) * cos(y2 * inv(13.0))
        v = 128.0 + 44.0 * cos(x2 * inv(11.0) - ph) * sin(y2 * inv(29.0))
    else:
        y = ((xx * 2 + yy + ti * 7 + si * 37) % 256).to(torch.uint8)
        u = 128 + 47 * sin((xx[..., ::2] + ti * 3 + si * 11).to(f32)
                           * inv(37.0))
        v = 128 + 47 * cos((yy[:, :, ::2] - ti * 5 + si * 13).to(f32)
                           * inv(29.0))
    sh2 = (k, s, h // 2, w // 2)
    return (y.expand(k, s, h, w), u.to(torch.uint8).expand(sh2),
            v.to(torch.uint8).expand(sh2))


def _within_one_level(got, want, what):
    d = [(a.int() - b.int()).abs() for a, b in zip(got, want)]
    assert max(int(x.max()) for x in d) <= 1, what
    return sum(int((x > 0).sum()) for x in d), sum(x.numel() for x in d)


def test_noise_on_cpu_threads_is_exact(k15_cpu):
    """The int32 hash, in wrapping 32-bit arithmetic, on every edge case:
    one MB, an odd MB count (chroma rows not 16-byte aligned), S = 1,
    k = 1 and 4, two tiles across, t = 0 and large t."""
    for case in chip_smoke.K15_EDGES:
        got = _kernel(k15_cpu, case, "noise")
        want = tsrc._device_source_gop_plain(*case[:4], "noise", case[4],
                                              "cpu")
        for a, b in zip(got, want):
            assert a.dtype == torch.uint8
            np.testing.assert_array_equal(a.numpy(), b.numpy(),
                                          err_msg=str(case))


@pytest.mark.parametrize("kind", ["rigid", "moving_gradient"])
def test_float_kinds_on_cpu_threads_within_one_level(k15_cpu, kind):
    """The float kinds' tables and sample chains: within one level on at
    most 0.1% of samples of the plain version (t small) and of its card
    form (every t, the slow path of sinf / cosf included)."""
    near = [0, 0]
    card = [0, 0]
    for case in chip_smoke.K15_EDGES:
        w, h, k, s, t = case
        got = _kernel(k15_cpu, case, kind)
        n, tot = _within_one_level(got, _card_chain(w, h, k, s, kind, t),
                                   f"{case} card form")
        card = [card[0] + n, card[1] + tot]
        if t < 100_000:
            n, tot = _within_one_level(got, tsrc._device_source_gop_plain(
                w, h, k, s, kind, t, "cpu"), str(case))
            near = [near[0] + n, near[1] + tot]
    assert card[0] <= 1e-3 * card[1] and near[0] <= 1e-3 * near[1], (card,
                                                                      near)


def test_card_chain_is_the_plain_chain_for_small_t():
    """The card form differs from the plain version only by the rounding of
    its divisions: within one level on at most 0.1% of samples at small
    t (each row of the float kinds, 1080p-wide)."""
    for kind in ("rigid", "moving_gradient"):
        n, tot = _within_one_level(
            _card_chain(1920, 32, 2, 2, kind, 37),
            tsrc._device_source_gop_plain(1920, 32, 2, 2, kind, 37, "cpu"),
            kind)
        assert n <= 1e-3 * tot


@pytest.mark.parametrize("kind", ["noise", "moving_gradient", "rigid"])
def test_frames_source_is_the_one_stream_gop(kind):
    """The DevicePipeline's source (`device_source_frames`) is
    `device_source_gop` with one stream ("noise", else the moving
    gradient): so it is in the JAX package, exactly (its
    `_device_source_frames` against its `_device_source_gop` at S = 1);
    the port's equals the JAX one, "noise" exactly, the gradient within
    one level on at most 0.1% of samples."""
    w, h, k, t = 64, 48, 4, 9
    gk = "noise" if kind == "noise" else "moving_gradient"
    jf = [np.asarray(p) for p in jsrc._device_source_frames(w, h, k, kind)(
        np.int32(t))]
    jg = [np.asarray(p) for p in jsrc._device_source_gop(w, h, k, 1, gk)(
        np.int32(t))]
    for a, b in zip(jf, jg):
        np.testing.assert_array_equal(a, b[:, 0])
    tf = tsrc.device_source_frames(w, h, k, kind, t, "cpu")
    tg = tsrc.device_source_gop(w, h, k, 1, gk, t, "cpu")
    for a, b, j in zip(tf, tg, jf):
        assert a.shape == j.shape and a.is_contiguous()
        assert torch.equal(a, b[:, 0])
    n, tot = _within_one_level(tf, [torch.tensor(j) for j in jf], kind)
    assert n == 0 if kind == "noise" else n <= 1e-3 * tot


def test_router_cpu_and_other_devices(monkeypatch):
    """CPU tensors take the plain version without loading the library; a
    meta device raises; an unknown kind raises."""
    monkeypatch.setattr(cuda_lib, "load", lambda: pytest.fail("loaded"))
    n = tsrc.device_source_gop.launches
    got = tsrc.device_source_gop(32, 16, 2, 2, "noise", 3, "cpu")
    want = tsrc._device_source_gop_plain(32, 16, 2, 2, "noise", 3, "cpu")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    with pytest.raises(ValueError):
        tsrc.device_source_gop(32, 16, 2, 2, "noise", 3, "meta")
    with pytest.raises(ValueError):
        tsrc.device_source_gop(32, 16, 2, 2, "checker", 3, "cpu")
    assert tsrc.device_source_gop.launches == n
