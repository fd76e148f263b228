"""The port's GOP pipeline as a whole against the JAX GOPDevicePipeline.

64x48 x 2 streams, gop 8, three dispatches (IDR+3P | 4P | IDR+3P), the
integer-exact "noise" source, RTC preset, at fixed QP 28 and in CBR:
identical annex-B bytes per stream, identical decode-from-bits planes,
identical QP sequences.  The port's streams also decode in the golden
decoder (and libavcodec where present) to its own decoder DPB.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from pipeline_checks import assert_rings_and_sse_match_jax
from tpuh264.engine import CodecConfig as JaxConfig
from tpuh264.engine.devpipe import GOPDevicePipeline as JaxPipe
from tpuh264.golden import codec as gcodec
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine.devpipe import GOPDevicePipeline
from tpuh264_torch.state import load_jax_state, rc_state_of

try:
    from tpuh264.conformance.ffdec import decode_with_libav
except Exception:  # pragma: no cover
    decode_with_libav = None

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CFG = dict(width=64, height=48, streams=2, intra_in_p=False)
MODES = {"qp28": dict(qp=28), "cbr": dict(qp=None, bitrate=200_000)}


def _drive(pipe, n):
    qps = []
    for _ in range(n):
        qps.append(pipe.config.qp if pipe.config.qp is not None
                   else pipe.rc.current_qp())
        pipe.pump_frame()
    return qps


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request):
    kw = dict(CFG, **MODES[request.param])
    jax_pipe = JaxPipe(JaxConfig(**kw), gop_size=8, source_kind="noise")
    port = GOPDevicePipeline(CodecConfig(**kw), gop_size=8,
                             source_kind="noise", device="cpu")
    jq, pq = _drive(jax_pipe, 3), _drive(port, 3)
    return request.param, jax_pipe, port, jq, pq


def test_bytes_planes_and_qp_match_jax(runs):
    mode, jax_pipe, port, jq, pq = runs
    assert pq == jq
    if mode == "cbr":
        assert len(set(pq)) > 1, "rate control never moved the QP"
    assert len(port.frame_streams) == 12
    for si in range(2):
        assert port.stream_bytes(si) == jax_pipe.stream_bytes(si), si
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port.fallback_packs == jax_pipe.fallback_packs == 0
    assert abs(port.last_psnr_y - jax_pipe.last_psnr_y) < 1e-3


def test_rings_and_sse_match_jax(runs):
    """K4 deblocks each frame straight into its DPB ring slot (an IDR into
    slot 0) and K14 takes each decoded frame's SSE right after: both rings
    and the last dispatch's per-frame SSE equal the JAX pipeline's."""
    _, jax_pipe, port, _, _ = runs
    assert_rings_and_sse_match_jax(jax_pipe, port)


def test_port_streams_decode_to_its_decoder_dpb(runs):
    _, _, port, _, _ = runs
    dec = port.decoded_planes()
    enc = port.encoder_planes()
    for d, e in zip(dec, enc):
        np.testing.assert_array_equal(d, e)
    for si in range(2):
        stream = port.stream_bytes(si)
        ours = gcodec.decode_annexb_seq(stream)
        assert len(ours) == 12
        for p in range(3):
            np.testing.assert_array_equal(ours[-1][p], dec[p][si])
        if decode_with_libav is not None:
            av = decode_with_libav(stream)
            assert len(av) == 12
            for fi, (a, o) in enumerate(zip(av, ours)):
                for p in range(3):
                    np.testing.assert_array_equal(
                        np.asarray(a[p]), np.asarray(o[p]),
                        err_msg=f"s{si} f{fi} p{p}")


def test_load_jax_state_mid_gop(runs):
    """Start a fresh port pipeline from the JAX pipeline's state after
    three dispatches (GOP position 3: an interior dispatch) and continue
    both: the next dispatch's bytes and planes are identical."""
    _, jax_pipe, _, _, _ = runs
    port = GOPDevicePipeline(
        CodecConfig(**dict(CFG, **MODES[runs[0]])), gop_size=8,
        source_kind="noise", device="cpu")
    load_jax_state(
        port,
        [np.asarray(p) for p in jax_pipe._dpb_enc],
        [np.asarray(p) for p in jax_pipe._dpb_dec],
        jax_pipe._gop_pos, jax_pipe.dispatch_index, rc_state_of(jax_pipe.rc))
    assert port._gop_pos % port.gop_dispatches != 0
    jq, pq = _drive(jax_pipe, 1), _drive(port, 1)
    assert pq == jq
    assert port.frame_streams == jax_pipe.frame_streams[-4:]
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)


def test_overflow_host_pack_path():
    """QP-0 noise overflows the device entropy bit caps: IDR and P frames
    are repacked on the host and the streams still decode exactly."""
    port = GOPDevicePipeline(
        CodecConfig(width=96, height=64, qp=0, streams=2, intra_in_p=False),
        gop_size=8, source_kind="noise", device="cpu")
    port.pump_frame()
    port.pump_frame()  # a P-only dispatch too
    assert port.fallback_packs == 2, "overflow path was not exercised"
    dec = port.decoded_planes()
    for si in range(2):
        stream = port.stream_bytes(si)
        ours = gcodec.decode_annexb_seq(stream)
        assert len(ours) == 8
        for p in range(3):
            np.testing.assert_array_equal(ours[-1][p], dec[p][si])
        if decode_with_libav is not None:
            av = decode_with_libav(stream)
            for fi, (a, o) in enumerate(zip(av, ours)):
                for p in range(3):
                    np.testing.assert_array_equal(np.asarray(a[p]), o[p])


def test_port_imports_no_jax():
    code = (
        "import sys, pkgutil, importlib, tpuh264_torch\n"
        "for m in pkgutil.walk_packages(tpuh264_torch.__path__, "
        "'tpuh264_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import tpuh264_torch.engine.devpipe, tpuh264_torch.engine.app\n"
        "import tpuh264_torch.engine.sources\n"
        "assert 'jax' not in sys.modules, sorted(m for m in sys.modules "
        "if m.startswith('jax'))\n"
        "bad = sorted(m for m in sys.modules "
        "if m == 'tpuh264' or m.startswith('tpuh264.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_unported_options_raise():
    """Nothing of the P encode and decode is refused any more: the DPB
    halo runs (tests/test_torch_halo.py holds it to JAX), and on a
    reference edge-extended by HALO_Y / HALO_C rows -- what the frame's
    only band receives -- it equals the unsharded encode and decode, as
    does the 8x8 transform (tests/test_torch_t8.py).  The "libav"
    implementation of the App and of the session Pipeline is ported: both
    build it."""
    import torch

    from tpuh264_torch.engine import Pipeline
    from tpuh264_torch.engine.app import App
    from tpuh264_torch.kernels import pframe

    rng = np.random.default_rng(5)
    y = torch.from_numpy(rng.integers(0, 256, (1, 16, 32), np.uint8))
    c = torch.from_numpy(rng.integers(0, 256, (1, 8, 16), np.uint8))
    refs = tuple(torch.from_numpy(rng.integers(0, 256, p.shape, np.int32)
                                  )[None] for p in (y, c, c))
    ext = tuple(pframe._edge_pad(r[0], halo, 0)[None] for r, halo in zip(
        refs, (pframe.HALO_Y, pframe.HALO_C, pframe.HALO_C)))
    sym, rec, mv = pframe.encode_pframe_rows_multi(y, c, c, *refs, 28)
    hsym, hrec, hmv = pframe.encode_pframe_rows_multi(y, c, c, *ext, 28,
                                                      halo=True)
    for a, b in zip((*sym, *rec, *mv), (*hsym, *hrec, *hmv)):
        assert torch.equal(a, b)
    dec, _ = pframe.decode_pframe_rows_multi(hsym, *ext, 28, halo=True)
    assert all(torch.equal(a, b) for a, b in zip(dec, rec))
    sym, rec, _ = pframe.encode_pframe_rows_multi(y, c, c, *refs, 28,
                                                  t8=True)
    dec, _ = pframe.decode_pframe_rows_multi(sym, *refs, 28, t8=True)
    assert all(torch.equal(a, b) for a, b in zip(dec, rec))
    from tpuh264_torch.engine import libav_backend

    cfg = CodecConfig(**dict(CFG, qp=28))
    app = App(cfg, impl="libav", device="cpu")
    assert app.impl == "libav" and app.pipeline is None
    if libav_backend.available():
        for pipe in (app._build(), Pipeline(cfg, impl="libav", device="cpu")):
            assert pipe.impl == "libav"
            assert isinstance(pipe.decoders, libav_backend.LibavDecoderPool)
