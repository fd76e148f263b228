"""The port's session Pipeline (impl "tpu"), its App, and session state
carried over from the JAX package, against tpuh264.engine on the CPU,
exactly.

64x48, one encoded stream fanned out to 3 decoders, QP 30, GOP 3: four
ticks (IDR, P, P, IDR) of `Pipeline.pump_frame` give the JAX pipeline's
decoder outputs and encoder recon; the App builds that pipeline for impl
"tpu" and runs it live.  impl "libav" (libx264 / libavcodec host
sessions) gives the JAX "libav" pipeline's bytes and pictures.  An EncoderSession and a DecoderSession loaded
with a JAX session's state mid-GOP (two references, CBR) emit and
decode the JAX sessions' next frames."""

import time

import numpy as np
import pytest

from tpuh264.engine import CodecConfig as JCfg
from tpuh264.engine import DecoderSession as JDec
from tpuh264.engine import EncoderSession as JEnc
from tpuh264.engine.pipeline import Pipeline as JPipe
from tpuh264_torch.engine import CodecConfig, DecoderSession, EncoderSession
from tpuh264_torch.engine import Pipeline, sources
from tpuh264_torch.engine.app import App
from tpuh264_torch.state import (load_jax_decoder_state,
                                 load_jax_session_state, rc_state_of)

W, H = 64, 48
PIPE_CFG = dict(width=W, height=H, streams=3, qp=30, gop_size=3)


def _tick_outputs(pipe, n):
    """Per tick: the decoders' outputs and the encoder's recon (numpy)."""
    out = []
    for _ in range(n):
        assert pipe.pump_frame()
        recon = [np.asarray(p.cpu() if hasattr(p, "cpu") else p)
                 for p in pipe.encoder.recon]
        out.append(({i: pipe.last_outputs[i] for i in range(3)}, recon))
    return out


def _check_ticks(j, t):
    for fi, ((jo, jr), (to, tr)) in enumerate(zip(j, t)):
        for a, b in zip(jr, tr):
            np.testing.assert_array_equal(a, b, err_msg=f"tick {fi} recon")
        assert sorted(to) == sorted(jo)
        for i in jo:
            for a, b, r in zip(jo[i], to[i], tr):
                assert b.dtype == a.dtype
                np.testing.assert_array_equal(a, b, err_msg=f"tick {fi}")
                np.testing.assert_array_equal(b, r[0][:b.shape[0],
                                                      :b.shape[1]])


def test_pipeline_matches_jax_over_four_ticks():
    jp = JPipe(JCfg(**PIPE_CFG), impl="tpu")
    tp = Pipeline(CodecConfig(**PIPE_CFG), impl="tpu", device="cpu")
    _check_ticks(_tick_outputs(jp, 4), _tick_outputs(tp, 4))
    assert tp.ring.produced == jp.ring.produced == 4
    assert tp.ring.released == jp.ring.released == 12
    js, ts = jp.stats.snapshot(3), tp.stats.snapshot(3)
    for k in ("dropped_capture", "dropped_ring", "dropped_decode"):
        assert ts[k] == js[k] == 0
    assert ts["bitrate_bps"] > 0
    from tpuh264_torch.engine import libav_backend

    if libav_backend.available():
        lp = Pipeline(CodecConfig(**PIPE_CFG), impl="libav", device="cpu")
        assert isinstance(lp.encoder, libav_backend.LibavEncoderSession)
        assert isinstance(lp.decoders, libav_backend.LibavDecoderPool)
    with pytest.raises(ValueError):
        Pipeline(CodecConfig(**PIPE_CFG), impl="gpu", device="cpu")


def test_pipeline_libav_matches_jax():
    """impl "libav": 128x96 x 2 streams, QP 30, four ticks through the
    port's copy of the libx264 / libavcodec backend and through the JAX
    package's; the same bytes a tick, the same decoder pictures, the
    decoders' counters; the App builds and runs it."""
    from tpuh264.engine import libav_backend as j_libav
    from tpuh264_torch.engine import libav_backend

    if not (libav_backend.available() and j_libav.available()):
        pytest.skip("libx264 / libavcodec unavailable")
    cfg = dict(width=128, height=96, streams=2, qp=30)
    pipes = [JPipe(JCfg(**cfg), impl="libav"),
             Pipeline(CodecConfig(**cfg), impl="libav", device="cpu")]
    sent = [[], []]
    for k, pipe in enumerate(pipes):
        real = pipe.ring.try_publish
        pipe.ring.try_publish = (
            lambda data, fanout, real=real, box=sent[k]:
            box.append(data) or real(data, fanout=fanout))
    for tick in range(4):
        for pipe in pipes:
            assert pipe.pump_frame()
        assert sent[1][tick] == sent[0][tick], f"tick {tick}: bytes differ"
        jo, to = (p.last_outputs for p in pipes)
        assert sorted(to) == sorted(jo) == [0, 1]
        for i in jo:
            assert to[i][0].shape == (96, 128)
            for a, b in zip(jo[i], to[i]):
                assert b.dtype == a.dtype
                np.testing.assert_array_equal(a, b)
    for i in range(2):
        assert pipes[1].decoders[i].frames_decoded == 4
        assert pipes[1].decoders[i].frames_concealed == 0
    assert pipes[1].stats.snapshot(2)["bitrate_bps"] > 0
    app = App(CodecConfig(**dict(cfg, fps=60)), impl="libav", device="cpu")
    app.start()
    deadline = time.monotonic() + 30
    while app.pipeline.frame_index < 2 and time.monotonic() < deadline:
        time.sleep(0.05)
    stats = app.get_stats()
    app.stop()
    assert app.error is None and stats["impl"] == "libav"


def test_app_tpu_builds_and_runs_the_session_pipeline():
    """App(impl="tpu") builds the session Pipeline on its device (four
    ticks equal to JAX's), and runs it live: stats, a keyframe request,
    the two-phase stop."""
    app = App(CodecConfig(**dict(PIPE_CFG, fps=60)), impl="tpu",
              device="cpu")
    pipe = app._build()
    assert isinstance(pipe, Pipeline) and pipe.device.type == "cpu"
    jp = JPipe(JCfg(**dict(PIPE_CFG, fps=60)), impl="tpu")
    _check_ticks(_tick_outputs(jp, 4), _tick_outputs(pipe, 4))

    app.start()
    live = app.pipeline
    deadline = time.monotonic() + 60
    while live.frame_index < 3 and time.monotonic() < deadline:
        time.sleep(0.05)
    app.request_keyframe()
    stats = app.get_stats()
    app.stop()
    assert app.error is None and app.pipeline is None
    assert stats["impl"] == "tpu" and stats["streams"] == 3
    assert "psnr_y" not in stats
    assert live.frame_index >= 3 and live.ring.produced >= 3
    outs, recon = live.last_outputs, live.encoder.recon
    for i in range(3):
        for p, r in zip(outs[i], recon):
            np.testing.assert_array_equal(p, r[0].numpy()[:p.shape[0],
                                                          :p.shape[1]])


def _yuv(t):
    y, u, v = zip(*(sources.yuv_frame(W, H, t, "noise", seed=s)
                    for s in range(2)))
    return [np.stack(p).astype(np.uint8) for p in (y, u, v)]


def test_load_jax_session_state_mid_gop():
    """A JAX session pair runs three frames (IDR, P, P: two references in
    the DPB); fresh port sessions loaded with its state then encode and
    decode the next two frames exactly as the JAX pair does."""
    kw = dict(width=W, height=H, streams=2, num_ref_frames=2, gop_size=8,
              bitrate=60_000)
    jenc, jdec = JEnc(JCfg(**kw)), JDec()
    for t in range(3):
        jdec.decode(jenc.encode_frame_yuv(*_yuv(t))[0].data)
    assert len(jenc._dpb) == 2 and len(jdec._dpb) == 2

    tenc = EncoderSession(CodecConfig(**kw), device="cpu")
    load_jax_session_state(
        tenc, [tuple(np.asarray(p) for p in pic) for pic in jenc._dpb],
        jenc.frame_num, jenc._frame_in_gop, jenc.idr_pic_id,
        jenc._force_idr, rc_state_of(jenc.rc))
    tdec = DecoderSession(device="cpu")
    load_jax_decoder_state(
        tdec, [tuple(np.asarray(p) for p in pic) for pic in jdec._dpb],
        vars(jdec._sps), vars(jdec._pps), jdec._nra, jdec._idc,
        jdec._is_ref_frame)
    for t in (3, 4):
        jf, tf = jenc.encode_frame_yuv(*_yuv(t)), tenc.encode_frame_yuv(
            *_yuv(t))
        assert not tf[0].is_idr
        assert [f.data for f in tf] == [f.data for f in jf]
        assert tf[0].qp == jf[0].qp and tf[0].frame_num == jf[0].frame_num
        for a, b in zip(jdec.decode(jf[0].data), tdec.decode(tf[0].data)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError):
        load_jax_decoder_state(
            tdec, [tuple(np.asarray(p) for p in jenc._dpb[0])],
            vars(jdec._sps), vars(jdec._pps), 1, 1, True)
