"""The I-frame decode scan, the I-only `DevicePipeline` and the live `App`.

- `decode_iframe_scan` equals the JAX one on the same parsed symbols.
- `DevicePipeline` emits the JAX pipeline's bytes, with the same
  fan-out decode SSE, on the device-entropy path and on the overflow
  host pack (QP-0 noise); its streams decode in the golden decoder.
- `App(impl="tpu_gop")` runs its lifecycle on the CPU: start ->
  request_keyframe -> stop, with a capture rate the pump cannot keep,
  so it drops capture frames; the emitted streams decode to the
  pipeline's decoder DPB; stop() is idempotent and joins the pump.
"""

import threading
import time

import numpy as np
import pytest
import torch

from tpuh264.core import nal
from tpuh264.engine import CodecConfig as JaxConfig
from tpuh264.engine.devpipe import DevicePipeline as JaxDevicePipeline
from tpuh264.golden import codec as gcodec
from tpuh264.kernels import iframe as jif
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine.app import App
from tpuh264_torch.engine.devpipe import DevicePipeline, GOPDevicePipeline
from tpuh264_torch.kernels import iframe as tif


@pytest.mark.parametrize("qp", [0, 28, 51])
def test_decode_iframe_scan_matches_jax(qp):
    rng = np.random.default_rng(qp)
    y = rng.integers(0, 256, (2, 48, 64)).astype(np.int32)
    y[:, 16:] = (90 + 3 * np.arange(32))[:, None]  # flat rows: H mode wins
    u = rng.integers(60, 200, (2, 24, 32)).astype(np.int32)
    v = np.broadcast_to(np.arange(24)[:, None] * 5 + 40,
                        (2, 24, 32)).astype(np.int32)
    sym, rec = jif.encode_iframe_rows(y, u, v, qp)
    assert len(np.unique(np.asarray(sym.mode))) == 2
    tsym = tif.MBSymbols(*(None if f is None
                           else torch.from_numpy(np.asarray(f).copy())
                           for f in sym))
    jdec = jif.decode_iframe_scan(sym, qp)
    tdec = tif.decode_iframe_scan(tsym, qp)
    for a, b, r in zip(jdec, tdec, rec):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(np.asarray(r), b.numpy())


CASES = {
    "qp30": (dict(width=64, height=48, qp=30, streams=2), "moving_gradient"),
    "overflow": (dict(width=96, height=64, qp=0, streams=1), "noise"),
}


@pytest.fixture(scope="module", params=sorted(CASES))
def dev_runs(request):
    kw, kind = CASES[request.param]
    jax_pipe = JaxDevicePipeline(JaxConfig(**kw), source_kind=kind)
    port = DevicePipeline(CodecConfig(**kw), source_kind=kind, device="cpu")
    for p in (jax_pipe, port):
        p.pump_frame()
        p.pump_frame()
    return request.param, jax_pipe, port


def test_device_pipeline_matches_jax(dev_runs):
    name, jax_pipe, port = dev_runs
    assert port.frame_index == jax_pipe.frame_index == 8
    assert len(port.frame_streams) == port.FRAMES_PER_DISPATCH
    assert port.frame_streams == jax_pipe.frame_streams
    assert port.last_stream == jax_pipe.last_stream
    assert port.fallback_packs == jax_pipe.fallback_packs
    assert (port.fallback_packs > 0) == (name == "overflow")
    assert abs(port.last_psnr_y - jax_pipe.last_psnr_y) < 1e-3


def test_device_pipeline_streams_decode(dev_runs):
    _, _, port = dev_runs
    for stream in port.frame_streams:
        types = [t for _, t, _ in nal.split_annexb(stream)]
        assert types[:2] == [nal.NAL_SPS, nal.NAL_PPS]
        y, u, v = gcodec.decode_annexb(stream)
        assert y.shape == (port.config.height, port.config.width)
    if port.config.qp:
        assert port.last_psnr_y > 30


def test_device_pipeline_run():
    """The pipelined measurement loop retires every dispatch it issues."""
    port = DevicePipeline(CodecConfig(width=64, height=48, qp=30, streams=3),
                          device="cpu")
    snap = port.run(duration_s=0.3, warmup=1)
    assert snap["frames"] >= port.FRAMES_PER_DISPATCH
    assert snap["frames"] % port.FRAMES_PER_DISPATCH == 0
    assert port.frame_index == snap["frames"] + port.FRAMES_PER_DISPATCH
    assert snap["frames_per_s_aggregate"] > 0 and snap["psnr_y"] > 30


def test_app_lifecycle_drops_and_decodes():
    cfg = CodecConfig(width=64, height=48, streams=2, fps=2000, pool_size=4,
                      gop_size=8)
    app = App(cfg, impl="tpu_gop", device="cpu")
    assert not app.is_processing()
    app.stop()  # a no-op when not running
    app.start()
    pipe = app.pipeline
    assert app.is_processing() and pipe.device == torch.device("cpu")
    deadline = time.monotonic() + 60
    while pipe.dispatch_index < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    app.request_keyframe()
    while pipe.dispatch_index < 4 and time.monotonic() < deadline:
        time.sleep(0.02)
    stats = app.get_stats()
    app.stop()
    assert app.error is None
    assert not app.is_processing() and app.pipeline is None
    assert not any(t.name == "tpuh264-torch-pump" for t in threading.enumerate())
    app.stop()  # idempotent
    assert app.get_stats() == stats
    assert stats["impl"] == "tpu_gop" and stats["streams"] == 2
    assert stats["input_fps"] > 0 and stats["output_fps"] > 0
    assert stats["dropped_capture"] > 0
    assert pipe.time_offset >= stats["dropped_capture"]
    n = len(pipe.frame_streams)
    assert n >= 4 * pipe.FRAMES_PER_DISPATCH
    dec = pipe.decoded_planes()
    for d, e in zip(dec, pipe.encoder_planes()):
        np.testing.assert_array_equal(d, e)
    for si in range(2):
        ours = gcodec.decode_annexb_seq(pipe.stream_bytes(si))
        assert len(ours) == n
        for p in range(3):
            np.testing.assert_array_equal(ours[-1][p], dec[p][si])


def test_app_pump_failure_raises_from_stop(monkeypatch):
    """A failure in the pump thread is kept in `error` and raised by
    stop() after the teardown; it is never silent."""
    def boom(self):
        raise RuntimeError("boom")

    monkeypatch.setattr(GOPDevicePipeline, "pump_frame", boom)
    app = App(CodecConfig(width=64, height=48, streams=1, gop_size=8,
                          qp=30), device="cpu")
    app.start()
    app._thread.join(timeout=60)
    assert not app.is_processing() and isinstance(app.error, RuntimeError)
    with pytest.raises(RuntimeError, match="boom"):
        app.stop()
    assert app.pipeline is None
    app.stop()  # idempotent: the failure was raised once


def test_app_reconfigure_restarts():
    app = App(CodecConfig(width=64, height=48, streams=1, gop_size=8,
                          qp=30), device="cpu")
    app.set_streams(2)  # not running: only the config changes
    assert app.pipeline is None and app.config.streams == 2
    app.start()
    first = app.pipeline
    app.set_resolution("48x32")
    assert app.pipeline is not first and app.is_processing()
    assert (app.pipeline.config.width, app.pipeline.config.height) == (48, 32)
    from tpuh264_torch.engine import libav_backend

    if libav_backend.available():  # restarts on libx264 / libavcodec
        app.set_implementation("libav")
        assert app.is_processing() and app.pipeline.impl == "libav"
        assert isinstance(app.pipeline.encoder,
                          libav_backend.LibavEncoderSession)
    with pytest.raises(ValueError):
        app.set_implementation("vaapi")
    app.stop()
    assert app.error is None and app.pipeline is None
