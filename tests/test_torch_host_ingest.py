"""Host sources and host ingest: the port against the JAX package.

- The port's numpy host sources equal the originals.
- Host ingest (`source_kind="host"`, `pump_host_frames`) of
  `clip_frames("meeting")` at 60x44 (not a multiple of 16: the frames
  are edge-padded to the MB grid), CBR, intra-in-P, with a hard scene
  change mid-GOP that restarts the GOP with an IDR, and a
  `drop_frames` between dispatches: identical bytes, decoder planes, QP
  sequences and GOP positions.

Fan-out decode is held against JAX in test_torch_intra_in_p.py, beside
the pipeline whose compiled JAX encode steps it shares.
"""

import numpy as np
import pytest

from tpuh264.core import nal
from tpuh264.engine import CodecConfig as JaxConfig
from tpuh264.engine import sources as jsrc
from tpuh264.engine.devpipe import GOPDevicePipeline as JaxPipe
from tpuh264.golden import codec as gcodec
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine import sources as tsrc
from tpuh264_torch.engine.devpipe import GOPDevicePipeline

K = GOPDevicePipeline.FRAMES_PER_DISPATCH


@pytest.mark.parametrize("kind", ["moving_gradient", "rigid", "colorbars",
                                  "noise", "checker"])
def test_yuv_and_rgba_frame_copies(kind):
    for t in (0, 5):
        for a, b in zip(jsrc.yuv_frame(40, 24, t, kind, seed=3),
                        tsrc.yuv_frame(40, 24, t, kind, seed=3)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(jsrc.rgba_frame(40, 24, t, kind, 1),
                                      tsrc.rgba_frame(40, 24, t, kind, 1))


@pytest.mark.parametrize("kind", ["meeting", "pan_detail"])
def test_clip_frames_copy(kind):
    a = jsrc.clip_frames(60, 44, 5, kind, seed=2)
    b = tsrc.clip_frames(60, 44, 5, kind, seed=2)
    assert len(a) == len(b) == 5
    for fa, fb in zip(a, b):
        for pa, pb in zip(fa, fb):
            assert pa.dtype == pb.dtype
            np.testing.assert_array_equal(pa, pb)


def test_y4m_round_trip_copy(tmp_path):
    """Each side reads what the other wrote, byte for byte."""
    frames = tsrc.clip_frames(48, 32, 3, "pan_detail")
    tsrc.write_y4m(str(tmp_path / "t.y4m"), frames)
    jsrc.write_y4m(str(tmp_path / "j.y4m"), frames)
    assert (tmp_path / "t.y4m").read_bytes() == (tmp_path / "j.y4m").read_bytes()
    for got in (tsrc.read_y4m(str(tmp_path / "j.y4m")),
                jsrc.read_y4m(str(tmp_path / "t.y4m"), max_frames=3)):
        assert len(got) == 3
        for fa, fb in zip(frames, got):
            for pa, pb in zip(fa, fb):
                np.testing.assert_array_equal(pa, pb)


# -- host ingest ---------------------------------------------------------

W, H, S = 60, 44, 2
HOST_CFG = dict(width=W, height=H, streams=S, qp=None, bitrate=150_000)


def _host_batches():
    """Five dispatches of [K, S, H, W] uint8 frames (chroma half-size):
    per-stream "meeting" clips, inverted from dispatch 2 on (a scene
    change two dispatches into a 16-frame GOP)."""
    clips = [tsrc.clip_frames(W, H, 5 * K, "meeting", seed=si)
             for si in range(S)]
    out = []
    for d in range(5):
        planes = []
        for p in range(3):
            a = np.stack([[clips[si][d * K + f][p] for si in range(S)]
                          for f in range(K)]).astype(np.uint8)
            planes.append(255 - a if d >= 2 else a)
        out.append(planes)
    return out


def _drive_host(pipe):
    qps, gop_pos = [], []
    for d, batch in enumerate(_host_batches()):
        qps.append(pipe.rc.current_qp())
        pipe.pump_host_frames(*batch)
        gop_pos.append(pipe._gop_pos)
        if d == 0:
            pipe.drop_frames(3)
    return qps, gop_pos


@pytest.fixture(scope="module")
def host_runs():
    jax_pipe = JaxPipe(JaxConfig(**HOST_CFG), gop_size=16, source_kind="host")
    port = GOPDevicePipeline(CodecConfig(**HOST_CFG), gop_size=16,
                             source_kind="host", device="cpu")
    return jax_pipe, port, _drive_host(jax_pipe), _drive_host(port)


def test_host_ingest_matches_jax(host_runs):
    jax_pipe, port, (jq, jpos), (pq, ppos) = host_runs
    assert (pq, ppos) == (jq, jpos)
    assert port.w16 == 64 and port.h16 == 48  # padded to the MB grid
    assert len(port.frame_streams) == 5 * K
    for si in range(S):
        assert port.stream_bytes(si) == jax_pipe.stream_bytes(si), si
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port.time_offset == jax_pipe.time_offset == 3
    # host frames: quality is measured by the caller, SSE against zeros
    assert abs(port.last_psnr_y - jax_pipe.last_psnr_y) < 1e-3
    assert port.last_copy_ms > 0 and port.stage_ms["copy"] >= port.last_copy_ms


def test_host_scene_cut_restarts_gop(host_runs):
    """The spike of the inverted frames (dispatch 2, mid-GOP) restarts the
    GOP: dispatch 3 is an IDR access unit, on both sides."""
    jax_pipe, port, _, (_, ppos) = host_runs
    assert ppos[1] == 2 and ppos[2] == 0, ppos
    assert port.rc.scene_cuts == jax_pipe.rc.scene_cuts > 0
    for fr in (0, 3 * K):
        types = [t for _, t, _ in nal.split_annexb(port.frame_streams[fr][0])]
        assert nal.NAL_SPS in types and nal.NAL_SLICE_IDR in types
    dec = port.decoded_planes()
    for d, e in zip(dec, port.encoder_planes()):
        np.testing.assert_array_equal(d, e)
    for si in range(S):
        ours = gcodec.decode_annexb_seq(port.stream_bytes(si))
        assert len(ours) == 5 * K
        for p, (hh, ww) in enumerate(((H, W), (H // 2, W // 2),
                                      (H // 2, W // 2))):
            # the decoder crops the padded MB grid to the coded size
            np.testing.assert_array_equal(ours[-1][p], dec[p][si][:hh, :ww])


def test_host_source_needs_frames():
    port = GOPDevicePipeline(CodecConfig(**HOST_CFG), gop_size=16,
                             source_kind="host", device="cpu")
    with pytest.raises(RuntimeError):
        port.pump_frame()
