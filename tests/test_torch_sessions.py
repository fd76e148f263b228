"""The port's session path (tpuh264_torch.engine EncoderSession,
DecoderSession / DecoderPool, kernels.color) against tpuh264.engine on the
CPU, exactly.

64x48 x 2 streams (stream 0 a camera-like clip with moving stripes,
stream 1 noise), 6 frames across an IDR, from I420 (`encode_frame_yuv`),
for the default config (CBR, intra-in-P), fixed QP with deblock and
Intra_4x4, two references, temporal layers 2 and 3, and single-slice I
frames: identical annex-B bytes per frame and stream, identical encoder
recon, QPs and frame numbers (the same configs from RGBA:
tests/test_torch_sessions_rgba.py).  The decoders (`decode` per session
and `decode_batch`) return the JAX pool's planes, dtypes and flags, and
the encoder's recon.  Garbage conceals as in JAX; the 8x8 transform
without CABAC raises NotImplementedError in the encoder, and x264's
CABAC and CAVLC 8x8 streams, and streams with ref_pic_list_modification,
decode through the golden decoder to libavcodec's pictures (the engine's
own CABAC sessions: tests/test_torch_sessions_cabac*.py)."""

import numpy as np
import pytest
import torch

from tpuh264.engine import CodecConfig as JCfg
from tpuh264.engine import DecoderPool as JPool
from tpuh264.engine import EncoderSession as JEnc
from tpuh264.kernels import color as j_color
from tpuh264_torch.engine import CodecConfig, DecoderPool, EncoderSession
from tpuh264_torch.engine import sources
from tpuh264_torch.kernels import color as t_color

W, H, S, N_FRAMES = 64, 48, 2, 6
CONFIGS = {
    "default CBR intra-in-P": dict(gop_size=4, bitrate=40_000),
    "QP 28 deblock intra44": dict(qp=28, deblock=True, intra44=True,
                                  gop_size=4),
    "2 refs": dict(qp=30, num_ref_frames=2, gop_size=4),
    "temporal 2": dict(qp=30, temporal_layers=2, gop_size=4),
    "temporal 3 deblock": dict(qp=30, temporal_layers=3, gop_size=5,
                               deblock=True),
    "single slice": dict(qp=26, slice_mode="single", gop_size=1),
}
_CLIP = sources.clip_frames(W, H, N_FRAMES, "meeting")


def yuv_frames(t):
    """Stream 0: the "meeting" clip with moving diagonal stripes on its
    left half (Intra_4x4 wins there); stream 1: noise (intra MBs in P)."""
    y0 = _CLIP[t][0].copy()
    yy, xx = np.mgrid[0:H, 0:W // 2]
    y0[:, :W // 2] = np.where(((2 * xx + yy + t) // 5) % 2, 60, 180)
    noise = sources.yuv_frame(W, H, t, "noise", seed=1)
    return [np.stack([a, b]).astype(np.uint8)
            for a, b in zip((y0, *_CLIP[t][1:]), noise)]


def rgba_frames(t):
    return np.stack([sources.rgba_frame(W, H, t, "moving_gradient", seed=s)
                     for s in range(S)])


def run_session(enc, kind, pools=()):
    """Encode N_FRAMES from `kind` ("yuv" or "rgba") input; decode each
    frame in every pool, per session in a pool named "decode" and batched
    in one named "batch".  Returns per frame (bytes per stream, is_idr,
    qp, frame_num, recon planes as numpy, {pool name: outputs per
    stream}, {pool name: (needs_keyframe, frames_decoded,
    frames_concealed) per stream})."""
    out = []
    for t in range(N_FRAMES):
        fr = (enc.encode_frame(rgba_frames(t)) if kind == "rgba"
              else enc.encode_frame_yuv(*yuv_frames(t)))
        data = [f.data for f in fr]
        dec, flags = {}, {}
        for name, pool in pools:
            if name == "decode":
                dec[name] = [pool.decode(i, d) for i, d in enumerate(data)]
            else:
                res = pool.decode_batch(list(enumerate(data)))
                dec[name] = [res[i] for i in range(S)]
            flags[name] = [(pool[i].needs_keyframe, pool[i].frames_decoded,
                            pool[i].frames_concealed) for i in range(S)]
        recon = [np.asarray(p.cpu() if isinstance(p, torch.Tensor) else p)
                 for p in enc.recon]
        out.append((data, fr[0].is_idr, fr[0].qp, fr[0].frame_num, recon,
                    dec, flags))
    return out


def make_pool(cls, **kw):
    pool = cls(**kw)
    for i in range(S):
        pool.init_decoder(i)
    return pool


_CACHE = {}


def _runs(name):
    """JAX: the session and a batched pool; the port: the session, a
    per-session pool and a batched pool (the JAX pool's per-session
    decode is held in test_decode_to_rgba_matches and the concealment
    test; both of its routes return the same planes)."""
    if name not in _CACHE:
        kw = dict(width=W, height=H, streams=S, **CONFIGS[name])
        j = run_session(JEnc(JCfg(**kw)), "yuv",
                        [("batch", make_pool(JPool))])
        t = run_session(EncoderSession(CodecConfig(**kw), device="cpu"),
                        "yuv", [(n, make_pool(DecoderPool, device="cpu"))
                                for n in ("decode", "batch")])
        _CACHE[name] = (j, t)
    return _CACHE[name]


def check_encoder_runs(j, t, cbr: bool):
    assert [f[1] for f in t] == [f[1] for f in j]
    assert any(f[1] for f in t[1:]), "no IDR after the first frame"
    for fi, (a, b) in enumerate(zip(j, t)):
        assert b[0] == a[0], f"frame {fi}: bytes differ"
        assert b[2:4] == a[2:4], f"frame {fi}: qp / frame_num differ"
        for p, q in zip(a[4], b[4]):
            assert q.dtype == p.dtype
            np.testing.assert_array_equal(p, q)
    if cbr:
        assert len({f[2] for f in t}) > 1, "rate control never moved the QP"


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encoder_bytes_match(name):
    j, t = _runs(name)
    check_encoder_runs(j, t, CONFIGS[name].get("qp") is None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_decoders_match_jax_and_the_recon(name):
    j, t = _runs(name)
    for fi, (a, b) in enumerate(zip(j, t)):
        for route in ("decode", "batch"):
            assert b[6][route] == a[6]["batch"], f"frame {fi}: flags differ"
            for si, (pj, pt) in enumerate(zip(a[5]["batch"], b[5][route])):
                assert pt is not None and len(pt) == 3
                for p, q in zip(pj, pt):
                    assert isinstance(q, np.ndarray) and q.dtype == p.dtype
                    assert q.shape == p.shape
                    np.testing.assert_array_equal(p, q)
                for q, r in zip(pt, b[4]):
                    np.testing.assert_array_equal(
                        q, r[si][:q.shape[0], :q.shape[1]])


def test_intra_in_p_and_i4x4_were_exercised(monkeypatch):
    """The default config's P frames code intra MBs (stream 1 is noise),
    and the intra44 config's IDR frames code Intra_4x4 MBs."""
    from tpuh264_torch.entropy import native
    from tpuh264_torch.kernels import pframe

    _, t = _runs("QP 28 deblock intra44")
    assert (native.parse_iframe(t[0][0][0])[3][:, 0] == 4).any()
    seen = []
    real = pframe.encode_pframe_rows_multi

    def spy(*a, **kw):
        out = real(*a, **kw)
        seen.append(int((out[0].kind == 2).sum()))
        return out

    monkeypatch.setattr(pframe, "encode_pframe_rows_multi", spy)
    sess = EncoderSession(CodecConfig(width=W, height=H, streams=S,
                                      **CONFIGS["default CBR intra-in-P"]),
                          device="cpu")
    for fi in range(3):
        sess.encode_frame_yuv(*yuv_frames(fi))
    assert len(seen) == 2 and sum(seen) > 0, seen


def test_color_both_ways_matches():
    rng = np.random.default_rng(0)
    rgba = rng.integers(0, 256, (2, 32, 48, 4)).astype(np.uint8)
    rgba[0, 0, :4] = [[0, 0, 0, 0], [255, 255, 255, 255], [255, 0, 0, 9],
                      [0, 0, 255, 1]]
    jy = j_color.rgba_to_yuv420(rgba)
    ty = t_color.rgba_to_yuv420(torch.from_numpy(rgba))
    for a, b in zip(jy, ty):
        assert b.dtype == torch.int32
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(j_color.rgba_to_yuv420_ref(rgba), ty):
        np.testing.assert_array_equal(a, b.numpy())
    yuv = [rng.integers(0, 256, s).astype(np.uint8)
           for s in ((2, 32, 48), (2, 16, 24), (2, 16, 24))]
    back = t_color.yuv420_to_rgba(*(torch.from_numpy(p) for p in yuv))
    assert back.dtype == torch.uint8
    np.testing.assert_array_equal(np.asarray(j_color.yuv420_to_rgba(*yuv)),
                                  back.numpy())


def test_decode_to_rgba_matches():
    kw = dict(width=W, height=H, qp=30)
    frame = [p[0] for p in yuv_frames(0)]
    data = EncoderSession(CodecConfig(**kw), device="cpu").encode_frame_yuv(
        *frame)[0].data
    assert data == JEnc(JCfg(**kw)).encode_frame_yuv(*frame)[0].data
    from tpuh264.engine.decoder import DecoderSession as JDec
    from tpuh264_torch.engine import DecoderSession

    a = JDec().decode_to_rgba(data)
    b = DecoderSession(device="cpu").decode_to_rgba(data)
    assert b.dtype == a.dtype and b.shape == (H, W, 4)
    np.testing.assert_array_equal(a, b)


def test_concealment_matches_jax():
    """Garbage conceals (None before any frame, then the last good frame),
    needs_keyframe set, exactly as the JAX pool does."""
    junk = [b"\x00\x00\x01\x65garbage", b"\x00\x00\x01\x41" + bytes(40),
            b""]
    good = EncoderSession(CodecConfig(width=W, height=H, qp=30),
                          device="cpu").encode_frame_yuv(
        *[p[0] for p in yuv_frames(1)])[0].data
    pools = [JPool(max_decoders=32), DecoderPool(max_decoders=32,
                                                 device="cpu")]
    res = []
    for pool in pools:
        with pytest.raises(IndexError):
            pool.init_decoder(32)
        pool.init_decoder(3)
        r = [pool.decode(3, junk[0]), pool[3].needs_keyframe]
        out = pool.decode(3, good)
        r += [pool[3].needs_keyframe]
        for d in junk:
            r += [pool.decode(3, d) is out, pool[3].needs_keyframe]
        r += [pool[3].frames_decoded, pool[3].frames_concealed]
        batch = pool.decode_batch([(3, junk[1])])
        r += [batch[3] is out, pool[3].needs_keyframe]
        res.append(r)
    assert res[0][0] is None and res[1][0] is None
    assert res[0][1:] == res[1][1:]
    assert res[1][1] and not res[1][2] and res[1][-1]


def test_unported_syntax_raises():
    """The encoder refuses what the JAX session refuses (the 8x8 transform
    without CABAC among them) and nothing more: CABAC, with and without
    the 8x8 transform, builds.  Syntax the fast path does not take goes
    to the golden decoder."""
    from tpuh264_torch.engine import DecoderSession

    for kw in (dict(cabac=True), dict(cabac=True, transform8x8=True)):
        enc = EncoderSession(CodecConfig(width=W, height=H, **kw),
                             device="cpu")
        assert enc.pps.entropy_coding_mode_flag == 1
        assert enc.pps.transform_8x8_mode_flag == kw.get("transform8x8", 0)
    for kw in (dict(transform8x8=True),
               dict(slice_mode="single", deblock=True, gop_size=1),
               dict(slice_mode="single", gop_size=4),
               dict(slice_mode="single", intra44=True, gop_size=1)):
        with pytest.raises(NotImplementedError):
            EncoderSession(CodecConfig(width=W, height=H, **kw),
                           device="cpu")
    # the decoder side takes what the encoder never emits: a P slice with
    # ref_pic_list_modification (which the JAX fast path decodes in the
    # default order), x264's single-slice CABAC with mb_qp_delta and its
    # CAVLC 8x8 transform decode to libavcodec's pictures (or the golden
    # decoder's, where libavcodec is missing) through the golden path
    from test_torch_general_decode import (list_mod_aus, split_aus,
                                           x264_stream)
    from tpuh264_torch.conformance import ffdec, ffenc
    from tpuh264_torch.engine import DecoderSession
    from tpuh264_torch.golden import codec as gcodec

    oracle = (ffdec.decode_with_libav if ffdec.libav_available()
              else gcodec.decode_annexb_seq)
    enc = EncoderSession(CodecConfig(width=W, height=H, qp=30,
                                     num_ref_frames=2), device="cpu")
    aus = [enc.encode_frame_yuv(*[p[0] for p in yuv_frames(t)])[0].data
           for t in range(4)]
    aus[2] = list_mod_aus(aus[2], enc.sps, enc.pps)
    streams = {"list modification": aus}
    if ffenc.encoder_available():
        for name in ("main CABAC", "high CAVLC Intra_8x8"):
            streams[name] = split_aus(x264_stream(name))
    for name, units in streams.items():
        ref = oracle(b"".join(units))
        dec = DecoderSession(device="cpu")
        pool = DecoderPool(device="cpu")
        pool.init_decoder(0)
        for t, data in enumerate(units):
            for out in (dec.decode(data), pool.decode_batch([(0, data)])[0]):
                assert out is not None and out[0].dtype == np.uint8
                for a, b in zip(out, ref[t]):
                    np.testing.assert_array_equal(a, b, err_msg=name)
        assert dec._general and pool[0]._general, name
        assert dec.frames_concealed == pool[0].frames_concealed == 0


def test_sessions_default_to_the_card(monkeypatch):
    """Without `device` the session entry points take the card; where there
    is none they raise instead of running on the CPU."""
    import inspect

    from tpuh264_torch.engine import DecoderSession, Pipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodecConfig(width=W, height=H, qp=28)
    makers = {EncoderSession: lambda: EncoderSession(cfg),
              DecoderSession: lambda: DecoderSession(),
              DecoderPool: lambda: DecoderPool(4),
              Pipeline: lambda: Pipeline(cfg)}
    for cls, make in makers.items():
        assert inspect.signature(cls).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="is_available"):
            make()
