"""The port's CABAC sessions against tpuh264.engine on the CPU, exactly.

64x48 x 2 streams (stream 0 the "meeting" clip with moving stripes,
stream 1 noise), 6 frames of `encode_frame_yuv`, at the JAX package's
own CABAC anchors (tests/test_cabac.py: intra44 at gop 1, IPPP, deblock
with 2 temporal layers; tests/test_multiref.py: 2 references, 3
temporal layers with deblock; tests/test_wavefront.py: one slice at gop
1): identical annex-B bytes, recon, QPs and frame numbers.  The port's
DecoderSession and DecoderPool.decode_batch decode every frame on the
fast path (never `_general`, nothing concealed) to the recon, and so
does libavcodec where it loads.  The 8x8-transform configurations are in
tests/test_torch_sessions_cabac_t8.py.  Also: the session Pipeline
(impl "tpu") on a CABAC config, a JAX CABAC + 8x8 session's state
carried mid-GOP into the port, and one decode_batch call that mixes a
CAVLC stream with a CABAC one."""

import numpy as np
import pytest

from test_torch_sessions import make_pool, rgba_frames, yuv_frames
from tpuh264.engine import CodecConfig as JCfg
from tpuh264.engine import DecoderSession as JDec
from tpuh264.engine import EncoderSession as JEnc
from tpuh264.engine.pipeline import Pipeline as JPipe
from tpuh264_torch.conformance import ffdec
from tpuh264_torch.engine import (CodecConfig, DecoderPool, DecoderSession,
                                  EncoderSession, Pipeline)
from tpuh264_torch.entropy import cabac_pack
from tpuh264_torch.state import (load_jax_decoder_state,
                                 load_jax_session_state, rc_state_of)

W, H, S, N_FRAMES = 64, 48, 2, 6
CONFIGS = {
    "intra44 gop 1": dict(qp=30, intra44=True, gop_size=1),
    "IPPP": dict(qp=28, gop_size=5),
    "deblock temporal 2": dict(qp=30, deblock=True, temporal_layers=2,
                               gop_size=4),
    "2 refs CBR": dict(bitrate=40_000, num_ref_frames=2, gop_size=4),
    "temporal 3 deblock": dict(qp=30, temporal_layers=3, deblock=True,
                               gop_size=5),
    "single slice gop 1": dict(qp=26, slice_mode="single", gop_size=1),
}


def cabac_run(cfg: dict, kind: str = "yuv"):
    """Encode N_FRAMES in the JAX session and the port's (cabac=True plus
    `cfg`); decode the port's access units per session and batched.
    Returns (per frame: (JAX bytes, port bytes, JAX (idr, qp, frame_num),
    port's, JAX recon, port recon, {route: per-stream planes}), the port's
    P symbols per frame, the pools)."""
    kw = dict(width=W, height=H, streams=S, cabac=True, **cfg)
    jenc = JEnc(JCfg(**kw))
    tenc = EncoderSession(CodecConfig(**kw), device="cpu")
    syms = []
    real = tenc._encode_p

    def spy(*a):
        out = real(*a)
        syms.append(out[0])
        return out

    tenc._encode_p = spy
    pools = {r: make_pool(DecoderPool, device="cpu")
             for r in ("decode", "batch")}
    frames = []
    for t in range(N_FRAMES):
        src = rgba_frames(t) if kind == "rgba" else yuv_frames(t)
        enc = (lambda e: e.encode_frame(src)) if kind == "rgba" else (
            lambda e: e.encode_frame_yuv(*src))
        jf, tf = enc(jenc), enc(tenc)
        data = [f.data for f in tf]
        dec = {"decode": [pools["decode"].decode(i, d)
                          for i, d in enumerate(data)]}
        res = pools["batch"].decode_batch(list(enumerate(data)))
        dec["batch"] = [res[i] for i in range(S)]
        meta = lambda fr: (fr[0].is_idr, fr[0].qp, fr[0].frame_num)
        frames.append(([f.data for f in jf], data, meta(jf), meta(tf),
                       [np.asarray(p) for p in jenc.recon],
                       [p.numpy() for p in tenc.recon], dec))
    return frames, syms, pools


_CACHE = {}


def cached(configs, name, kind="yuv"):
    if name not in _CACHE:
        _CACHE[name] = cabac_run(configs[name], kind)
    return _CACHE[name]


def check_bytes(frames, cbr: bool):
    for fi, (jb, tb, jm, tm, jr, tr, _) in enumerate(frames):
        assert tb == jb, f"frame {fi}: bytes differ"
        assert tm == jm, f"frame {fi}: idr / qp / frame_num differ"
        for a, b in zip(jr, tr):
            assert b.dtype == a.dtype
            np.testing.assert_array_equal(a, b, err_msg=f"frame {fi}")
    assert frames[0][3][0] and any(f[3][0] for f in frames[1:]), \
        "no IDR after the first frame"
    if cbr:
        assert len({f[3][1] for f in frames}) > 1, "the QP never moved"


def check_decoders(frames, pools):
    """Both pools decode every frame on the fast path to the recon, and
    libavcodec decodes each stream to the recon."""
    for fi, (_, _, _, _, _, tr, dec) in enumerate(frames):
        for route, outs in dec.items():
            for si, out in enumerate(outs):
                assert out is not None, (route, fi, si)
                for q, r in zip(out, tr):
                    assert q.dtype == np.uint8
                    np.testing.assert_array_equal(
                        q, r[si][:q.shape[0], :q.shape[1]],
                        err_msg=f"{route} frame {fi} stream {si}")
    for pool in pools.values():
        for i in range(S):
            assert not pool[i]._general, "left the fast path"
            assert pool[i].frames_concealed == 0
            assert pool[i].frames_decoded == len(frames)
    if not ffdec.libav_available():
        return
    for si in range(S):
        lv = ffdec.decode_with_libav(b"".join(f[1][si] for f in frames))
        assert len(lv) == len(frames)
        for fi, (got, f) in enumerate(zip(lv, frames)):
            for q, r in zip(got, f[5]):
                np.testing.assert_array_equal(
                    q, r[si][:q.shape[0], :q.shape[1]],
                    err_msg=f"libavcodec frame {fi} stream {si}")


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cabac_encoder_bytes_match(name):
    frames, _, _ = cached(CONFIGS, name)
    check_bytes(frames, CONFIGS[name].get("qp") is None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cabac_decoders_match_the_recon(name):
    frames, _, pools = cached(CONFIGS, name)
    check_decoders(frames, pools)


def test_cabac_sessions_code_what_they_claim():
    """Intra_4x4 MBs in the intra44 stream's IDRs, intra MBs in P frames
    (the noise stream), reference 1 chosen with two references."""
    frames, _, _ = cached(CONFIGS, "intra44 gop 1")
    i4 = sum(int((cabac_pack.parse_iframe(f[1][0])[3][:, 0] == 4).sum())
             for f in frames)
    assert i4 > 0
    _, syms, _ = cached(CONFIGS, "2 refs CBR")
    assert any(bool((s.kind == 2).any()) for s in syms)
    assert any(bool(((s.kind == 1) & (s.refidx == 1)).any()) for s in syms)


def test_cabac_pipeline_matches_jax():
    """The session Pipeline (impl "tpu": one encoder, 3 decoders) on a
    CABAC config: four ticks, the JAX pipeline's outputs and recon."""
    cfg = dict(width=W, height=H, streams=3, qp=30, gop_size=3, cabac=True,
               deblock=True)
    jp = JPipe(JCfg(**cfg), impl="tpu")
    tp = Pipeline(CodecConfig(**cfg), impl="tpu", device="cpu")
    for fi in range(4):
        assert jp.pump_frame() and tp.pump_frame()
        recon = [p.numpy() for p in tp.encoder.recon]
        for a, b in zip(jp.encoder.recon, recon):
            np.testing.assert_array_equal(np.asarray(a), b)
        assert sorted(tp.last_outputs) == sorted(jp.last_outputs) == [0, 1,
                                                                       2]
        for i in range(3):
            for a, b, r in zip(jp.last_outputs[i], tp.last_outputs[i],
                               recon):
                np.testing.assert_array_equal(a, b, err_msg=f"tick {fi}")
                np.testing.assert_array_equal(b, r[0][:b.shape[0],
                                                      :b.shape[1]])
    assert not any(d._general for d in tp.decoders._slots.values())


def test_load_jax_cabac_t8_session_state_mid_gop():
    """A JAX CABAC + 8x8 session pair (two references, CBR) runs three
    frames; fresh port sessions loaded with its state through state.py --
    no field beyond those of a CAVLC session: the PPS carries the CABAC
    and 8x8 flags -- encode and decode the next two frames exactly as the
    JAX pair does."""
    kw = dict(width=W, height=H, streams=2, num_ref_frames=2, gop_size=8,
              bitrate=60_000, cabac=True, transform8x8=True, deblock=True)
    jenc, jdec = JEnc(JCfg(**kw)), JDec()
    for t in range(3):
        jdec.decode(jenc.encode_frame_yuv(*yuv_frames(t))[0].data)
    assert len(jenc._dpb) == 2 and len(jdec._dpb) == 2
    assert jdec._pps.entropy_coding_mode_flag == 1
    assert jdec._pps.transform_8x8_mode_flag == 1
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
    t8 = 0
    real = tenc._encode_p

    def spy(*a):
        nonlocal t8
        out = real(*a)
        t8 += int(out[0].t8.sum())
        return out

    tenc._encode_p = spy
    for t in (3, 4):
        jf = jenc.encode_frame_yuv(*yuv_frames(t))
        tf = tenc.encode_frame_yuv(*yuv_frames(t))
        assert not tf[0].is_idr
        assert [f.data for f in tf] == [f.data for f in jf]
        assert tf[0].qp == jf[0].qp and tf[0].frame_num == jf[0].frame_num
        for a, b in zip(jdec.decode(jf[0].data), tdec.decode(tf[0].data)):
            np.testing.assert_array_equal(a, b)
    assert t8 > 0, "no MB chose the 8x8 transform"
    assert not tdec._general and tdec.frames_concealed == 0


def test_decode_batch_mixes_cavlc_and_cabac():
    """One decode_batch call per frame over three sessions: two CAVLC
    streams (I and P frames batch) and a CABAC + 8x8 one (per session);
    every output equals its encoder's recon, on the fast path."""
    encs = [EncoderSession(CodecConfig(width=W, height=H, qp=30, gop_size=3,
                                       **kw), device="cpu")
            for kw in ({}, dict(deblock=True),
                       dict(cabac=True, transform8x8=True, deblock=True))]
    pool = DecoderPool(device="cpu")
    for i in range(3):
        pool.init_decoder(i)
    calls = {"i": 0, "p": 0}
    for name in calls:
        real = getattr(pool, f"_decode_batch_{name}")

        def count(items, results, real=real, name=name):
            calls[name] += len(items)
            return real(items, results)

        setattr(pool, f"_decode_batch_{name}", count)
    for t in range(4):
        src = [p[1 if t % 2 else 0] for p in yuv_frames(t)]
        aus = [e.encode_frame_yuv(*src)[0].data for e in encs]
        out = pool.decode_batch(list(enumerate(aus)))
        for i, e in enumerate(encs):
            for q, r in zip(out[i], e.recon):
                np.testing.assert_array_equal(
                    q, r[0].numpy()[:q.shape[0], :q.shape[1]],
                    err_msg=f"frame {t} session {i}")
    assert not any(pool[i]._general or pool[i].frames_concealed
                   for i in range(3))
    # the CAVLC sessions batched (two per frame), the CABAC one did not
    assert calls == {"i": 4, "p": 4}, calls
