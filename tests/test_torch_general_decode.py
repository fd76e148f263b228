"""The port's DecoderSession and DecoderPool on streams the fast path does
not take, through the golden StreamDecoder (tpuh264_torch/golden), on the
CPU.

Third-party libx264 streams at 64x48 (general baseline with partitions and
adaptive quantisation, in-loop deblock, two slices a frame, CABAC main,
high profile with Intra_8x8 in CABAC and in CAVLC, and x264's smart
weighted prediction with ref_pic_list_modification) decode access unit by
access unit, per session and batched, to libavcodec's pictures, and to
the JAX session's where that one is right (all but the list
modifications, which its fast path decodes in the default order).  The
engine's own streams with a 20-pel MV or with a list modification divert
mid-stream, the golden decoder starting from the fast path's DPB.  A
batch mixes fast and general sessions.  An error raised once device work
has started propagates, with no golden try."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpuh264.engine.decoder import DecoderSession as JDec
from tpuh264_torch.conformance import ffdec, ffenc
from tpuh264_torch.core import nal
from tpuh264_torch.core.bitstream import BitReader, BitWriter
from tpuh264_torch.core.sliceheader import SliceHeader
from tpuh264_torch.engine import (CodecConfig, DecoderPool, DecoderSession,
                                  EncoderSession)
from tpuh264_torch.engine import decoder as t_decoder
from tpuh264_torch.engine import sources
from tpuh264_torch.golden import codec as t_gcodec
from tpuh264_torch.kernels import iframe, pframe

X264 = {
    "baseline general": ("baseline", "aq-mode=1:partitions=p8x8,i4x4:ref=1:"
                         "no-deblock=1", {}),
    "baseline partitions deblock": ("baseline", "aq-mode=0:partitions=p8x8,"
                                    "p4x4,i4x4:ref=1", {}),
    "baseline two slices": ("baseline", "aq-mode=0:partitions=p8x8,i4x4:"
                            "ref=1:slices=2", {}),
    "main CABAC": ("main", "aq-mode=1:partitions=all:ref=1", {}),
    "high CABAC Intra_8x8": ("high", "aq-mode=0:partitions=i8x8,i4x4:ref=1",
                             {}),
    "high CAVLC Intra_8x8": ("high", "cabac=0:aq-mode=0:partitions=i8x8,"
                             "i4x4:ref=1", {}),
    "high weightp list modification": ("high", "aq-mode=1:partitions=all:"
                                       "ref=2", {"preset": "medium"}),
}
LIST_MODS = "high weightp list modification"


def _need_libav():
    if not (ffdec.libav_available() and ffenc.encoder_available()):
        pytest.skip("libavcodec with libx264 is not installed")


def _frames(w=64, h=48, n=6, seed=3):
    """Smoothed noise under a translating crop (the JAX package's
    reverse-conformance fixture): inter prediction wins, partitions are
    used."""
    from numpy.lib.stride_tricks import sliding_window_view

    rng = np.random.default_rng(seed)
    base = [rng.integers(0, 256, s, np.uint8)
            for s in ((h * 2, w * 2), (h, w), (h, w))]

    def smooth(a):
        pad = np.pad(a.astype(np.float32), 2, mode="edge")
        return sliding_window_view(pad, (4, 4)).mean(axis=(2, 3))[
            :a.shape[0], :a.shape[1]]

    sy, su, sv = (smooth(a) for a in base)
    out = []
    for t in range(n):
        dx, dy = 2 * t + (t % 2), 3 * t % 5
        out.append((sy[dy:dy + h, dx:dx + w].astype(np.uint8),
                    su[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2]
                    .astype(np.uint8),
                    sv[dy // 2:dy // 2 + h // 2, dx // 2:dx // 2 + w // 2]
                    .astype(np.uint8)))
    return out


def split_aus(stream: bytes):
    """Annex-B bytes -> access units: a new one starts at a slice NAL whose
    first_mb_in_slice is 0 (its payload's first bit set)."""
    import re

    aus, cur, seen = [], 0, False
    for m in re.finditer(b"\x00\x00\x01", stream):
        off = m.start()
        if stream[off + 3] & 31 in (1, 5):
            if stream[off + 4] & 0x80 and seen:
                aus.append(stream[cur:off])
                cur = off
            seen = True
    return aus + [stream[cur:]]


_STREAMS = {}


def x264_stream(name: str) -> bytes:
    if name not in _STREAMS:
        profile, params, kw = X264[name]
        _STREAMS[name] = ffenc.encode_with_x264(
            _frames(), bitrate=400_000, profile=profile,
            x264_params=params + ":threads=1:sliced-threads=0", **kw)
    return _STREAMS[name]


def assert_planes_equal(got, ref, what):
    assert got is not None, what
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray) and g.dtype == np.uint8, what
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=what)


def list_mod_aus(aus, sps, pps):
    """Access units of a P frame with every slice header rewritten to carry
    ref_pic_list_modification_flag_l0 with one entry, abs_diff_pic_num 2:
    the picture two frame numbers back moves to the head of list 0, so the
    slices' ref_idx 0 names the older reference."""
    out = b""
    for ridc, ntype, rbsp in nal.split_annexb(aus):
        assert ntype == nal.NAL_SLICE_NON_IDR
        # payload bits: up to the rbsp stop bit
        nbits = 8 * len(rbsp) - (rbsp[-1] & -rbsp[-1]).bit_length()
        r = BitReader(rbsp)
        r.ue(), r.ue(), r.ue()  # first_mb_in_slice, slice_type, pps id
        r.u(sps.log2_max_frame_num_minus4 + 4)  # frame_num
        if sps.pic_order_cnt_type == 0:
            r.u(sps.log2_max_pic_order_cnt_lsb_minus4 + 4)
        if r.u(1):  # num_ref_idx_active_override_flag
            r.ue()
        flag_at = r.bit_position
        assert r.u(1) == 0
        bits = BitReader(rbsp)
        w = BitWriter()
        for _ in range(flag_at):
            w.u(1, bits.u(1))
        bits.u(1)
        w.u(1, 1)  # ref_pic_list_modification_flag_l0
        w.ue(0)  # modification_of_pic_nums_idc 0: subtract
        w.ue(1)  # abs_diff_pic_num_minus1
        w.ue(3)  # end of the list
        for _ in range(flag_at + 1, nbits):
            w.u(1, bits.u(1))
        w.rbsp_trailing_bits()
        out += nal.wrap_nal(ntype, w.get_bytes(), ridc)
    return out


@pytest.mark.parametrize("name", sorted(X264))
def test_x264_streams_decode_to_libavcodec(name):
    """Per session and batched (two slots on the same stream), every
    access unit equals libavcodec's picture, as uint8; the sessions switch
    to the general path and conceal nothing.  The JAX session returns the
    same pictures, except on the list modifications."""
    _need_libav()
    stream = x264_stream(name)
    aus = split_aus(stream)
    ref = ffdec.decode_with_libav(stream)
    assert len(aus) == len(ref) == 6
    if name == LIST_MODS:
        assert any(SliceHeader.parse(BitReader(rbsp), *_ps(stream), False,
                                     ref=ridc != 0).ref_list_mods
                   for ridc, ntype, rbsp in nal.split_annexb(stream)
                   if ntype == nal.NAL_SLICE_NON_IDR)
    sess = DecoderSession(device="cpu")
    pool = DecoderPool(device="cpu")
    pool.init_decoder(0)
    pool.init_decoder(5)
    jsess = JDec()
    for t, au in enumerate(aus):
        assert_planes_equal(sess.decode(au), ref[t], f"{name} frame {t}")
        res = pool.decode_batch([(0, au), (5, au)])
        for i in (0, 5):
            assert_planes_equal(res[i], ref[t], f"{name} batch {i} f{t}")
        if name != LIST_MODS:
            got = sess.last_frame
            for a, b in zip(jsess.decode(au), got):
                np.testing.assert_array_equal(np.asarray(a), b)
    for s in (sess, pool[0], pool[5]):
        assert s._general and s.frames_concealed == 0
        assert s.frames_decoded == 6


def _ps(stream):
    from tpuh264_torch.core.params import PPS, SPS

    sps = pps = None
    for _, ntype, rbsp in nal.split_annexb(stream):
        if ntype == nal.NAL_SPS:
            sps = SPS.parse(BitReader(rbsp))
        elif ntype == nal.NAL_PPS:
            pps = PPS.parse(BitReader(rbsp))
    return sps, pps


def test_mv_beyond_the_window_diverts_to_golden():
    """The engine test's crafted stream (an I frame, then a P frame whose
    first MV is 20 pels): `chip_smoke.general_stream` emits the JAX
    package's bytes; the I frame takes the fast path, the P frame the golden one,
    equal to the golden decode, to the JAX session and to libavcodec."""
    from tpuh264.core.params import PPS as JPPS, SPS as JSPS
    from tpuh264.engine import sources as jsrc
    from tpuh264.entropy import packp as jpackp
    from tpuh264.golden import codec as jgcodec

    i_bytes, p_bytes = chip_smoke.general_stream(np)
    y, u, v = jsrc.yuv_frame(96, 64, 0)
    ji, _ = jgcodec.encode_iframe(np.asarray(y, np.int32),
                                  np.asarray(u, np.int32),
                                  np.asarray(v, np.int32), qp=28)
    sps, pps = JSPS.for_size(96, 64), JPPS()
    n = sps.mb_height * sps.mb_width
    mb_info = np.zeros((n, 8), np.int32)
    mb_info[:, 0] = 1
    mb_info[0, 5] = 80
    jp = jpackp.pack_pframe(
        mb_info, np.zeros((n, 16), np.int32), np.zeros((n, 16, 16), np.int32),
        np.zeros((n, 2, 4), np.int32), np.zeros((n, 2, 4, 15), np.int32),
        sps, pps, 28, slice_mode="rows", frame_num=1, deblock_idc=1)
    assert (i_bytes, p_bytes) == (ji, jp)
    sess = DecoderSession(device="cpu")
    out_i = sess.decode(i_bytes)
    assert not sess._general and sess._gold is None
    out_p = sess.decode(p_bytes)
    assert sess._general and sess.frames_concealed == 0
    gold = jgcodec.decode_annexb_seq(i_bytes + p_bytes)
    jsess = JDec()
    for t, (got, au) in enumerate(((out_i, i_bytes), (out_p, p_bytes))):
        assert_planes_equal(got, gold[t], f"golden frame {t}")
        assert_planes_equal(got, jsess.decode(au), f"JAX frame {t}")
    if ffdec.libav_available():
        for got, ref in zip((out_i, out_p),
                            ffdec.decode_with_libav(i_bytes + p_bytes)):
            assert_planes_equal(got, ref, "libavcodec")


def _own_stream(n=5, refs=2):
    """The engine's own stream, 64x48, QP 30, noise, `refs` references."""
    enc = EncoderSession(CodecConfig(width=64, height=48, qp=30,
                                     num_ref_frames=refs, gop_size=16),
                         device="cpu")
    aus = [enc.encode_frame_yuv(*sources.yuv_frame(64, 48, t, "noise",
                                                   seed=2))[0].data
           for t in range(n)]
    return aus, enc.sps, enc.pps


def test_list_modification_diverts_mid_stream_to_libavcodecs_pictures():
    """Frames 2 and 3 of the engine's own two-reference stream carry a
    list modification that swaps the two references.  The fast path takes
    frames 0 and 1, then hands the session to the golden decoder, seeded
    with the DPB and its frame numbers: every picture equals
    libavcodec's, per session and batched.  The JAX session decodes
    frame 2 in the default order, and its pixels differ."""
    _need_libav()
    aus, sps, pps = _own_stream()
    aus[2] = list_mod_aus(aus[2], sps, pps)
    aus[3] = list_mod_aus(aus[3], sps, pps)
    ref = ffdec.decode_with_libav(b"".join(aus))
    assert len(ref) == len(aus)
    sess = DecoderSession(device="cpu")
    pool = DecoderPool(device="cpu")
    pool.init_decoder(1)
    for t, au in enumerate(aus):
        assert_planes_equal(sess.decode(au), ref[t], f"session frame {t}")
        assert_planes_equal(pool.decode_batch([(1, au)])[1], ref[t],
                            f"pool frame {t}")
        assert sess._general == (t >= 2)
        if t == 1:
            assert sess._fnums == [1, 0] and len(sess._dpb) == 2
    assert sess.frames_concealed == pool[1].frames_concealed == 0
    jsess = JDec()
    jout = [jsess.decode(au) for au in aus[:3]]
    assert not np.array_equal(np.asarray(jout[2][0]), ref[2][0])


def test_decode_batch_mixes_fast_and_general_sessions(monkeypatch):
    """Slots 0 and 1 decode the engine's own stream, slots 2 and 3 an x264
    stream: one batch a tick.  The own-stream slots stay on the fast path
    and their P frames are reconstructed in one batched call of two
    streams; the x264 slots go general; every picture equals libavcodec's
    decode of its stream."""
    _need_libav()
    own, _, _ = _own_stream(refs=1)  # the pool batches one-reference P
    own_ref = ffdec.decode_with_libav(b"".join(own))
    x264 = x264_stream("baseline general")
    x_aus = split_aus(x264)[:len(own)]
    x_ref = ffdec.decode_with_libav(x264)
    batches = []
    real = pframe.decode_pframe_rows_multi

    def spy(sym, *a, **kw):
        batches.append(int(sym.kind.shape[0]))
        return real(sym, *a, **kw)

    monkeypatch.setattr(pframe, "decode_pframe_rows_multi", spy)
    pool = DecoderPool(device="cpu")
    for i in range(4):
        pool.init_decoder(i)
    for t in range(len(own)):
        res = pool.decode_batch([(0, own[t]), (2, x_aus[t]), (1, own[t]),
                                 (3, x_aus[t])])
        for i in (0, 1):
            assert_planes_equal(res[i], own_ref[t], f"own slot {i} f{t}")
        for i in (2, 3):
            assert_planes_equal(res[i], x_ref[t], f"x264 slot {i} f{t}")
    assert [pool[i]._general for i in range(4)] == [False, False, True, True]
    assert batches == [2] * (len(own) - 1)


class _CardFault(RuntimeError):
    pass


@pytest.mark.parametrize("route", ["session", "pool"])
@pytest.mark.parametrize("frame", ["I", "P"])
def test_device_stage_error_propagates(monkeypatch, route, frame):
    """A RuntimeError raised by device work (as PyTorch raises a CUDA
    fault) reaches the caller: no golden try, no switch, no concealment."""
    aus, _, _ = _own_stream(2)
    built = []
    monkeypatch.setattr(t_gcodec, "StreamDecoder",
                        lambda: built.append(1) or pytest.fail("golden"))

    def boom(*a, **kw):
        raise _CardFault("CUDA error: an illegal memory access")

    target = (iframe, "decode_iframe_scan") if frame == "I" else (
        pframe, "decode_pframe_rows_multi")
    sess = DecoderSession(device="cpu")
    pool = DecoderPool(device="cpu")
    pool.init_decoder(0)
    if frame == "P":
        sess.decode(aus[0])
        pool.decode_batch([(0, aus[0])])
    monkeypatch.setattr(*target, boom)
    au = aus[1] if frame == "P" else aus[0]
    with pytest.raises(_CardFault):
        if route == "session":
            sess.decode(au)
        else:
            pool.decode_batch([(0, au)])
    s = sess if route == "session" else pool[0]
    assert not built and s._gold is None and not s._general
    assert s.frames_concealed == 0 and not s.needs_keyframe


def test_dpb_copy_fault_propagates(monkeypatch):
    """A switch to the golden path copies the DPB from the device; a fault
    there is the device's, so it reaches the caller, not the
    concealment."""
    aus, _, _ = _own_stream(2)
    sess = DecoderSession(device="cpu")
    sess.decode(aus[0])

    class Plane:
        def __getitem__(self, i):
            return self

        def cpu(self):
            raise _CardFault("CUDA error: an illegal memory access")

    sess._dpb = [(Plane(), Plane(), Plane())]
    monkeypatch.setattr(sess, "_host_stage", lambda data: (
        _ for _ in ()).throw(NotImplementedError("general syntax")))
    with pytest.raises(_CardFault):
        sess.decode(aus[1])
    assert sess.frames_concealed == 0 and not sess.needs_keyframe


def test_host_stage_runtime_error_gets_one_golden_try(monkeypatch):
    """A P frame before any reference: the host stage raises RuntimeError,
    the golden try fails too (it has no reference either), so the session
    conceals and stays on the fast path, which then decodes the IDR.  A
    golden try that succeeds switches the session."""
    aus, _, _ = _own_stream(2)
    sess = DecoderSession(device="cpu")
    assert sess.decode(aus[1]) is None and sess.needs_keyframe
    assert not sess._general and sess.frames_concealed == 1
    ref = t_gcodec.decode_annexb_seq(aus[0])[0]
    assert_planes_equal(sess.decode(aus[0]), ref, "IDR after concealment")
    assert not sess.needs_keyframe and not sess._general
    # the native parse refuses what follows; golden takes it
    monkeypatch.setattr(t_decoder.entropy_native, "parse_pframe_slices",
                        lambda *a: (_ for _ in ()).throw(RuntimeError("x")))
    ref = t_gcodec.decode_annexb_seq(aus[0] + aus[1])[1]
    assert_planes_equal(sess.decode(aus[1]), ref, "P frame on golden")
    assert sess._general and sess.frames_concealed == 1


def test_general_session_is_not_batched(monkeypatch):
    """A pool slot that went general decodes per session from then on: the
    batch's host stage never classifies it again."""
    _need_libav()
    stream = x264_stream("main CABAC")
    aus = split_aus(stream)
    ref = ffdec.decode_with_libav(stream)
    pool = DecoderPool(device="cpu")
    pool.init_decoder(0)
    calls = []
    real = t_decoder.DecoderSession._classify
    monkeypatch.setattr(t_decoder.DecoderSession, "_classify",
                        lambda self, d: calls.append(1) or real(self, d))
    for t, au in enumerate(aus):
        assert_planes_equal(pool.decode_batch([(0, au)])[0], ref[t],
                            f"frame {t}")
        assert pool[0]._general and pool[0]._dpb == []
    # frame 0: the batch's classify and the session's own (both refuse
    # CABAC); none after the switch
    assert len(calls) == 2
    assert isinstance(pool[0]._gold, t_gcodec.StreamDecoder)
