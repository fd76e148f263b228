# Copy of tpuh264/conformance/ffdec.py, so that the port imports nothing of tpuh264.
"""External-decoder conformance: decode annex-B with libavcodec via ctypes.

The reference has no conformance story at all (SURVEY.md section 4: no
tests, no golden bitstreams); this module closes that gap by checking our
streams against FFmpeg's normative H.264 decoder, with bit-exact plane
access (no swscale color conversion in the way).
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

AV_CODEC_ID_H264 = 27
AV_NOPTS_VALUE = -(2**63)
AVERROR_EAGAIN = -11
AVERROR_EOF = -541478725  # FFERRTAG('E','O','F',' ')


class AVPacketHead(ctypes.Structure):
    _fields_ = [
        ("buf", ctypes.c_void_p),
        ("pts", ctypes.c_int64),
        ("dts", ctypes.c_int64),
        ("data", ctypes.POINTER(ctypes.c_uint8)),
        ("size", ctypes.c_int),
        ("stream_index", ctypes.c_int),
        ("flags", ctypes.c_int),
    ]


class AVFrameHead(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_uint8) * 8),
        ("linesize", ctypes.c_int * 8),
        ("extended_data", ctypes.c_void_p),
        ("width", ctypes.c_int),
        ("height", ctypes.c_int),
        ("nb_samples", ctypes.c_int),
        ("format", ctypes.c_int),
    ]


_libs = None

# soname ladders: FFmpeg 4.x..8.x (avcodec 58..62 / avutil 56..60).  The
# AVPacket/AVFrame head layouts read here are prefix-stable across these
# majors; `_self_check` verifies the loaded pair actually works before any
# conformance test trusts it (VERDICT r1 next-round item 10).
_AVCODEC_SONAMES = [f"libavcodec.so.{v}" for v in (59, 60, 61, 62, 58)]
_AVUTIL_SONAMES = [f"libavutil.so.{v}" for v in (57, 58, 59, 60, 56)]


def _dlopen_first(names):
    err = None
    for n in names + [n.rsplit(".so", 1)[0] + ".so" for n in names[:1]]:
        try:
            return ctypes.CDLL(n)
        except OSError as e:
            err = e
    raise OSError(f"none of {names} loadable: {err}")


def _self_check(avcodec, avutil) -> None:
    """Fail loudly at load time if the runtime pair is unusable."""
    avcodec.avcodec_version.restype = ctypes.c_uint
    avutil.avutil_version.restype = ctypes.c_uint
    cv = avcodec.avcodec_version() >> 16
    if not 58 <= cv <= 70:
        raise OSError(f"unexpected libavcodec major {cv}")
    avcodec.avcodec_find_decoder.restype = ctypes.c_void_p
    if not avcodec.avcodec_find_decoder(AV_CODEC_ID_H264):
        raise OSError("libavcodec has no H.264 decoder")


def _load():
    global _libs
    if _libs is None:
        avutil = _dlopen_first(_AVUTIL_SONAMES)
        avcodec = _dlopen_first(_AVCODEC_SONAMES)
        _self_check(avcodec, avutil)
        avcodec.avcodec_find_decoder.restype = ctypes.c_void_p
        avcodec.avcodec_alloc_context3.restype = ctypes.c_void_p
        avcodec.av_packet_alloc.restype = ctypes.POINTER(AVPacketHead)
        avutil.av_frame_alloc.restype = ctypes.POINTER(AVFrameHead)
        avcodec.av_parser_init.restype = ctypes.c_void_p
        _libs = (avcodec, avutil)
    return _libs


def libav_available() -> bool:
    try:
        _load()
        return True
    except OSError:
        return False


def _plane(frame, idx: int, h: int, w: int) -> np.ndarray:
    stride = frame.contents.linesize[idx]
    ptr = frame.contents.data[idx]
    buf = np.ctypeslib.as_array(ptr, shape=(h, stride))
    return buf[:, :w].astype(np.int32).copy()


def decode_with_libav(
    annexb: bytes, width: int = 0, height: int = 0
) -> List[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Decode an annex-B H.264 stream; returns list of (Y, U, V) int32 planes.

    width/height arguments are accepted for API compatibility but the
    decoder's own reported dimensions are used.
    """
    avcodec, avutil = _load()
    codec = avcodec.avcodec_find_decoder(AV_CODEC_ID_H264)
    if not codec:
        raise RuntimeError("libavcodec has no H.264 decoder")
    ctx = avcodec.avcodec_alloc_context3(ctypes.c_void_p(codec))
    if avcodec.avcodec_open2(ctypes.c_void_p(ctx), ctypes.c_void_p(codec), None) < 0:
        raise RuntimeError("avcodec_open2 failed")
    parser = avcodec.av_parser_init(AV_CODEC_ID_H264)
    pkt = avcodec.av_packet_alloc()
    frame = avutil.av_frame_alloc()

    frames: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []

    def receive_all():
        while True:
            ret = avcodec.avcodec_receive_frame(
                ctypes.c_void_p(ctx), ctypes.cast(frame, ctypes.c_void_p)
            )
            if ret in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            if ret < 0:
                raise RuntimeError(f"avcodec_receive_frame: {ret}")
            fw, fh = frame.contents.width, frame.contents.height
            frames.append(
                (
                    _plane(frame, 0, fh, fw),
                    _plane(frame, 1, fh // 2, fw // 2),
                    _plane(frame, 2, fh // 2, fw // 2),
                )
            )

    data = (ctypes.c_uint8 * len(annexb)).from_buffer_copy(annexb)
    pos = 0
    out_data = ctypes.POINTER(ctypes.c_uint8)()
    out_size = ctypes.c_int(0)
    while pos < len(annexb):
        consumed = avcodec.av_parser_parse2(
            ctypes.c_void_p(parser),
            ctypes.c_void_p(ctx),
            ctypes.byref(out_data),
            ctypes.byref(out_size),
            ctypes.byref(data, pos),
            len(annexb) - pos,
            ctypes.c_int64(AV_NOPTS_VALUE),
            ctypes.c_int64(AV_NOPTS_VALUE),
            ctypes.c_int64(0),
        )
        if consumed < 0:
            raise RuntimeError("av_parser_parse2 failed")
        pos += consumed
        if out_size.value:
            pkt.contents.data = out_data
            pkt.contents.size = out_size.value
            if avcodec.avcodec_send_packet(
                ctypes.c_void_p(ctx), ctypes.cast(pkt, ctypes.c_void_p)
            ) < 0:
                raise RuntimeError("avcodec_send_packet failed")
            receive_all()
    # flush parser (emits any buffered AU) then drain the decoder
    consumed = avcodec.av_parser_parse2(
        ctypes.c_void_p(parser),
        ctypes.c_void_p(ctx),
        ctypes.byref(out_data),
        ctypes.byref(out_size),
        None,
        0,
        ctypes.c_int64(AV_NOPTS_VALUE),
        ctypes.c_int64(AV_NOPTS_VALUE),
        ctypes.c_int64(0),
    )
    if out_size.value:
        pkt.contents.data = out_data
        pkt.contents.size = out_size.value
        avcodec.avcodec_send_packet(
            ctypes.c_void_p(ctx), ctypes.cast(pkt, ctypes.c_void_p)
        )
        receive_all()
    avcodec.avcodec_send_packet(ctypes.c_void_p(ctx), None)
    receive_all()

    avcodec.av_parser_close(ctypes.c_void_p(parser))
    avcodec.avcodec_free_context(ctypes.byref(ctypes.c_void_p(ctx)))
    return frames
