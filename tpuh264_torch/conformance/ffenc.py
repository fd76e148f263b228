# Copy of tpuh264/conformance/ffenc.py, so that the port imports nothing of tpuh264.
"""External H.264 encoder (libx264 via libavcodec ctypes) for quality
comparison: the "PSNR vs reference encoder at matched bitrate" metric
from BASELINE.json.  Everything is configured through the av_opt API so
no AVCodecContext struct layout is assumed.
"""

from __future__ import annotations

import ctypes
from typing import List, Tuple

import numpy as np

from .ffdec import AVFrameHead, AVPacketHead, AVERROR_EAGAIN, AVERROR_EOF

AV_OPT_SEARCH_CHILDREN = 1


def _load():
    from .ffdec import _dlopen_first, _AVCODEC_SONAMES, _AVUTIL_SONAMES

    avutil = _dlopen_first(_AVUTIL_SONAMES)
    avcodec = _dlopen_first(_AVCODEC_SONAMES)
    avcodec.avcodec_find_encoder_by_name.restype = ctypes.c_void_p
    avcodec.avcodec_alloc_context3.restype = ctypes.c_void_p
    avcodec.av_packet_alloc.restype = ctypes.POINTER(AVPacketHead)
    avutil.av_frame_alloc.restype = ctypes.POINTER(AVFrameHead)
    avutil.av_opt_set.restype = ctypes.c_int
    avutil.av_opt_set.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_char_p, ctypes.c_int
    ]
    avutil.av_opt_set_int.restype = ctypes.c_int
    avutil.av_opt_set_int.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int64, ctypes.c_int
    ]
    return avcodec, avutil


def encoder_available(name: str = "libx264") -> bool:
    try:
        avcodec, _ = _load()
        return bool(avcodec.avcodec_find_encoder_by_name(name.encode()))
    except OSError:
        return False


def encode_with_x264(
    frames: List[Tuple[np.ndarray, np.ndarray, np.ndarray]],
    bitrate: int = 1_000_000,
    fps: int = 30,
    preset: str = "veryfast",
    tune: str = "zerolatency",
    profile: str = None,
    x264_params: str = None,
) -> bytes:
    """Encode I420 frames with libx264 at a target bitrate -> annex-B.

    `profile` ("baseline"/"main"/"high") and `x264_params`
    (colon-separated x264 option string) configure the encoder for the
    reverse-conformance tests: OUR decoder must accept what a real
    third-party encoder emits (the role the reference's DecodeFrameNoDelay
    pool plays, reference/openh264_wrapper.cpp:240-280)."""
    avcodec, avutil = _load()
    codec = avcodec.avcodec_find_encoder_by_name(b"libx264")
    if not codec:
        raise RuntimeError("libx264 encoder unavailable")
    ctx = ctypes.c_void_p(avcodec.avcodec_alloc_context3(ctypes.c_void_p(codec)))
    h, w = frames[0][0].shape

    def opt(k: str, v: str):
        r = avutil.av_opt_set(ctx, k.encode(), v.encode(), AV_OPT_SEARCH_CHILDREN)
        if r < 0:
            raise RuntimeError(f"av_opt_set({k}={v}) -> {r}")

    opt("video_size", f"{w}x{h}")
    opt("pixel_format", "yuv420p")
    opt("time_base", f"1/{fps}")
    avutil.av_opt_set_int(ctx, b"b", bitrate, AV_OPT_SEARCH_CHILDREN)
    avutil.av_opt_set_int(ctx, b"g", 30, AV_OPT_SEARCH_CHILDREN)
    opt("preset", preset)
    opt("tune", tune)
    if profile:
        opt("profile", profile)
    if x264_params:
        opt("x264-params", x264_params)
    if avcodec.avcodec_open2(ctx, ctypes.c_void_p(codec), None) < 0:
        raise RuntimeError("avcodec_open2(libx264) failed")

    frame = avutil.av_frame_alloc()
    frame.contents.width = w
    frame.contents.height = h
    frame.contents.format = 0  # AV_PIX_FMT_YUV420P
    if avutil.av_frame_get_buffer(ctypes.cast(frame, ctypes.c_void_p), 0) < 0:
        raise RuntimeError("av_frame_get_buffer failed")
    pkt = avcodec.av_packet_alloc()

    out = bytearray()

    def drain():
        while True:
            r = avcodec.avcodec_receive_packet(
                ctx, ctypes.cast(pkt, ctypes.c_void_p)
            )
            if r in (AVERROR_EAGAIN, AVERROR_EOF):
                return
            if r < 0:
                raise RuntimeError(f"receive_packet {r}")
            size = pkt.contents.size
            out.extend(ctypes.string_at(pkt.contents.data, size))
            avcodec.av_packet_unref(ctypes.cast(pkt, ctypes.c_void_p))

    for t, (y, u, v) in enumerate(frames):
        avutil.av_frame_make_writable(ctypes.cast(frame, ctypes.c_void_p))
        for idx, plane in enumerate((y, u, v)):
            ph, pw = plane.shape
            stride = frame.contents.linesize[idx]
            src = np.ascontiguousarray(plane, np.uint8)
            dst = frame.contents.data[idx]
            for row in range(ph):
                ctypes.memmove(
                    ctypes.cast(
                        ctypes.cast(dst, ctypes.c_void_p).value + row * stride,
                        ctypes.c_void_p,
                    ),
                    src[row].ctypes.data,
                    pw,
                )
        # AVFrame.pts offset in FFmpeg 5.x: data(64) + linesize(32) +
        # extended_data(8) + width/height/nb_samples/format(16) +
        # key_frame(4) + pict_type(4) + sample_aspect_ratio(8) = 136
        ctypes.c_int64.from_address(
            ctypes.addressof(frame.contents) + 136
        ).value = t
        r = avcodec.avcodec_send_frame(ctx, ctypes.cast(frame, ctypes.c_void_p))
        if r < 0:
            raise RuntimeError(f"send_frame {r}")
        drain()
    avcodec.avcodec_send_frame(ctx, None)
    drain()
    return bytes(out)
