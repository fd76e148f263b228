# Copy of tpuh264/engine/libav_backend.py, so that the port imports nothing of tpuh264.
"""Selectable libavcodec backend for the fan-out pipeline.

The reference can swap its whole pipeline onto the browser's hardware
codecs (WebCodecs backend, reference/scripts/app.js:616-692) and
its harness A/Bs the two implementations (automation.js:120-153).  This
module is the analog: `Pipeline(impl="libav")` runs the same
1-encoder -> ring -> N-decoder loop on libx264/libavcodec host sessions
instead of the TPU engine, so the benchmark matrix can compare both
implementations end to end (VERDICT r1 next-round item 8).

Incremental (per-frame) sessions built on the ctypes FFI in
tpuh264.conformance.ffenc/ffdec; zerolatency tuning means every
send_frame yields its packet immediately, matching the RTC loop.
"""

from __future__ import annotations

import ctypes
import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..conformance import ffdec, ffenc
from ..core import nal
from .config import CodecConfig

_AV_NOPTS_VALUE = -(1 << 63)


def _frame_offsets(avutil, frame) -> Tuple[int, int]:
    """(pict_type, pts) byte offsets into AVFrame, branched on the
    libavutil major and VERIFIED against a freshly allocated frame.

    FFmpeg 5/6 (lavu 57/58): ...format(116) key_frame(120)
    pict_type(124) sample_aspect_ratio(128) pts(136).  FFmpeg 7+
    (lavu >= 59) removed key_frame, so pict_type moves to 120 and pts
    stays at 136 behind the AVRational + alignment padding.  The checks
    below make a wrong guess a hard error instead of a silent write
    into sample_aspect_ratio (advisor round-2 finding)."""
    major = (avutil.avutil_version() >> 16) & 0xFF
    off_pict = 120 if major >= 59 else 124
    off_pts = 136
    base = ctypes.addressof(frame.contents)
    if ctypes.c_int64.from_address(base + off_pts).value != _AV_NOPTS_VALUE:
        raise RuntimeError(
            f"AVFrame.pts not at offset {off_pts} for libavutil {major}"
        )
    probe = ctypes.c_int32.from_address(base + 120).value
    expect = 1 if major < 59 else 0  # key_frame default 1 / pict_type NONE
    if probe != expect:
        raise RuntimeError(
            f"AVFrame layout probe failed for libavutil {major}: "
            f"int32@120 = {probe}, expected {expect}"
        )
    return off_pict, off_pts


def available() -> bool:
    try:
        return ffdec.libav_available() and ffenc.encoder_available()
    except Exception:
        return False


class _Encoded:
    __slots__ = ("data", "timings", "keyframe")

    def __init__(self, data: bytes, timings: Dict[str, float], keyframe: bool):
        self.data = data
        self.timings = timings
        self.keyframe = keyframe


class LibavEncoderSession:
    """Incremental libx264 encoder with the EncoderSession surface the
    pipeline uses (encode_frame_yuv / force_key_frame)."""

    def __init__(self, config: CodecConfig):
        self.config = config
        avcodec, avutil = ffenc._load()
        self._avcodec, self._avutil = avcodec, avutil
        codec = avcodec.avcodec_find_encoder_by_name(b"libx264")
        if not codec:
            raise RuntimeError("libx264 encoder unavailable")
        ctx = ctypes.c_void_p(avcodec.avcodec_alloc_context3(
            ctypes.c_void_p(codec)))
        self._ctx = ctx
        w = (config.width + 1) & ~1
        h = (config.height + 1) & ~1

        def opt(k, v):
            rr = avutil.av_opt_set(ctx, k.encode(), v.encode(),
                                   ffenc.AV_OPT_SEARCH_CHILDREN)
            if rr < 0:
                raise RuntimeError(f"av_opt_set({k}={v}) -> {rr}")

        opt("video_size", f"{w}x{h}")
        opt("pixel_format", "yuv420p")
        opt("time_base", "1/30")
        avutil.av_opt_set_int(ctx, b"b", config.bitrate,
                              ffenc.AV_OPT_SEARCH_CHILDREN)
        avutil.av_opt_set_int(ctx, b"g", config.gop_size or 30,
                              ffenc.AV_OPT_SEARCH_CHILDREN)
        opt("preset", "veryfast")
        opt("tune", "zerolatency")
        opt("profile", "baseline")
        opt("x264-params", "threads=1:sliced-threads=0")
        if avcodec.avcodec_open2(ctx, ctypes.c_void_p(codec), None) < 0:
            raise RuntimeError("avcodec_open2(libx264) failed")
        self._frame = avutil.av_frame_alloc()
        # resolve + verify version-dependent AVFrame offsets BEFORE any
        # field writes (fresh frame still holds the alloc defaults)
        self._off_pict_type, self._off_pts = _frame_offsets(
            avutil, self._frame
        )
        self._frame.contents.width = w
        self._frame.contents.height = h
        self._frame.contents.format = 0  # AV_PIX_FMT_YUV420P
        if avutil.av_frame_get_buffer(
                ctypes.cast(self._frame, ctypes.c_void_p), 0) < 0:
            raise RuntimeError("av_frame_get_buffer failed")
        self._pkt = avcodec.av_packet_alloc()
        self._pts = 0
        self._force_idr = False
        self.frames_encoded = 0

    def force_key_frame(self) -> None:
        self._force_idr = True

    def _drain(self) -> bytes:
        out = bytearray()
        while True:
            rr = self._avcodec.avcodec_receive_packet(
                self._ctx, ctypes.cast(self._pkt, ctypes.c_void_p))
            if rr in (ffenc.AVERROR_EAGAIN, ffenc.AVERROR_EOF):
                return bytes(out)
            if rr < 0:
                raise RuntimeError(f"receive_packet {rr}")
            out += ctypes.string_at(self._pkt.contents.data,
                                    self._pkt.contents.size)
            self._avcodec.av_packet_unref(
                ctypes.cast(self._pkt, ctypes.c_void_p))

    def encode_frame_yuv(self, y, u, v) -> List[_Encoded]:
        t0 = time.perf_counter()
        avutil, avcodec, frame = self._avutil, self._avcodec, self._frame
        avutil.av_frame_make_writable(ctypes.cast(frame, ctypes.c_void_p))
        for idx, plane in enumerate((y, u, v)):
            src = np.ascontiguousarray(plane, np.uint8)
            ph, pw = src.shape
            stride = frame.contents.linesize[idx]
            dst = ctypes.cast(frame.contents.data[idx], ctypes.c_void_p).value
            for row in range(ph):
                ctypes.memmove(ctypes.c_void_p(dst + row * stride),
                               src[row].ctypes.data, pw)
        base = ctypes.addressof(frame.contents)
        ctypes.c_int64.from_address(base + self._off_pts).value = self._pts
        ctypes.c_int32.from_address(base + self._off_pict_type).value = (
            1 if self._force_idr else 0  # AV_PICTURE_TYPE_I / none
        )
        self._force_idr = False
        self._pts += 1
        t1 = time.perf_counter()
        if avcodec.avcodec_send_frame(
                self._ctx, ctypes.cast(frame, ctypes.c_void_p)) < 0:
            raise RuntimeError("send_frame failed")
        data = self._drain()
        t2 = time.perf_counter()
        self.frames_encoded += 1
        timings = {
            "copy_ms": (t1 - t0) * 1e3,
            "encode_ms": (t2 - t1) * 1e3,
            "entropy_ms": 0.0,
        }
        keyframe = any(
            ntype == nal.NAL_SLICE_IDR
            for _, ntype, _ in nal.split_annexb(data)
        )
        return [_Encoded(data, timings, keyframe)]


class _LibavDecoderSlot:
    def __init__(self):
        # ffdec._load configures the decoder-side restypes (pointer-sized
        # returns); ffenc._load only does the encoder side
        avcodec, avutil = ffdec._load()
        self._avcodec = avcodec
        codec = avcodec.avcodec_find_decoder(ffdec.AV_CODEC_ID_H264)
        self._ctx = ctypes.c_void_p(
            avcodec.avcodec_alloc_context3(ctypes.c_void_p(codec)))
        if avcodec.avcodec_open2(self._ctx, ctypes.c_void_p(codec), None) < 0:
            raise RuntimeError("avcodec_open2(h264 dec) failed")
        self._pkt = avcodec.av_packet_alloc()
        self._frame = avutil.av_frame_alloc()
        self.last_frame = None
        self.needs_keyframe = False
        self.frames_decoded = 0
        self.frames_concealed = 0

    def decode(self, data: bytes):
        """Decode one access unit (no parser needed: AU-framed input)."""
        buf = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        self._pkt.contents.data = ctypes.cast(
            buf, ctypes.POINTER(ctypes.c_uint8))
        self._pkt.contents.size = len(data)
        got = None
        if self._avcodec.avcodec_send_packet(
                self._ctx, ctypes.cast(self._pkt, ctypes.c_void_p)) < 0:
            self.needs_keyframe = True
            self.frames_concealed += 1
            return self.last_frame
        while True:
            rr = self._avcodec.avcodec_receive_frame(
                self._ctx, ctypes.cast(self._frame, ctypes.c_void_p))
            if rr in (ffdec.AVERROR_EAGAIN, ffdec.AVERROR_EOF):
                break
            if rr < 0:
                self.needs_keyframe = True
                self.frames_concealed += 1
                return self.last_frame
            fw = self._frame.contents.width
            fh = self._frame.contents.height
            got = (
                ffdec._plane(self._frame, 0, fh, fw),
                ffdec._plane(self._frame, 1, fh // 2, fw // 2),
                ffdec._plane(self._frame, 2, fh // 2, fw // 2),
            )
        if got is None:
            self.needs_keyframe = True
            self.frames_concealed += 1
            return self.last_frame
        self.last_frame = got
        self.needs_keyframe = False
        self.frames_decoded += 1
        return got


class LibavDecoderPool:
    """DecoderPool surface over per-stream libavcodec sessions."""

    def __init__(self, max_decoders: int = 32):
        self.max_decoders = max_decoders
        self._slots: Dict[int, _LibavDecoderSlot] = {}

    def init_decoder(self, idx: int) -> None:
        if not 0 <= idx < self.max_decoders:
            raise IndexError(f"decoder index {idx} out of range")
        self._slots[idx] = _LibavDecoderSlot()

    def deinit_decoder(self, idx: int) -> None:
        self._slots.pop(idx, None)

    def __getitem__(self, idx: int) -> _LibavDecoderSlot:
        return self._slots[idx]

    def active(self) -> List[int]:
        return sorted(self._slots)

    def decode(self, idx: int, data: bytes):
        return self._slots[idx].decode(data)

    def decode_batch(self, items):
        return {idx: self._slots[idx].decode(data) for idx, data in items}
