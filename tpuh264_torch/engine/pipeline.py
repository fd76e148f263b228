"""Multi-stream fan-out pipeline: 1 encoder -> bounded ring -> N decoders,
on a PyTorch device.

Port of tpuh264/engine/pipeline.py, the reference's orchestrator: one
encoder produces an access unit per tick; the frame ring publishes it
with refcount = number of streams; every stream's decoder consumes it
and releases its claim exactly once.  The decoders run as ONE batched
reconstruction per tick (`DecoderPool.decode_batch`).  A decoder that
raises `needs_keyframe` makes the encoder code an IDR next tick.

impl "tpu" runs the port's sessions; impl "libav" runs the same loop on
libx264 / libavcodec host sessions (engine/libav_backend.py, a copy of
the JAX package's), the reference's selectable-backend axis, so that
both implementations can be compared end to end.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from . import sources
from .config import CodecConfig
from .decoder import DecoderPool
from .devpipe import resolve_device
from .encoder import EncoderSession
from .metrics import StatsWindow
from .ring import FrameRing


class Pipeline:
    """The session pipeline on `device` (the card unless the caller asks
    for another; no card there raises).  impl "libav" codes on the host
    and uses no device."""

    def __init__(self, config: Optional[CodecConfig] = None,
                 impl: str = "tpu", *, device="cuda", **kw):
        if config is None:
            config = CodecConfig(**kw)
        if config.streams > config.max_decoders:
            raise ValueError(
                f"streams {config.streams} > MAX_DECODERS {config.max_decoders}")
        if impl not in ("tpu", "libav"):
            raise ValueError(f"unknown impl {impl!r}")
        self.config = config
        self.impl = impl
        self.device = resolve_device(device)
        if impl == "libav":
            from . import libav_backend

            self.encoder = libav_backend.LibavEncoderSession(config)
            self.decoders = libav_backend.LibavDecoderPool(
                config.max_decoders)
        else:
            self.encoder = EncoderSession(config, device=self.device)
            self.decoders = DecoderPool(config.max_decoders,
                                        device=self.device)
        for i in range(config.streams):
            self.decoders.init_decoder(i)
        self.ring = FrameRing(config.pool_size, config.max_frame_size)
        self.stats = StatsWindow()
        self.frame_index = 0
        self.last_outputs: Dict[int, Tuple[np.ndarray, ...]] = {}

    def pump_frame(self, frame: Optional[Tuple[np.ndarray, ...]] = None
                   ) -> bool:
        """One tick: encode (the source's next frame unless `frame` is
        given), publish, fan out to every decoder.  False if the ring
        dropped the frame."""
        cfg = self.config
        if frame is None:
            frame = sources.yuv_frame(cfg.width, cfg.height, self.frame_index)
        self.frame_index += 1
        self.stats.on_input()

        encoded = self.encoder.encode_frame_yuv(*frame)[0]
        tm = encoded.timings
        self.stats.on_encode(1, tm["encode_ms"], tm["copy_ms"],
                             tm["entropy_ms"], len(encoded.data))

        claim = self.ring.try_publish(encoded.data, fanout=cfg.streams)
        if claim is None:
            self.stats.on_drop("ring")
            return False
        slot, gen = claim

        # fan out: every stream decodes the same access unit, batched
        t0 = time.perf_counter()
        data = self.ring.read(slot, gen)
        try:
            results = self.decoders.decode_batch(
                [(i, data) for i in range(cfg.streams)])
        finally:
            for _ in range(cfg.streams):
                self.ring.release(slot, gen)  # exactly once per consumer
        self.stats.on_decode(cfg.streams, (time.perf_counter() - t0) * 1e3)
        self.last_outputs = results

        if any(self.decoders[i].needs_keyframe for i in range(cfg.streams)):
            self.encoder.force_key_frame()
        return True

    def run(self, duration_s: float = 5.0, max_frames: Optional[int] = None,
            source: Optional[Callable[[int], tuple]] = None
            ) -> Dict[str, float]:
        """Pump for `duration_s` (or `max_frames`) and return the stats."""
        end = time.monotonic() + duration_s
        n = 0
        while time.monotonic() < end:
            self.pump_frame(source(self.frame_index) if source else None)
            n += 1
            if max_frames is not None and n >= max_frames:
                break
        snap = self.stats.snapshot(self.config.streams)
        snap["frames"] = n
        return snap
