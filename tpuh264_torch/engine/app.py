"""Live application orchestrator: the reference lab's `window.app` analog.

Port of tpuh264/engine/app.py.  The reference exposes a lifecycle and
automation API on a RUNNING pipeline -- start, stop, getStats,
setImplementation, setResolution, setStreams, setThreads, isProcessing
-- with a two-phase worker shutdown and a restart-on-reconfigure policy
for the live controls.  Same surface here:

* `App.start()` builds the pipeline on `device` and spawns a pump thread
  that paces it at the configured capture rate.
* `App.stop()` is the two-phase teardown: phase 1 signals the pump loop
  and joins it once the in-flight dispatch has retired; phase 2 releases
  the pipeline (and with it its device tensors).  Idempotent.
* `set_implementation/set_resolution/set_streams/set_threads`: changing
  a control while running restarts the pipeline with the new config.
* Capture backpressure: when the pump falls behind the capture clock by
  more than the frame-pool budget, source frames are DROPPED and counted
  (`dropped_capture`).
* `request_keyframe()` routes to the encoder owner (a forced IDR).

The implementations: "tpu_gop" (the device IPPP pipeline,
`devpipe.GOPDevicePipeline`), "tpu" (the per-frame session `Pipeline` of
engine/pipeline.py) and "libav" (that `Pipeline` on libx264 / libavcodec
host sessions).  The impl strings are the JAX App's API values.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Dict, Optional

from .config import RESOLUTIONS, CodecConfig

_log = logging.getLogger(__name__)

IMPLEMENTATIONS = ("tpu_gop", "tpu", "libav")


def _check_impl(impl: str) -> None:
    if impl not in IMPLEMENTATIONS:
        raise ValueError(f"unknown impl {impl!r}")


class App:
    """Lifecycle owner for one running pipeline on `device` (the card
    unless the caller asks for another; no card there raises).

    impl "tpu_gop": the device IPPP pipeline with decode-from-bits;
    "tpu": the per-frame session pipeline (EncoderSession -> ring ->
    DecoderPool); "libav": the same pipeline on libx264 / libavcodec."""

    def __init__(self, config: Optional[CodecConfig] = None,
                 impl: str = "tpu_gop", source_kind: str = "moving_gradient",
                 *, device="cuda", **kw):
        from .devpipe import resolve_device

        self.config = config if config is not None else CodecConfig(**kw)
        _check_impl(impl)
        self.impl = impl
        self.source_kind = source_kind
        self.device = resolve_device(device)
        self.pipeline = None
        self.error: Optional[BaseException] = None  # pump thread failure
        self._thread: Optional[threading.Thread] = None
        self._stop_evt = threading.Event()
        self._lock = threading.RLock()
        self._force_keyframe = False
        self.processing = False
        self.last_stats: Dict[str, float] = {}

    # -- lifecycle -------------------------------------------------------

    def _build(self):
        cfg = dataclasses.replace(self.config)  # pipeline owns its copy
        if self.impl in ("tpu", "libav"):
            from .pipeline import Pipeline

            return Pipeline(cfg, impl=self.impl, device=self.device)
        from .devpipe import GOPDevicePipeline

        k = GOPDevicePipeline.FRAMES_PER_DISPATCH
        gop = max(k, cfg.gop_size // k * k)
        return GOPDevicePipeline(cfg, gop_size=gop,
                                 source_kind=self.source_kind,
                                 device=self.device)

    def start(self) -> None:
        """Build the pipeline and begin pumping."""
        with self._lock:
            self.stop()  # idempotent teardown first
            self.pipeline = self._build()
            self.error = None
            self._stop_evt.clear()
            self.processing = True
            self._thread = threading.Thread(
                target=self._pump_loop, args=(self.pipeline,),
                name="tpuh264-torch-pump", daemon=True)
            self._thread.start()

    def stop(self) -> None:
        """Two-phase teardown; a no-op when not running.  If the pump
        thread failed, its exception is raised here after the teardown
        (it stays in `error` until the next start)."""
        with self._lock:
            thread = self._thread
            if thread is None:
                return
            # phase 1: signal, then wait for the in-flight dispatch
            self._stop_evt.set()
            thread.join()
            self._thread = None
            self.processing = False
            # phase 2: release the pipeline and its device state
            self.pipeline = None
            if self.error is not None:
                raise self.error

    def is_processing(self) -> bool:
        return self.processing

    # -- pump loop -------------------------------------------------------

    def _pump_loop(self, pipe) -> None:
        cfg = self.config
        frame_dt = 1.0 / max(cfg.fps, 1)
        pool_budget = cfg.pool_size  # frames of backlog before dropping
        is_gop = hasattr(pipe, "FRAMES_PER_DISPATCH")
        step = pipe.FRAMES_PER_DISPATCH if is_gop else 1
        produced = 0
        t0 = time.monotonic()
        try:
            while not self._stop_evt.is_set():
                if self._force_keyframe:
                    self._force_keyframe = False
                    if is_gop:
                        pipe.force_idr()
                    else:
                        pipe.encoder.force_key_frame()
                pipe.pump_frame()
                produced += step
                # capture-clock pacing + busy-drop backpressure: if the
                # pipeline lags the capture rate by more than the pool
                # budget, drop source frames instead of queueing them
                behind = (time.monotonic() - t0) / frame_dt - produced
                if behind > pool_budget:
                    ndrop = int(behind - pool_budget) + 1
                    if is_gop:
                        pipe.drop_frames(ndrop)
                    else:
                        pipe.stats.on_drop("capture", ndrop)
                        pipe.frame_index += ndrop
                    produced += ndrop
                elif behind < 0:
                    time.sleep(min(-behind * frame_dt, 0.25))
        except Exception as e:  # the thread's boundary: stop() re-raises
            _log.exception("pump thread failed")
            self.error = e
            self.processing = False

    # -- stats + automation API -----------------------------------------

    def get_stats(self) -> Dict[str, float]:
        pipe = self.pipeline
        if pipe is None:
            return dict(self.last_stats)
        snap = pipe.stats.snapshot(self.config.streams)
        snap["impl"] = self.impl
        snap["resolution"] = self.config.resolution_name
        snap["streams"] = self.config.streams
        snap["threads"] = self.config.effective_threads()
        if hasattr(pipe, "last_psnr_y"):
            snap["psnr_y"] = pipe.last_psnr_y
        self.last_stats = snap
        return snap

    def request_keyframe(self, stream_index: int = 0) -> None:
        """Decoder-side recovery request, routed to the encoder owner."""
        self._force_keyframe = True

    def _reconfigure(self, **changes) -> None:
        """Apply config changes; restart if running.  Teardown happens
        BEFORE the mutation: the pump thread reads self.config."""
        with self._lock:
            running = self._thread is not None
            if running:
                self.stop()
            for k, v in changes.items():
                setattr(self.config, k, v)
            if running:
                self.start()

    def set_implementation(self, impl: str) -> None:
        _check_impl(impl)
        with self._lock:
            running = self._thread is not None
            self.impl = impl
            if running:
                self.start()

    def set_resolution(self, res: str) -> None:
        if res in RESOLUTIONS:
            w, h = RESOLUTIONS[res]
        else:
            ws, hs = res.split("x")
            w, h = int(ws), int(hs)
        self._reconfigure(width=w, height=h)

    def set_streams(self, n: int) -> None:
        if not 1 <= n <= self.config.max_decoders:
            raise ValueError(f"streams must be 1..{self.config.max_decoders}")
        self._reconfigure(streams=n)

    def set_threads(self, n: int) -> None:
        self._reconfigure(threads=n)
