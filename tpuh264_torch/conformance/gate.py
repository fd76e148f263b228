"""Correctness gate of the port's GOP pipeline, for a run on the card.

The port's counterpart of tools/tpu_gate.py.  It drives
`GOPDevicePipeline` on `device` (the card unless the caller asks for
another) and holds the decode-from-bits reconstruction against an
independent decode of the emitted annex-B bytes: libavcodec where it
loads (`ffdec.libav_available()`), else the golden numpy decoder
(`golden.codec.decode_annexb_seq`).  Any difference raises
`AssertionError`.

Unlike the JAX gate, `run_gate` covers only the shapes; call
`run_gate_extended` after it for the extended paths (`python -m
tpuh264_torch.conformance.gate` runs both on the card).  Each returns
{"oracle", "compared" (decoded pictures held against the oracle's),
"decoded" (frames the oracle decoded), "decoded_mbs" (their
macroblocks), "oracle_seconds" (the oracle's decode time, summed over
its decodes), "seconds" (the wall)}.

The oracle decodes the bytes the pipeline emitted on this device, so
the "rigid" source's float differences between devices do not matter
here; a test must not hold the card's streams against the CPU's.

The golden decoder is numpy on one host core, ~2 ms an MB (16 frames of
1080p take minutes), so by default the oracle decodes in `workers`
spawned processes, each stream beside the next and beside the pipeline
that is still running; `workers=0` decodes in the calling process.
"""

from __future__ import annotations

import multiprocessing
import os
import sys
import time
from concurrent.futures import Future, ProcessPoolExecutor

import numpy as np

# (width, height, streams, intra_in_p): the smallest shape, the
# reference's 480p x 8 operating point with the default intra-in-P scan,
# and the 1080p x 4 shape with the RTC preset that the JAX bench measures
GATE_SHAPES = ((64, 48, 2, True), (854, 480, 8, True),
               (1920, 1080, 4, False))


def oracle_name() -> str:
    """"libavcodec" where it loads, else "golden"."""
    from .ffdec import libav_available

    return "libavcodec" if libav_available() else "golden"


def decode_oracle(stream: bytes, oracle: str = None):
    """Decode annex-B bytes with `oracle` (by default `oracle_name()`) ->
    [(Y, U, V) int32 planes]."""
    if (oracle or oracle_name()) == "libavcodec":
        from .ffdec import decode_with_libav

        return decode_with_libav(stream)
    from ..golden import codec as gcodec

    return gcodec.decode_annexb_seq(stream)


def _timed_decode(stream: bytes, oracle: str):
    """decode_oracle -> (frames, seconds it took)."""
    t0 = time.perf_counter()
    frames = decode_oracle(stream, oracle)
    return frames, time.perf_counter() - t0


class _Oracle:
    """Decodes streams with the oracle: in `workers` spawned processes, or
    at once in this process when `workers` is 0.  A context manager that
    stops its processes on exit."""

    def __init__(self, workers):
        self.name = oracle_name()
        if workers is None:
            workers = max(1, min(8, (os.cpu_count() or 2) - 1))
        self.pool = (ProcessPoolExecutor(
            workers, mp_context=multiprocessing.get_context("spawn"))
            if workers else None)

    def submit(self, stream: bytes) -> Future:
        """-> a future of (frames, decode seconds)."""
        if self.pool is not None:
            return self.pool.submit(_timed_decode, stream, self.name)
        done = Future()
        done.set_result(_timed_decode(stream, self.name))
        return done

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        if self.pool is not None:
            self.pool.shutdown(wait=True, cancel_futures=True)


def _check(frames, n_frames: int, planes, what: str) -> None:
    """The oracle decoded `n_frames` frames and its last one equals the
    device decode `planes` (Y, U, V, padded to the MB grid)."""
    if len(frames) != n_frames:
        raise AssertionError(f"gate {what}: the oracle decoded "
                             f"{len(frames)} of {n_frames} frames")
    for name, dev, ora in zip("YUV", planes, frames[-1]):
        ora = np.asarray(ora)
        dev = np.asarray(dev)[:ora.shape[0], :ora.shape[1]]
        if not np.array_equal(dev, ora):
            raise AssertionError(
                f"gate {what} {name}: device decode != oracle "
                f"({int((dev != ora).sum())} samples differ)")


def run_gate(shapes=GATE_SHAPES, dispatches: int = 2, qp: int = 33, *,
             device="cuda", workers=None, verbose: bool = True) -> dict:
    """Encode and decode `dispatches` dispatches of the "rigid" source at
    each (width, height, streams, intra_in_p) shape at fixed `qp`; the
    final decoded frame of the first and the last stream must equal the
    oracle's decode of that stream's bytes.  The largest shape runs
    first, so that its oracle decodes start soonest."""
    from ..engine import CodecConfig
    from ..engine.devpipe import GOPDevicePipeline

    t_all = time.perf_counter()
    pending = []
    with _Oracle(workers) as oracle:
        for (w, h, s, iip) in sorted(shapes, key=lambda x: -x[0] * x[1] *
                                     x[2]):
            t0 = time.perf_counter()
            pipe = GOPDevicePipeline(
                CodecConfig(width=w, height=h, qp=qp, streams=s,
                            intra_in_p=iip),
                gop_size=4 * dispatches, source_kind="rigid", device=device)
            for _ in range(dispatches):
                pipe.pump_frame()  # raises on bytes its own parse refuses
            planes = pipe.decoded_planes()
            n_frames = pipe.FRAMES_PER_DISPATCH * dispatches
            mbs = n_frames * -(-w // 16) * -(-h // 16)
            for si in sorted({0, s - 1}):
                pending.append((oracle.submit(pipe.stream_bytes(si)),
                                n_frames, mbs, [p[si] for p in planes],
                                f"{w}x{h} stream {si}"))
            if verbose:
                print(f"gate {w}x{h} x {s}: {dispatches} dispatches in "
                      f"{time.perf_counter() - t0:.1f} s", file=sys.stderr)
        secs = 0.0
        for fut, n_frames, _, planes, what in pending:
            frames, t = fut.result()
            secs += t
            _check(frames, n_frames, planes, what)
    res = dict(oracle=oracle.name, compared=len(pending),
               decoded=sum(p[1] for p in pending),
               decoded_mbs=sum(p[2] for p in pending), oracle_seconds=secs,
               seconds=time.perf_counter() - t_all)
    if verbose:
        print(f"gate: {res['compared']} final pictures equal to "
              f"{oracle.name} ({res['seconds']:.1f} s)", file=sys.stderr)
    return res


def run_gate_extended(dispatches: int = 4, *, device="cuda", workers=None,
                      verbose: bool = True) -> dict:
    """The paths the plain shapes miss: CBR rate control with a scene cut
    (the content inverts from dispatch 2 on), host-frame ingest, and 1 ->
    2 decode fan-out at 128x96 x 2, every decode stream held against the
    oracle after EVERY dispatch; the controller must see the cut."""
    from ..engine import CodecConfig, sources
    from ..engine.devpipe import GOPDevicePipeline

    t0 = time.perf_counter()
    w, h = 128, 96
    cfg = CodecConfig(width=w, height=h, streams=2, qp=None,
                      bitrate=500_000, intra_in_p=False)
    pipe = GOPDevicePipeline(cfg, gop_size=16, source_kind="host", fanout=2,
                             device=device)
    k = pipe.FRAMES_PER_DISPATCH

    def batch(t_first: int, invert: bool):
        out = []
        for i in range(3):
            p = np.stack([
                np.stack([sources.yuv_frame(w, h, t_first + f, seed=si)[i]
                          for si in range(cfg.streams)])
                for f in range(k)]).astype(np.uint8)
            out.append(255 - p if invert else p)
        return tuple(out)

    pending = []  # (oracle decode, frames, decode streams and their planes)
    with _Oracle(workers) as oracle:
        for d in range(dispatches):
            pipe.pump_host_frames(*batch(k * d, invert=d >= 2))
            planes = pipe.decoded_planes()
            for enc_s in range(cfg.streams):
                # the fan-out's decode streams share their bytes
                sds = range(enc_s * pipe.fanout, (enc_s + 1) * pipe.fanout)
                pending.append((oracle.submit(pipe.stream_bytes(enc_s)),
                                k * (d + 1), d,
                                [(sd, [p[sd] for p in planes]) for sd in sds]))
        secs = 0.0
        for fut, n_frames, d, streams in pending:
            frames, t = fut.result()
            secs += t
            for sd, got in streams:
                _check(frames, n_frames, got,
                       f"extended dispatch {d} stream {sd}")
    if pipe.rc.scene_cuts < 1:
        raise AssertionError("gate extended: the rate controller saw no "
                             "scene cut")
    n = sum(p[1] for p in pending)
    res = dict(oracle=oracle.name, compared=sum(len(p[3]) for p in pending),
               decoded=n, decoded_mbs=n * (w // 16) * (h // 16),
               oracle_seconds=secs, seconds=time.perf_counter() - t0)
    if verbose:
        print(f"gate extended (CBR + scene cut + host ingest + fan-out 2): "
              f"{k * dispatches} frames x {pipe.s_dec} decode streams equal "
              f"to {oracle.name} after every dispatch "
              f"({res['seconds']:.1f} s)", file=sys.stderr)
    return res


if __name__ == "__main__":
    run_gate()
    run_gate_extended()
    print("gate: PASS", file=sys.stderr)
