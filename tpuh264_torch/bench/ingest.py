"""Host-frame ingest benchmark: the reference's own topology -- camera
frames copied in from the host, ONE stream encoded, the encoded stream
decoded N times (fan-out).

Port of tools/bench_ingest.py.  `GOPDevicePipeline(cfg,
source_kind="host", fanout=N)` takes each dispatch's host frames through
`pump_host_frames`: the copy (`last_copy_ms`: the memcpy into a reused
page-locked staging buffer plus the upload, synchronised), the encode,
the wire, the native parse and N decodes.  Fixed QP 32 by default, as in
the JAX tool (`--qp -1` for CBR at `--bitrate`).

The frames are made on the host before each dispatch and outside its
timing (the JAX tool's window includes making them): `encode_fps` is
frames over the summed `pump_host_frames` wall.  After the window the
decode streams must equal the encoder's reconstruction.

    python -m tpuh264_torch.bench.ingest [--width 854 --height 480
        --fanout 8 --seconds 10] [--device cuda]

Prints one JSON line, `host_ingest_fanout`, naming the device.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Dict, Optional

import numpy as np

from ..engine import CodecConfig, sources
from ..engine.devpipe import GOPDevicePipeline
from . import harness
from .headline import check_decode


def make_pipeline(width: int = 854, height: int = 480, fanout: int = 8,
                  qp: Optional[int] = 32, bitrate: int = 1_000_000,
                  device="cuda") -> GOPDevicePipeline:
    """One host-fed stream (RTC preset, gop 32) decoded `fanout` times;
    `qp` None for CBR at `bitrate`."""
    cfg = CodecConfig(width=width, height=height, streams=1, qp=qp,
                      bitrate=bitrate, intra_in_p=False)
    return GOPDevicePipeline(cfg, gop_size=32, source_kind="host",
                             fanout=fanout, device=device)


def host_batch(pipe: GOPDevicePipeline, t0: int,
               frame: Optional[Callable] = None):
    """The dispatch's frames t0 .. t0 + K - 1 from `frame(t)` -> (y, u, v)
    (by default `sources.yuv_frame`), as [K, 1, H, W] planes."""
    cfg = pipe.config
    frame = frame or (lambda t: sources.yuv_frame(cfg.width, cfg.height, t))
    fr = [frame(t0 + i) for i in range(pipe.FRAMES_PER_DISPATCH)]
    return tuple(np.stack([f[i] for f in fr])[:, None] for i in range(3))


def measure(pipe: GOPDevicePipeline, seconds: float = 10.0,
            warmup: int = 2) -> Dict[str, object]:
    """`warmup` dispatches, then dispatches until `seconds` of
    `pump_host_frames` wall; the source clock continues from the pipe's.
    Returns the `host_ingest_fanout` line."""
    k = pipe.FRAMES_PER_DISPATCH
    t = pipe.dispatch_index * k + pipe.time_offset
    for _ in range(warmup):
        pipe.pump_host_frames(*host_batch(pipe, t))
        t += k
    n, busy, copy_ms, last = 0, 0.0, [], None
    while busy < seconds or n == 0:
        last = host_batch(pipe, t)
        t0 = time.perf_counter()
        pipe.pump_host_frames(*last)
        busy += time.perf_counter() - t0
        copy_ms.append(pipe.last_copy_ms)
        t += k
        n += k
    check_decode(pipe)
    # quality: decode stream 0 (the first fan-out copy) against the last
    # source frame fed
    cfg = pipe.config
    psnr = harness.psnr(pipe.decoded_planes()[0][0][:cfg.height, :cfg.width],
                        last[0][-1, 0])
    return {
        "metric": "host_ingest_fanout",
        "config": f"{cfg.width}x{cfg.height} x1 enc -> x{pipe.fanout} dec",
        "encode_fps": round(n / busy, 2),
        "decode_fps_aggregate": round(n * pipe.fanout / busy, 2),
        "copy_ms_per_frame": round(float(np.mean(copy_ms)) / k, 2),
        "copy_ms_per_dispatch": round(float(np.mean(copy_ms)), 2),
        "psnr_y": round(psnr, 2),
        "qp": cfg.qp if cfg.qp is not None else pipe.rc.current_qp(),
        "frames": n,
        "device": harness.device_info(pipe.device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=854)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--fanout", type=int, default=8)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--qp", type=int, default=32,
                    help="fixed QP; -1 for CBR at --bitrate")
    ap.add_argument("--bitrate", type=int, default=1_000_000)
    ap.add_argument("--device", default="cuda",
                    help="where the codec runs (cpu for a run without a "
                         "card)")
    args = ap.parse_args(argv)
    pipe = make_pipeline(args.width, args.height, args.fanout,
                         None if args.qp < 0 else args.qp, args.bitrate,
                         args.device)
    print(json.dumps(measure(pipe, args.seconds)))


if __name__ == "__main__":
    main()
