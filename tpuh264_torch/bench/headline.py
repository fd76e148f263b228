"""Headline benchmark of the port: encode + decode frames/s on one card at
1080p, after the conformance gate.

Port of bench.py.  It runs the gate (`conformance.gate.run_gate`: the GOP
pipeline at three shapes, its decode-from-bits held against an
independent decoder), then `GOPDevicePipeline.run` at the headline
configuration -- 1920x1080 x 4 streams, CBR 4 Mbps, the RTC preset
(`intra_in_p=False`), gop 32, the camera-like "rigid" source -- and at
the reference lab's operating point, 854x480 x 8 streams at CBR 1 Mbps.
Each configuration runs REPEATS times on one pipeline; the headline is
the median of its aggregate frames/s, with min, max, every run and the
frames each run counted beside it.  After each configuration the
decoder DPB must equal the encoder DPB.

    python -m tpuh264_torch.bench.headline [--device cuda]

stderr: the card, the gate, a stage line per configuration and the 480p
line; the last line of stdout is one JSON object with bench.py's keys
(`metric`, `value`, `unit`, `vs_baseline`, `gate`) plus `min`, `max`,
`runs`, `frames` and `device`.  Unlike bench.py, a failure -- of the
gate, of either configuration, or a missing card -- is not caught into
a result: the process prints bench.py's error line and exits 1.

The stages are means per dispatch of `run()`'s software-pipelined loop.
Eager PyTorch returns before the card finishes, so `ms_enc_dispatch` and
`ms_dec_dispatch` are the host's time to enqueue the encode and the
decode, not the card's; `ms_dev_wait` is the wait on the encode's event
before its download.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import traceback
from typing import Dict, List

import numpy as np

from ..conformance import gate as conformance_gate
from ..engine import CodecConfig
from ..engine.devpipe import GOPDevicePipeline
from .harness import device_info

BASELINE_FPS = 26.7  # the reference lab's screenshot figure, BASELINE.md
METRIC = "encode_decode_fps_1080p_gpu"
UNIT = "frames/s/gpu"
REPEATS = 3
GOP_SIZE = 32  # ~ the reference's fixed 30-frame IDR interval
SOURCE_KIND = "rigid"  # one rigid motion field: camera-like content

# (CodecConfig fields, run() duration_s, run() warmup dispatches)
HEADLINE = (dict(width=1920, height=1080, streams=4, qp=None,
                 bitrate=4_000_000, intra_in_p=False), 10.0, 3)
SECONDARY = (dict(width=854, height=480, streams=8, qp=None,
                  bitrate=1_000_000, intra_in_p=False), 6.0, 3)

# what each stage of run() times, for the stage line
STAGES = (
    ("ms_enc_dispatch", "host enqueue of the encode"),
    ("ms_wire", "retire: wait, download, NAL framing"),
    ("ms_dev_wait", "of which the wait on the encode's event"),
    ("ms_d2h", "of which the metadata + payload download"),
    ("ms_parse", "native CAVLC parse"),
    ("ms_dec_dispatch", "host enqueue of the decode"),
)


def gate(device="cuda") -> dict:
    """The on-hardware correctness gate, as bench.py runs it first:
    raises AssertionError where the card's decode differs from the
    oracle's."""
    return conformance_gate.run_gate(device=device)


def check_decode(pipe: GOPDevicePipeline) -> None:
    """The decoder DPB head equals the encoder's: each decode stream
    ss*fanout+fi against its encoded stream ss."""
    for name, dec, enc in zip("YUV", pipe.decoded_planes(),
                              pipe.encoder_planes()):
        if not np.array_equal(dec, np.repeat(enc, pipe.fanout, axis=0)):
            raise AssertionError(
                f"{name}: decoder DPB != encoder DPB after "
                f"{pipe.dispatch_index} dispatches")


def measure(cfg: CodecConfig, duration_s: float, warmup: int, repeats: int,
            device="cuda") -> List[Dict[str, float]]:
    """`repeats` calls of `run(duration_s, warmup)` on one
    GOPDevicePipeline (gop GOP_SIZE, source SOURCE_KIND), each ->
    {"frames_per_s_aggregate", "frames", "psnr_y", "qp", "stream_bytes",
    "ms_*" stages}; the decode is held to the encoder's reconstruction
    after the last."""
    pipe = GOPDevicePipeline(cfg, gop_size=GOP_SIZE, source_kind=SOURCE_KIND,
                             device=device)
    runs = []
    for _ in range(repeats):
        snap = pipe.run(duration_s=duration_s, warmup=warmup)
        if snap["frames"] <= 0 or not np.isfinite(snap["psnr_y"]):
            raise AssertionError(f"run() counted {snap['frames']} frames, "
                                 f"PSNR {snap['psnr_y']}")
        runs.append({k: v for k, v in snap.items()
                     if k in ("frames_per_s_aggregate", "frames", "psnr_y",
                              "qp", "stream_bytes") or k.startswith("ms_")})
    check_decode(pipe)
    return runs


def summary(runs: List[Dict[str, float]]) -> Dict[str, object]:
    """{"value": median, "min", "max", "runs" (each run's aggregate fps),
    "frames" (each run's count)}."""
    fps = [round(r["frames_per_s_aggregate"], 2) for r in runs]
    return {"value": statistics.median(fps), "min": min(fps),
            "max": max(fps), "runs": fps,
            "frames": [r["frames"] for r in runs]}


def median_run(runs: List[Dict[str, float]]) -> Dict[str, float]:
    """The run whose aggregate fps is the median (the lower of two)."""
    order = sorted(runs, key=lambda r: r["frames_per_s_aggregate"])
    return order[(len(order) - 1) // 2]


def stage_line(name: str, runs: List[Dict[str, float]]) -> str:
    """The median run's stages per dispatch, each labelled with what it
    times ("-" where the run retired one dispatch and timed none), its
    PSNR-Y, QP and the last frame's bytes of stream 0."""
    r = median_run(runs)
    stages = ", ".join(f"{what} ({k}) " + (f"{r[k]:.2f}" if k in r else "-")
                       for k, what in STAGES)
    return (f"{name} stages/dispatch ms (median run): {stages}; psnr "
            f"{r['psnr_y']:.2f} qp {r['qp']} bytes/frame "
            f"{r['stream_bytes']}")


def headline_line(runs, gate_result: str, device: dict) -> Dict[str, object]:
    """bench.py's last line for the headline runs, with the spread and
    the card."""
    s = summary(runs)
    return {"metric": METRIC, "value": s["value"], "unit": UNIT,
            "vs_baseline": round(s["value"] / BASELINE_FPS, 3),
            "gate": gate_result, "min": s["min"], "max": s["max"],
            "runs": s["runs"], "frames": s["frames"], "device": device}


def secondary_line(runs) -> Dict[str, object]:
    """bench.py's 480p line (stderr), with the spread."""
    r = median_run(runs)
    s = summary(runs)
    return {"agg_fps": s["value"], "min": s["min"], "max": s["max"],
            "runs": s["runs"], "frames": s["frames"],
            "psnr": round(r["psnr_y"], 2), "qp": r["qp"]}


def run(device="cuda") -> Dict[str, object]:
    """Gate, headline, secondary -> the headline line; raises on any
    failure."""
    dev = device_info(device)
    print(f"device: {dev['name']}, power limit {dev['power_limit']}",
          file=sys.stderr)
    gate(device)
    print("gate: PASS", file=sys.stderr)
    fields, dur, warm = HEADLINE
    cfg = CodecConfig(**fields)
    runs = measure(cfg, dur, warm, REPEATS, device)
    print(stage_line(f"{cfg.width}x{cfg.height} x {cfg.streams}", runs),
          file=sys.stderr)
    fields, dur, warm = SECONDARY
    cfg = CodecConfig(**fields)
    runs480 = measure(cfg, dur, warm, REPEATS, device)
    print(stage_line(f"{cfg.width}x{cfg.height} x {cfg.streams}", runs480),
          file=sys.stderr)
    print(f"ref-config {cfg.height}p x {cfg.streams} x "
          f"{cfg.bitrate / 1e6:g}Mbps:", secondary_line(runs480),
          file=sys.stderr)
    return headline_line(runs, "pass", dev)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="where the codec runs (cpu for a run without a "
                         "card)")
    args = ap.parse_args(argv)
    try:
        line = run(args.device)
    except Exception as e:  # the error line, then a failed exit
        traceback.print_exc()
        print(json.dumps({"metric": METRIC, "value": 0.0, "unit": UNIT,
                          "vs_baseline": 0.0,
                          "error": f"{type(e).__name__}: {e}"}))
        return 1
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
