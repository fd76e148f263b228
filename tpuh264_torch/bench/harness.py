"""Automated benchmark matrix on a PyTorch device.

Port of tpuh264/bench/harness.py, the reference's automation harness
(reference/scripts/automation.js:70-158): sweep configurations
(resolution x streams x qp/bitrate x implementation x entropy threads),
run each for a fixed measurement window after a warm-up (the 5 s window
+ cool-down protocol, automation.js:82-86), and emit a machine-readable
results table with PSNR and bitrate columns, which the reference lacks.

The implementations (the `impl` axis): "tpu_gop" (the decode-from-bits
GOP pipeline, `engine.devpipe.GOPDevicePipeline`), "tpu" (the session
`Pipeline`: 1 encoder -> ring -> N decoders) and "libav" (the same
`Pipeline` on libx264 / libavcodec).  Everything runs on `device`, the
card unless the caller names another.

Eager PyTorch returns before the card finishes, and the GOP pipeline's
`ms_dev_wait` reads 0.0 there: its "tpu_gop" `avg_encode_ms` is the
host's time to enqueue the encode, not the card's time.  The rates
(`pipeline_fps`, `frames_per_s_aggregate`) count frames that were
encoded, packed, parsed back and reconstructed.
"""

from __future__ import annotations

import json
import os
import subprocess
import time
from typing import Dict, Iterable, List, Optional

import numpy as np
import torch

from ..engine import CodecConfig, Pipeline, sources
from ..engine.config import RESOLUTIONS


def psnr(a: np.ndarray, b: np.ndarray) -> float:
    mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
    return 99.0 if mse == 0 else float(10 * np.log10(255.0**2 / mse))


def machine_info() -> Dict[str, object]:
    """hardwareConcurrency/deviceMemory analog (app.js:87-96) + the card:
    torch's backend, card count and name, and nvidia-smi's name and power
    limit of the first card (the limit sets its speed under load)."""
    info: Dict[str, object] = {"cpus": os.cpu_count()}
    if not torch.cuda.is_available():
        info["backend"] = "none"
        return info
    info["backend"] = "cuda"
    info["devices"] = torch.cuda.device_count()
    info["device_kind"] = torch.cuda.get_device_name(0)
    res = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    info["card"] = res.stdout.strip().splitlines()[0]
    return info


def device_info(device="cuda") -> Dict[str, object]:
    """What a measurement ran on, for the line it prints: {"name",
    "power_limit"} -- torch's name of the card and nvidia-smi's power
    limit of it (the limit sets its speed under load), or "cpu" and None.
    A CUDA device where there is no card raises, as the pipelines do."""
    from ..engine.devpipe import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    idx = torch.cuda.current_device() if dev.index is None else dev.index
    # nvidia-smi counts the machine's cards, torch the visible ones
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    card = visible.split(",")[idx].strip() if visible else str(idx)
    res = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True)
    return {"name": torch.cuda.get_device_name(idx),
            "power_limit": res.stdout.strip().splitlines()[0]}


def _run_single_gop(config: CodecConfig, duration_s: float,
                    warmup_frames: int, device) -> Dict[str, float]:
    """Measure the decode-from-bits GOP pipeline (the headline path
    bench.py drives), with the fields of the session rows."""
    from ..engine.devpipe import GOPDevicePipeline

    gop = max(4, config.gop_size // 4 * 4)
    pipe = GOPDevicePipeline(config, gop_size=gop, source_kind="rigid",
                             device=device)
    t0 = time.perf_counter()
    snap = pipe.run(duration_s=duration_s, warmup=warmup_frames)
    wall = time.perf_counter() - t0
    k = pipe.FRAMES_PER_DISPATCH * config.streams  # frames per dispatch
    fps = config.fps
    return {
        "config": {
            "res": config.resolution_name,
            "width": config.width, "height": config.height,
            "streams": config.streams, "qp": snap.get("qp"),
            "bitrate": config.bitrate,
            "slice_mode": config.slice_mode,
            "impl": "tpu_gop", "threads": config.threads,
        },
        "frames": snap["frames"],
        "wall_s": wall,
        "pipeline_fps": snap["pipeline_fps"],
        "frames_per_s_aggregate": snap["frames_per_s_aggregate"],
        "avg_encode_ms": (snap.get("ms_enc_dispatch", 0.0)
                          + snap.get("ms_dev_wait", 0.0)) / k,
        "avg_entropy_ms": (snap.get("ms_d2h", 0.0)
                           + snap.get("ms_parse", 0.0)) / k,
        "avg_decode_ms": snap.get("ms_dec_dispatch", 0.0) / k,
        "bitrate_bps": snap.get("stream_bytes", 0) * 8 * fps,
        "psnr_y": snap["psnr_y"],
    }


def run_single(
    config: CodecConfig,
    duration_s: float = 5.0,
    warmup_frames: int = 3,
    max_frames: Optional[int] = None,
    impl: str = "tpu",
    *,
    device="cuda",
) -> Dict[str, float]:
    """Measure one config on `device`: warm-up, then a fixed window."""
    if impl == "tpu_gop":
        return _run_single_gop(config, duration_s, warmup_frames, device)
    pipe = Pipeline(config, impl=impl, device=device)
    for _ in range(warmup_frames):
        pipe.pump_frame()
    pipe.stats.snapshot(config.streams)

    t0 = time.perf_counter()
    stats = pipe.run(duration_s=duration_s, max_frames=max_frames)
    wall = time.perf_counter() - t0

    # quality: PSNR of stream 0's last output vs its source frame
    y, u, v = sources.yuv_frame(config.width, config.height,
                                pipe.frame_index - 1)
    out = pipe.last_outputs.get(0)
    stats.update(
        {
            "config": {
                "res": config.resolution_name,
                "width": config.width,
                "height": config.height,
                "streams": config.streams,
                "qp": config.qp,
                "bitrate": config.bitrate,
                "slice_mode": config.slice_mode,
                "impl": pipe.impl,
                "threads": config.threads,
            },
            "wall_s": wall,
            "pipeline_fps": stats["frames"] / wall,
            "frames_per_s_aggregate": stats["frames"] * config.streams / wall,
            "psnr_y": psnr(out[0], y) if out is not None else float("nan"),
        }
    )
    return stats


def run_matrix(
    resolutions: Iterable[str] = ("360p", "480p", "720p", "1080p"),
    streams: Iterable[int] = (1, 4, 8),
    qps: Iterable[Optional[int]] = (30,),
    duration_s: float = 5.0,
    cooldown_s: float = 1.0,
    max_frames: Optional[int] = None,
    impls: Iterable[str] = ("tpu",),
    threads: Iterable[int] = (0,),
    *,
    device="cuda",
) -> List[Dict[str, float]]:
    """The reference's checkbox test matrix (automation.js:110-153);
    `impls` is its implementation axis (wasm vs webcodecs,
    automation.js:120-153) -- here "tpu", "tpu_gop" and "libav";
    `threads` is its worker-thread axis (automation.js:137-153) -- here
    the native entropy stage's thread-pool size (0 = default policy)."""
    results = []
    for impl in impls:
        for th in threads:
            for res in resolutions:
                w, h = RESOLUTIONS[res]
                for s in streams:
                    for qp in qps:
                        cfg = CodecConfig(width=w, height=h, streams=s,
                                          qp=qp, threads=th)
                        results.append(run_single(
                            cfg, duration_s=duration_s,
                            max_frames=max_frames, impl=impl, device=device,
                        ))
                        time.sleep(cooldown_s)
    return results


def render_table(results: List[Dict[str, float]]) -> str:
    """Results table analog (app.js:801-824), as text."""
    cols = [
        ("impl", lambda r: r["config"].get("impl", "tpu")),
        ("threads", lambda r: r["config"].get("threads", 0)),
        ("res", lambda r: r["config"]["res"]),
        ("streams", lambda r: r["config"]["streams"]),
        ("qp", lambda r: r["config"]["qp"]),
        ("pipe fps", lambda r: f"{r['pipeline_fps']:.1f}"),
        ("agg fps", lambda r: f"{r['frames_per_s_aggregate']:.1f}"),
        ("enc ms", lambda r: f"{r['avg_encode_ms']:.2f}"),
        ("entropy ms", lambda r: f"{r['avg_entropy_ms']:.2f}"),
        ("dec ms", lambda r: f"{r['avg_decode_ms']:.2f}"),
        ("kbps", lambda r: f"{r['bitrate_bps'] / 1e3:.0f}"),
        ("psnr", lambda r: f"{r['psnr_y']:.1f}"),
    ]
    lines = ["  ".join(f"{name:>10}" for name, _ in cols)]
    for r in results:
        lines.append("  ".join(f"{str(fn(r)):>10}" for _, fn in cols))
    return "\n".join(lines)


def main() -> None:
    import argparse

    p = argparse.ArgumentParser(description="tpu-h264 benchmark matrix")
    p.add_argument("--resolutions", default="360p,480p")
    p.add_argument("--streams", default="1,4")
    p.add_argument("--qps", default="30")
    p.add_argument("--duration", type=float, default=5.0)
    p.add_argument("--impls", default="tpu",
                   help="comma list: tpu,tpu_gop,libav (A/B like "
                        "automation.js)")
    p.add_argument("--threads", default="0",
                   help="comma list of entropy-thread counts "
                        "(automation.js thread axis; 0 = default)")
    p.add_argument("--charts", default="",
                   help="path prefix: write the reference's SVG chart "
                        "families (automation.js:119-153)")
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default="cuda",
                   help="where the codec runs (cpu for a run without a "
                        "card)")
    args = p.parse_args()
    results = run_matrix(
        resolutions=args.resolutions.split(","),
        streams=[int(x) for x in args.streams.split(",")],
        qps=[int(x) for x in args.qps.split(",")],
        duration_s=args.duration,
        impls=args.impls.split(","),
        threads=[int(x) for x in args.threads.split(",")],
        device=args.device,
    )
    if args.charts:
        from .charts import render_charts

        for path in render_charts(results, args.charts):
            print(f"chart: {path}")
    if args.json:
        print(json.dumps({"machine": machine_info(), "results": results}))
    else:
        print(machine_info())
        print(render_table(results))


if __name__ == "__main__":
    main()
