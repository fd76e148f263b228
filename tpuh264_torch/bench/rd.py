"""Clip RD table: ours against libx264 at matched bitrate.

Port of tools/bench_rd.py.  Clips go through the Y4M file path
(`engine.sources.write_y4m` / `read_y4m`), the route recorded clips
take; without --y4m the clips are the deterministic camera-like
generator's (`sources.clip_frames`).  One markdown table per clip: the
x264 anchors (veryfast / zerolatency, through libavcodec) and our
closest-rate fixed-QP point (`quality.our_rd_point`, our encoder on
`device`), with the PSNR delta at matched bitrate.  Both streams are
decoded by libavcodec.

libx264 and libavcodec run on the host and are required: where either
does not load (the card machine has neither) the tool stops with an
error naming it.  Our bytes do not depend on the device, so on the CPU
the dB figures equal the JAX tool's.

    python -m tpuh264_torch.bench.rd [--frames 16] [--y4m a.y4m ...]
        [--sizes 854x480,1280x720] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

import numpy as np

from ..conformance import libav_available
from ..conformance.ffenc import encoder_available
from ..engine import sources
from . import quality
from .harness import device_info

QPS = (22, 25, 28, 31, 34, 37, 40, 43, 46, 49)
ANCHORS = (400_000, 1_000_000, 2_500_000)


def require_libraries() -> None:
    """Raise unless libx264 and libavcodec both load."""
    missing = [name for name, ok in (("libx264", encoder_available()),
                                     ("libavcodec", libav_available()))
               if not ok]
    if missing:
        raise RuntimeError(f"the RD table needs {' and '.join(missing)} on "
                           f"this host, which did not load")


def rd_table(name: str, frames, qps, anchors, fps=30, *, device="cuda"):
    """Print the clip's table; returns the rate-matched (x264, ours)
    rows (ours within 0.75-1.33x of the anchor's rate)."""
    ours = [quality.our_rd_point(frames, qp, gop=30, fps=fps, device=device)
            for qp in qps]
    rows = []
    for bitrate in anchors:
        x = quality.x264_rd_point(
            [tuple(np.asarray(p, np.uint8) for p in f) for f in frames],
            bitrate, fps=fps,
        )
        best = min(ours, key=lambda o: abs(o["bits_per_s"]
                                           - x["bits_per_s"]))
        rows.append((x, best))
    h, w = frames[0][0].shape
    print(f"\n### {name} ({w}x{h}, {len(frames)} frames)\n")
    print("| x264 kbps | x264 PSNR | ours QP | ours kbps | ours PSNR |"
          " delta dB |")
    print("|---|---|---|---|---|---|")
    for x, o in rows:
        ratio = o["bits_per_s"] / max(x["bits_per_s"], 1)
        tag = "" if 0.75 <= ratio <= 1.33 else " (UNMATCHED rate)"
        print(f"| {x['bits_per_s']/1000:.0f} | {x['psnr']:.2f} "
              f"| {o['qp']} | {o['bits_per_s']/1000:.0f} "
              f"| {o['psnr']:.2f} | {o['psnr']-x['psnr']:+.2f}{tag} |")
    sys.stdout.flush()
    return [
        (x, o) for x, o in rows
        if 0.75 <= o["bits_per_s"] / max(x["bits_per_s"], 1) <= 1.33
    ]


def clips(frames: int, sizes: str, y4m, tmp: str):
    """[(name, frames)]: the --y4m files, else "meeting" and "pan_detail"
    at each size, written to and read back from a Y4M file under
    `tmp`."""
    if y4m:
        return [(os.path.basename(p), sources.read_y4m(p, frames))
                for p in y4m]
    out = []
    for wh in sizes.split(","):
        w, h = (int(x) for x in wh.split("x"))
        for kind in ("meeting", "pan_detail"):
            fr = sources.clip_frames(w, h, frames, kind)
            p = os.path.join(tmp, f"clip_{kind}_{w}x{h}.y4m")
            sources.write_y4m(p, [tuple(np.asarray(x, np.uint8) for x in f)
                                  for f in fr])
            out.append((f"{kind}.y4m", sources.read_y4m(p)))
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--y4m", nargs="*", default=None,
                    help="real clips; default: generated camera-like "
                         "clips through the same Y4M file path")
    ap.add_argument("--sizes", default="854x480,1280x720")
    ap.add_argument("--device", default="cuda",
                    help="where our encoder runs (cpu for a run without a "
                         "card)")
    args = ap.parse_args(argv)
    dev = device_info(args.device)
    print(f"device: {dev['name']}, power limit {dev['power_limit']}")
    require_libraries()
    deltas = []
    with tempfile.TemporaryDirectory(prefix="tpuh264_rd_") as tmp:
        for name, frames in clips(args.frames, args.sizes, args.y4m, tmp):
            rows = rd_table(name, frames, QPS, ANCHORS, device=args.device)
            deltas += [o["psnr"] - x["psnr"] for x, o in rows]
    if not deltas:
        raise RuntimeError("no anchor had a rate-matched point of ours")
    print(f"\nmean delta over {len(deltas)} rate-MATCHED points "
          f"(within 33%): {np.mean(deltas):+.2f} dB "
          f"(min {min(deltas):+.2f})")


if __name__ == "__main__":
    main()
