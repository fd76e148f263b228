"""Live stats view of a running App: the reference's performance-analyzer
panel as a terminal view.

Port of tools/live.py.  The reference renders windowed metrics every
second while the pipeline runs (app.js:694-721) and captures them into a
results table (app.js:737-789).  This drives the same App surface
(start / stop / get_stats) on `device`, repaints `render(stats)` at the
reference's 1 s tick and, on exit (or after --seconds), prints the
captured ticks as the results table, then the device.

    python -m tpuh264_torch.bench.live [--impl tpu_gop|tpu|libav]
        [--res 480p] [--streams 8] [--seconds 30] [--qp 32]
        [--device cuda]
"""

from __future__ import annotations

import argparse
import sys
import time

ROWS = (
    ("Input FPS", "input_fps", "{:.1f}"),
    ("Avg Output FPS (per stream)", "output_fps", "{:.1f}"),
    ("Avg encode ms/frame", "avg_encode_ms", "{:.2f}"),
    ("Avg copy ms/frame", "avg_copy_ms", "{:.2f}"),
    ("Total decode ms/s", "total_decode_ms", "{:.1f}"),
    ("Avg decode ms/frame", "avg_decode_ms", "{:.2f}"),
    ("Bitrate kbps", "bitrate_bps", lambda v: f"{v / 1e3:.0f}"),
    ("PSNR-Y dB", "psnr_y", "{:.2f}"),
    ("Dropped (capture)", "dropped_capture", "{:.0f}"),
)


def _fmt(spec, v):
    if v is None:
        return "-"
    try:
        return spec(v) if callable(spec) else spec.format(v)
    except (TypeError, ValueError):
        return str(v)


def render(stats: dict) -> str:
    width = 44
    lines = [
        f"tpu-h264 live  [{stats.get('impl', '?')}  "
        f"{stats.get('resolution', '?')} x{stats.get('streams', '?')} "
        f"threads={stats.get('threads', '?')}]",
        "-" * width,
    ]
    for label, key, spec in ROWS:
        lines.append(f"{label:<32}{_fmt(spec, stats.get(key)):>12}")
    lines.append("-" * width)
    return "\n".join(lines)


def captured_table(captured) -> str:
    """The results table of the captured ticks (app.js:801-824 analog)."""
    lines = ["captured ticks:",
             f"{'t':>4} {'in fps':>8} {'out fps':>8} {'enc ms':>8} "
             f"{'dec ms':>8} {'kbps':>8} {'psnr':>7}"]
    for i, s in enumerate(captured):
        lines.append(
            f"{i:>4} {s.get('input_fps', 0):>8.1f} "
            f"{s.get('output_fps', 0):>8.1f} "
            f"{s.get('avg_encode_ms', 0):>8.2f} "
            f"{s.get('avg_decode_ms', 0):>8.2f} "
            f"{(s.get('bitrate_bps', 0) or 0) / 1e3:>8.0f} "
            f"{s.get('psnr_y', 0):>7.2f}")
    return "\n".join(lines)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--impl", default="tpu_gop",
                    choices=("tpu_gop", "tpu", "libav"))
    ap.add_argument("--res", default="480p")
    ap.add_argument("--streams", type=int, default=8)
    ap.add_argument("--qp", type=int, default=32)
    ap.add_argument("--seconds", type=float, default=30.0)
    ap.add_argument("--device", default="cuda",
                    help="where the codec runs (cpu for a run without a "
                         "card)")
    args = ap.parse_args(argv)

    from ..engine import CodecConfig
    from ..engine.app import App
    from .harness import device_info

    dev = device_info(args.device)
    cfg = CodecConfig.from_params(
        {"res": args.res, "streams": str(args.streams), "qp": str(args.qp)}
    )
    cfg.intra_in_p = False
    app = App(cfg, impl=args.impl, source_kind="rigid", device=args.device)
    app.start()
    captured = []
    t0 = time.perf_counter()
    try:
        while time.perf_counter() - t0 < args.seconds:
            time.sleep(1.0)
            stats = app.get_stats()
            captured.append(stats)
            sys.stdout.write("\x1b[2J\x1b[H" + render(stats) + "\n")
            sys.stdout.flush()
    except KeyboardInterrupt:
        pass
    finally:
        app.stop()
    print("\n" + captured_table(captured))
    print(f"device: {dev['name']}, power limit {dev['power_limit']}")


if __name__ == "__main__":
    main()
