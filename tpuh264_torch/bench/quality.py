"""Rate-distortion measurement: PSNR vs bitrate, ours vs libx264.

Port of tpuh264/bench/quality.py, BASELINE.json's quality metric ("PSNR
vs reference encoder at matched bitrate").  The external anchor is
libx264 driven through libavcodec (conformance.ffenc); both codecs'
outputs are decoded by libavcodec, so the measurement chain is
externally validated end to end.  Our encoder runs on `device`, the card
unless the caller names another; libx264 and libavcodec run on the host.
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np

from ..conformance import decode_with_libav
from ..conformance.ffenc import encode_with_x264, encoder_available
from ..engine import CodecConfig, EncoderSession, sources


def psnr_yuv(dec, src) -> float:
    """Combined-plane PSNR (6/8 Y + 1/8 U + 1/8 V convention)."""
    def p(a, b):
        mse = np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2)
        return 99.0 if mse == 0 else 10 * np.log10(255.0**2 / mse)

    return (6 * p(dec[0], src[0]) + p(dec[1], src[1]) + p(dec[2], src[2])) / 8


def sequence_psnr(decoded, frames) -> float:
    return float(np.mean([psnr_yuv(d, f) for d, f in zip(decoded, frames)]))


def make_sequence(width: int, height: int, n: int, seed: int = 0):
    return [sources.yuv_frame(width, height, t, seed=seed) for t in range(n)]


def our_rd_point(frames, qp: int, gop: int = 30, fps: int = 30, *,
                 device="cuda") -> Dict[str, float]:
    """Encode with our engine at fixed QP; returns {bits_per_s, psnr}."""
    h, w = frames[0][0].shape
    cfg = CodecConfig(width=w, height=h, qp=qp, gop_size=gop, fps=fps,
                      deblock=True)
    enc = EncoderSession(cfg, device=device)
    stream = bytearray()
    for y, u, v in frames:
        stream += enc.encode_frame_yuv(y, u, v)[0].data
    decoded = decode_with_libav(bytes(stream))
    return {
        "qp": qp,
        "bytes": len(stream),
        "bits_per_s": len(stream) * 8 * fps / len(frames),
        "psnr": sequence_psnr(decoded, frames),
    }


def x264_rd_point(frames, bitrate: int, fps: int = 30) -> Dict[str, float]:
    u8 = [
        tuple(np.asarray(p, np.uint8) for p in f) for f in frames
    ]
    stream = encode_with_x264(u8, bitrate=bitrate, fps=fps)
    decoded = decode_with_libav(stream)
    return {
        "bitrate_req": bitrate,
        "bytes": len(stream),
        "bits_per_s": len(stream) * 8 * fps / len(frames),
        "psnr": sequence_psnr(decoded, frames),
    }


def compare_at_matched_bitrate(
    width: int = 640,
    height: int = 360,
    n_frames: int = 10,
    qps: Sequence[int] = (20, 24, 28, 32, 36, 40, 44),
    anchors: Sequence[int] = (500_000, 1_000_000, 2_000_000),
    *,
    device="cuda",
) -> List[Dict[str, float]]:
    """For each x264 anchor bitrate, find our closest-rate QP and report
    the PSNR delta (positive = we win)."""
    frames = make_sequence(width, height, n_frames)
    ours = [our_rd_point(frames, qp, device=device) for qp in qps]
    rows = []
    for target in anchors:
        x = x264_rd_point(frames, target)
        best = min(ours, key=lambda o: abs(o["bits_per_s"] - x["bits_per_s"]))
        rows.append(
            {
                "anchor_bps": x["bits_per_s"],
                "x264_psnr": x["psnr"],
                "our_qp": best["qp"],
                "our_bps": best["bits_per_s"],
                "our_psnr": best["psnr"],
                "delta_psnr": best["psnr"] - x["psnr"],
            }
        )
    return rows


def main():
    import argparse

    p = argparse.ArgumentParser(description="RD: ours vs libx264")
    p.add_argument("--device", default="cuda",
                   help="where our encoder runs (cpu for a run without a "
                        "card)")
    args = p.parse_args()
    if not encoder_available():
        print("libx264 unavailable")
        return
    rows = compare_at_matched_bitrate(
        width=320, height=192, n_frames=8,
        qps=(22, 26, 30, 34, 38, 42),
        anchors=(250_000, 500_000, 1_000_000),
        device=args.device,
    )
    print(f"{'anchor kbps':>12} {'x264 dB':>9} {'our qp':>7} "
          f"{'our kbps':>9} {'our dB':>7} {'delta':>7}")
    for r in rows:
        print(
            f"{r['anchor_bps'] / 1e3:>12.0f} {r['x264_psnr']:>9.2f} "
            f"{r['our_qp']:>7} {r['our_bps'] / 1e3:>9.0f} "
            f"{r['our_psnr']:>7.2f} {r['delta_psnr']:>+7.2f}"
        )


if __name__ == "__main__":
    main()
