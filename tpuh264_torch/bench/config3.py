"""BASELINE config 3 (constrained high: CABAC + 8x8 transform + 2
references + CBR) measured through the session path, and the flagship
GOP pipeline at 2 references.

Port of tools/bench_config3.py.  The GOP pipeline's device entropy is
CAVLC only, so the config-3 toolset runs through `EncoderSession`: the
codec interior (ME / MC with K1, the transforms with the 8x8 decision,
the intra-in-P scan K6, recon) runs on `device`; the CABAC pack is the
host's numpy coder, reported apart as `ms_entropy` so that it is not
counted as device time.  The stream is decoded by the gate's oracle
(`conformance.gate.decode_oracle`: libavcodec where it loads, else the
golden decoder), which must decode every frame to the encoder's
reconstruction.  Then `GOPDevicePipeline` at 2 references, CBR 4 Mbps,
the RTC preset: the config-3 subset the device entropy covers.

    python -m tpuh264_torch.bench.config3 [--width 1920 --height 1080]
        [--frames 12] [--device cuda]

Prints two JSON lines, `config3_session_encode` and
`flagship_multiref_cbr`, each naming the device.  With the golden
oracle (no libavcodec) the decode of 12 1080p frames takes minutes.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, Iterator, List

import numpy as np

from ..conformance import gate
from ..engine import CodecConfig, EncoderSession, sources
from ..engine.devpipe import GOPDevicePipeline
from .harness import device_info, psnr
from .headline import check_decode


def session_config(width: int, height: int, frames: int) -> CodecConfig:
    """Config 3 as tools/bench_config3.py sets it: CABAC, the 8x8
    transform, 2 references, CBR 4 Mbps, intra-in-P, one GOP."""
    return CodecConfig(width=width, height=height, qp=None,
                       bitrate=4_000_000, cabac=True, transform8x8=True,
                       num_ref_frames=2, gop_size=frames, intra_in_p=True)


def source(width: int, height: int, frames: int) -> List[tuple]:
    return [sources.yuv_frame(width, height, t, kind="rigid")
            for t in range(frames)]


def encode_frames(enc: EncoderSession, src) -> Iterator[Dict[str, object]]:
    """Encode each (y, u, v) of `src` through `enc`; yields per frame
    {"au" (stream 0's access unit), "idr", "qp", "wall_s" (the call),
    "timings" (`copy_ms`, `encode_ms`, `entropy_ms`), "recon" (stream 0's
    planes, cropped, read after the call)}."""
    for planes in src:
        t0 = time.perf_counter()
        out = enc.encode_frame_yuv(*planes)[0]
        wall = time.perf_counter() - t0
        recon = [p[0].cpu().numpy()[:a.shape[0], :a.shape[1]]
                 for p, a in zip(enc.recon, planes)]
        yield dict(au=out.data, idr=out.is_idr, qp=out.qp, wall_s=wall,
                   timings=out.timings, recon=recon)


def check_decoded(decoded, recons) -> None:
    """The oracle decoded every frame, each equal to the recon."""
    if len(decoded) != len(recons):
        raise AssertionError(f"config 3: the oracle decoded {len(decoded)} "
                             f"of {len(recons)} frames")
    for t, (d, r) in enumerate(zip(decoded, recons)):
        if not all(np.array_equal(np.asarray(a), b) for a, b in zip(d, r)):
            raise AssertionError(f"config 3: oracle decode != encoder "
                                 f"recon at frame {t}")


def session_line(frames: List[dict], decoded, src, oracle: str,
                 device: dict) -> Dict[str, object]:
    """The `config3_session_encode` line of the encoded `frames`
    (encode_frames' records) and the oracle's decode of their stream."""
    h, w = src[0][0].shape
    n = len(frames)
    wall = sum(f["wall_s"] for f in frames)
    mean = lambda k: sum(f["timings"][k] for f in frames) / n
    return {
        "metric": "config3_session_encode",
        "config": f"{w}x{h} CABAC+8x8+2ref CBR 4Mbps (session path)",
        "fps": round(n / wall, 2),
        "psnr_y": round(float(np.mean([psnr(d[0], s[0])
                                       for d, s in zip(decoded, src)])), 2),
        "kbps@30fps": round(sum(len(f["au"]) for f in frames) * 8 * 30 / n
                            / 1000),
        "ms_copy": round(mean("copy_ms"), 2),
        "ms_encode": round(mean("encode_ms"), 2),
        "ms_entropy": round(mean("entropy_ms"), 2),
        "oracle": oracle,
        "note": "ms_encode: device work, synchronised; ms_entropy: the "
                "CABAC pack on the host",
        "device": device,
    }


def measure_session(width: int, height: int, frames: int,
                    device="cuda") -> Dict[str, object]:
    """One warm-up frame on a throwaway session, then `frames` frames of
    "rigid" through a fresh one; decoded by the oracle, checked, and
    summarised as the `config3_session_encode` line."""
    cfg = session_config(width, height, frames)
    src = source(width, height, frames)
    EncoderSession(cfg, device=device).encode_frame_yuv(*src[0])
    enc = EncoderSession(cfg, device=device)
    done = list(encode_frames(enc, src))
    oracle = gate.oracle_name()
    decoded = gate.decode_oracle(b"".join(f["au"] for f in done), oracle)
    check_decoded(decoded, [f["recon"] for f in done])
    return session_line(done, decoded, src, oracle, device_info(device))


def flagship_multiref(width: int, height: int, duration_s: float = 5.0,
                      device="cuda") -> Dict[str, object]:
    """The `flagship_multiref_cbr` line: GOPDevicePipeline, 4 streams, 2
    references, CBR 4 Mbps, the RTC preset, gop 16, "rigid"; decoder DPB
    == encoder DPB at the end."""
    pipe = GOPDevicePipeline(
        CodecConfig(width=width, height=height, qp=None, bitrate=4_000_000,
                    streams=4, num_ref_frames=2, intra_in_p=False),
        gop_size=16, source_kind="rigid", device=device)
    snap = pipe.run(duration_s=duration_s)
    check_decode(pipe)
    return {
        "metric": "flagship_multiref_cbr",
        "config": f"{width}x{height} x4 streams CAVLC+2ref CBR 4Mbps "
                  f"(flagship)",
        "agg_fps": round(snap["frames_per_s_aggregate"], 2),
        "frames": snap["frames"],
        "psnr_y": round(snap["psnr_y"], 2),
        "qp": snap.get("qp"),
        "device": device_info(device),
    }


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--device", default="cuda",
                    help="where the codec runs (cpu for a run without a "
                         "card)")
    args = ap.parse_args(argv)
    print(json.dumps(measure_session(args.width, args.height, args.frames,
                                     args.device)), flush=True)
    print(json.dumps(flagship_multiref(args.width, args.height,
                                       device=args.device)))


if __name__ == "__main__":
    main()
