#!/usr/bin/env python3
"""Time BASELINE config 3's session path per frame, in turns with other
trees.

    python3 tools/time_config3.py [--parent DIR ...] [--frames N]
                                  [--rounds N] [--width W --height H]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
Each turn is a process of its own, started in a tree's root (this
checkout, or DIR: another tree, e.g. `git archive <commit>` unpacked
into a git-ignored directory), that imports that tree's package: config
3's `EncoderSession` (`bench.config3.session_config`: CABAC, the 8x8
transform, 2 references, CBR 4 Mbps, intra-in-P, one GOP) encodes N
frames of "rigid" (chip_smoke.py phase 15's), and a `DecoderSession`
decodes each access unit, which must equal the encoder's recon.  Per
frame it prints the session's `encode_ms` and `entropy_ms` (the host
CABAC pack), the decode's wall ms (the host CABAC parse included), and
the turn's K9 / K10 launches (with this checkout's routers, those of
their t8 routes).  A round runs the parents, this, this, the parents;
the card's name and power limit head the output.  A turn that fails
ends the run non-zero.
"""

import argparse
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

# one turn, run in a tree's root: w, h, n from argv
TURN = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, ".")
from tpuh264_torch.bench import config3
from tpuh264_torch.engine import DecoderSession, EncoderSession
from tpuh264_torch.kernels import pframe
w, h, n = map(int, sys.argv[1:4])
enc = EncoderSession(config3.session_config(w, h, n), device="cuda")
dec = DecoderSession(device="cuda")
src = config3.source(w, h, n)
fns = (pframe._inter_encode, pframe._inter_decode)
base = [(f.launches, getattr(f, "t8_launches", 0)) for f in fns]
rows = []
for t, f in enumerate(config3.encode_frames(enc, src)):
    t0 = time.perf_counter()
    got = dec.decode(f["au"])
    ms = (time.perf_counter() - t0) * 1e3
    ok = got is not None and all(np.array_equal(a, r)
                                 for a, r in zip(got, f["recon"]))
    if not ok or dec._general:
        sys.exit(f"frame {t}: decoder != recon (general {dec._general})")
    tm = f["timings"]
    rows.append(dict(frame=t, idr=f["idr"], qp=f["qp"],
                     encode_ms=tm["encode_ms"], entropy_ms=tm["entropy_ms"],
                     decode_ms=ms))
k = [(f.launches - a, getattr(f, "t8_launches", 0) - b)
     for f, (a, b) in zip(fns, base)]
print("CONFIG3_TURN " + json.dumps(dict(rows=rows, k9=k[0], k10=k[1])))
"""


def turn(root: str, w: int, h: int, n: int) -> dict:
    """One turn in the tree at `root`: its CONFIG3_TURN result."""
    res = subprocess.run([sys.executable, "-c", TURN, str(w), str(h),
                          str(n)], cwd=root, capture_output=True, text=True,
                         timeout=900)
    if res.returncode != 0:
        cs.fail(f"config 3 turn in {root}: {res.stderr[-2000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("CONFIG3_TURN ")][-1]
    return json.loads(line.split(" ", 1)[1])


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="the root of another tree, e.g. from git archive")
    ap.add_argument("--frames", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    print(card)
    trees = [("this checkout", ROOT)] + [(f"tree {d}", os.path.abspath(d))
                                         for d in a.parent]
    order = trees[:0:-1] + trees[:1] * 2 + trees[1:]
    for rnd in range(a.rounds):
        for name, root in order:
            got = turn(root, a.width, a.height, a.frames)
            for r in got["rows"]:
                print(f"round {rnd}: {name}: frame {r['frame']} (QP "
                      f"{r['qp']}{', IDR' if r['idr'] else ''}): encode "
                      f"{r['encode_ms']:.1f} ms, entropy "
                      f"{r['entropy_ms']:.1f} ms, decode "
                      f"{r['decode_ms']:.1f} ms [{card}]")
            p = [r for r in got["rows"] if not r["idr"]]
            mean = lambda k: sum(r[k] for r in p) / max(len(p), 1)
            print(f"round {rnd}: {name}: mean of {len(p)} P frames: encode "
                  f"{mean('encode_ms'):.1f} ms, entropy "
                  f"{mean('entropy_ms'):.1f} ms, decode "
                  f"{mean('decode_ms'):.1f} ms; K9 (launches, t8 route) "
                  f"{got['k9']}, K10 {got['k10']} [{card}]")


if __name__ == "__main__":
    main()
