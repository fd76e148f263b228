#!/usr/bin/env python3
"""Time the port's intra encode kernel (K6,
tpuh264_torch/csrc/intra16_enc.cu) at chip_smoke.py phase 2's D3 and D4
inputs and its Intra_4x4 route's, optionally in turns with another build
of it.

    python3 tools/time_intra16.py [--other SRC.cu [--entry D3,D4[,I44]]]
                                  [--parent DIR] [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are the 1920x1080 x 4 "rigid" I frame (D3, from its uint8
planes and from int32 ones) and the 854x480 x 8 intra-in-P P frame's own
arguments of its intra-in-P scan (D4), as phase 2 builds them.  SRC.cu
is a K6 source with the two C entries of csrc/intra16_enc.cu (e.g. an
earlier one: `git show <commit>:tpuh264_torch/csrc/intra16_enc.cu`, put
in a git-ignored directory), named by --entry; it is built with nvcc
into tpuh264_torch/build/ as a library of its own and called through the
same wrappers (`kernels/iframe.py` `encode_iframe_scan`, `kernels/
pframe.py` `_intra_in_p_scan`).  Every build is first held equal to the
plain versions.  Each round times other, this, this, other (CUDA events
behind a device sleep, 20 calls: chip_smoke.timed) and prints each
reading's ms, its share of the bytes bound (chip_smoke.k6_bytes) and its
SM cycles a MB column at the clock read under load, beside the card's
name and power limit.  Then this checkout's Intra_4x4 route (`intra44`,
a build of its own has none to compare) on that I frame at QP 30 and on
chip_smoke.py phase 11's IDR (the 854x480 x 8 "meeting" session's own
int32 planes, QP 34), each first held equal to the plain version and
timed beside it once: ms, bound share (chip_smoke.k6_i44_bytes), cycles
a MB column, the Intra_4x4 share of the MBs, plain ms; in the rounds
the route also in turns with another build that has the entry.  With
--parent DIR (another tree, e.g. `git archive <commit>` unpacked into a
git-ignored directory), chip_smoke.py phase 11's session in turns with
it (parent, this, this, parent; each turn a process of its own in its
tree's root, that tree's package): the 854x480 x 8 "meeting" clip's 10
frames from RGBA through an `intra44` EncoderSession (deblock, gop 8,
CBR 1 Mbps), each frame's `encode_ms` and `entropy_ms` (the IDRs are
frames 0 and 8), and one I scan of frame 0 at QP 34 fenced without and
with the Intra_4x4 trial, twice each.  Last, ptxas's registers, spills
and shared memory of each build, each template instance apart.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ENTRIES = ("th264_intra16_encode_rows", "th264_intra16_in_p_rows",
           "th264_intra44_encode_rows")


class _OtherLib:
    """The kernel library with another build's entries in K6's place."""

    def __init__(self, lib, fns):
        self._lib = lib
        for name, fn in fns.items():
            setattr(self, name, fn)

    def __getattr__(self, name):
        return getattr(self._lib, name)


def build_other(src: str, entries):
    """`src` built into tpuh264_torch/build/ as its own library: (D3, D4,
    Intra_4x4) calls of the wrappers with that library's `entries` (the
    Intra_4x4 call None where `entries` names no third) in K6's place."""
    from tpuh264_torch.kernels import cuda_lib, iframe, pframe

    out = os.path.join(cuda_lib.BUILD, "libintra16_other.so")
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {src}: {res.stdout}{res.stderr}")
    so = ctypes.CDLL(out)
    real = cuda_lib.load()
    fns = {}
    for mine, theirs in zip(ENTRIES, entries):
        fn = fns[mine] = getattr(so, theirs)
        fn.argtypes = getattr(real, mine).argtypes
        fn.restype = ctypes.c_int
    other = _OtherLib(real, fns)

    def through(router, name, **fixed):
        if name not in fns:
            return None

        def call(*args, **kw):
            saved = cuda_lib.load
            cuda_lib.load = lambda: other
            try:
                return router(*args, **fixed, **kw)
            finally:
                cuda_lib.load = saved
        return call

    return (through(iframe.encode_iframe_scan, ENTRIES[0]),
            through(pframe._intra_in_p_scan, ENTRIES[1]),
            through(iframe.encode_iframe_scan, ENTRIES[2], intra44=True))


# one session turn, run in a tree's root: the RGBA frames' .npy from argv
TURN = r"""
import json, sys, time
import numpy as np
sys.path.insert(0, ".")
import torch
from tpuh264_torch.engine import CodecConfig, EncoderSession
from tpuh264_torch.engine.encoder import _pad_multiple
from tpuh264_torch.kernels import color, iframe
frames = np.load(sys.argv[1])
n, s, h, w, _ = frames.shape
enc = EncoderSession(CodecConfig(width=w, height=h, streams=s, intra44=True,
                                 deblock=True, gop_size=8,
                                 bitrate=1_000_000), device="cuda")
rows = []
for t, rgba in enumerate(frames):
    out = enc.encode_frame(rgba)
    tm = out[0].timings
    rows.append(dict(frame=t, idr=out[0].is_idr, encode_ms=tm["encode_ms"],
                     entropy_ms=tm["entropy_ms"]))
yuv = color.rgba_to_yuv420(torch.from_numpy(
    _pad_multiple(frames[0], 16, axes=(1, 2))).to("cuda"))
scan = {"without": [], "with": []}
for on in (False, True, True, False):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    iframe.encode_iframe_scan(*yuv, 34, intra44=on)
    torch.cuda.synchronize()
    scan["with" if on else "without"].append(
        (time.perf_counter() - t0) * 1e3)
print("I44_TURN " + json.dumps(dict(rows=rows, scan=scan)))
"""


def session_turn(root: str, frames: str) -> dict:
    """One phase-11 session turn in the tree at `root`: its I44_TURN."""
    res = subprocess.run([sys.executable, "-c", TURN, frames], cwd=root,
                         capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        cs.fail(f"session turn in {root}: {res.stderr[-2000:]}")
    line = [ln for ln in res.stdout.splitlines()
            if ln.startswith("I44_TURN ")][-1]
    return json.loads(line.split(" ", 1)[1])


def sessions(parent: str, rounds: int, dev, card: str) -> None:
    """Phase 11's session, this checkout in turns with the tree at
    `parent` (the clip made once, here, and handed to every turn)."""
    import numpy as np

    trees = [("parent", os.path.abspath(parent)), ("this checkout", ROOT)]
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "meeting.npy")
        np.save(path, np.stack(cs.clip_rgba(dev, 854, 480, 10, 8)))
        for rnd in range(rounds):
            for name, root in trees + trees[::-1]:
                got = session_turn(root, path)
                for r in got["rows"]:
                    print(f"round {rnd}: session {name}: frame {r['frame']}"
                          f"{' (IDR)' if r['idr'] else ''}: encode "
                          f"{r['encode_ms']:.1f} ms, entropy "
                          f"{r['entropy_ms']:.1f} ms [{card}]")
                sc = {k: [round(x, 2) for x in v]
                      for k, v in got["scan"].items()}
                print(f"round {rnd}: session {name}: one I scan (QP 34, "
                      f"fenced) without / with the Intra_4x4 trial "
                      f"{sc['without']} / {sc['with']} ms [{card}]")


def equal_d3(fn, planes, qp, torch, what, intra44=False):
    from tpuh264_torch.kernels import iframe

    k = fn(*planes, qp)
    p = iframe._encode_iframe_scan_plain(*planes, qp, intra44)
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip((*k[0], *k[1]), (*p[0], *p[1]))):
        cs.fail(f"{what}: differs from the plain I encode scan")


def equal_d4(fn, kw, torch, what) -> int:
    """Held equal to the plain intra-in-P scan; its intra MBs."""
    from tpuh264_torch.kernels import pframe

    use, m, rec = fn(**kw)
    puse, pm, prec = pframe._intra_in_p_scan_plain(**kw)
    pairs = [(use, puse), *zip(m[:-1], pm[:-1]), *zip(rec, prec)]
    if not all(torch.equal(a.to(b.dtype), b) for a, b in pairs):
        cs.fail(f"{what}: differs from the plain intra-in-P scan")
    return int(use.sum())


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another K6 kernel source (.cu)")
    ap.add_argument("--entry", default=",".join(ENTRIES[:2]),
                    help="its D3 and D4 C entries (and its Intra_4x4 one), "
                    "comma-separated")
    ap.add_argument("--parent", help="another tree's root: phase 11's "
                    "session in turns with it")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernel's times are taken on the card")
    from tpuh264_torch.kernels import iframe, pframe

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    builds = [("this checkout", iframe.encode_iframe_scan,
               pframe._intra_in_p_scan,
               lambda *p, **k: iframe.encode_iframe_scan(*p, intra44=True,
                                                         **k))]
    if a.other:
        entries = a.entry.split(",")
        if len(entries) not in (2, 3):
            cs.fail("--entry takes the D3, D4 (and Intra_4x4) entries, "
                    "comma-separated")
        builds.append((a.other, *build_other(a.other, entries)))
    y, u, v, _, _, _ = cs.pframe_1080p(dev, torch)
    planes = (y[0], u[0], v[0])
    cases = [("D3 1080p x 4 I frame, uint8 planes", planes),
             ("D3 1080p x 4 I frame, int32 planes",
              tuple(p.to(torch.int32) for p in planes))]
    i44_cases = [("1080p x 4 I frame", planes, 30),
                 ("854x480 x 8 'meeting' session IDR",
                  cs.meeting_idr(dev, torch), 34)]
    kw, _, kinds = cs.intra_in_p_480p(dev, torch)
    k6 = builds
    k44 = [b for b in builds if b[3] is not None]
    for name, d3, d4, _ in k6:
        for what, pl in cases:
            equal_d3(d3, pl, 30, torch, f"{name}: {what}")
        n_intra = equal_d4(d4, kw, torch, f"{name}: D4 480p x 8")
    for name, _, _, i44 in k44[1:]:
        for what, pl, qp in i44_cases:
            equal_d3(i44, pl, qp, torch, f"{name}: Intra_4x4 {what}",
                     intra44=True)
    torch.cuda.synchronize()
    mhz = cs.busy_sm_clock()
    print(f"{card}; SM clock under load {mhz} MHz; D4 frame's MB kinds "
          f"skip/inter/intra {kinds}, {n_intra} MBs take intra")
    d4_planes = [iframe._mbs_to_plane(kw[k])
                 for k in ("src_mbs", "u_mbs", "v_mbs")]
    turns = lambda bs: bs[::-1] + bs if len(bs) > 1 else bs * 2
    for rnd in range(a.rounds):
        for what, pl in cases:
            bound = cs.bound_ms(cs.k6_bytes(pl))
            c = pl[0].shape[2] // 16
            for name, d3, _, _ in turns(k6):
                ms = cs.timed(lambda: d3(*pl, 30), 20)
                print(f"round {rnd}: {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f}% of the bytes bound "
                      f"{bound:.4f} ms, {cs.k6_cycles(ms, mhz, c):.0f} "
                      f"cycles a MB column ({c} columns) at {mhz} MHz "
                      f"[{card}]")
        bound = cs.bound_ms(cs.k6_bytes(d4_planes, kw, n_intra))
        c = kw["inter_sad"].shape[2]
        for name, _, d4, _ in turns(k6):
            ms = cs.timed(lambda: d4(**kw), 20)
            print(f"round {rnd}: D4 480p x 8 intra-in-P P frame: {name}: "
                  f"{ms:.4f} ms, {100 * bound / ms:.1f}% of the bytes bound "
                  f"{bound:.4f} ms, {cs.k6_cycles(ms, mhz, c):.0f} cycles a "
                  f"MB column ({c} columns) at {mhz} MHz [{card}]")
        for what, pl, qp in i44_cases:
            bound = cs.bound_ms(cs.k6_i44_bytes(pl))
            c = pl[0].shape[2] // 16
            for name, _, _, i44 in turns(k44):
                ms = cs.timed(lambda: i44(*pl, qp), 20)
                print(f"round {rnd}: K6-i44 {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.2f}% of the bytes bound "
                      f"{bound:.4f} ms, {cs.k6_cycles(ms, mhz, c):.0f} "
                      f"cycles a MB column ({c} columns) at {mhz} MHz "
                      f"[{card}]")
    # this checkout's route beside its plain version, with its share
    for what, pl, qp in i44_cases:
        cs.d3_i44_timed(pl, qp, torch, what, card, mhz)
    src = os.path.join(ROOT, "tpuh264_torch", "csrc", "intra16_enc.cu")
    if a.parent:
        sessions(a.parent, a.rounds, dev, card)
    ptx = [("this checkout", src)]
    if a.other:
        ptx.append((a.other, a.other))
    for name, path in ptx:
        for ln in cs.ptxas_lines(path):
            print(f"ptxas, {name}: {ln}")


if __name__ == "__main__":
    main()
