#!/usr/bin/env python3
"""Time the single-slice wavefront's kernels K7 (encode) and K8 (decode),
tpuh264_torch/csrc/wavefront.cu, at chip_smoke.py phase 2's frames,
optionally in turns with another build of them.

    python3 tools/time_wavefront.py [--other SRC.cu [--entry ENC,DEC]]
                                    [--rounds N]
    python3 tools/time_wavefront.py --sessions [--root DIR] [--tag T]
                                    [--frames N]
    python3 tools/time_wavefront.py --count-ops

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The frames are phase 2's: one frame of the "meeting" clip at 854x480 x 8
(phase 12), 640x360 x 1 (BASELINE config 1) and 1920x1080 x 1, edge-padded
to the MB grid, QP 28.  SRC.cu is a source with the two C entries of
csrc/wavefront.cu (e.g. `git show <commit>:tpuh264_torch/csrc/
wavefront.cu` in a git-ignored directory, with csrc/intra16_common.cuh
beside it), named by --entry; it is built with nvcc into
tpuh264_torch/build/ as a library of its own and called through the same
wrappers (`kernels/wavefront.py` `encode_iframe_single` and
`_k8_launch`).  Every build is first held equal to the plain versions
(K8 on K7's symbols, and to K7's recon).  Each round times other, this,
this, other (CUDA events behind a device sleep, 20 calls:
chip_smoke.timed) and prints each reading's ms, its share of the bytes
bound (chip_smoke.k7_bytes / k8_bytes) and its SM cycles a wave at the
clock read under load, beside the card's name and power limit; then
ptxas's registers, spills and shared memory of each build.

With --sessions it times instead the single-slice session path of the
checkout at DIR (by default this one; an earlier tree unpacked by `git
archive` too, whose wavefront may still be the plain loop): that tree's
EncoderSession and DecoderSession on the card, BASELINE config 1
(640x360 x 1, QP 28, N frames of "meeting", 10 by default) and phase
12's 854x480 x 8 (2 frames, a DecoderSession a stream), each after a
warm-up frame, every decode held equal to the recon; it prints the mean
encode / entropy / decode ms a frame and the round trip's fps (host
wall), tagged T.  For parent / change comparisons, run it in turns on
both trees in one machine session.

With --count-ops (on the CPU, no card needed) it counts the device
operations the plain versions issue: every aten call that is not a view,
under a torch dispatch mode, for one encode and one decode of phase 12's
854x480 x 8 frame and of config 1's 640x360 x 1, a wave's worth and in
all (an eager scan on the card launches about one kernel for each).
"""

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ENTRIES = ("th264_wavefront_encode", "th264_wavefront_decode")
FRAMES = ((854, 480, 8), (640, 360, 1), (1920, 1080, 1))
QP = 28


class _OtherLib:
    """The kernel library with another build's entries in K7's and K8's
    place."""

    def __init__(self, lib, enc, dec):
        self._lib = lib
        self.th264_wavefront_encode = enc
        self.th264_wavefront_decode = dec

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _through(lib, fn):
    """`fn` called with `lib` as the kernel library."""
    from tpuh264_torch.kernels import cuda_lib

    def call(*args):
        saved = cuda_lib.load
        cuda_lib.load = lambda: lib
        try:
            return fn(*args)
        finally:
            cuda_lib.load = saved
    return call


def builds(other, entries):
    """[(name, encode, decode)]: this checkout's K7 / K8 wrappers, and
    `other`'s entries through the same wrappers where given."""
    from tpuh264_torch.kernels import cuda_lib, wavefront

    real = cuda_lib.load()
    out = [("this checkout", wavefront.encode_iframe_single,
            wavefront._k8_launch)]
    if other is None:
        return out
    so_path = os.path.join(cuda_lib.BUILD, "libwavefront_other.so")
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-o", so_path, other],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {other}: {res.stdout}{res.stderr}")
    so = ctypes.CDLL(so_path)
    fns = []
    for mine, theirs in zip(ENTRIES, entries):
        fn = getattr(so, theirs)
        fn.argtypes = getattr(real, mine).argtypes
        fn.restype = ctypes.c_int
        fns.append(fn)
    lib = _OtherLib(real, *fns)
    out.append((other, _through(lib, wavefront.encode_iframe_single),
                _through(lib, wavefront._k8_launch)))
    return out


def check(enc, dec, planes, torch, what):
    """The build's K7 and K8 equal the plain versions on `planes`; K8's
    inputs (mode, cmode, residuals)."""
    from tpuh264_torch.kernels import wavefront
    from tpuh264_torch.kernels.iframe import _intra_residuals
    from tpuh264_torch.kernels.transform import chroma_qp_from_luma

    sym, rec = enc(*planes, QP)
    psym, prec = wavefront._encode_iframe_single_plain(*planes, QP)
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip((*sym, *rec), (*psym, *prec))):
        cs.fail(f"{what}: K7 differs from the plain encode")
    args = (sym.mode, sym.cmode, _intra_residuals(sym, QP,
                                                  chroma_qp_from_luma(QP)))
    got = dec(*args)
    want = wavefront._decode_iframe_single_plain(sym, QP)
    if not all(torch.equal(a, b) and torch.equal(a, c)
               for a, b, c in zip(got, want, rec)):
        cs.fail(f"{what}: K8 differs from the plain decode or the recon")
    return args


def sessions(root: str, tag: str, n_frames: int) -> None:
    """The --sessions mode: the tree at `root` imported in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    for m in [m for m in sys.modules
              if m.split(".")[0] in ("chip_smoke", "tpuh264_torch")]:
        del sys.modules[m]
    import numpy as np

    import chip_smoke as tree
    from tpuh264_torch.engine import (CodecConfig, DecoderSession,
                                      EncoderSession)
    from tpuh264_torch.entropy import native
    from tpuh264_torch.kernels import cuda_lib

    cuda_lib.load()
    native.load()
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    for w, h, s, n in ((640, 360, 1, n_frames), (854, 480, 8, 2)):
        frames = tree.clip_streams(w, h, n + 1, s)  # the first: warm-up
        enc = EncoderSession(CodecConfig(width=w, height=h, streams=s,
                                         qp=QP, slice_mode="single",
                                         gop_size=1), device="cuda")
        decs = [DecoderSession(device="cuda") for _ in range(s)]
        rows = []
        for t, planes in enumerate(frames):
            t0 = time.perf_counter()
            out = enc.encode_frame_yuv(*planes)
            t1 = time.perf_counter()
            got = [d.decode(f.data) for d, f in zip(decs, out)]
            t2 = time.perf_counter()
            recon = [p.cpu().numpy() for p in enc.recon]
            for i, g in enumerate(got):
                if g is None or not all(
                        np.array_equal(x, r[i][:x.shape[0], :x.shape[1]])
                        for x, r in zip(g, recon)):
                    cs.fail(f"{tag}: decoder {i} != recon at frame {t}")
            rows.append((out[0].timings["encode_ms"],
                         out[0].timings["entropy_ms"], (t2 - t1) * 1e3,
                         t2 - t0))
        rows = rows[1:]
        mean = lambda k: sum(r[k] for r in rows) / n
        print(f"sessions {tag}: {w}x{h} x {s}, QP {QP}, {n} frames: mean "
              f"encode {mean(0):.2f} ms, entropy {mean(1):.2f} ms, {s} "
              f"decodes {mean(2):.2f} ms a frame; round trip "
              f"{n / sum(r[3] for r in rows):.2f} fps (host wall) [{card}]",
              flush=True)


def count_ops() -> None:
    """The --count-ops mode: the plain versions' non-view aten calls."""
    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    from tpuh264_torch.kernels import wavefront

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.n += not func.is_view
            return func(*args, **(kwargs or {}))

    for w, h, s in FRAMES[:2]:
        planes = cs.wave_frames("cpu", torch, np, w, h, s)
        r, c = planes[0].shape[1] // 16, planes[0].shape[2] // 16
        waves = 2 * (r - 1) + c  # the plain versions' waves, 2r + c
        with Count() as enc:
            sym, _ = wavefront._encode_iframe_single_plain(*planes, QP)
        with Count() as dec:
            wavefront._decode_iframe_single_plain(sym, QP)
        print(f"{w}x{h} x {s}: {waves} waves of the plain scan; encode "
              f"{enc.n} device operations ({enc.n / waves:.0f} a wave), "
              f"decode {dec.n} ({dec.n / waves:.0f} a wave)")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another K7 / K8 kernel source (.cu)")
    ap.add_argument("--entry", default=",".join(ENTRIES),
                    help="its encode and decode C entries, comma-separated")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--sessions", action="store_true",
                    help="time the session path of the tree at --root")
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--tag", default="this checkout")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--count-ops", action="store_true",
                    help="count the plain versions' device operations (CPU)")
    a = ap.parse_args()
    if a.count_ops:
        count_ops()
        return
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernels' times are taken on the card")
    if a.sessions:
        sessions(a.root, a.tag, a.frames)
        return
    entries = a.entry.split(",")
    if len(entries) != 2:
        cs.fail("--entry takes the encode and decode entries, "
                "comma-separated")
    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    bs = builds(a.other, entries)
    cases = []
    for w, h, s in FRAMES:
        planes = cs.wave_frames(dev, torch, np, w, h, s)
        what = f"{w}x{h} x {s}"
        for name, enc, dec in bs:
            args = check(enc, dec, planes, torch, f"{name}: {what}")
        cases.append((what, planes, args))
    torch.cuda.synchronize()
    mhz = cs.busy_sm_clock()
    print(f"{card}; SM clock under load {mhz} MHz")
    order = bs[::-1] + bs if len(bs) > 1 else bs * 2
    for rnd in range(a.rounds):
        for what, planes, args in cases:
            waves = planes[0].shape[1] // 16 + planes[0].shape[2] // 16 - 1
            for key, nbytes, pick in (
                    ("K7", cs.k7_bytes(planes), lambda b: lambda: b[1](
                        *planes, QP)),
                    ("K8", cs.k8_bytes(args[0]), lambda b: lambda: b[2](
                        *args))):
                bound = cs.bound_ms(nbytes)
                for b in order:
                    ms = cs.timed(pick(b), 20)
                    print(f"round {rnd}: {key} {what}: {b[0]}: {ms:.4f} ms, "
                          f"{100 * bound / ms:.2f}% of the bytes bound "
                          f"{bound:.4f} ms, "
                          f"{cs.wave_cycles(ms, mhz, waves):.0f} cycles a "
                          f"wave ({waves} waves) at {mhz} MHz [{card}]")
    srcs = [os.path.join(ROOT, "tpuh264_torch", "csrc", "wavefront.cu")]
    for b, src in zip(bs, srcs + [a.other]):
        for ln in cs.ptxas_lines(src):
            print(f"ptxas, {b[0]}: {ln}")


if __name__ == "__main__":
    main()
