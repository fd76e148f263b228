#!/usr/bin/env python3
"""Time the single-slice wavefront's kernels K7 (encode) and K8 (decode),
tpuh264_torch/csrc/wavefront.cu, at chip_smoke.py phase 2's frames,
optionally in turns with another build of them.

    python3 tools/time_wavefront.py [--parent DIR ...] [--other SRC.cu
                                    [--entry ENC]] [--rounds N]
    python3 tools/time_wavefront.py --sessions [--root DIR] [--tag T]
                                    [--frames N]
    python3 tools/time_wavefront.py --count-ops

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The frames are phase 2's: one frame of the "meeting" clip at 854x480 x 8
(phase 12), 640x360 x 1 (BASELINE config 1) and 1920x1080 x 1, edge-padded
to the MB grid, QP 28.  DIR is another tree of the repo (e.g. `git
archive <commit>` unpacked into a git-ignored directory; --parent may be
given more than once): its package is imported as a package of its own
(`tree0_tpuh264_torch`, ..., its kernel library built in its own tree)
and its routers `encode_iframe_single`
and `decode_iframe_single` are timed in turns with this checkout's (the
routers, since what K8 takes changed: the parent's decodes the residuals
in torch and then launches its K8).  SRC.cu is a source with K7's C
entry of csrc/wavefront.cu (e.g. `git show <commit>:tpuh264_torch/csrc/
wavefront.cu` in a git-ignored directory, with csrc/intra16_common.cuh
beside it), named by --entry; it is built with nvcc into
tpuh264_torch/build/ as a library of its own and called through this
checkout's wrapper `encode_iframe_single`.  Every build is first held
equal to this checkout's plain versions (K8 on K7's symbols, and to K7's
recon).  Each round times the others, this, this, the others (CUDA
events behind a device sleep, 20 calls: chip_smoke.timed): K7, this
checkout's K8 entry alone (`_k8_launch`) and every tree's K8 router,
each reading's ms, its share of the bytes bound (chip_smoke.k7_bytes /
k8_bytes) and its SM cycles a wave at the clock read under load, beside
the card's name and power limit; then ptxas's registers, spills and
shared memory of each build, and this checkout's cluster plan.

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

ENTRY = "th264_wavefront_encode"
FRAMES = ((854, 480, 8), (640, 360, 1), (1920, 1080, 1))
QP = 28


class _OtherLib:
    """The kernel library with another build's entry in K7's place."""

    def __init__(self, lib, enc):
        self._lib = lib
        self.th264_wavefront_encode = enc

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


def tree_wavefront(root: str, alias: str):
    """kernels/wavefront.py of the tree at `root`, its package imported as
    `alias` (its modules import each other relatively, so it stays apart
    from this checkout's)."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "tpuh264_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return importlib.import_module(f"{alias}.kernels.wavefront")


def builds(other, entry, parents):
    """[(name, encode, decode router)]: this checkout's, each tree of
    `parents`' routers, and `other`'s K7 entry through this checkout's
    wrapper (no decode) where given."""
    from tpuh264_torch.kernels import cuda_lib, wavefront

    real = cuda_lib.load()
    out = [("this checkout", wavefront.encode_iframe_single,
            wavefront.decode_iframe_single)]
    for i, root in enumerate(parents):
        pw = tree_wavefront(root, f"tree{i}_tpuh264_torch")
        out.append((f"tree {root}", pw.encode_iframe_single,
                    pw.decode_iframe_single))
    if other is None:
        return out
    so_path = os.path.join(cuda_lib.BUILD, "libwavefront_other.so")
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-o", so_path, other],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {other}: {res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(so_path), entry)
    fn.argtypes = real.th264_wavefront_encode.argtypes
    fn.restype = ctypes.c_int
    lib = _OtherLib(real, fn)
    out.append((other, _through(lib, wavefront.encode_iframe_single), None))
    return out


def check(enc, dec, planes, torch, what):
    """The build's K7 and K8 router (where given) equal this checkout's
    plain versions on `planes`; returns K7's symbols."""
    from tpuh264_torch.kernels import wavefront

    sym, rec = enc(*planes, QP)
    psym, prec = wavefront._encode_iframe_single_plain(*planes, QP)
    if not all(a.dtype == b.dtype and torch.equal(a, b)
               for a, b in zip((*sym, *rec), (*psym, *prec))):
        cs.fail(f"{what}: K7 differs from the plain encode")
    if dec is not None:
        got = dec(sym, QP)
        want = wavefront._decode_iframe_single_plain(sym, QP)
        if not all(torch.equal(a, b) and torch.equal(a, c)
                   for a, b, c in zip(got, want, rec)):
            cs.fail(f"{what}: K8 differs from the plain decode or the "
                    f"recon")
    return psym


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
    ap.add_argument("--parent", action="append", default=[],
                    help="another tree: time its routers too (repeatable)")
    ap.add_argument("--other", help="another K7 kernel source (.cu)")
    ap.add_argument("--entry", default=ENTRY, help="its K7 C entry")
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
    from tpuh264_torch.kernels import wavefront

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    bs = builds(a.other, a.entry, a.parent)
    cases = []
    for w, h, s in FRAMES:
        planes = cs.wave_frames(dev, torch, np, w, h, s)
        what = f"{w}x{h} x {s}"
        for name, enc, dec in bs:
            sym = check(enc, dec, planes, torch, f"{name}: {what}")
        cases.append((what, planes, sym))
    torch.cuda.synchronize()
    mhz = cs.busy_sm_clock()
    print(f"{card}; SM clock under load {mhz} MHz")
    order = bs[:0:-1] + bs[:1] + bs[:1] + bs[1:] if len(bs) > 1 else bs * 2
    mine = [("this checkout's K8 entry", None, wavefront._k8_launch)] * 2
    for rnd in range(a.rounds):
        for what, planes, sym in cases:
            waves = planes[0].shape[1] // 16 + planes[0].shape[2] // 16 - 1
            timings = [("K7", cs.k7_bytes(planes), b[0],
                        (lambda b: lambda: b[1](*planes, QP))(b))
                       for b in order]
            timings += [("K8", cs.k8_bytes(sym.mode), f"{b[0]} router",
                         (lambda b: lambda: b[2](sym, QP))(b))
                        for b in order if b[2] is not None]
            timings += [("K8", cs.k8_bytes(sym.mode), b[0],
                         (lambda b: lambda: b[2](sym, QP))(b)) for b in mine]
            for key, nbytes, name, fn in timings:
                bound = cs.bound_ms(nbytes)
                ms = cs.timed(fn, 20)
                print(f"round {rnd}: {key} {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.2f}% of the bytes bound "
                      f"{bound:.4f} ms, "
                      f"{cs.wave_cycles(ms, mhz, waves):.0f} cycles a "
                      f"wave ({waves} waves) at {mhz} MHz [{card}]",
                      flush=True)
    srcs = [("this checkout", os.path.join(ROOT, "tpuh264_torch", "csrc",
                                           "wavefront.cu"))]
    srcs += [(f"tree {root}", os.path.join(root, "tpuh264_torch", "csrc",
                                           "wavefront.cu"))
             for root in a.parent]
    if a.other:
        srcs.append((a.other, a.other))
    for name, src in srcs:
        for ln in cs.ptxas_lines(src):
            print(f"ptxas, {name}: {ln}")
    for w, h, _ in FRAMES:
        r, c = (h + 15) // 16, (w + 15) // 16
        print(f"plan {w}x{h}: {cs.wave_plan(r, c)}")


if __name__ == "__main__":
    main()
