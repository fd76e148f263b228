#!/usr/bin/env python3
"""Time the port's deblock kernel (K4, tpuh264_torch/csrc/deblock.cu) at
chip_smoke.py phase 2's two K4 inputs, optionally in turns with another
build of it.

    python3 tools/time_deblock.py [--other SRC.cu --entry NAME] [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are the 1920x1080 x 4 pipeline P frame and the 854x480 x 8
t8 P frame ("meeting", 8x8 transform, intra-in-P) of phase 2.  SRC.cu is
a kernel source whose C entry NAME takes th264_deblock_rows's arguments
(an earlier csrc/deblock.cu with its entry renamed); it is built with
nvcc into tpuh264_torch/build/ and called through the same wrapper,
`kernels/deblock.py` `deblock_frame_rows`.  Every kernel is first held
equal to the plain version.  Each round times other, this, this, other
(CUDA events behind a device sleep, 20 calls: chip_smoke.timed) and
prints each reading's ms, its share of the bytes bound and its cycles a
MB column at the SM clock read under load, beside the card's name and
power limit.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


class _OtherLib:
    """The kernel library with another entry in th264_deblock_rows's place."""

    def __init__(self, lib, entry):
        self._lib, self.th264_deblock_rows = lib, entry

    def __getattr__(self, name):
        return getattr(self._lib, name)


def build_other(src: str, entry: str):
    """`src` built into tpuh264_torch/build/ as its own library; a call of
    the wrapper with that library's `entry` in the kernel's place."""
    from tpuh264_torch.kernels import cuda_lib, deblock

    out = os.path.join(cuda_lib.BUILD, f"lib{entry}.so")
    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-o", out, src],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {src}: {res.stdout}{res.stderr}")
    fn = getattr(ctypes.CDLL(out), entry)
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 12 + [i, i, i, i, p]
    fn.restype = ctypes.c_int
    other = _OtherLib(cuda_lib.load(), fn)

    def call(*args, **kw):
        saved = cuda_lib.load
        cuda_lib.load = lambda: other
        try:
            return deblock.deblock_frame_rows(*args, **kw)
        finally:
            cuda_lib.load = saved

    return call


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="another deblock kernel source (.cu)")
    ap.add_argument("--entry", default="th264_deblock_rows_other",
                    help="its C entry (th264_deblock_rows's arguments)")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernel's times are taken on the card")
    from tpuh264_torch.kernels import deblock

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    kernels = [("this checkout", deblock.deblock_frame_rows)]
    if a.other:
        kernels.append((f"{a.other}:{a.entry}", build_other(a.other,
                                                             a.entry)))
    _, _, _, sym, rec, mot = cs.pframe_1080p(dev, torch)
    cases = [("1080p x 4 P frame", cs.d1_args(torch, rec, 30, sym, mot))]
    _, _, sym, rec, mot = cs.pframe_480p(dev, torch, t8=True)
    cases.append(("480p x 8 t8 P frame",
                  cs.d1_args(torch, rec, 30, sym, mot, t8=True)))
    for what, (args, kw) in cases:
        plain = deblock._deblock_rows_plain(*args, **kw)
        for name, fn in kernels:
            if not all(torch.equal(x, y) for x, y in zip(fn(*args, **kw),
                                                         plain)):
                cs.fail(f"{name} differs from the plain version ({what})")
    mhz = cs.busy_sm_clock()
    print(f"{card}; SM clock under load {mhz} MHz")
    order = kernels[::-1] + kernels if len(kernels) > 1 else kernels * 2
    for rnd in range(a.rounds):
        for what, (args, kw) in cases:
            bound = cs.bound_ms(cs.k4_bytes(args, kw))
            c = args[0].shape[-1] // 16
            for name, fn in order:
                ms = cs.timed(lambda: fn(*args, **kw), 20)
                print(f"round {rnd}: {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f}% of the bytes bound "
                      f"{bound:.4f} ms, "
                      f"{cs.d1_cycles(ms, mhz, c):.0f} cycles a MB column "
                      f"({c} columns) at {mhz} MHz [{card}]")


if __name__ == "__main__":
    main()
