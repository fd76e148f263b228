#!/usr/bin/env python3
"""Time K3's slice entry (`merge_slices`, tpuh264_torch/csrc/cavlc_merge.cu)
on the GOP pipeline's slice stages, in turns with other builds of it.

    python3 tools/time_entropy.py [--other DIR ...] [--sass] [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are chip_smoke.py phase 2's, as the slice stage's kernels
leave them for the slice entry (header, K3's MB-level strings, K13's
skip-run tails): the 1920x1080 x 4 RTC P frame's symbols four times over
(a P dispatch: 1,088 slices of 120 MBs), the GOP start's I slices of that
size (272 slices, no tail) and phase 2's intra-in-P 854x480 x 8 P frame
four times over (960 slices of 54 MBs). DIR is a directory holding
another build's cavlc_merge.cu (e.g. the parent's csrc from `git
archive`), built with nvcc into tpuh264_torch/build/ as a library of its
own and called through this checkout's router (the entry's arguments
are unchanged since the slice entry came). Every build is first held equal to the plain
version (words, bytes, overflow flag) on every input and on every
chip_smoke.K3S_CASES edge case. Each round times the others, this, this,
the others (CUDA events behind a device sleep, 20 calls: chip_smoke.timed)
and prints each reading's ms and its share of the bytes bound
(chip_smoke.k3s_bytes) beside the card's name and power limit; then
each build's ptxas registers and shared memory, and its slice entry's
resident blocks an SM and waves at each input (the runtime's occupancy,
from the build's th264_merge_slices_resident where it has one).
--sass prints, for each kernel of the source, whether it compiles to the
SASS of each --other build's (merge_warp and merge_block, K3's MB level
and generic entry, are unchanged by a change to the slice entry).
"""

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(ROOT, "tpuh264_torch", "csrc")
SOURCE = "cavlc_merge.cu"
ENTRY = "th264_merge_slices"
RESIDENT = "th264_merge_slices_resident"


class _OtherLib:
    """The kernel library with another build's slice entry."""

    def __init__(self, lib, fn):
        self._lib = lib
        self.th264_merge_slices = fn

    def __getattr__(self, name):
        return getattr(self._lib, name)


def build_other(src_dir: str, tag: str):
    """The cavlc_merge.cu of `src_dir` built into tpuh264_torch/build/ as
    a library of its own: a call of this checkout's router
    `merge_slices` with that library's entry."""
    from tpuh264_torch.kernels import cavlc_cuda, cuda_lib

    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD, f"libmerge_{tag}.so")
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-o", out, os.path.join(src_dir, SOURCE)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {src_dir}: {res.stdout}{res.stderr}")
    real, own = cuda_lib.load(), ctypes.CDLL(out)
    fn = getattr(own, ENTRY)
    fn.argtypes = getattr(real, ENTRY).argtypes
    fn.restype = ctypes.c_int
    lib = _OtherLib(real, fn)

    def call(*a):
        saved = cuda_lib.load
        cuda_lib.load = lambda: lib
        try:
            return cavlc_cuda.merge_slices(*a)
        finally:
            cuda_lib.load = saved
    call.lib = own
    return call


def sass(src: str) -> dict:
    """{kernel: its SASS, addresses and encodings dropped} of the source
    `src` compiled alone by nvcc into tpuh264_torch/build/."""
    from tpuh264_torch.kernels import cuda_lib

    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD, "sass_" + os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(src)))) + ".cubin")
    for cmd in ([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH, "-std=c++17",
                 "-O3", "-cubin", "-o", out, src],
                [os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump"),
                 "-sass", out]):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            cs.fail(f"{cmd[0]} {src}: {res.stdout}{res.stderr}")
    fns, name = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:  # the anonymous namespace's name varies
            name = re.sub(r"_GLOBAL__N__\w+?_cu_[0-9a-f]+", "_GLOBAL__N_",
                          ln.split("Function :")[1].strip())
            fns[name] = []
        elif name and "/*" in ln and ";" in ln:
            fns[name].append(ln.split("*/", 1)[1].split(";")[0].strip())
    return fns


def inputs(dev, torch):
    """[(what, merge_slices' arguments less n_out and ovf)] at phase 2's
    three slice stages, as the stage's kernels leave them."""
    from tpuh264_torch.core.params import PPS, SPS
    from tpuh264_torch.core.sliceheader import SLICE_P
    from tpuh264_torch.entropy.device_pack import slice_headers_device
    from tpuh264_torch.kernels import iframe, pframe

    def stage(sym, pslice):
        lead, r, c = sym.mode.shape
        kw = (dict(slice_type=SLICE_P) if pslice else {})
        hdr = slice_headers_device(SPS.for_size(16 * c, 16 * r), PPS(), 30,
                                   int(pslice), not pslice, lead,
                                   deblock_idc=2, device=dev, **kw)
        got = cs.entropy_stage(sym, hdr, torch, 1, pslice, False)
        return (*hdr, got[6], got[7], got[3])

    four = lambda sym: pframe.MBSymbolsP(*[None if f is None else
                                           torch.cat([f] * 4) for f in sym])
    y, u, v, sym = cs.pframe_1080p(dev, torch)[:4]
    sym_i, _ = iframe.encode_iframe_rows(y[0], u[0], v[0], 30)
    out = [("1080p x 4 P dispatch (1,088 slices of 120 MBs)",
            stage(four(sym), True)),
           ("1080p x 4 GOP start's I slices (272 slices of 120 MBs)",
            stage(sym_i, False))]
    del y, u, v, sym, sym_i
    _, sym, _ = cs.intra_in_p_480p(dev, torch)
    out.append(("854x480 x 8 intra-in-P P dispatch (960 slices of 54 MBs)",
                stage(four(sym), True)))
    return out


def check(fn, cases, torch, np, dev, name) -> None:
    """The build's slice entry `fn` equal to the plain version (words,
    bytes, overflow flag) on every input and every K3S_CASES case."""
    from tpuh264_torch.kernels import cavlc_cuda

    edge = []
    for case in cs.K3S_CASES:
        *parts, n_out = cs.k3s_case(np, case)
        edge.append((case, [None if x is None else torch.from_numpy(x)
                            .to(dev) for x in parts], n_out))
    for what, args, n_out in ([(w, a, 8192) for w, a in cases] + edge):
        ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        want_ovf = torch.zeros_like(ovf)
        got = fn(*args, n_out, ovf)
        want = cavlc_cuda._merge_slices_plain(*args, n_out, want_ovf)
        cs._all_equal([*got, ovf], [*want, want_ovf], torch,
                      f"{name}: the slice entry ({what})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="a directory with another build's cavlc_merge.cu")
    ap.add_argument("--sass", action="store_true",
                    help="also whether each kernel compiles to the SASS of "
                    "each --other build's")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernels' times are taken on the card")
    from tpuh264_torch.kernels import cavlc_cuda

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    builds = [("this checkout", cavlc_cuda.merge_slices, CSRC)]
    for i, d in enumerate(a.other):
        builds.append((d, build_other(d, f"other{i}"), d))
    for d in a.other if a.sass else ():
        mine, theirs = (sass(os.path.join(x, SOURCE)) for x in (CSRC, d))
        for k in sorted(set(mine) | set(theirs)):
            same = k in mine and mine.get(k) == theirs.get(k)
            print(f"sass, {k}: {'equals' if same else 'DIFFERS FROM'} {d}'s "
                  f"({len(mine.get(k, []))} / {len(theirs.get(k, []))} "
                  f"instructions)")
    cases = inputs(dev, torch)
    for name, fn, _ in builds:
        check(fn, cases, torch, np, dev, name)
    print(f"{card}; every build equal to the plain version on every input "
          f"and on {len(cs.K3S_CASES)} edge cases")
    order = builds[:0:-1] + builds[:1] * 2 + builds[1:]
    for rnd in range(a.rounds):
        for what, args in cases:
            bound = cs.bound_ms(cs.k3s_bytes(args[1], args[3], 128, 8192,
                                             args[4]))
            ovf = torch.zeros(1, dtype=torch.int32, device=dev)
            for name, fn, _ in order:
                ms = cs.timed(lambda: fn(*args, 8192, ovf), 20)
                print(f"round {rnd}: {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f}% of the bytes bound "
                      f"{bound:.4f} ms [{card}]")
    for name, fn, d in builds:
        src = os.path.join(d, SOURCE)
        for ln in cs.ptxas_lines(src):
            print(f"ptxas, {name}: {ln}")
        lib = getattr(fn, "lib", None)
        if lib is not None and not hasattr(lib, RESIDENT):
            print(f"occupancy, {name}: the build has no {RESIDENT}")
            continue
        if lib is not None:
            getattr(lib, RESIDENT).argtypes = [ctypes.c_void_p]
            getattr(lib, RESIDENT).restype = ctypes.c_int
        n, threads = cavlc_cuda.merge_slices_resident(lib)
        waves = ", ".join(f"{args[1].numel() / (132 * n):.2f}"
                          for _, args in cases)
        print(f"occupancy, {name}: {n} blocks of {threads} threads an SM; "
              f"waves at the inputs {waves}")


if __name__ == "__main__":
    main()
