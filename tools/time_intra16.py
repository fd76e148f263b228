#!/usr/bin/env python3
"""Time the port's Intra_16x16 encode kernel (K6,
tpuh264_torch/csrc/intra16_enc.cu) at chip_smoke.py phase 2's D3 and D4
inputs, optionally in turns with another build of it.

    python3 tools/time_intra16.py [--other SRC.cu [--entry D3,D4]]
                                  [--rounds N]

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
name and power limit; then ptxas's registers, spills and shared memory
of each build.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

ENTRIES = ("th264_intra16_encode_rows", "th264_intra16_in_p_rows")


class _OtherLib:
    """The kernel library with another build's entries in K6's place."""

    def __init__(self, lib, d3, d4):
        self._lib = lib
        self.th264_intra16_encode_rows = d3
        self.th264_intra16_in_p_rows = d4

    def __getattr__(self, name):
        return getattr(self._lib, name)


def build_other(src: str, entries):
    """`src` built into tpuh264_torch/build/ as its own library: (D3, D4)
    calls of the wrappers with that library's `entries` in K6's place."""
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
    fns = []
    for mine, theirs in zip(ENTRIES, entries):
        fn = getattr(so, theirs)
        fn.argtypes = getattr(real, mine).argtypes
        fn.restype = ctypes.c_int
        fns.append(fn)
    other = _OtherLib(real, *fns)

    def through(router):
        def call(*args, **kw):
            saved = cuda_lib.load
            cuda_lib.load = lambda: other
            try:
                return router(*args, **kw)
            finally:
                cuda_lib.load = saved
        return call

    return through(iframe.encode_iframe_scan), through(pframe._intra_in_p_scan)


def equal_d3(fn, planes, qp, torch, what):
    from tpuh264_torch.kernels import iframe

    k = fn(*planes, qp)
    p = iframe._encode_iframe_scan_plain(*planes, qp)
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
    ap.add_argument("--entry", default=",".join(ENTRIES),
                    help="its D3 and D4 C entries, comma-separated")
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
               pframe._intra_in_p_scan)]
    if a.other:
        entries = a.entry.split(",")
        if len(entries) != 2:
            cs.fail("--entry takes the D3 and D4 entries, comma-separated")
        builds.append((a.other, *build_other(a.other, entries)))
    y, u, v, _, _, _ = cs.pframe_1080p(dev, torch)
    planes = (y[0], u[0], v[0])
    cases = [("D3 1080p x 4 I frame, uint8 planes", planes),
             ("D3 1080p x 4 I frame, int32 planes",
              tuple(p.to(torch.int32) for p in planes))]
    kw, _, kinds = cs.intra_in_p_480p(dev, torch)
    for name, d3, d4 in builds:
        for what, pl in cases:
            equal_d3(d3, pl, 30, torch, f"{name}: {what}")
        n_intra = equal_d4(d4, kw, torch, f"{name}: D4 480p x 8")
    torch.cuda.synchronize()
    mhz = cs.busy_sm_clock()
    print(f"{card}; SM clock under load {mhz} MHz; D4 frame's MB kinds "
          f"skip/inter/intra {kinds}, {n_intra} MBs take intra")
    order = builds[::-1] + builds if len(builds) > 1 else builds * 2
    d4_planes = [iframe._mbs_to_plane(kw[k])
                 for k in ("src_mbs", "u_mbs", "v_mbs")]
    for rnd in range(a.rounds):
        for what, pl in cases:
            bound = cs.bound_ms(cs.k6_bytes(pl))
            c = pl[0].shape[2] // 16
            for name, d3, _ in order:
                ms = cs.timed(lambda: d3(*pl, 30), 20)
                print(f"round {rnd}: {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.1f}% of the bytes bound "
                      f"{bound:.4f} ms, {cs.k6_cycles(ms, mhz, c):.0f} "
                      f"cycles a MB column ({c} columns) at {mhz} MHz "
                      f"[{card}]")
        bound = cs.bound_ms(cs.k6_bytes(d4_planes, kw, n_intra))
        c = kw["inter_sad"].shape[2]
        for name, _, d4 in order:
            ms = cs.timed(lambda: d4(**kw), 20)
            print(f"round {rnd}: D4 480p x 8 intra-in-P P frame: {name}: "
                  f"{ms:.4f} ms, {100 * bound / ms:.1f}% of the bytes bound "
                  f"{bound:.4f} ms, {cs.k6_cycles(ms, mhz, c):.0f} cycles a "
                  f"MB column ({c} columns) at {mhz} MHz [{card}]")
    srcs = [os.path.join(ROOT, "tpuh264_torch", "csrc", "intra16_enc.cu")]
    for name, src in zip((b[0] for b in builds), srcs + [a.other]):
        for ln in cs.ptxas_lines(src):
            print(f"ptxas, {name}: {ln}")


if __name__ == "__main__":
    main()
