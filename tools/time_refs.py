#!/usr/bin/env python3
"""Time the P frame's reference build (K11, tpuh264_torch/csrc/halfpel.cu),
its stage-A winner (K12, csrc/me_winner.cu) and the decoders' intra
reconstruction (K5, csrc/intra_recon.cu, which decodes the intra MBs'
residuals from the levels) at chip_smoke.py phase 2's inputs, in turns
with other trees' routes for the same stages.

    python3 tools/time_refs.py [--parent DIR ...] [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are the routers' own arguments, captured from the codec's
calls: the 1920x1080 x 4 "rigid" P frame of the RTC preset (one
reference: its encode's `_references` and `_int_winner`, its decode's
`_references` and `_intra_recon_scan`, which has no intra MB), that
frame's IDR (`decode_iframe_scan`: every MB intra), the 854x480 x 8
"meeting" default-config P frame with two references (its encode's
`_references` and both `_int_winner` calls, its decode's `_references`),
and the scan of a 854x480 x 8 default-config P frame coded against the
frame 8 frames back (a few intra MBs).  DIR is the root of another tree
(e.g. `git archive <commit>` unpacked into a git-ignored directory),
whose package is imported apart as a package of its own: its
`_references` and `_int_winner` are called with the same arguments, and
its scan as that tree's P decode calls it (before this one: the
residuals of `_intra_residuals`, then its `_intra_recon_scan`); K12
is also timed by phase, each of its two launches apart through the
tree's own entry (`chip_smoke.k12_phases`).  Every
way is first held equal to this checkout's plain versions on every
input.  Each round times the parents, this, this, the parents (CUDA
events behind a device sleep, chip_smoke.timed) and prints each reading
beside the bytes bound (chip_smoke.k11_bytes / k12_bytes / k5_bytes) and
the card's name and power limit.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def tree_kernels(root: str, alias: str):
    """(kernels.iframe, kernels.pframe, kernels.cuda_lib) of the tree at
    `root`, its package imported as `alias` (its modules import each
    other relatively, so it stays apart from this checkout's)."""
    import importlib
    import importlib.util

    pkg = os.path.join(os.path.abspath(root), "tpuh264_torch")
    spec = importlib.util.spec_from_file_location(
        alias, os.path.join(pkg, "__init__.py"),
        submodule_search_locations=[pkg])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[alias] = mod
    spec.loader.exec_module(mod)
    return tuple(importlib.import_module(f"{alias}.kernels.{m}")
                 for m in ("iframe", "pframe", "cuda_lib"))


def tree_ways(tif, tpf, lib):
    """The tree's route of each stage, called with this checkout's router
    arguments: {stage: fn(**kw)}, and "K12 phases": fn(**kw) -> K12's
    launches apart (`chip_smoke.k12_phases` through the tree's entry).  A
    tree whose scan takes `res` gets the residuals of its own
    `_intra_residuals` first."""
    import inspect

    def scan(mode, cmode, levels, qp, qpc, other=None, is_intra=None,
             i44=None):
        if "levels" in inspect.signature(tif._intra_recon_scan).parameters:
            return tif._intra_recon_scan(mode, cmode, levels, qp, qpc, other,
                                         is_intra, i44)
        return tif._intra_recon_scan(mode, cmode,
                                     tif._intra_residuals(levels, qp, qpc),
                                     other, is_intra, i44)
    return {"K11": tpf._references, "K12": tpf._int_winner, "K5": scan,
            "K12 phases": lambda **kw: cs.k12_phases(tpf, lib, kw)}


def inputs(dev, torch):
    """[(stage, what, router kwargs)] of phase 2's frames."""
    from tpuh264_torch.kernels import iframe, pframe

    out, cases = [], []
    names = ("_references", "_int_winner")
    got = cs.capture_all(pframe, names,
                         lambda: out.append(cs.pframe_1080p(dev, torch)))
    y, u, v, sym = out[0][:4]
    one = "1080p x 4 RTC P frame, one reference"
    cases += [("K11", f"{one}: encode", got["_references"][0]),
              ("K12", one, got["_int_winner"][0])]
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    scan = []
    dec = cs.capture_all(pframe, ("_references",), lambda: scan.extend(
        cs.d2_capture(lambda: pframe.decode_pframe_rows_multi(sym, *refs,
                                                              30))))
    cases += [("K11", f"{one}: decode", dec["_references"][0]),
              ("K5", f"{one}: decode (no intra MB)", scan[0])]
    sym_i, _ = iframe.encode_iframe_rows(y[0], u[0], v[0], 30)
    cases.append(("K5", "1080p x 4 IDR (decode_iframe_scan, every MB "
                  "intra)", cs.d2_capture(
                      lambda: iframe.decode_iframe_scan(sym_i, 30))[0]))
    del y, u, v, sym, refs, sym_i, out
    box = {}
    got = cs.capture_all(pframe, names, lambda: box.update(
        p=cs.pframe_480p_2ref(dev, torch)))
    two = "854x480 x 8 default-config P frame, two references"
    cases += [("K11", f"{two}: encode", got["_references"][-2]),
              ("K11", f"{two}: decode", got["_references"][-1])]
    cases += [("K12", f"{two}: reference {i}", kw)
              for i, kw in enumerate(got["_int_winner"][-2:])]
    _, refs, sym, _, _ = cs.pframe_480p(dev, torch, t8=False, gap=8)
    cases.append(("K5", "854x480 x 8 meeting P frame 8 frames on "
                  "(defaults, intra-in-P)", cs.d2_capture(
                      lambda: pframe.decode_pframe_rows_multi(sym, *refs,
                                                              30))[0]))
    return cases


def k5_variant(spec: str):
    """K5's source built alone into the build directory, `spec` "[SRC:]
    NAME=V,...": this checkout's csrc/intra_recon.cu, or SRC (another
    version of it, its headers beside it), with those macros (e.g.
    K5_WORKERS, K5_RING).  K5's route through that build's
    entry, fn(**router kwargs)."""
    import ctypes
    import subprocess

    from tpuh264_torch.kernels import cuda_lib, iframe

    src, _, defines = spec.rpartition(":")
    src = src or os.path.join(cuda_lib.CSRC, "intra_recon.cu")
    macros = [d for d in defines.split(",") if d]
    out = os.path.join(cuda_lib.BUILD, "variants", "k5_" + "_".join(
        [str(abs(hash(src)))] + macros).replace("=", "") + ".so")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    *(f"-D{d}" for d in macros), "-o", out, src], check=True)
    lib = ctypes.CDLL(out)
    entry = lib.th264_intra_recon_rows
    entry.argtypes = [ctypes.c_void_p] * 3
    entry.restype = ctypes.c_int

    def scan(mode, cmode, levels, qp, qpc, other=None, is_intra=None,
             i44=None):
        ins, outs, ints = iframe._k5_operands(mode, cmode, levels, qp, qpc,
                                              other, is_intra)
        err = entry(cuda_lib.pointers(ins + outs), cuda_lib.ints(ints),
                    cuda_lib.stream(mode.device))
        if err:
            raise RuntimeError(f"K5 variant {spec}: CUDA error {err}")
        return tuple(outs)

    return scan


def k12_blocks(per_sm: int):
    """K12's route at `per_sm` blocks an SM of the card, and its phases
    apart: {"K12": fn(**kw), "K12 phases": fn(**kw)}."""
    import torch

    from tpuh264_torch.kernels import cuda_lib, pframe

    def blocks(sads):
        return per_sm * torch.cuda.get_device_properties(
            sads.device).multi_processor_count

    return {"K12": lambda sads, lam, group=None: pframe._k12_launch(
                sads, lam, group, blocks(sads)),
            "K12 phases": lambda **kw: cs.k12_phases(
                pframe, cuda_lib, kw, blocks(kw["sads"]))}


def bound(stage, kw):
    return cs.bound_ms({"K11": cs.k11_bytes, "K12": cs.k12_bytes,
                        "K5": cs.k5_bytes}[stage](kw))


def flat(out):
    """A stage's output as a list of tensors."""
    items = []
    for x in out:
        items += list(x) if isinstance(x, (list, tuple)) else [x]
    return items


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="the root of another tree, e.g. from git archive")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--k5-variant", action="append", default=[],
                    help="K5 built with these macros, e.g. "
                    "K5_WORKERS=6,K5_RING=16 (timed as one more way)")
    ap.add_argument("--k12-blocks", action="append", type=int, default=[],
                    help="K12 at this many blocks an SM (one more way)")
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernels' times are taken on the card")
    from tpuh264_torch.kernels import iframe, pframe

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    plain = {"K11": pframe._references_plain, "K12": pframe._int_winner_plain,
             "K5": iframe._intra_recon_scan_plain}
    from tpuh264_torch.kernels import cuda_lib

    ways = [("this checkout", tree_ways(iframe, pframe, cuda_lib))]
    for i, root in enumerate(a.parent):
        ways.append((f"tree {root}", tree_ways(*tree_kernels(
            root, f"tree{i}_tpuh264_torch"))))
    this = ways[0][1]
    for d in a.k5_variant:
        ways.append((f"K5 {d}", dict(this, K5=k5_variant(d))))
    for n in a.k12_blocks:
        ways.append((f"K12 {n} blocks an SM", dict(this, **k12_blocks(n))))
    cases = inputs(dev, torch)
    for stage, what, kw in cases:
        want = flat(plain[stage](**kw))
        for name, fns in ways:
            got = flat(fns[stage](**kw))
            cs._all_equal(got, want, torch, f"{name}: {stage} ({what})")
    print(f"{card}; every way equal to the plain versions on every input")
    order = ways[:0:-1] + ways[:1] * 2 + ways[1:]
    for rnd in range(a.rounds):
        for stage, what, kw in cases:
            b = bound(stage, kw)
            for name, fns in order:
                ms = cs.timed(lambda: fns[stage](**kw), 20)
                print(f"round {rnd}: {stage} {what}: {name}: {ms:.4f} ms, "
                      f"{100 * b / ms:.1f}% of the bytes bound {b:.4f} ms "
                      f"[{card}]")
                if stage == "K12":
                    one, two = fns["K12 phases"](**kw)
                    print(f"round {rnd}: K12 {what}: {name}: phase 1 "
                          f"{cs.timed(one, 20):.4f} ms, phase 2 "
                          f"{cs.timed(two, 20):.4f} ms [{card}]")


if __name__ == "__main__":
    main()
