#!/usr/bin/env python3
"""Time the P frame's reference build (K11, tpuh264_torch/csrc/halfpel.cu),
the kernels that read its planes (K1, csrc/me_sad.cu; K9,
csrc/pframe_enc.cu; K10, csrc/pframe_dec.cu), its stage-A winner (K12,
csrc/me_winner.cu) and the decoders' intra reconstruction (K5,
csrc/intra_recon.cu, which decodes the intra MBs' residuals from the
levels; "K5-i44" its Intra_4x4 route, and "D-i44" the session decoders'
whole IDR decode around it) at chip_smoke.py phase 2's inputs, in turns
with other trees' routes for the same stages.

    python3 tools/time_refs.py [--parent DIR ...] [--rounds N]
                               [--only K11,K9,...]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are the routers' own arguments, captured from the codec's
calls: the 1920x1080 x 4 "rigid" P frame of the RTC preset (one
reference: its encode's `_references` and `_int_winner`, its decode's
`_references` and `_intra_recon_scan`, which has no intra MB), that
frame's IDR (`decode_iframe_scan`: every MB intra), the 854x480 x 8
"meeting" default-config P frame with two references (its encode's
`_references` and both `_int_winner` calls, its decode's `_references`),
and the scan of a 854x480 x 8 default-config P frame coded against the
frame 8 frames back (a few intra MBs); K5's Intra_4x4 route ("K5-i44")
on a 1920x1080 x 4 IDR whose MBs are all Intra_4x4 (`d2_i44_case`) and
on the IDR of phase 11's session (854x480 x 8 "meeting" from RGBA,
intra44 + deblock: the decoders' own inputs, `session_idr_i44`), and
that IDR's 8 access units through each tree's
`DecoderPool.decode_batch` ("D-i44": host wall of the fenced call,
parse and deblock included; equal to the encoder's recon); K1, K9 (writing the symbols, as
the GOP pipeline's P encode does) and K10 (on the parsed records' views)
at the 1080p frame's encode and decode, and K1, K9 and K10 at the 480p
frame with two references. Each tree's K1, K9 and K10 read the planes
that tree's own `_references` builds from the captured references (the
layouts differ between trees), built once, outside the timing. DIR is
the root of another tree (e.g. `git archive <commit>` unpacked into a
git-ignored directory), whose package is imported apart as a package of
its own: its `_references` and `_int_winner` are called with the same
arguments, and its scan as that tree's P decode calls it (before this
one: the residuals of `_intra_residuals`, then its `_intra_recon_scan`);
K12 is also timed by phase, each of its two launches apart through the
tree's own entry (`chip_smoke.k12_phases`). Every way is first held
equal to this checkout's plain versions on every input (K11's planes by
value: each tree lays them out its own way). Each round times
the parents, this, this, the parents (CUDA events behind a device sleep,
chip_smoke.timed) and prints each reading beside this checkout's bytes
bound (chip_smoke.k11_bytes / k12_bytes / k5_bytes / k1_bytes / k9_bytes
/ k10_bytes) and the card's name and power limit.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def tree_kernels(root: str, alias: str):
    """(kernels.iframe, kernels.pframe, kernels.cuda_lib, kernels.me_cuda,
    engine) of the tree at `root`, its package imported as `alias` (its
    modules import each other relatively, so it stays apart from this
    checkout's)."""
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
                 for m in ("iframe", "pframe", "cuda_lib", "me_cuda")) + (
        importlib.import_module(f"{alias}.engine"),)


def tree_ways(tif, tpf, lib, tme, eng):
    """The tree's route of each stage, called with this checkout's router
    arguments: {stage: fn(**kw)}, and "K12 phases": fn(**kw) -> K12's
    launches apart (`chip_smoke.k12_phases` through the tree's entry).  A
    tree whose scan takes `res` gets the residuals of its own
    `_intra_residuals` first.  K1, K9 and K10 take `refs` (the captured
    `_references` arguments) besides: the tree's own planes of them,
    built at the first call and kept, replace this checkout's.  "D-i44"
    takes access units: the tree's DecoderPool (made at the first call)
    decodes them in one batch."""
    import inspect

    def scan(mode, cmode, levels, qp, qpc, other=None, is_intra=None,
             i44=None):
        if "levels" in inspect.signature(tif._intra_recon_scan).parameters:
            return tif._intra_recon_scan(mode, cmode, levels, qp, qpc, other,
                                         is_intra, i44)
        return tif._intra_recon_scan(mode, cmode,
                                     tif._intra_residuals(levels, qp, qpc),
                                     other, is_intra, i44)

    built = {}

    def planes(refs):
        if id(refs) not in built:
            built[id(refs)] = (refs, tpf._references(**refs))
        return dict(zip(("planes_l", "refs_up", "refs_vp"),
                        built[id(refs)][1]))

    pools = []

    def decode(aus):
        if not pools:
            pools.append(eng.DecoderPool(device="cuda"))
            for i, _ in aus:
                pools[0].init_decoder(i)
        return pools[0].decode_batch(aus)

    return {"K11": tpf._references, "K12": tpf._int_winner, "K5": scan,
            "K5-i44": scan, "D-i44": decode,
            "K12 phases": lambda **kw: cs.k12_phases(tpf, lib, kw),
            "K1": lambda refs, y, n: tme.sad_field(
                y, planes(refs)["planes_l"][n][0]),
            "K9": lambda refs, **kw: tpf._inter_encode(
                **dict(kw, **planes(refs))),
            "K10": lambda refs, **kw: tpf._inter_decode(
                **dict(kw, **planes(refs)))}


def plain_of(stage, kw):
    """This checkout's plain version of `stage` on a case's arguments."""
    from tpuh264_torch.kernels import iframe, me_cuda, pframe

    if stage == "K1":
        y, n = kw["y"], kw["n"]
        g = pframe._references_plain(**kw["refs"])[0][n][0]
        return me_cuda._sad_field(y[:, ::2, ::2], g, *y.shape[1:])
    args = {k: v for k, v in kw.items() if k not in ("refs", "out")}
    if "refs" in kw:
        args.update(zip(("planes_l", "refs_up", "refs_vp"),
                        pframe._references_plain(**kw["refs"])))
    if stage == "D-i44":  # the encoder's recon, stream by stream
        return [p[i] for i, _ in kw["aus"] for p in kw["recon"]]
    return {"K11": pframe._references_plain,
            "K12": pframe._int_winner_plain,
            "K5": iframe._intra_recon_scan_plain,
            "K5-i44": iframe._intra_recon_scan_plain,
            "K9": pframe._inter_encode_plain,
            "K10": pframe._inter_decode_plain}[stage](**args)


def inputs(dev, torch):
    """[(stage, what, router kwargs)] of phase 2's frames; K1's, K9's and
    K10's kwargs hold `refs`, the `_references` arguments of their
    planes, in place of the planes (K1's: the source `y` and the
    reference's index `n`)."""
    from tpuh264_torch.kernels import iframe, me_cuda, pframe

    out, cases = [], []
    names = ("_references", "_int_winner", "_inter_encode")
    sads = cs.capture(me_cuda, "sad_field", lambda: out.append(
        cs.capture_all(pframe, names,
                       lambda: out.append(cs.pframe_1080p(dev, torch)))))
    y, u, v, sym = out[0][:4]
    got = out[1]
    one = "1080p x 4 RTC P frame, one reference"
    refs = got["_references"][0]
    enc = dict(got["_inter_encode"][0], out=pframe.empty_symbols(
        sym.kind.shape[:1], *sym.kind.shape[1:], dev))
    cases += [("K11", f"{one}: encode", got["_references"][0]),
              ("K12", one, got["_int_winner"][0]),
              ("K1", one, dict(y=sads[0]["y"], n=0, refs=refs)),
              ("K9", f"{one} (writing the symbols)",
               dict(_planeless(enc), refs=refs))]
    dec_refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    scan = []
    dec = cs.capture_all(pframe, ("_references",), lambda: scan.extend(
        cs.d2_capture(lambda: pframe.decode_pframe_rows_multi(
            sym, *dec_refs, 30))))
    cases += [("K11", f"{one}: decode", dec["_references"][0]),
              ("K5", f"{one}: decode (no intra MB)", scan[0])]
    # K10 as the GOP pipeline runs it: the parsed records' views, the
    # reference a uint8 DPB slot
    dec = cs.capture_all(pframe, ("_references", "_inter_decode"),
                         lambda: pframe.decode_pframe_rows_multi(
                             cs.record_views(sym, torch), [y[0]], [u[0]],
                             [v[0]], 30))
    cases.append(("K10", f"{one}: decode (record views, a uint8 slot)",
                  dict(_planeless(dec["_inter_decode"][0]),
                       refs=dec["_references"][0])))
    sym_i, _ = iframe.encode_iframe_rows(y[0], u[0], v[0], 30)
    cases.append(("K5", "1080p x 4 IDR (decode_iframe_scan, every MB "
                  "intra)", cs.d2_capture(
                      lambda: iframe.decode_iframe_scan(sym_i, 30))[0]))
    del y, u, v, sym, dec_refs, sym_i, out
    box = {}
    names = ("_references", "_int_winner", "_inter_encode", "_inter_decode")
    sads = cs.capture(me_cuda, "sad_field", lambda: box.update(
        got=cs.capture_all(pframe, names, lambda: box.update(
            p=cs.pframe_480p_2ref(dev, torch)))))
    got = box["got"]
    two = "854x480 x 8 default-config P frame, two references"
    cases += [("K11", f"{two}: encode", got["_references"][-2]),
              ("K11", f"{two}: decode", got["_references"][-1])]
    cases += [("K12", f"{two}: reference {i}", kw)
              for i, kw in enumerate(got["_int_winner"][-2:])]
    cases += [("K1", f"{two}: reference {i}",
               dict(y=kw["y"], n=i, refs=got["_references"][-2]))
              for i, kw in enumerate(sads[-2:])]
    cases += [("K9", two, dict(_planeless(got["_inter_encode"][-1]),
                                refs=got["_references"][-2])),
              ("K10", f"{two}: decode", dict(
                  _planeless(got["_inter_decode"][-1]),
                  refs=got["_references"][-1]))]
    _, refs, sym, _, _ = cs.pframe_480p(dev, torch, t8=False, gap=8)
    cases.append(("K5", "854x480 x 8 meeting P frame 8 frames on "
                  "(defaults, intra-in-P)", cs.d2_capture(
                      lambda: pframe.decode_pframe_rows_multi(sym, *refs,
                                                              30))[0]))
    del refs, sym
    import numpy as np

    cases.append(("K5-i44", "1080p x 4 IDR, every MB Intra_4x4",
                  cs.d2_args(torch, cs.d2_i44_case(np, (4, 68, 120), "i44",
                                                   30), dev)))
    kw, share, (aus, recon) = cs.session_idr_i44(dev, np)
    what = f"854x480 x 8 meeting session IDR, Intra_4x4 share {share:.4f}"
    cases += [("K5-i44", what, kw),
              ("D-i44", f"{what}: DecoderPool.decode_batch",
               dict(aus=aus, recon=recon))]
    return cases


def _planeless(kw):
    """A K9 / K10 call's arguments less its planes (each tree brings its
    own)."""
    return {k: v for k, v in kw.items()
            if k not in ("planes_l", "refs_up", "refs_vp")}


def k5_variant(spec: str):
    """K5's source built alone into the build directory, `spec` "[SRC:]
    NAME=V,...": this checkout's csrc/intra_recon.cu, or SRC (another
    version of it, its headers beside it), with those macros (e.g.
    K5_WORKERS, K5_RING).  K5's route (its Intra_4x4 route where the call
    has `i44`) through that build's entry, fn(**router kwargs)."""
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
                                              other, is_intra, i44)
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
    """This checkout's bytes bound of a case, ms."""
    from tpuh264_torch.kernels import pframe

    if stage == "K1":
        return cs.bound_ms(cs.k1_bytes(*kw["y"].shape))
    if stage in ("K9", "K10"):
        full = dict(kw, **dict(zip(("planes_l", "refs_up", "refs_vp"),
                                   pframe._references(**kw["refs"]))))
        del full["refs"]
        if stage == "K9":
            return cs.bound_ms(cs.k9_bytes(full))
        return cs.bound_ms(cs.k10_bytes(full,
                                        pframe._inter_decode(**full)[1]))
    if stage == "D-i44":  # host work: no device bound
        return None
    return cs.bound_ms({"K11": cs.k11_bytes, "K12": cs.k12_bytes,
                        "K5": cs.k5_bytes, "K5-i44": cs.k5_bytes}[stage](kw))


def flat(out):
    """A stage's output as a list of tensors (a decode's dict of planes
    by stream: each stream's, in stream order, as tensors)."""
    import torch

    if isinstance(out, dict):
        return [torch.as_tensor(p) for i in sorted(out) for p in out[i]]
    items = []
    for x in out:
        items += list(x) if isinstance(x, (list, tuple)) else [x]
    return [torch.as_tensor(x) for x in items]


def reading(fn, stage) -> float:
    """ms a call of fn: CUDA events over 20 calls behind a device sleep
    (chip_smoke.timed), 2 for a way slower than 50 ms a call (the plain
    routes); "D-i44", host work, the least of 3 fenced calls."""
    if stage == "D-i44":
        return min(cs.fenced_ms(fn) for _ in range(3))
    return cs.timed(fn, 2 if cs.fenced_ms(fn) > 50 else 20)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", action="append", default=[],
                    help="the root of another tree, e.g. from git archive")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--k5-variant", action="append", default=[],
                    help="K5 built with these macros, e.g. "
                    "K5_WORKERS=6,K5_RING=16, or SRC:[MACROS] another "
                    "source (timed as one more way, K5 and K5-i44)")
    ap.add_argument("--k12-blocks", action="append", type=int, default=[],
                    help="K12 at this many blocks an SM (one more way)")
    ap.add_argument("--only", default="K1,K5,K5-i44,D-i44,K9,K10,K11,K12",
                    help="the stages to time, e.g. K11,K9")
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernels' times are taken on the card")
    from tpuh264_torch.kernels import iframe, pframe

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    from tpuh264_torch.kernels import cuda_lib, me_cuda

    from tpuh264_torch import engine

    ways = [("this checkout", tree_ways(iframe, pframe, cuda_lib, me_cuda,
                                        engine))]
    for i, root in enumerate(a.parent):
        ways.append((f"tree {root}", tree_ways(*tree_kernels(
            root, f"tree{i}_tpuh264_torch"))))
    this = ways[0][1]
    for d in a.k5_variant:
        v = k5_variant(d)
        ways.append((f"K5 {d}", dict(this, **{"K5": v, "K5-i44": v})))
    for n in a.k12_blocks:
        ways.append((f"K12 {n} blocks an SM", dict(this, **k12_blocks(n))))
    cases = [c for c in inputs(dev, torch) if c[0] in a.only.split(",")]
    for stage, what, kw in cases:
        want = flat(plain_of(stage, kw))
        for name, fns in ways:
            if stage == "D-i44":  # cropped planes against the recon
                got = [x.long() for x in flat(fns[stage](kw["aus"]))]
                want_s = [w[:g.shape[0], :g.shape[1]].long()
                          for g, w in zip(got, want)]
            else:
                got = flat(fns[stage](**kw))
                want_s = want
            if stage == "K11":  # the planes' type is a tree's layout
                got, want_s = [x.long() for x in got], [x.long() for x in want]
            cs._all_equal(got, want_s, torch, f"{name}: {stage} ({what})")
    print(f"{card}; every way equal to the plain versions on every input")
    order = ways[:0:-1] + ways[:1] * 2 + ways[1:]
    bounds = [bound(stage, kw) for stage, _, kw in cases]
    for rnd in range(a.rounds):
        for (stage, what, kw), b in zip(cases, bounds):
            for name, fns in order:
                if stage == "D-i44":
                    ms = reading(lambda: fns[stage](kw["aus"]), stage)
                    print(f"round {rnd}: {stage} {what}: {name}: {ms:.1f} "
                          f"ms (host wall, fenced) [{card}]")
                    continue
                ms = reading(lambda: fns[stage](**kw), stage)
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
