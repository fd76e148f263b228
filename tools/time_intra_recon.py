#!/usr/bin/env python3
"""Time the decoders' intra-reconstruction column scan three ways on the
same inputs: the kernel (K5, tpuh264_torch/csrc/intra_recon.cu), its
plain PyTorch version, and the plain version visiting only the columns
that hold an intra MB (the "skip" variant, which lives only here).

    python3 tools/time_intra_recon.py [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are the scan's own arguments in three decodes (chip_smoke.py
phase 2's): the 1920x1080 x 4 "rigid" P frame of the RTC preset (no
intra MB), the 854x480 x 8 "meeting" P frame of the CodecConfig
defaults (intra-in-P), coded against the frame 8 frames back (a few
intra MBs), and the 1920x1080 x 4 IDR (`decode_iframe_scan`: every MB
intra, so the skip variant is the plain scan).  The skip variant is exact: a column without an intra MB outputs
`other`, and so hands `other`'s right column to the next; it reads
is_intra to the host once a call.  All three are first held equal.  Each
round times kernel, plain, skip, skip, plain, kernel (CUDA events behind
a device sleep: chip_smoke.timed, which counts the host's time where the
host is slower than the card) and prints each reading beside the bytes
bound and the card's name and power limit.
"""

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def plain_skipping(mode, cmode, res, other=None, is_intra=None, i44=None):
    """The plain scan over the runs of columns that hold an intra MB,
    each from the column before it (which takes `other`); the rest of the
    output is `other`.  (`i44` is the scan's argument; always None here.)"""
    import torch

    from tpuh264_torch.kernels import iframe

    plain = iframe._intra_recon_scan_plain
    if other is None or i44 is not None:
        return plain(mode, cmode, res, other, is_intra, i44)
    cols = torch.nonzero(is_intra.any(0).any(0)).flatten().tolist()
    if not cols:
        return other
    out = [o.clone() for o in other]
    runs, start = [], cols[0]
    for a, b in zip(cols, cols[1:] + [None]):
        if b != a + 1:
            runs.append((max(start - 1, 0), a + 1))
            start = b
    for a, b in runs:
        cut = lambda xs: tuple(x[:, :, a:b] for x in xs)
        rec = plain(mode[:, :, a:b], cmode[:, :, a:b], cut(res), cut(other),
                    is_intra[:, :, a:b])
        for o, x in zip(out, rec):
            o[:, :, a:b] = x
    return tuple(out)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernel's times are taken on the card")
    from tpuh264_torch.kernels import iframe, pframe

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    y, u, v, sym, _, _ = cs.pframe_1080p(dev, torch)
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    sym_i, _ = iframe.encode_iframe_rows(y[0], u[0], v[0], 30)
    cases = [("1080p x 4 rigid P frame (RTC preset)", cs.d2_capture(
        lambda: pframe.decode_pframe_rows_multi(sym, *refs, 30))[0])]
    cases.append(("1080p x 4 IDR (decode_iframe_scan)", cs.d2_capture(
        lambda: iframe.decode_iframe_scan(sym_i, 30))[0]))
    _, refs, sym, _, _ = cs.pframe_480p(dev, torch, t8=False, gap=8)
    cases.append(("480p x 8 meeting P frame 8 frames on (defaults, "
                  "intra-in-P)",
                  cs.d2_capture(lambda: pframe.decode_pframe_rows_multi(
                      sym, *refs, 30))[0]))
    del y, u, v, sym, sym_i, refs
    ways = [("kernel", iframe._intra_recon_scan, 20),
            ("plain", iframe._intra_recon_scan_plain, 2),
            ("skip", plain_skipping, 3)]
    for what, kw in cases:
        want = iframe._intra_recon_scan_plain(**kw)
        for name, fn, _ in ways:
            if not all(torch.equal(x, w) for x, w in zip(fn(**kw), want)):
                cs.fail(f"{name} differs from the plain version ({what})")
        mode = kw["mode"]
        intra = (torch.ones_like(mode, dtype=torch.bool)
                 if kw.get("is_intra") is None else kw["is_intra"])
        print(f"{what}: {list(mode.shape)}, {int(intra.sum())} of "
              f"{mode.numel()} MBs intra, {int(intra.any(0).any(0).sum())} "
              f"of {mode.shape[-1]} columns hold one; all three equal "
              f"[{card}]")
    print(card)
    for rnd in range(a.rounds):
        for what, kw in cases:
            bound = cs.bound_ms(cs.k5_bytes(kw))
            for name, fn, iters in ways + ways[::-1]:
                ms = cs.timed(lambda: fn(**kw), iters)
                print(f"round {rnd}: {what}: {name}: {ms:.4f} ms, "
                      f"{100 * bound / ms:.2f}% of the bytes bound "
                      f"{bound:.4f} ms [{card}]")


if __name__ == "__main__":
    main()
