#!/usr/bin/env python3
"""Time the P-frame inter path's kernels, K9 (the P encode after stage A,
tpuh264_torch/csrc/pframe_enc.cu) and K10 (the P decode's inter part,
csrc/pframe_dec.cu), at chip_smoke.py phase 2's inputs, in turns with
other builds of them.

    python3 tools/time_pframe.py [--other DIR ...] [--variants]
                                 [--phases] [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are phase 2's: the 1920x1080 x 4 RTC P frame (one reference)
and its decode, and the 854x480 x 8 default-config P frame with two
references and its decode, as the P encode and decode pass them to their
routers `_inter_encode` / `_inter_decode` (the planes K11's uint8
layout, the 1080p decode's reference a uint8 DPB slot). DIR is a
directory holding another build's pframe_enc.cu and pframe_dec.cu with
the headers they include, built for this checkout's operands (the same
entry arguments and plane layout; a tree of another layout is timed
against this one by tools/time_refs.py --parent, through its own
routers); both are built with nvcc into tpuh264_torch/build/ as a
library of their own and called through this checkout's routers.
--variants adds K9 variants made from this checkout's source by the text
edits of VARIANTS (each undoes one part of the design, so that its time
says what that part bought). Every build is first held equal to the
plain versions on every input. Each round times the others, this, this,
the others (CUDA events behind a device sleep, 20 calls:
chip_smoke.timed) and prints each reading's ms and its share of the
bytes bound (chip_smoke.k9_bytes / k10_bytes) beside the card's name and
power limit; then ptxas's registers, stack, spills and shared memory of
each build. --phases first prints K9's cycles a MB by phase: a build
with clock64() read at each phase's end (PHASE_EDITS), each warp's
cycles written in place of its int32 fields, the mean over the MBs; the
SM clock read under load beside them.
"""

import argparse
import ctypes
import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402

CSRC = os.path.join(ROOT, "tpuh264_torch", "csrc")
SOURCES = ("pframe_enc.cu", "pframe_dec.cu")
ENTRIES = ("th264_pframe_encode", "th264_pframe_decode")

# K9 variants, each this checkout's pframe_enc.cu with one part of the
# design undone: (what it undoes, [(old text, new text), ...]).
VARIANTS = {
    "49-positions": (
        "(a) the 32 quarter-pel positions no selection reads computed too",
        [("    cost += a.ref_cost[n];\n",
          "    {  // 32 SADs the selections never read, kept alive\n"
          "      unsigned sink = 0;\n"
          "#pragma unroll 4\n"
          "      for (int k = 0; k < 32; ++k)\n"
          "        sink += __reduce_add_sync(kFull, sad8(src, qpel8(\n"
          "            win, oy, ox, k / 7 - 3, k % 7 - 3, row, col)));\n"
          "      if (sink == kFull) bsad = -1;\n"
          "    }\n"
          "    cost += a.ref_cost[n];\n")]),
    "shuffle-sums": (
        "(c) each SAD by a 5-step xor-shuffle chain, not redux.sync",
        [("sad[k] = (int)__reduce_add_sync(kFull, sad[k]);",
          "sad[k] = (int)warp_sum((unsigned)sad[k]);")] * 2),
    "24-warps": (
        "(d) occupancy held to the first design's 6 blocks (24 warps) an "
        "SM by "
        "18,000 bytes of unused dynamic shared memory a block",
        [("32 * kWarps, 0,\n                         (cudaStream_t)stream",
          "32 * kWarps, 18000,\n                         (cudaStream_t)"
          "stream")]),
    "scalar-stores": (
        "(e) the luma levels and the int32 reconstruction stored a "
        "scalar at a time",
        [("        reinterpret_cast<int4*>(a.luma_ac + (size_t)m * 256 + 16 * "
          "lane)[half] =\n"
          "            make_int4((int)lw[0], (int)lw[1], (int)lw[2], "
          "(int)lw[3]);\n",
          "        for (int k = 0; k < 8; ++k)\n"
          "          a.luma_ac[(size_t)m * 256 + 16 * lane + 8 * half + k] "
          "=\n"
          "              (int16_t)(lw[k >> 1] >> (16 * (k & 1)));\n"),
         ("        *reinterpret_cast<int4*>(o + (4 * by + i) * n) =\n"
          "            make_int4(x[4 * i], x[4 * i + 1], x[4 * i + 2], "
          "x[4 * i + 3]);\n",
          "        for (int j = 0; j < 4; ++j) o[(4 * by + i) * n + j] = "
          "x[4 * i + j];\n")]),
}


# --phases: K9 with clock64() read at its phases' ends, each warp's cycles
# a phase summed over the references and written in place of the int32
# fields (its outputs are not the codec's): [(old text, new text), ...]
# and the phases' names, in the order of InterEnc's first eight fields.
PHASE_EDITS = [
    ("  const int crow = (lane & 15) >> 1, ccol = (lane & 1) * 4;  // its "
     "chroma 4\n",
     "  const int crow = (lane & 15) >> 1, ccol = (lane & 1) * 4;  // its "
     "chroma 4\n"
     "  long long tc = clock64(), ph[8] = {0, 0, 0, 0, 0, 0, 0, 0};\n"
     "  auto tick = [&](int k) {\n"
     "    const long long t = clock64();\n"
     "    ph[k] += t - tc, tc = t;\n"
     "  };\n"),
    ("  int best_cost = 0, best_mvx = 0,",
     "  tick(0);\n  int best_cost = 0, best_mvx = 0,"),
    ("                 16 * c + ix0 - 2 + a.pe, a.Hp, a.Wp, lane);\n"
     "    __syncwarp();\n",
     "                 16 * c + ix0 - 2 + a.pe, a.Hp, a.Wp, lane);\n"
     "    __syncwarp();\n    tick(1);\n"),
    ("    // stage C: the half-pel", "    tick(2);\n    // stage C: the half-pel"),
    ("    cost += a.ref_cost[n];\n", "    tick(3);\n    cost += a.ref_cost[n];\n"),
    ("  // the transforms: lanes 0-15",
     "  tick(4);\n  // the transforms: lanes 0-15"),
    ("  __syncwarp();\n  int dcq = 0;", "  tick(5);\n  __syncwarp();\n  int dcq = 0;"),
    ("  // the reconstruction: uncoded",
     "  tick(6);\n  // the reconstruction: uncoded"),
    ("  if (lane == 0) {\n    const bool skip",
     "  tick(7);\n  if (lane == 0) {\n    const bool skip"),
    ("    a.mvx[m] = mvx, a.mvy[m] = mvy, a.refsel[m] = best_ref;\n"
     "    a.sad[m] = best_sad, a.kind[m] = skip ? 0 : 1;\n"
     "    a.refidx[m] = skip ? 0 : best_ref + a.ref_base;\n"
     "    a.cbp_l[m] = cbp_l, a.cbp_c[m] = cbp_c;\n",
     "    a.mvx[m] = ph[0], a.mvy[m] = ph[1], a.refsel[m] = ph[2];\n"
     "    a.sad[m] = ph[3], a.kind[m] = ph[4], a.refidx[m] = ph[5] + 0 * skip;"
     "\n    a.cbp_l[m] = ph[6], a.cbp_c[m] = ph[7];\n"),
]
PHASES = ("source and winners in", "window loads", "stage B", "stages C / D",
          "MC", "transforms, levels out", "chroma DC, cbp ballots",
          "reconstruction out")


class _OtherLib:
    """The kernel library with another build's K9 and K10 entries."""

    def __init__(self, lib, enc, dec):
        self._lib = lib
        self.th264_pframe_encode = enc
        self.th264_pframe_decode = dec

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _through(lib, fn):
    """`fn` called with `lib` as the kernel library."""
    from tpuh264_torch.kernels import cuda_lib

    def call(**kw):
        saved = cuda_lib.load
        cuda_lib.load = lambda: lib
        try:
            return fn(**kw)
        finally:
            cuda_lib.load = saved
    return call


def build_other(src_dir: str, tag: str):
    """The K9 / K10 sources of `src_dir` built into tpuh264_torch/build/
    as a library of their own: (encode, decode) calls of this checkout's
    routers with that library's entries."""
    from tpuh264_torch.kernels import cuda_lib, pframe

    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD, f"libpframe_{tag}.so")
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-I", src_dir, "-o", out,
                          *(os.path.join(src_dir, s) for s in SOURCES)],
                         capture_output=True, text=True)
    if res.returncode != 0:
        cs.fail(f"nvcc {src_dir}: {res.stdout}{res.stderr}")
    so, real = ctypes.CDLL(out), cuda_lib.load()
    fns = []
    for name in ENTRIES:
        fn = getattr(so, name)
        fn.argtypes = getattr(real, name).argtypes
        fn.restype = ctypes.c_int
        fns.append(fn)
    lib = _OtherLib(real, *fns)
    return (_through(lib, pframe._inter_encode),
            _through(lib, pframe._inter_decode))


def variant_dir(name: str, edits) -> str:
    """A copy of this checkout's csrc/ under tpuh264_torch/build/ with the
    text `edits` made to pframe_enc.cu."""
    from tpuh264_torch.kernels import cuda_lib

    d = os.path.join(cuda_lib.BUILD, "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    path = os.path.join(d, "pframe_enc.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            cs.fail(f"variant {name}: its edit no longer applies")
        text = text.replace(old, new, 1)
    with open(path, "w") as f:
        f.write(text)
    return d


def phases(cases, torch, card) -> None:
    """The --phases mode: K9's warp cycles a MB by phase (PHASE_EDITS),
    the mean over the MBs, at each input."""
    enc, _ = build_other(variant_dir("phases", PHASE_EDITS), "phases")
    mhz = cs.busy_sm_clock()
    for what, ekw, _ in cases:
        ms = cs.timed(lambda: enc(**ekw), 20)
        o = enc(**ekw)
        cyc = [float(x.double().mean()) for x in o[:8]]
        print(f"phases, K9 {what}: {ms:.4f} ms with the clock reads; "
              f"{sum(cyc):.0f} cycles a MB a warp at {mhz} MHz [{card}]")
        for name, x in zip(PHASES, cyc):
            print(f"  {name:24s} {x:9.0f} cycles {100 * x / sum(cyc):5.1f}%")


def inputs(dev, torch):
    """[(what, encode kwargs, decode kwargs)] of phase 2's two frames."""
    from tpuh264_torch.kernels import pframe

    out = []
    enc, = cs.capture(pframe, "_inter_encode",
                      lambda: out.append(cs.pframe_1080p(dev, torch)))
    y, u, v, sym = out[0][:4]
    refs = ([y[0]], [u[0]], [v[0]])  # a uint8 DPB slot, as the pipeline's
    dec, = cs.capture(pframe, "_inter_decode",
                      lambda: pframe.decode_pframe_rows_multi(sym, *refs, 30))
    enc2, dec2, kinds = cs.pframe_480p_2ref(dev, torch)
    return [("1080p x 4 RTC P frame, one reference", enc, dec),
            (f"854x480 x 8 default-config P frame, two references (MB "
             f"kinds skip/inter/intra {kinds})", enc2, dec2)]


def check(enc, dec, cases, torch, name) -> None:
    """The build's K9 and K10 equal the plain versions on every input."""
    from tpuh264_torch.kernels import pframe

    for what, ekw, dkw in cases:
        flat = lambda o: [*o[:-1], *o.rec]
        cs._all_equal(flat(enc(**ekw)),
                      flat(pframe._inter_encode_plain(**ekw)), torch,
                      f"{name}: K9 ({what})")
        cs._all_equal([*sum(dec(**dkw), ())],
                      [*sum(pframe._inter_decode_plain(**dkw), ())], torch,
                      f"{name}: K10 ({what})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="a directory with another build's K9 / K10 sources")
    ap.add_argument("--variants", action="store_true",
                    help="also time the K9 variants of VARIANTS")
    ap.add_argument("--phases", action="store_true",
                    help="also K9's warp cycles a MB by phase (clock64)")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernels' times are taken on the card")
    from tpuh264_torch.kernels import pframe

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    builds = [("this checkout", pframe._inter_encode, pframe._inter_decode,
               CSRC)]
    for i, d in enumerate(a.other):
        builds.append((d, *build_other(d, f"other{i}"), d))
    if a.variants:
        for name, (_, edits) in VARIANTS.items():
            d = variant_dir(name, edits)
            enc, _ = build_other(d, name)
            builds.append((f"variant {name}", enc, None, d))
    cases = inputs(dev, torch)
    if a.phases:
        phases(cases, torch, card)
    for name, enc, dec, _ in builds:
        check(enc, dec or pframe._inter_decode, cases, torch, name)
    print(f"{card}; every build equal to the plain versions on both frames")
    order = builds[:0:-1] + builds[:1] * 2 + builds[1:]
    for rnd in range(a.rounds):
        for what, ekw, dkw in cases:
            kb = cs.bound_ms(cs.k9_bytes(ekw))
            db = cs.bound_ms(cs.k10_bytes(dkw, pframe._inter_decode(**dkw)[1]))
            for key, idx, kw, bound in (("K9", 1, ekw, kb), ("K10", 2, dkw, db)):
                for b in order:
                    if b[idx] is None:
                        continue
                    ms = cs.timed(lambda: b[idx](**kw), 20)
                    print(f"round {rnd}: {key} {what}: {b[0]}: {ms:.4f} ms, "
                          f"{100 * bound / ms:.1f}% of the bytes bound "
                          f"{bound:.4f} ms [{card}]")
    for name, _, _, d in builds:
        for src in SOURCES:
            for ln in cs.ptxas_lines(os.path.join(d, src)):
                print(f"ptxas, {name}, {src}: {ln}")
    for name, (what, _) in VARIANTS.items():
        print(f"variant {name}: {what}")


if __name__ == "__main__":
    main()
