#!/usr/bin/env python3
"""Time the P-frame inter path's kernels, K9 (the P encode after stage A,
tpuh264_torch/csrc/pframe_enc.cu) and K10 (the P decode's inter part,
csrc/pframe_dec.cu), at chip_smoke.py phase 2's inputs, in turns with
other builds of them.

    python3 tools/time_pframe.py [--t8] [--other DIR ...]
                                 [--variants [NAME,...]] [--phases]
                                 [--sass] [--rounds N]

Run from the root of a checkout, on a machine with a CUDA card and nvcc.
The inputs are phase 2's: the 1920x1080 x 4 RTC P frame (one reference)
and its decode, and the 854x480 x 8 default-config P frame with two
references and its decode, as the P encode and decode pass them to their
routers `_inter_encode` / `_inter_decode` (the planes K11's uint8
layout, the 1080p decode's reference a uint8 DPB slot); with --t8 also
config 3's 1920x1080 x 1 P frame and part B's 854x480 x 8 one, two
references each, on the routes' t8 instances (chip_smoke.t8_rows'
inputs). DIR is a directory holding another build's pframe_enc.cu and
pframe_dec.cu with the headers they include, built for this checkout's
operands (the same entry arguments and plane layout; a tree of another
layout is timed against this one by tools/time_refs.py --parent,
through its own routers); both are built with nvcc into
tpuh264_torch/build/ as a library of their own and called through this
checkout's routers. --variants adds builds made from this checkout's
sources by the text edits of VARIANTS (each undoes one part of the
design, so that its time says what that part bought; all of them where
none is named). Every exact build is first held equal to the plain
versions on every input. Each round times the others, this, this, the
others (CUDA events behind a device sleep, 20 calls: chip_smoke.timed)
and prints each reading's ms and its share of the bytes bound
(chip_smoke.k9_bytes / k10_bytes) beside the card's name and power
limit, K9 also writing the frame's symbols into `empty_symbols` buffers
(the main path's route, mvds included; held equal to the plain version
first), and the mvd pass alone of each --other build that has one
(`pframe_mvd_kernel`, launched by an entry appended to a copy of its
source, MVD_ENTRY); then ptxas's registers, stack, spills and shared
memory of each build. --phases first prints a warp's cycles a MB by phase, K9's on
every input (its 8x8 trial a phase of its own) and K10's t8 route's: a
build with clock64() read at each phase's end (PHASE_EDITS), the cycles
written in place of output fields, the mean over the MBs; the SM clock
read under load beside them. --sass prints whether the instances without
t8 compile to the SASS of each --other build's.
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

# Variants, each this checkout's source with one part of the design
# undone: {name: (what it undoes, source, exact, [(old text, new text),
# ...])}.  An exact variant is held equal to the plain versions like any
# build; an inexact one (it leaves out work the codec needs) is only
# timed, for what that work costs.
VARIANTS = {
    "k9-serial-refs": (
        "K9-t8: reference 0's search waits for reference 1's copies too "
        "(the second reference's windows no longer land during the first's "
        "search)", "pframe_enc.cu", True,
        [("          cp_async_wait<1>();\n",
          "          cp_async_wait<0>();\n")]),
    "k9-qpel-lookups": (
        "K9-t8: each sub-pel candidate's components from the constant "
        "tables (kQpel, kCompPl / Dy / Dx) at a run-time index, not from two "
        "immediates", "pframe_enc.cu", True,
        [("unsigned e, int row,\n"
          "                                        int col) {\n"
          "  const int y = oy + (py >> 2) + row, x = ox + (px >> 2) + col;\n",
          "unsigned e, int row,\n"
          "                                        int col) {\n"
          "  const int f = (py & 3) * 4 + (px & 3);\n"
          "  const int c1 = kQpel[f][0], c2 = kQpel[f][1];\n"
          "  e = kCompPl[c1] | kCompDy[c1] << 2 | kCompDx[c1] << 3"
          " | (kCompPl[c2] | kCompDy[c2] << 2 | kCompDx[c2] << 3) << 4;\n"
          "  const int y = oy + (py >> 2) + row, x = ox + (px >> 2) + col;\n")]),
    "k9-winners-first": (
        "K9-t8: both references' winners and global vectors loaded before "
        "the first reference's copies (the copies' asm orders every load "
        "after it)", "pframe_enc.cu", True,
        [("  if constexpr (kT8) {\n"
          "    for (int n = 0; n < 2; ++n) {\n"
          "      if (n < a.N) {\n"
          "        const size_t am = (size_t)n * mbs + m;\n"
          "        const int iy0 = a.iy0[am], ix0 = a.ix0[am];\n"
          "        w.ref01[n][0] = iy0, w.ref01[n][1] = ix0;\n"
          "        w.ref01[n][2] = 4 * a.gy[n * a.S + s];\n"
          "        w.ref01[n][3] = 4 * a.gx[n * a.S + s];\n",
          "  if constexpr (kT8) {\n"
          "    int wn[2][4] = {};\n"
          "#pragma unroll\n"
          "    for (int n = 0; n < 2; ++n) {\n"
          "      if (n < a.N) {\n"
          "        const size_t am = (size_t)n * mbs + m;\n"
          "        wn[n][0] = a.iy0[am], wn[n][1] = a.ix0[am];\n"
          "        wn[n][2] = 4 * a.gy[n * a.S + s];\n"
          "        wn[n][3] = 4 * a.gx[n * a.S + s];\n"
          "      }\n"
          "    }\n"
          "#pragma unroll\n"
          "    for (int n = 0; n < 2; ++n) {\n"
          "      if (n < a.N) {\n"
          "        const int iy0 = wn[n][0], ix0 = wn[n][1];\n"
          "        w.ref01[n][0] = iy0, w.ref01[n][1] = ix0;\n"
          "        w.ref01[n][2] = wn[n][2], w.ref01[n][3] = wn[n][3];\n")]),
    "k9-rows-6-words": (
        "K9-t8: window rows 6 words apart (7: a lane's SAD rows on banks of "
        "their own) and chroma rows 4 (5), 5,600 bytes of shared memory a "
        "warp, not 6,464", "pframe_enc.cu", True,
        [("constexpr int kRowW = 7, kCWin = 11, kCRowW = 5;",
          "constexpr int kRowW = 6, kCWin = 11, kCRowW = 4;")]),
    "k9-64-registers": (
        "K9-t8: held to 64 registers (8 blocks, 32 warps an SM; the "
        "routes without t8 use 63 of their own)", "pframe_enc.cu", True,
        [("__launch_bounds__(32 * kWarps)\n    pframe_encode_kernel",
          "__launch_bounds__(32 * kWarps, 8)\n    pframe_encode_kernel")]),
    "k9-quarter-fractions": (
        "K9-t8: stage D's fraction components worked out a candidate "
        "(`qpel_pair` of the run-time fraction), not read from an immediate "
        "of the half-pel winner's parity", "pframe_enc.cu", True,
        [("      const unsigned e = half ? qpel_pair((py & 3) * 4 + (px & 3))\n"
          "                              : (unsigned)(eq >> (8 * k)) & 255u;\n",
          "      const unsigned e = qpel_pair((py & 3) * 4 + (px & 3)) + 0 * eq;\n")]),
    "k9-mvds-at-end": (
        "K9: the mvds' exchanges made at the warp's end, not as soon as its "
        "vector is final (their round trips then wait at the end)",
        "pframe_enc.cu", True,
        [("  if (a.mvdx && lane == 0) {\n    const unsigned long long word",
          "  if (false) {\n    const unsigned long long word"),
         ("      mvd_finish(a, m, got_l, mvx, mvy, true);\n",
          "      if (c > 0) got_l = atomicExch(a.pairs + m, mvd_word(mvx, mvy));"
          "\n      if (c + 1 < a.C)\n"
          "        got_r = atomicExch(a.pairs + m + 1, mvd_word(mvx, mvy));\n"
          "      mvd_finish(a, m, got_l, mvx, mvy, true);\n")]),
    "k10-40-registers": (
        "K10-t8: not held to 32 registers (the compiler's own count; fewer "
        "warps an SM)", "pframe_dec.cu", True,
        [("__launch_bounds__(32 * kWarps, 8)", "__launch_bounds__(32 * kWarps)")]),
    "k10-no-luma8": (
        "K10-t8: the 8x8 inverse of the t8 MBs left out (their luma as the "
        "4x4 route's; inexact)", "pframe_dec.cu", False,
        [("  if (t8mb) luma8(a, w.pred, w.lev, w.st, m, lane);\n"
          "  const bool luma = lane < 16 && !t8mb,",
          "  const bool luma = lane < 16,")]),
}


# --phases: K9 and K10 with clock64() read at their phases' ends.  K9:
# lane 0's cycles a phase (summed over the references) written in place
# of the int32 fields and the t8 flag; K10's t8 route: lane 16's (a
# chroma lane, which every MB's warp runs to its end) in place of its
# first recon samples of plane u (rows 0-1, columns 0-3: its own 4x4
# block's).  Their outputs are not the codec's.  {source: [(old text,
# new text), ...]} and the phases' names in the order they are written.
_TICK = ("  long long tc = clock64(), ph[{n}] = {{}};\n"
         "  auto tick = [&](int k) {{\n"
         "    const long long t = clock64();\n"
         "    ph[k] += t - tc, tc = t;\n"
         "  }};\n")
PHASE_EDITS = {
    "pframe_enc.cu": [
        ("  const int crow = (lane & 15) >> 1, ccol = (lane & 1) * 4;  // its "
         "chroma 4\n",
         "  const int crow = (lane & 15) >> 1, ccol = (lane & 1) * 4;  // its "
         "chroma 4\n" + _TICK.format(n=9)),
        ("  // the source as bytes: the lane's",
         "  tick(0);\n  // the source as bytes: the lane's"),
        ("  int best_cost = 0, best_mvx = 0,",
         "  tick(1);\n  int best_cost = 0, best_mvx = 0,"),
        ("      __syncwarp();  // every lane's copies and stores of the slot\n",
         "      __syncwarp();  // every lane's copies and stores of the slot\n"
         "      tick(2);\n"),
        ("      const int cost = b.cost + a.ref_cost[n];\n",
         "      tick(3);\n      const int cost = b.cost + a.ref_cost[n];\n"),
        ("                   16 * c + ix0 - 2 + a.pe, a.Hp, a.Wp, a.lp, lane);\n"
         "      __syncwarp();\n",
         "                   16 * c + ix0 - 2 + a.pe, a.Hp, a.Wp, a.lp, lane);\n"
         "      __syncwarp();\n      tick(2);\n"),
        ("      cost += a.ref_cost[n];\n", "      tick(3);\n      cost += a.ref_cost[n];\n"),
        ("  // the transforms: lanes 0-15",
         "  tick(4);\n  // the transforms: lanes 0-15"),
        ("  __syncwarp();\n  int dcq = 0;", "  tick(5);\n  __syncwarp();\n  int dcq = 0;"),
        ("  // the reconstruction: uncoded",
         "  tick(6);\n  // the reconstruction: uncoded"),
        ("  int use8 = 0;  // the t8 symbol before P_Skip\n",
         "  tick(7);\n  int use8 = 0;  // the t8 symbol before P_Skip\n"),
        ("  if (luma || chroma) {\n    const int n = luma ? 16 : 8;\n",
         "  tick(8);\n  if (luma || chroma) {\n    const int n = luma ? 16 : 8;\n"),
        ("  if (lane == 0) {\n    const bool skip",
         "  tick(7);\n  if (lane == 0) {\n    const bool skip"),
        ("    a.mvx[m] = mvx, a.mvy[m] = mvy, a.refsel[m] = best_ref;\n"
         "    a.sad[m] = best_sad, a.kind[m] = skip ? 0 : 1;\n"
         "    a.refidx[m] = skip ? 0 : best_ref + a.ref_base;\n"
         "    a.cbp_l[m] = cbp_l, a.cbp_c[m] = cbp_c;\n",
         "    a.mvx[m] = ph[0], a.mvy[m] = ph[1], a.refsel[m] = ph[2];\n"
         "    a.sad[m] = ph[3], a.kind[m] = ph[4], a.refidx[m] = ph[5] + 0 * skip;"
         "\n    a.cbp_l[m] = ph[6], a.cbp_c[m] = ph[7];\n"),
        ("    if (a.t8) a.t8[m] = skip ? 0 : use8;\n",
         "    if (a.t8) a.t8[m] = ph[8] + 0 * use8;\n"),
    ],
    "pframe_dec.cu": [
        ("  WarpMemT8& w = smem[warp];\n  const size_t m = mi;\n"
         "  const int s = mi / rc, r = (mi % rc) / a.C, c = mi % a.C;\n",
         "  WarpMemT8& w = smem[warp];\n  const size_t m = mi;\n"
         "  const int s = mi / rc, r = (mi % rc) / a.C, c = mi % a.C;\n"
         + _TICK.format(n=6)),
        ("  cp_async_commit();\n", "  cp_async_commit();\n  tick(0);\n"),
        ("  if (lane == 0) a.mvx[m] = mvx, a.mvy[m] = mvy;\n  const int ref",
         "  if (lane == 0) a.mvx[m] = mvx, a.mvy[m] = mvy;\n  tick(1);\n"
         "  const int ref"),
        ("  cp_async_wait<0>();\n", "  tick(2);\n  cp_async_wait<0>();\n"),
        ("  __syncwarp();  // the prediction and every lane's levels\n",
         "  __syncwarp();  // the prediction and every lane's levels\n"
         "  tick(3);\n"),
        ("  if (t8mb) luma8(a, w.pred, w.lev, w.st, m, lane);\n",
         "  if (t8mb) luma8(a, w.pred, w.lev, w.st, m, lane);\n  tick(4);\n"),
        ("        make_int4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);\n"
         "}\n\n}  // namespace\n",
         "        make_int4(d[4 * i], d[4 * i + 1], d[4 * i + 2], d[4 * i + 3]);\n"
         "  tick(5);\n"
         "  if (lane == 16)\n"
         "    for (int k = 0; k < 6; ++k) a.ru[m * 64 + (k < 4 ? k : k + 4)] = "
         "(int)ph[k];\n"
         "}\n\n}  // namespace\n"),
    ],
}
PHASES = {
    "pframe_enc.cu": ("t8: winners in, copies issued", "source in",
                      "windows: loads or waits", "stages B-D", "MC",
                      "transforms, levels out", "chroma DC, cbp ballots",
                      "reconstruction, out", "8x8 trial and choice"),
    "pframe_dec.cu": ("level copies issued", "fields, MV look-back", "MC",
                      "levels' wait", "luma8 (t8 MBs)",
                      "4x4 and chroma residuals, out"),
}


def edited(src: str, edits) -> str:
    """`src` (a source's text) with the text `edits` made, each once;
    raises ValueError where an edit's old text is not found."""
    for old, new in edits:
        if old not in src:
            raise ValueError(f"edit no longer applies: {old[:60]!r}")
        src = src.replace(old, new, 1)
    return src


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


# An entry that launches a build's mvd pass alone (the second kernel of
# K9's entry in builds before the mvds were folded into K9), appended to
# a copy of that build's pframe_enc.cu.
MVD_ENTRY = """
#ifdef __CUDACC__
extern "C" int th264_pframe_mvd_only(void* const* p, const int* n,
                                     void* stream) {
  const EncArgs a = enc_args(p, n);
  const int mbs = a.S * a.R * a.C;
  pframe_mvd_kernel<<<(mbs + kMvdThreads - 1) / kMvdThreads, kMvdThreads,
                      0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
#endif
"""


def build_other(src_dir: str, tag: str):
    """The K9 / K10 sources of `src_dir` built into tpuh264_torch/build/
    as a library of their own: (encode, decode) calls of this checkout's
    routers with that library's entries, and a call of its mvd pass alone
    on `_inter_encode`'s keyword arguments (with `out`), or None where the
    build has no mvd pass."""
    from tpuh264_torch.kernels import cuda_lib, pframe

    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    srcs = [os.path.join(src_dir, s) for s in SOURCES]
    with open(srcs[0]) as f:
        enc_src = f.read()
    has_pass = "pframe_mvd_kernel" in enc_src
    if has_pass:
        srcs[0] = os.path.join(cuda_lib.BUILD, f"pframe_enc_{tag}.cu")
        with open(srcs[0], "w") as f:
            f.write(enc_src + MVD_ENTRY)
    out = os.path.join(cuda_lib.BUILD, f"libpframe_{tag}.so")
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-shared", "-Xcompiler",
                          "-fPIC", "-I", src_dir, "-o", out, *srcs],
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
    mvd = None
    if has_pass:
        only = so.th264_pframe_mvd_only
        only.argtypes = real.th264_pframe_encode.argtypes
        only.restype = ctypes.c_int

        def mvd(**kw):
            """The pass on the operands of one K9 call with `out` (made
            once: the pass reads the vectors that call's buffers hold)."""
            ops = pframe._k9_operands(**kw)
            p, n = cuda_lib.pointers(ops[0] + ops[1]), cuda_lib.ints(ops[2])
            dev = kw["y32"].device

            def call():
                cuda_lib.check(only(p, n, cuda_lib.stream(dev)),
                               "th264_pframe_mvd_only")
                return ops
            return call
    return (_through(lib, pframe._inter_encode),
            _through(lib, pframe._inter_decode), mvd)


def sass_without_t8(src: str) -> dict:
    """{kernel: its SASS, addresses and encodings dropped} of the
    instances without t8 (the RTC and default routes) in the K9 or K10
    source `src`, compiled alone by nvcc into tpuh264_torch/build/."""
    from tpuh264_torch.kernels import cuda_lib

    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD, "sass_" + os.path.basename(
        os.path.dirname(os.path.dirname(os.path.abspath(src)))) + "_"
        + os.path.basename(src) + ".cubin")
    for cmd in ([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH, "-std=c++17",
                 "-O3", "-cubin", "-o", out, src],
                [os.path.join(os.path.dirname(cuda_lib._nvcc()), "cuobjdump"),
                 "-sass", out]):
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            cs.fail(f"{cmd[0]} {src}: {res.stdout}{res.stderr}")
    fns, name = {}, None
    for ln in res.stdout.splitlines():
        if "Function :" in ln:
            name = ln.split("Function :")[1].strip()
            fns[name] = []
        elif name and "/*" in ln and ";" in ln:
            fns[name].append(ln.split("*/", 1)[1].split(";")[0].strip())
    return {k: v for k, v in fns.items()
            if "ILb1E" not in k and "t8" not in k and "mvd" not in k}


def variant_dir(name: str, edits) -> str:
    """A copy of this checkout's csrc/ under tpuh264_torch/build/ with the
    text `edits` ({source: [(old, new), ...]}) made."""
    from tpuh264_torch.kernels import cuda_lib

    d = os.path.join(cuda_lib.BUILD, "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(CSRC, d)
    for src, ed in edits.items():
        path = os.path.join(d, src)
        with open(path) as f:
            text = f.read()
        try:
            text = edited(text, ed)
        except ValueError as e:
            cs.fail(f"variant {name}, {src}: {e}")
        with open(path, "w") as f:
            f.write(text)
    return d


def phases(cases, torch, card) -> None:
    """The --phases mode: K9's and K10's warp cycles a MB by phase
    (PHASE_EDITS), the mean over the MBs, at each input."""
    enc, dec, _ = build_other(variant_dir("phases", PHASE_EDITS), "phases")
    mhz = cs.busy_sm_clock()
    for what, ekw, dkw in cases:
        for key, fn, kw in (("K9", enc, ekw), ("K10", dec, dkw)):
            if key == "K10" and not kw.get("t8"):
                continue  # the clocks are in its t8 route
            ms = cs.timed(lambda: fn(**kw), 20)
            o = fn(**kw)
            if key == "K9":
                cyc = [float(x.double().mean()) for x in (*o[:8], o.t8)]
                names = PHASES["pframe_enc.cu"]
            else:
                ru = o[0][1].reshape(-1, 64).double()
                cyc = [float(ru[:, k if k < 4 else k + 4].mean())
                       for k in range(6)]
                names = PHASES["pframe_dec.cu"]
            print(f"phases, {key} {what}: {ms:.4f} ms with the clock reads; "
                  f"{sum(cyc):.0f} cycles a MB a warp at {mhz} MHz [{card}]")
            for name, x in zip(names, cyc):
                print(f"  {name:24s} {x:9.0f} cycles "
                      f"{100 * x / sum(cyc):5.1f}%")


def inputs(dev, torch, t8: bool):
    """[(what, encode kwargs, decode kwargs)] of phase 2's two frames and,
    with `t8`, config 3's P frame and part B's (`t8_rows`' inputs)."""
    from tpuh264_torch.kernels import pframe

    out = []
    enc, = cs.capture(pframe, "_inter_encode",
                      lambda: out.append(cs.pframe_1080p(dev, torch)))
    y, u, v, sym = out[0][:4]
    refs = ([y[0]], [u[0]], [v[0]])  # a uint8 DPB slot, as the pipeline's
    dec, = cs.capture(pframe, "_inter_decode",
                      lambda: pframe.decode_pframe_rows_multi(sym, *refs, 30))
    del out, y, u, v, sym, refs
    enc2, dec2, kinds = cs.pframe_480p_2ref(dev, torch)
    cases = [("1080p x 4 RTC P frame, one reference", enc, dec),
             (f"854x480 x 8 default-config P frame, two references (MB "
              f"kinds skip/inter/intra {kinds})", enc2, dec2)]
    if t8:
        enc3, dec3, kinds, n8 = cs.pframe_config3(dev, torch)
        cases.append((f"config 3 1920x1080 x 1 P frame, two references, t8 "
                      f"(MB kinds skip/inter/intra {kinds}, {n8} with the "
                      f"8x8 transform)", enc3, dec3))
        enc4, dec4, kinds = cs.pframe_480p_2ref(dev, torch, t8=True)
        cases.append((f"config 3 part B 854x480 x 8 P frame, two "
                      f"references, t8 (MB kinds skip/inter/intra {kinds})",
                      enc4, dec4))
    return cases


def check(enc, dec, cases, torch, name) -> None:
    """The build's K9 and K10 (where not None) equal the plain versions
    on every input, K9 also writing the symbols."""
    from tpuh264_torch.kernels import pframe

    for what, ekw, dkw in cases:
        flat = lambda o: [*o[:-1], *o.rec]
        if enc is not None:
            cs._all_equal(flat(enc(**ekw)),
                          flat(pframe._inter_encode_plain(
                              **cs.plain_args(ekw))), torch,
                          f"{name}: K9 ({what})")
            cs.k9_out_equal(cs.plain_args(ekw), torch,
                            f"{name}: K9 writing the symbols ({what})",
                            fn=enc)
        if dec is not None:
            cs._all_equal([*sum(dec(**dkw), ())],
                          [*sum(pframe._inter_decode_plain(**dkw), ())],
                          torch, f"{name}: K10 ({what})")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", action="append", default=[],
                    help="a directory with another build's K9 / K10 sources")
    ap.add_argument("--variants", nargs="?", const=",".join(VARIANTS),
                    default="", help="also time these VARIANTS (comma "
                    "separated; all where none is named)")
    ap.add_argument("--phases", action="store_true",
                    help="also K9's and K10's warp cycles a MB by phase "
                    "(clock64)")
    ap.add_argument("--t8", action="store_true",
                    help="also config 3's P frame and part B's (the t8 "
                    "routes)")
    ap.add_argument("--sass", action="store_true",
                    help="also whether the instances without t8 compile to "
                    "the SASS of each --other build's")
    ap.add_argument("--rounds", type=int, default=2)
    a = ap.parse_args()
    os.environ.setdefault("CUDA_VISIBLE_DEVICES", "0")
    import torch

    if not torch.cuda.is_available():
        cs.fail("no CUDA card: the kernels' times are taken on the card")
    from tpuh264_torch.kernels import pframe

    dev = torch.device("cuda", 0)
    card = cs.card_line(os.environ["CUDA_VISIBLE_DEVICES"].split(",")[0])
    # (name, K9 call or None, K10 call or None, source dir, exact)
    builds = [("this checkout", pframe._inter_encode, pframe._inter_decode,
               CSRC, True)]
    passes = []  # (name, the mvd pass alone on K9's arguments)
    for i, d in enumerate(a.other):
        enc, dec, mvd = build_other(d, f"other{i}")
        builds.append((d, enc, dec, d, True))
        if mvd is not None:
            passes.append((d, mvd))
    names = [n for n in a.variants.split(",") if n]
    for name in names:
        _, src, exact, edits = VARIANTS[name]
        d = variant_dir(name, {src: edits})
        enc, dec, _ = build_other(d, name)
        builds.append((f"variant {name}", *((enc, None) if src == SOURCES[0]
                                            else (None, dec)), d, exact))
    for d in a.other if a.sass else ():
        for src in SOURCES:
            mine = list(sass_without_t8(os.path.join(CSRC, src)).values())
            theirs = list(sass_without_t8(os.path.join(d, src)).values())
            same = len(mine) == len(theirs) == 1 and mine == theirs
            print(f"sass, {src}: the instance without t8 "
                  f"{'equals' if same else 'DIFFERS FROM'} {d}'s "
                  f"({[len(x) for x in mine]} / {[len(x) for x in theirs]} "
                  f"instructions)")
    cases = inputs(dev, torch, a.t8)
    if a.phases:
        phases(cases, torch, card)
    for name, enc, dec, _, exact in builds:
        if exact:
            check(enc, dec, cases, torch, name)
    print(f"{card}; every exact build equal to the plain versions on every "
          f"input")
    order = builds[:0:-1] + builds[:1] * 2 + builds[1:]
    for rnd in range(a.rounds):
        for what, ekw, dkw in cases:
            s, r, c = ekw["iy0"].shape[1:]
            okw = dict(cs.plain_args(ekw), out=pframe.empty_symbols(
                (s,), r, c, dev))
            kb = cs.bound_ms(cs.k9_bytes(ekw))
            ob = cs.bound_ms(cs.k9_bytes(okw))
            db = cs.bound_ms(cs.k10_bytes(dkw, pframe._inter_decode(**dkw)[1]))
            for key, idx, kw, bound in (("K9", 1, ekw, kb),
                                        ("K9 writing the symbols", 1, okw,
                                         ob), ("K10", 2, dkw, db)):
                for b in order:
                    if b[idx] is None:
                        continue
                    ms = cs.timed(lambda: b[idx](**kw), 20)
                    print(f"round {rnd}: {key} {what}: {b[0]}: {ms:.4f} ms, "
                          f"{100 * bound / ms:.1f}% of the bytes bound "
                          f"{bound:.4f} ms [{card}]")
            mb = cs.bound_ms(cs.mvd_bytes(ekw["iy0"][0]))
            for name, mvd in passes:
                ms = cs.timed(mvd(**okw), 20)
                print(f"round {rnd}: the mvd pass alone {what}: {name}: "
                      f"{ms:.5f} ms, {100 * mb / ms:.1f}% of the bytes bound "
                      f"{mb:.5f} ms [{card}]")
    for name, _, _, d, _ in builds:
        for src in SOURCES:
            for ln in cs.ptxas_lines(os.path.join(d, src)):
                print(f"ptxas, {name}, {src}: {ln}")
    for name in names:
        print(f"variant {name}: {VARIANTS[name][0]}")


if __name__ == "__main__":
    main()
