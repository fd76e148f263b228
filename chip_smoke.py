#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpuh264_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc
(/usr/local/cuda or CUDA_HOME).  It builds the port's CUDA kernels from
tpuh264_torch/csrc, then:

  1. prints the card (nvidia-smi name and power limit) and builds the
     port's two libraries: the CUDA kernels (nvcc) and the host CAVLC
     engine (g++, a copy of native/cavlc.cpp);
  2. holds K1 (stage-A SAD table), K2 (CAVLC block pack) and K3 (bit-
     string merge) against their plain PyTorch versions on the card
     (exact equality) at the main path's 1920x1080 x 4 shapes, K3 at its
     MB level (27 chunks -> 128 words) and its slice level (K = 123
     strings -> 8192 words), with the winner selection's first-index ties
     on the card; all three again on seeded edge cases (K1: samples 0 and
     255, the maximum SAD, ragged tiles, S = 1 and 4; K2: escape levels,
     16 nonzeros, chroma DC, nh 0..8, n_w 1 / 6 / 20 / 32 with
     truncation, code_residual 0; K3: all-ones strings of 0, 1, 31, 32,
     33 and 32*W bits, empty lanes, K 1 / 27 / 123 x W 1 / 20 / 128 x
     n_out 1 / 16 / 128 / 8192 with truncation), and K2/K3 on intra-in-P
     P symbols at 854x480 x 8 (skip, inter and intra MBs; slice level
     K = 57); times each kernel beside its plain version (CUDA events,
     after a warm-up) and against its bound (the bytes it must move over
     the card's 3.35 TB/s), and one fenced `encode_bits_pframe` call;
  3. at 64x48 x 2 the GPU emits the CPU's bytes (plain versions) and
     decoder DPB on every path: the RTC preset, intra-in-P, two
     references, host ingest with fan-out 2 and a drop_frames, and the
     I-only DevicePipeline; the intra-in-P and two-reference cases code
     intra MBs in P frames; and on the session path (EncoderSession,
     DecoderPool), 6 frames across an IDR: intra44 with deblock (Intra_4x4
     MBs required), two references, three temporal layers, single slice
     with gop 1, and with CABAC: the 8x8 transform + deblock + two
     references, three temporal layers + deblock, intra44 at gop 4
     (Intra_4x4 MBs required) -- GPU bytes and recon == CPU's, GPU
     decoders == recon (the CPU tests decode the same CPU bytes in the
     JAX package's golden decoder);
  4. drives the main path -- GOPDevicePipeline, 1920x1080 x 4 streams, CBR
     4 Mbps, RTC preset, gop 8, "rigid" source -- for 3 dispatches
     (crossing an IDR): after every dispatch the decode-from-bits DPB
     equals the encoder DPB bit for bit, and K3 launched twice (MB and
     slice level) per entropy call: 4 times per IDR dispatch, 2 per
     interior one;
  5. runs `run()` briefly at that configuration and at 854x480 x 8 streams
     at 1 Mbps and prints aggregate fps, the stage split, PSNR and QP;
  6. the reference's operating point with the default CodecConfig
     (intra-in-P): 854x480 x 8, CBR 1 Mbps, gop 8, 3 dispatches, decoder
     DPB == encoder DPB after each; the share of intra MBs in P frames;
     the fenced time of one P-frame encode with intra-in-P on and off;
  7. two references at that shape: decoder DPB == encoder DPB after each
     dispatch, K1 launched once per active reference per P frame, the
     share of MBs that chose reference 1;
  8. host ingest -> fan-out 8: one 854x480 stream of camera-like host
     frames at QP 32, decoded eight times, with a drop_frames: all eight
     decode streams equal the encoder DPB; intra MBs coded in P frames;
     the upload ms per dispatch;
  9. the I-only DevicePipeline at 854x480, decoded 8 times from symbols;
     the port's own decode of a frame's bytes (`decode_bytes`: native
     parse + I scan) equals the encoder's reconstruction;
 10. the live App (impl "tpu_gop") with the defaults at 854x480 x 8 for
     10 s, or longer until its first dispatch has retired: its stats,
     capture drops included, then stop();
 11. EncoderSession at the reference's operating point, 854x480 x 8 from
     RGBA (a different "meeting" clip frame per stream), intra44 +
     deblock, gop 8, CBR 1 Mbps, 10 frames across an IDR: every frame's 8
     access units through DecoderPool.decode_batch == the recon; Intra_4x4
     MBs coded in the IDR frames; K1 launched once per P frame; per-frame
     copy / encode / entropy / decode ms;
 12. single-slice I frames (the wavefront) at 854x480 x 8, gop 1, 2
     frames, each stream decoded by its own DecoderSession == the recon;
 13. the live App with impl "tpu" (the session Pipeline: 1 encoder ->
     ring -> 8 decoders) at 854x480 for 10 s: its stats, then stop();
     every decoder == the encoder recon at the last frame;
 14. the conformance gate (`tpuh264_torch.conformance.gate`): `run_gate`
     at every GATE_SHAPES shape (64x48 x 2 and 854x480 x 8 intra-in-P,
     1920x1080 x 4 RTC; 2 dispatches of "rigid" at QP 33) and
     `run_gate_extended` (128x96 x 2, CBR with a scene cut, host ingest,
     fan-out 2, 4 dispatches), every decoded picture it checks equal to
     the oracle's decode of the card's bytes -- libavcodec where it
     loads, else the golden decoder -- and the oracle, pictures and
     seconds printed; then a crafted general stream (a 20-pel MV)
     through DecoderSession on the card: the I frame on the fast path,
     the P frame on the golden one, both equal to the golden decode (and
     to libavcodec's where it loads);
 15. BASELINE config 3 on the card (tools/bench_config3.py's session):
     EncoderSession 1920x1080, CABAC + 8x8 transform, 2 references, CBR
     4 Mbps, intra-in-P, gop 6, 6 frames of "rigid" (IDR + 5 P), each
     access unit through a DecoderSession == the recon; MBs coded with
     the 8x8 transform and with reference 1 required; K1 launched once
     per P frame and searched reference (1 + 2 x 4 = 9); the whole
     stream decoded by the golden decoder in a spawned worker == the
     recon of every frame, beside part B: 854x480 x 8 from RGBA, CABAC +
     8x8 transform + deblock, 2 references, CBR 1 Mbps, gop 8, 4 frames
     through DecoderPool.decode_batch (per session: CABAC does not
     batch) == the recon; per-frame copy / encode / entropy / decode
     ms, kbps at 30 fps, PSNR-Y, QP, and the t8 / reference-1 / intra
     shares of the P MBs;
 16. the distribution layer, device_pack and the bench harness: (a)
     BASELINE config 5 cut to one card -- 4 ranks (processes) sharing it
     under gloo, mesh (streams 2, rows 2), 16 x 1920x1080 "rigid", I + 2
     P at QP 30 through `dist.mesh.sharded_gop_step` with the fused halo:
     every frame's gathered symbols, recon and motion == the unsharded
     encode on the card, MVs across the band edge, each rank's halo
     decode == its band, K1 once per rank per P frame (8), its plain
     version never; (b) `python -m tpuh264_torch.dist.multihost`, 2
     processes, both layouts at 832x480: bitexact; (c) a 1-rank NCCL
     group at 854x480 x 8 == the unsharded encode; (d)
     `device_pack.assemble_iframe` / `assemble_pframe` at 854x480 x 8:
     card bytes == CPU bytes, the golden decode == recon; (e)
     `bench.harness.run_matrix` at 480p x 8 ("tpu_gop", "tpu"), its
     table and charts.  Every spawned process has a timeout; on a failure
     all are killed and the run fails.

Every path of phases 4 and 6-16 is driven with the kernels' launch
counts set to 0 just before it and read just after; each must have
launched every kernel it runs (phase 12 and the general stream have no
P frame on the fast path, so none), and none may reach the plain
version of K1 or K3.  No session of the engine's own streams (phases
11-13 and 15) may leave the fast path for the golden decoder.
Any failure exits non-zero.  The last two lines are the kernel table
(launches summed over those paths; phase 16's worker processes report
theirs in their result lines and the sums include them) and
{"ok": true, "device": {...}}.  Nothing here imports JAX or the JAX
package tpuh264; the run fails if either was loaded.
"""

import json
import os
import subprocess
import sys
import time

T_START = time.perf_counter()


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line(card: str) -> str:
    """nvidia-smi's name and power limit of `card` (an index or UUID)."""
    res = subprocess.run(
        ["nvidia-smi", "-i", card, "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def timed(fn, iters: int) -> float:
    """Mean ms per call on the card: one warm-up call, then CUDA events
    around `iters` calls queued behind a ~20 ms device sleep, so that the
    events time the card and not the host's launch rate (a wrapper's
    Python takes tens of us, as long as K3 itself).  Where the host takes
    longer than the sleep to queue the calls, as for the plain versions'
    thousands of eager ops, its time shows."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(40_000_000)  # cycles: ~20 ms at the H100's clocks
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / iters


def fenced_ms(fn) -> float:
    """Host wall ms of one call, synchronised before and after."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def max_abs_err(x, y) -> int:
    return int((x.long() - y.long()).abs().max().item()) if x.numel() else 0


class Launches:
    """The three wrappers' launch counts, zeroed before and read after each
    path the smoke drives; summed over those paths for the kernel table.
    The plain versions of K1 (`_sad_field`) and K3 (`tree_merge`) are
    counted too: neither may run on a path."""

    def __init__(self):
        from tpuh264_torch.kernels import cavlc_cuda, me_cuda

        self.fns = (me_cuda.sad_field, cavlc_cuda.pack_blocks,
                    cavlc_cuda.merge_tree)
        self.total = [0, 0, 0]

    def path(self, name, fn, needs=(0, 1, 2)):
        from tpuh264_torch.kernels import cavlc_cuda, me_cuda

        for f in self.fns:
            f.launches = 0
        plains = [(me_cuda, "_sad_field"), (cavlc_cuda, "tree_merge")]
        saved = [getattr(m, a) for m, a in plains]
        calls = [[], []]
        for (m, a), f, c in zip(plains, saved, calls):
            setattr(m, a, lambda *x, f=f, c=c: c.append(1) or f(*x))
        try:
            out = fn()
        finally:
            for (m, a), f in zip(plains, saved):
                setattr(m, a, f)
        counts = [f.launches for f in self.fns]
        for i, n in enumerate(counts):
            self.total[i] += n
        print(f"launches [{name}]: K1 {counts[0]}, K2 {counts[1]}, "
              f"K3 {counts[2]}; plain K1 calls {len(calls[0])}, plain K3 "
              f"calls {len(calls[1])}")
        if any(counts[i] <= 0 for i in needs):
            fail(f"{name}: a kernel of the path was never launched: {counts}")
        if calls[0] or calls[1]:
            fail(f"{name}: a plain version ran (K1 {len(calls[0])}, K3 "
                 f"{len(calls[1])} times)")
        return out, counts


HBM_BPS = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
NO_LIBRARY = {
    "K1": "no single PyTorch call: torch.cdist(p=1) would first need the "
          "289 candidate patches of every MB unfolded, and that is the work",
    "K2": "no PyTorch call encodes CAVLC",
    "K3": "no PyTorch call concatenates variable-length bit strings",
}


def bound_ms(nbytes: int) -> float:
    """Least ms to move `nbytes` through device memory (each input read
    once, each output written once); every kernel here is bound by bytes:
    its arithmetic is small integer work, far under the card's peaks."""
    return nbytes / HBM_BPS * 1e3


def kernel_row(key, name, source, replaces, err, ms, plain_ms, nbytes):
    return dict(name=f"{key} {name}", route="cuda", source=source,
                replaces=replaces, max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bound_ms(nbytes),
                bound_by="bytes", library_ms=None, key=key)


def show(r, where):
    print(f"phase 2: {r['name']}: equal to plain (max_abs_err "
          f"{r['max_abs_err']}); kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}): {100 * r['bound_ms'] / r['ms']:.1f}% of the "
          f"bound, {where}; library call: none ({NO_LIBRARY[r['key']]})")


def k1_bytes(s, h, w) -> int:
    """The even source samples, the window of the G plane that the +-R
    candidates reach ((h + 2R - 1) x (w + 2R - 1) samples, not the whole
    padded plane), and the table, int32."""
    from tpuh264_torch.golden.inter import SEARCH_RANGE as R

    return 4 * s * ((h // 2) * (w // 2) + (h + 2 * R - 1) * (w + 2 * R - 1)
                    + (h // 16) * (w // 16) * (2 * R + 1) ** 2)


def k2_bytes(n, nh, n_w) -> int:
    """levels, nc / maxc / code_residual, nh header slots (len + value)
    in; n_w words + the bit length out; int32."""
    return 4 * n * (16 + 3 + 2 * nh + n_w + 1)


def k3_bytes(bits, w, n_out) -> int:
    """The bit lengths, the words the strings use (<= w each), and n_out
    words + the total bit length out per lane; int32."""
    used = int(((bits.long() + 31) // 32).clamp(0, w).sum())
    return 4 * (bits.numel() + used + (bits.numel() // bits.shape[-1])
                * (n_out + 1))


def k3_equal(words, bits, n_out, torch, what) -> int:
    """K3 against tree_merge on one input; fails unless equal."""
    from tpuh264_torch.kernels import cavlc_cuda

    ko, kb = cavlc_cuda.merge_tree(words, bits, n_out)
    po, pb = cavlc_cuda.tree_merge(words, bits, n_out)
    torch.cuda.synchronize()
    if not (torch.equal(kb, pb) and torch.equal(ko, po)):
        fail(f"K3 merge_tree differs from its plain version ({what})")
    return max(max_abs_err(ko, po), max_abs_err(kb, pb))


def k23_rows(sym, torch, what):
    """K2 and K3 (MB level) against their plain versions on the P symbols
    `sym` (rows for the kernel table); K3's slice level on the strings
    `encode_bits_pframe` builds from them, and that call fenced."""
    from tpuh264_torch.core.params import PPS, SPS
    from tpuh264_torch.core.sliceheader import SLICE_P
    from tpuh264_torch.entropy.device_pack import slice_headers_device
    from tpuh264_torch.kernels import cavlc_cuda, entropy_gpu

    args, code_res, present, _ = entropy_gpu.pframe_pack_inputs(sym)
    kw, kb = cavlc_cuda.pack_blocks(*args, 20, 6, code_residual=code_res)
    pw, pb = cavlc_cuda._pack_blocks_plain(*args, 20, code_res)
    torch.cuda.synchronize()
    if not (torch.equal(kb, pb) and torch.equal(kw, pw)):
        fail("K2 pack_blocks differs from its plain version")
    k2 = kernel_row(
        "K2", "pack_blocks (CAVLC block symbolise + pack)",
        "tpuh264_torch/csrc/cavlc_pack.cu",
        "tpuh264/kernels/cavlc_pallas.py:114",
        max(max_abs_err(kw, pw), max_abs_err(kb, pb)),
        timed(lambda: cavlc_cuda.pack_blocks(*args, 20, 6,
                                             code_residual=code_res), 20),
        timed(lambda: cavlc_cuda._pack_blocks_plain(*args, 20, code_res), 2),
        k2_bytes(kb.numel(), 6, 20))
    del pw, pb, args
    cb = torch.where(present, kb, 0).contiguous()
    cw = torch.where(present[..., None], kw, 0).contiguous()
    k3 = kernel_row(
        "K3", "merge_tree (chunk -> MB and MB -> slice bit-string merge)",
        "tpuh264_torch/csrc/cavlc_merge.cu",
        "tpuh264/kernels/cavlc_pallas.py:486",
        k3_equal(cw, cb, 128, torch, f"MB level, {what}"),
        timed(lambda: cavlc_cuda.merge_tree(cw, cb, 128), 20),
        timed(lambda: cavlc_cuda.tree_merge(cw, cb, 128), 3),
        k3_bytes(cb, cw.shape[-1], 128))
    del kw, kb, cw, cb

    s, r, c = sym.kind.shape
    hdr = slice_headers_device(SPS.for_size(16 * c, 16 * r), PPS(), 30, 1,
                               False, s, slice_type=SLICE_P, deblock_idc=2,
                               device=sym.kind.device)
    parts = entropy_gpu.pframe_slice_parts(sym, *hdr)[:2]
    sw, sb, _ = entropy_gpu.slice_strings(*parts)
    del parts
    n_out = entropy_gpu.SLICE_W
    err = k3_equal(sw, sb, n_out, torch, f"slice level, {what}")
    ms = timed(lambda: cavlc_cuda.merge_tree(sw, sb, n_out), 20)
    plain = timed(lambda: cavlc_cuda.tree_merge(sw, sb, n_out), 2)
    bound = bound_ms(k3_bytes(sb, sw.shape[-1], n_out))
    print(f"phase 2: K3 slice level, {what}: {list(sw.shape)} -> "
          f"{n_out} words: equal to plain (max_abs_err {err}); kernel "
          f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms (bytes): "
          f"{100 * bound / ms:.1f}% of the bound")
    del sw, sb
    enc = [round(fenced_ms(lambda: entropy_gpu.encode_bits_pframe(
        sym, 30, *hdr)), 3) for _ in range(3)]
    print(f"phase 2: encode_bits_pframe, {what}, one call fenced: {enc} ms")
    return [k2, k3]


def k1_edges(dev, torch, np):
    """K1 on seeded edge cases: samples only 0 and 255, the maximum SAD
    (16,320 everywhere), ragged tiles (864 and 80 wide), S = 1 and 4."""
    from tpuh264_torch.kernels import me_cuda, pframe

    rng = np.random.default_rng(11)
    for s, h, w, kind in ((4, 1088, 1920, "0/255"), (1, 480, 864, "0/255"),
                          (1, 480, 864, "uniform"), (4, 48, 80, "max"),
                          (1, 48, 80, "0/255")):
        if kind == "max":
            y = np.full((s, h, w), 255, np.int32)
            ref = np.zeros((s, h, w), np.int32)
        elif kind == "0/255":
            y, ref = (rng.integers(0, 2, (2, s, h, w)) * 255).astype(np.int32)
        else:
            y, ref = rng.integers(0, 256, (2, s, h, w)).astype(np.int32)
        yd = torch.from_numpy(y).to(dev)
        g = pframe.build_halfpel_planes(torch.from_numpy(ref).to(dev))[0]
        k = me_cuda.sad_field(yd, g)
        p = me_cuda._sad_field(yd[:, ::2, ::2], g, h, w)
        torch.cuda.synchronize()
        if not torch.equal(k, p):
            fail(f"K1 differs from plain on {kind} samples, S={s}, {w}x{h}")
        if kind == "max" and not (k == 16320).all():
            fail("K1: the maximum SAD is not 16,320 everywhere")
        print(f"phase 2: K1 edge case S={s} {w}x{h} ({w // 16} MB columns), "
              f"{kind} samples: equal to plain, SAD range "
              f"{int(k.min())}..{int(k.max())}")


def k2_case(rng, np, n, nh):
    """Seeded K2 inputs: a quarter each of sparse small levels, 16 nonzero
    coefficients up to escape size, one or two escape-size levels, and
    all-zero blocks; maxc 16 / 15 / 4 (chroma DC: nc -1); 30% of rows
    with code_residual 0; header slots of 0..32 bits."""
    kind = rng.integers(0, 4, n)
    maxc = rng.choice(np.array([16, 15, 4], np.int32), n)
    maxc[kind == 1] = 16
    sign = rng.choice(np.array([-1, 1]), (n, 16))
    lv = rng.integers(-3, 4, (n, 16))
    lv[rng.random((n, 16)) < 0.6] = 0
    big = sign * rng.integers(1, 30001, (n, 16))
    lv[kind == 1] = big[kind == 1]
    esc = (kind == 2)[:, None] & (rng.random((n, 16)) < 0.12)
    lv[kind == 2] = 0
    lv[esc] = big[esc]
    lv[kind == 3] = 0
    lv[np.arange(16)[None, :] >= maxc[:, None]] = 0
    nc = rng.integers(0, 17, n).astype(np.int32)
    nc[maxc == 4] = -1
    cr = (rng.random(n) >= 0.3).astype(np.int32)
    hl = rng.integers(0, 33, (n, nh))
    hv = rng.integers(0, 1 << 32, (n, nh), dtype=np.uint64)
    hv &= np.where(hl > 0, (np.uint64(1) << hl.astype(np.uint64))
                   - np.uint64(1), np.uint64(0xFFFFFFFF))
    return (lv.astype(np.int32), nc, maxc.astype(np.int32), cr,
            hl.astype(np.int32), hv.astype(np.uint32).view(np.int32))


def k2_edges(dev, torch, np):
    """K2 on seeded edge cases: nh 0..8 x n_w 1, 6, 20, 32 (truncating)."""
    from tpuh264_torch.kernels import cavlc_cuda

    rng = np.random.default_rng(12)
    n = 4096 + 77  # a ragged last block
    trunc = 0
    for nh in range(9):
        for n_w in (1, 6, 20, 32):
            lv, nc, mc, cr, hl, hv = [torch.from_numpy(a).to(dev)
                                      for a in k2_case(rng, np, n, nh)]
            kw, kb = cavlc_cuda.pack_blocks(lv, nc, mc, hl, hv, n_w, nh,
                                            code_residual=cr)
            pw, pb = cavlc_cuda._pack_blocks_plain(lv, nc, mc, hl, hv, n_w,
                                                   cr)
            torch.cuda.synchronize()
            if not (torch.equal(kb, pb) and torch.equal(kw, pw)):
                fail(f"K2 differs from plain on edge cases nh={nh} "
                     f"n_w={n_w}")
            trunc += int((kb > 32 * n_w).sum())
    print(f"phase 2: K2 edge cases nh 0..8 x n_w 1/6/20/32, {n} rows each "
          f"(escape levels, 16 nonzeros, chroma DC, code_residual 0): equal "
          f"to plain; {trunc} rows truncated at n_w words")


K3_LANES = 32 * 16 + 5  # ragged: merge_warp takes 4 lanes a warp, 32 a block


def k3_case(rng, np, n, k, w):
    """Seeded K3 inputs: n lanes of k MSB-first strings of w words, each
    zero past its bit length and within its budget (<= 32*w bits).  Lanes
    cycle through four kinds: random lengths and words; lengths 0, 1, 31,
    32, 33 and 32*w in turn (those <= 32*w), words all ones up to the
    length, so a wrong shift shows; every string empty; strings all ones
    within 40 bits of 32*w (lane totals past 32*n_out at narrow outputs)."""
    cap = 32 * w
    kind = np.arange(n) % 4
    bits = rng.integers(0, cap + 1, (n, k))
    edge = np.array([b for b in (0, 1, 31, 32, 33, cap) if b <= cap])
    n1 = int((kind == 1).sum())
    bits[kind == 1] = edge[np.arange(n1 * k).reshape(n1, k) % len(edge)]
    bits[kind == 2] = 0
    bits[kind == 3] = cap - rng.integers(0, min(cap, 40) + 1,
                                         (int((kind == 3).sum()), k))
    raw = rng.integers(0, 1 << 32, (n, k, w), dtype=np.uint64)
    raw[kind != 0] = 0xFFFFFFFF
    keep = np.clip(bits[..., None] - 32 * np.arange(w), 0, 32)
    low = (np.uint64(1) << (32 - keep).astype(np.uint64)) - np.uint64(1)
    words = raw & (np.uint64(0xFFFFFFFF) ^ low)
    return words.astype(np.uint32).view(np.int32), bits.astype(np.int32)


def k3_edges(dev, torch, np):
    """K3 on seeded edge cases: K 1 / 27 / 123 x W 1 / 20 / 128 x n_out 1
    / 16 / 128 / 8192, K3_LANES lanes each."""
    rng = np.random.default_rng(13)
    trunc = 0
    for k in (1, 27, 123):
        for w in (1, 20, 128):
            words, bits = [torch.from_numpy(a).to(dev)
                           for a in k3_case(rng, np, K3_LANES, k, w)]
            total = bits.long().sum(-1)
            for n_out in (1, 16, 128, 8192):
                k3_equal(words, bits, n_out, torch,
                         f"edge cases K={k} W={w} n_out={n_out}")
                trunc += int((total > 32 * n_out).sum())
    print(f"phase 2: K3 edge cases K 1/27/123 x W 1/20/128 x n_out "
          f"1/16/128/8192, {K3_LANES} lanes each (all-ones strings of 0, 1, "
          f"31, 32, 33 and 32*W bits, empty lanes): equal to plain; {trunc} "
          f"lanes truncated at n_out words")


def phase_kernels(dev, torch, np):
    """Phase 2: K1/K2/K3 against their plain versions at 1080p x 4 and on
    edge cases, and K2/K3 on intra-in-P symbols at 480p x 8; K3 at its MB
    and slice levels."""
    from tpuh264_torch.engine.sources import device_source_gop
    from tpuh264_torch.kernels import me_cuda, pframe

    w, h, s = 1920, 1088, 4
    y, u, v = device_source_gop(w, h, 2, s, "rigid", 100, dev)
    y0, y1 = y[0].to(torch.int32), y[1].to(torch.int32).contiguous()
    gplane = pframe.build_halfpel_planes(y0)[0]
    rows = []

    k1 = me_cuda.sad_field(y1, gplane)
    p1 = me_cuda._sad_field(y1[:, ::2, ::2], gplane, h, w)
    torch.cuda.synchronize()
    if k1.shape != (s, h // 16, w // 16, 289) or not torch.equal(k1, p1):
        fail("K1 sad_field differs from its plain version")
    rows.append(kernel_row(
        "K1", "sad_field (stage-A motion search)",
        "tpuh264_torch/csrc/me_sad.cu", "tpuh264/kernels/me_pallas.py:53",
        max_abs_err(k1, p1),
        timed(lambda: me_cuda.sad_field(y1, gplane), 50),
        timed(lambda: me_cuda._sad_field(y1[:, ::2, ::2], gplane, h, w), 3),
        k1_bytes(s, h, w)))
    del k1, p1
    k1_edges(dev, torch, np)
    # first-index ties of the winner selection, on the card vs the CPU
    rng = np.random.default_rng(3)
    tied = torch.from_numpy(
        (rng.integers(0, 4, (s, 68, 120, 289)) * 4).astype(np.int32))
    tied[..., ::3] = 0
    for a, b in zip(pframe._int_winner(tied.to(dev), 30),
                    pframe._int_winner(tied, 30)):
        if not torch.equal(a.cpu(), b):
            fail("winner selection ties differ between the card and the CPU")

    # K2 / K3 inputs: one encoded 1080p x 4 P frame, four times over (a
    # P dispatch's 16 frame-streams: 3.5 M blocks, 130,560 MBs)
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    sym, _, _ = pframe.encode_pframe_rows_multi(
        y[1], u[1], v[1], *refs, 30, intra_in_p=False)
    sym4 = pframe.MBSymbolsP(*[None if f is None else torch.cat([f] * 4)
                               for f in sym])
    rows += k23_rows(sym4, torch, "1080p x 4 P symbols x 4 frames")
    for r in rows:
        show(r, "1080p x 4 shapes")
    del sym, sym4
    k2_edges(dev, torch, np)
    k3_edges(dev, torch, np)

    # intra-in-P P symbols at 854x480 x 8: a band copied from the
    # reference (skips), the moving field (inter) and a flat patch no
    # reference holds (intra), four P frames' worth (32 frame-streams)
    w, h, s = 864, 480, 8
    y, u, v = device_source_gop(w, h, 2, s, "rigid", 40, dev)
    cur = [p[1].clone() for p in (y, u, v)]
    for i, p in enumerate((y, u, v)):
        sh = 1 + (i == 0)
        cur[i][:, :64 // sh] = p[0][:, :64 // sh]
        cur[i][:, 160 // sh:288 // sh, 96 // sh:480 // sh] = 30 + 40 * i
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    sym, _, _ = pframe.encode_pframe_rows_multi(*cur, *refs, 30,
                                                intra_in_p=True)
    kinds = torch.bincount(sym.kind.reshape(-1), minlength=3).tolist()
    if min(kinds) == 0:
        fail(f"intra-in-P symbols lack an MB kind (skip/inter/intra): {kinds}")
    sym4 = pframe.MBSymbolsP(*[None if f is None else torch.cat([f] * 4)
                               for f in sym])
    for r in k23_rows(sym4, torch, "intra-in-P 854x480 x 8 x 4 frames"):
        show(r, f"intra-in-P P symbols at 854x480 x 8 x 4 frames (MB kinds "
                f"skip/inter/intra {kinds} per frame)")
    return rows


def small_cases():
    """Phase 3's cases: (name, CodecConfig arguments over 64x48 x 2,
    GOPDevicePipeline arguments over gop 8 / "noise", driver or None for 3
    pump_frame()s, intra MBs required in the P frames).  The CPU tests
    decode the CPU's bytes of each in the JAX package's golden decoder."""
    import numpy as np

    from tpuh264_torch.engine.sources import clip_frames

    clips = [clip_frames(60, 44, 12, "meeting", seed=si) for si in range(2)]

    def host_batch(d):
        return [np.stack([[clips[si][4 * d + f][p] for si in range(2)]
                          for f in range(4)]).astype(np.uint8)
                for p in range(3)]

    def host_drive(p):
        for d in range(3):
            p.pump_host_frames(*host_batch(d))
            if d == 0:
                p.drop_frames(3)

    return [
        ("RTC preset, QP 28", dict(qp=28, intra_in_p=False), {}, None, False),
        ("intra-in-P, QP 28", dict(qp=28), {}, None, True),
        ("2 references, CBR", dict(qp=None, bitrate=200_000,
                                   num_ref_frames=2), {}, None, True),
        ("host ingest 60x44, fan-out 2, drop_frames(3)",
         dict(width=60, height=44, qp=None, bitrate=150_000),
         dict(source_kind="host", fanout=2), host_drive, False),
    ]


def small_pipe(kw, pkw, device):
    """One phase-3 case's GOPDevicePipeline on `device`, before driving."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline

    cfg = dict(dict(width=64, height=48, streams=2), **kw)
    return GOPDevicePipeline(CodecConfig(**cfg), gop_size=8,
                             **dict(dict(source_kind="noise"), **pkw),
                             device=device)


def drive_small(p, drive):
    if drive is None:
        for _ in range(3):
            p.pump_frame()
    else:
        drive(p)


def phase_small(dev, torch, np):
    """Phase 3: at 64x48 x 2 the GPU emits the CPU's bytes on every path;
    the intra-in-P cases on "noise" code intra MBs in their P frames."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import DevicePipeline

    cases = small_cases()
    for name, kw, pkw, drive, need_intra in cases:
        pipes = []
        for d in (dev, "cpu"):
            p = small_pipe(kw, pkw, d)
            if d == dev:
                spy = SymbolSpy(p, torch)
            drive_small(p, drive)
            pipes.append(p)
        gpu, cpu = pipes
        kinds, _ = spy.shares()
        if need_intra and kinds[2] == 0:
            fail(f"64x48 {name}: no intra MB in the P frames: {kinds}")
        dec = gpu.decoded_planes()
        for a, b in zip(dec, cpu.decoded_planes()):
            if not np.array_equal(a, b):
                fail(f"64x48 {name}: GPU decoder DPB differs from the CPU's")
        for si in range(2):
            if gpu.stream_bytes(si) != cpu.stream_bytes(si):
                fail(f"64x48 {name}: GPU bytes differ from CPU bytes ({si})")
        # (the CPU tests decode these same CPU bytes in the JAX package's
        # golden decoder: tests/test_torch_smoke_cases.py)
        print(f"phase 3: 64x48 x 2, {name}, 3 dispatches: GPU bytes == CPU "
              f"bytes ({sum(len(gpu.stream_bytes(i)) for i in range(2))} B), "
              f"GPU decoder DPB == CPU decoder DPB "
              f"({dec[0].shape[0]} decode streams); P-frame MB kinds "
              f"skip/inter/intra {kinds}")
    pipes = []
    for d in (dev, "cpu"):
        p = DevicePipeline(CodecConfig(width=64, height=48, qp=30, streams=2),
                           source_kind="noise", device=d)
        p.pump_frame()
        p.pump_frame()
        pipes.append(p)
    if pipes[0].frame_streams != pipes[1].frame_streams:
        fail("64x48 DevicePipeline: GPU bytes differ from CPU bytes")
    print("phase 3: 64x48 x 2, DevicePipeline QP 30, 2 dispatches: GPU bytes "
          f"== CPU bytes ({sum(map(len, pipes[0].frame_streams))} B in the "
          "last dispatch)")


def session_cases():
    """Phase 3's session cases over 64x48 x 2 at QP 28, 6 frames: (name,
    CodecConfig arguments, I4x4 MBs required in the IDR frames).  The CPU
    tests decode the CPU's bytes of each in the JAX package's golden
    decoder."""
    return [
        ("intra44 + deblock, IPPP across an IDR",
         dict(intra44=True, deblock=True, gop_size=4), True),
        ("2 references", dict(num_ref_frames=2, gop_size=4), False),
        ("3 temporal layers", dict(temporal_layers=3, gop_size=5), False),
        ("single slice, gop 1", dict(slice_mode="single", gop_size=1), False),
        ("cabac + transform8x8 + deblock + 2 references",
         dict(cabac=True, transform8x8=True, deblock=True, num_ref_frames=2,
              gop_size=4), False),
        ("cabac + 3 temporal layers + deblock",
         dict(cabac=True, temporal_layers=3, deblock=True, gop_size=5),
         False),
        ("cabac + intra44, gop 4", dict(cabac=True, intra44=True,
                                        gop_size=4), True),
    ]


def session_frames(n):
    """n I420 frames [2, 48, 64] (+ chroma): stream 0 the "meeting" clip
    with moving diagonal stripes on its left half (Intra_4x4 wins there),
    stream 1 noise (intra MBs in P frames)."""
    import numpy as np

    from tpuh264_torch.engine.sources import clip_frames, yuv_frame

    clip = clip_frames(64, 48, n, "meeting")
    yy, xx = np.mgrid[0:48, 0:32]
    out = []
    for t in range(n):
        y0 = clip[t][0].copy()
        y0[:, :32] = np.where(((2 * xx + yy + t) // 5) % 2, 60, 180)
        noise = yuv_frame(64, 48, t, "noise", seed=1)
        out.append([np.stack([a, b]).astype(np.uint8)
                    for a, b in zip((y0, *clip[t][1:]), noise)])
    return out


def run_session_case(kw, device, frames, decode: bool):
    """One session case on `device`: the EncoderSession's access units per
    frame and stream, its recon per frame (numpy), a DecoderPool's batched
    decode of every frame (where `decode`), and the IDR frames."""
    import numpy as np

    from tpuh264_torch.engine import CodecConfig, DecoderPool, EncoderSession

    enc = EncoderSession(CodecConfig(width=64, height=48, streams=2, qp=28,
                                     **kw), device=device)
    pool = None
    if decode:
        pool = DecoderPool(device=device)
        for i in range(2):
            pool.init_decoder(i)
    data, recon, dec, idr = [], [], [], []
    for t, f in enumerate(frames):
        encoded = enc.encode_frame_yuv(*f)
        aus = [x.data for x in encoded]
        data.append(aus)
        if encoded[0].is_idr:
            idr.append(t)
        recon.append([np.asarray(p.cpu()) for p in enc.recon])
        if pool is not None:
            out = pool.decode_batch(list(enumerate(aus)))
            dec.append([out[i] for i in range(2)])
    return data, recon, dec, idr


def phase_small_sessions(dev, np):
    """Phase 3, sessions: at 64x48 x 2 the session path on the GPU emits
    the CPU's bytes (plain versions) and recon, and the GPU decoders equal
    the encoder recon after every frame."""
    from tpuh264_torch.entropy import cabac_pack, native

    frames = session_frames(6)
    for name, kw, need_i4 in session_cases():
        g_data, g_rec, g_dec, idr = run_session_case(kw, dev, frames, True)
        c_data, c_rec, _, c_idr = run_session_case(kw, "cpu", frames, False)
        if idr != c_idr or len(idr) < 2:
            fail(f"64x48 session, {name}: IDR frames {idr} / {c_idr}")
        for t in range(len(frames)):
            if g_data[t] != c_data[t]:
                fail(f"64x48 session, {name}: GPU bytes differ from CPU "
                     f"bytes at frame {t}")
            for a, b in zip(g_rec[t], c_rec[t]):
                if not np.array_equal(a, b):
                    fail(f"64x48 session, {name}: GPU recon differs from "
                         f"CPU recon at frame {t}")
            for i in range(2):
                out = g_dec[t][i]
                if out is None or not all(
                        np.array_equal(p, r[i]) for p, r in zip(out,
                                                                g_rec[t])):
                    fail(f"64x48 session, {name}: decoder {i} != encoder "
                         f"recon at frame {t}")
        parse = cabac_pack.parse_iframe if kw.get("cabac") else \
            native.parse_iframe
        i4 = sum(int((parse(c_data[t][0])[3][:, 0] == 4).sum()) for t in idr)
        if need_i4 and i4 == 0:
            fail(f"64x48 session, {name}: no Intra_4x4 MB coded")
        print(f"phase 3: 64x48 x 2 session, {name}, {len(frames)} frames "
              f"(IDR at {idr}): GPU bytes == CPU bytes "
              f"({sum(len(b) for d in g_data for b in d)} B), GPU recon == "
              f"CPU recon, GPU DecoderPool == encoder recon after every "
              f"frame; Intra_4x4 MBs in stream 0's IDR frames: {i4}")


def check_dpbs(pipe, np, what, i):
    """Every decode stream equals its encoded stream's encoder DPB head."""
    fan = pipe.fanout
    for e, d in zip(pipe.encoder_planes(), pipe.decoded_planes()):
        if not np.array_equal(np.repeat(e, fan, axis=0), d):
            fail(f"{what}: decoder DPB != encoder DPB after dispatch {i}")
    # (host frames: the caller measures quality, the SSE is against zeros)
    if pipe.source_kind != "host" and (not np.isfinite(pipe.last_psnr_y)
                                       or pipe.last_psnr_y < 25):
        fail(f"{what}: implausible PSNR {pipe.last_psnr_y}")
    if pipe.qp_mismatches or pipe.fallback_packs:
        fail(f"{what}: QP mismatch or host repack")


def phase_main(dev, torch, np, card):
    """Phase 4: the main path, 3 dispatches, enc DPB == dec DPB each time;
    K3 launched twice per entropy call (MB and slice level)."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline
    from tpuh264_torch.kernels import cavlc_cuda

    cfg = CodecConfig(width=1920, height=1080, streams=4, qp=None,
                      bitrate=4_000_000, intra_in_p=False)
    pipe = GOPDevicePipeline(cfg, gop_size=8, source_kind="rigid",
                             device=dev)
    spy = SymbolSpy(pipe, torch)
    qps, times, k3 = [], [], []
    for i in range(3):
        qps.append(pipe.rc.current_qp())
        n0 = cavlc_cuda.merge_tree.launches
        t0 = time.perf_counter()
        pipe.pump_frame()
        times.append(time.perf_counter() - t0)
        k3.append(cavlc_cuda.merge_tree.launches - n0)
        check_dpbs(pipe, np, "1080p", i)
    expect = [4 if st else 2 for st in spy.starts]
    if k3 != expect:
        fail(f"1080p: K3 launches per dispatch {k3}, expected {expect} "
             f"(GOP starts {spy.starts})")
    print(f"phase 4: 1920x1080 x 4, CBR 4 Mbps, gop 8, rigid: 3 dispatches "
          f"(12 frames, GOP starts {spy.starts}), decoder DPB == encoder DPB "
          f"after each; K3 launches per dispatch {k3} (MB + slice level per "
          f"entropy call); QP {qps}; PSNR {pipe.last_psnr_y:.2f} dB; "
          f"pump_frame s {[round(t, 2) for t in times]} [{card}]")


def phase_runs(dev, card):
    """Phase 5: short measured runs at the two benchmark configurations."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline

    for w, h, s, rate, dur in ((1920, 1080, 4, 4_000_000, 15.0),
                               (854, 480, 8, 1_000_000, 12.0)):
        cfg = CodecConfig(width=w, height=h, streams=s, qp=None,
                          bitrate=rate, intra_in_p=False)
        pipe = GOPDevicePipeline(cfg, gop_size=32, source_kind="rigid",
                                 device=dev)
        snap = pipe.run(duration_s=dur, warmup=1)
        stages = {k: round(v, 1) for k, v in snap.items()
                  if k.startswith("ms_")}
        print(f"phase 5: run() {w}x{h} x {s} CBR {rate // 1000} kbps: "
              f"{snap['frames_per_s_aggregate']:.2f} aggregate fps "
              f"({snap['frames']} frames), stages/dispatch ms {stages}, "
              f"PSNR {snap['psnr_y']:.2f} dB, QP {snap['qp']} [{card}]")


class SymbolSpy:
    """Counts the P symbols' MB kinds and reference indices per dispatch,
    on the device (read once at the end)."""

    def __init__(self, pipe, torch):
        self.kind, self.ref1, self.mbs, self.starts = [], [], 0, []
        enc = pipe._encode

        def spy(start, *a, **kw):
            out = enc(start, *a, **kw)
            self.starts.append(bool(start))
            sp = out[1]
            self.kind.append(torch.bincount(sp.kind.reshape(-1),
                                            minlength=3))
            self.ref1.append((sp.refidx > 0).sum())
            self.mbs += sp.kind.numel()
            return out

        pipe._encode = spy

    def shares(self):
        kinds = sum(k.cpu() for k in self.kind).tolist()
        return kinds, sum(int(r) for r in self.ref1) / self.mbs


def phase_intra_in_p(dev, torch, np, card, launches):
    """Phase 6: the reference's operating point with CodecConfig defaults."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline
    from tpuh264_torch.kernels import pframe

    cfg = CodecConfig(width=854, height=480, streams=8)
    if not (cfg.intra_in_p and cfg.qp is None and cfg.bitrate == 1_000_000):
        fail("CodecConfig defaults are not intra-in-P CBR 1 Mbps")
    pipe = GOPDevicePipeline(cfg, gop_size=8, source_kind="rigid",
                             device=dev)
    spy = SymbolSpy(pipe, torch)
    qps, times = [], []

    def drive():
        for i in range(3):
            qps.append(pipe.rc.current_qp())
            t0 = time.perf_counter()
            pipe.pump_frame()
            times.append(time.perf_counter() - t0)
            check_dpbs(pipe, np, "480p intra-in-P", i)

    launches.path("480p x 8 intra-in-P", drive)
    kinds, _ = spy.shares()
    n_p = sum(kinds)
    print(f"phase 6: 854x480 x 8, CodecConfig defaults (intra-in-P, CBR 1 "
          f"Mbps), gop 8, rigid: 3 dispatches, decoder DPB == encoder DPB "
          f"after each; QP {qps}; PSNR {pipe.last_psnr_y:.2f} dB; P-frame MB "
          f"kinds skip/inter/intra {kinds}, intra share "
          f"{kinds[2] / n_p:.4f}; pump_frame s "
          f"{[round(t, 2) for t in times]} [{card}]")
    # the cost of the intra-in-P column loop: one P-frame encode of the
    # next source frame against the current DPB, fenced, on and off
    from tpuh264_torch.engine.sources import device_source_gop

    y, u, v = device_source_gop(pipe.w16, pipe.h16, 1, 8, "rigid", 100, dev)
    refs = tuple(p[:1] for p in pipe._dpb_enc)
    qp = pipe.rc.current_qp()
    ms = {True: [], False: []}
    for iip in (False, True, True, False, False, True):
        ms[iip].append(round(fenced_ms(
            lambda: pframe.encode_pframe_rows_multi(
                y[0], u[0], v[0], *refs, qp, intra_in_p=iip)), 1))
    print(f"phase 6: one P-frame encode at 854x480 x 8, QP {qp}, fenced: "
          f"intra-in-P {ms[True]} ms, RTC preset {ms[False]} ms "
          f"(mean {sum(ms[True]) / 3:.1f} vs {sum(ms[False]) / 3:.1f}) "
          f"[{card}]")


def phase_multiref(dev, torch, np, card, launches):
    """Phase 7: two references at 854x480 x 8, CBR 1 Mbps."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline

    cfg = CodecConfig(width=854, height=480, streams=8, num_ref_frames=2)
    pipe = GOPDevicePipeline(cfg, gop_size=32, source_kind="rigid",
                             device=dev)
    spy = SymbolSpy(pipe, torch)
    qps = []

    def drive():
        for i in range(3):
            qps.append(pipe.rc.current_qp())
            pipe.pump_frame()
            check_dpbs(pipe, np, "480p 2 refs", i)

    _, counts = launches.path("480p x 8, 2 references", drive)
    # one K1 launch per active reference per P frame: the 3 P frames of a
    # GOP-start dispatch have one (only the IDR is in a decoder's DPB),
    # the 4 of an interior dispatch have both
    expect = sum(3 * 1 if st else 4 * 2 for st in spy.starts)
    if counts[0] != expect:
        fail(f"2 references: K1 launched {counts[0]} times, expected {expect}")
    kinds, ref1 = spy.shares()
    if ref1 <= 0:
        fail("2 references: no MB chose reference 1")
    print(f"phase 7: 854x480 x 8, 2 references, CBR 1 Mbps, intra-in-P, "
          f"gop 32: 3 dispatches (GOP starts {spy.starts}), decoder DPB == "
          f"encoder DPB after each; K1 launches {counts[0]} == active "
          f"references x P frames ({expect}); P-frame MB kinds "
          f"skip/inter/intra {kinds}, MBs with refidx > 0: {ref1:.4f}; QP "
          f"{qps}; PSNR "
          f"{pipe.last_psnr_y:.2f} dB [{card}]")


def phase_ingest_fanout(dev, torch, np, card, launches):
    """Phase 8: host ingest -> fan-out 8 (one camera stream decoded 8x),
    intra-in-P (the CodecConfig default): intra MBs must be coded."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline
    from tpuh264_torch.engine.sources import clip_frames

    w, h = 854, 480
    t0 = time.perf_counter()
    clip = clip_frames(w, h, 16, "meeting")
    t_clip = time.perf_counter() - t0
    pipe = GOPDevicePipeline(CodecConfig(width=w, height=h, streams=1, qp=32),
                             gop_size=32, source_kind="host", fanout=8,
                             device=dev)
    spy = SymbolSpy(pipe, torch)
    copy_ms = []

    def batch(f0):
        return [np.stack([clip[f0 + f][p] for f in range(4)])[:, None]
                .astype(np.uint8) for p in range(3)]

    def drive():
        f0 = 0
        for i in range(3):
            pipe.pump_host_frames(*batch(f0))
            copy_ms.append(round(pipe.last_copy_ms, 3))
            check_dpbs(pipe, np, "ingest fan-out 8", i)
            f0 += 4
            if i == 0:  # capture backpressure: the encoder skips 4 frames
                pipe.drop_frames(4)
                f0 += 4

    launches.path("host ingest -> fan-out 8", drive)
    if pipe.decoded_planes()[0].shape[0] != 8:
        fail("fan-out 8: the decoder DPB is not 8 streams wide")
    kinds, _ = spy.shares()
    if kinds[2] == 0:
        fail(f"ingest fan-out 8: no intra MB in the P frames: {kinds}")
    print(f"phase 8: host ingest 854x480 (clip 'meeting', made in "
          f"{t_clip:.1f} s) -> 1 stream, QP 32, fan-out 8: 3 dispatches with "
          f"drop_frames(4) after the first; all 8 decode streams == encoder "
          f"DPB after each; P-frame MB kinds skip/inter/intra {kinds}; copy "
          f"ms per dispatch (memcpy into reused pinned staging + upload) "
          f"{copy_ms}; time_offset {pipe.time_offset} [{card}]")


def phase_device_pipeline(dev, torch, np, card, launches):
    """Phase 9: the I-only DevicePipeline, 854x480, decoded 8x."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.devpipe import DevicePipeline
    from tpuh264_torch.engine.sources import device_source_frames
    from tpuh264_torch.kernels import iframe

    pipe = DevicePipeline(CodecConfig(width=854, height=480, qp=30,
                                      streams=8), device=dev)

    def drive():
        for _ in range(2):
            pipe.pump_frame()

    launches.path("DevicePipeline 480p x 8", drive, needs=(1, 2))
    if pipe.fallback_packs:
        fail("DevicePipeline: host repack")
    # the port's own decode of frame 0's bytes (native parse + I scan):
    # equal to the encoder's reconstruction of that frame, and against its
    # source (cropped to 854x480; the device decode's PSNR is over the MB
    # grid)
    src = device_source_frames(pipe.w16, pipe.h16, 1, "moving_gradient",
                               pipe.frame_index - 4, dev)
    qp, dec = pipe.decode_bytes(pipe.frame_streams[0])
    _, rec = iframe.encode_iframe_rows(*src, 30)
    if qp != 30 or not all(torch.equal(a.to(torch.uint8), b)
                           for a, b in zip(rec, dec)):
        fail("DevicePipeline: the decode of the bytes differs from the "
             "encoder's reconstruction")
    d = (dec[0][0, :480, :854].double() - src[0][0, :480, :854].double())
    psnr_b = float(10 * torch.log10(255.0 ** 2 / (d * d).mean()))
    for p in (pipe.last_psnr_y, psnr_b):
        if not np.isfinite(p) or p < 30:
            fail(f"DevicePipeline: implausible PSNR {p}")
    print(f"phase 9: DevicePipeline 854x480, QP 30, decoded 8x from device "
          f"symbols: 2 dispatches, device-decode PSNR "
          f"{pipe.last_psnr_y:.2f} dB (coded {pipe.w16}x{pipe.h16}); the "
          f"port's decode of frame 0's bytes (native parse + I scan) == the "
          f"encoder's reconstruction, {psnr_b:.2f} dB (cropped 854x480); "
          f"{sum(map(len, pipe.frame_streams))} B per dispatch [{card}]")


def phase_app(dev, card, launches):
    """Phase 10: the live App at 854x480 x 8 for ~10 s."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.app import App

    app = App(CodecConfig(width=854, height=480, streams=8), impl="tpu_gop",
              device=dev)
    box = {}

    def drive():
        app.start()
        pipe = app.pipeline
        t0 = time.perf_counter()
        time.sleep(10.0)
        # the stats show output and drops only once the first dispatch
        # (an IDR and 3 intra-in-P P frames, 7-10 s) has retired and the
        # pump has dropped the frames it fell behind by (time_offset > 0)
        while (pipe.time_offset == 0 and app.is_processing()
               and time.perf_counter() - t0 < 120.0):
            time.sleep(0.1)
        box["wait_s"] = time.perf_counter() - t0
        box["stats"] = app.get_stats()
        t0 = time.perf_counter()
        app.stop()
        box["stop_s"] = time.perf_counter() - t0
        box["pipe"] = pipe

    launches.path("App tpu_gop 480p x 8", drive)
    stats, pipe = box["stats"], box["pipe"]
    if app.error is not None:
        fail(f"App: the pump thread failed: {app.error!r}")
    if app.is_processing() or app.pipeline is not None:
        fail("App: stop() left the pipeline running")
    app.stop()
    frames = pipe.dispatch_index * pipe.FRAMES_PER_DISPATCH
    if frames <= 0 or stats["dropped_capture"] <= 0:
        fail(f"App: no frames or no capture drops: {stats}")
    shown = {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in stats.items()}
    print(f"phase 10: App(impl='tpu_gop') 854x480 x 8, defaults, "
          f"{box['wait_s']:.1f} s: {frames} frames per stream encoded, "
          f"time_offset "
          f"{pipe.time_offset}; get_stats() {shown}; stop() took "
          f"{box['stop_s']:.1f} s [{card}]")


def clip_streams(w, h, n, streams):
    """n I420 frames [streams, h, w] (+ chroma) uint8 of the "meeting"
    clip, stream s starting at clip frame s: a different camera-like frame
    per stream."""
    import numpy as np

    from tpuh264_torch.engine.sources import clip_frames

    clip = clip_frames(w, h, n + streams - 1, "meeting")
    return [[np.stack([clip[t + i][p] for i in range(streams)])
             .astype(np.uint8) for p in range(3)] for t in range(n)]


def clip_rgba(dev, w, h, n, streams):
    """`clip_streams` as RGBA input [streams, h, w, 4] uint8, converted on
    the card by the port's yuv420_to_rgba."""
    import torch

    from tpuh264_torch.kernels import color

    return [color.yuv420_to_rgba(*(torch.from_numpy(p).to(dev) for p in f))
            .cpu().numpy() for f in clip_streams(w, h, n, streams)]


def stay_fast(sessions, what):
    """The engine's own streams never leave the fast path: no session may
    have switched to the golden decoder, nor concealed a frame."""
    bad = [i for i, d in enumerate(sessions)
           if d._general or d.frames_concealed]
    if bad:
        fail(f"{what}: decoders {bad} left the fast path or concealed")


def phase_sessions(dev, np, card, launches):
    """Phase 11: EncoderSession at 854x480 x 8 from RGBA (intra44, deblock,
    gop 8, CBR 1 Mbps, 10 frames across an IDR), every frame's 8 access
    units decoded by DecoderPool.decode_batch == the recon."""
    from tpuh264_torch.engine import CodecConfig, DecoderPool, EncoderSession
    from tpuh264_torch.entropy import native
    from tpuh264_torch.kernels import me_cuda

    w, h, s, n = 854, 480, 8, 10
    t0 = time.perf_counter()
    frames = clip_rgba(dev, w, h, n, s)
    t_src = time.perf_counter() - t0
    cfg = CodecConfig(width=w, height=h, streams=s, intra44=True,
                      deblock=True, gop_size=8, bitrate=1_000_000)
    enc = EncoderSession(cfg, device=dev)
    pool = DecoderPool(device=dev)
    for i in range(s):
        pool.init_decoder(i)
    rows, i4 = [], []

    def drive():
        for t, rgba in enumerate(frames):
            k0 = me_cuda.sad_field.launches
            out = enc.encode_frame(rgba)
            k1 = me_cuda.sad_field.launches - k0
            t0 = time.perf_counter()
            dec = pool.decode_batch([(i, f.data) for i, f in enumerate(out)])
            dec_ms = (time.perf_counter() - t0) * 1e3
            recon = [p.cpu().numpy() for p in enc.recon]
            for i in range(s):
                if dec[i] is None or not all(
                        np.array_equal(a, r[i][:a.shape[0], :a.shape[1]])
                        for a, r in zip(dec[i], recon)):
                    fail(f"480p sessions: decoder {i} != encoder recon at "
                         f"frame {t}")
                if dec[i][0].shape != (h, w):
                    fail(f"480p sessions: decoder output {dec[i][0].shape}")
            if k1 != (0 if out[0].is_idr else 1):
                fail(f"480p sessions: K1 launched {k1} times for frame {t} "
                     f"(IDR {out[0].is_idr}); one per P frame expected")
            if out[0].is_idr:
                mb = [native.parse_iframe(f.data)[3][:, 0] for f in out]
                i4.append(sum(int((m == 4).sum()) for m in mb)
                          / sum(m.size for m in mb))
            tm = out[0].timings
            rows.append(dict(frame=t, idr=out[0].is_idr, qp=out[0].qp,
                             bytes=sum(len(f.data) for f in out), k1=k1,
                             copy_ms=round(tm["copy_ms"], 1),
                             encode_ms=round(tm["encode_ms"], 1),
                             entropy_ms=round(tm["entropy_ms"], 1),
                             decode_ms=round(dec_ms, 1)))

    launches.path("EncoderSession + DecoderPool 480p x 8", drive, needs=(0,))
    stay_fast([pool[i] for i in range(s)], "480p sessions")
    if len(i4) != 2 or min(i4) <= 0:
        fail(f"480p sessions: Intra_4x4 share of the IDR frames {i4}")
    # what the Intra_4x4 trial adds to the I scan: frame 0, off / on in turns
    import torch

    from tpuh264_torch.engine.encoder import _pad_multiple
    from tpuh264_torch.kernels import color, iframe

    yuv = color.rgba_to_yuv420(torch.from_numpy(
        _pad_multiple(frames[0], 16, axes=(1, 2))).to(dev))
    scan_ms = {False: [], True: []}
    for on in (False, True, True, False):
        scan_ms[on].append(round(fenced_ms(lambda: iframe.encode_iframe_scan(
            *yuv, 34, intra44=on)), 1))
    for r in rows:
        print(f"phase 11: frame {r}")
    mean = lambda k, idr: sum(r[k] for r in rows if r["idr"] == idr) / max(
        1, sum(r["idr"] == idr for r in rows))
    print(f"phase 11: EncoderSession 854x480 x 8 from RGBA (clip 'meeting' "
          f"made and converted in {t_src:.1f} s), intra44 + deblock, gop 8, "
          f"CBR 1 Mbps, 10 frames: DecoderPool.decode_batch == encoder "
          f"recon after every frame; Intra_4x4 MB share of the IDR frames "
          f"{[round(x, 4) for x in i4]}; K1 once per P frame; mean ms IDR / "
          f"P: copy {mean('copy_ms', True):.1f} / {mean('copy_ms', False):.1f}"
          f", encode {mean('encode_ms', True):.1f} / "
          f"{mean('encode_ms', False):.1f}, entropy "
          f"{mean('entropy_ms', True):.1f} / {mean('entropy_ms', False):.1f}"
          f", decode {mean('decode_ms', True):.1f} / "
          f"{mean('decode_ms', False):.1f}; one I scan (QP 34, fenced) "
          f"without / with the Intra_4x4 trial {scan_ms[False]} / "
          f"{scan_ms[True]} ms [{card}]")


def phase_wavefront(dev, np, card, launches):
    """Phase 12: single-slice I frames (the wavefront) at 854x480 x 8, gop
    1, 2 frames, each stream decoded by its own DecoderSession == recon.
    No P frame: K1 is not on this path."""
    from tpuh264_torch.engine import CodecConfig, DecoderSession, EncoderSession

    w, h, s = 854, 480, 8
    frames = clip_streams(w, h, 2, s)
    enc = EncoderSession(CodecConfig(width=w, height=h, streams=s,
                                     slice_mode="single", gop_size=1),
                         device=dev)
    decs = [DecoderSession(device=dev) for _ in range(s)]
    ms = []

    def drive():
        for t, planes in enumerate(frames):
            out = enc.encode_frame_yuv(*planes)
            if not all(f.is_idr for f in out):
                fail("wavefront: a frame that is not an IDR")
            recon = [p.cpu().numpy() for p in enc.recon]
            t0 = time.perf_counter()
            for i, d in enumerate(decs):
                got = d.decode(out[i].data)
                if got is None or not all(
                        np.array_equal(a, r[i][:a.shape[0], :a.shape[1]])
                        for a, r in zip(got, recon)):
                    fail(f"wavefront: decoder {i} != encoder recon, frame {t}")
            ms.append((round(out[0].timings["encode_ms"], 1),
                       round(out[0].timings["entropy_ms"], 1),
                       round((time.perf_counter() - t0) * 1e3, 1)))

    _, counts = launches.path("wavefront 480p x 8", drive, needs=())
    stay_fast(decs, "wavefront")
    if counts[0]:
        fail(f"wavefront: K1 launched {counts[0]} times on an I-only path")
    waves = 2 * ((h + 15) // 16 - 1) + (w + 15) // 16
    print(f"phase 12: single-slice I frames (wavefront, {waves} waves) "
          f"854x480 x 8, gop 1, 2 frames: each stream's DecoderSession == "
          f"encoder recon; (encode, entropy, 8 decodes) ms per frame {ms} "
          f"[{card}]")


def phase_app_tpu(dev, np, card, launches):
    """Phase 13: the live App with impl "tpu" (the session Pipeline: one
    encoder -> ring -> 8 decoders) at 854x480 for ~10 s."""
    from tpuh264_torch.engine import CodecConfig
    from tpuh264_torch.engine.app import App

    app = App(CodecConfig(width=854, height=480, streams=8), impl="tpu",
              device=dev)
    box = {}

    def drive():
        app.start()
        pipe = app.pipeline
        t0 = time.perf_counter()
        time.sleep(10.0)
        while (pipe.frame_index < 2 and app.is_processing()
               and time.perf_counter() - t0 < 120.0):
            time.sleep(0.1)
        box["wait_s"] = time.perf_counter() - t0
        box["stats"] = app.get_stats()
        app.stop()
        box["pipe"] = pipe

    launches.path("App tpu 480p fan-out 8", drive, needs=(0,))
    stats, pipe = box["stats"], box["pipe"]
    if app.error is not None:
        fail(f"App tpu: the pump thread failed: {app.error!r}")
    if app.is_processing() or app.pipeline is not None:
        fail("App tpu: stop() left the pipeline running")
    if pipe.ring.produced < 2 or len(pipe.last_outputs) != 8:
        fail(f"App tpu: {pipe.ring.produced} frames, "
             f"{len(pipe.last_outputs)} decoder outputs")
    stay_fast([pipe.decoders[i] for i in range(8)], "App tpu")
    recon = [p.cpu().numpy() for p in pipe.encoder.recon]
    for i, out in pipe.last_outputs.items():
        if out is None or not all(
                np.array_equal(a, r[0][:a.shape[0], :a.shape[1]])
                for a, r in zip(out, recon)):
            fail(f"App tpu: decoder {i} != the encoder recon")
    shown = {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in stats.items()}
    print(f"phase 13: App(impl='tpu') 854x480, fan-out 8, defaults, "
          f"{box['wait_s']:.1f} s: {pipe.ring.produced} frames encoded and "
          f"each decoded 8x (frame_index {pipe.frame_index}); every decoder "
          f"== the encoder recon at the last frame; get_stats() {shown} "
          f"[{card}]")


def general_stream(np):
    """A stream the fast path hands to the general path: the golden
    `encode_iframe` of a 96x64 frame, then a P frame of inter MBs whose
    first MV is 20 pels, past the fast path's window (as the JAX package's
    engine test builds it).  -> (I access unit, P access unit)."""
    from tpuh264_torch.core.params import PPS, SPS
    from tpuh264_torch.engine import sources
    from tpuh264_torch.entropy import packp
    from tpuh264_torch.golden import codec as gcodec

    w, h = 96, 64
    y, u, v = sources.yuv_frame(w, h, 0)
    i_bytes, _ = gcodec.encode_iframe(
        np.asarray(y, np.int32), np.asarray(u, np.int32),
        np.asarray(v, np.int32), qp=28)
    sps, pps = SPS.for_size(w, h), PPS()
    n = sps.mb_height * sps.mb_width
    mb_info = np.zeros((n, 8), np.int32)
    mb_info[:, 0] = 1  # every MB inter
    mb_info[0, 5] = 4 * 20  # a 20-pel MV: past the +-10 pel window
    p_bytes = packp.pack_pframe(
        mb_info, np.zeros((n, 16), np.int32), np.zeros((n, 16, 16), np.int32),
        np.zeros((n, 2, 4), np.int32), np.zeros((n, 2, 4, 15), np.int32),
        sps, pps, 28, slice_mode="rows", frame_num=1, deblock_idc=1)
    return i_bytes, p_bytes


def phase_gate(dev, np, card, launches):
    """Phase 14: the conformance gate on the card -- `run_gate` at every
    GATE_SHAPES shape, then `run_gate_extended` (CBR with a scene cut,
    host ingest, fan-out 2, every dispatch), each decoded picture held
    against the oracle (libavcodec where it loads, else the golden
    decoder); then a general stream through DecoderSession on the card."""
    from tpuh264_torch.conformance import gate
    from tpuh264_torch.engine import DecoderSession
    from tpuh264_torch.golden import codec as gcodec

    box = {}

    def drive():
        box["shapes"] = gate.run_gate(device=dev)
        box["extended"] = gate.run_gate_extended(device=dev)

    launches.path("conformance gate", drive)
    a, b = box["shapes"], box["extended"]
    print(f"phase 14: conformance gate, oracle {a['oracle']}: GATE_SHAPES "
          f"{[s[:3] for s in gate.GATE_SHAPES]} x 2 dispatches, "
          f"{a['compared']} final pictures equal ({a['decoded']} frames "
          f"decoded by the oracle) in {a['seconds']:.1f} s; extended "
          f"128x96 x 2 CBR + scene cut + host ingest + fan-out 2, 4 "
          f"dispatches: {b['compared']} pictures equal after every "
          f"dispatch ({b['decoded']} frames decoded by the oracle) in "
          f"{b['seconds']:.1f} s; the oracle's decodes "
          f"{a['oracle_seconds']:.1f} + {b['oracle_seconds']:.1f} s, "
          f"{1e3 * a['oracle_seconds'] / a['decoded_mbs']:.3f} ms an MB at "
          f"the shapes [{card}]")

    i_bytes, p_bytes = general_stream(np)
    sess = DecoderSession(device=dev)

    def decode():
        return [sess.decode(i_bytes), sess.decode(p_bytes)]

    outs, _ = launches.path("general stream", decode, needs=())
    if not sess._general or sess.frames_concealed:
        fail(f"general stream: the session did not switch to the golden "
             f"path (general {sess._general}, concealed "
             f"{sess.frames_concealed})")
    refs = {"golden": gcodec.decode_annexb_seq(i_bytes + p_bytes)}
    if gate.oracle_name() == "libavcodec":
        from tpuh264_torch.conformance.ffdec import decode_with_libav

        refs["libavcodec"] = decode_with_libav(i_bytes + p_bytes)
    for name, frames in refs.items():
        for t, (got, ref) in enumerate(zip(outs, frames)):
            if got is None or not all(
                    g.dtype == np.uint8 and np.array_equal(g, r)
                    for g, r in zip(got, ref)):
                fail(f"general stream: frame {t} != {name}")
    print(f"phase 14: a general stream (20-pel MV) through "
          f"DecoderSession on the card: I frame on the fast path, P frame "
          f"on the golden path, both equal to {' and '.join(refs)} "
          f"[{card}]")


class PSymbols:
    """Spies on an EncoderSession's P encode: per P frame, the reference
    pictures it searched (every DPB picture: no temporal layers here) and,
    on the device, the counts of intra MBs, of inter MBs that chose the
    8x8 transform and of those that chose reference 1 (read at the end)."""

    def __init__(self, enc, torch):
        self.searched, self.counts, self.mbs = [], [], 0
        real = enc._encode_p

        def spy(*a):
            self.searched.append(len(enc._dpb))
            out = real(*a)
            sym = out[0]
            inter = sym.kind == 1
            self.counts.append(torch.stack([
                (sym.kind == 2).sum(), (inter & (sym.t8 == 1)).sum(),
                (inter & (sym.refidx == 1)).sum()]))
            self.mbs += sym.kind.numel()
            return out

        enc._encode_p = spy

    def shares(self):
        """(intra, t8, reference 1) shares of the P frames' MBs."""
        tot = sum(c.cpu() for c in self.counts).tolist()
        return [x / max(self.mbs, 1) for x in tot]


def phase_config3(dev, np, card, launches):
    """Phase 15: BASELINE config 3 on the card (tools/bench_config3.py's
    session: 1080p, CABAC + 8x8 transform, 2 references, CBR 4 Mbps,
    intra-in-P), 6 frames, decoded by a DecoderSession on the fast path
    == the recon after every frame and == the golden decode of the whole
    stream (in a spawned worker, beside part B); then part B, the
    reference lab's operating point (854x480 x 8 from RGBA) with CABAC,
    the 8x8 transform and its deblock, through DecoderPool.decode_batch."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from tpuh264_torch.conformance import gate
    from tpuh264_torch.engine import (CodecConfig, DecoderPool,
                                      DecoderSession, EncoderSession, sources)

    # ---- part A: config 3 at 1920x1080, IDR + 5 P ----
    w, h, n = 1920, 1080, 6
    cfg = CodecConfig(width=w, height=h, qp=None, bitrate=4_000_000,
                      cabac=True, transform8x8=True, num_ref_frames=2,
                      gop_size=6, intra_in_p=True)
    enc = EncoderSession(cfg, device=dev)
    dec = DecoderSession(device=dev)
    spy = PSymbols(enc, torch)
    src = [sources.yuv_frame(w, h, t, kind="rigid") for t in range(n)]
    rows, aus, recons = [], [], []

    def drive():
        for t, planes in enumerate(src):
            out = enc.encode_frame_yuv(*planes)[0]
            t0 = time.perf_counter()
            got = dec.decode(out.data)
            dec_ms = (time.perf_counter() - t0) * 1e3
            recon = [p[0].cpu().numpy() for p in enc.recon]
            recon = [r[:a.shape[0], :a.shape[1]] for r, a in zip(recon,
                                                                  planes)]
            if got is None or not all(np.array_equal(a, r)
                                      for a, r in zip(got, recon)):
                fail(f"config 3: decoder != encoder recon at frame {t}")
            if dec._general or dec.frames_concealed:
                fail(f"config 3: the decoder left the fast path (general "
                     f"{dec._general}) or concealed at frame {t}")
            d = recon[0].astype(np.float64) - planes[0]
            tm = out.timings
            aus.append(out.data)
            recons.append(recon)
            rows.append(dict(
                frame=t, idr=out.is_idr, qp=out.qp,
                kbps_at_30fps=round(len(out.data) * 8 * 30 / 1e3, 1),
                psnr_y=round(float(10 * np.log10(255.0 ** 2
                                                 / (d * d).mean())), 2),
                copy_ms=round(tm["copy_ms"], 1),
                encode_ms=round(tm["encode_ms"], 1),
                entropy_ms=round(tm["entropy_ms"], 1),
                decode_ms=round(dec_ms, 1)))

    _, counts = launches.path("config 3 1080p", drive, needs=(0,))
    intra, t8, ref1 = spy.shares()
    if spy.searched != [1, 2, 2, 2, 2] or counts[0] != sum(spy.searched):
        fail(f"config 3: K1 launched {counts[0]} times for the references "
             f"searched {spy.searched} (1 + 2 x 4 = 9 expected)")
    if t8 <= 0 or ref1 <= 0:
        fail(f"config 3: P-frame MB shares t8 {t8}, reference 1 {ref1}")
    for r in rows:
        print(f"phase 15: config 3 frame {r} [{card}]")
    # the independent oracle: the golden decoder, in a spawned worker
    oracle = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        gold = oracle.submit(gate._timed_decode, b"".join(aus), "golden")
        part_b(dev, np, card, launches, torch)
        frames, gold_s = gold.result()
    finally:
        oracle.shutdown(wait=True, cancel_futures=True)
    if len(frames) != n:
        fail(f"config 3: the golden decoder decoded {len(frames)} frames")
    for t, (f, r) in enumerate(zip(frames, recons)):
        if not all(np.array_equal(np.asarray(a), b) for a, b in zip(f, r)):
            fail(f"config 3: golden decode != encoder recon at frame {t}")
    mean = lambda k: sum(r[k] for r in rows[1:]) / (n - 1)
    print(f"phase 15: BASELINE config 3 (1920x1080, CABAC + 8x8 transform, "
          f"2 references, CBR 4 Mbps, intra-in-P, gop 6), 'rigid', {n} "
          f"frames: DecoderSession on the fast path == encoder recon after "
          f"every frame, golden decode (worker, {gold_s:.1f} s) == recon; "
          f"K1 {counts[0]} launches for the references searched "
          f"{spy.searched}; P-frame MB shares: t8 {t8:.4f}, reference 1 "
          f"{ref1:.4f}, intra {intra:.4f}; mean P ms: encode "
          f"{mean('encode_ms'):.1f}, entropy {mean('entropy_ms'):.1f}, "
          f"decode {mean('decode_ms'):.1f}; stream "
          f"{sum(map(len, aus)) * 8 * 30 / n / 1e3:.1f} kbps at 30 fps "
          f"[{card}]")


def part_b(dev, np, card, launches, torch):
    """Phase 15 part B: 854x480 x 8 from RGBA (the "meeting" clip), CABAC +
    8x8 transform + deblock, 2 references, CBR 1 Mbps, gop 8, 4 frames;
    every frame's access units through DecoderPool.decode_batch (per
    session: CABAC does not batch) == the recon."""
    from tpuh264_torch.engine import CodecConfig, DecoderPool, EncoderSession

    w, h, s, n = 854, 480, 8, 4
    frames = clip_rgba(dev, w, h, n, s)
    enc = EncoderSession(CodecConfig(
        width=w, height=h, streams=s, cabac=True, transform8x8=True,
        deblock=True, num_ref_frames=2, gop_size=8, bitrate=1_000_000),
        device=dev)
    pool = DecoderPool(device=dev)
    for i in range(s):
        pool.init_decoder(i)
    spy = PSymbols(enc, torch)
    rows = []

    def drive():
        for t, rgba in enumerate(frames):
            out = enc.encode_frame(rgba)
            t0 = time.perf_counter()
            got = pool.decode_batch([(i, f.data) for i, f in enumerate(out)])
            dec_ms = (time.perf_counter() - t0) * 1e3
            recon = [p.cpu().numpy() for p in enc.recon]
            for i in range(s):
                if got[i] is None or not all(
                        np.array_equal(a, r[i][:a.shape[0], :a.shape[1]])
                        for a, r in zip(got[i], recon)):
                    fail(f"config 3 part B: decoder {i} != encoder recon at "
                         f"frame {t}")
            tm = out[0].timings
            rows.append((t, out[0].qp, sum(len(f.data) for f in out),
                         round(tm["encode_ms"], 1),
                         round(tm["entropy_ms"], 1), round(dec_ms, 1)))

    _, counts = launches.path("config 3 part B 480p x 8", drive, needs=(0,))
    stay_fast([pool[i] for i in range(s)], "config 3 part B")
    intra, t8, ref1 = spy.shares()
    if counts[0] != sum(spy.searched) or t8 <= 0:
        fail(f"config 3 part B: K1 {counts[0]} launches for the references "
             f"searched {spy.searched}; t8 share {t8}")
    print(f"phase 15: part B, 854x480 x 8 from RGBA (clip 'meeting'), CABAC "
          f"+ 8x8 transform + deblock, 2 references, CBR 1 Mbps, gop 8, "
          f"{n} frames: DecoderPool.decode_batch == encoder recon after "
          f"every frame, no session left the fast path; K1 {counts[0]} "
          f"launches ({spy.searched}); P-frame MB shares t8 {t8:.4f}, "
          f"reference 1 {ref1:.4f}, intra {intra:.4f}; (frame, QP, bytes, "
          f"encode, entropy, decode ms) {rows} [{card}]")


# ---- phase 16: the distribution layer, device_pack and the bench ----------

SHARD_QP = 30
SHARD_STREAMS, SHARD_W, SHARD_H = 16, 1920, 1080
SHARD_MESH = (2, 2)


def rigid_frame(args):
    """One "rigid" I420 frame (w, h, time t) edge-padded to whole MBs, as
    uint8 (numpy only: a worker of the frame pool runs it)."""
    import numpy as np

    from tpuh264_torch.engine.sources import yuv_frame

    w, h, t = args
    pad_h, pad_w = -h % 16, -w % 16
    return [np.pad(p, ((0, pad_h // k), (0, pad_w // k)), mode="edge")
            .astype(np.uint8)
            for k, p in zip((1, 2, 2), yuv_frame(w, h, t, kind="rigid"))]


def shard_frames(tmp, n_frames):
    """The phase's content as .npy files every rank maps: frame t of
    stream s is "rigid" at time t + 3 s (numpy on the host, so every rank
    and the oracle see the same samples), made by a pool of processes."""
    import multiprocessing

    import numpy as np

    jobs = [(SHARD_W, SHARD_H, t + 3 * s) for t in range(n_frames)
            for s in range(SHARD_STREAMS)]
    with multiprocessing.get_context("spawn").Pool(
            min(8, os.cpu_count() or 1)) as pool:
        frames = pool.map(rigid_frame, jobs)
    for t in range(n_frames):
        for p, name in enumerate("yuv"):
            np.save(os.path.join(tmp, f"{name}{t}.npy"), np.stack(
                [frames[t * SHARD_STREAMS + s][p]
                 for s in range(SHARD_STREAMS)]))


def _sym_fields(sym):
    return [(n, getattr(sym, n)) for n in sym._fields
            if getattr(sym, n) is not None]


def shard_rank(rank: int, tmp: str) -> None:
    """Phase 16(a), one rank (a process of its own, on the card): the I + P
    frames of its band of the (streams, rows) mesh, the DPB halo crossing
    processes through gloo; the halo decode of its own P symbols == its
    reconstruction band; then every frame's symbols, recon and motion
    gathered, and on rank 0 held to the unsharded encode of the same frames
    on the same device.  The job (mesh, frames, QP, device) is tmp's
    job.json, the frames its .npy files.  Prints SHARD_RESULT {json};
    exits non-zero on a difference."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpuh264_torch.dist import mesh as dm
    from tpuh264_torch.dist import multihost
    from tpuh264_torch.kernels import iframe, me_cuda, pframe

    with open(os.path.join(tmp, "job.json")) as f:
        job = json.load(f)
    dev, qp, n = torch.device(job["device"]), job["qp"], job["frames"]
    sync = torch.cuda.synchronize
    multihost.initialize(f"file://{tmp}/rendezvous", job["world"], rank,
                         "gloo", dev)
    try:
        mesh = dm.make_codec_mesh(*job["mesh"], device=dev)
        frames = [[np.load(os.path.join(tmp, f"{p}{t}.npy"), mmap_mode="r")
                   for p in "yuv"] for t in range(n)]
        i_fn, p_fn = dm.sharded_gop_step(mesh, fused_halo=True)
        plain = []
        sad = me_cuda._sad_field
        me_cuda._sad_field = lambda *a: plain.append(1) or sad(*a)
        k1 = me_cuda.sad_field.launches
        sync()
        t0 = time.perf_counter()
        sym, rec = i_fn(*dm.shard_inputs(mesh, *frames[0]), qp)
        sync()
        i_ms = (time.perf_counter() - t0) * 1e3
        syms, recs, mots, p_ms = [sym], [rec], [], []
        for t in range(1, n):
            t0 = time.perf_counter()
            sym, rec, mot = p_fn(*dm.shard_inputs(mesh, *frames[t]),
                                 *recs[-1], qp)
            sync()
            p_ms.append(round((time.perf_counter() - t0) * 1e3, 1))
            syms.append(sym)
            recs.append(rec)
            mots.append(mot)
        k1 = me_cuda.sad_field.launches - k1
        me_cuda._sad_field = sad
        # each rank decodes its own P symbols against its halo-extended DPB
        halo_ok = True
        for t in range(1, n):
            ext = dm._halo_extend_yuv(*recs[t - 1], pframe.HALO_Y,
                                      pframe.HALO_C, mesh)
            dec, _ = pframe.decode_pframe_rows_multi(
                syms[t], *(e[None] for e in ext), qp, halo=True)
            halo_ok &= all(torch.equal(a, b) for a, b in zip(dec, recs[t]))
        got = [([(f, dm.gather(mesh, x)) for f, x in _sym_fields(syms[t])],
                [dm.gather(mesh, x) for x in recs[t]],
                [dm.gather(mesh, x) for x in mots[t - 1]] if t else [])
               for t in range(n)]
        ok = halo_ok and k1 == n - 1 and not plain
        result = dict(rank=rank, band=[mesh.stream_index, mesh.row_index],
                      shape=list(recs[0][0].shape), k1_launches=k1,
                      plain_k1_calls=len(plain), i_ms=round(i_ms, 1),
                      p_step_ms=p_ms, halo_decode_equal=bool(halo_ok))
        if rank == 0:
            # the unsharded encode of the same frames on the same device
            t0 = time.perf_counter()
            up = lambda t: [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                            for a in frames[t]]
            sym, rec = iframe.encode_iframe_rows(*up(0), qp)
            ref = [(sym, rec, ())]
            for t in range(1, n):
                sym, rec, mot = pframe.encode_pframe_rows_multi(
                    *up(t), *(r[None] for r in rec), qp)
                ref.append((sym, rec, mot))
            sync()
            result["unsharded_ms"] = round((time.perf_counter() - t0) * 1e3,
                                           1)
            same = []
            for (gs, gr, gm), (rs, rr, rm) in zip(got, ref):
                same += [torch.equal(x, getattr(rs, f).cpu()) for f, x in gs]
                same += [torch.equal(a, b.cpu()) for a, b in zip(gr, rr)]
                same += [torch.equal(a, b.cpu()) for a, b in zip(gm, rm)]
            # vertical MVs across the mesh's band edge: the bottom MB row of
            # the top band pointing down, the top row of the next pointing up
            edge = recs[0][0].shape[1] // 16
            cross = sum(int((m[1][:, edge - 1] > 0).sum()
                            + (m[1][:, edge] < 0).sum())
                        for _, _, m in got[1:])
            result.update(equal_unsharded=all(same), compared=len(same),
                          crossing_mbs=cross)
            ok = ok and all(same) and cross > 0
        print("SHARD_RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()
    if not ok:
        sys.exit(1)


def nccl_rank(tmp: str, device: str) -> None:
    """Phase 16(c): a 1-rank NCCL group (mesh 1x1) runs sharded_gop_step
    at 854x480 x 8 (padded to whole MBs) -- its collectives on NCCL's
    route, device tensors -- and equals the unsharded encode.  Prints
    NCCL_RESULT {json}; exits non-zero on a difference."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from tpuh264_torch.dist import mesh as dm
    from tpuh264_torch.dist import multihost
    from tpuh264_torch.kernels import iframe, me_cuda, pframe

    dev = torch.device(device)
    multihost.initialize(f"file://{tmp}/nccl_rendezvous", 1, 0, "nccl", dev)
    try:
        mesh = dm.make_codec_mesh(1, 1, device=dev)
        frames = [[np.stack(p) for p in zip(*[
            rigid_frame((854, 480, t + 3 * s)) for s in range(8)])]
            for t in range(3)]
        i_fn, p_fn = dm.sharded_gop_step(mesh, fused_halo=False)
        k1 = me_cuda.sad_field.launches
        _, rec = i_fn(*dm.shard_inputs(mesh, *frames[0]), SHARD_QP)
        for t in (1, 2):
            sym, rec, _ = p_fn(*dm.shard_inputs(mesh, *frames[t]), *rec,
                               SHARD_QP)
        k1 = me_cuda.sad_field.launches - k1
        got = [dm.gather(mesh, x) for x in rec] + [
            dm.gather(mesh, x) for _, x in _sym_fields(sym)]
        up = lambda t: [torch.from_numpy(a).to(dev) for a in frames[t]]
        _, ref = iframe.encode_iframe_rows(*up(0), SHARD_QP)
        for t in (1, 2):
            rsym, ref, _ = pframe.encode_pframe_rows_multi(
                *up(t), *(r[None] for r in ref), SHARD_QP)
        exp = [r.cpu() for r in ref] + [x.cpu() for _, x in _sym_fields(rsym)]
        ok = all(torch.equal(a, b) for a, b in zip(got, exp))
        print("NCCL_RESULT " + json.dumps(dict(
            backend=dist.get_backend(), shape=list(rec[0].shape),
            equal_unsharded=ok, k1_launches=k1)), flush=True)
    finally:
        dist.destroy_process_group()
    if not ok:
        sys.exit(1)


def start_procs(cmds, tmp, tag, env_extra=None):
    """Start one process a command (cwd: the checkout), each writing its
    output to a file under `tmp` (no pipe can fill and stall a rank)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep
               + os.environ.get("PYTHONPATH", ""), **(env_extra or {}))
    procs = []
    for i, cmd in enumerate(cmds):
        log = open(os.path.join(tmp, f"{tag}{i}.log"), "w+")
        procs.append((subprocess.Popen(cmd, cwd=here, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def wait_procs(procs, timeout_s: float, tag: str, marker: str):
    """Each process's `marker` result line as a dict.  A process that
    fails, prints no result or outlives `timeout_s` fails the smoke, and
    every process of the group is killed first."""
    deadline = time.perf_counter() + timeout_s
    results = []
    try:
        for p, log in procs:
            try:
                rc = p.wait(timeout=max(1.0, deadline - time.perf_counter()))
            except subprocess.TimeoutExpired:
                fail(f"{tag}: a process ran past {timeout_s:.0f} s")
            log.seek(0)
            out = log.read()
            lines = [l for l in out.splitlines() if l.startswith(marker)]
            if rc != 0 or not lines:
                fail(f"{tag}: a process exited {rc}"
                     f"{'' if lines else ' without a result'}:\n"
                     f"{out[-3000:]}")
            results.append(json.loads(lines[-1].split(" ", 1)[1]))
    finally:
        kill_procs(procs)
    return results


def kill_procs(procs) -> None:
    for p, log in procs:
        p.kill()
        p.wait()
        log.close()


def phase_dist(dev, np, card, launches):
    """Phase 16: the distribution layer, device_pack and the bench harness.

    (a) BASELINE config 5 ("16x 1080p30 streams, GOP/slice-row sharded",
    BASELINE.json:11) on the one card: 4 ranks (processes), gloo with a
    file:// rendezvous, mesh (streams 2, rows 2), so each rank holds 8
    streams x 34 of the 68 MB rows and the rows groups cross processes;
    16 streams of "rigid" 1920x1080 (vertical motion, so MVs cross the
    band edge), I + 2 P at QP 30 through sharded_gop_step with the fused
    halo.  Checked: every frame's gathered symbols, recon and motion ==
    the unsharded encode on the card (rank 0); MVs across the band edge;
    each rank's halo decode == its band; K1 once per rank per P frame (8)
    and its plain version never.  The depth is cut to 3 frames (a GOP's
    first I and two P, which already exercise the I step, the halo and the
    reference chain) and the ranks to 4 on one card (the smoke must run on
    one card: the four processes share it, as gloo allows) for the
    smoke's wall.
    (b) `python -m tpuh264_torch.dist.multihost`, 2 processes on the card
    with gloo, rows across processes and not ("dcn-halo",
    "stream-parallel"), 832x480: both bitexact.
    (c) a 1-rank NCCL group (mesh 1x1): sharded_gop_step at 854x480 x 8 ==
    the unsharded encode, so the NCCL route initialises and runs on the
    card (NCCL between cards is not checked: one card is visible).
    (d) device_pack.assemble_iframe / assemble_pframe at 854x480 x 8: the
    card's bytes == the CPU's (plain K2 / K3) on the same symbols; the
    golden decoder decodes stream 0 to the encoder's recon.
    (e) bench.harness.run_matrix at 480p x 8, impls "tpu_gop" and "tpu",
    5 s each, its table and charts, machine_info naming the card.
    (quality.py needs libx264 and libavcodec, which the card machine
    lacks: the CPU tests hold it.)"""
    import tempfile

    import torch

    t_phase = time.perf_counter()
    n_frames = 3
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        shard_frames(tmp, n_frames)
        t_made = time.perf_counter()
        world = SHARD_MESH[0] * SHARD_MESH[1]
        with open(os.path.join(tmp, "job.json"), "w") as f:
            json.dump(dict(world=world, mesh=SHARD_MESH, frames=n_frames,
                           qp=SHARD_QP, device=str(dev)), f)
        code = ("import sys, chip_smoke; "
                "chip_smoke.shard_rank(int(sys.argv[1]), sys.argv[2])")
        ranks = wait_procs(start_procs(
            [[sys.executable, "-c", code, str(r), tmp] for r in range(world)],
            tmp, "rank"), 600, "phase 16(a)", "SHARD_RESULT ")
        t_a = time.perf_counter()
        k1 = sum(r["k1_launches"] for r in ranks)
        if k1 != world * (n_frames - 1) or any(r["plain_k1_calls"]
                                               for r in ranks):
            fail(f"phase 16(a): K1 launched {k1} times (expected "
                 f"{world * (n_frames - 1)}); plain K1 "
                 f"{[r['plain_k1_calls'] for r in ranks]}")
        r0 = ranks[0]
        for r in ranks:
            print(f"phase 16(a): rank {r['rank']} band {r['band']} "
                  f"{r['shape']}: I {r['i_ms']} ms, P steps {r['p_step_ms']}"
                  f" ms (fenced, halo exchange included), halo decode == "
                  f"band {r['halo_decode_equal']}, K1 {r['k1_launches']} "
                  f"[{card}]")
        print(f"phase 16(a): BASELINE config 5 cut to one card: "
              f"{SHARD_STREAMS} x {SHARD_W}x{SHARD_H} 'rigid', I + "
              f"{n_frames - 1} P at QP {SHARD_QP} (GOP depth cut to "
              f"{n_frames} frames), mesh {SHARD_MESH} over {world} gloo "
              f"ranks on one card, fused halo: gathered symbols, recon and "
              f"motion == the unsharded encode ({r0['compared']} tensors, "
              f"unsharded {r0['unsharded_ms']} ms on rank 0); "
              f"{r0['crossing_mbs']} MBs with a vertical MV across the "
              f"band edge; K1 {k1} launches, plain K1 none; frames made in "
              f"{t_made - t_phase:.1f} s, ranks {t_a - t_made:.1f} s "
              f"[{card}]")

        # (b) and (c) in their own processes while (d) runs here
        mh = [[sys.executable, "-m", "tpuh264_torch.dist.multihost",
               "--coordinator", f"file://{tmp}/mh{int(rows)}",
               "--num-processes", "2", "--process-id", str(pid),
               "--width", "832", "--height", "480", "--bench-reps", "2",
               "--device", str(dev)] + (["--rows-across-hosts"] if rows
                                      else [])
              for rows in (True, False) for pid in (0, 1)]
        mh_procs = start_procs(mh, tmp, "multihost")
        # the 1-rank group's bootstrap stays on the loopback: one host
        nccl_procs = start_procs(
            [[sys.executable, "-c", "import sys, chip_smoke; "
              "chip_smoke.nccl_rank(*sys.argv[1:])", tmp, str(dev)]], tmp,
            "nccl", {"NCCL_SOCKET_IFNAME": "lo"})
        try:
            phase_device_pack(dev, np, card, launches, torch)
        except BaseException:
            kill_procs(mh_procs + nccl_procs)
            raise
        mh_res = wait_procs(mh_procs, 300, "phase 16(b)",
                            "MULTIHOST_RESULT ")
        nccl_res = wait_procs(nccl_procs, 300, "phase 16(c)",
                              "NCCL_RESULT ")[0]
    for r in mh_res:
        if not r["bitexact"] or r["k1_launches"] != 2:
            fail(f"phase 16(b): multihost worker {r}")
    for rows in (True, False):
        rs = [r for r in mh_res if r["rows_across_hosts"] == rows]
        print(f"phase 16(b): python -m tpuh264_torch.dist.multihost, 2 gloo "
              f"processes on the card, 832x480, "
              f"{'dcn-halo' if rows else 'stream-parallel'} mesh "
              f"{rs[0]['mesh']}, fused halo {rs[0]['fused_halo']}: bitexact "
              f"in both; P step {[round(r['p_step_ms'], 1) for r in rs]} ms "
              f"[{card}]")
    if (not nccl_res["equal_unsharded"] or nccl_res["backend"] != "nccl"
            or nccl_res["k1_launches"] != 2):
        fail(f"phase 16(c): {nccl_res}")
    print(f"phase 16(c): a 1-rank NCCL group, mesh 1x1, sharded_gop_step "
          f"854x480 x 8 ({nccl_res['shape']}), I + 2 P: == the unsharded "
          f"encode (NCCL between cards not checked: one card) [{card}]")
    launches.total[0] += k1 + sum(r["k1_launches"] for r in mh_res) + \
        nccl_res["k1_launches"]
    phase_bench(dev, card, launches)
    print(f"phase 16: wall {time.perf_counter() - t_phase:.1f} s [{card}]")


def phase_device_pack(dev, np, card, launches, torch):
    """Phase 16(d): assemble_iframe / assemble_pframe at 854x480 x 8 on the
    card == on the CPU (plain K2 / K3) for the same symbols; the golden
    decoder decodes stream 0 (SPS, PPS, I, P) to the encoder's recon."""
    from tpuh264_torch.core.params import PPS, SPS
    from tpuh264_torch.entropy import device_pack
    from tpuh264_torch.golden import codec
    from tpuh264_torch.kernels import iframe, pframe

    w, h, s, qp = 854, 480, 8, 30
    f0, f1 = ([torch.from_numpy(np.stack(p)).to(dev) for p in zip(*[
        rigid_frame((w, h, t + 3 * i)) for i in range(s)])] for t in (0, 1))
    sps, pps = SPS.for_size(w, h), PPS()
    sym_i, rec_i = iframe.encode_iframe_rows(*f0, qp)
    sym_p, rec_p, _ = pframe.encode_pframe_rows_multi(
        *f1, *(r[None] for r in rec_i), qp)

    def pack(dv):
        on = lambda sym: type(sym)(*(None if x is None else x.to(dv)
                                     for x in sym))
        a, ovf_a = device_pack.assemble_iframe(on(sym_i), sps, pps, qp)
        b, ovf_b = device_pack.assemble_pframe(on(sym_p), sps, pps, qp)
        if ovf_a or ovf_b:
            fail(f"phase 16(d): device entropy overflow on {dv}")
        return a, b

    gpu, counts = launches.path("device_pack 480p x 8", lambda: pack(dev),
                                needs=(1, 2))
    cpu = pack("cpu")
    if gpu != cpu:
        fail("phase 16(d): the card's assembled bytes differ from the CPU's")
    frames = codec.decode_annexb_seq(gpu[0][0] + gpu[1][0])
    for t, rec in enumerate((rec_i, rec_p)):
        if not all(np.array_equal(np.asarray(a), r[0, :a.shape[0],
                                                    :a.shape[1]].cpu().numpy())
                   for a, r in zip(frames[t], rec)):
            fail(f"phase 16(d): golden decode != encoder recon, frame {t}")
    print(f"phase 16(d): device_pack.assemble_iframe / assemble_pframe "
          f"854x480 x 8, QP {qp}: card bytes == CPU bytes "
          f"({sum(map(len, gpu[0]))} + {sum(map(len, gpu[1]))} B), stream 0 "
          f"decoded by the golden decoder == encoder recon; K2 {counts[1]}, "
          f"K3 {counts[2]} launches [{card}]")


def phase_bench(dev, card, launches):
    """Phase 16(e): the port's bench harness at 480p x 8, impls "tpu_gop"
    and "tpu", 5 s each; its table, charts and machine_info."""
    import tempfile

    from tpuh264_torch.bench import charts, harness

    rows, counts = launches.path(
        "bench harness 480p x 8", lambda: harness.run_matrix(
            resolutions=("480p",), streams=(8,), impls=("tpu_gop", "tpu"),
            duration_s=5, device=dev))
    if any(r["frames"] <= 0 for r in rows):
        fail(f"phase 16(e): a harness run counted no frame: {rows}")
    info = harness.machine_info()
    if info.get("device_kind") is None or "card" not in info:
        fail(f"phase 16(e): machine_info names no card: {info}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_charts_") as tmp:
        paths = charts.render_charts(rows, os.path.join(tmp, "bench"))
        if not paths or not all(os.path.getsize(p) > 0 for p in paths):
            fail(f"phase 16(e): render_charts wrote {paths}")
    print(f"phase 16(e): bench.harness.run_matrix 480p x 8, tpu_gop + tpu, "
          f"5 s each; machine_info {info}; {len(paths)} charts rendered")
    for line in harness.render_table(rows).splitlines():
        print(f"phase 16(e): {line} [{card}]")


def main() -> None:
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "tpuh264_torch", "csrc")):
        fail("tpuh264_torch/ not found next to chip_smoke.py: run from a "
             "checkout of the repository")
    sys.path.insert(0, here)
    # the run uses one card: the process sees only the first visible one
    # (in nvidia-smi's PCI order), so device_count() counts the cards used
    os.environ.setdefault("CUDA_DEVICE_ORDER", "PCI_BUS_ID")
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    os.environ["CUDA_VISIBLE_DEVICES"] = (
        "0" if visible is None else visible.split(",")[0].strip())
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this smoke run needs a GPU")
    if torch.cuda.device_count() != 1:
        fail(f"{torch.cuda.device_count()} cards visible, expected 1")
    dev = torch.device("cuda", 0)
    card = card_line(os.environ["CUDA_VISIBLE_DEVICES"])
    print(card)

    from tpuh264_torch.entropy import native
    from tpuh264_torch.kernels import cuda_lib

    t0 = time.perf_counter()
    cuda_lib.load()
    t1 = time.perf_counter()
    native.load()
    print(f"phase 1: kernels built in {cuda_lib.build_seconds:.1f} s "
          f"(load {t1 - t0:.1f} s) with nvcc for sm_90a; host CAVLC engine "
          f"built and loaded in {time.perf_counter() - t1:.1f} s with g++")

    rows = phase_kernels(dev, torch, np)
    phase_small(dev, torch, np)
    phase_small_sessions(dev, np)

    launches = Launches()
    launches.path("main path 1080p x 4",
                  lambda: phase_main(dev, torch, np, card))
    phase_runs(dev, card)
    phase_intra_in_p(dev, torch, np, card, launches)
    phase_multiref(dev, torch, np, card, launches)
    phase_ingest_fanout(dev, torch, np, card, launches)
    phase_device_pipeline(dev, torch, np, card, launches)
    phase_app(dev, card, launches)
    phase_sessions(dev, np, card, launches)
    phase_wavefront(dev, np, card, launches)
    phase_app_tpu(dev, np, card, launches)
    phase_gate(dev, np, card, launches)
    phase_config3(dev, np, card, launches)
    phase_dist(dev, np, card, launches)

    for r, n in zip(rows, launches.total):
        r["launches"] = n
    print(f"launches summed over the driven paths: K1 {launches.total[0]}, "
          f"K2 {launches.total[1]}, K3 {launches.total[2]}")
    banned = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "tpuh264"))
    if banned:
        fail(f"JAX or the JAX package was imported: {banned[:8]}")
    print(f"chip_smoke: total wall {time.perf_counter() - T_START:.1f} s")
    print(json.dumps({"kernels": [
        {k: r[k] for k in ("name", "route", "source", "replaces", "launches",
                           "max_abs_err", "ms", "plain_ms", "bound_ms",
                           "bound_by", "library_ms")} for r in rows]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))  # 1: the one card it used


if __name__ == "__main__":
    main()
