#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (tpuh264_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with a CUDA card and nvcc
(/usr/local/cuda or CUDA_HOME).  It builds the port's CUDA kernels from
tpuh264_torch/csrc, then:

  1. prints the card (nvidia-smi name and power limit) and builds the
     port's two libraries: the CUDA kernels (nvcc) and the host CAVLC
     engine (g++, a copy of native/cavlc.cpp);
  2. holds K1 (stage-A SAD table), K2 (CAVLC block pack), K3 (bit-
     string merge), K4 (D1, the in-loop deblock), K5 (D2, the
     decoders' intra-reconstruction column scan), K6 (D3 and D4, the
     encoder's Intra_16x16 column scans), K7 and K8 (the single-slice
     wavefront's encode and decode, a thread-block cluster a stream, its
     MB rows pipelined), K9 (the P encode after stage A: refinement,
     reference choice, MC, inter coding), K10 (the P decode's MV
     chain, MC and inter residuals), K11 (the reference build: half-pel
     planes and padded chroma), K12 (the stage-A winner) and K15 (the
     device source, each kind, also on `K15_EDGES`: one MB, an odd MB
     count, S = 1, k = 1 and 4, t = 0 and past sinf's fast path) against
     their plain
     PyTorch versions on the card (exact equality) at the main path's
     1920x1080 x 4 shapes (K4: an encoded I frame and P frame; K5: the
     decoders' own inputs of that P frame and of its IDR, the residuals
     decoded from the levels), K3 at its
     MB level (27 chunks -> 128 words) and its slice level (K = 123
     strings -> 8192 words), with the winner selection's first-index ties
     on the card; all three again on seeded edge cases (K1: samples 0 and
     255, the maximum SAD, ragged tiles, S = 1 and 4; K2: escape levels,
     16 nonzeros, chroma DC, nh 0..8, n_w 1 / 6 / 20 / 32 with
     truncation, code_residual 0; K3: all-ones strings of 0, 1, 31, 32,
     33 and 32*W bits, empty lanes, K 1 / 27 / 123 x W 1 / 20 / 128 x
     n_out 1 / 16 / 128 / 8192 with truncation), and K2/K3 on intra-in-P
     P symbols at 854x480 x 8 (skip, inter and intra MBs; slice level
     K = 57); K4 on seeded edge cases (`d1_case`: C = 1, odd S / R / C,
     an even C of 16, MV steps 3 / 4 / 5, refidx 0..3, random t8,
     all-intra, qp 0 .. 51) and on config-3 symbols (the 8x8 transform,
     intra-in-P) at 854x480 x 8, its ring entry (uint8 planes in, a ring
     slot out, the coded 4x4 blocks from the levels) on those frames, on
     the P frame's record views and on every D1 case (`d1_ring_args`:
     the fields as record views and apart), held
     to the plain deblock on `deblock_nnz`'s grid; K5 on seeded cases (`d2_case`: C = 1,
     2, 3 and 61, intra shares 0 / ~1% / 50% / 100% and the I decode, DC
     and H mixes, clips at 0 and 255, H modes in column 0, which no legal
     stream codes, levels the cbps mask out, QPs 0, 32 and 51) and on a
     default-config (intra-in-P)
     P frame of "meeting" at 854x480 x 8, intra MBs required; K5's
     Intra_4x4 route (`i44`, its "K5-i44" row) on a 1920x1080 (1088) x 4
     IDR whose MBs are all Intra_4x4, on the IDR of phase 11's
     "meeting" session at 854x480 x 8 (the decoders' own inputs) and on
     seeded cases (`d2_i44_case`: all-Intra_4x4 and mixed columns,
     beside `other` too, every mode at every block, modes outside 0..8,
     levels outside cbp_luma, QPs 0, 12, 32, 51, lanes past the ring); K6 on the
     1080p x 4 I frame (D3), on the intra-in-P P frame at 854x480 x 8
     (D4, the P encode's own inputs of its scan) and on seeded cases
     (`d3_case`, `d4_args`: C = 1, 2, 3 and 61; flat, noise, rows and
     0 / 255 content; QPs 0, 11, 12, 28, 51; D3 from uint8 and int32
     planes; D4 intra shares 0 / ~1% / 50% / 100% and exact SAD ties);
     K6's Intra_4x4 route (`intra44`, its "K6-i44" row: the trial and the
     I16-vs-I4x4 choice) on that 1080p x 4 I frame, on the IDR of phase
     11's session (its own int32 planes, QP 34) and on seeded cases
     (`d3_i44_case`: C = 1, 2, 3 and 61; stripes where Intra_4x4 wins a
     share, flat content where mode SADs and J tie, noise, 0 / 255; QPs
     0, 12, 28, 51; uint8 and int32 planes); K7 / K8 on one frame of phase 12's 854x480 x 8, of BASELINE config
     1's 640x360 (368) x 1 and of 1920x1080 (1088) x 1 (the "meeting"
     clip, QP 28), and on seeded cases (`wave_case`: one MB, one row, one
     column, R > C, several rows a CTA; noise, ramps, mixed MB kinds,
     flat 0 / 255 and saturated frames; QPs 0, 11, 12, 28, 51; K7 from
     uint8 and int32 planes; K8 also on random modes, each legal at its
     MB, on any modes (0-3 at every MB) and on random cbp over the
     levels), K8 on K7's symbols equal to K7's recon too; their cluster
     and team sizes; K9 / K10 on the 1080p x 4 RTC P frame (one
     reference) and its decode, on a 854x480 x 8 default-config P frame
     of "meeting" with two references and intra-in-P and its decode, and
     on seeded cases (`k9_case`, `k10_case`: one MB, odd S, a row of 34
     columns; noise, motion, flat and 0 / 255 content; QPs 0, 28, 51;
     1-4 and 6 references, ref_base 0 / 1, stage-A winners at +-8, halo and
     intra-in-P on and off; decode symbols of skip, inter and intra MBs
     with chains that restart and run past the planes' pad); K9's and
     K10's t8 routes (the 8x8 transform's choice and decode, config 3's)
     on config 3's 1920x1080 x 1 P frame with two references (their rows
     of the kernel table, "K9-t8" and "K10-t8"), on part B's 854x480 x 8
     with two references, both also timed without t8, with each route's
     resident warps an SM, and on seeded cases (`K9_T8_CASES`,
     `K10_T8_CASES`: QPs 0, 5, 6, 11, 12 .. 51, J ties, an 8x8 coding
     of no level, t8 on skip and intra MBs and levels outside
     cbp_luma; 1-4 references, windows past the planes' pads and at
     them, a later reference chosen); K11 / K12 on
     that P frame's encode (and K11 its decode) and the 480p frame's two
     references, and on seeded cases (`k11_case`: S 1 / 3, one MB, a
     row, a column, 97 columns, N 1 / 2 / 4, halo on and off, uint8 and
     int32; `k12_case`: noise, mirrored ties, tied counts, a group's
     counts summed in), K11 also beside its closest library formulation
     (replicate F.pad + float32 conv2d);
     times each kernel beside its plain
     version (CUDA events, after a warm-up) and against its bound (the
     bytes it must move over the card's 3.35 TB/s), K4 and K6 also in
     cycles a MB column, K7 and K8 in cycles a wave, at the SM clock read
     under load, and one fenced
     `encode_bits_pframe` call; P1 and P2 (the toolchain probe's bit
     operations and slab sum) against their plain versions at the
     probe's shapes, on `P1_CASES` / `P2_CASES` (tails, offset views
     aligned and not, ragged M * L, edge values, sums that wrap) and at
     a shape where bytes bind (16,777,216 int32; [16, 1024, 1024]),
     P2 beside torch.sum(dtype=torch.int32);
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
     equals the encoder DPB bit for bit (both sides deblock with K4), K15
     once a dispatch, K3
     launched twice (MB and slice level) per entropy call: 4 times per
     IDR dispatch, 2 per interior one, K4's ring entry 8 times per
     dispatch (each frame into its ring slot), K14 4 times (a decoded
     frame each), K5
     4 times (once a decoded frame, the IDR's included) and K6 once a
     GOP-start dispatch (its I frame);
  5. runs `run()` briefly at that configuration and at 854x480 x 8 streams
     at 1 Mbps through `bench.headline.measure` (one repeat each, decoder
     DPB == encoder DPB after it) and prints aggregate fps, the labelled
     stage split, PSNR and QP, and the headline's line and 480p line;
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
     the upload ms per dispatch; then `bench.ingest.measure` on that
     pipeline for 3 s, its `host_ingest_fanout` line;
  9. the I-only DevicePipeline at 854x480, decoded 8 times from symbols;
     the port's own decode of a frame's bytes (`decode_bytes`: native
     parse + I scan) equals the encoder's reconstruction;
 10. the live App (impl "tpu_gop") with the defaults at 854x480 x 8 for
     10 s, or longer until its first dispatch has retired: its stats,
     capture drops included, and their `bench.live.render` view, then
     stop();
 11. EncoderSession at the reference's operating point, 854x480 x 8 from
     RGBA (a different "meeting" clip frame per stream), intra44 +
     deblock, gop 8, CBR 1 Mbps, 10 frames across an IDR: every frame's 8
     access units through DecoderPool.decode_batch == the recon; Intra_4x4
     MBs coded in the IDR frames; K1 launched once per P frame; per-frame
     copy / encode / entropy / decode ms;
 12. single-slice I frames (the wavefront: K7 once a frame, K8 once a
     decoded frame) at 854x480 x 8, gop 1, 2 frames, each stream decoded
     by its own DecoderSession == the recon; then BASELINE config 1:
     EncoderSession 640x360 x 1, QP 28, single slice, gop 1, 30 frames of
     the "meeting" clip, each through a DecoderSession == the recon, K7
     and K8 30 times each, frame 0 through the gate's oracle == the
     recon; mean encode / entropy / decode ms and the round trip's fps;
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
 15. BASELINE config 3 on the card through `bench.config3` (the analog of
     tools/bench_config3.py): EncoderSession 1920x1080, CABAC + 8x8
     transform, 2 references, CBR 4 Mbps, intra-in-P, gop 6, 6 frames of
     "rigid" (IDR + 5 P), each access unit through a DecoderSession ==
     the recon; MBs coded with
     the 8x8 transform and with reference 1 required; K1 launched once
     per P frame and searched reference (1 + 2 x 4 = 9); the whole
     stream decoded by the golden decoder in a spawned worker == the
     recon of every frame, K9 and K10 launched on their t8 routes only,
     beside part B: 854x480 x 8 from RGBA, CABAC +
     8x8 transform + deblock, 2 references, CBR 1 Mbps, gop 8, 4 frames
     through DecoderPool.decode_batch (per session: CABAC does not
     batch) == the recon, and its stream 0 decoded by the golden decoder
     == the recon (a check of K4's t8 edges independent of K4); per-frame
     copy / encode / entropy / decode ms, kbps at 30 fps, PSNR-Y, QP, and
     the t8 / reference-1 / intra shares of the P MBs; the
     `config3_session_encode` line; `bench.config3.flagship_multiref`
     (1920x1080 x 4, 2 references, CBR 4 Mbps) for 2 s, decoder DPB ==
     encoder DPB after it;
 16. the distribution layer, device_pack and the bench harness: (a)
     BASELINE config 5 cut to one card -- 4 ranks (processes) sharing it
     under gloo, mesh (streams 2, rows 2), 16 x 1920x1080 "rigid", I + 2
     P at QP 30 through `dist.mesh.sharded_gop_step` with the fused halo:
     every frame's gathered symbols, recon and motion == the unsharded
     encode on the card, MVs across the band edge, each rank's halo
     decode == its band, K1 once per rank per P frame (8), its plain
     version never; (b) `bench.multihost.measure` at its smallest mesh
     (1x2, 2 processes of `python -m tpuh264_torch.dist.multihost`), one
     host then two hosts with the rows across them, and the
     stream-parallel layout, at 832x480: bitexact; (c) a 1-rank NCCL
     group at 854x480 x 8 == the unsharded encode; (d)
     `device_pack.assemble_iframe` / `assemble_pframe` at 854x480 x 8:
     card bytes == CPU bytes, the golden decode == recon; (e)
     `bench.harness.run_matrix` at 480p x 8 ("tpu_gop", "tpu"), its
     table and charts.  Every spawned process has a timeout; on a failure
     all are killed and the run fails;
 17. the toolchain probe (`python -m tpuh264_torch.kernels.probe`, the
     counterpart of tools/pallas_smoke.py) on the card: both its match
     lines True, P1 and P2 launched once each.

Every path of phases 4 and 6-17 is driven with the kernels' launch
counts set to 0 just before it and read just after; each must have
launched every kernel it runs (K15 on every path with a device source:
phases 4, 6, 7, 9, 10, 14, 15's flagship and 16(e); phase 12 and the
general stream have no P frame on the fast path, so no K1; K7 and K8 run on phase 12 alone
(and in phase 3's single-slice session case); the deblock runs on every GOP
pipeline and on the sessions with `deblock=True`; K5 on every path that
decodes but the wavefront's, phase 16(a)'s halo decodes too; K6 on
every path that encodes an I frame or a P frame with intra-in-P, phase
16(a)'s ranks too, its Intra_4x4 route on the sessions with `intra44`;
K9 on every path that encodes a P
frame and K10 on every path that decodes one, config 3's on their t8
routes; K11 on every
path that encodes or decodes a P frame, K12 on every one that encodes
one, config 3 and phase 16(a)'s halo ranks included; P1 and P2 on phase
17 alone, once each), and none may
reach the plain version of K1, K3, K4 (either entry), K5 or K6 (their
Intra_4x4 routes included: the sessions with `intra44` must launch both),
K7, K8, K9, K10, K11, K12, K13, K14, K15, P1 or P2, nor `deblock_nnz` or
a plane copy for K4, nor the eager intra residuals.  Encoder DPB ==
decoder DPB does not
check K4 (both sides run it): phase 14's gate against the oracle and
phase 15's golden decode do.  No session of the engine's own streams (phases
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


def card_line(card: str, fields: str = "name,power.limit") -> str:
    """nvidia-smi's `fields` (by default the name and power limit) of
    `card` (an index or UUID), as its csv line."""
    res = subprocess.run(
        ["nvidia-smi", "-i", card, f"--query-gpu={fields}",
         "--format=csv,noheader"], capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvidia-smi failed: {res.stderr.strip()}")
    return res.stdout.strip().splitlines()[0]


def busy_sm_clock() -> int:
    """The card's SM clock in MHz (nvidia-smi clocks.sm), read while a
    ~1 s device sleep keeps it busy: an idle card lowers its clock."""
    import torch

    torch.cuda._sleep(2_000_000_000)  # cycles
    mhz = card_line(os.environ["CUDA_VISIBLE_DEVICES"], "clocks.sm")
    torch.cuda.synchronize()
    return int(mhz.split()[0])  # "1980 MHz"


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


def _plain_spy(name, f, calls):
    """`f` (the plain version `name`) counting its calls into `calls`."""
    def call(*a, **kw):
        calls.append(name)
        return f(*a, **kw)
    return call


class Launches:
    """The seventeen kernels' launch counts (K1, K2, K3 and K4: each its two
    entries' counts summed, K4 = the deblock D1 (its counts entry
    `deblock_frame_rows` and its ring entry `deblock_ring`, the one every
    path takes, printed apart),
    K5 = the intra reconstruction D2 (its Intra_4x4 route's launches also
    apart, `i44_total`, key "K5-i44"), K6 = the Intra_16x16 encode scans
    D3 and D4: its two routers' counts summed (D3's Intra_4x4 route's also
    apart, `k6_i44_total`, key "K6-i44"), K7 / K8 = the single-slice
    wavefront's encode / decode, K9 = the P encode after stage A, K10 =
    the P decode's inter part, K11 = the reference build, K12 = the
    stage-A winner: its calls, two launches each, K13 = the CAVLC
    prologue, K14 = the decoder's SSE, K15 = the device source, P1 / P2 =
    the toolchain probe's bit operations and slab sum), zeroed
    before and read after each path the smoke drives; summed over those
    paths for the kernel table.  The plain versions of K1 (`_sad_field`), K3
    (`tree_merge`), K4 (`_deblock_rows_plain`), K5
    (`_intra_recon_scan_plain`, and the eager `_intra_residuals`), K6
    (`_encode_iframe_scan_plain`, with `intra44` or without,
    `_intra_in_p_scan_plain`), K7
    (`_encode_iframe_single_plain`), K8 (`_decode_iframe_single_plain`),
    K9 (`_inter_encode_plain`), K10 (`_inter_decode_plain`), K11
    (`_references_plain`), K12 (`_int_winner_plain`),
    K13 (`_prologue_plain`), K2's and K3's entries on the symbols
    (`_pack_symbols_plain`, `_merge_slices_plain`), K14 (`_sse_plain`),
    K15 (`_device_source_gop_plain`), K4's ring entry
    (`_deblock_ring_plain`), P1 (`_probe_bits_plain`) and P2
    (`_slab_sum_plain`) are counted too, and so are `deblock_nnz` and
    `_plane_copy` (the deblock's eager coded-count grid and plane cast,
    which K4's ring entry replaced): none may run on a path.  K9's and
    K10's launches of their t8 routes (the CABAC + 8x8 session path's)
    are also counted apart (`t8_total`, keys "K9-t8" and "K10-t8"), and
    so are K3's slice entry's (`slices_total`, key "K3-slices").  P1
    and P2 run on the probe's path alone: any other path that launches
    one fails."""

    NEEDS = (0, 1, 2, 3, 4, 5, 8, 9, 10, 11, 12, 13)  # a GOP pipeline's
    NEEDS_SRC = NEEDS + (14,)  # ... with the device source
    PROBE = (15, 16)  # the toolchain probe's path
    KEYS = tuple(f"K{i}" for i in range(1, 16)) + ("P1", "P2")

    def __init__(self):
        from tpuh264_torch.engine import sources
        from tpuh264_torch.kernels import (cavlc_cuda, deblock, entropy_gpu,
                                           iframe, me_cuda, pframe, probe,
                                           sse, wavefront)

        self.fns = ((me_cuda.sad_field,),
                    (cavlc_cuda.pack_blocks, cavlc_cuda.pack_symbols),
                    (cavlc_cuda.merge_tree, cavlc_cuda.merge_slices),
                    (deblock.deblock_frame_rows, deblock.deblock_ring),
                    (iframe._intra_recon_scan,),
                    (iframe.encode_iframe_scan, pframe._intra_in_p_scan),
                    (wavefront.encode_iframe_single,),
                    (wavefront.decode_iframe_single,),
                    (pframe._inter_encode,), (pframe._inter_decode,),
                    (pframe._references,), (pframe._int_winner,),
                    (entropy_gpu.cavlc_prologue,), (sse.sse,),
                    (sources.device_source_gop,), (probe.probe_bits,),
                    (probe.slab_sum,))
        self.total = [0] * len(self.fns)
        self.t8_total = [0, 0]  # K9's and K10's t8 routes
        self.i44_total = 0  # K5's Intra_4x4 route
        self.k6_i44_total = 0  # K6's
        self.slices_total = 0  # K3's slice entry

    def by_key(self) -> dict:
        """The launch totals by kernel key ("K1" .. "K15", "P1", "P2", and
        "K9-t8", "K10-t8", "K5-i44", "K6-i44", "K3-slices": K9's and
        K10's t8 routes, K5's and K6's Intra_4x4 routes and K3's slice
        entry, also in theirs)."""
        return dict(zip(self.KEYS, self.total), **{
            "K9-t8": self.t8_total[0], "K10-t8": self.t8_total[1],
            "K5-i44": self.i44_total, "K6-i44": self.k6_i44_total,
            "K3-slices": self.slices_total})

    def path(self, name, fn, needs=NEEDS, i44=False):
        """Drive `fn()` with the counts zeroed and read after; fails unless
        every kernel of `needs` launched (and K5's and K6's Intra_4x4
        routes, where `i44`) and no plain version ran."""
        from tpuh264_torch.engine import sources
        from tpuh264_torch.kernels import (cavlc_cuda, deblock, entropy_gpu,
                                           iframe, me_cuda, pframe, probe,
                                           sse, wavefront)

        for fs in self.fns:
            for f in fs:
                f.launches = 0
        t8_fns = (pframe._inter_encode, pframe._inter_decode)
        for f in t8_fns:
            f.t8_launches = 0
        iframe._intra_recon_scan.i44_launches = 0
        iframe.encode_iframe_scan.i44_launches = 0
        plains = [(me_cuda, "_sad_field"), (cavlc_cuda, "tree_merge"),
                  (deblock, "_deblock_rows_plain"),
                  (iframe, "_intra_recon_scan_plain"),
                  (iframe, "_encode_iframe_scan_plain"),
                  (pframe, "_intra_in_p_scan_plain"),
                  (wavefront, "_encode_iframe_single_plain"),
                  (wavefront, "_decode_iframe_single_plain"),
                  (pframe, "_inter_encode_plain"),
                  (pframe, "_inter_decode_plain"),
                  (pframe, "_references_plain"),
                  (pframe, "_int_winner_plain"),
                  (entropy_gpu, "_prologue_plain"),
                  (cavlc_cuda, "_pack_symbols_plain"),
                  (cavlc_cuda, "_merge_slices_plain"), (sse, "_sse_plain"),
                  (sources, "_device_source_gop_plain"),
                  (deblock, "_deblock_ring_plain"), (deblock, "deblock_nnz"),
                  (deblock, "_plane_copy"), (probe, "_probe_bits_plain"),
                  (probe, "_slab_sum_plain")]
        saved = [getattr(m, a) for m, a in plains]
        calls = [[] for _ in plains]
        for (m, a), f, c in zip(plains, saved, calls):
            setattr(m, a, _plain_spy(a, f, c))
        # the eager intra residuals: K5 decodes them, they never run on
        # the card
        residuals, res_calls = iframe._intra_residuals, []
        iframe._intra_residuals = (
            lambda *a, **kw: res_calls.append(1) or residuals(*a, **kw))
        try:
            out = fn()
        finally:
            for (m, a), f in zip(plains, saved):
                setattr(m, a, f)
            iframe._intra_residuals = residuals
        counts = [sum(f.launches for f in fs) for fs in self.fns]
        for i, n in enumerate(counts):
            self.total[i] += n
        t8 = [f.t8_launches for f in t8_fns]
        self.t8_total = [a + b for a, b in zip(self.t8_total, t8)]
        n_i44 = iframe._intra_recon_scan.i44_launches
        self.i44_total += n_i44
        k6_i44 = iframe.encode_iframe_scan.i44_launches
        self.k6_i44_total += k6_i44
        self.slices_total += cavlc_cuda.merge_slices.launches
        k4_rows = deblock.deblock_frame_rows.launches
        plain = [len(c) for c in calls]
        print(f"launches [{name}]: K1 {counts[0]}, K2 {counts[1]}, "
              f"K3 {counts[2]}, K4 (deblock) {counts[3]}, K5 (intra "
              f"recon) {counts[4]}, K6 (intra16 encode) {counts[5]} (D3 "
              f"{self.fns[5][0].launches}, of them its Intra_4x4 route "
              f"{k6_i44}, D4 {self.fns[5][1].launches}), "
              f"K7 (wavefront encode) {counts[6]}, K8 (wavefront decode) "
              f"{counts[7]}, K9 (P encode) {counts[8]}, K10 (P decode) "
              f"{counts[9]}, K11 (references) {counts[10]}, K12 (stage-A "
              f"winner) {counts[11]}, K13 (CAVLC prologue) {counts[12]}, "
              f"K14 (SSE) {counts[13]}; plain calls K1 {plain[0]}, K3 "
              f"{plain[1]}, K4 {plain[2]}, K5 {plain[3]}, K6: "
              f"D3 {plain[4]}, D4 {plain[5]}, K7 "
              f"{plain[6]}, K8 {plain[7]}, K9 without t8 {plain[8]}, K10 "
              f"without t8 {plain[9]}, K11 {plain[10]}, K12 {plain[11]}, "
              f"K13 {plain[12]}, K2's symbols entry {plain[13]}, K3's slice "
              f"entry {plain[14]}, K14 {plain[15]}, K15 {plain[16]}, K4's "
              f"ring entry {plain[17]}, deblock_nnz {plain[18]}, K4 plane "
              f"copies {plain[19]}, P1 {plain[20]}, P2 {plain[21]}")
        print(f"launches [{name}]: K15 (device source) {counts[14]}; K4: "
              f"ring entry {counts[3] - k4_rows}, counts entry "
              f"(deblock_frame_rows) {k4_rows}; P1 (probe bits) "
              f"{counts[15]}, P2 (probe slab sum) {counts[16]}; the t8 "
              f"routes: K9 {t8[0]}, K10 {t8[1]}; K5's Intra_4x4 route "
              f"{n_i44}; eager intra residuals {len(res_calls)}")
        if any(counts[i] <= 0 for i in needs):
            fail(f"{name}: a kernel of the path was never launched: {counts}")
        if i44 and min(n_i44, k6_i44) <= 0:
            fail(f"{name}: K5's / K6's Intra_4x4 routes launched {n_i44} / "
                 f"{k6_i44} times")
        if any(counts[i] for i in self.PROBE if i not in needs):
            fail(f"{name}: the probe's P1 / P2 launched off its path: "
                 f"{counts}")
        if any(plain):
            fail(f"{name}: a plain version ran (K1, K3, K4, K5, K6 D3, K6 "
                 f"D4, K7, K8, K9, K10, K11, K12, K13, K2 symbols, K3 "
                 f"slices, K14, K15, K4 ring, deblock_nnz, K4 plane copies, "
                 f"P1, P2: {plain} times)")
        if res_calls:
            fail(f"{name}: the eager _intra_residuals ran {len(res_calls)} "
                 f"times on the card")
        return out, counts


HBM_BPS = 3.35e12  # H100 SXM device memory, NVIDIA's data sheet
NO_LIBRARY = {
    "K9": "no PyTorch call runs H.264 motion refinement, compensation "
          "and inter coding",
    "K10": "no PyTorch call runs H.264 motion compensation and inter "
           "reconstruction",
    "K9-t8": "no PyTorch call runs H.264 motion refinement, compensation "
             "and inter coding with the 8x8 transform's choice",
    "K10-t8": "no PyTorch call runs H.264 motion compensation and the 8x8 "
              "inverse transform's reconstruction",
    "K11": "timed: replicate F.pad + float32 conv2d with the 6-tap "
           "filters, rounded, clamped and narrowed to uint8",
    "K12": "no single PyTorch call: the winners' mode and the rate "
           "relative to it sit between two argmins",
    "K1": "no single PyTorch call: torch.cdist(p=1) would first need the "
          "289 candidate patches of every MB unfolded, and that is the work",
    "K2": "no PyTorch call encodes CAVLC",
    "K3": "no PyTorch call concatenates variable-length bit strings",
    "K3-slices": "no PyTorch call concatenates variable-length bit "
                 "strings",
    "K4": "no PyTorch call runs the H.264 deblocking filter",
    "K5": "no PyTorch call runs H.264 intra prediction",
    "K5-i44": "no PyTorch call runs H.264 Intra_4x4 prediction",
    "K6": "no PyTorch call runs an H.264 intra encode",
    "K6-i44": "no PyTorch call runs an H.264 Intra_4x4 mode decision and "
              "encode",
    "K7": "no PyTorch call runs an H.264 intra encode",
    "K8": "no PyTorch call runs H.264 intra prediction",
    "K13": "no PyTorch call derives CAVLC nC, header slots or skip runs",
    "K14": "timed: float32 F.mse_loss(reduction='none') summed per "
           "stream; not exact (a float32 sum rounds)",
    "K15": "no PyTorch call evaluates this field in one op",
    "P1": "no PyTorch call counts leading zeros",
    "P2": "timed: torch.sum(dim=0, dtype=torch.int32), the same sum mod "
          "2^32",
}
# K15's instruction issue a sample (luma, chroma; a chroma sample of U or
# V), counted in the SASS of csrc/source.cu (sm_90a, nvcc 12.8): sinf's
# fast path 24 instructions (range reduction, its |x| test, polynomial,
# quadrant), the rigid luma sample 13 more (table reads, six float ops,
# clamp, conversion, packing), a hash 6 (multiply-adds, shifts, xors) and
# its packing 2: the least the kernel issues for a frame, beside the bytes
# it writes
K15_SINF = 24
K15_INSTR = {"rigid": (K15_SINF + 13, 5), "noise": (8, 8),
             "moving_gradient": (3, 2)}
ISSUE_LANES = 132 * 4 * 32  # H100 SXM: SMs x schedulers x lanes a cycle


def k15_issue_ms(kind, w, h, k, s, mhz) -> float:
    """Least ms K15 takes to issue its sample loops' instructions
    (K15_INSTR) for k frames of S streams of w x h at an SM clock of
    `mhz`, every lane of every scheduler busy."""
    luma, chroma = K15_INSTR[kind]
    n = k * s * h * w
    return (luma * n + chroma * n // 2) / (ISSUE_LANES * mhz * 1e3)


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
    lib = ("none" if r["library_ms"] is None
           else f"{r['library_ms']:.4f} ms") + f" ({NO_LIBRARY[r['key']]})"
    print(f"phase 2: {r['name']}: equal to plain (max_abs_err "
          f"{r['max_abs_err']}); kernel {r['ms']:.4f} ms, plain "
          f"{r['plain_ms']:.3f} ms, bound {r['bound_ms']:.4f} ms "
          f"({r['bound_by']}): {100 * r['bound_ms'] / r['ms']:.1f}% of the "
          f"bound, {where}; library call: {lib}")


def k1_bytes(s, h, w) -> int:
    """The even source samples (int32), the window of the uint8 G plane
    that the +-R candidates reach ((h + 2R - 1) x (w + 2R - 1) samples,
    not the whole padded plane) and the int32 table."""
    from tpuh264_torch.golden.inter import SEARCH_RANGE as R

    return s * (4 * (h // 2) * (w // 2) + (h + 2 * R - 1) * (w + 2 * R - 1)
                + 4 * (h // 16) * (w // 16) * (2 * R + 1) ** 2)


def k1_plane(torch, ref):
    """The G plane K1 reads for uint8 (or 0..255 int32) reference frames
    ref [S, H, W]: the first plane of `_references` (K11 for a card
    tensor), in its layout: uint8, rows 16-byte aligned."""
    from tpuh264_torch.kernels import pframe

    s, h, w = ref.shape
    c = torch.zeros((s, h // 2, w // 2), dtype=torch.uint8,
                    device=ref.device)
    return pframe._references([ref.to(torch.uint8)], [c], [c],
                              False)[0][0][0]


def k4_bytes(args, kw) -> int:
    """D1: the int32 planes and side information the call passes (kind,
    mvx, mvy, nnz, refidx and t8 where given) in, the uint8 planes out."""
    planes = sum(p.numel() for p in args[:3])
    side = sum(x.numel() for x in (*args[3:7], *kw.values())
               if x is not None)
    return 4 * planes + planes + 4 * side


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


def k13_bytes(sym) -> int:
    """K13, what this run's data needs: per MB its eight int32 fields in,
    the int16 levels of the blocks its masks count (32 B a luma block,
    the MB's 240 B of chroma AC where the coded cbp_chroma is 2), and 27
    chunk ints and 12 slot ints out; 8 B a row (the trailing run)."""
    import torch

    kind, cbp_l = sym.kind.long(), sym.cbp_luma.long()
    cbp_c = torch.where(kind != 0, sym.cbp_chroma.long(), 0)
    pop = sum((cbp_l >> g) & 1 for g in range(4))
    luma = torch.where(kind == 2, (cbp_l == 1).long() * 16,
                       torch.where(kind == 1, 4 * pop, 0))
    mbs = kind.numel()
    return (4 * mbs * (8 + 27 + 12) + 32 * int(luma.sum())
            + 240 * int((cbp_c == 2).sum()) + 8 * (mbs // kind.shape[-1]))


def k2s_bytes(meta, nh, n_w) -> int:
    """K2's symbols entry: each chunk's int in, the header slots of the
    MBs whose chunk 0 is present, the levels of the present chunks that
    code a residual (32 B luma DC and AC, 8 B chroma DC, 30 B chroma AC),
    and n_w words and a bit length out a chunk."""
    import torch

    present = (meta >> 14) & 1
    code = present & ((meta >> 13) & 1)
    per = torch.tensor([32] * 17 + [8] * 2 + [30] * 8, device=meta.device)
    return (4 * meta.numel() * (1 + n_w + 1)
            + 8 * nh * int(present[:, 0].sum()) + int((code * per).sum()))


def k3s_bytes(hdr_len, mb_bits, mb_w, n_out, tail) -> int:
    """K3's slice entry: the header's and MBs' bit lengths and the words
    they use (<= mb_w an MB), the tail (8 B a slice, P), and n_out words
    and a byte count out a slice; int32."""
    lanes = hdr_len.numel()
    used = (int(((mb_bits.long() + 31) // 32).clamp(0, mb_w).sum())
            + int(((hdr_len.long() + 31) // 32).sum()))
    return (4 * (lanes + mb_bits.numel() + used + lanes * (n_out + 1))
            + (0 if tail is None else 8 * lanes))


def k23_rows(sym, torch, what):
    """K13, K2 and K3 against their plain versions on the P symbols `sym`
    (rows for the kernel table): K13 (the prologue), K2's symbols entry
    (the main path's; its block entry on the same chunks a line), K3 at
    the MB level (its slice entry a line, and its generic slice-level
    merge on the joined strings a line), then the stage fenced.  Returns
    ([K2, K3, K3's slice entry], K13) rows."""
    from tpuh264_torch.core.params import PPS, SPS
    from tpuh264_torch.core.sliceheader import SLICE_P
    from tpuh264_torch.entropy.device_pack import slice_headers_device
    from tpuh264_torch.kernels import cavlc_cuda, entropy_gpu

    dev = sym.kind.device
    s, r, c = sym.kind.shape
    hdr = slice_headers_device(SPS.for_size(16 * c, 16 * r), PPS(), 30, 1,
                               False, s, slice_type=SLICE_P, deblock_idc=2,
                               device=dev)
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    got = entropy_stage(sym, hdr, torch, 1, True, False)
    want = entropy_stage(sym, hdr, torch, 1, True, True)
    torch.cuda.synchronize()
    errs = []
    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.equal(g, w):
            fail(f"the slice stage's step {i} differs from its plain "
                 f"version ({what})")
        errs.append(max_abs_err(g, w))
    meta, hl, hv, tail, cw, cb, mw, mb = want[:8]
    used = float(((want[9].float() + 3) // 4).mean())  # a slice's words
    k13 = kernel_row(
        "K13", "cavlc_prologue (nC, header slots, chunk flags, trailing "
        "skip_run)", "tpuh264_torch/csrc/cavlc_prologue.cu",
        "tpuh264/kernels/entropy_tpu.py:627", max(errs[:4]),
        timed(lambda: entropy_gpu.cavlc_prologue(sym, ovf, 1), 20),
        timed(lambda: entropy_gpu._prologue_plain(sym, ovf, 1), 2),
        k13_bytes(sym))
    k2 = kernel_row(
        "K2", "pack_symbols (CAVLC block symbolise + pack, levels read "
        "from the symbols)", "tpuh264_torch/csrc/cavlc_pack.cu",
        "tpuh264/kernels/cavlc_pallas.py:114", max(errs[4:6]),
        timed(lambda: cavlc_cuda.pack_symbols(sym, meta, hl, hv, 20, ovf),
              20),
        timed(lambda: cavlc_cuda._pack_symbols_plain(sym, meta, hl, hv, 20,
                                                     ovf), 2),
        k2s_bytes(meta, 6, 20))
    del got, want
    mw4, mb4 = cw.reshape(s, r, c, 27, 20), cb.reshape(s, r, c, 27)
    k3 = kernel_row(
        "K3", "merge_tree / merge_slices (chunk -> MB and MB -> slice "
        "bit-string merge)", "tpuh264_torch/csrc/cavlc_merge.cu",
        "tpuh264/kernels/cavlc_pallas.py:486",
        k3_equal(mw4, mb4, 128, torch, f"MB level, {what}"),
        timed(lambda: cavlc_cuda.merge_tree(mw4, mb4, 128), 20),
        timed(lambda: cavlc_cuda.tree_merge(mw4, mb4, 128), 3),
        k3_bytes(mb4, 20, 128))
    del cw, cb, mw4, mb4
    n_out = entropy_gpu.SLICE_W
    k3s = kernel_row(
        "K3-slices", "merge_slices (K3's slice entry: header, MB strings, "
        "skip-run tail and rbsp trailer -> the slice's row)",
        "tpuh264_torch/csrc/cavlc_merge.cu",
        "tpuh264/kernels/cavlc_pallas.py:486", max(errs[8:]),
        timed(lambda: cavlc_cuda.merge_slices(*hdr, mw, mb, tail, n_out,
                                              ovf), 20),
        timed(lambda: cavlc_cuda._merge_slices_plain(
            *hdr, mw, mb, tail, n_out, ovf), 2),
        k3s_bytes(hdr[1], mb, 128, n_out, tail))
    print(f"phase 2: K3 slice entry (merge_slices), {what}: {s * r} slices "
          f"of {c} MBs -> {n_out} words ({used:.1f} used a slice): equal "
          f"to plain (max_abs_err {k3s['max_abs_err']}); kernel "
          f"{k3s['ms']:.4f} ms, plain {k3s['plain_ms']:.3f} ms, bound "
          f"{k3s['bound_ms']:.4f} ms (bytes): "
          f"{100 * k3s['bound_ms'] / k3s['ms']:.1f}% of the bound")
    del mw, mb

    # K2's block entry on the same chunks (the host-pack and session
    # tests' entry), and K3's generic slice level on the joined strings
    args, code_res, _, _ = entropy_gpu.pframe_pack_inputs(sym)
    kw, kb = cavlc_cuda.pack_blocks(*args, 20, 6, code_residual=code_res)
    pw, pb = cavlc_cuda._pack_blocks_plain(*args, 20, code_res)
    torch.cuda.synchronize()
    if not (torch.equal(kb, pb) and torch.equal(kw, pw)):
        fail("K2 pack_blocks differs from its plain version")
    ms = timed(lambda: cavlc_cuda.pack_blocks(*args, 20, 6,
                                              code_residual=code_res), 20)
    bound = bound_ms(k2_bytes(kb.numel(), 6, 20))
    print(f"phase 2: K2 block entry (pack_blocks), {what}: equal to plain "
          f"(max_abs_err {max(max_abs_err(kw, pw), max_abs_err(kb, pb))}); "
          f"kernel {ms:.4f} ms, bound {bound:.4f} ms (bytes): "
          f"{100 * bound / ms:.1f}% of the bound")
    del kw, kb, pw, pb, args
    parts = entropy_gpu.pframe_slice_parts(sym, *hdr)[:2]
    sw, sb, _ = entropy_gpu.slice_strings(*parts)
    del parts
    err = k3_equal(sw, sb, n_out, torch, f"slice level, {what}")
    ms = timed(lambda: cavlc_cuda.merge_tree(sw, sb, n_out), 20)
    plain = timed(lambda: cavlc_cuda.tree_merge(sw, sb, n_out), 2)
    bound = bound_ms(k3_bytes(sb, sw.shape[-1], n_out))
    print(f"phase 2: K3 generic slice level (merge_tree), {what}: "
          f"{list(sw.shape)} -> {n_out} words: equal to plain (max_abs_err "
          f"{err}); kernel {ms:.4f} ms, plain {plain:.3f} ms, bound "
          f"{bound:.4f} ms (bytes): {100 * bound / ms:.1f}% of the bound")
    del sw, sb
    enc = [round(fenced_ms(lambda: entropy_gpu.encode_bits_pframe(
        sym, 30, *hdr)), 3) for _ in range(3)]
    print(f"phase 2: encode_bits_pframe, {what}, one call fenced: {enc} ms")
    return [k2, k3, k3s], k13


def k3s_islices(sym_i, torch, card):
    """K3's slice entry on the I slices of the GOP start's I frame `sym_i`
    (no tail): the stage run by the kernels and by the plain versions,
    each step equal, and the entry timed beside its plain version."""
    from tpuh264_torch.core.params import PPS, SPS
    from tpuh264_torch.entropy.device_pack import slice_headers_device
    from tpuh264_torch.kernels import cavlc_cuda

    dev = sym_i.mode.device
    s, r, c = sym_i.mode.shape
    hdr = slice_headers_device(SPS.for_size(16 * c, 16 * r), PPS(), 30, 0,
                               True, s, deblock_idc=2, device=dev)
    got = entropy_stage(sym_i, hdr, torch, 1, False, False)
    want = entropy_stage(sym_i, hdr, torch, 1, False, True)
    torch.cuda.synchronize()
    for i, (g, w) in enumerate(zip(got, want)):
        if (g is None) != (w is None) or (g is not None
                                          and not torch.equal(g, w)):
            fail(f"the I slice stage's step {i} differs from its plain "
                 f"version")
    mw, mb, ovf = want[6], want[7], torch.zeros_like(want[10])
    ms = timed(lambda: cavlc_cuda.merge_slices(*hdr, mw, mb, None, 8192,
                                               ovf), 20)
    plain = timed(lambda: cavlc_cuda._merge_slices_plain(
        *hdr, mw, mb, None, 8192, ovf), 2)
    bound = bound_ms(k3s_bytes(hdr[1], mb, 128, 8192, None))
    used = float(((want[9].float() + 3) // 4).mean())
    err = max_abs_err(got[8], want[8])
    print(f"phase 2: K3 slice entry (merge_slices), 1080p x 4 GOP start's I "
          f"slices: {s * r} slices of {c} MBs -> 8192 words ({used:.1f} "
          f"used a slice): equal to plain (max_abs_err {err}); kernel "
          f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms "
          f"(bytes): {100 * bound / ms:.1f}% of the bound [{card}]")


def k3s_layout(card) -> None:
    """ptxas's registers and shared memory of K3's source, and its slice
    entry's resident blocks an SM and waves for a 1080p x 4 P dispatch's
    1,088 slices."""
    from tpuh264_torch.kernels import cavlc_cuda

    src = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "tpuh264_torch", "csrc", "cavlc_merge.cu")
    for ln in ptxas_lines(src):
        print(f"phase 2: cavlc_merge.cu ptxas: {ln}")
    n, threads = cavlc_cuda.merge_slices_resident()
    if threads != K3S_THREADS:
        fail(f"K3 slice entry: {threads} threads a block, not "
             f"{K3S_THREADS}")
    print(f"phase 2: K3 slice entry: {n} blocks of {threads} threads an "
          f"SM, {1088 / (132 * n):.2f} waves for 1,088 slices [{card}]")


def k14_library(dec, src):
    """The nearest PyTorch call: F.mse_loss(reduction="none") in float32,
    summed per stream (not exact: a float32 sum rounds)."""
    import torch

    d = torch.stack(list(dec)).float()
    return torch.nn.functional.mse_loss(
        d, src.float(), reduction="none").sum((-1, -2))


K14_CASES = [((4, 4, 1088, 1920), 1, True), ((4, 8, 48, 64), 2, True),
             ((3, 2, 32, 48), 1, False), ((1, 1, 16, 16), 1, True),
             ((4, 8, 480, 864), 8, True), ((2, 6, 64, 80), 3, False)]


def k14_case(np, shape, fanout, with_src, seed=0):
    """Seeded K14 inputs (numpy uint8): k decoded planes [k, S, H, W] and
    the source [k, S / fanout, H, W] (None: measured against zeros),
    the decoded planes near the source (a codec's error) with saturated
    0 / 255 patches."""
    k, s, h, w = shape
    rng = np.random.default_rng([seed, k, s, h, w, fanout])
    src = rng.integers(0, 256, (k, s // fanout, h, w)).astype(np.uint8)
    dec = np.repeat(src, fanout, 1).astype(np.int64)
    dec += rng.integers(-9, 10, dec.shape)
    dec[..., :4, :4] = 255
    dec[..., -4:, -4:] = 0
    return (np.clip(dec, 0, 255).astype(np.uint8), src if with_src else None)


def k14_rows(dev, torch, np, card):
    """K14 against its plain version: its row at the main path's shapes
    (an interior 1080p x 4 dispatch's four decoded frames against their
    sources), then every K14_CASES case (fan-out, no source)."""
    from tpuh264_torch.kernels import sse

    row = None
    for case in K14_CASES:
        d, src = k14_case(np, *case)
        dec = [t for t in torch.from_numpy(d).to(dev)]
        src_t = None if src is None else torch.from_numpy(src).to(dev)
        got = sse.sse(dec, src_t, case[1])
        want = sse._sse_plain(dec, src_t, case[1])
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"K14 sse differs from its plain version on case {case}")
        if row is None:
            nbytes = d.nbytes + (0 if src is None else src.nbytes) + got.numel() * 8
            lib = timed(lambda: k14_library(dec, src_t), 20)
            row = dict(kernel_row(
                "K14", "sse (the decoder's per-frame, per-stream SSE, exact "
                "int64)", "tpuh264_torch/csrc/sse.cu",
                "tpuh264/engine/devpipe.py:692", max_abs_err(got, want),
                timed(lambda: sse.sse(dec, src_t, case[1]), 50),
                timed(lambda: sse._sse_plain(dec, src_t, case[1]), 3),
                nbytes), library_ms=lib)
            print(f"phase 2: K14 library call F.mse_loss(float32, "
                  f"reduction='none').sum per stream {lib:.4f} ms (not "
                  f"exact) [{card}]")
        del dec, src_t, got, want
    print(f"phase 2: K14 equal to its plain version on {len(K14_CASES)} "
          f"seeded cases (1080p x 4, fan-out 2 / 3 / 8, no source, one MB)")
    return row


def k1_edges(dev, torch, np):
    """K1 on seeded edge cases: samples only 0 and 255, the maximum SAD
    (16,320 everywhere), ragged tiles (864 and 80 wide), S = 1 and 4,
    from the uint8 G plane K11 writes (`k1_plane`)."""
    from tpuh264_torch.kernels import me_cuda

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
        g = k1_plane(torch, torch.from_numpy(ref).to(dev))
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


# K13 (the CAVLC prologue), K2's symbols entry and K3's slice entry, on
# seeded symbols: (lead, R, C) shapes -- one MB, one column, a row of 121
# MBs (four 32-column passes and one more), a row of 33 -- x MB mixes:
# "mixed" (skip / inter / intra), "skip" (all-skip rows), "intra"
# (all-intra rows), "last" (a row's only coded MB its last), "border"
# (inter and intra MBs alternating, so nC meets both rules across every
# MB border), "inter"; P slices with nra 1, 2 and 3, and I slices.
K13_SHAPES = ((1, 1, 1), (2, 3, 1), (1, 2, 121), (3, 2, 5), (2, 1, 33))
K13_MIX = ("mixed", "skip", "intra", "last", "border", "inter")
K13_CASES = ([(shape, mix, 1 + (i + j) % 3, True)
              for i, shape in enumerate(K13_SHAPES)
              for j, mix in enumerate(K13_MIX)]
             + [(shape, "intra", 1, False) for shape in K13_SHAPES])


def k13_case(np, shape, mix, nra, pslice, seed=0):
    """Seeded symbols of a K13 case as numpy arrays (MBSymbolsP's fields,
    or MBSymbols' for an I slice): levels sparse, a few up to escape size;
    cbps at random (the stage reads them as coded, whatever the levels);
    mvds +-64; refidx below nra."""
    lead, r, c = shape
    mb = (lead, r, c)
    rng = np.random.default_rng(1000 + seed + 7 * c + 31 * r + 101 * lead
                                + 13 * K13_MIX.index(mix) + 3 * nra)

    def lv(*sh):
        x = rng.integers(-3, 4, (*mb, *sh))
        x[rng.random(x.shape) < 0.7] = 0
        big = rng.random(x.shape) < 0.01
        x[big] = rng.integers(-2000, 2001, int(big.sum()))
        return x.astype(np.int16)

    kind = {"mixed": rng.choice(3, mb, p=[0.5, 0.35, 0.15]),
            "skip": np.zeros(mb, np.int64), "intra": np.full(mb, 2),
            "last": np.zeros(mb, np.int64),
            "border": 1 + (np.arange(c) + np.arange(r)[:, None]) % 2
            + np.zeros(mb, np.int64),
            "inter": np.ones(mb, np.int64)}[mix]
    if mix == "last":
        kind[..., -1] = rng.choice([1, 2], (lead, r))
    if mix == "mixed" and r > 1:
        kind[0, 0] = 0  # an all-skip row
    intra = kind == 2
    f = dict(
        mode=rng.integers(0, 4, mb), cmode=rng.integers(0, 4, mb),
        cbp_luma=np.where(intra, rng.integers(0, 2, mb),
                          rng.integers(0, 16, mb)),
        cbp_chroma=rng.integers(0, 3, mb), luma_dc=lv(16),
        luma_ac=lv(16, 16), chroma_dc=lv(2, 4), chroma_ac=lv(2, 4, 15))
    if pslice:
        f.update(kind=kind, mvdx=rng.integers(-64, 65, mb),
                 mvdy=rng.integers(-64, 65, mb),
                 refidx=np.where(kind == 1, rng.integers(0, nra, mb), 0),
                 t8=np.zeros(mb, np.int64))
    else:
        f["cbp_luma"] = rng.integers(0, 2, mb)
    return {k: v if v.dtype == np.int16 else v.astype(np.int32)
            for k, v in f.items()}


def k13_symbols(torch, case, dev):
    """A `k13_case` as the port's MBSymbolsP (P) or MBSymbols (I) on
    `dev`."""
    from tpuh264_torch.kernels import iframe, pframe

    t = {k: torch.from_numpy(v).to(dev) for k, v in case.items()}
    if "kind" in t:
        return pframe.MBSymbolsP(**t)
    return iframe.MBSymbols(**t)


def k13_headers(torch, np, lead, r, dev, seed=0):
    """Slice headers as K3's slice entry reads them: [lead, R, 4] int32
    MSB-first words, zero past their bit lengths [lead, R] (20-120)."""
    rng = np.random.default_rng(77 + seed)
    bits = rng.integers(20, 121, (lead, r))
    words = rng.integers(0, 1 << 32, (lead, r, 4), dtype=np.uint64)
    pos = np.arange(128).reshape(4, 32)
    keep = pos[None, None] < bits[..., None, None]
    mask = (keep * (np.uint64(1) << (31 - np.arange(32)).astype(np.uint64))
            ).sum(-1).astype(np.uint64)
    words = (words & mask).astype(np.uint32).view(np.int32)
    return (torch.from_numpy(words).to(dev),
            torch.from_numpy(bits.astype(np.int32)).to(dev))


def entropy_stage(sym, hdr, torch, nra, pslice, plain):
    """The slice stage's four steps on `sym` and headers `hdr`, each by
    its kernel (plain False: the routers, CUDA tensors) or its plain
    version: [chunk ints, slots (len, val), tail, chunk words, bits, MB
    words, bits, slice words, bytes, overflow flag]."""
    from tpuh264_torch.kernels import cavlc_cuda, entropy_gpu

    dev = hdr[1].device
    ovf = torch.zeros(1, dtype=torch.int32, device=dev)
    lead = tuple(sym.mode.shape)
    if plain:
        meta, hl, hv, tail = entropy_gpu._prologue_plain(sym, ovf, nra,
                                                         pslice)
        if tail is not None:
            tail = tail.reshape(*lead[:-1], 2)
        w, b = cavlc_cuda._pack_symbols_plain(sym, meta, hl, hv, 20, ovf)
        mw, mb = cavlc_cuda.tree_merge(w.reshape(*lead, 27, 20),
                                       b.reshape(*lead, 27), 128)
        sw, sb = cavlc_cuda._merge_slices_plain(*hdr, mw, mb, tail, 8192,
                                                ovf)
    else:
        meta, hl, hv, tail = entropy_gpu.cavlc_prologue(sym, ovf, nra, pslice)
        w, b = cavlc_cuda.pack_symbols(sym, meta, hl, hv, 20, ovf)
        mw, mb = cavlc_cuda.merge_tree(w.reshape(*lead, 27, 20),
                                       b.reshape(*lead, 27), 128)
        sw, sb = cavlc_cuda.merge_slices(*hdr, mw, mb, tail, 8192, ovf)
    return [meta, hl, hv, tail, w, b, mw, mb, sw, sb, ovf]


def k13_edges(dev, torch, np):
    """K13, K2's symbols entry and K3's slice entry on every K13_CASES
    case: the stage run by the kernels and by the plain versions, each
    step's output equal, int for int (so each kernel met its plain
    version's inputs)."""
    n_ovf = 0
    for case in K13_CASES:
        shape, mix, nra, pslice = case
        cpu = k13_symbols(torch, k13_case(np, *case), "cpu")
        gpu = k13_symbols(torch, k13_case(np, *case), dev)
        hdr = k13_headers(torch, np, shape[0], shape[1], "cpu")
        want = entropy_stage(cpu, hdr, torch, nra, pslice, True)
        got = entropy_stage(gpu, tuple(x.to(dev) for x in hdr), torch, nra,
                            pslice, False)
        for i, (g, w) in enumerate(zip(got, want)):
            if (g is None) != (w is None) or (
                    g is not None and not torch.equal(g.cpu(), w)):
                fail(f"K13 / K2 / K3 slice stage step {i} differs from its "
                     f"plain version on case {case}")
        n_ovf += int(want[-1])
    print(f"phase 2: K13, K2's symbols entry and K3's slice entry equal to "
          f"their plain versions on {len(K13_CASES)} seeded cases (one MB, "
          f"one column, rows of 121 and 33; mixed, all-skip, all-intra, "
          f"last-MB-only, inter/intra borders, all-inter; nra 1-3; I "
          f"slices); {n_ovf} raise the overflow flag")


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


# K3's slice entry on seeded edge cases (`k3s_case`): bodies that end
# exactly on a word boundary (and bodies whose trailer does), slices of
# empty MB strings (P and I), many MB strings shorter than 32 bits inside
# one word (rows of 8191 words, so no row starts on a 16-byte boundary),
# bodies at the overflow limit 32 * 8192 - 64 bits, and one bit past it,
# past the row and with an MB past its words (the flag raised), and 1,024
# strings a slice.
K3S_CASES = ("aligned", "empty", "empty-i", "short", "limit", "overflow",
             "k1024")
K3S_THREADS = 256  # cavlc_merge.cu kBlockThreads: a slice's block


def k3s_case(np, name, seed=0):
    """Seeded inputs of K3's slice entry for the K3S_CASES case `name`, as
    numpy arrays: (hdr_hw [L, 4], hdr_len [L], mb_hw [L, C, 128], mb_bits
    [L, C], tail [L, 2] (word, bits) or None, n_out).  Every string is
    MSB-first and zero past its bit length."""
    rng = np.random.default_rng(4100 + 17 * K3S_CASES.index(name) + seed)
    lanes, c, n_out = {"aligned": (32, 20, 8192), "empty": (8, 120, 8192),
                       "empty-i": (8, 120, 8192), "short": (16, 120, 8191),
                       "limit": (2, 120, 8192), "overflow": (3, 120, 8192),
                       "k1024": (2, 1021, 8192)}[name]
    hdr = rng.integers(20, 121, lanes)
    tail = None if name == "empty-i" else rng.integers(1, 32, lanes)
    t_bits = 0 if tail is None else tail
    if name in ("aligned", "k1024"):
        mb = rng.integers(0, 200 if name == "aligned" else 300, (lanes, c))
        mb[rng.random(mb.shape) < 0.2] = 0
    elif name.startswith("empty"):
        mb = np.zeros((lanes, c), np.int64)
    elif name == "short":
        mb = rng.integers(1, 8, (lanes, c))
        mb[rng.random(mb.shape) < 0.3] = 0
    else:  # the bodies' totals set below
        mb = np.zeros((lanes, c), np.int64)
    if name == "aligned":  # even lanes: the body ends on a word boundary;
        # odd lanes: its 8-bit trailer does
        body = hdr + mb.sum(-1) + t_bits
        mb[:, -1] += (np.where(np.arange(lanes) % 2, 24, 0) - body) % 32
    if name in ("limit", "overflow"):
        limit = 32 * n_out - 64
        want = (np.full(lanes, limit) if name == "limit"
                else np.array([limit + 1, 32 * n_out + 8000, 9000]))
        rest = want - hdr - t_bits
        mb += rest[:, None] // c
        mb[:, :1] += rest[:, None] % c
        h = (c - 1) // 2
        jitter = rng.integers(-100, 101, (lanes, h))
        mb[:, 1:1 + h] += jitter
        mb[:, 1 + h:1 + 2 * h] -= jitter
        if name == "overflow":
            mb[2] = 0
            mb[2, 5] = 32 * 128 + 4  # an MB past its 128 words
            mb[2, 6:] = rng.integers(0, 200, c - 6)

    def strings(bits, w):
        keep = np.clip(bits[..., None] - 32 * np.arange(w), 0, 32)
        raw = rng.integers(0, 1 << 32, keep.shape, dtype=np.uint64)
        low = (np.uint64(1) << (32 - keep).astype(np.uint64)) - np.uint64(1)
        return (raw & (np.uint64(0xFFFFFFFF) ^ low)).astype(
            np.uint32).view(np.int32)

    i32 = lambda x: np.asarray(x, np.int32)
    tail_w = None
    if tail is not None:
        tail_w = np.stack([strings(tail, 1)[:, 0], i32(tail)], -1)
    return (strings(hdr, 4), i32(hdr), strings(np.minimum(mb, 32 * 128), 128),
            i32(mb), tail_w, n_out)


# (S, H, W): C = 1; odd S, R, C; a long lane of an even C = 16
D1_SHAPES = ((1, 16, 16), (3, 80, 112), (2, 32, 16), (2, 48, 256))
D1_VARIANTS = ("inter", "t8", "intra")
D1_QPS = (0, 15, 16, 29, 30, 39, 51)
D1_CASES = [(shape, variant, qp) for shape in D1_SHAPES
            for variant in D1_VARIANTS for qp in D1_QPS]


def d1_case(np, shape, variant, qp):
    """Seeded deblock inputs (numpy): y, u, v int32, kind, mvx, mvy, nnz,
    refidx, t8 (the last two None where the variant has none).  Shapes: C =
    1, odd S, R and C, and an even C of 16.  Samples: MB row lane % 4 picks
    a smooth random walk of 4x4-block levels (most edges filter), near
    black or near white (p0 +- delta clips at 0 / 255), or uniform noise.
    "inter": skip / inter / intra MBs, MVs a walk of steps 0, +-3, +-4, +-5
    quarter pels along each row, refidx 0..3; "t8" adds a random t8;
    "intra": every MB intra (deblock_i's shape: no refidx, no t8)."""
    s, h, w = shape
    r, c = h // 16, w // 16
    rng = np.random.default_rng([s, h, w, D1_VARIANTS.index(variant), qp])

    def plane(sh, blk):
        lv = 128 + np.cumsum(rng.integers(-9, 10, (sh[0], sh[1] // blk,
                                                   sh[2] // blk)), -1)
        lv = np.repeat(np.repeat(lv, blk, 1), blk, 2)
        p = lv + rng.integers(-2, 3, sh)
        lane = np.arange(sh[0] * r).reshape(sh[0], r, 1, 1) % 4
        lane = np.repeat(lane, sh[1] // r, 1).reshape(sh[0], sh[1], 1)
        p = np.where(lane == 1, p % 9, p)
        p = np.where(lane == 2, 255 - p % 9, p)
        p = np.where(lane == 3, rng.integers(0, 256, sh), p)
        return np.clip(p, 0, 255).astype(np.int32)

    y = plane((s, h, w), 4)
    u, v = plane((s, h // 2, w // 2), 2), plane((s, h // 2, w // 2), 2)
    mb = (s, r, c)
    if variant == "intra":
        kind = np.full(mb, 2, np.int32)
        mvx = mvy = np.zeros(mb, np.int32)
    else:
        kind = rng.choice(np.array([0, 1, 2], np.int32), mb,
                          p=[0.3, 0.5, 0.2])
        steps = np.array([0, 3, -3, 4, -4, 5, -5])
        mvx, mvy = (rng.integers(-64, 65, (s, r, 1)) + np.cumsum(
            rng.choice(steps, mb), -1) for _ in range(2))
        mvx, mvy = mvx.astype(np.int32), mvy.astype(np.int32)
    nnz = rng.integers(0, 17, (*mb, 4, 4))
    nnz[rng.random((*mb, 4, 4)) < 0.6] = 0
    ref = None if variant == "intra" else \
        rng.integers(0, 4, mb).astype(np.int32)
    t8 = rng.integers(0, 2, mb).astype(np.int32) if variant == "t8" else None
    return y, u, v, kind, mvx, mvy, nnz.astype(np.int32), ref, t8


# K4's ring entry takes the per-MB fields as the GOP decode's record views
# ("records") or as separate tensors ("contiguous")
D1_RING_LAYOUTS = ("records", "contiguous")


def d1_levels(np, rng, nnz):
    """luma_ac levels [S, R, C, 16, 16] int16 whose 4x4 block 4 by + bx
    holds nnz[..., by, bx] nonzero levels (+-1 .. +-59 at random
    positions); of every 7 MBs one (0, 7, ...) is not coded at all and
    one (3, 10, ...) is coded in one 4x4 block alone: one level of block
    (MB index % 16)."""
    mb = nnz.shape[:3]
    rank = rng.random((*mb, 16, 16)).argsort(-1).argsort(-1)
    vals = (rng.integers(1, 60, (*mb, 16, 16))
            * rng.choice(np.array([-1, 1]), (*mb, 16, 16)))
    lev = np.where(rank < nnz.reshape(*mb, 16, 1), vals, 0).astype(np.int16)
    flat = lev.reshape(-1, 16, 16)
    flat[np.arange(len(flat)) % 7 == 0] = 0
    ids = np.flatnonzero(np.arange(len(flat)) % 7 == 3)
    flat[ids] = 0
    flat[ids, ids % 16, (5 * ids) % 16] = 9
    return lev


def d1_ring_case(np, case, layout):
    """`d1_case`'s inputs as K4's ring entry takes them (numpy): (y, u, v,
    fields, levels, names).  "records": kind, mvx, mvy, refidx and t8 in
    columns 0, 5, 6, 7 and 8 of one [S, R, C, 9] int32 record, the levels
    of `d1_levels` in slots 16:272 of one [S, R, C, 400] int16 record whose
    other slots (the luma DC first) are nonzero noise, as the GOP decode
    holds them; "contiguous": the fields [5, S, R, C] and the levels [S, R,
    C, 16, 16] apart.  names: the fields the variant has (no refidx for
    "intra", t8 only for "t8")."""
    y, u, v, kind, mvx, mvy, nnz, ref, t8 = d1_case(np, *case)
    rng = np.random.default_rng([7, *case[0], case[2]])
    lev = d1_levels(np, rng, nnz)
    zero = np.zeros_like(kind)
    names = ("kind", "mvx", "mvy") + ("refidx",) * (ref is not None) + (
        "t8",) * (t8 is not None)
    cols = [kind, mvx, mvy, zero if ref is None else ref,
            zero if t8 is None else t8]
    if layout == "contiguous":
        return y, u, v, np.stack(cols), lev, names
    rec = rng.integers(-9, 10, (*kind.shape, 9)).astype(np.int32)
    for c, x in zip((0, 5, 6, 7, 8), cols):
        rec[..., c] = x
    slots = rng.integers(-9, 10, (*kind.shape, 400)).astype(np.int16)
    slots[..., 16:272] = lev.reshape(*kind.shape, 256)
    return y, u, v, rec, slots, names


def d1_ring_args(torch, np, case, layout, u8, dev):
    """`deblock_ring`'s arguments (args, keyword args) for `d1_ring_case`
    on `dev`: the planes uint8 (`u8`; int32 otherwise, which the router
    narrows first), the fields and levels as views of the layout's
    buffers there; the "intra" variant as
    `deblock_i` passes it (kind None: every MB intra)."""
    y, u, v, fields, levels, names = d1_ring_case(np, case, layout)
    planes = [torch.from_numpy(p.astype(np.uint8 if u8 else np.int32))
              .to(dev) for p in (y, u, v)]
    qp = case[2]
    if case[1] == "intra":
        return (*planes, None, None, None, None, qp), {}
    f, lv = torch.from_numpy(fields).to(dev), torch.from_numpy(levels).to(dev)
    if layout == "records":
        mb = f.shape[:-1]
        col = dict(zip(("kind", "mvx", "mvy", "refidx", "t8"), (0, 5, 6, 7,
                                                               8)))
        get = lambda n: f[..., col[n]]
        lac = lv[..., 16:272].reshape(*mb, 16, 16)
    else:
        get = lambda n: f[("kind", "mvx", "mvy", "refidx", "t8").index(n)]
        lac = lv
    kw = {n: get(n) for n in ("refidx", "t8") if n in names}
    return (*planes, get("kind"), get("mvx"), get("mvy"), lac, qp), kw


def d1_ring_plain(args, kw):
    """The plain deblock the ring entry must equal on (args, kw):
    `_deblock_rows_plain` on `deblock_nnz`'s grid of the levels (the 8x8
    rule where t8 is given), or deblock_i's plain version for an
    all-intra call (kind None)."""
    import types

    from tpuh264_torch.kernels import deblock

    y, u, v, kind, mvx, mvy, lac, qp = args
    if kind is None:
        return deblock._deblock_ring_plain(*args, **kw)
    t8 = kw.get("t8")
    nnz = deblock.deblock_nnz(types.SimpleNamespace(luma_ac=lac, t8=t8),
                              t8 is not None)
    return deblock._deblock_rows_plain(y, u, v, kind, mvx, mvy, nnz, qp,
                                       kw.get("refidx"), t8)


# K15 (the device source): (W, H, k, S, t) -- one MB; an odd MB count (3
# x 2: chroma rows of 24 bytes, not 16-byte aligned); S = 1; k = 1 and
# 4; two tiles across; t = 0 and times whose arguments take CUDA's slow
# path of sinf / cosf (|x| past 105,615: t = 400,000 and 2,000,000)
K15_EDGES = ((16, 16, 1, 1, 0), (48, 32, 4, 3, 0), (64, 48, 4, 1, 400_000),
             (144, 80, 1, 2, 123), (80, 48, 4, 2, 2_000_000))
K15_MAIN = (1920, 1088, 4, 4, 100)  # the main path's: 1080p x 4, k = 4


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


def k3s_edges(dev, torch, np):
    """K3's slice entry on every K3S_CASES case: words, bytes and the
    overflow flag equal to its plain version's."""
    from tpuh264_torch.kernels import cavlc_cuda

    flags = []
    for name in K3S_CASES:
        *parts, n_out = k3s_case(np, name)
        parts = [None if x is None else torch.from_numpy(x) for x in parts]
        want_ovf = torch.zeros(1, dtype=torch.int32)
        want = cavlc_cuda._merge_slices_plain(*parts, n_out, want_ovf)
        ovf = torch.zeros(1, dtype=torch.int32, device=dev)
        got = cavlc_cuda.merge_slices(
            *[None if x is None else x.to(dev) for x in parts], n_out, ovf)
        for what, g, w in zip(("words", "bytes", "overflow flag"),
                              (*got, ovf), (*want, want_ovf)):
            if not torch.equal(g.cpu(), w):
                fail(f"K3's slice entry: {what} differ from its plain "
                     f"version on edge case {name!r}")
        flags.append(int(want_ovf))
    print(f"phase 2: K3's slice entry equal to plain on {len(K3S_CASES)} "
          f"edge cases {K3S_CASES} (bodies ending on word boundaries, empty "
          f"and sub-word MB strings, the overflow limit and past it, 1,024 "
          f"strings; overflow flags {flags})")


def d1_args(torch, rec, qp, sym=None, motion=None, t8=False):
    """deblock_frame_rows's arguments as deblock_i (no symbols) or
    deblock_p build them, the planes as int32: (args, keyword args)."""
    from tpuh264_torch.kernels import deblock

    planes = [p.to(torch.int32).contiguous() for p in rec]
    s, h, w = planes[0].shape
    sh = (s, h // 16, w // 16)
    if sym is None:
        z = torch.zeros(sh, dtype=torch.int32, device=planes[0].device)
        nnz = torch.zeros((*sh, 4, 4), dtype=torch.int32, device=z.device)
        return (*planes, torch.full_like(z, 2), z, z, nnz, qp), {}
    return ((*planes, sym.kind, motion[0], motion[1],
             deblock.deblock_nnz(sym, t8), qp),
            dict(refidx=sym.refidx, t8=sym.t8 if t8 else None))


def d1_equal(args, kw, torch, what) -> int:
    """D1 against its plain version on one input; fails unless equal."""
    from tpuh264_torch.kernels import deblock

    k = deblock.deblock_frame_rows(*args, **kw)
    p = deblock._deblock_rows_plain(*args, **kw)
    torch.cuda.synchronize()
    if not all(a.dtype == torch.uint8 and torch.equal(a, b)
               for a, b in zip(k, p)):
        fail(f"D1 deblock_frame_rows differs from its plain version ({what})")
    return max(max_abs_err(a, b) for a, b in zip(k, p))


def d1_row(args, kw, torch, what, mhz):
    """D1 equal to its plain version on (args, kw), timed beside it: the
    row of the kernel table, with the kernel's cycles a MB column at an
    SM clock of `mhz` (what bounds it: one lane's chain of C columns)."""
    from tpuh264_torch.kernels import deblock

    r = kernel_row(
        "K4", "deblock_frame_rows (D1, in-loop deblocking filter)",
        "tpuh264_torch/csrc/deblock.cu", "tpuh264/kernels/deblock.py:130",
        d1_equal(args, kw, torch, what),
        timed(lambda: deblock.deblock_frame_rows(*args, **kw), 20),
        timed(lambda: deblock._deblock_rows_plain(*args, **kw), 1),
        k4_bytes(args, kw))
    r["cycles_col"] = d1_cycles(r["ms"], mhz, args[0].shape[-1] // 16)
    return r


def d1_cycles(ms: float, mhz: int, c: int) -> float:
    """SM cycles a MB column of a D1 call of `ms` over `c` columns."""
    return ms * mhz * 1e3 / c


def ring_call_args(rec, qp, sym=None, motion=None, t8=False):
    """`deblock_ring`'s arguments as deblock_i (no symbols: kind None) or
    deblock_p passes them: (args, keyword args)."""
    if sym is None:
        return (*rec, None, None, None, None, qp), {}
    return ((*rec, sym.kind, motion[0], motion[1], sym.luma_ac, qp),
            dict(refidx=sym.refidx, t8=sym.t8 if t8 else None))


def k4_ring_equal(args, kw, torch, what) -> int:
    """K4's ring entry writing slot 1 of a two-slot ring against
    `d1_ring_plain` (`_deblock_rows_plain` on `deblock_nnz`'s grid); fails
    unless equal and slot 0 untouched."""
    from tpuh264_torch.kernels import deblock

    ring = [torch.zeros((2, *p.shape), dtype=torch.uint8, device=p.device)
            for p in args[:3]]
    got = deblock.deblock_ring(*args, out=tuple(r[1] for r in ring), **kw)
    want = d1_ring_plain(args, kw)
    torch.cuda.synchronize()
    if (not all(torch.equal(a, b) for a, b in zip(got, want))
            or any(bool(r[0].any()) for r in ring)):
        fail(f"K4's ring entry differs from the plain deblock ({what})")
    return max(max_abs_err(a, b) for a, b in zip(got, want))


def k4_ring_bytes(args, kw) -> int:
    """K4's ring entry: the planes in as they are (uint8 a byte a sample),
    the uint8 planes out, the per-MB fields it reads (kind, mvx, mvy and
    refidx / t8 where given, 4 bytes each) and the inter MBs' levels (512
    bytes each: an intra MB's bS needs none); the planes alone for an
    all-intra call."""
    n = sum(p.numel() for p in args[:3])
    nbytes = n * args[0].element_size() + n
    kind = args[3]
    if kind is None:
        return nbytes
    fields = 3 + sum(kw.get(f) is not None for f in ("refidx", "t8"))
    return (nbytes + 4 * fields * kind.numel()
            + 512 * int((kind != 2).sum()))


def k4_ring_row(args, kw, torch, what, mhz):
    """K4's ring entry equal to the plain deblock on (args, kw), timed
    into a preallocated slot beside the plain version: the kernel table's
    K4 row, with its cycles a MB column."""
    from tpuh264_torch.kernels import deblock

    out = [torch.empty(p.shape, dtype=torch.uint8, device=p.device)
           for p in args[:3]]
    r = kernel_row(
        "K4", "deblock_ring (D1, the in-loop deblocking filter: its ring "
        "entry, uint8 planes in, the DPB slot out, coded 4x4 blocks from "
        "the levels)", "tpuh264_torch/csrc/deblock.cu",
        "tpuh264/kernels/deblock.py:130", k4_ring_equal(args, kw, torch, what),
        timed(lambda: deblock.deblock_ring(*args, out=out, **kw), 20),
        timed(lambda: d1_ring_plain(args, kw), 1), k4_ring_bytes(args, kw))
    r["cycles_col"] = d1_cycles(r["ms"], mhz, args[0].shape[-1] // 16)
    return r


def d1_ring_edges(dev, torch, np, card):
    """K4's ring entry on every D1 case, the fields as record views and
    apart, from uint8 planes; timed on each D1 shape's "inter" case at QP
    30 from the record views (ms, bytes bound, share)."""
    from tpuh264_torch.kernels import deblock

    for case in D1_CASES:
        for layout in D1_RING_LAYOUTS:
            args, kw = d1_ring_args(torch, np, case, layout, True, dev)
            k4_ring_equal(args, kw, torch, f"edge case {case} {layout}")
    for shape in D1_SHAPES:
        args, kw = d1_ring_args(torch, np, (shape, "inter", 30), "records",
                                True, dev)
        ms = timed(lambda: deblock.deblock_ring(*args, **kw), 20)
        bound = bound_ms(k4_ring_bytes(args, kw))
        print(f"phase 2: K4's ring entry, D1 shape (S, H, W) {shape}, inter, "
              f"QP 30, record views: {ms:.4f} ms, bound {bound:.5f} ms "
              f"(bytes), {100 * bound / ms:.1f}% of the bound [{card}]")
    print(f"phase 2: K4's ring entry, {2 * len(D1_CASES)} edge cases: "
          f"D1_CASES x the fields {list(D1_RING_LAYOUTS)} (inter MBs coded in "
          f"one 4x4 alone, uncoded ones, t8 MBs, all-intra frames without "
          f"fields): equal to the plain deblock on deblock_nnz's grid, "
          f"written into a ring slot")


def k15_rows(dev, torch, card, mhz):
    """K15 against its plain version at the main path's 1080p x 4, k = 4,
    for each kind (rigid first: the main path's), then on every
    K15_EDGES case: exact (max_abs_err 0) or the run fails."""
    from tpuh264_torch.engine import sources

    w, h, k, s, t = K15_MAIN
    rows = []
    for kind in sources.KINDS:
        call = lambda: sources.device_source_gop(w, h, k, s, kind, t, dev)
        plain = lambda: sources._device_source_gop_plain(w, h, k, s, kind,
                                                         t, dev)
        got, want = call(), plain()
        torch.cuda.synchronize()
        err = max(max_abs_err(a, b) for a, b in zip(got, want))
        if err:
            fail(f"K15 differs from its plain version ({kind}, 1080p x 4)")
        del got, want
        r = kernel_row(
            "K15", f"device_source_gop (the device source, '{kind}')",
            "tpuh264_torch/csrc/source.cu", "tpuh264/engine/sources.py:143",
            err, timed(call, 20), timed(plain, 3), 3 * k * s * h * w // 2)
        r["issue_ms"] = k15_issue_ms(kind, w, h, k, s, mhz)
        print(f"phase 2: K15 '{kind}': bytes bound {r['bound_ms']:.4f} ms, "
              f"issue bound {r['issue_ms']:.4f} ms ({K15_INSTR[kind]} "
              f"instructions a luma / chroma sample at {mhz} MHz) [{card}]")
        if r["issue_ms"] > r["bound_ms"]:
            r["bound_ms"], r["bound_by"] = r["issue_ms"], "operations"
        rows.append(r)
    for case in K15_EDGES:
        for kind in sources.KINDS:
            got = sources.device_source_gop(*case[:4], kind, case[4], dev)
            want = sources._device_source_gop_plain(*case[:4], kind, case[4],
                                                    dev)
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                fail(f"K15 differs from its plain version ({kind}, {case})")
    print(f"phase 2: K15 on {len(K15_EDGES)} edge cases (W, H, k, S, t) "
          f"{list(K15_EDGES)} x {list(sources.KINDS)}: equal to plain "
          f"(max_abs_err 0)")
    return rows


def pframe_1080p(dev, torch):
    """Phase 2's 1920x1080 x 4 input (1088 rows): two "rigid" frames and
    the second encoded as a P frame against the first: y, u, v, the P
    symbols, its recon and motion."""
    from tpuh264_torch.engine.sources import device_source_gop
    from tpuh264_torch.kernels import pframe

    y, u, v = device_source_gop(1920, 1088, 2, 4, "rigid", 100, dev)
    # the reference as the pipeline passes it: a DPB slot, uint8
    sym, rec, mot = pframe.encode_pframe_rows_multi(
        y[1], u[1], v[1], [y[0]], [u[0]], [v[0]], 30, intra_in_p=False)
    return y, u, v, sym, rec, mot


def pframe_480p(dev, torch, t8, gap=1):
    """A 854x480 x 8 (864 wide) P frame at QP 30: the "meeting" clip, an I
    frame, then the clip's frame `gap` frames on as a P frame with
    intra-in-P (the CodecConfig default) and, where `t8`, the 8x8
    transform (config 3's symbols) against the I frame's deblocked recon:
    the I recon, the references, the P symbols, recon and motion."""
    from tpuh264_torch.kernels import deblock, iframe, pframe

    clip = clip_streams(864, 480, gap + 1, 8)
    f0, f1 = ([torch.from_numpy(p).to(dev) for p in clip[t]]
              for t in (0, gap))
    _, rec_i = iframe.encode_iframe_rows(*f0, 30)
    refs = [p.to(torch.int32)[None] for p in deblock.deblock_i(rec_i, 30)]
    sym, rec, mot = pframe.encode_pframe_rows_multi(*f1, *refs, 30, t8=t8,
                                                    intra_in_p=True)
    return rec_i, refs, sym, rec, mot


def d1_edges(dev, torch, np):
    """D1 on the seeded edge cases of `d1_case` (every D1_CASES entry)."""
    for case in D1_CASES:
        y, u, v, kind, mvx, mvy, nnz, ref, t8 = [
            None if a is None else torch.from_numpy(a).to(dev)
            for a in d1_case(np, *case)]
        d1_equal((y, u, v, kind, mvx, mvy, nnz, case[2]),
                 dict(refidx=ref, t8=t8), torch, f"edge case {case}")
    print(f"phase 2: K4 (D1) edge cases, {len(D1_CASES)}: (S, H, W) "
          f"{list(D1_SHAPES)} (C = 1; odd S, R, C; C = 16) x "
          f"{list(D1_VARIANTS)} "
          f"(MV steps 0 / 3 / 4 / 5, refidx 0..3, random t8, all-intra; "
          f"samples near 0 / 255) x qp {list(D1_QPS)}: equal to plain")


def d1_t8_480p(dev, torch, mhz, card):
    """D1 on `pframe_480p`'s I frame and t8 P frame; t8 MBs required."""
    from tpuh264_torch.kernels import deblock

    rec_i, _, sym, rec, mot = pframe_480p(dev, torch, t8=True)
    d1_equal(*d1_args(torch, rec_i, 30), torch, "480p x 8 I frame")
    n8 = int((sym.t8 == 1).sum())
    if n8 == 0:
        fail("D1 480p x 8: no MB chose the 8x8 transform")
    rargs, rkw = ring_call_args(rec, 30, sym, mot, t8=True)
    k4_ring_equal(rargs, rkw, torch, "480p x 8 t8 P frame")
    ms = timed(lambda: deblock.deblock_ring(*rargs, **rkw), 20)
    bound = bound_ms(k4_ring_bytes(rargs, rkw))
    print(f"phase 2: K4's ring entry, 854x480 x 8 t8 P frame: {ms:.4f} ms, "
          f"bound {bound:.4f} ms (bytes), {100 * bound / ms:.1f}% of the "
          f"bound; {d1_cycles(ms, mhz, 54):.0f} cycles a MB column at {mhz} "
          f"MHz [{card}]")
    r = d1_row(*d1_args(torch, rec, 30, sym, mot, t8=True), torch,
               "480p x 8 t8 P frame", mhz)
    print(f"phase 2: K4 (D1) 854x480 x 8 (864 wide) 'meeting' I frame and "
          f"t8 P frame ({n8} of {sym.t8.numel()} MBs t8): equal to plain; "
          f"P frame: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.3f} ms, "
          f"bound {r['bound_ms']:.4f} ms (bytes): "
          f"{100 * r['bound_ms'] / r['ms']:.1f}% of the bound; "
          f"{r['cycles_col']:.0f} cycles a MB column at {mhz} MHz [{card}]")


# (S, R, C): C = 1, 2 and 3, and a long lane (C = 61, odd: past the
# kernel's ring of 8 columns in flight and its 32-column flag windows);
# S and R from 1 to 4
D2_SHAPES = ((1, 1, 1), (4, 3, 1), (2, 4, 2), (3, 2, 3), (2, 2, 61))
# intra shares 0, ~1% (at least one MB), 50% and 100% beside `other`, and
# the I decode (no `other`: every MB intra); then the P decode ("col0",
# column 0 all intra) and the I decode ("iframe-col0") with modes that
# no legal stream codes in column 0: luma H (mode 1) and chroma H (cmode
# 1), apart and together (D2_COL0, lane by lane)
D2_SHARE = {"inter": 0.0, "sparse": 0.01, "half": 0.5, "intra": 1.0,
            "iframe": 1.0, "col0": 0.5, "iframe-col0": 1.0}
D2_VARIANTS = tuple(D2_SHARE)
D2_COL0 = ((1, 1), (1, 0), (2, 1), (2, 0))  # (mode, cmode) of lane l % 4
D2_QP = 32
D2_CASES = [(shape, variant) for shape in D2_SHAPES
            for variant in D2_VARIANTS]
# and QPs 0 and 51 (the dequantisers' extremes), on the I decode, the P
# decode's mix and all intra
D2_QP_CASES = [(shape, variant, qp) for shape in D2_SHAPES[2:]
               for variant in ("iframe", "half", "intra") for qp in (0, 51)]
# K5's ring of columns (csrc/intra_recon.cu): all-intra lanes longer than
# it (C = 61 above, 97 here), P decodes whose lanes alternate runs of
# intra and `other` columns ("runs": lane l's runs D2_RUNS[l % 5] long,
# so that the ring drains and refills), and C = 1
D2_RUNS = (1, 2, 5, 9, 13)
D2_RING_CASES = [((2, 2, 97), "intra"), ((1, 3, 97), "iframe"),
                 ((2, 3, 97), "runs"), ((3, 2, 40), "runs"),
                 ((2, 3, 1), "runs"), ((1, 2, 1), "iframe")]


def d2_case(np, shape, variant, qp=D2_QP):
    """Seeded D2 inputs (numpy): (symbols, other, refs, qp).  `symbols`
    holds the P-slice symbol fields (kernels/pframe.py MBSymbolsP's names
    and layout), the MB kinds by the variant's intra share, or in runs
    ("runs", D2_RUNS) (the others skip or inter).  Intra MBs take legal
    modes, column 0 DC (mode 2,
    cmode 0), but in the "-col0" variants, whose column 0 is all intra
    with lane l's modes D2_COL0[l % 4]; later columns DC or H at random,
    luma and chroma apart.
    Luma and chroma DC levels up to +-40 at QP 32 drive prediction +
    residual past 0 and past 255; levels are drawn whatever the cbps say
    (those a cbp masks out are nonzero too).  `other` is [S,R,C,16,16],
    [S,R,C,8,8] x 2 random samples (what the intra scan takes for the
    other MBs);
    `refs` one reference [1,S,H,W] x 3 for the whole P decode, and inter
    MBs' MVs within +-6 pels.  Both None for "iframe" and "iframe-col0"
    (the I decode)."""
    s, r, c = shape
    tag = D2_VARIANTS.index(variant) if variant in D2_SHARE else 99
    rng = np.random.default_rng([s, r, c, tag]
                                + ([] if qp == D2_QP else [qp]))
    mb = (s, r, c)
    if variant == "runs":
        lane = np.arange(s * r).reshape(s, r, 1)
        run = np.asarray(D2_RUNS)[lane % len(D2_RUNS)]
        intra = ((np.arange(c) + lane) // run) % 2 == 0
    else:
        intra = rng.random(mb) < D2_SHARE[variant]
    if variant == "sparse" and not intra.any():
        intra[tuple(int(rng.integers(0, n)) for n in mb)] = True
    col0 = variant.endswith("col0")
    if col0:
        intra[..., 0] = True
    kind = np.where(intra, 2, rng.integers(0, 2, mb))
    first = np.arange(c) == 0
    lanes = np.arange(s * r).reshape(s, r, 1) % len(D2_COL0)
    m0, c0 = ((np.asarray(D2_COL0)[:, i][lanes] if col0 else legal)
              for i, legal in ((0, 2), (1, 0)))
    mode = np.where(intra, np.where(first, m0, rng.choice([1, 2], mb)), 0)
    cmode = np.where(intra, np.where(first, c0, rng.integers(0, 2, mb)), 0)
    cbp_luma = np.where(intra, rng.integers(0, 2, mb),
                        np.where(kind == 1, rng.integers(0, 16, mb), 0))
    cbp_chroma = np.where(kind == 0, 0, rng.integers(0, 3, mb))
    # quarter-pel MVs; an inter MB's mvd is its MV less its left
    # neighbour's (0 where that one is not inter: the decoder's chain)
    mvd = []
    for _ in range(2):
        mv = np.where(kind == 1, rng.integers(-24, 25, mb), 0)
        mvd.append(np.where(kind == 1, mv - np.concatenate(
            [np.zeros((s, r, 1), mv.dtype), mv[..., :-1]], -1), 0))

    def levels(sh, amp, zero):
        x = rng.integers(-amp, amp + 1, sh)
        x[rng.random(sh) < zero] = 0
        return x.astype(np.int16)

    i32 = lambda x: x.astype(np.int32)
    sym = dict(kind=i32(kind), mode=i32(mode), cmode=i32(cmode),
               cbp_luma=i32(cbp_luma), cbp_chroma=i32(cbp_chroma),
               mvdx=i32(mvd[0]), mvdy=i32(mvd[1]),
               luma_dc=levels((*mb, 16), 40, 0.5),
               luma_ac=levels((*mb, 16, 16), 6, 0.8),
               chroma_dc=levels((*mb, 2, 4), 30, 0.5),
               chroma_ac=levels((*mb, 2, 4, 15), 6, 0.8),
               refidx=np.zeros(mb, np.int32))
    if variant.startswith("iframe"):
        return sym, None, None, qp
    other = tuple(i32(rng.integers(0, 256, (*mb, n, n))) for n in (16, 8, 8))
    refs = tuple(i32(rng.integers(0, 256, (1, s, n * r, n * c)))
                 for n in (16, 8, 8))
    return sym, other, refs, qp


# K5's Intra_4x4 route (`i44`): every MB of mode 4 ("i44"), Intra_16x16
# (DC or H) and Intra_4x4 MBs mixed column by column ("mix"), both I
# decodes, and the P decode's mix of those with `other` ("p-i44"); C = 1,
# 3, 9 and 61, S and R 1 to 4; QPs 0, 12, 32 and 51, each variant meeting
# every one across the shapes; then lanes of 97 and 40 columns that wrap
# the ring (and the small build's ring of 3)
D2_I44_SHAPES = ((1, 1, 1), (3, 2, 3), (2, 4, 9), (2, 2, 61))
D2_I44_VARIANTS = ("i44", "mix", "p-i44")
D2_I44_QPS = (0, 12, 32, 51)
D2_I44_CASES = [(shape, variant, D2_I44_QPS[(i + j) % len(D2_I44_QPS)])
                for i, shape in enumerate(D2_I44_SHAPES)
                for j, variant in enumerate(D2_I44_VARIANTS)]
D2_I44_RING_CASES = [((1, 2, 97), "i44", 28), ((1, 3, 40), "p-i44", 36)]
# the two-block levels of the blocks' dependency levels (z-scan indices;
# csrc/intra44_common.cuh `i44_level_block`), which the Intra_4x4 routes
# walk a half-warp a block
I44_LEVEL_PAIRS = ((2, 4), (3, 5), (6, 8), (7, 9), (10, 12), (11, 13))
# every MB of mode 4, the two blocks of every two-block level of every MB
# of different modes (DC beside a directional mode too)
D2_I44_LEVEL_CASE = ((2, 3, 9), "levels", 20)
# block modes outside 0..8, which the reconstruction clamps
D2_I44_WILD = (-32768, -9, -1, 9, 15, 255, 32767)


def d2_i44_case(np, shape, variant, qp=D2_QP):
    """Seeded inputs of K5's Intra_4x4 route, as `d2_case`'s: (symbols,
    other, None, qp), `symbols` with `i4modes` [S, R, C, 16] int16.  Every
    field is drawn whatever the MB's mode: the block modes 0..8 (~8%
    D2_I44_WILD), all 16 zigzag luma levels of every block (slot 0 too)
    whatever the 4-bit cbp_luma, luma DC levels, and luma / chroma modes
    DC or H in any column, column 0 included.  "p-i44": half the MBs
    intra, the rest taking `other` (samples -300..600, so that
    predictions from them leave 0..255).  "levels" (D2_I44_LEVEL_CASE):
    every MB of mode 4, its block modes in 0..8, the second block of each
    two-block level (I44_LEVEL_PAIRS) of another mode than the first."""
    s, r, c = mb = shape
    rng = np.random.default_rng([s, r, c, 44, (D2_I44_VARIANTS
                                               + ("levels",)).index(variant),
                                 qp])
    p = variant == "p-i44"
    intra = rng.random(mb) < 0.5 if p else np.ones(mb, bool)
    mode = (np.full(mb, 4) if variant in ("i44", "levels")
            else rng.choice([1, 2, 4, 4], mb))
    mode = np.where(intra, mode, 0)
    kind = np.where(intra, 2, rng.integers(0, 2, mb))
    i4m = rng.integers(0, 9, (*mb, 16))
    if variant == "levels":
        for a, b in I44_LEVEL_PAIRS:
            i4m[..., b] = (i4m[..., a] + rng.integers(1, 9, mb)) % 9
    else:
        wild = rng.random(i4m.shape) < 0.08
        i4m[wild] = rng.choice(D2_I44_WILD, int(wild.sum()))

    def levels(sh, amp, zero):
        x = rng.integers(-amp, amp + 1, sh)
        x[rng.random(sh) < zero] = 0
        return x.astype(np.int16)

    i32 = lambda x: x.astype(np.int32)
    sym = dict(kind=i32(kind), mode=i32(mode),
               cmode=i32(np.where(intra, rng.integers(0, 2, mb), 0)),
               cbp_luma=i32(np.where(mode == 4, rng.integers(0, 16, mb),
                                     rng.integers(0, 2, mb))),
               cbp_chroma=i32(np.where(kind == 0, 0, rng.integers(0, 3, mb))),
               luma_dc=levels((*mb, 16), 40, 0.5),
               luma_ac=levels((*mb, 16, 16), 12, 0.7),
               chroma_dc=levels((*mb, 2, 4), 30, 0.5),
               chroma_ac=levels((*mb, 2, 4, 15), 6, 0.8),
               i4modes=i4m.astype(np.int16))
    other = (tuple(i32(rng.integers(-300, 601, (*mb, n, n)))
                   for n in (16, 8, 8)) if p else None)
    return sym, other, None, qp


def d2_args(torch, case, dev):
    """`_intra_recon_scan`'s arguments (a dict) for a `d2_case` or
    `d2_i44_case` result on `dev`: the symbols as `levels`, qp and its
    chroma QP, `other` and is_intra (kind == 2) where the case has them,
    and `i44` (luma_ac, i4modes, qp) where it has i4modes."""
    import types

    from tpuh264_torch.kernels.transform import chroma_qp_from_luma

    sym, other, _, qp = case
    t = types.SimpleNamespace(**{k: torch.as_tensor(v, device=dev)
                                 for k, v in sym.items()})
    kw = dict(mode=t.mode, cmode=t.cmode, levels=t, qp=qp,
              qpc=chroma_qp_from_luma(qp))
    if "i4modes" in sym:
        kw["i44"] = (t.luma_ac, t.i4modes, qp)
    if other is None:
        return kw
    return dict(kw, other=tuple(torch.as_tensor(p, device=dev)
                                for p in other), is_intra=t.kind == 2)


def d2_capture(fn):
    """The arguments (dicts) of the `_intra_recon_scan` calls that `fn()`
    makes: the decoders' own inputs of the scan."""
    import inspect

    from tpuh264_torch.kernels import iframe, pframe

    real = iframe._intra_recon_scan
    sig = inspect.signature(real)
    calls = []

    def spy(*a, **kw):
        calls.append(dict(sig.bind(*a, **kw).arguments))
        return real(*a, **kw)

    # the router counts its launches (and its Intra_4x4 route's) on the
    # function its module names
    spy.__dict__.update(real.__dict__)
    iframe._intra_recon_scan = pframe._intra_recon_scan = spy
    try:
        fn()
    finally:
        iframe._intra_recon_scan = pframe._intra_recon_scan = real
        real.__dict__.update(spy.__dict__)
    return calls


# K6 (D3, D4): the D2 shapes (C = 1, 2, 3 and a long lane of 61; S and R
# from 1 to 4); content flat (DC / H ties), noise, constant rows (H
# wins) and samples at 0 and 255 (the recon clips); QPs 0, 11 (the
# rounding shift of dequant_luma_dc), 12, 28 and 51 (the tables' top).
# Each content meets every QP across the shapes: (shape i + content j)
# picks the QP.
D3_SHAPES = D2_SHAPES
D3_CONTENT = ("flat", "noise", "rows", "saturate")
D3_QPS = (0, 11, 12, 28, 51)
D3_CASES = [(shape, content, D3_QPS[(i + j) % len(D3_QPS)])
            for i, shape in enumerate(D3_SHAPES)
            for j, content in enumerate(D3_CONTENT)]
# D4: the inter SAD makes intra win on a share of the MBs (0, ~1% -- at
# least one MB --, 50%, 100%), or ties it exactly ("ties": the intra SAD
# itself on half the MBs, exact up to each lane's first tie, which inter
# wins and which changes the chain after it)
D4_SHARE = {"inter": 0.0, "sparse": 0.01, "half": 0.5, "intra": 1.0,
            "ties": 0.5}
D4_CASES = [(shape, variant, D3_CONTENT[(i + j) % len(D3_CONTENT)],
             D3_QPS[(i + j) % len(D3_QPS)])
            for i, shape in enumerate(D3_SHAPES)
            for j, variant in enumerate(D4_SHARE)]
NO_INTER = 1 << 30  # an inter SAD no intra SAD reaches (at most 65,280)


def d3_case(np, shape, content, qp):
    """Seeded source frames (numpy uint8 y [S,H,W], u, v [S,H/2,W/2]) of a
    D3 case, and its qp."""
    s, r, c = shape
    rng = np.random.default_rng(
        [s, r, c, D3_CONTENT.index(content), qp])

    def plane(n):
        h, w = n * r, n * c
        if content == "flat":  # one value a lane: DC and H predict alike
            x = np.repeat(rng.integers(0, 256, (s, r, 1, 1)), n, 2)
            x = np.broadcast_to(x, (s, r, n, w)).reshape(s, h, w)
        elif content == "noise":
            x = rng.integers(0, 256, (s, h, w))
        elif content == "rows":  # a value a sample row: H wins
            x = np.broadcast_to(rng.integers(0, 256, (s, h, 1)), (s, h, w))
        else:  # "saturate": 0 and 255 samples, so recon passes both
            x = np.where(rng.random((s, h, w)) < 0.5, 0, 255)
            x[:, :, ::3] = rng.integers(0, 256, (s, h, (w + 2) // 3))
        return np.ascontiguousarray(x).astype(np.uint8)

    return plane(16), plane(8), plane(8), qp


# K6's Intra_4x4 route (`intra44`): the D3 shapes of C = 1, 2, 3 and 61;
# content "stripes" (each MB stripes of its own direction, period and
# levels over noise: Intra_4x4 wins a share of the MBs, every mode 0-8 is
# chosen somewhere, column 0 too), "flat" (every mode predicts alike: mode
# SADs tie, and at QP 0 J ties exactly, both recons exact), "noise"
# (Intra_16x16 wins nearly everywhere) and "saturate" (0 and 255); QPs 0,
# 12, 28 and 51, each content meeting every one across the shapes.  Each
# case runs from uint8 and from int32 planes.
D3_I44_SHAPES = ((1, 1, 1), (2, 4, 2), (3, 2, 3), (2, 2, 61))
D3_I44_CONTENT = ("flat", "stripes", "noise", "saturate")
D3_I44_QPS = (0, 12, 28, 51)
D3_I44_CASES = [(shape, content, D3_I44_QPS[(i + j) % len(D3_I44_QPS)])
                for i, shape in enumerate(D3_I44_SHAPES)
                for j, content in enumerate(D3_I44_CONTENT)]
# the stripes' directions (x, y weights of a sample's phase): vertical,
# horizontal and the diagonals of the eight directional modes
D3_I44_DIRS = ((1, 0), (0, 1), (1, 1), (1, -1), (2, 1), (1, 2), (2, -1),
               (1, -2))
# stripes of four directions a MB, one an 8x8 quadrant: each two-block
# level's blocks lie in two quadrants, and where Intra_4x4 wins they
# mostly take different modes (the tests count them)
D3_I44_LEVEL_CASE = ((2, 3, 8), "quadrants", 28)


def d3_i44_case(np, shape, content, qp):
    """Seeded source frames (numpy uint8 y [S,H,W], u, v [S,H/2,W/2]) of a
    D3_I44 case, and its qp: `d3_case`'s but for "stripes", where every MB
    holds two levels in stripes of a direction of D3_I44_DIRS, a period of
    3-8 samples and a phase of its own, over noise of -6..6 or none (then
    blocks inside a stripe predict alike by every mode); its chroma is a
    level an MB over the same noise.  "quadrants" (D3_I44_LEVEL_CASE):
    stripes of four different directions a MB, one an 8x8 quadrant (a
    period of 4-11, a phase and two levels of its own), no noise; chroma
    a level an MB."""
    if content == "quadrants":
        return _i44_quadrants(np, shape, qp)
    if content != "stripes":
        return d3_case(np, shape, content, qp)
    s, r, c = mb = shape
    rng = np.random.default_rng([s, r, c, 44, qp])
    up = lambda x, n: np.repeat(np.repeat(x, n, 1), n, 2)
    dirs = np.asarray(D3_I44_DIRS)[rng.integers(0, len(D3_I44_DIRS), mb)]
    yy, xx = np.mgrid[0:16 * r, 0:16 * c]
    phase = (up(dirs[..., 0], 16) * xx + up(dirs[..., 1], 16) * yy
             + up(rng.integers(0, 16, mb), 16)) // up(rng.integers(3, 9, mb),
                                                      16)
    lo, hi = up(rng.integers(16, 110, mb), 16), up(rng.integers(140, 240, mb),
                                                    16)
    amp = rng.integers(0, 2, mb) * 6

    def noise(n):
        return (rng.integers(-6, 7, (s, n * r, n * c)) * up(amp, n)) // 6

    y = np.where(phase % 2, hi, lo) + noise(16)

    def chroma():
        x = up(rng.integers(40, 216, mb), 8) + noise(8)
        return np.clip(x, 0, 255).astype(np.uint8)

    return np.clip(y, 0, 255).astype(np.uint8), chroma(), chroma(), qp


def _i44_quadrants(np, shape, qp):
    """`d3_i44_case`'s "quadrants" frames."""
    s, r, c = shape
    rng = np.random.default_rng([s, r, c, 4444, qp])
    nq = (s, 2 * r, 2 * c)
    up = lambda x, n: np.repeat(np.repeat(x, n, 1), n, 2)
    d = np.stack([rng.permutation(len(D3_I44_DIRS))[:4]
                  for _ in range(s * r * c)]).reshape(s, r, c, 2, 2)
    dirs = np.asarray(D3_I44_DIRS)[d.transpose(0, 1, 3, 2, 4).reshape(nq)]
    yy, xx = np.mgrid[0:16 * r, 0:16 * c]
    phase = (up(dirs[..., 0], 8) * xx + up(dirs[..., 1], 8) * yy
             + up(rng.integers(0, 16, nq), 8)) // up(rng.integers(4, 12, nq),
                                                     8)
    y = np.where(phase % 2, up(rng.integers(140, 240, nq), 8),
                 up(rng.integers(16, 110, nq), 8))
    chroma = lambda: up(rng.integers(40, 216, (s, r, c)), 8).astype(np.uint8)
    return y.astype(np.uint8), chroma(), chroma(), qp


def d4_args(torch, case, dev):
    """`_intra_in_p_scan`'s arguments (a dict) for a D4_CASES entry on
    `dev`: the case's source as MB views of int32 planes, `rec_inter`
    random samples, and the inter SAD of its variant ("ties": the plain
    scan's intra SADs when every MB takes intra, on half the MBs)."""
    import numpy as np

    from tpuh264_torch.kernels import iframe, pframe
    from tpuh264_torch.kernels.transform import chroma_qp_from_luma

    shape, variant, content, qp = case
    s, r, c = shape
    y, u, v, _ = d3_case(np, shape, content, qp)
    rng = np.random.default_rng([s, r, c, list(D4_SHARE).index(variant)])
    i32 = lambda x: torch.from_numpy(np.ascontiguousarray(x, np.int32))
    mbs = [iframe._plane_to_mbs(i32(p), n)
           for p, n in ((y, 16), (u, 8), (v, 8))]
    rec = tuple(i32(rng.integers(0, 256, (s, r, c, n, n)))
                for n in (16, 8, 8))
    intra = rng.random((s, r, c)) < D4_SHARE[variant]
    if variant == "sparse" and not intra.any():
        intra[tuple(int(rng.integers(0, n)) for n in shape)] = True
    isad = np.where(intra, NO_INTER, 0)
    kw = dict(src_mbs=mbs[0], u_mbs=mbs[1], v_mbs=mbs[2], rec_inter=rec,
              qp=qp, qpc=chroma_qp_from_luma(qp))
    if variant == "ties":
        _, m, _ = pframe._intra_in_p_scan_plain(
            **kw, inter_sad=torch.full((s, r, c), NO_INTER,
                                       dtype=torch.int32))
        isad = np.where(intra, NO_INTER, m.sad.numpy())
    kw["inter_sad"] = i32(isad)
    return {k: (tuple(p.to(dev) for p in x) if isinstance(x, tuple) else
                x.to(dev) if torch.is_tensor(x) else x)
            for k, x in kw.items()}


def d4_capture(fn):
    """The arguments (dicts) of the `_intra_in_p_scan` calls that `fn()`
    makes: the P encode's own inputs of the intra-in-P scan."""
    from tpuh264_torch.kernels import pframe

    return capture(pframe, "_intra_in_p_scan", fn)


# K9 (the P encode after stage A) and K10 (the P decode's inter part):
# one MB (S = R = C = 1), odd S, one row, one column, a 3 x 5 frame, a
# row of 34 columns (K10 carries its chain past 32);
# content noise, real motion (the references are shifted crops of one
# texture, the source another with noise), flat frames (every SAD 0, so
# the rates and the tie order decide) and samples at 0 / 255 (the recon
# clips; QP 0 makes the largest levels); QPs 0, 28 and 51.  K9 takes 1-4
# references and ref_base 0 or 1, intra-in-P on or off (int32 MBs or
# uint8 planes out), references vertically pre-extended (`halo`) or not,
# and its stage-A winners from the real stage A or "edge" ones: each of
# iy0, ix0 at -8, +8 or random in between, with random global vectors,
# so that the refined vectors reach +-9 pels beside a global vector of up
# to 8 the other way.  K10 decodes symbols with skip, inter and intra MBs
# ("mixed"), inter chains only ("inter", long chains, MVs past the
# planes' pad: the clamp), all skip and all intra, and random references.
P_SHAPES = ((1, 1, 1), (3, 1, 2), (2, 2, 3), (1, 3, 5), (1, 2, 34))
P_CONTENT = ("noise", "motion", "flat", "saturate")
P_QPS = (0, 28, 51)
K9_CASES = [(shape, 1 + (i + j + w) % 4, (i + w) % 2, content,
             P_QPS[(i + j + w) % 3], ("stageA", "edge")[w],
             bool((i + j) % 2), (i + 2 * j + w) % 3 == 0)
            for i, shape in enumerate(P_SHAPES)
            for j, content in enumerate(P_CONTENT) for w in (0, 1)]
# and six references (more than the GOP pipeline's four: a session or a
# decoded stream may hold up to sixteen)
K9_CASES.append(((1, 2, 3), 6, 0, "motion", 28, "stageA", True, False))
# and "subpel": each MB's source is reference 0's quarter-pel prediction
# at 4 (iy0 + sy) + 3 sy (and likewise in x), sy = +-1, on a smooth
# texture, so that stage B takes the far +-1 candidate, the half-pel
# selection a corner and the quarter-pel one the ring beyond it (|by| =
# |bx| = 3): the last rows and columns of the 20x20 window.  MBs at the
# frame's border take winners of +-12 / 13 pointing out of the frame, so
# that their windows reach past the planes' pad (the clamp); the others
# stay within +-8 (no clamp).
K9_CASES += [((2, 2, 3), 1, 0, "smooth", 12, "subpel", False, False),
             ((1, 3, 5), 2, 0, "smooth", 20, "subpel", True, False),
             ((1, 3, 5), 1, 1, "smooth", 28, "subpel", False, True)]
# and a row of 121 MBs (31 blocks of K9 on one row, the mvds handed
# across 30 block borders)
K9_CASES.append(((1, 1, 121), 1, 0, "motion", 28, "stageA", False, False))
K10_MIX = ("mixed", "inter", "skip", "intra")
K10_CASES = [(shape, 1 + (i + j) % 4, mix, P_QPS[(i + 2 * j) % 3],
              (i + j) % 3 == 1)
             for i, shape in enumerate(P_SHAPES)
             for j, mix in enumerate(K10_MIX)] + [((2, 1, 3), 6, "mixed", 28,
                                                    False)]
# and rows of 97 columns, more than three 32-column spans: every MB inter
# ("chain": one run of 97), and every MB inter but a skip at column 33
# and an intra MB at column 64 ("resets": runs of 33, 30 and 32)
K10_CASES += [((1, 1, 97), 2, "chain", 28, False),
              ((2, 1, 97), 1, "resets", 12, True),
              ((1, 1, 121), 1, "mixed", 28, False)]

# The t8 routes (the 8x8 transform's choice in K9, its decode in K10), at
# the QPs of dequant8x8's branches (0, 5, 6, 11 below 12; 12, 51) and
# between, 1 and 2 references, intra-in-P on and off.  K9's "sparse"
# content (`_sparse_frame`: flat references, a source of sparse faint
# 4x4 noise, 8x8 offsets and row bumps) meets the choice's corners: J
# ties at QP 0 (they keep 4x4), an 8x8 coding of no level that would be
# cheaper (cbp8 == 0 keeps 4x4) and MBs whose 4x4 coding codes nothing
# while their 8x8 one wins (tests/test_torch_pframe_kernel.py counts
# them and asserts the cases meet each);
# "motion" and "noise" the route on real and random content.
K9_T8_CASES = [((2, 4, 8), 1 + i % 2, 0, "sparse", qp, "stageA",
                bool(i % 3 == 1), False)
               for i, qp in enumerate((0, 5, 6, 11, 12, 14, 16, 28, 40, 51))]
K9_T8_CASES += [((1, 2, 3), 2, 0, "motion", 0, "stageA", True, False),
                ((2, 2, 3), 2, 1, "motion", 28, "stageA", False, True),
                ((1, 3, 5), 1, 0, "noise", 51, "edge", False, False),
                ((3, 1, 2), 2, 0, "saturate", 12, "stageA", True, False)]
# and the corners of the t8 route's windows (both references' copied in
# at the warp's start, a later one's after a search, luma and chroma):
# two references whose first's windows lie past the planes' border at the
# frame's edge ("subpel"), and "far" winners, 14-16 pels out of the frame
# at its border MBs, so that the luma and the chroma windows of every
# reference there lie past the pads (the clamp), the chroma ones 14 pels
# up exactly at them; 1, 2, 3 and 4 references; and three references
# whose last, copied in after the first two's searches, is the source's
# ("subpel_last": "subpel" on the last reference, which most MBs choose)
K9_T8_CASES += [((1, 3, 5), 2, 0, "smooth", 20, "subpel", False, False),
                ((2, 2, 3), 3, 0, "motion", 28, "far", False, False),
                ((1, 3, 5), 2, 1, "noise", 40, "far", True, False),
                ((1, 1, 2), 4, 0, "motion", 12, "far", False, True),
                ((1, 2, 4), 1, 0, "sparse", 6, "far", False, False),
                ((1, 3, 5), 3, 0, "smooth", 28, "subpel_last", False, False)]
# K10's: symbols whose t8 is 1 on MBs of every kind (skip and intra MBs
# too: the plain version reconstructs every t8 MB through the 8x8
# transform, whatever its kind and cbp_luma), levels outside cbp_luma
K10_T8_CASES = [(shape, 1 + (i + j) % 2, mix, qp, (i + j) % 3 == 2)
                for i, shape in enumerate(((1, 1, 1), (2, 2, 3), (1, 3, 5)))
                for j, (mix, qp) in enumerate(
                    (("mixed", 0), ("inter", 5), ("skip", 6), ("intra", 11),
                     ("mixed", 12), ("mixed", 51)))]


def _p_frames(np, rng, n, s, h, w, content, ext=0):
    """n uint8 frames [n, s, h + 2 ext, w] of the content (`ext` rows of
    the frame's continuation above and below: a halo)."""
    hh = h + 2 * ext
    if content == "flat":
        return np.full((n, s, hh, w), 128, np.uint8)
    if content == "saturate":
        x = np.where(rng.random((n, s, hh, w)) < 0.5, 0, 255)
        return x.astype(np.uint8)
    if content == "noise":
        return rng.integers(0, 256, (n, s, hh, w)).astype(np.uint8)
    tex = rng.integers(0, 256, (s, hh + 24, w + 24))
    tex = (tex + np.roll(tex, 1, -1) + np.roll(tex, 1, -2)) // 3
    out = []
    for _ in range(n):
        dy, dx = rng.integers(0, 25, 2)
        f = tex[:, dy:dy + hh, dx:dx + w] + rng.integers(-3, 4, (s, hh, w))
        out.append(np.clip(f, 0, 255))
    return np.stack(out).astype(np.uint8)


def k9_case(np, shape, n_refs, ref_base, content, qp, winners, iip, halo):
    """Seeded K9 inputs (numpy): dict of the source y, u, v [S, H, W]
    uint8, the references refs_y, refs_u, refs_v [N, S, H, W] uint8 (with
    `halo`, HALO_Y / HALO_C more rows a side), the stage-A winners iy0,
    ix0 [N, S, R, C] and global vectors gy, gx [N, S] int32 ("edge"; None
    for "stageA": the real stage A runs on them), and qp, ref_base,
    intra_in_p, halo."""
    from tpuh264_torch.kernels import pframe

    s, r, c = shape
    rng = np.random.default_rng([s, r, c, n_refs, ref_base,
                                 (*P_CONTENT, "smooth", "sparse").index(
                                     content), qp,
                                 ("stageA", "edge", "subpel", "far",
                                  "subpel_last").index(winners),
                                 iip, halo])
    h, w = 16 * r, 16 * c
    ey, ec = (pframe.HALO_Y, pframe.HALO_C) if halo else (0, 0)
    if winners in ("subpel", "subpel_last"):
        return _subpel_case(np, rng, shape, n_refs, ref_base, qp, iip, halo,
                            n_refs - 1 if winners == "subpel_last" else 0)
    if content == "sparse":
        src = [_sparse_frame(np, rng, s, h, w),
               _sparse_frame(np, rng, s, h // 2, w // 2),
               _sparse_frame(np, rng, s, h // 2, w // 2)]
    else:
        src = [_p_frames(np, rng, 1, s, h, w, content)[0],
               _p_frames(np, rng, 1, s, h // 2, w // 2, content)[0],
               _p_frames(np, rng, 1, s, h // 2, w // 2, content)[0]]
    kind = "flat" if content == "sparse" else content
    refs = [_p_frames(np, rng, n_refs, s, h, w, kind, ey),
            _p_frames(np, rng, n_refs, s, h // 2, w // 2, kind, ec),
            _p_frames(np, rng, n_refs, s, h // 2, w // 2, kind, ec)]
    win = None
    if winners in ("edge", "far"):
        mb = (n_refs, s, r, c)
        pick = lambda: np.where(rng.random(mb) < 0.6,
                                rng.choice([-8, 8], mb),
                                rng.integers(-8, 9, mb)).astype(np.int32)
        win = (pick(), pick(), rng.integers(-8, 9, (n_refs, s)).astype(
            np.int32), rng.integers(-8, 9, (n_refs, s)).astype(np.int32))
    if winners == "far":  # the border MBs' 14-16 pels out of the frame
        out = lambda n, i: np.where(i == 0, -1, np.where(i == n - 1, 1, 0))
        for k, o in ((0, out(r, np.arange(r))[:, None]),
                     (1, out(c, np.arange(c))[None, :])):
            far = o * rng.integers(14, 17, mb)
            win[k][...] = np.where(o != 0, far, win[k])
    return dict(y=src[0], u=src[1], v=src[2], refs_y=refs[0],
                refs_u=refs[1], refs_v=refs[2], winners=win, qp=qp,
                ref_base=ref_base, intra_in_p=iip, halo=halo)


def _sparse_frame(np, rng, s, h, w):
    """A uint8 [s, h, w] frame for the t8 cases: 128 plus faint noise in
    a tenth of the 4x4 blocks (amplitude 2, 3, 6 or 20 a MB, mostly 2),
    an offset of up to +-8 on a fifth of the 8x8 blocks and a dip of 2 to
    60 on the top row of another fifth."""
    amp = np.kron(rng.choice([2, 2, 3, 6, 20], (s, h // 16, w // 16)),
                  np.ones((16, 16), np.int64))
    x = (rng.random((s, h, w)) * (2 * amp + 1)).astype(np.int64) - amp
    x *= np.kron(rng.random((s, h // 4, w // 4)) < 0.1,
                 np.ones((4, 4), np.int64))
    b8 = (s, h // 8, w // 8)
    x += np.kron(rng.integers(-8, 9, b8) * (rng.random(b8) < 0.2),
                 np.ones((8, 8), np.int64))
    row = np.zeros((s, h // 8, 8, w // 8, 8), np.int64)
    row[:, :, 0] = (-rng.integers(2, 61, b8)
                    * (rng.random(b8) < 0.2))[..., None]
    return np.clip(128 + x + row.reshape(s, h, w), 0, 255).astype(np.uint8)


def _subpel_case(np, rng, shape, n_refs, ref_base, qp, iip, halo, k=0):
    """`k9_case`'s "subpel" inputs (see K9_CASES): smooth references, the
    source reference k's motion-compensated prediction at the vectors
    4 (iy0 + sy) + 3 sy, 4 (ix0 + sx) + 3 sx, with the winners and zero
    global vectors of reference k given (the others' at random): k is 0,
    or the last reference ("subpel_last")."""
    import torch

    from tpuh264_torch.kernels import pframe

    s, r, c = shape
    h, w = 16 * r, 16 * c
    ey, ec = (pframe.HALO_Y, pframe.HALO_C) if halo else (0, 0)

    def smooth(n, hh, ww):
        x = rng.integers(0, 256, (n, s, hh + 8, ww + 8)).astype(np.float64)
        for ax in (-1, -2):  # a 9-tap box blur a direction, twice
            for _ in range(2):
                x = sum(np.roll(x, k, ax) for k in range(-4, 5)) / 9
        x = (x - x.mean()) * 6 + 128
        return np.clip(x[..., 4:-4, 4:-4], 0, 255).astype(np.uint8)

    refs = [smooth(n_refs, h + 2 * ey, w), smooth(n_refs, h // 2 + 2 * ec,
                                                  w // 2),
            smooth(n_refs, h // 2 + 2 * ec, w // 2)]
    mb = (n_refs, s, r, c)
    sign = lambda: rng.choice([-1, 1], mb[1:])
    sy, sx = sign(), sign()
    rows, cols = np.arange(r)[:, None], np.arange(c)[None, :]
    # at the border, out of the frame past the pad; inside, within +-8
    out_y = np.where(rows == 0, -1, np.where(rows == r - 1, 1, 0))
    out_x = np.where(cols == 0, -1, np.where(cols == c - 1, 1, 0))
    far = lambda out: np.where(out != 0, out * rng.integers(12, 14, mb[1:]),
                               rng.integers(-7, 8, mb[1:]))
    iy, ix = far(out_y), far(out_x)
    sy = np.where(out_y != 0, out_y, sy)
    sx = np.where(out_x != 0, out_x, sx)
    win = [rng.integers(-8, 9, mb).astype(np.int32) for _ in range(2)]
    win[0][k], win[1][k] = iy, ix
    g = [rng.integers(-2, 3, (n_refs, s)).astype(np.int32) for _ in range(2)]
    g[0][k] = g[1][k] = 0
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x))
    planes_l, refs_up, refs_vp = pframe._references(
        *(t(x) for x in refs), halo)
    mvy = t((4 * (iy + sy) + 3 * sy).astype(np.int32))
    mvx = t((4 * (ix + sx) + 3 * sx).astype(np.int32))
    src = [pframe._mbs_to_plane(x.to(torch.uint8)).numpy() for x in (
        pframe._mc_luma(planes_l[k], mvx, mvy),
        pframe._mc_chroma(refs_up[k], mvx, mvy),
        pframe._mc_chroma(refs_vp[k], mvx, mvy))]
    return dict(y=src[0], u=src[1], v=src[2], refs_y=refs[0],
                refs_u=refs[1], refs_v=refs[2],
                winners=(win[0], win[1], g[0], g[1]), qp=qp,
                ref_base=ref_base, intra_in_p=iip, halo=halo)


def k9_args(torch, case, dev, t8=False):
    """`_inter_encode`'s arguments (a dict) for a `k9_case` result on
    `dev`: the references' planes from `_references`, the stage-A
    winners the case gives or the real stage A's (K1 and the winner
    selection on `dev`)."""
    from tpuh264_torch.golden.inter import LAMBDA_ME
    from tpuh264_torch.kernels import me_cuda, pframe

    t = lambda x: torch.from_numpy(x).to(dev)
    planes_l, refs_up, refs_vp = pframe._references(
        t(case["refs_y"]), t(case["refs_u"]), t(case["refs_v"]),
        case["halo"])
    y32 = t(case["y"]).to(torch.int32).contiguous()
    if case["winners"] is None:
        lam = int(LAMBDA_ME[case["qp"]])
        win = [torch.stack(f) for f in zip(*[
            pframe._int_winner(me_cuda.sad_field(y32, p[0]), lam)
            for p in planes_l])]
    else:
        win = [t(x) for x in case["winners"]]
    return dict(y32=y32, u=t(case["u"]), v=t(case["v"]), planes_l=planes_l,
                refs_up=refs_up, refs_vp=refs_vp, iy0=win[0], ix0=win[1],
                gy=win[2], gx=win[3], qp=case["qp"],
                ref_base=case["ref_base"], t8=t8,
                intra_in_p=case["intra_in_p"])



def k10_case(np, shape, n_refs, mix, qp, halo, t8=False):
    """Seeded K10 inputs (numpy): (symbols, refs, qp, halo), `symbols`
    the MBSymbolsP fields (int32 flags, int16 levels) of MBs of the mix
    (the kinds skip 0 / inter 1 / intra 2), inter MBs' mvds in +-24
    quarter-pels (chains past the planes' pad where they run long: the
    clamp), references and cbps at random; refs [N, S, H, W] x 3 uint8
    random (with `halo`, HALO_Y / HALO_C more rows a side).  With `t8`,
    symbols.t8 is 1 on about half the MBs, of any kind (K10_T8_CASES);
    else 0."""
    from tpuh264_torch.kernels import pframe

    s, r, c = shape
    rng = np.random.default_rng([s, r, c, n_refs, (
        *K10_MIX, "chain", "resets").index(mix), qp, halo] + [1] * t8)
    mb = (s, r, c)
    kind = {"mixed": rng.integers(0, 3, mb), "inter": np.where(
        rng.random(mb) < 0.85, 1, rng.integers(0, 3, mb)),
        "skip": np.zeros(mb, int), "intra": np.full(mb, 2)}.get(
            mix, np.ones(mb, int))
    if mix == "resets":
        kind[..., 33], kind[..., 64] = 0, 2
    inter, intra = kind == 1, kind == 2

    def levels(sh, amp, zero):
        x = rng.integers(-amp, amp + 1, sh)
        x[rng.random(sh) < zero] = 0
        return x.astype(np.int16)

    i32 = lambda x: np.asarray(x).astype(np.int32)
    sym = dict(
        kind=i32(kind), mode=i32(np.where(intra, 2, 0)),
        cmode=i32(np.zeros(mb)),
        cbp_luma=i32(np.where(intra, rng.integers(0, 2, mb),
                              np.where(inter, rng.integers(0, 16, mb), 0))),
        cbp_chroma=i32(np.where(kind == 0, 0, rng.integers(0, 3, mb))),
        mvdx=i32(np.where(inter, rng.integers(-24, 25, mb), 0)),
        mvdy=i32(np.where(inter, rng.integers(-24, 25, mb), 0)),
        luma_dc=levels((*mb, 16), 30, 0.5),
        luma_ac=levels((*mb, 16, 16), 8, 0.7),
        chroma_dc=levels((*mb, 2, 4), 30, 0.4),
        chroma_ac=levels((*mb, 2, 4, 15), 8, 0.7),
        refidx=i32(np.where(inter, rng.integers(0, n_refs, mb), 0)),
        t8=i32(rng.random(mb) < 0.5 if t8 else np.zeros(mb)))
    ey, ec = (pframe.HALO_Y, pframe.HALO_C) if halo else (0, 0)
    refs = tuple(rng.integers(0, 256, (n_refs, s, n * r + 2 * e, n * c))
                 .astype(np.uint8) for n, e in ((16, ey), (8, ec), (8, ec)))
    return sym, refs, qp, halo


def k10_args(torch, case, dev, t8=False):
    """`_inter_decode`'s arguments (a dict) for a `k10_case` result on
    `dev`."""
    from tpuh264_torch.kernels import pframe

    sym, refs, qp, halo = case
    planes_l, refs_up, refs_vp = pframe._references(
        *[torch.from_numpy(x).to(dev) for x in refs], halo)
    return dict(symbols=pframe.MBSymbolsP(**{
        k: torch.from_numpy(v).to(dev) for k, v in sym.items()}),
        planes_l=planes_l, refs_up=refs_up, refs_vp=refs_vp, qp=qp, t8=t8)


# K11 (the reference build): S = 1 and 3; one MB, a row, a column, a 2 x 3
# frame, a row of 97 columns (13 strips of 128 output columns) and a
# frame of 7 columns (its second strip starts past the frame's last
# sample: every staged chunk there is the clamp); N = 1, 2 and 4; without
# and with `halo`; int32 and uint8 references; noise, flat and 0 / 255
# content (the 6-tap sums at their extremes, the clips).
K11_SHAPES = ((1, 1, 1), (3, 1, 4), (1, 4, 1), (3, 2, 3), (1, 1, 97),
              (1, 2, 7))
K11_CONTENT = ("noise", "flat", "saturate")
K11_CASES = [(shape, (1, 2, 4)[(i + h) % 3], bool(h), bool((i + h) % 2),
              K11_CONTENT[(i + 2 * h) % 3])
             for i, shape in enumerate(K11_SHAPES) for h in (0, 1)]


def k11_case(np, shape, n_refs, halo, u8, content):
    """Seeded K11 inputs (numpy): (refs_y, refs_u, refs_v, halo), the DPB
    [N, S, H, W] x 3 (with `halo`, HALO_Y / HALO_C more rows a side), of
    `content`, uint8 where `u8` else int32."""
    from tpuh264_torch.kernels import pframe

    s, r, c = shape
    rng = np.random.default_rng([s, r, c, n_refs, halo, u8,
                                 K11_CONTENT.index(content)])
    ey, ec = (pframe.HALO_Y, pframe.HALO_C) if halo else (0, 0)
    refs = []
    for n, e in ((16, ey), (8, ec), (8, ec)):
        sh = (n_refs, s, n * r + 2 * e, n * c)
        x = {"noise": rng.integers(0, 256, sh), "flat": np.full(sh, 77),
             "saturate": np.where(rng.random(sh) < 0.5, 0, 255)}[content]
        refs.append(x.astype(np.uint8 if u8 else np.int32))
    return (*refs, halo)


# K12 (the stage-A winner): tables of noise SADs, of SADs in {0, 4, 8, 12}
# mirrored in dx (every least phase-1 cost tied with its mirror: the
# first-index rules), of MBs that each make one of two candidates the
# winner ("counts": alternating, so the two tie in every stream's counts;
# "split": a stream's first half one, its second half the other, so the
# tie is split across the blocks of a stream), and of MBs that all win
# one candidate a stream ("one": a rigid scene's serialised counts); a
# second table's counts summed in, as a row-sharded `group` gives; lam
# of QPs 0, 28 and 51.  The last field is the most blocks a launch (None:
# the card's SMs, `pframe._K12_BLOCKS_PER_SM` each): with 1, 2, 3 and 5 a
# stream spans several blocks' chunks and a chunk several streams
# ((5, 1, 2) at 2 blocks: three streams in one chunk).
K12_SHAPES = ((1, 1, 1), (2, 3, 4), (3, 2, 5), (1, 4, 34), (5, 1, 2),
              (3, 4, 17))
K12_CONTENT = ("noise", "tied", "counts", "split", "one")
K12_BLOCKS = (None, 1, 2, 3, 5)
K12_CASES = [(shape, content, (0, 28, 51)[(i + j) % 3], (i + j) % 2 == 1,
              K12_BLOCKS[(i + 2 * j) % len(K12_BLOCKS)])
             for i, shape in enumerate(K12_SHAPES)
             for j, content in enumerate(K12_CONTENT)]


def k12_case(np, shape, content, qp, group, blocks=None):
    """Seeded K12 inputs (numpy): (sads [S, R, C, 289] int32, lam, other),
    `other` a second table whose counts a `group` would sum in (None
    without `group`).  `blocks` (the launch's, see K12_CASES) does not
    change the data."""
    from tpuh264_torch.golden.inter import LAMBDA_ME

    s, r, c = shape
    rng = np.random.default_rng([s, r, c, K12_CONTENT.index(content), qp,
                                 group])

    def table():
        sh = (s, r, c, 289)
        if content == "noise":
            return rng.integers(0, 16320, sh).astype(np.int32)
        if content == "tied":  # mirrored in dx, dx = 0 out of the race
            x = (rng.integers(0, 4, sh) * 4).reshape(s, r, c, 17, 17)
            x = np.where(np.arange(17) < 8, x, x[..., ::-1])
            x[..., 8] = 16000
            return x.reshape(sh).astype(np.int32)
        x = np.full(sh, 16000, np.int32)
        mbs = x.reshape(s, -1, 289)
        n = mbs.shape[1]
        if content == "one":  # stream i's MBs all win one candidate
            wins = rng.integers(0, 289, (s, 1)).repeat(n, 1)
            wins[0] = 144  # the zero vector, as a static scene's
        else:  # candidates 200 and 17 half each: their counts tie, the
            # later one listed first
            half = (np.arange(n) % 2 if content == "counts"
                    else np.arange(n) >= n // 2)
            wins = np.where(half, 17, 200)[None].repeat(s, 0)
        np.put_along_axis(mbs, wins[..., None], 0, -1)
        return x

    return table(), int(LAMBDA_ME[qp]), table() if group else None


def capture(module, name, fn):
    """The arguments (dicts) of the calls of `module.name` that `fn()`
    makes, e.g. the P encode's own inputs of `_inter_encode`."""
    import inspect

    real = getattr(module, name)
    sig = inspect.signature(real)
    calls = []

    def spy(*a, **kw):
        calls.append(dict(sig.bind(*a, **kw).arguments))
        return real(*a, **kw)

    # the router counts its launches (and K9's / K10's those of their t8
    # routes) on the function its module names
    spy.__dict__.update(real.__dict__)
    setattr(module, name, spy)
    try:
        fn()
    finally:
        setattr(module, name, real)
        real.__dict__.update(spy.__dict__)
    return calls


# K7 / K8 (the single-slice wavefront): one MB (R = C = 1), one row (R =
# 1: the encoder still runs the wavefront), one column (C = 1), R > C
# (a wave's MBs capped by C, not R), and wider frames; content noise,
# linear ramps a stream and plane (Plane wins luma and chroma), a mix of
# MB kinds a frame (flat, vertical and horizontal stripes, ramps, noise:
# every mode beside its neighbours), flat 0 and 255 frames and 0 / 255
# samples (the recon clips); QPs 0, 11, 12, 28 and 51 met by every
# content across the shapes.  (1, 7, 5) and (2, 9, 4) put several MB rows
# on each CTA of the kernels' clusters as the CPU-thread tests build them
# (at most 3 CTAs, 2 teams a CTA), 7 rows not a multiple of the cluster.
W_SHAPES = ((1, 1, 1), (2, 1, 3), (2, 3, 1), (1, 5, 2), (2, 3, 4),
            (1, 2, 6), (1, 7, 5), (2, 9, 4))
W_CONTENT = ("noise", "ramp", "mix", "flat0", "flat255", "saturate")
W_QPS = D3_QPS
W_CASES = [(shape, content, W_QPS[(i + j) % len(W_QPS)])
           for i, shape in enumerate(W_SHAPES)
           for j, content in enumerate(W_CONTENT)]


def wave_case(np, shape, content, qp):
    """Seeded source frames (numpy uint8 y [S,H,W], u, v [S,H/2,W/2]) of a
    W_CASES entry, and its qp."""
    s, r, c = shape
    rng = np.random.default_rng([s, r, c, W_CONTENT.index(content), qp])

    def plane(n):
        h, w = n * r, n * c
        yy, xx = np.mgrid[0:h, 0:w]
        ramp = lambda: (128 + rng.integers(-3, 4, (s, 1, 1)) * (xx - w // 2)
                        + rng.integers(-3, 4, (s, 1, 1)) * (yy - h // 2))
        if content == "noise":
            x = rng.integers(0, 256, (s, h, w))
        elif content == "ramp":
            x = ramp()
        elif content == "mix":
            up = lambda a: np.repeat(np.repeat(a, n, 1), n, 2)
            kind = up(rng.integers(0, 5, (s, r, c)))
            x = np.select([kind == 0, kind == 1, kind == 2, kind == 3], [
                up(rng.integers(0, 256, (s, r, c))),
                np.broadcast_to(rng.integers(0, 256, (s, 1, w)), (s, h, w)),
                np.broadcast_to(rng.integers(0, 256, (s, h, 1)), (s, h, w)),
                ramp()], rng.integers(0, 256, (s, h, w)))
        elif content in ("flat0", "flat255"):
            x = np.full((s, h, w), 0 if content == "flat0" else 255)
        else:  # "saturate"
            x = np.where(rng.random((s, h, w)) < 0.5, 0, 255)
            x[:, :, ::3] = rng.integers(0, 256, (s, h, (w + 2) // 3))
        return np.ascontiguousarray(np.clip(x, 0, 255)).astype(np.uint8)

    return plane(16), plane(8), plane(8), qp


def legal_modes(np, rng, shape):
    """(mode, cmode) int32 [S, R, C] drawn at random among the modes legal
    at each MB: luma V (0) below row 0, H (1) right of column 0, DC (2)
    everywhere, Plane (3) with both; chroma DC (0) everywhere, H (1) right
    of column 0, V (2) below row 0, Plane (3) with both."""
    s, r, c = shape
    top = np.broadcast_to((np.arange(r) > 0)[:, None], (r, c))
    left = np.broadcast_to((np.arange(c) > 0)[None, :], (r, c))
    every = np.ones((r, c), bool)

    def draw(avail):  # a uniform pick among the available candidates
        keys = np.where(np.stack(avail, -1), rng.random((s, r, c, 4)), -1)
        return keys.argmax(-1).astype(np.int32)

    return (draw([top, left, every, top & left]),
            draw([every, left, top, top & left]))


def any_modes(np, rng, shape):
    """(mode, cmode) int32 [S, R, C], every MB's drawn uniformly from 0-3
    whatever neighbours it has: at the frame's edges the missing samples
    predict as the plain decode reads them (0, and the corner of a column-0
    MB from row 2 on, the bottom-right sample of MB (r - 2, 0))."""
    s, r, c = shape
    return (rng.integers(0, 4, (s, r, c)).astype(np.int32),
            rng.integers(0, 4, (s, r, c)).astype(np.int32))


def masked_cbp(np, rng, shape):
    """(cbp_luma, cbp_chroma) int32 [S, R, C] drawn at random whatever the
    levels hold (luma 0 / 1, chroma 0 / 1 / 2): where they say fewer
    levels than were coded, the decode must mask the rest."""
    return (rng.integers(0, 2, shape).astype(np.int32),
            rng.integers(0, 3, shape).astype(np.int32))


def k6_bytes(planes, kw=None, n_intra=0) -> int:
    """K6 per MB: the source samples in (uint8 or int32), the four int32
    fields and the int16 levels (16 + 256 + 8 + 120) out; D3 also the
    i4modes (16 int16) and uint8 recon out; D4 (`kw`) also the inter SAD
    in, `rec_inter` in only where inter wins (the result reads it
    nowhere else), the intra SAD, the uint8 choice and the int32 final
    recon out."""
    n = planes[0].numel() // 256
    src = sum(p.numel() * p.element_size() for p in planes)
    out = n * (16 + 2 * (16 + 256 + 8 + 120))
    if kw is None:
        return src + out + n * (2 * 16 + 384)
    return src + out + n * (4 + 4 + 1 + 4 * 384) + (n - n_intra) * 4 * 384


def ptxas_lines(src: str) -> list:
    """`src` (a kernel source) compiled alone by nvcc with -Xptxas -v into
    tpuh264_torch/build/: ptxas's lines naming each kernel (template
    instances apart) and on its registers, stack, spills and shared
    memory (empty where the build prints none)."""
    from tpuh264_torch.kernels import cuda_lib

    os.makedirs(cuda_lib.BUILD, exist_ok=True)
    out = os.path.join(cuda_lib.BUILD, os.path.basename(src) + ".cubin")
    res = subprocess.run([cuda_lib._nvcc(), "-gencode", cuda_lib.ARCH,
                          "-std=c++17", "-O3", "-cubin", "-Xptxas", "-v",
                          "-o", out, src], capture_output=True, text=True)
    if res.returncode != 0:
        fail(f"nvcc -Xptxas -v {src}: {res.stdout}{res.stderr}")
    return [ln.strip() for ln in (res.stdout + res.stderr).splitlines()
            if "spill" in ln or "Used" in ln or "entry function" in ln]


def k6_cycles(ms: float, mhz: int, c: int) -> float:
    """SM cycles a MB column of a lane (every lane walks its C columns in
    parallel with the others)."""
    return ms * 1e-3 * mhz * 1e6 / c


def intra_in_p_480p(dev, torch):
    """Phase 2's 854x480 x 8 intra-in-P P frame (864 columns): a band
    copied from the reference (skips), the moving field (inter) and a
    flat patch no reference holds (intra), encoded with intra-in-P.
    Returns the P encode's own arguments of its intra-in-P scan (a dict,
    `d4_capture`), its symbols and its MB kinds (skip, inter, intra)."""
    from tpuh264_torch.engine.sources import device_source_gop
    from tpuh264_torch.kernels import pframe

    w, h, s = 864, 480, 8
    y, u, v = device_source_gop(w, h, 2, s, "rigid", 40, dev)
    cur = [p[1].clone() for p in (y, u, v)]
    for i, p in enumerate((y, u, v)):
        sh = 1 + (i == 0)
        cur[i][:, :64 // sh] = p[0][:, :64 // sh]
        cur[i][:, 160 // sh:288 // sh, 96 // sh:480 // sh] = 30 + 40 * i
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    out = []
    kw, = d4_capture(lambda: out.append(pframe.encode_pframe_rows_multi(
        *cur, *refs, 30, intra_in_p=True)))
    sym = out[0][0]
    kinds = torch.bincount(sym.kind.reshape(-1), minlength=3).tolist()
    if min(kinds) == 0:
        fail(f"intra-in-P symbols lack an MB kind (skip/inter/intra): {kinds}")
    return kw, sym, kinds


def d3_equal(planes, qp, torch, what) -> int:
    """K6 as the I encode's scan (D3) against its plain version on one
    frame batch; fails unless every field and the recon are equal."""
    from tpuh264_torch.kernels import iframe

    k = iframe.encode_iframe_scan(*planes, qp)
    p = iframe._encode_iframe_scan_plain(*planes, qp)
    torch.cuda.synchronize()
    pairs = list(zip((*k[0], *k[1]), (*p[0], *p[1])))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        fail(f"K6 (D3) encode_iframe_scan differs from its plain version "
             f"({what})")
    return max(max_abs_err(a, b) for a, b in pairs)


def d4_equal(kw, torch, what):
    """K6 as the intra-in-P scan (D4) against its plain version on one
    input (levels int16 in the kernel, int32 in the plain version); fails
    unless equal.  Returns (max_abs_err, intra MBs)."""
    from tpuh264_torch.kernels import pframe

    use, m, rec = pframe._intra_in_p_scan(**kw)
    puse, pm, prec = pframe._intra_in_p_scan_plain(**kw)
    torch.cuda.synchronize()
    pairs = [(use, puse), *zip(m[:-1], pm[:-1]), *zip(rec, prec)]
    if not (use.dtype == torch.bool and all(
            torch.equal(a.to(b.dtype), b) for a, b in pairs)):
        fail(f"K6 (D4) _intra_in_p_scan differs from its plain version "
             f"({what})")
    return max(max_abs_err(a, b) for a, b in pairs), int(use.sum())


def d3_timed(planes, qp, torch, what, card, mhz):
    """D3 equal to its plain version on `planes`, timed beside it: a line,
    and (max_abs_err, kernel ms, plain ms, bytes)."""
    from tpuh264_torch.kernels import iframe

    err = d3_equal(planes, qp, torch, what)
    ms = timed(lambda: iframe.encode_iframe_scan(*planes, qp), 20)
    plain = timed(lambda: iframe._encode_iframe_scan_plain(*planes, qp), 1)
    nbytes = k6_bytes(planes)
    bound = bound_ms(nbytes)
    c = planes[0].shape[2] // 16
    print(f"phase 2: K6 (D3) {what} ({list(planes[0].shape)} "
          f"{planes[0].dtype}, QP {qp}): equal to plain (max_abs_err {err}); "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms "
          f"(bytes, {nbytes / 1e6:.1f} MB): {100 * bound / ms:.2f}% of the "
          f"bound; {k6_cycles(ms, mhz, c):.0f} cycles a MB column ({c} "
          f"columns) at {mhz} MHz [{card}]")
    return err, ms, plain, nbytes


def d4_timed(kw, torch, what, card, mhz):
    """D4 equal to its plain version on `kw`, timed beside it: a line."""
    from tpuh264_torch.kernels import iframe, pframe

    err, n_intra = d4_equal(kw, torch, what)
    ms = timed(lambda: pframe._intra_in_p_scan(**kw), 20)
    plain = timed(lambda: pframe._intra_in_p_scan_plain(**kw), 1)
    planes = [iframe._mbs_to_plane(kw[k])
              for k in ("src_mbs", "u_mbs", "v_mbs")]
    nbytes = k6_bytes(planes, kw, n_intra)
    bound = bound_ms(nbytes)
    s, r, c = kw["inter_sad"].shape
    print(f"phase 2: K6 (D4) {what} ([{s}, {r}, {c}] MBs, {n_intra} take "
          f"intra, QP {kw['qp']}): equal to plain (max_abs_err {err}); "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms "
          f"(bytes, {nbytes / 1e6:.1f} MB): {100 * bound / ms:.2f}% of the "
          f"bound; {k6_cycles(ms, mhz, c):.0f} cycles a MB column at {mhz} "
          f"MHz [{card}]")


def d3_edges(dev, torch, np):
    """K6 on the seeded cases: D3 on every D3_CASES entry (uint8 and int32
    planes), D4 on every D4_CASES entry."""
    for case in D3_CASES:
        y, u, v, qp = d3_case(np, *case)
        planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
        d3_equal(planes, qp, torch, f"edge case {case}")
        d3_equal([p.to(torch.int32) for p in planes], qp, torch,
                 f"edge case {case}, int32")
    for case in D4_CASES:
        d4_equal(d4_args(torch, case, dev), torch, f"edge case {case}")
    print(f"phase 2: K6 edge cases: D3 {len(D3_CASES)} x (uint8, int32), "
          f"(S, R, C) {list(D3_SHAPES)} x {list(D3_CONTENT)}, QPs "
          f"{list(D3_QPS)}; D4 {len(D4_CASES)}, intra shares "
          f"{list(D4_SHARE)}: equal to plain")


def meeting_idr(dev, torch):
    """Phase 11's IDR input: the first frame of the 854x480 x 8 "meeting"
    clip from RGBA through the session's own padding and colour
    conversion (int32 planes [8, 480, 864], [8, 240, 432] x 2)."""
    from tpuh264_torch.engine.encoder import _pad_multiple
    from tpuh264_torch.kernels import color

    rgba = clip_rgba(dev, 854, 480, 1, 8)[0]
    return color.rgba_to_yuv420(torch.from_numpy(
        _pad_multiple(rgba, 16, axes=(1, 2))).to(dev))


def k6_i44_bytes(planes) -> int:
    """K6's Intra_4x4 route: D3's bytes (`k6_bytes`: the trial reads no
    more and writes the same fields) and the 576 B of tap words once."""
    return k6_bytes(planes) + 576


def d3_i44_equal(planes, qp, torch, what):
    """K6's Intra_4x4 route against its plain version on one frame batch;
    fails unless every field and the recon are equal.  Returns
    (max_abs_err, the Intra_4x4 share of the MBs)."""
    from tpuh264_torch.kernels import iframe

    k = iframe.encode_iframe_scan(*planes, qp, intra44=True)
    p = iframe._encode_iframe_scan_plain(*planes, qp, True)
    torch.cuda.synchronize()
    pairs = list(zip((*k[0], *k[1]), (*p[0], *p[1])))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        fail(f"K6-i44 encode_iframe_scan(intra44=True) differs from its "
             f"plain version ({what})")
    return (max(max_abs_err(a, b) for a, b in pairs),
            (k[0].mode == 4).float().mean().item())


def d3_i44_timed(planes, qp, torch, what, card, mhz):
    """K6's Intra_4x4 route equal to its plain version on `planes`, timed
    beside it: a line, and (max_abs_err, kernel ms, plain ms, bytes)."""
    from tpuh264_torch.kernels import iframe

    err, share = d3_i44_equal(planes, qp, torch, what)
    ms = timed(lambda: iframe.encode_iframe_scan(*planes, qp, intra44=True),
               20)
    plain = timed(lambda: iframe._encode_iframe_scan_plain(*planes, qp,
                                                           True), 1)
    nbytes = k6_i44_bytes(planes)
    bound = bound_ms(nbytes)
    c = planes[0].shape[2] // 16
    print(f"phase 2: K6-i44 {what} ({list(planes[0].shape)} "
          f"{planes[0].dtype}, QP {qp}, Intra_4x4 share {share:.4f}): equal "
          f"to plain (max_abs_err {err}); kernel {ms:.4f} ms, plain "
          f"{plain:.3f} ms, bound {bound:.4f} ms (bytes, {nbytes / 1e6:.1f} "
          f"MB): {100 * bound / ms:.2f}% of the bound; "
          f"{k6_cycles(ms, mhz, c):.0f} cycles a MB column ({c} columns) at "
          f"{mhz} MHz [{card}]")
    return err, ms, plain, nbytes


def d3_i44_rows(dev, torch, np, card, mhz, planes):
    """K6's Intra_4x4 route (`intra44`) against its plain version: the
    1080p x 4 I frame `planes` (the row of the kernel table), phase 11's
    IDR (`meeting_idr`, QP 34: the session's own int32 planes) and every
    D3_I44 case and D3_I44_LEVEL_CASE from uint8 and int32 planes; then
    ptxas of K5's and K6's instances."""
    from tpuh264_torch.kernels import iframe

    err, ms, plain, nbytes = d3_i44_timed(planes, 30, torch,
                                          "1080p x 4 I frame", card, mhz)
    row = kernel_row(
        "K6-i44", "encode_iframe_scan with intra44 (D3's Intra_4x4 route: "
        "the trial and the I16-vs-I4x4 choice)",
        "tpuh264_torch/csrc/intra16_enc.cu", "tpuh264/kernels/iframe.py:233",
        err, ms, plain, nbytes)
    d3_i44_timed(meeting_idr(dev, torch), 34, torch,
                 "854x480 x 8 'meeting' session IDR", card, mhz)
    for case in D3_I44_CASES:
        y, u, v, qp = d3_i44_case(np, *case)
        pl = [torch.from_numpy(x).to(dev) for x in (y, u, v)]
        d3_i44_equal(pl, qp, torch, f"i44 case {case}")
        d3_i44_equal([x.to(torch.int32) for x in pl], qp, torch,
                     f"i44 case {case}, int32")
    print(f"phase 2: K6's Intra_4x4 route, {len(D3_I44_CASES)} seeded cases x "
          f"(uint8, int32): (S, R, C) {list(D3_I44_SHAPES)} x "
          f"{list(D3_I44_CONTENT)}, QPs {list(D3_I44_QPS)}: equal to plain")
    y, u, v, qp = d3_i44_case(np, *D3_I44_LEVEL_CASE)
    pl = [torch.from_numpy(x).to(dev) for x in (y, u, v)]
    err, _ = d3_i44_equal(pl, qp, torch, f"i44 level case {D3_I44_LEVEL_CASE}")
    d3_i44_equal([x.to(torch.int32) for x in pl], qp, torch,
                 f"i44 level case {D3_I44_LEVEL_CASE}, int32")
    sym = iframe.encode_iframe_scan(*pl, qp, intra44=True)[0]
    i4 = sym.mode == 4
    m = sym.i4modes[i4]
    six = torch.stack([m[:, a] != m[:, b] for a, b in I44_LEVEL_PAIRS],
                      -1).all(-1)
    print(f"phase 2: K6's Intra_4x4 route, level case {D3_I44_LEVEL_CASE} "
          f"(uint8, int32): {int(i4.sum())} of {i4.numel()} MBs Intra_4x4, "
          f"{int(six.sum())} of them with the two blocks of every two-block "
          f"level of different modes: equal to plain (max_abs_err {err})")
    i44_ptxas()
    return row


# the template instances of K5's and K6's sources, by their mangled names
I44_INSTANCES = (("intra16_enc.cu", "intra16_enc_kernelILb0", "K6 (D3, D4)"),
                 ("intra16_enc.cu", "intra16_enc_kernelILb1", "K6-i44"),
                 ("intra_recon.cu", "intra_recon_kernelILb0", "K5"),
                 ("intra_recon.cu", "intra_recon_kernelILb1", "K5-i44"))


def i44_ptxas() -> None:
    """ptxas's registers, stack, spills and shared memory of the four
    instances of K5's and K6's sources, a line each."""
    csrc = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "tpuh264_torch", "csrc")
    lines = {f: ptxas_lines(os.path.join(csrc, f))
             for f in {f for f, _, _ in I44_INSTANCES}}
    for f, mangled, name in I44_INSTANCES:
        got, on = [], False
        for ln in lines[f]:
            if "entry function" in ln:
                on = mangled in ln
            elif on:
                got.append(ln.replace("ptxas info    : ", ""))
        if not got:
            fail(f"ptxas printed nothing of {name} ({f})")
        print(f"phase 2: ptxas, {name}: {'; '.join(got)}")


def k7_bytes(planes) -> int:
    """K7 per MB: the uint8 source samples in (384), the four int32
    fields, the int16 levels and i4modes (16 + 256 + 8 + 120 + 16) and the
    uint8 recon (384) out."""
    n = planes[0].numel() // 256
    return n * (384 + 16 + 2 * (16 + 256 + 8 + 120 + 16) + 384)


def k8_bytes(mode) -> int:
    """K8 per MB: mode, cmode, cbp_luma and cbp_chroma (int32) and the
    int16 levels (16 + 256 + 8 + 120) in, the uint8 recon (384) out."""
    return mode.numel() * (16 + 2 * (16 + 256 + 8 + 120) + 384)


def wave_cycles(ms: float, mhz: int, waves: int) -> float:
    """SM cycles a wave (every stream's block walks its R + C - 1 waves in
    parallel with the others)."""
    return ms * 1e-3 * mhz * 1e6 / waves


def k7_equal(planes, qp, torch, what):
    """K7 against its plain version on one frame batch; fails unless every
    field and the recon are equal.  Returns (max_abs_err, the kernel's
    symbols, its recon)."""
    from tpuh264_torch.kernels import wavefront

    k = wavefront.encode_iframe_single(*planes, qp)
    p = wavefront._encode_iframe_single_plain(*planes, qp)
    torch.cuda.synchronize()
    pairs = list(zip((*k[0], *k[1]), (*p[0], *p[1])))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        fail(f"K7 encode_iframe_single differs from its plain version "
             f"({what})")
    return max(max_abs_err(a, b) for a, b in pairs), k[0], k[1]


def k7_int32_equal(planes, sym, rec, qp, torch, what) -> int:
    """K7 from the int32 form of uint8 `planes` (what the session's RGBA
    conversion hands it) against its output `sym`, `rec` from the uint8
    planes; fails unless equal.  Returns max_abs_err."""
    from tpuh264_torch.kernels import wavefront

    k = wavefront.encode_iframe_single(*(p.to(torch.int32) for p in planes),
                                       qp)
    torch.cuda.synchronize()
    pairs = list(zip((*k[0], *k[1]), (*sym, *rec)))
    if not all(a.dtype == b.dtype and torch.equal(a, b) for a, b in pairs):
        fail(f"K7 from int32 planes differs from K7 from uint8 ({what})")
    return max(max_abs_err(a, b) for a, b in pairs)


def k8_equal(sym, qp, torch, what, recon=None) -> int:
    """K8 (the decode router: one launch on the symbols) against its plain
    version on one symbol batch, and against the encoder's `recon` where
    given; fails unless equal."""
    from tpuh264_torch.kernels import wavefront

    k = wavefront.decode_iframe_single(sym, qp)
    p = wavefront._decode_iframe_single_plain(sym, qp)
    torch.cuda.synchronize()
    if not all(a.dtype == torch.uint8 and torch.equal(a, b)
               for a, b in zip(k, p)):
        fail(f"K8 decode_iframe_single differs from its plain version "
             f"({what})")
    if recon is not None and not all(torch.equal(a, b)
                                     for a, b in zip(k, recon)):
        fail(f"K8 decode_iframe_single differs from the encoder's recon "
             f"({what})")
    return max(max_abs_err(a, b) for a, b in zip(k, p))


def wave_plan(r, c):
    """K7's and K8's launch shape for R x C MBs, as a phrase."""
    from tpuh264_torch.kernels import wavefront

    return "; ".join(
        f"{key}: clusters of {k} CTAs, {rpc} MB rows and {teams} teams (2 "
        f"warps each) a CTA, {smem} B of shared memory a CTA"
        for key, (k, rpc, teams, smem) in zip(
            ("K7", "K8"), wavefront.launch_plan(r, c)))


def wave_timed(planes, qp, torch, what, card, mhz):
    """K7 and K8 equal to their plain versions on `planes` (K8 on K7's
    symbols, equal to K7's recon too), timed beside them: K8's entry on the
    symbols, and the router around it.  Prints a line each; returns the two
    rows' numbers, (max_abs_err, ms, plain ms, bytes) each."""
    from tpuh264_torch.kernels import wavefront

    err7, sym, rec = k7_equal(planes, qp, torch, what)
    err7 = max(err7, k7_int32_equal(planes, sym, rec, qp, torch, what))
    err8 = k8_equal(sym, qp, torch, what, rec)
    s, h, w = planes[0].shape
    waves = h // 16 + w // 16 - 1
    ms7 = timed(lambda: wavefront.encode_iframe_single(*planes, qp), 20)
    wide = [p.to(torch.int32) for p in planes]
    ms7i = timed(lambda: wavefront.encode_iframe_single(*wide, qp), 20)
    plain7 = timed(lambda: wavefront._encode_iframe_single_plain(*planes,
                                                                 qp), 1)
    ms8 = timed(lambda: wavefront._k8_launch(sym, qp), 20)
    router8 = timed(lambda: wavefront.decode_iframe_single(sym, qp), 20)
    plain8 = timed(lambda: wavefront._decode_iframe_single_plain(sym, qp), 1)
    b7, b8 = k7_bytes(planes), k8_bytes(sym.mode)
    modes = torch.bincount(sym.mode.reshape(-1).long(), minlength=4).tolist()
    cmodes = torch.bincount(sym.cmode.reshape(-1).long(),
                            minlength=4).tolist()
    for key, err, ms, plain, nb, extra in (
            ("K7", err7, ms7, plain7, b7, f"from int32 planes (equal) "
             f"{ms7i:.4f} ms; luma modes V/H/DC/Plane {modes}, "
             f"chroma DC/H/V/Plane {cmodes}"),
            ("K8", err8, ms8, plain8, b8, f"the router around it "
             f"{router8:.4f} ms")):
        print(f"phase 2: {key} {what} ({list(planes[0].shape)}, QP {qp}, "
              f"{waves} waves; {wave_plan(h // 16, w // 16)}): equal to plain "
              f"(max_abs_err {err}); kernel "
              f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bound_ms(nb):.4f} "
              f"ms (bytes, {nb / 1e6:.2f} MB): "
              f"{100 * bound_ms(nb) / ms:.2f}% of the bound; "
              f"{wave_cycles(ms, mhz, waves):.0f} cycles a wave at {mhz} MHz; "
              f"{extra} [{card}]")
    return (err7, ms7, plain7, b7), (err8, ms8, plain8, b8)


def wave_edges(dev, torch, np):
    """K7 and K8 on every W_CASES entry: K7 against its plain version and
    from int32 planes, K8 on K7's symbols against its plain version and
    K7's recon, and K8 on those symbols with every MB's modes drawn at
    random among those legal there (`legal_modes`: the edges' missing
    neighbours read 0 only where no mode uses them), then among all four
    (`any_modes`: the edges' zeros and the column-0 corner predict), and
    K8 on K7's levels under random cbp (`masked_cbp`)."""
    for case in W_CASES:
        y, u, v, qp = wave_case(np, *case)
        planes = [torch.from_numpy(p).to(dev) for p in (y, u, v)]
        _, sym, rec = k7_equal(planes, qp, torch, f"edge case {case}")
        k7_int32_equal(planes, sym, rec, qp, torch, f"edge case {case}")
        k8_equal(sym, qp, torch, f"edge case {case}", rec)
        mode, cmode = legal_modes(np, np.random.default_rng(
            sum(case[0]) + qp), tuple(sym.mode.shape))
        rand = sym._replace(mode=torch.from_numpy(mode).to(dev),
                            cmode=torch.from_numpy(cmode).to(dev))
        k8_equal(rand, qp, torch, f"edge case {case}, random modes")
        mode, cmode = any_modes(np, np.random.default_rng(
            sum(case[0]) + qp + 1), tuple(sym.mode.shape))
        rand = sym._replace(mode=torch.from_numpy(mode).to(dev),
                            cmode=torch.from_numpy(cmode).to(dev))
        k8_equal(rand, qp, torch, f"edge case {case}, any modes")
        cbl, cbc = masked_cbp(np, np.random.default_rng(sum(case[0]) + qp),
                              tuple(sym.mode.shape))
        k8_equal(sym._replace(cbp_luma=torch.from_numpy(cbl).to(dev),
                              cbp_chroma=torch.from_numpy(cbc).to(dev)), qp,
                 torch, f"edge case {case}, masked levels")
    print(f"phase 2: K7 / K8 edge cases, {len(W_CASES)}: (S, R, C) "
          f"{list(W_SHAPES)} x {list(W_CONTENT)}, QPs {list(W_QPS)}; K7 also "
          f"from int32 planes, K8 also on random legal modes, on any "
          f"modes (0-3 at every MB, a column-0 Plane MB's corner included) "
          f"and on random cbp over the levels (the masks act): equal to "
          f"plain")


def wave_frames(dev, torch, np, w, h, s):
    """One frame of `s` streams of the "meeting" clip (stream i from clip
    frame i) at w x h, edge-padded to the MB grid as EncoderSession pads
    it, uint8 on `dev`."""
    from tpuh264_torch.engine.encoder import _pad_multiple

    return [torch.from_numpy(_pad_multiple(p, m)).to(dev)
            for p, m in zip(clip_streams(w, h, 1, s)[0], (16, 8, 8))]


def wave_rows(dev, torch, np, card, mhz):
    """K7 and K8 against their plain versions and timed: on phase 12's
    854x480 x 8 frame (the rows of the kernel table), on BASELINE config
    1's 640x360 (368) x 1 and on a 1920x1080 (1088) x 1 frame (the longest
    waves, 68 MBs), then on the edge cases."""
    rows = []
    for w, h, s, what in ((854, 480, 8, "854x480 x 8 (phase 12's frames)"),
                          (640, 360, 1, "640x360 x 1 (BASELINE config 1)"),
                          (1920, 1080, 1, "1920x1080 x 1 (long waves)")):
        got = wave_timed(wave_frames(dev, torch, np, w, h, s), 28, torch,
                         what, card, mhz)
        if not rows:
            rows = [kernel_row(
                "K7", "encode_iframe_single (single-slice wavefront encode)",
                "tpuh264_torch/csrc/wavefront.cu",
                "tpuh264/kernels/wavefront.py:284", *got[0]), kernel_row(
                "K8", "decode_iframe_single (single-slice wavefront decode)",
                "tpuh264_torch/csrc/wavefront.cu",
                "tpuh264/kernels/wavefront.py:435", *got[1])]
    wave_edges(dev, torch, np)
    return rows


def k5_bytes(kw) -> int:
    """D2 from the levels, what this run's data needs: is_intra in (a
    byte an MB, where given); an intra MB's mode, cmode and cbps (16 B)
    and the levels its cbps code (luma DC 32 B, luma AC 512 B where
    cbp_luma is 1, chroma DC 16 B where cbp_chroma >= 1, chroma AC 240 B
    where it is 2), but with `i44` an Intra_4x4 MB's every luma level
    (512 B) and its 16 int16 block modes (32 B) in place of the luma DC
    and AC, and the 576 B of tap words once; another MB's 1,536 bytes of
    `other` (the result depends on nothing else); every MB's 1,536 bytes
    of int32 output."""
    lev, n = kw["levels"], kw["mode"].numel()
    given = kw.get("is_intra") is not None
    intra = kw["is_intra"].bool() if given else kw["mode"] >= 0
    i44 = kw.get("i44") is not None
    i4 = intra & (kw["mode"] == 4) if i44 else intra & False
    cbl, cbc = lev.cbp_luma[intra & ~i4], lev.cbp_chroma[intra]
    n_intra, n_i4 = int(intra.sum()), int(i4.sum())
    levels = (32 * (n_intra - n_i4) + 512 * int((cbl == 1).sum())
              + 544 * n_i4 + 576 * i44
              + 16 * int((cbc >= 1).sum()) + 240 * int((cbc == 2).sum()))
    return (n if given else 0) + 16 * n_intra + levels + (
        n - n_intra) * 1536 + n * 1536


def d2_equal(kw, torch, what) -> int:
    """D2 against its plain version on one input; fails unless equal."""
    from tpuh264_torch.kernels import iframe

    k = iframe._intra_recon_scan(**kw)
    p = iframe._intra_recon_scan_plain(**kw)
    torch.cuda.synchronize()
    if not all(a.dtype == torch.int32 and torch.equal(a, b)
               for a, b in zip(k, p)):
        fail(f"D2 _intra_recon_scan differs from its plain version ({what})")
    return max(max_abs_err(a, b) for a, b in zip(k, p))


def d2_timed(kw, torch, what, card):
    """D2 equal to its plain version on `kw`, timed beside it: a line, and
    (max_abs_err, kernel ms, plain ms)."""
    from tpuh264_torch.kernels import iframe

    err = d2_equal(kw, torch, what)
    ms = timed(lambda: iframe._intra_recon_scan(**kw), 20)
    plain = timed(lambda: iframe._intra_recon_scan_plain(**kw), 1)
    bound = bound_ms(k5_bytes(kw))
    mode = kw["mode"]
    n_intra = (mode.numel() if kw.get("is_intra") is None
               else int(kw["is_intra"].sum()))
    print(f"phase 2: K5 (D2) {what} ({list(mode.shape)}, {n_intra} of "
          f"{mode.numel()} MBs intra): equal to plain (max_abs_err {err}); "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms "
          f"(bytes, {k5_bytes(kw) / 1e6:.1f} MB): "
          f"{100 * bound / ms:.1f}% of the bound [{card}]")
    return err, ms, plain


def d2_edges(dev, torch, np):
    """D2 on the seeded cases of `d2_case` (every D2_CASES and
    D2_RING_CASES entry)."""
    for case in D2_CASES + D2_RING_CASES:
        d2_equal(d2_args(torch, d2_case(np, *case), dev), torch,
                 f"edge case {case}")
    print(f"phase 2: K5 (D2) edge cases, {len(D2_CASES)}: (S, R, C) "
          f"{list(D2_SHAPES)} x {list(D2_VARIANTS)} (intra shares 0, ~1%, "
          f"50%, 100%, and the I decode; DC / H mixes, clips at 0 and 255; "
          f"H modes in column 0), and {len(D2_RING_CASES)} of the ring "
          f"(lanes of 97 intra columns, runs of intra and other, C = 1): "
          f"equal to plain")


def d2_rows(dev, torch, np, card, frames):
    """K5 (D2) against its plain version on the decoders' own inputs: the
    1080p x 4 P frame and IDR (`frames`: y, u, v, P symbols, I symbols)
    and the 480p x 8 default-config P frame (intra MBs required), and on
    the D2 cases; the 1080p P frame's row of the kernel table."""
    from tpuh264_torch.kernels import iframe, pframe

    for ln in ptxas_lines(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tpuh264_torch", "csrc",
            "intra_recon.cu")):
        print(f"phase 2: K5 ptxas: {ln}")
    y, u, v, sym, sym_i = frames
    refs = tuple(p[0].to(torch.int32)[None] for p in (y, u, v))
    p1080, = d2_capture(lambda: pframe.decode_pframe_rows_multi(
        sym, *refs, 30))
    err, ms, plain = d2_timed(p1080, torch, "1080p x 4 P frame", card)
    row = kernel_row(
        "K5", "_intra_recon_scan (D2, intra-reconstruction column scan)",
        "tpuh264_torch/csrc/intra_recon.cu",
        "tpuh264/kernels/pframe.py:1167", err, ms, plain, k5_bytes(p1080))
    del p1080
    idr, = d2_capture(lambda: iframe.decode_iframe_scan(sym_i, 30))
    d2_timed(idr, torch, "1080p x 4 IDR (decode_iframe_scan)", card)
    del idr
    # 8 frames on (as after dropped capture frames): 63 intra MBs in 11
    # of the 54 columns on the card (1 frame on: none)
    _, refs, sym, _, _ = pframe_480p(dev, torch, t8=False, gap=8)
    if not (sym.kind == 2).any():
        fail("D2 480p x 8: the default config coded no intra MB")
    p480, = d2_capture(lambda: pframe.decode_pframe_rows_multi(
        sym, *refs, 30))
    d2_timed(p480, torch, "480p x 8 'meeting' intra-in-P P frame, 8 "
             "frames on", card)
    del p480
    d2_edges(dev, torch, np)
    return row


def session_idr_i44(dev, np):
    """The decoders' own K5 inputs of phase 11's IDR (EncoderSession
    854x480 x 8 from RGBA, "meeting", intra44 + deblock, gop 8, CBR 1
    Mbps: frame 0 through DecoderPool.decode_batch), its Intra_4x4 MB
    share, and (the IDR's access units, the encoder's recon planes)."""
    from tpuh264_torch.engine import CodecConfig, DecoderPool, EncoderSession
    from tpuh264_torch.entropy import native

    w, h, s = 854, 480, 8
    enc = EncoderSession(CodecConfig(width=w, height=h, streams=s,
                                     intra44=True, deblock=True, gop_size=8,
                                     bitrate=1_000_000), device=dev)
    out = enc.encode_frame(clip_rgba(dev, w, h, 1, s)[0])
    pool = DecoderPool(device=dev)
    for i in range(s):
        pool.init_decoder(i)
    calls = d2_capture(lambda: pool.decode_batch(
        [(i, f.data) for i, f in enumerate(out)]))
    calls = [kw for kw in calls if kw.get("i44") is not None]
    if not out[0].is_idr or not calls:
        fail("D2 i44: the session's IDR decode made no call of K5's "
             "Intra_4x4 route")
    mb = [native.parse_iframe(f.data)[3][:, 0] for f in out]
    share = sum(int((m == 4).sum()) for m in mb) / sum(m.size for m in mb)
    if share <= 0:
        fail("D2 i44: the session's IDR coded no Intra_4x4 MB")
    return (max(calls, key=lambda kw: kw["mode"].numel()), share,
            ([(i, f.data) for i, f in enumerate(out)],
             [p.cpu().numpy() for p in enc.recon]))


def d2_i44_rows(dev, torch, np, card):
    """K5's Intra_4x4 route (`i44`) against its plain version: a 1920x1080
    (1088) x 4 IDR whose MBs are all Intra_4x4 (`d2_i44_case`, the row of
    the kernel table), the IDR of phase 11's session (the decoders' own
    inputs, `session_idr_i44`), every D2_I44 case and D2_I44_LEVEL_CASE."""
    kw = d2_args(torch, d2_i44_case(np, (4, 68, 120), "i44", 30), dev)
    err, ms, plain = d2_timed(kw, torch, "1080p x 4 IDR, every MB "
                              "Intra_4x4 (the i44 route)", card)
    row = kernel_row(
        "K5-i44", "_intra_recon_scan with i44 (D2's Intra_4x4 route, "
        "decode_iframe_scan with intra44)",
        "tpuh264_torch/csrc/intra_recon.cu", "tpuh264/kernels/iframe.py:372",
        err, ms, plain, k5_bytes(kw))
    del kw
    kw, share, _ = session_idr_i44(dev, np)
    d2_timed(kw, torch, f"854x480 x 8 'meeting' session IDR, Intra_4x4 "
             f"share {share:.4f} (the i44 route)", card)
    del kw
    for case in D2_I44_CASES + D2_I44_RING_CASES:
        d2_equal(d2_args(torch, d2_i44_case(np, *case), dev), torch,
                 f"i44 case {case}")
    print(f"phase 2: K5's Intra_4x4 route, {len(D2_I44_CASES)} + "
          f"{len(D2_I44_RING_CASES)} seeded cases (all-Intra_4x4 and mixed "
          f"columns, beside `other` too, modes outside 0..8, levels outside "
          f"cbp_luma, QPs {sorted(set(D2_I44_QPS))}, lanes past the ring): "
          f"equal to plain")
    case = d2_i44_case(np, *D2_I44_LEVEL_CASE)
    err = d2_equal(d2_args(torch, case, dev), torch,
                   f"i44 level case {D2_I44_LEVEL_CASE}")
    m = case[0]["i4modes"]
    differ = sum(int((m[..., a] != m[..., b]).sum())
                 for a, b in I44_LEVEL_PAIRS)
    print(f"phase 2: K5's Intra_4x4 route, level case {D2_I44_LEVEL_CASE}: "
          f"the two blocks of a two-block level of different modes in "
          f"{differ} of {len(I44_LEVEL_PAIRS) * m[..., 0].size} (MB, level) "
          f"pairs: equal to plain (max_abs_err {err})")
    return row


def k9_bytes(kw) -> int:
    """K9: the int32 source (y, u, v) and stage A's winners and global
    vectors in; for every reference the four uint8 half-pel planes and
    the two uint8 chroma planes over the frame's area (every MB searches
    every
    reference, and its 18x18 windows of the four planes tile the plane,
    so that is what the data needs; the planes' pads and the MC reads of
    the chosen reference add nothing new); per MB 8 int32 fields, 384
    int16 levels and the reconstruction (384 uint8 samples, or int32 with
    intra-in-P) out; writing the symbols (`out`), also the mvds, mode,
    cmode and t8 (int32) and the zero luma_dc (32 B); on the t8 route
    without `out`, t8 (int32).  The 8x8 trial reads nothing more: the
    source and the prediction are the 4x4 coding's."""
    src = sum(kw[k].numel() for k in ("y32", "u", "v", "iy0", "ix0", "gy",
                                      "gx"))
    frame = kw["y32"].numel()
    planes = len(kw["planes_l"]) * (4 * frame + 2 * (frame // 4))
    mbs = frame // 256
    sym = (5 * 4 + 32 if kw.get("out") is not None  # mvds, zero fields
           else 4 if kw.get("t8") else 0)
    return 4 * src + planes + mbs * (32 + sym + 768 + 384 * (
        4 if kw["intra_in_p"] else 1))


def k10_bytes(kw, motion) -> int:
    """K10, what this run's data needs: per MB six int32 flags and 384
    int16 levels in, and from its reference the half-pel planes its
    quarter-pel fraction reads (G alone for a whole-pel vector, else the
    planes of its two components), a 16x16 uint8 window each, and the two
    8x8 uint8 chroma windows; per MB the int32 reconstruction (384
    samples) and the two int32 MV components out; on the t8 route also
    the int32 t8 flag in.  `motion`: the call's (mvx, mvy)."""
    import torch

    from tpuh264_torch.kernels import pframe

    lut = pframe.tables.get("qpel_lut", motion[0].device)[..., 0]  # planes
    n_planes = 1 + (lut[:, 0] != lut[:, 1]).to(torch.int64)  # [16]
    mvx, mvy = motion
    reads = int(n_planes[((mvy & 3) * 4 + (mvx & 3)).long()].sum())
    mbs = mvx.numel()
    return 256 * reads + mbs * (2 * 64 + 24 + 768 + 1536 + 8
                                + 4 * bool(kw.get("t8")))


def _all_equal(k, p, torch, what) -> int:
    """Every output tensor of a kernel equal to its plain version's (dtype
    and values); fails unless so.  Returns the max_abs_err."""
    torch.cuda.synchronize()
    if len(k) != len(p) or not all(a.dtype == b.dtype and a.shape == b.shape
                                   and torch.equal(a, b)
                                   for a, b in zip(k, p)):
        fail(f"{what} differs from its plain version")
    return max(max_abs_err(a, b) for a, b in zip(k, p))


def k9_equal(kw, torch, what) -> int:
    """K9 (`_inter_encode`) against its plain version on one input, every
    field and the reconstruction."""
    from tpuh264_torch.kernels import pframe

    flat = lambda o: [*o[:-1], *o.rec]
    return _all_equal(flat(pframe._inter_encode(**kw)),
                      flat(pframe._inter_encode_plain(**plain_args(kw))),
                      torch, f"K9 _inter_encode ({what})")


def plain_args(kw):
    """`_inter_encode`'s captured arguments less `out` (the symbol
    buffers K9 may write; its plain version leaves them to its caller)."""
    return {k: v for k, v in kw.items() if k != "out"}


def k10_equal(kw, torch, what) -> int:
    """K10 (`_inter_decode`) against its plain version on one input: the
    reconstruction and the motion."""
    from tpuh264_torch.kernels import pframe

    flat = lambda o: [*o[0], *o[1]]
    return _all_equal(flat(pframe._inter_decode(**kw)),
                      flat(pframe._inter_decode_plain(**kw)), torch,
                      f"K10 _inter_decode ({what})")


def pframe_2ref(frames, qp, torch, t8=False, deblocked=True):
    """Three frames ([y, u, v] tensors on the card) at QP `qp`: an I frame,
    a P frame against it, then a P frame against both (newest first), all
    with intra-in-P and, where `t8`, the 8x8 transform's choice; each
    reference deblocked where `deblocked`.  Returns the last encode's and
    its decode's arguments of `_inter_encode` / `_inter_decode` (dicts),
    its MB kinds (skip, inter, intra) and its count of t8 MBs."""
    from tpuh264_torch.kernels import deblock, iframe, pframe

    _, rec = iframe.encode_iframe_rows(*frames[0], qp)
    if deblocked:
        rec = deblock.deblock_i(rec, qp)
    dpb = [[p.to(torch.int32) for p in rec]]
    sym, rec, mot = pframe.encode_pframe_rows_multi(
        *frames[1], *(p[None] for p in dpb[0]), qp, t8=t8, intra_in_p=True)
    if deblocked:
        rec = deblock.deblock_p(rec, sym, mot, qp, t8=t8)
    dpb.insert(0, [p.to(torch.int32) for p in rec])
    refs = [torch.stack(p) for p in zip(*dpb)]
    out = []
    enc, = capture(pframe, "_inter_encode", lambda: out.append(
        pframe.encode_pframe_rows_multi(*frames[2], *refs, qp, t8=t8,
                                        intra_in_p=True)))
    sym = out[0][0]
    dec, = capture(pframe, "_inter_decode",
                   lambda: pframe.decode_pframe_rows_multi(sym, *refs, qp,
                                                           t8=t8))
    kinds = torch.bincount(sym.kind.reshape(-1), minlength=3).tolist()
    return enc, dec, kinds, int((sym.t8 == 1).sum())


def pframe_480p_2ref(dev, torch, t8=False):
    """A 854x480 x 8 (864 wide) default-config P frame with two references
    (`pframe_2ref`): the "meeting" clip at QP 30, each reference
    deblocked; with `t8`, config 3 part B's toolset.  Returns the last
    encode's and its decode's arguments of `_inter_encode` /
    `_inter_decode` (dicts) and its MB kinds (skip, inter, intra)."""
    frames = [[torch.from_numpy(p).to(dev) for p in f]
              for f in clip_streams(864, 480, 3, 8)]
    return pframe_2ref(frames, 30, torch, t8)[:3]


def pframe_config3(dev, torch):
    """BASELINE config 3's P frame at its shapes (`pframe_2ref` with t8):
    1920x1080 x 1 (1088 rows) of "rigid" at QP 30, two references, no
    deblock (config 3's session codes none).  Returns the encode's and
    decode's arguments, the MB kinds and the count of t8 MBs."""
    from tpuh264_torch.engine.sources import device_source_gop

    y, u, v = device_source_gop(1920, 1088, 3, 1, "rigid", 0, dev)
    return pframe_2ref([[y[t], u[t], v[t]] for t in range(3)], 30, torch,
                       t8=True, deblocked=False)


def p_timed(key, kw, torch, what, card):
    """K9 or K10 equal to its plain version on `kw`, timed beside it: a
    line, and (max_abs_err, kernel ms, plain ms, bytes)."""
    from tpuh264_torch.kernels import pframe

    if key == "K9":
        err = k9_equal(kw, torch, what)
        fn, plain_fn, nbytes = (pframe._inter_encode,
                                pframe._inter_encode_plain, k9_bytes(kw))
    else:
        err = k10_equal(kw, torch, what)
        fn, plain_fn, nbytes = (pframe._inter_decode,
                                pframe._inter_decode_plain,
                                k10_bytes(kw, pframe._inter_decode(**kw)[1]))
    ms = timed(lambda: fn(**kw), 20)
    plain = timed(lambda: plain_fn(**plain_args(kw)), 2)
    bound = bound_ms(nbytes)
    print(f"phase 2: {key} {what}: equal to plain (max_abs_err {err}); "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms, bound {bound:.4f} ms "
          f"(bytes, {nbytes / 1e6:.1f} MB): {100 * bound / ms:.2f}% of the "
          f"bound [{card}]")
    return err, ms, plain, nbytes


def capture_all(module, names, fn):
    """{name: `capture(module, name, ...)`} for each of `names`, over one
    run of `fn()`."""
    if not names:
        fn()
        return {}
    out = {}
    out[names[0]] = capture(module, names[0], lambda: out.update(
        capture_all(module, names[1:], fn)))
    return out


def k11_bytes(kw) -> int:
    """K11: the references in (int32 or uint8, each sample read once), the
    samples of the four uint8 half-pel planes and the two uint8 chroma
    planes of each out (not their pitch bytes)."""
    from tpuh264_torch.kernels import pframe

    ins, _, ints = pframe._k11_operands(**kw)
    n, s, hs, w, oy, hcs, wc, oyc = ints[:8]
    return (sum(x.numel() * x.element_size() for x in ins if x is not None)
            + n * s * (4 * (hs + 2 * oy) * (w + 2 * pframe._PE)
                       + 2 * (hcs + 2 * oyc) * (wc + 2 * pframe._CP)))


def k12_bytes(kw) -> int:
    """K12: the SAD table in (read once), the winners and the global
    vectors out, int32."""
    s, r, c, nn = kw["sads"].shape
    return 4 * (s * r * c * (nn + 2) + 2 * s)


def k12_phases(pframe, cuda_lib, kw, blocks=None):
    """K12's two launches apart on `kw`'s table (`_int_winner`'s
    arguments), through the entry of the tree whose modules `pframe` and
    `cuda_lib` are (at `blocks` blocks where given): (phase 1, phase 2)
    callables on one set of operands, phase 1 run once first so that
    phase 2 reads real counts (a repeated phase 1 adds to them: the mode
    stays)."""
    more = () if blocks is None else (blocks,)
    ins, outs, ints = pframe._k12_operands(kw["sads"], kw["lam"], *more)
    lib = cuda_lib.load()
    ptrs = cuda_lib.pointers(ins + outs)
    args = {ph: cuda_lib.ints(ints + [ph]) for ph in (1, 2)}
    stream = cuda_lib.stream(kw["sads"].device)

    def run(ph):
        cuda_lib.check(lib.th264_me_winner(ptrs, args[ph], stream),
                       "th264_me_winner")
        return ins, outs  # held by the closure for as long as it lives

    run(1)
    return (lambda: run(1)), (lambda: run(2))


def k12_phase_line(kw, torch, what, card):
    """Each K12 phase's ms on `kw` (`k12_phases`) beside the bound of its
    own bytes (one read of the table; phase 2 also writes the winners):
    a line, and (phase 1 ms, phase 2 ms)."""
    from tpuh264_torch.kernels import cuda_lib, pframe

    one, two = k12_phases(pframe, cuda_lib, kw)
    ms = [timed(one, 20), timed(two, 20)]
    s, r, c, nn = kw["sads"].shape
    b1 = bound_ms(4 * (s * r * c * nn + s * nn))
    b2 = bound_ms(k12_bytes(kw))
    print(f"phase 2: K12 {what}, by phase: phase 1 {ms[0]:.4f} ms "
          f"({100 * b1 / ms[0]:.1f}% of its bound {b1:.4f} ms), phase 2 "
          f"{ms[1]:.4f} ms ({100 * b2 / ms[1]:.1f}% of {b2:.4f} ms) "
          f"[{card}]")
    return ms


def k11_library(refs_y, refs_u, refs_v, halo):
    """K11's closest formulation in library calls (its table row's
    "library call"; the port never calls it): replicate F.pad, float32
    conv2d with the 6-tap filters (b and h from the samples, j from b's
    unrounded sums; TF32 off, so exact), rounded, clamped and narrowed to
    uint8, as K11's planes are; chroma replicate F.pad.  Returns ([N, 4,
    S, Hp, Wp], [N, 2, S, Hcp, Wcp]) uint8 (contiguous rows: no library
    call writes a pitch)."""
    import torch
    import torch.nn.functional as F

    from tpuh264_torch.kernels import pframe

    refs_y, refs_u, refs_v = (x if torch.is_tensor(x) else torch.stack(
        list(x)) for x in (refs_y, refs_u, refs_v))  # a ring's slots
    n, s, hs, w = refs_y.shape
    oy, oyc = (0, 0) if halo else (pframe.HALO_Y, pframe.HALO_C)
    pe, cp = pframe._PE, pframe._CP
    x = refs_y.reshape(n * s, 1, hs, w).float()
    x = F.pad(x, (pe + 3, pe + 3, oy + 3, oy + 3), mode="replicate")
    tap = torch.tensor([1., -5., 20., 20., -5., 1.], device=x.device)
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        b1 = F.conv2d(x, tap.view(1, 1, 1, 6))        # [.., Hp + 6, Wp + 1]
        h1 = F.conv2d(x, tap.view(1, 1, 6, 1))        # [.., Hp + 1, Wp + 6]
        j1 = F.conv2d(b1, tap.view(1, 1, 6, 1))       # [.., Hp + 1, Wp + 1]
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    g = x[..., 3:-3, 3:-3]
    b = ((b1[..., 3:-3, 1:] + 16) / 32).floor().clamp(0, 255)
    h = ((h1[..., 1:, 3:-3] + 16) / 32).floor().clamp(0, 255)
    j = ((j1[..., 1:, 1:] + 512) / 1024).floor().clamp(0, 255)
    planes = torch.stack([g, b, h, j], 1).to(torch.uint8)
    hp, wp = planes.shape[-2:]
    c = torch.stack([F.pad(p.reshape(n * s, 1, *p.shape[-2:]).float(),
                           (cp, cp, oyc, oyc), mode="replicate")
                     for p in (refs_u, refs_v)], 1).to(torch.uint8)
    return (planes.reshape(n, s, 4, hp, wp).transpose(1, 2),
            c.reshape(n, s, 2, *c.shape[-2:]).transpose(1, 2))


def k11_equal(kw, torch, what) -> int:
    """K11 (`_references`) against its plain version on one input, every
    plane of every reference, and in its layout: uint8, the same row
    pitch (a multiple of 16 bytes) and every plane 16-byte aligned."""
    from tpuh264_torch.kernels import pframe

    flat = lambda o: [*o[0], *o[1], *o[2]]
    got = flat(pframe._references(**kw))
    want = flat(pframe._references_plain(**kw))
    if any(a.stride() != b.stride() or a.stride(-2) % 16
           or a.data_ptr() % 16 for a, b in zip(got, want)):
        fail(f"K11 _references ({what}): planes not in the plain "
             f"version's layout: {[a.stride() for a in got]}")
    return _all_equal(got, want, torch, f"K11 _references ({what})")


def k12_equal(kw, torch, what, blocks=None) -> int:
    """K12 (`_int_winner`) against its plain version on one input; with
    `blocks`, its launches (`_k12_launch`) at that grid instead (a
    K12_CASES grid)."""
    from tpuh264_torch.kernels import pframe

    got = (pframe._int_winner(**kw) if blocks is None
           else pframe._k12_launch(**kw, blocks=blocks))
    return _all_equal(list(got), list(pframe._int_winner_plain(**kw)),
                      torch, f"K12 _int_winner ({what})")


def ref_timed(key, kw, torch, what, card):
    """K11 or K12 equal to its plain version on `kw`, timed beside it (K11
    also beside `k11_library`): a line, and (max_abs_err, kernel ms, plain
    ms, bytes, library ms or None)."""
    from tpuh264_torch.kernels import pframe

    lib = None
    if key == "K11":
        err = k11_equal(kw, torch, what)
        fn, plain_fn, nbytes = (pframe._references,
                                pframe._references_plain, k11_bytes(kw))
        got = k11_library(**kw)
        want = pframe._references_plain(**kw)
        lib_err = max(max(max_abs_err(got[0][i], want[0][i]),
                          max_abs_err(got[1][i, 0], want[1][i]),
                          max_abs_err(got[1][i, 1], want[2][i]))
                      for i in range(len(want[0])))
        lib = timed(lambda: k11_library(**kw), 10)
    else:
        err = k12_equal(kw, torch, what)
        fn, plain_fn, nbytes = (pframe._int_winner, pframe._int_winner_plain,
                                k12_bytes(kw))
    ms = timed(lambda: fn(**kw), 20)
    plain = timed(lambda: plain_fn(**kw), 3)
    bound = bound_ms(nbytes)
    extra = ("" if lib is None else f", library formulation {lib:.4f} ms "
             f"(max_abs_err {lib_err} against the plain version)")
    print(f"phase 2: {key} {what}: equal to plain (max_abs_err {err}); "
          f"kernel {ms:.4f} ms, plain {plain:.3f} ms{extra}, bound "
          f"{bound:.4f} ms (bytes, {nbytes / 1e6:.1f} MB): "
          f"{100 * bound / ms:.2f}% of the bound [{card}]")
    return err, ms, plain, nbytes, lib


def ref_edges(dev, torch, np):
    """K11 and K12 on their seeded cases (`K11_CASES`, `K12_CASES`); K12's
    cases with a group sum a second table's counts in between its
    phases, as the row-sharded encode's all_reduce does (its plain
    version the same)."""
    from tpuh264_torch.kernels import pframe

    for case in K11_CASES:
        refs_y, refs_u, refs_v, halo = k11_case(np, *case)
        t = lambda x: torch.from_numpy(x).to(dev)
        k11_equal(dict(refs_y=t(refs_y), refs_u=t(refs_u), refs_v=t(refs_v),
                       halo=halo), torch, f"edge case {case}")
    reduce = pframe.all_reduce
    try:
        for case in K12_CASES:
            sads, lam, other = k12_case(np, *case)
            kw = dict(sads=torch.from_numpy(sads).to(dev), lam=lam)
            if other is not None:
                extra = k12_counts(torch, torch.from_numpy(other).to(dev),
                                   lam)
                pframe.all_reduce = lambda x, g: x.add_(extra.to(x.dtype))
                kw["group"] = "another band"
            k12_equal(kw, torch, f"edge case {case}", case[4])
            pframe.all_reduce = reduce
    finally:
        pframe.all_reduce = reduce
    print(f"phase 2: K11 / K12 equal to their plain versions on "
          f"{len(K11_CASES)} / {len(K12_CASES)} seeded edge cases")


def k12_counts(torch, sads, lam):
    """The phase-1 counts [S, 289] of a SAD table (what a band adds to
    the group's all_reduce), by the plain version's formulas."""
    from tpuh264_torch.kernels import pframe

    cost = 4 * sads + lam * pframe.tables.get("rate0", sads.device)
    win = pframe._argmin_first(cost).reshape(sads.shape[0], -1)
    counts = torch.zeros((sads.shape[0], pframe._NN), dtype=torch.int64,
                         device=sads.device)
    return counts.scatter_add_(1, win, torch.ones_like(win))


def record_views(sym, torch):
    """The P symbols `sym` as the GOP decode holds them: strided views of
    one [.., 9] int32 MB-field record and one [.., 400] int16
    coefficient-slot record (`devpipe.record_symbols`)."""
    from tpuh264_torch.engine import devpipe

    lead = sym.kind.shape
    m = torch.stack([sym.kind, sym.mode, sym.cmode, sym.cbp_luma,
                     sym.cbp_chroma, sym.mvdx, sym.mvdy, sym.refidx,
                     torch.zeros_like(sym.kind)], -1).to(torch.int32)
    cf = torch.cat([sym.luma_dc, sym.luma_ac.reshape(*lead, 256),
                    sym.chroma_dc.reshape(*lead, 8),
                    sym.chroma_ac.reshape(*lead, 120)], -1).to(torch.int16)
    return devpipe.record_symbols(m, cf)


def k9_out_equal(kw, torch, what, fn=None) -> int:
    """K9 (`fn`, by default `_inter_encode`) writing the symbols into
    `empty_symbols` buffers (the mvds by pairs) against the fields its
    plain version gives (t8 too: 0 but on the t8 route), the mvds those
    of its vectors against the left MB's, and mode, cmode, luma_dc 0."""
    from tpuh264_torch.kernels import pframe

    s, r, c = kw["iy0"].shape[1:]
    buf = pframe.empty_symbols((s,), r, c, kw["iy0"].device)
    (fn or pframe._inter_encode)(**dict(kw, out=buf))
    p = pframe._inter_encode_plain(**plain_args(kw))
    left = lambda mv: torch.nn.functional.pad(mv, (1, 0))[..., :-1]
    zero = torch.zeros_like(p.kind)
    want = pframe.MBSymbolsP(
        kind=p.kind, mode=zero, cmode=zero, cbp_luma=p.cbp_luma,
        cbp_chroma=p.cbp_chroma, mvdx=p.mvx - left(p.mvx),
        mvdy=p.mvy - left(p.mvy),
        luma_dc=torch.zeros_like(buf.luma_dc), luma_ac=p.luma_ac,
        chroma_dc=p.chroma_dc, chroma_ac=p.chroma_ac, refidx=p.refidx,
        t8=p.t8)
    return _all_equal(list(buf), list(want), torch,
                      f"K9's symbols ({what})")


def device_events(fn, torch) -> list:
    """The names of the device's events (kernels, copies, memsets) of one
    call of `fn()`, under torch.profiler, in their order."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [n for _, n in sorted({(e.time_range.start, e.name)
                                  for e in prof.events()
                                  if e.device_type == DeviceType.CUDA})]


def mvd_bytes(mvx) -> int:
    """The mvds of K9's symbols, as a function of their own: two int32
    vector components in and two mvd components out a MB (the left MB's
    vector is its neighbour's, read once)."""
    return 16 * mvx.numel()


def k9_symbols_check(y, u, v, sym, torch, card):
    """K9 writing the frame's symbols itself (the main path's route: the
    fields into `empty_symbols` buffers, the mvds by pairs, the zero
    fields) equal, field for field, to the symbols assembled around K9's
    plain outputs (`sym`, the same frame's encode without them); the
    launch timed both ways, the device events of one call (one kernel),
    and the mvds as a function of their own: K9's mvds equal to torch.diff
    of its own vectors, and their bound, their plain version and torch.diff
    timed on those vectors."""
    from tpuh264_torch.kernels import pframe

    s, r, c = sym.kind.shape
    buf = pframe.empty_symbols((s,), r, c, y.device)
    refs = ([y[0]], [u[0]], [v[0]])
    kws = capture(pframe, "_inter_encode", lambda: (
        pframe.encode_pframe_rows_multi(y[1], u[1], v[1], *refs, 30,
                                        intra_in_p=False, out=buf)))
    torch.cuda.synchronize()
    err = _all_equal(list(buf), list(sym), torch,
                     "K9's symbols (empty_symbols) vs the assembled ones")
    kw = kws[0]
    events = device_events(lambda: pframe._inter_encode(**kw), torch)
    k9 = [e for e in events if "pframe_" in e]
    if len(k9) != 1 or "pframe_encode_kernel" not in k9[0]:
        fail(f"K9 writing the symbols launched {k9} on the card, not its "
             f"one kernel")
    ms = timed(lambda: pframe._inter_encode(**kw), 20)
    ms0 = timed(lambda: pframe._inter_encode(**dict(kw, out=None)), 20)
    print(f"phase 2: K9 writing the 1080p x 4 P frame's symbols (13 fields, "
          f"the mvds by pairs): equal to the assembled symbols (max_abs_err "
          f"{err}); its entry launches one kernel ({len(events) - 1} other "
          f"device events a call: the router's casts of the chroma to "
          f"int32); K9 {ms:.4f} ms with them, {ms0:.4f} ms without "
          f"[{card}]")
    res = pframe._inter_encode(**kw)
    mv = torch.stack([res.mvx, res.mvy])
    zero = torch.zeros_like(mv[..., :1])
    plain = timed(lambda: mv - torch.nn.functional.pad(mv, (1, 0))[..., :-1],
                  20)
    lib = timed(lambda: torch.diff(mv, dim=-1, prepend=zero), 20)
    if not torch.equal(torch.diff(mv, dim=-1, prepend=zero),
                       torch.stack([buf.mvdx, buf.mvdy])):
        fail("torch.diff of K9's vectors differs from the mvds it wrote")
    print(f"phase 2: the mvds as a function of their own (K9's former "
          f"second launch), 1080p x 4 P frame: bound "
          f"{bound_ms(mvd_bytes(buf.mvdx)):.5f} ms (bytes), plain "
          f"{plain:.4f} ms, torch.diff {lib:.4f} ms [{card}]")


def k10_copy_check(kw, torch, card):
    """K10 on the record views (no operand copy) against its plain version,
    and timed beside K10 on contiguous copies of the same symbols."""
    from tpuh264_torch.kernels import pframe

    err = k10_equal(kw, torch, "1080p x 4 P frame, record views")
    sym = kw["symbols"]
    flat = pframe.MBSymbolsP(*[None if x is None else x.contiguous()
                               for x in sym])
    copied = dict(kw, symbols=flat)
    ms = timed(lambda: pframe._inter_decode(**kw), 20)
    ms_c = timed(lambda: pframe._inter_decode(**copied), 20)
    ins = pframe._k10_operands(sym, kw["planes_l"], kw["refs_up"],
                               kw["refs_vp"], kw["qp"])[0]
    shared = sum(x.data_ptr() == y.data_ptr() for x, y in zip(ins, (
        sym.kind, sym.mvdx, sym.mvdy, sym.refidx, sym.cbp_luma,
        sym.cbp_chroma, sym.luma_ac, sym.chroma_dc, sym.chroma_ac)))
    if shared != 9:
        fail(f"K10's operands copied {9 - shared} of the record views")
    print(f"phase 2: K10 on the record views (strided, 9 of 9 fields in "
          f"place): equal to plain (max_abs_err {err}); {ms:.4f} ms, on "
          f"contiguous symbols {ms_c:.4f} ms [{card}]")


def k11_ring_check(y, u, v, torch, card):
    """K11 reading the references by pointer from a two-slot uint8 DPB
    ring whose head is slot 1 (newest first: slots 1, 0) equal to its
    plain version on the stacked references."""
    from tpuh264_torch.engine import devpipe

    ring = tuple(torch.stack([p[0], p[1]]) for p in (y, u, v))
    kw = dict(zip(("refs_y", "refs_u", "refs_v"),
                  devpipe.dpb_refs(ring, 1, 2)), halo=False)
    err = k11_equal(kw, torch, "a two-slot ring, head at slot 1")
    print(f"phase 2: K11 by pointer on a two-slot uint8 ring (head slot 1): "
          f"equal to plain (max_abs_err {err}) [{card}]")


# P1 (the probe's bit operations): values at the edges of every term -- the
# signed compare's 5 / 6, the shift's 0..8, the sign bit, INT_MIN /
# INT_MAX, values whose left shift drops set bits and whose sum wraps
# (0x3FFFFFFF passes INT_MAX, 0x7FFFFFFF 2^32) --, every value of
# [-64, 64] and 2^k - 1, 2^k, 2^k + 1 and their negations
P1_EDGES = tuple(sorted(
    {0, 1, 5, 6, 7, 8, -1, -8, -2**31, 2**31 - 1, 0x3FFFFFFF, 0x00FFFFFF,
     0x01000007, -2**31 + 7}
    | set(range(-64, 65))
    | {((s * ((1 << k) + d) + 2**31) % 2**32) - 2**31
       for k in range(32) for d in (-1, 0, 1) for s in (1, -1)}))
# (name, shape, view offset in elements, grid cap on CPU threads): the
# script's input; tails of 1-3 elements past the 16-byte chunks; fewer
# elements than a chunk; offset views (4: still 16-byte aligned; 1, 3:
# the scalar route on the card); a grid of one block, so that the
# grid-stride loop turns
P1_CASES = [("script", (8, 128), 0, 8), ("edges", (1, 1027), 0, 8),
            ("random", (64, 128), 0, 8), ("tail", (4097,), 0, 8),
            ("tail", (4098,), 0, 8), ("short", (3,), 0, 8),
            ("offset", (1031,), 4, 8), ("offset", (1030,), 1, 8),
            ("offset", (1029,), 3, 8), ("grid", (12291,), 0, 1)]
# P2 (the slab sum), (name, (M, L), view offset, grid cap): the script's
# input; full-range values; values near +-2^31, so that every sum wraps;
# ragged M * L (not a multiple of 4: the scalar route); offset views; a
# grid of one block
P2_CASES = [("script", (32, 128), 0, 8), ("random", (32, 128), 0, 8),
            ("wrap", (32, 128), 0, 8), ("ragged", (3, 5), 0, 8),
            ("ragged", (1, 1), 0, 8), ("ragged", (7, 9), 0, 8),
            ("offset", (8, 128), 4, 8), ("offset", (8, 128), 1, 8),
            ("grid", (40, 128), 0, 1)]


def p1_case(np, name, shape, seed=0):
    """Seeded P1 input (numpy int32 of `shape`): the script's arange, or
    full-range values with P1_EDGES first."""
    n = int(np.prod(shape))
    if name == "script":
        return np.arange(n, dtype=np.int32).reshape(shape)
    rng = np.random.default_rng([seed, n])
    x = rng.integers(-2**31, 2**31, n)
    e = np.array(P1_EDGES[:n])
    x[:e.size] = e
    return x.astype(np.int32).reshape(shape)


def p2_case(np, name, ml, seed=0):
    """Seeded P2 input (numpy int32 [16, M, L]): the script's arange,
    full-range values, or values within 2^24 of +-2^31."""
    m, l = ml
    if name == "script":
        return np.arange(16 * m * l, dtype=np.int32).reshape(16, m, l)
    rng = np.random.default_rng([seed, m, l])
    if name == "wrap":
        x = rng.integers(2**31 - 2**24, 2**31 + 2**24, (16, m, l))
        x = np.where(rng.random(x.shape) < 0.5, x, -x)
        return ((x + 2**31) % 2**32 - 2**31).astype(np.int32)
    return rng.integers(-2**31, 2**31, (16, m, l)).astype(np.int32)


def offset_view(torch, a, offset, dev):
    """numpy `a` as a tensor on `dev` that starts `offset` elements into
    its storage (contiguous)."""
    flat = torch.zeros(a.size + offset + 8, dtype=torch.int32, device=dev)
    flat[offset:offset + a.size] = torch.from_numpy(a.reshape(-1)).to(dev)
    return flat[offset:offset + a.size].view(a.shape)


P1_BOUND_N = 1 << 24  # P1's byte-bound shape: 64 MiB in, 64 MiB out
P2_BOUND_ML = (1024, 1024)  # P2's: [16, 1024, 1024], 64 MiB in, 4 MiB out


def probe_rows(dev, torch, np, card):
    """P1 and P2 against their plain versions on the card (max_abs_err 0)
    at the probe's shapes, on every P1_CASES / P2_CASES case and at a
    shape where bytes bind (P1_BOUND_N, P2_BOUND_ML: seeded full-range
    values made on the card); their rows of the kernel table at the
    byte-bound shapes, the probe's shapes printed beside them.  P2's
    library call is torch.sum(lv, 0, dtype=torch.int32)."""
    from tpuh264_torch.kernels import probe

    for ln in ptxas_lines(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tpuh264_torch", "csrc",
            "probe.cu")):
        print(f"phase 2: probe.cu ptxas: {ln}")
    fns = {"P1": (probe.probe_bits, probe._probe_bits_plain),
           "P2": (probe.slab_sum, probe._slab_sum_plain)}

    def equal(key, x, what):
        kernel, plain = fns[key]
        got, want = kernel(x), plain(x)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            fail(f"{key} differs from its plain version on {what}")
        return max_abs_err(got, want)

    for key, cases, make in (("P1", P1_CASES, p1_case),
                             ("P2", P2_CASES, p2_case)):
        for case in cases:
            equal(key, offset_view(torch, make(np, *case[:2]), case[2], dev),
                  f"case {case[:3]}")
    g = torch.Generator(device=dev).manual_seed(0)
    big = {"P1": (P1_BOUND_N,), "P2": (16, *P2_BOUND_ML)}
    probe_in = {"P1": (8, 128), "P2": (16, 32, 128)}
    names = {"P1": "probe_bits (the probe's bit operations)",
             "P2": "slab_sum (the probe's sum of 16 slabs)"}
    rows = []
    for key in ("P1", "P2"):
        kernel, plain = fns[key]
        n = int(np.prod(probe_in[key]))
        small = torch.arange(n, dtype=torch.int32,
                             device=dev).reshape(probe_in[key])
        x = torch.randint(-2**31, 2**31, big[key], generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
        rs = []
        for t, what in ((x, f"{list(x.shape)} int32"),
                        (small, f"the probe's {list(small.shape)}")):
            out_bytes = 4 * (t.numel() if key == "P1" else t[0].numel())
            r = kernel_row(key, f"{names[key]}, {what}",
                           "tpuh264_torch/csrc/probe.cu",
                           "tools/pallas_smoke.py:18" if key == "P1"
                           else "tools/pallas_smoke.py:41",
                           equal(key, t, what), timed(lambda: kernel(t), 50),
                           timed(lambda: plain(t), 5),
                           4 * t.numel() + out_bytes)
            if key == "P2":
                lib = torch.sum(t, 0, dtype=torch.int32)
                if not torch.equal(lib, plain(t)):
                    fail(f"P2's library call differs on {what}")
                r["library_ms"] = timed(
                    lambda: torch.sum(t, 0, dtype=torch.int32), 50)
            rs.append(r)
        del x, small
        show(rs[0], f"a byte-bound shape [{card}]")
        show(rs[1], f"the probe's own shape, launch latency [{card}]")
        rows.append(rs[0])
    print(f"phase 2: P1 / P2 equal to their plain versions on "
          f"{len(P1_CASES)} / {len(P2_CASES)} seeded cases (tails, fewer "
          f"elements than a chunk, offset views 16-byte aligned and not, "
          f"ragged M * L, edge values and sums that wrap)")
    return rows


def p_rows(dev, torch, np, card):
    """K9-K12: the rows of the kernel table on the main path's 1080p x 4
    RTC P frame (one reference, a uint8 DPB slot: its encode's K9 writing
    the symbols, reference build K11 and stage-A winner K12) and its
    decode (K10 on the record views), a line each on K9's symbols, K10's
    record views, K11 on a two-slot ring, that decode's reference build
    and the 480p x 8 default-config P frame with two references (its
    encode's and decode's), then the seeded edge cases (`K9_CASES`, K9
    also writing the symbols; `K10_CASES`, also on record views;
    `K11_CASES`, `K12_CASES`)."""
    from tpuh264_torch.kernels import pframe

    for src in ("pframe_enc.cu", "pframe_dec.cu", "halfpel.cu",
                "me_winner.cu", "cavlc_prologue.cu", "sse.cu"):
        for ln in ptxas_lines(os.path.join(os.path.dirname(
                os.path.abspath(__file__)), "tpuh264_torch", "csrc", src)):
            print(f"phase 2: {src} ptxas: {ln}")
    out = []
    names = ("_inter_encode", "_references", "_int_winner")
    got = capture_all(pframe, names,
                      lambda: out.append(pframe_1080p(dev, torch)))
    (enc,), (ref_e,), (win,) = (got[n] for n in names)
    y, u, v, sym = out[0][:4]
    k9_symbols_check(y, u, v, sym, torch, card)
    # K9's row as the main path launches it: writing the symbols
    enc = dict(enc, out=pframe.empty_symbols(sym.kind.shape[:1],
                                             *sym.kind.shape[1:], y.device))
    # the decode as the GOP pipeline runs it: the parsed records' views
    # (K10 reads them with their MB strides), the reference a DPB slot
    refs = ([y[0]], [u[0]], [v[0]])
    got = capture_all(pframe, ("_inter_decode", "_references"),
                      lambda: pframe.decode_pframe_rows_multi(
                          record_views(sym, torch), *refs, 30))
    (dec,), (ref_d,) = got["_inter_decode"], got["_references"]
    k10_copy_check(dec, torch, card)
    k11_ring_check(y, u, v, torch, card)
    del out, y, u, v, sym, refs
    rows = []
    for key, kw, name, source, replaces in (
            ("K9", enc, "encode_pframe_rows_multi after stage A "
             "(_inter_encode: refine, reference choice, MC, inter coding)",
             "tpuh264_torch/csrc/pframe_enc.cu",
             "tpuh264/kernels/pframe.py:638"),
            ("K10", dec, "decode_pframe_rows_multi's inter part "
             "(_inter_decode: MV chain, MC, inter residuals)",
             "tpuh264_torch/csrc/pframe_dec.cu",
             "tpuh264/kernels/pframe.py:1021")):
        rows.append(kernel_row(key, name, source, replaces, *p_timed(
            key, kw, torch, "1080p x 4 RTC P frame, one reference", card)))
    for key, kw, name, source, replaces in (
            ("K11", ref_e, "_references (the half-pel planes and padded "
             "chroma of every reference)", "tpuh264_torch/csrc/halfpel.cu",
             "tpuh264/kernels/pframe.py:111"),
            ("K12", win, "_int_winner (the two-phase stage-A winner)",
             "tpuh264_torch/csrc/me_winner.cu",
             "tpuh264/kernels/pframe.py:332")):
        err, ms, plain, nbytes, lib = ref_timed(
            key, kw, torch, "1080p x 4 RTC P frame's encode, one reference",
            card)
        rows.append(dict(kernel_row(key, name, source, replaces, err, ms,
                                    plain, nbytes), library_ms=lib))
        if key == "K12":
            k12_phase_line(kw, torch, "1080p x 4 RTC P frame's encode, one "
                           "reference", card)
    ref_timed("K11", ref_d, torch, "1080p x 4 RTC P frame's decode", card)
    del enc, dec, ref_e, ref_d, win
    got = {}
    caps = capture_all(pframe, ("_references", "_int_winner"),
                       lambda: got.update(p=pframe_480p_2ref(dev, torch)))
    enc, dec, kinds = got["p"]
    two = f"two references (MB kinds skip/inter/intra {kinds})"
    for key, kw in (("K9", enc), ("K10", dec)):
        p_timed(key, kw, torch, f"854x480 x 8 default-config P frame, {two}",
                card)
    # the calls of the last encode (two references) and of its decode
    ref_timed("K11", caps["_references"][-2], torch,
              f"854x480 x 8 default-config P frame's encode, {two}", card)
    ref_timed("K11", caps["_references"][-1], torch,
              f"854x480 x 8 default-config P frame's decode, {two}", card)
    for i, kw in enumerate(caps["_int_winner"][-2:]):
        what = f"854x480 x 8 default-config P frame, reference {i} of two"
        ref_timed("K12", kw, torch, what, card)
        k12_phase_line(kw, torch, what, card)
    del enc, dec, caps, got
    rows += t8_rows(dev, torch, np, card)
    n_out = 0
    for case in K9_CASES:
        kw = k9_args(torch, k9_case(np, *case), dev)
        k9_equal(kw, torch, f"edge case {case}")
        if not kw["intra_in_p"]:  # the route that writes the symbols
            k9_out_equal(kw, torch, f"edge case {case}")
            n_out += 1
    for case in K10_CASES:
        kw = k10_args(torch, k10_case(np, *case), dev)
        k10_equal(kw, torch, f"edge case {case}")
        k10_equal(dict(kw, symbols=record_views(kw["symbols"], torch)),
                  torch, f"edge case {case}, record views")
    print(f"phase 2: K9 / K10 equal to their plain versions on "
          f"{len(K9_CASES)} / {len(K10_CASES)} seeded edge cases (K9 also "
          f"writing the symbols on the {n_out} without intra-in-P, K10 "
          f"also on their record views)")
    ref_edges(dev, torch, np)
    return rows


def t8_rows(dev, torch, np, card):
    """K9's and K10's t8 routes (the 8x8 transform's choice and decode,
    config 3's CABAC + 8x8 sessions): their rows of the kernel table on
    config 3's 1920x1080 x 1 P frame with two references
    (`pframe_config3`), a line each on part B's 854x480 x 8 P frame with
    two references (`pframe_480p_2ref` with t8), then the seeded cases
    (`K9_T8_CASES`, K9 also writing the symbols; `K10_T8_CASES`).  Each
    kernel is also timed on config 3's frame without t8, for what the
    route adds."""
    from tpuh264_torch.kernels import pframe

    res = pframe.resident_warps()
    mbs = 8160, 8 * 30 * 54  # config 3's frame, part B's (480 rows: 30)
    print(f"phase 2: K9 / K10 resident warps an SM (a MB each): " + ", ".join(
        f"{k} {n} ({mbs[0] / (132 * n):.2f} / {mbs[1] / (132 * n):.2f} waves "
        f"of config 3's / part B's frame)" for k, n in res.items())
        + f" [{card}]")
    enc, dec, kinds, n8 = pframe_config3(dev, torch)
    if not n8:
        fail("config 3's P frame coded no MB with the 8x8 transform")
    what = (f"config 3 1920x1080 x 1 P frame, two references, t8 (MB kinds "
            f"skip/inter/intra {kinds}, {n8} with the 8x8 transform)")
    rows = []
    for key, kw, name, source, replaces in (
            ("K9-t8", enc, "encode_pframe_rows_multi after stage A, its t8 "
             "route (_inter_encode with the 8x8 transform's choice)",
             "tpuh264_torch/csrc/pframe_enc.cu",
             "tpuh264/kernels/pframe.py:747"),
            ("K10-t8", dec, "decode_pframe_rows_multi's inter part, its t8 "
             "route (_inter_decode, the 8x8 inverse of t8 MBs)",
             "tpuh264_torch/csrc/pframe_dec.cu",
             "tpuh264/kernels/pframe.py:1101")):
        rows.append(kernel_row(key, name, source, replaces, *p_timed(
            key[:-3], kw, torch, what, card)))
        fn = pframe._inter_encode if key == "K9-t8" else pframe._inter_decode
        ms0 = timed(lambda: fn(**dict(kw, t8=False)), 20)
        print(f"phase 2: {key[:-3]} on the same frame without t8 (the route "
              f"without the 8x8 transform): {ms0:.4f} ms, against "
              f"{rows[-1]['ms']:.4f} ms with it [{card}]")
    del enc, dec
    enc, dec, kinds = pframe_480p_2ref(dev, torch, t8=True)
    for key, kw in (("K9", enc), ("K10", dec)):
        _, ms, _, _ = p_timed(key, kw, torch, f"config 3 part B 854x480 x 8 "
                              f"P frame, two references, t8 (MB kinds "
                              f"skip/inter/intra {kinds})", card)
        fn = pframe._inter_encode if key == "K9" else pframe._inter_decode
        ms0 = timed(lambda: fn(**dict(kw, t8=False)), 20)
        print(f"phase 2: {key} on part B's frame without t8: {ms0:.4f} ms, "
              f"against {ms:.4f} ms with it [{card}]")
    del enc, dec
    n_out = 0
    for case in K9_T8_CASES:
        kw = k9_args(torch, k9_case(np, *case), dev, t8=True)
        k9_equal(kw, torch, f"t8 case {case}")
        if not kw["intra_in_p"]:  # the route that writes the symbols
            k9_out_equal(kw, torch, f"t8 case {case}")
            n_out += 1
    for case in K10_T8_CASES:
        k10_equal(k10_args(torch, k10_case(np, *case, t8=True), dev,
                           t8=True), torch, f"t8 case {case}")
    print(f"phase 2: K9's / K10's t8 routes equal to their plain versions "
          f"on {len(K9_T8_CASES)} / {len(K10_T8_CASES)} seeded t8 cases "
          f"(K9 also writing the symbols on the {n_out} without "
          f"intra-in-P; QPs 0, 5, 6, 11, 12 and up to 51, J ties, cbp8 0, "
          f"t8 on skip and intra MBs)")
    return rows


def phase_kernels(dev, torch, np, card):
    """Phase 2: K1-K6 against their plain versions at 1080p x 4 and on
    edge cases, K13 / K2 / K3 and K6 (D4) on intra-in-P inputs, K4 on t8
    symbols and K5 on default-config symbols at 480p x 8; K3 at its MB
    and slice levels; K7 / K8 at 480p x 8, config 1 and 1080p x 1 and on
    their edge cases; K9-K12 (`p_rows`); K13 and K14 at the main path's
    shapes and on `K13_CASES` / `K14_CASES`."""
    from tpuh264_torch.kernels import deblock, iframe, me_cuda, pframe

    w, h, s = 1920, 1088, 4
    y, u, v, sym, rec_p, mot = pframe_1080p(dev, torch)
    y1 = y[1].to(torch.int32).contiguous()
    gplane = k1_plane(torch, y[0])
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

    # K2 / K3 inputs: the encoded 1080p x 4 P frame, four times over (a
    # P dispatch's 16 frame-streams: 3.5 M blocks, 130,560 MBs)
    sym4 = pframe.MBSymbolsP(*[None if f is None else torch.cat([f] * 4)
                               for f in sym])
    k3s_layout(card)
    k23, k13 = k23_rows(sym4, torch, "1080p x 4 P symbols x 4 frames")
    rows += k23
    # K4 (D1): an encoded I frame and P frame at 1080p x 4, the P frame's
    # row in the kernel table, with its cycles a MB column
    sym_i, rec_i = iframe.encode_iframe_rows(y[0], u[0], v[0], 30)
    k3s_islices(sym_i, torch, card)
    d1_equal(*d1_args(torch, rec_i, 30), torch, "1080p x 4 I frame")
    k4_ring_equal(*ring_call_args(rec_i, 30), torch,
                  "1080p x 4 I frame, as deblock_i")
    del rec_i
    mhz = busy_sm_clock()
    print(f"phase 2: SM clock under load {mhz} MHz (nvidia-smi clocks.sm) "
          f"[{card}]")
    # the ring entry (the main path's) is the K4 row; the counts entry,
    # from int32 planes and deblock_nnz's grid, is printed beside it
    rows.append(k4_ring_row(*ring_call_args(rec_p, 30, sym, mot), torch,
                            "1080p x 4 P frame", mhz))
    cargs, ckw = d1_args(torch, rec_p, 30, sym, mot)
    d1_equal(cargs, ckw, torch, "1080p x 4 P frame, counts entry")
    c_ms = timed(lambda: deblock.deblock_frame_rows(*cargs, **ckw), 20)
    print(f"phase 2: K4 deblock_frame_rows (D1's counts entry: int32 planes, "
          f"deblock_nnz's grid), 1080p x 4 P frame: equal to plain; kernel "
          f"{c_ms:.4f} ms, bound {bound_ms(k4_bytes(cargs, ckw)):.4f} ms "
          f"(bytes), {d1_cycles(c_ms, mhz, 120):.0f} cycles a MB column "
          f"[{card}]")
    del cargs, ckw
    rargs, rkw = ring_call_args(rec_p, 30, record_views(sym, torch), mot)
    rec_ms = timed(lambda: deblock.deblock_ring(*rargs, **rkw), 20)
    k4_ring_equal(rargs, rkw, torch, "1080p x 4 P frame, record views")
    del rec_p, mot, rargs, rkw
    print(f"phase 2: K4 (D1) 1080p x 4 P frame: ring entry "
          f"{rows[-1]['cycles_col']:.0f} cycles a MB column (120 columns) "
          f"at {mhz} MHz; from the "
          f"record views (fields with MB stride 9, levels 400) {rec_ms:.4f} "
          f"ms [{card}]")
    k15 = k15_rows(dev, torch, card, mhz)
    rows.append(k15[0])  # the main path's kind, "rigid"
    for r in k15[1:]:
        show(r, "1080p x 4, k = 4 (not the main path's kind)")
    # K5 (D2): the decoders' inputs of the P frame and the IDR, then 480p;
    # its Intra_4x4 route
    rows.append(d2_rows(dev, torch, np, card, (y, u, v, sym, sym_i)))
    rows.append(d2_i44_rows(dev, torch, np, card))
    # K6 (D3): the 1080p x 4 I frame (the main path's GOP start), from
    # its uint8 planes; the row of the kernel table, with its cycles, and
    # ptxas's registers, spills and shared memory of its source
    for ln in ptxas_lines(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tpuh264_torch", "csrc",
            "intra16_enc.cu")):
        print(f"phase 2: K6 ptxas: {ln}")
    err, ms, plain, nbytes = d3_timed((y[0], u[0], v[0]), 30, torch,
                                      "1080p x 4 I frame", card, mhz)
    rows.append(kernel_row(
        "K6", "encode_iframe_scan / _intra_in_p_scan (D3, D4, Intra_16x16 "
        "encode column scan)", "tpuh264_torch/csrc/intra16_enc.cu",
        "tpuh264/kernels/iframe.py:219", err, ms, plain, nbytes))
    # its Intra_4x4 route (the encoders of intra44 sessions)
    rows.append(d3_i44_rows(dev, torch, np, card, mhz, (y[0], u[0], v[0])))
    for r in rows:
        show(r, "1080p x 4 shapes")
    del sym, sym4, sym_i
    # K7 / K8 (the single-slice wavefront): phase 12's frames, config 1,
    # a 1080p frame and the edge cases
    for ln in ptxas_lines(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "tpuh264_torch", "csrc",
            "wavefront.cu")):
        print(f"phase 2: K7 / K8 ptxas: {ln}")
    for r in wave_rows(dev, torch, np, card, mhz):
        show(r, "854x480 x 8 (phase 12's frames)")
        rows.append(r)
    # K9-K12 (the P-frame inter path, the reference build, the stage-A
    # winner): the 1080p x 4 P frame, 480p x 8 with two references and
    # intra-in-P, the edge cases
    for r in p_rows(dev, torch, np, card):
        show(r, "config 3's 1920x1080 x 1 P frame, two references"
             if r["key"].endswith("-t8")
             else "1080p x 4 shapes (RTC P frame, one reference)")
        rows.append(r)
    # K13 (the CAVLC prologue) on the dispatch's P symbols, K14 (the
    # decoder's SSE) on an interior dispatch's four frames
    show(k13, "1080p x 4 P symbols x 4 frames")
    rows.append(k13)
    rows.append(k14_rows(dev, torch, np, card))
    show(rows[-1], "1080p x 4, four decoded frames")
    rows += probe_rows(dev, torch, np, card)  # P1 / P2, the probe's
    k13_edges(dev, torch, np)
    k2_edges(dev, torch, np)
    k3_edges(dev, torch, np)
    k3s_edges(dev, torch, np)
    d1_edges(dev, torch, np)
    d1_ring_edges(dev, torch, np, card)
    d1_t8_480p(dev, torch, mhz, card)
    d3_edges(dev, torch, np)

    # intra-in-P P symbols at 854x480 x 8, four P frames' worth (32
    # frame-streams)
    p480, sym, kinds = intra_in_p_480p(dev, torch)
    # K6 (D4) on that P encode's own inputs of the intra-in-P scan
    d4_timed(p480, torch, "854x480 x 8 intra-in-P P frame", card, mhz)
    del p480
    sym4 = pframe.MBSymbolsP(*[None if f is None else torch.cat([f] * 4)
                               for f in sym])
    k23, k13 = k23_rows(sym4, torch, "intra-in-P 854x480 x 8 x 4 frames")
    for r in k23 + [k13]:
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
    from tpuh264_torch.kernels import iframe

    frames = session_frames(6)
    for name, kw, need_i4 in session_cases():
        # on the card no plain K5 or K6: the Intra_4x4 IDRs take their i44
        # routes
        names = ("_intra_recon_scan_plain", "_encode_iframe_scan_plain")
        real, plain = [getattr(iframe, a) for a in names], []
        i44_0 = (iframe._intra_recon_scan.i44_launches,
                 iframe.encode_iframe_scan.i44_launches)
        for a, f in zip(names, real):
            setattr(iframe, a, _plain_spy(a, f, plain))
        try:
            g_data, g_rec, g_dec, idr = run_session_case(kw, dev, frames,
                                                         True)
        finally:
            for a, f in zip(names, real):
                setattr(iframe, a, f)
        n_i44 = iframe._intra_recon_scan.i44_launches - i44_0[0]
        n6_i44 = iframe.encode_iframe_scan.i44_launches - i44_0[1]
        if plain or (need_i4 and min(n_i44, n6_i44) <= 0):
            fail(f"64x48 session, {name}: plain versions ran {plain}; "
                 f"the Intra_4x4 routes of K5 {n_i44}, K6 {n6_i44} times")
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
              f"frame; Intra_4x4 MBs in stream 0's IDR frames: {i4}; "
              f"launches: the Intra_4x4 routes of K5 {n_i44} and K6 "
              f"{n6_i44}, the plain versions of K5 and K6 none")


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
    the device source (K15) once a dispatch,
    K3 launched twice per entropy call (MB and slice level), the deblock
    (K4's ring entry) 8 times per dispatch (4 encoder frames, 4 decoder
    frames, each into its DPB ring slot), the
    intra reconstruction (K5) 4 times (the decoder's frames), K6 once a
    GOP-start dispatch (its I frame; the RTC preset has no intra-in-P),
    the reference build (K11) once a P encode and once a decoded frame,
    the stage-A winner (K12) once a P encode (one reference), K13 once an
    entropy call (I and P slices), K14 once a decoded frame (its SSE,
    taken before a later frame's deblock reuses its ring slot)."""
    from tpuh264_torch.engine import CodecConfig, sources
    from tpuh264_torch.engine.devpipe import GOPDevicePipeline
    from tpuh264_torch.kernels import (cavlc_cuda, deblock, entropy_gpu,
                                       iframe, pframe, sse)

    cfg = CodecConfig(width=1920, height=1080, streams=4, qp=None,
                      bitrate=4_000_000, intra_in_p=False)
    pipe = GOPDevicePipeline(cfg, gop_size=8, source_kind="rigid",
                             device=dev)
    spy = SymbolSpy(pipe, torch)
    qps, times, k3, k4, k5, k6, k11, k12 = [], [], [], [], [], [], [], []
    k13, k14, k15 = [], [], []
    k4_count = lambda: (deblock.deblock_frame_rows.launches
                        + deblock.deblock_ring.launches)
    k3_count = lambda: (cavlc_cuda.merge_tree.launches
                        + cavlc_cuda.merge_slices.launches)
    k6_count = lambda: (iframe.encode_iframe_scan.launches
                        + pframe._intra_in_p_scan.launches)
    for i in range(3):
        qps.append(pipe.rc.current_qp())
        n0 = k3_count()
        p0, q0 = entropy_gpu.cavlc_prologue.launches, sse.sse.launches
        d0, s0 = k4_count(), sources.device_source_gop.launches
        r0 = iframe._intra_recon_scan.launches
        e0 = k6_count()
        f0, w0 = pframe._references.launches, pframe._int_winner.launches
        t0 = time.perf_counter()
        pipe.pump_frame()
        times.append(time.perf_counter() - t0)
        k3.append(k3_count() - n0)
        k13.append(entropy_gpu.cavlc_prologue.launches - p0)
        k14.append(sse.sse.launches - q0)
        k4.append(k4_count() - d0)
        k15.append(sources.device_source_gop.launches - s0)
        k5.append(iframe._intra_recon_scan.launches - r0)
        k6.append(k6_count() - e0)
        k11.append(pframe._references.launches - f0)
        k12.append(pframe._int_winner.launches - w0)
        check_dpbs(pipe, np, "1080p", i)
    expect = [4 if st else 2 for st in spy.starts]
    if k3 != expect:
        fail(f"1080p: K3 launches per dispatch {k3}, expected {expect} "
             f"(GOP starts {spy.starts})")
    if (k13 != [n // 2 for n in expect] or k14 != [4, 4, 4]
            or k15 != [1, 1, 1]):
        fail(f"1080p: K13 launches per dispatch {k13}, K14 {k14}, K15 "
             f"{k15}, expected {[n // 2 for n in expect]} (one an entropy "
             f"call), four (one a decoded frame) and one")
    if k4 != [8, 8, 8]:
        fail(f"1080p: deblock launches per dispatch {k4}, expected 8 each")
    if k5 != [4, 4, 4]:  # one a decoded frame, the IDR's included
        fail(f"1080p: intra recon launches per dispatch {k5}, expected 4 "
             f"each")
    if k6 != [int(st) for st in spy.starts]:
        fail(f"1080p: K6 launches per dispatch {k6}, expected one a GOP "
             f"start (GOP starts {spy.starts})")
    # a P encode each: one reference build and one winner (one reference);
    # a decoded frame each (the IDR's too): one reference build
    p_enc = [3 if st else 4 for st in spy.starts]
    if k12 != p_enc or k11 != [n + 4 for n in p_enc]:
        fail(f"1080p: K11 launches per dispatch {k11}, K12 {k12}, expected "
             f"{[n + 4 for n in p_enc]} and {p_enc}")
    print(f"phase 4: 1920x1080 x 4, CBR 4 Mbps, gop 8, rigid: 3 dispatches "
          f"(12 frames, GOP starts {spy.starts}), decoder DPB == encoder DPB "
          f"after each; K3 launches per dispatch {k3} (MB + slice level per "
          f"entropy call), K4 (deblock) {k4} (4 encoder + 4 decoder "
          f"frames), K5 (intra recon) {k5} (4 decoded frames), K6 (intra16 "
          f"encode) {k6} (the I frames), K11 (references) {k11} (P "
          f"encodes and decoded frames), K12 (stage-A winner) {k12} (P "
          f"encodes), K13 (CAVLC prologue) {k13}, K14 (SSE) {k14} (a "
          f"decoded frame each), K15 (device source) {k15}; QP {qps}; "
          f"PSNR {pipe.last_psnr_y:.2f} dB; pump_frame s "
          f"{[round(t, 3) for t in times]} [{card}]")


def phase_runs(dev, card):
    """Phase 5: short measured runs at the headline's two configurations
    through `bench.headline.measure` (one repeat each, decoder DPB ==
    encoder DPB after it), printed in the headline's formats; the gate is
    phase 14's."""
    from tpuh264_torch.bench import harness, headline
    from tpuh264_torch.engine import CodecConfig

    runs = []
    for (fields, _, _), dur in ((headline.HEADLINE, 15.0),
                                (headline.SECONDARY, 12.0)):
        cfg = CodecConfig(**fields)
        runs.append(headline.measure(cfg, dur, 1, 1, dev))
        r = runs[-1][0]
        print(f"phase 5: run() {cfg.width}x{cfg.height} x {cfg.streams} CBR "
              f"{cfg.bitrate // 1000} kbps: "
              f"{r['frames_per_s_aggregate']:.2f} aggregate fps "
              f"({r['frames']} frames), PSNR {r['psnr_y']:.2f} dB, QP "
              f"{r['qp']} [{card}]")
        print(f"phase 5: "
              f"{headline.stage_line(f'{cfg.width}x{cfg.height}', runs[-1])}")
    print("phase 5: headline line (one repeat, gate in phase 14): "
          + json.dumps(headline.headline_line(
              runs[0], "phase 14", harness.device_info(dev))))
    print(f"phase 5: ref-config line: {headline.secondary_line(runs[1])}")


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
    from tpuh264_torch.engine import devpipe
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

    launches.path("480p x 8 intra-in-P", drive, needs=Launches.NEEDS_SRC)
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
    refs = devpipe.dpb_refs(pipe._dpb_enc, pipe._head_enc, 1)
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

    _, counts = launches.path("480p x 8, 2 references", drive,
                              needs=Launches.NEEDS_SRC)
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
    intra-in-P (the CodecConfig default): intra MBs must be coded; then
    `bench.ingest.measure` on the same pipeline for 3 s."""
    from tpuh264_torch.bench import ingest
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
    box = {}

    def drive():
        f0 = 0
        for i in range(3):
            pipe.pump_host_frames(*ingest.host_batch(pipe, f0,
                                                     clip.__getitem__))
            copy_ms.append(round(pipe.last_copy_ms, 3))
            check_dpbs(pipe, np, "ingest fan-out 8", i)
            f0 += 4
            if i == 0:  # capture backpressure: the encoder skips 4 frames
                pipe.drop_frames(4)
                f0 += 4
        # the bench's window, its source clock going on from the clip's
        box["line"] = ingest.measure(pipe, seconds=3.0, warmup=0)

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
    print(f"phase 8: bench.ingest.measure, 3 s on that pipeline "
          f"(intra-in-P), decode streams == encoder DPB after it: "
          f"{json.dumps(box['line'])}")


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

    launches.path("DevicePipeline 480p x 8", drive,
                  needs=(1, 2, 4, 5, 12, 14))
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
    """Phase 10: the live App at 854x480 x 8 for ~10 s; its stats as
    `bench.live.render` shows them."""
    from tpuh264_torch.bench import live
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
        # the stats show output only once the first dispatch (an IDR and 3
        # intra-in-P P frames) has retired; a pump that falls behind the
        # capture clock drops frames (time_offset), one that keeps up none
        while (pipe.stats.decoded_frames == 0 and app.is_processing()
               and time.perf_counter() - t0 < 120.0):
            time.sleep(0.1)
        box["wait_s"] = time.perf_counter() - t0
        box["stats"] = app.get_stats()
        t0 = time.perf_counter()
        app.stop()
        box["stop_s"] = time.perf_counter() - t0
        box["pipe"] = pipe

    launches.path("App tpu_gop 480p x 8", drive, needs=Launches.NEEDS_SRC)
    stats, pipe = box["stats"], box["pipe"]
    if app.error is not None:
        fail(f"App: the pump thread failed: {app.error!r}")
    if app.is_processing() or app.pipeline is not None:
        fail("App: stop() left the pipeline running")
    app.stop()
    frames = pipe.dispatch_index * pipe.FRAMES_PER_DISPATCH
    if frames <= 0 or stats["output_fps"] <= 0:
        fail(f"App: no frames or no output: {stats}")
    # every frame the pump skipped is counted as a capture drop: in the
    # window the stats showed, or after it
    dropped = (stats["dropped_capture"]
               + pipe.stats.snapshot(8)["dropped_capture"])
    if dropped != pipe.time_offset:
        fail(f"App: {dropped} capture drops counted for {pipe.time_offset} "
             f"frames skipped")
    shown = {k: (round(v, 3) if isinstance(v, float) else v)
             for k, v in stats.items()}
    print(f"phase 10: App(impl='tpu_gop') 854x480 x 8, defaults, "
          f"{box['wait_s']:.1f} s: {frames} frames per stream encoded, "
          f"time_offset "
          f"{pipe.time_offset}; get_stats() {shown}; stop() took "
          f"{box['stop_s']:.1f} s [{card}]")
    for ln in live.render(stats).splitlines():
        print(f"phase 10: {ln}")


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

    launches.path("EncoderSession + DecoderPool 480p x 8", drive,
                  needs=(0, 3, 4, 5, 8, 9, 10, 11), i44=True)
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
    """Phase 12: single-slice I frames (the wavefront: K7 encodes, K8
    decodes) at 854x480 x 8, gop 1, 2 frames, each stream decoded by its
    own DecoderSession == recon; then BASELINE config 1 (`phase_config1`).
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

    _, counts = launches.path("wavefront 480p x 8", drive, needs=(6, 7))
    stay_fast(decs, "wavefront")
    if counts[0]:
        fail(f"wavefront: K1 launched {counts[0]} times on an I-only path")
    if counts[6] != len(frames) or counts[7] != len(frames) * s:
        fail(f"wavefront: K7 / K8 launched {counts[6]} / {counts[7]} times, "
             f"expected one a frame / one a frame and stream")
    waves = (h + 15) // 16 + (w + 15) // 16 - 1
    print(f"phase 12: single-slice I frames (wavefront: K7 / K8, {waves} "
          f"waves a launch) 854x480 x 8, gop 1, 2 frames: each stream's "
          f"DecoderSession == encoder recon; (encode, entropy, 8 decodes) ms "
          f"per frame {ms} [{card}]")
    phase_config1(dev, np, card, launches)
    config1_rgba(dev, launches)


def phase_config1(dev, np, card, launches):
    """Phase 12, BASELINE config 1 (`BASELINE.json` configs[0]: 360p
    baseline-profile I-frame-only encode -> decode roundtrip, CAVLC, single
    slice, fixed QP): EncoderSession 640x360 x 1, QP 28, gop 1, 30 frames
    of the "meeting" clip, each access unit through a DecoderSession ==
    the recon; K7 and K8 once a frame, no plain wavefront; the first
    frame also through the gate's oracle == the recon; mean encode /
    entropy / decode ms a frame and the round trip's fps."""
    from tpuh264_torch.conformance import gate
    from tpuh264_torch.engine import CodecConfig, DecoderSession, EncoderSession

    w, h, n = 640, 360, 30
    frames = clip_streams(w, h, n, 1)
    enc = EncoderSession(CodecConfig(width=w, height=h, streams=1, qp=28,
                                     slice_mode="single", gop_size=1),
                         device=dev)
    dec = DecoderSession(device=dev)
    rows, first = [], []

    def drive():
        for t, planes in enumerate(frames):
            t0 = time.perf_counter()
            f, = enc.encode_frame_yuv(*planes)
            t1 = time.perf_counter()
            got = dec.decode(f.data)
            t2 = time.perf_counter()
            if not f.is_idr:
                fail(f"config 1: frame {t} is not an IDR")
            recon = [p[0].cpu().numpy() for p in enc.recon]
            if got is None or not all(
                    np.array_equal(a, r[:a.shape[0], :a.shape[1]])
                    for a, r in zip(got, recon)):
                fail(f"config 1: DecoderSession != encoder recon, frame {t}")
            if got[0].shape != (h, w):
                fail(f"config 1: decoded luma {got[0].shape}")
            if t == 0:
                first.append((f.data, got))
            rows.append(dict(encode=f.timings["encode_ms"],
                             entropy=f.timings["entropy_ms"],
                             decode=(t2 - t1) * 1e3, wall=t2 - t0,
                             bytes=len(f.data)))

    _, counts = launches.path("BASELINE config 1 640x360", drive,
                              needs=(6, 7))
    stay_fast([dec], "config 1")
    if counts[6] != n or counts[7] != n:
        fail(f"config 1: K7 / K8 launched {counts[6]} / {counts[7]} times "
             f"for {n} frames")
    data, got = first[0]
    t0 = time.perf_counter()
    oracle = gate.decode_oracle(data)
    oracle_s = time.perf_counter() - t0
    if len(oracle) != 1 or not all(np.array_equal(np.asarray(a), b)
                                   for a, b in zip(oracle[0], got)):
        fail("config 1: the gate's oracle != the recon of frame 0")
    mean = lambda k: sum(r[k] for r in rows) / n
    print(f"phase 12: BASELINE config 1, 640x360 x 1, QP 28, single slice, "
          f"gop 1, {n} frames of 'meeting': DecoderSession == encoder recon "
          f"every frame; frame 0 through the gate's oracle "
          f"({gate.oracle_name()}, {oracle_s:.1f} s) == recon; K7 {counts[6]}"
          f", K8 {counts[7]} launches; mean ms a frame: encode "
          f"{mean('encode'):.2f}, entropy {mean('entropy'):.2f}, decode "
          f"{mean('decode'):.2f}; round trip "
          f"{n / sum(r['wall'] for r in rows):.1f} fps (host wall, encode + "
          f"decode); {mean('bytes'):.0f} bytes a "
          f"frame [{card}]")


def config1_rgba(dev, launches):
    """Phase 12, config 1 from RGBA: `EncoderSession.encode_frame` (whose
    colour conversion gives K7 int32 planes) at 640x360 x 1, single slice,
    2 frames, emits the bytes of the same session on the CPU (the plain
    wavefront, run before the path is driven)."""
    from tpuh264_torch.engine import CodecConfig, EncoderSession

    cfg = CodecConfig(width=640, height=360, streams=1, qp=28,
                      slice_mode="single", gop_size=1)
    frames = clip_rgba(dev, 640, 360, 2, 1)
    cpu = EncoderSession(cfg, device="cpu")
    want = [cpu.encode_frame(f)[0].data for f in frames]
    enc = EncoderSession(cfg, device=dev)
    got = []

    def drive():
        for f in frames:
            got.append(enc.encode_frame(f)[0].data)

    _, counts = launches.path("config 1 from RGBA", drive, needs=(6,))
    if counts[6] != len(frames):
        fail(f"config 1 from RGBA: K7 launched {counts[6]} times for "
             f"{len(frames)} frames")
    if got != want:
        fail("config 1 from RGBA: the card's stream != the CPU session's")
    print(f"phase 12: config 1 from RGBA (encode_frame, int32 planes into "
          f"K7), 640x360 x 1, 2 frames: the card's bytes == the CPU "
          f"session's ({sum(map(len, got))} bytes)")


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

    launches.path("App tpu 480p fan-out 8", drive,
                  needs=(0, 4, 5, 8, 9, 10, 11))
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

    launches.path("conformance gate", drive, needs=Launches.NEEDS_SRC)
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

    outs, _ = launches.path("general stream", decode, needs=(4,))
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
    """Phase 15: BASELINE config 3 on the card through `bench.config3`
    (tools/bench_config3.py's session: 1080p, CABAC + 8x8 transform, 2
    references, CBR 4 Mbps, intra-in-P), 6 frames, decoded by a
    DecoderSession on the fast path == the recon after every frame and ==
    the golden decode of the whole stream (in a spawned worker, beside
    part B), its `config3_session_encode` line; part B, the reference
    lab's operating point (854x480 x 8 from RGBA) with CABAC, the 8x8
    transform and its deblock, through DecoderPool.decode_batch; then
    `bench.config3.flagship_multiref` (1080p x 4, 2 references) for 2 s."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor

    import torch

    from tpuh264_torch.bench import config3, harness
    from tpuh264_torch.conformance import gate
    from tpuh264_torch.engine import DecoderSession, EncoderSession

    # ---- part A: config 3 at 1920x1080, IDR + 5 P ----
    w, h, n = 1920, 1080, 6
    enc = EncoderSession(config3.session_config(w, h, n), device=dev)
    dec = DecoderSession(device=dev)
    spy = PSymbols(enc, torch)
    src = config3.source(w, h, n)
    rows, done = [], []

    def drive():
        for t, (planes, f) in enumerate(zip(src,
                                            config3.encode_frames(enc, src))):
            t0 = time.perf_counter()
            got = dec.decode(f["au"])
            dec_ms = (time.perf_counter() - t0) * 1e3
            recon = f["recon"]
            if got is None or not all(np.array_equal(a, r)
                                      for a, r in zip(got, recon)):
                fail(f"config 3: decoder != encoder recon at frame {t}")
            if dec._general or dec.frames_concealed:
                fail(f"config 3: the decoder left the fast path (general "
                     f"{dec._general}) or concealed at frame {t}")
            d = recon[0].astype(np.float64) - planes[0]
            tm = f["timings"]
            done.append(f)
            rows.append(dict(
                frame=t, idr=f["idr"], qp=f["qp"],
                kbps_at_30fps=round(len(f["au"]) * 8 * 30 / 1e3, 1),
                psnr_y=round(float(10 * np.log10(255.0 ** 2
                                                 / (d * d).mean())), 2),
                copy_ms=round(tm["copy_ms"], 1),
                encode_ms=round(tm["encode_ms"], 1),
                entropy_ms=round(tm["entropy_ms"], 1),
                decode_ms=round(dec_ms, 1)))

    _, counts = launches.path("config 3 1080p", drive,
                              needs=(0, 4, 5, 8, 9, 10, 11))
    t8_routes(counts, "config 3")
    intra, t8, ref1 = spy.shares()
    if spy.searched != [1, 2, 2, 2, 2] or counts[0] != sum(spy.searched):
        fail(f"config 3: K1 launched {counts[0]} times for the references "
             f"searched {spy.searched} (1 + 2 x 4 = 9 expected)")
    if t8 <= 0 or ref1 <= 0:
        fail(f"config 3: P-frame MB shares t8 {t8}, reference 1 {ref1}")
    for r in rows:
        print(f"phase 15: config 3 frame {r} [{card}]")
    # the independent oracle: the golden decoder, in a spawned worker
    aus = [f["au"] for f in done]
    oracle = ProcessPoolExecutor(
        1, mp_context=multiprocessing.get_context("spawn"))
    try:
        gold = oracle.submit(gate._timed_decode, b"".join(aus), "golden")
        aus_b, recons_b = part_b(dev, np, card, launches, torch)
        gold_b = oracle.submit(gate._timed_decode, b"".join(aus_b), "golden")
        frames, gold_s = gold.result()
        frames_b, gold_bs = gold_b.result()
    finally:
        oracle.shutdown(wait=True, cancel_futures=True)
    try:
        config3.check_decoded(frames, [f["recon"] for f in done])
    except AssertionError as e:
        fail(f"golden decode: {e}")
    if len(frames_b) != len(recons_b):
        fail(f"config 3 part B stream 0: the golden decoder decoded "
             f"{len(frames_b)} frames")
    for t, (f, r) in enumerate(zip(frames_b, recons_b)):
        if not all(np.array_equal(np.asarray(a), b[:a.shape[0], :a.shape[1]])
                   for a, b in zip(f, r)):
            fail(f"config 3 part B stream 0: golden decode != encoder recon "
                 f"at frame {t}")
    print(f"phase 15: part B stream 0 (CABAC, 8x8 transform, deblock with "
          f"K4) decoded by the golden decoder (worker, {gold_bs:.1f} s) == "
          f"the encoder recon of all {len(frames_b)} frames [{card}]")
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
    print("phase 15: " + json.dumps(config3.session_line(
        done, frames, src, "golden", harness.device_info(dev))))
    line, _ = launches.path("config 3 flagship 1080p x 4, 2 references",
                            lambda: config3.flagship_multiref(
                                w, h, 2.0, device=dev),
                            needs=(0, 1, 2, 3, 4, 8, 9, 10, 11, 14))
    print(f"phase 15: bench.config3.flagship_multiref, 2 s, decoder DPB == "
          f"encoder DPB after it: {json.dumps(line)}")


def t8_routes(counts, what):
    """Every K9 and K10 launch of the path just driven (`counts`) took the
    t8 route (a CABAC + 8x8 session's P frames): fails unless so."""
    from tpuh264_torch.kernels import pframe

    t8 = (pframe._inter_encode.t8_launches, pframe._inter_decode.t8_launches)
    if t8 != (counts[8], counts[9]):
        fail(f"{what}: K9 / K10 launched {counts[8]} / {counts[9]} times, "
             f"{t8[0]} / {t8[1]} of them on the t8 route")


def part_b(dev, np, card, launches, torch):
    """Phase 15 part B: 854x480 x 8 from RGBA (the "meeting" clip), CABAC +
    8x8 transform + deblock, 2 references, CBR 1 Mbps, gop 8, 4 frames;
    every frame's access units through DecoderPool.decode_batch (per
    session: CABAC does not batch) == the recon.  Returns stream 0's
    access units and recon planes per frame, for the golden decoder."""
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
    rows, aus0, recons0 = [], [], []

    def drive():
        for t, rgba in enumerate(frames):
            out = enc.encode_frame(rgba)
            t0 = time.perf_counter()
            got = pool.decode_batch([(i, f.data) for i, f in enumerate(out)])
            dec_ms = (time.perf_counter() - t0) * 1e3
            recon = [p.cpu().numpy() for p in enc.recon]
            aus0.append(out[0].data)
            recons0.append([r[0] for r in recon])
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

    _, counts = launches.path("config 3 part B 480p x 8", drive,
                              needs=(0, 3, 4, 5, 8, 9, 10, 11))
    t8_routes(counts, "config 3 part B")
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
    return aus0, recons0


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
        plain, plain6 = [], []
        sad = me_cuda._sad_field
        me_cuda._sad_field = lambda *a: plain.append(1) or sad(*a)
        k1 = me_cuda.sad_field.launches
        # K6 once a frame (the I step's scan, then each P step's
        # intra-in-P scan), its plain versions never
        k6_fns = (iframe.encode_iframe_scan, pframe._intra_in_p_scan)
        k6 = sum(f.launches for f in k6_fns)
        k9 = pframe._inter_encode.launches  # K9 once a P frame
        # K11 once a P encode and once a P decode (halo=True), K12 once a
        # P encode (one reference, the counts summed over the rows group)
        k11, k12 = pframe._references.launches, pframe._int_winner.launches
        p6 = [(iframe, "_encode_iframe_scan_plain"),
              (pframe, "_intra_in_p_scan_plain"),
              (pframe, "_inter_encode_plain"),
              (pframe, "_references_plain"),
              (pframe, "_int_winner_plain")]
        p6_saved = [getattr(m, a) for m, a in p6]
        for (m, a), f in zip(p6, p6_saved):
            setattr(m, a, _plain_spy(a, f, plain6))
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
        k6 = sum(f.launches for f in k6_fns) - k6
        k9 = pframe._inter_encode.launches - k9
        for (m, a), f in zip(p6, p6_saved):
            setattr(m, a, f)
        # each rank decodes its own P symbols against its halo-extended DPB
        # (K10 and K5 once a frame, their plain versions never)
        halo_ok, plain5 = True, []
        rplain = iframe._intra_recon_scan_plain
        iframe._intra_recon_scan_plain = _plain_spy(
            "_intra_recon_scan_plain", rplain, plain5)
        dplain = pframe._inter_decode_plain
        pframe._inter_decode_plain = _plain_spy(
            "_inter_decode_plain", dplain, plain5)
        fplain = pframe._references_plain
        pframe._references_plain = _plain_spy("_references_plain", fplain,
                                              plain5)
        k5 = iframe._intra_recon_scan.launches
        k10 = pframe._inter_decode.launches
        for t in range(1, n):
            ext = dm._halo_extend_yuv(*recs[t - 1], pframe.HALO_Y,
                                      pframe.HALO_C, mesh)
            dec, _ = pframe.decode_pframe_rows_multi(
                syms[t], *(e[None] for e in ext), qp, halo=True)
            halo_ok &= all(torch.equal(a, b) for a, b in zip(dec, recs[t]))
        k5 = iframe._intra_recon_scan.launches - k5
        k10 = pframe._inter_decode.launches - k10
        iframe._intra_recon_scan_plain = rplain
        pframe._inter_decode_plain = dplain
        pframe._references_plain = fplain
        k11 = pframe._references.launches - k11
        k12 = pframe._int_winner.launches - k12
        got = [([(f, dm.gather(mesh, x)) for f, x in _sym_fields(syms[t])],
                [dm.gather(mesh, x) for x in recs[t]],
                [dm.gather(mesh, x) for x in mots[t - 1]] if t else [])
               for t in range(n)]
        ok = (halo_ok and k1 == k5 == k9 == k10 == k12 == n - 1
              and k11 == 2 * (n - 1) and k6 == n and not plain
              and not plain5 and not plain6)
        result = dict(rank=rank, band=[mesh.stream_index, mesh.row_index],
                      shape=list(recs[0][0].shape), k1_launches=k1,
                      plain_k1_calls=len(plain), k5_launches=k5,
                      plain_k5_calls=len(plain5), k6_launches=k6,
                      plain_k6_calls=len(plain6), k9_launches=k9,
                      k10_launches=k10, k11_launches=k11,
                      k12_launches=k12, i_ms=round(i_ms, 1),
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
        k9 = pframe._inter_encode.launches
        _, rec = i_fn(*dm.shard_inputs(mesh, *frames[0]), SHARD_QP)
        for t in (1, 2):
            sym, rec, _ = p_fn(*dm.shard_inputs(mesh, *frames[t]), *rec,
                               SHARD_QP)
        k1 = me_cuda.sad_field.launches - k1
        k9 = pframe._inter_encode.launches - k9
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
            equal_unsharded=ok, k1_launches=k1, k9_launches=k9)),
            flush=True)
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
    (b) `bench.multihost.measure` at mesh 1x2 -- 2 processes of `python -m
    tpuh264_torch.dist.multihost` on the card with gloo, one host, then
    two hosts with the rows across them -- and the stream-parallel layout
    (mesh 2x1), 832x480: all bitexact.
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
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from tpuh264_torch.bench import multihost

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
        k5 = sum(r["k5_launches"] for r in ranks)
        k6 = sum(r["k6_launches"] for r in ranks)
        k9 = sum(r["k9_launches"] for r in ranks)
        k10 = sum(r["k10_launches"] for r in ranks)
        k11 = sum(r["k11_launches"] for r in ranks)
        k12 = sum(r["k12_launches"] for r in ranks)
        if (k1 != world * (n_frames - 1) or k5 != k1 or k9 != k1
                or k10 != k1 or k12 != k1 or k11 != 2 * k1
                or k6 != world * n_frames
                or any(r["plain_k1_calls"] or r["plain_k5_calls"]
                       or r["plain_k6_calls"] for r in ranks)):
            fail(f"phase 16(a): K1 launched {k1} times, K5 {k5}, K9 {k9}, "
                 f"K10 {k10}, K12 {k12} (expected {world * (n_frames - 1)} "
                 f"each), K11 {k11} (twice that), K6 {k6} (expected "
                 f"{world * n_frames}); plain K1 "
                 f"{[r['plain_k1_calls'] for r in ranks]}, plain K5 / K10 "
                 f"/ K11 {[r['plain_k5_calls'] for r in ranks]}, plain K6 "
                 f"/ K9 / K11 / K12 "
                 f"{[r['plain_k6_calls'] for r in ranks]}")
        r0 = ranks[0]
        for r in ranks:
            print(f"phase 16(a): rank {r['rank']} band {r['band']} "
                  f"{r['shape']}: I {r['i_ms']} ms, P steps {r['p_step_ms']}"
                  f" ms (fenced, halo exchange included), halo decode == "
                  f"band {r['halo_decode_equal']}, K1 {r['k1_launches']}, "
                  f"K5 {r['k5_launches']}, K6 {r['k6_launches']}, K9 "
                  f"{r['k9_launches']}, K10 {r['k10_launches']}, K11 "
                  f"{r['k11_launches']} (halo=True, encode and decode), K12 "
                  f"{r['k12_launches']} (counts summed over the rows group) "
                  f"[{card}]")
        print(f"phase 16(a): BASELINE config 5 cut to one card: "
              f"{SHARD_STREAMS} x {SHARD_W}x{SHARD_H} 'rigid', I + "
              f"{n_frames - 1} P at QP {SHARD_QP} (GOP depth cut to "
              f"{n_frames} frames), mesh {SHARD_MESH} over {world} gloo "
              f"ranks on one card, fused halo: gathered symbols, recon and "
              f"motion == the unsharded encode ({r0['compared']} tensors, "
              f"unsharded {r0['unsharded_ms']} ms on rank 0); "
              f"{r0['crossing_mbs']} MBs with a vertical MV across the "
              f"band edge; K1 {k1} launches, plain K1 none; K5 {k5} "
              f"launches (the halo decodes), plain K5 none; K6 {k6} "
              f"launches (I and P steps), plain K6 none; frames made in "
              f"{t_made - t_phase:.1f} s, ranks {t_a - t_made:.1f} s "
              f"[{card}]")

        # (b) and (c) in their own processes while (d) runs here: the
        # bench's two host layouts one after the other (a thread waits on
        # them), the stream-parallel layout and the NCCL rank beside them
        sp_procs = multihost.start_layout(tmp, "sp", 2, 1, False, None, 2,
                                          832, 480, str(dev))
        # the 1-rank group's bootstrap stays on the loopback: one host
        nccl_procs = start_procs(
            [[sys.executable, "-c", "import sys, chip_smoke; "
              "chip_smoke.nccl_rank(*sys.argv[1:])", tmp, str(dev)]], tmp,
            "nccl", {"NCCL_SOCKET_IFNAME": "lo"})
        pool = ThreadPoolExecutor(1)
        mh_bench = pool.submit(multihost.measure, (1, 2), 2, 832, 480,
                               str(dev), 300)
        pool.shutdown(wait=False)
        try:
            phase_device_pack(dev, np, card, launches, torch)
        except BaseException:
            kill_procs(sp_procs + nccl_procs)
            raise
        nccl_res = wait_procs(nccl_procs, 300, "phase 16(c)",
                              "NCCL_RESULT ")[0]
        try:
            sp_res = multihost.collect(sp_procs, 300)
            mh_line = mh_bench.result()
        except (RuntimeError, AssertionError,
                subprocess.TimeoutExpired) as e:
            fail(f"phase 16(b): {e}")
    for r in sp_res:
        if not r["bitexact"] or (r["k1_launches"], r["k9_launches"]) != (2, 2):
            fail(f"phase 16(b): multihost worker {r}")
    if mh_line["k1_launches"] != [2] * 4 or mh_line["k9_launches"] != [2] * 4:
        fail(f"phase 16(b): bench.multihost {mh_line}")
    print(f"phase 16(b): bench.multihost.measure, mesh 1x2 over 2 gloo "
          f"processes on the card, 832x480, one host then two hosts with "
          f"the rows across them: bitexact in both (its P steps beside the "
          f"other phase-16 work, so no scaling figure): {json.dumps(mh_line)}")
    print(f"phase 16(b): python -m tpuh264_torch.dist.multihost, 2 gloo "
          f"processes on the card, 832x480, stream-parallel mesh "
          f"{sp_res[0]['mesh']}, fused halo {sp_res[0]['fused_halo']}: "
          f"bitexact in both; P step "
          f"{[round(r['p_step_ms'], 1) for r in sp_res]} ms [{card}]")
    if (not nccl_res["equal_unsharded"] or nccl_res["backend"] != "nccl"
            or nccl_res["k1_launches"] != 2 or nccl_res["k9_launches"] != 2):
        fail(f"phase 16(c): {nccl_res}")
    print(f"phase 16(c): a 1-rank NCCL group, mesh 1x1, sharded_gop_step "
          f"854x480 x 8 ({nccl_res['shape']}), I + 2 P: == the unsharded "
          f"encode (NCCL between cards not checked: one card) [{card}]")
    launches.total[0] += (k1 + sum(r["k1_launches"] for r in sp_res)
                          + sum(mh_line["k1_launches"])
                          + nccl_res["k1_launches"])
    launches.total[4] += k5
    launches.total[5] += k6
    launches.total[8] += (k9 + sum(r["k9_launches"] for r in sp_res)
                          + sum(mh_line["k9_launches"])
                          + nccl_res["k9_launches"])
    launches.total[9] += k10
    launches.total[10] += k11
    launches.total[11] += k12
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
                                needs=(1, 2, 12))
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
            duration_s=5, device=dev), needs=Launches.NEEDS_SRC)
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


def phase_probe(card, launches) -> None:
    """Phase 17: the toolchain probe's own entry point on the card, `python
    -m tpuh264_torch.kernels.probe`'s body: both match lines True, P1 and
    P2 launched once each, neither plain version called."""
    import contextlib
    import io

    from tpuh264_torch.kernels import probe

    out = io.StringIO()

    def drive():
        with contextlib.redirect_stdout(out):
            return probe.main(["--device", "cuda"])

    rc, counts = launches.path("toolchain probe", drive,
                               needs=Launches.PROBE)
    lines = out.getvalue().splitlines()
    if rc != 0 or lines != ["match: True", "grid sum match: True"]:
        fail(f"phase 17: the probe returned {rc} and printed {lines}")
    if [counts[i] for i in Launches.PROBE] != [1, 1]:
        fail(f"phase 17: the probe launched P1 / P2 "
             f"{[counts[i] for i in Launches.PROBE]} times, not once each")
    print(f"phase 17: the toolchain probe (tpuh264_torch.kernels.probe "
          f"--device cuda) printed {lines}; P1 and P2 launched once each "
          f"[{card}]")


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

    rows = phase_kernels(dev, torch, np, card)
    phase_small(dev, torch, np)
    phase_small_sessions(dev, np)

    launches = Launches()
    launches.path("main path 1080p x 4",
                  lambda: phase_main(dev, torch, np, card),
                  needs=Launches.NEEDS_SRC)
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
    phase_probe(card, launches)

    totals = launches.by_key()
    for r in rows:
        r["launches"] = totals[r["key"]]
    print(f"launches summed over the driven paths: K1 {launches.total[0]}, "
          f"K2 {launches.total[1]}, K3 {launches.total[2]}, K4 (deblock) "
          f"{launches.total[3]}, K5 (intra recon) {launches.total[4]}, K6 "
          f"(intra16 encode) {launches.total[5]}, K7 (wavefront encode) "
          f"{launches.total[6]}, K8 (wavefront decode) {launches.total[7]}, "
          f"K9 (P encode) {launches.total[8]}, K10 (P decode) "
          f"{launches.total[9]}, K11 (references) {launches.total[10]}, "
          f"K12 (stage-A winner) {launches.total[11]}, K13 (CAVLC "
          f"prologue) {launches.total[12]}, K14 (SSE) {launches.total[13]}, "
          f"K15 (device source) {launches.total[14]}, P1 (probe bits) "
          f"{launches.total[15]}, P2 (probe slab sum) {launches.total[16]}; "
          f"of K9's and K10's, their t8 routes {launches.t8_total[0]} / "
          f"{launches.t8_total[1]}; of K5's and K6's, their Intra_4x4 "
          f"routes {launches.i44_total} / {launches.k6_i44_total}")
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
