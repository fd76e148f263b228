"""Where a tpuh264_torch GOPDevicePipeline dispatch spends its time, on a GPU.

    python3 tools/profile_torch_gop.py [--width 1920 --height 1080
        --streams 4 --bitrate 4000000 --dispatches 3]

Runs warm-up dispatches, then:

  1. per-stage wall time of interior `pump_frame()` dispatches, each
     stage fenced by torch.cuda.synchronize() (so a stage's time includes
     its device work): source, I encode, P encode, deblock (encoder and
     decoder), entropy (I / P), wire download, native parse, P decode,
     and inside them their sub-stages (also counted in the stage that
     calls them): the reference build of the P encode and of the P
     decode (`p_encode.references`, `p_decode.references`: K11, which
     writes the uint8 half-pel planes, rows 16-byte aligned, that K1, K9
     and K10 read as bytes in `p_encode` and `p_decode`), the
     stage-A winner (`p_encode.winner`: K12) and the decode's intra
     reconstruction (`p_decode.intra_scan`: K5);
  2. the same for one GOP-start dispatch (`force_idr()`: an I frame and
     three P frames);
  3. one dispatch under torch.profiler: device-busy share (the union of
     the CUDA kernels' intervals over wall time), kernel launches, and
     the top operators by host and by device time.

Fencing serialises host and device, so stage times add up to more than
an unfenced dispatch; they rank the stages, they are not the rate.
"""

import argparse
import collections
import functools
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

from tpuh264_torch.engine import CodecConfig, devpipe  # noqa: E402

STAGES = collections.defaultdict(float)
COUNTS = collections.Counter()
OUTER = []  # the fenced stages being timed, outermost first


def _fenced(name, fn):
    """`fn` timed under `name` ("{outer}" in it: the stage that calls it),
    synchronised before and after."""
    @functools.wraps(fn)
    def wrapper(*a, **kw):
        label = name.format(outer=OUTER[-1] if OUTER else "other")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        OUTER.append(label)
        try:
            out = fn(*a, **kw)
        finally:
            OUTER.pop()
        torch.cuda.synchronize()
        STAGES[label] += time.perf_counter() - t0
        COUNTS[label] += 1
        return out
    return wrapper


def _instrument():
    dp = devpipe
    dp.device_source_gop = _fenced("source", dp.device_source_gop)
    dp.iframe.encode_iframe_rows = _fenced("i_encode",
                                           dp.iframe.encode_iframe_rows)
    dp.pframe.encode_pframe_rows_multi = _fenced(
        "p_encode", dp.pframe.encode_pframe_rows_multi)
    dp.pframe.decode_pframe_rows_multi = _fenced(
        "p_decode", dp.pframe.decode_pframe_rows_multi)
    dp.pframe._intra_recon_scan = _fenced("{outer}.intra_scan",
                                          dp.pframe._intra_recon_scan)
    dp.pframe._references = _fenced("{outer}.references",
                                    dp.pframe._references)
    dp.pframe._int_winner = _fenced("{outer}.winner", dp.pframe._int_winner)
    dp.kdeblock.deblock_i = _fenced("deblock", dp.kdeblock.deblock_i)
    dp.kdeblock.deblock_p = _fenced("deblock", dp.kdeblock.deblock_p)
    dp.entropy_gpu.encode_bits_iframe = _fenced(
        "entropy_i", dp.entropy_gpu.encode_bits_iframe)
    dp.entropy_gpu.encode_bits_pframe = _fenced(
        "entropy_p", dp.entropy_gpu.encode_bits_pframe)
    dp.entropy_native.parse_dispatch_compact = _fenced(
        "parse", dp.entropy_native.parse_dispatch_compact)
    dp.GOPDevicePipeline._download = _fenced(
        "wire_download", dp.GOPDevicePipeline._download)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--width", type=int, default=1920)
    ap.add_argument("--height", type=int, default=1080)
    ap.add_argument("--streams", type=int, default=4)
    ap.add_argument("--bitrate", type=int, default=4_000_000)
    ap.add_argument("--dispatches", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA device")
    cfg = CodecConfig(width=args.width, height=args.height,
                      streams=args.streams, qp=None, bitrate=args.bitrate,
                      intra_in_p=False)
    pipe = devpipe.GOPDevicePipeline(cfg, gop_size=32, source_kind="rigid",
                                     device="cuda")
    pipe.pump_frame()  # GOP start
    pipe.pump_frame()
    torch.cuda.synchronize()
    _instrument()
    def stages(what, n):
        STAGES.clear()
        COUNTS.clear()
        t0 = time.perf_counter()
        for _ in range(n):
            pipe.pump_frame()
        wall = time.perf_counter() - t0
        print(f"config {args.width}x{args.height} x {args.streams}, {n} "
              f"{what}, fenced wall {wall / n:.3f} s/dispatch")
        for k, v in sorted(STAGES.items(), key=lambda kv: -kv[1]):
            print(f"  stage {k:20s} {v / n * 1e3:10.1f} ms/dispatch "
                  f"({COUNTS[k] // n} calls/dispatch, {100 * v / wall:.1f}%)")

    stages("interior dispatches", args.dispatches)
    pipe.force_idr()
    stages("GOP-start dispatch", 1)

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pipe.pump_frame()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType

    # device busy = union of the kernels' intervals (an event listed
    # twice, or kernels that overlap, count once)
    spans = sorted({(e.time_range.start, e.time_range.end)
                    for e in prof.events() if e.device_type == DeviceType.CUDA})
    dev_us, end = 0, float("-inf")
    for a, b in spans:
        if b > end:
            dev_us += b - max(a, end)
            end = b
    events = prof.key_averages()
    print(f"profiled dispatch: wall {wall:.3f} s, device kernels "
          f"{len(spans)}, device busy {dev_us / 1e6:.3f} s "
          f"({100 * dev_us / 1e6 / wall:.1f}% of wall)")
    print(events.table(sort_by="self_cpu_time_total", row_limit=12))
    sort_dev = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    print(events.table(sort_by=sort_dev, row_limit=12))


if __name__ == "__main__":
    main()
