"""Device-resident multi-stream pipelines on a PyTorch device.

Port of tpuh264/engine/devpipe.py: `GOPDevicePipeline` (IPPP, decode
from bits) and `DevicePipeline` (I-only, fan-out decode from device
symbols).

`GOPDevicePipeline`: S streams ride the leading batch axis of every
kernel; each dispatch advances all of them by FRAMES_PER_DISPATCH GOP
positions (an IDR at GOP start, P frames otherwise: quarter-pel ME/MC
against 1..4 previous deblocked reconstructions, with or without
intra-in-P).  Per dispatch:

  device  source (or the upload of host frames) -> I encode (GOP start)
          -> P encode chain -> deblock -> CAVLC slice payloads (K2 + K3)
          -> wire metadata
  host    one metadata download, payload compaction on the device at
          the exact size, one payload download, NAL framing
  host    native CAVLC parse of the annex-B bytes (th264_parse_dispatch_
          compact, shared with tpuh264); with `fanout` N every parsed
          record is replicated to N decode streams
  device  record scatter -> P decode (intra records for the I frame) ->
          deblock on an independent decoder DPB (S * N streams) -> SSE

Both DPBs stay on the device across dispatches, each plane one uint8
[N, S, H, W] tensor used as a ring (`dpb_refs`, `dpb_advance`,
`dpb_fill`): the newest frame in slot `_head_enc` / `_head_dec`, older
ones after it; with one reference (the RTC preset) the ring is one slot.
K11 reads the slots by pointer, newest first; the deblock (K4's ring
entry) writes each frame straight into the oldest slot, which becomes the
newest -- free by then, as K11 has already built the frame's reference
planes from it, and K1 / K9 / K10 read those planes, never the slot.
The decoder's SSE (K14, exact int64) reads each decoded frame's slot
right after its deblock, before a later frame of the dispatch takes the
slot, against the source frames the encode of the same dispatch built.
Eager PyTorch compiles nothing per shape, so the JAX
version's sticky payload budgets, record-cap buckets, `freeze_shapes`
and DevicePipeline's fixed-size wire bucket (`BUCKET_W`, with its
full-slab fallback) are gone: every payload is compacted to its exact
size once the byte counts are known, and the decode scatter takes the
exact records.

On a CUDA device the wire downloads run on a side stream behind an event
recorded after the dispatch's encode, so in `run()` they overlap the
next dispatch's encode (as the JAX version's per-buffer readiness did);
`dev_wait` is the time spent waiting on that event.
"""

from __future__ import annotations

import contextlib
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..core import nal
from ..core.params import PPS, SPS, param_sets
from ..core.sliceheader import SLICE_P
from ..entropy import native as entropy_native
from ..entropy.device_pack import slice_headers_device
from ..kernels import deblock as kdeblock
from ..kernels import entropy_gpu, iframe, pframe
from ..kernels import sse as ksse
from .config import CodecConfig
from .metrics import StatsWindow
from .ratecontrol import RateController
from .sources import device_source_frames, device_source_gop

I32 = torch.int32


def _compact(hw: torch.Tensor, nbytes: np.ndarray) -> torch.Tensor:
    """The used words of every slice, contiguous in slice order: the wire
    carries the content's size, not L x SLICE_W slabs."""
    flat = hw.reshape(-1, hw.shape[-1])
    wc = (nbytes.reshape(-1).astype(np.int64) + 3) // 4
    total = int(wc.sum())
    dev = hw.device
    wc_t = torch.from_numpy(wc).to(dev)
    sl = torch.repeat_interleave(torch.arange(len(wc), device=dev), wc_t,
                                 output_size=total)
    offs = torch.cumsum(wc_t, 0) - wc_t
    col = torch.arange(total, device=dev) - offs[sl]
    return flat[sl, col]


def _slices(pay_words: np.ndarray, nbytes: np.ndarray) -> list:
    """Per-slice RBSP byte strings from a contiguous compacted payload."""
    blob = pay_words.view(np.uint32).astype(">u4").tobytes()
    nbytes = nbytes.reshape(-1)
    wc = (nbytes.astype(np.int64) + 3) // 4
    offs = np.zeros(len(wc) + 1, np.int64)
    np.cumsum(wc, out=offs[1:])
    return [blob[4 * offs[i]:4 * offs[i] + int(nbytes[i])]
            for i in range(len(wc))]


def _fetch(side, done, meta_dev: torch.Tensor, payloads):
    """Download one dispatch's metadata vector, then the device tensors
    `payloads(meta)` returns, as numpy.  On a CUDA device the copies run
    on the `side` stream behind `done` (the event recorded after that
    dispatch's encode): they wait for that dispatch, not for work queued
    after it."""
    ctx = (torch.cuda.stream(side) if side is not None
           else contextlib.nullcontext())
    with ctx:
        if done is not None:
            side.wait_event(done)
        meta = meta_dev.cpu().numpy()
        return meta, [p.cpu().numpy() for p in payloads(meta)]


def resolve_device(device) -> torch.device:
    """The pipelines' device: the card unless the caller names another.
    A CUDA device on a machine without one raises; nothing falls back to
    the CPU."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} requested (the default) but "
            "torch.cuda.is_available() is False: pass device='cpu' to run "
            "on the CPU")
    return device


def scatter_records(mb_pos, mb_fields, cpos, cval, lead, r: int, c: int,
                    upload, device):
    """`parse_dispatch_compact`'s records as dense tensors on `device`:
    MB fields [*lead, r, c, 9] int32 and coefficient slots [*lead, r, c,
    MB_SLOTS] int16 (`upload` moves a numpy array there).  The records
    scatter onto buffers with one dead trailing slot (the JAX version's
    mode="drop"): an out-of-range record lands there."""
    lim_m = int(np.prod(lead)) * r * c
    pos = upload(mb_pos.astype(np.int64)).clamp(max=lim_m)
    mbf = torch.zeros((lim_m + 1, 9), dtype=I32, device=device)
    mbf[pos] = upload(mb_fields).to(I32)
    lim_c = lim_m * entropy_native.MB_SLOTS
    cp = upload(cpos.astype(np.int64)).clamp(max=lim_c)
    coef = torch.zeros(lim_c + 1, dtype=torch.int16, device=device)
    coef[cp] = upload(cval)
    return (mbf[:-1].reshape(*lead, r, c, 9),
            coef[:-1].reshape(*lead, r, c, entropy_native.MB_SLOTS))


def record_symbols(m: torch.Tensor, cf: torch.Tensor) -> pframe.MBSymbolsP:
    """One frame's symbols from its dense records: MB fields m [..., 9] =
    (kind, mode, cmode, cbp_luma, cbp_chroma, mvdx, mvdy, refidx, -) and
    coefficient slots cf [..., 400] = [luma DC 16 | luma AC 16x16 |
    chroma DC 2x4 | chroma AC 2x4x15]."""
    lead = m.shape[:-1]
    return pframe.MBSymbolsP(
        kind=m[..., 0], mode=m[..., 1], cmode=m[..., 2], cbp_luma=m[..., 3],
        cbp_chroma=m[..., 4], mvdx=m[..., 5], mvdy=m[..., 6],
        luma_dc=cf[..., :16], luma_ac=cf[..., 16:272].reshape(*lead, 16, 16),
        chroma_dc=cf[..., 272:280].reshape(*lead, 2, 4),
        chroma_ac=cf[..., 280:400].reshape(*lead, 2, 4, 15),
        refidx=m[..., 7], t8=torch.zeros_like(m[..., 0]))


def dpb_refs(dpb, head: int, n: int):
    """The n newest references of a DPB ring (three uint8 planes [N, S,
    H, W], the newest in slot `head`, older ones after it): per plane the
    list of slot views [S, H, W], newest first."""
    slots = [(head + i) % dpb[0].shape[0] for i in range(n)]
    return tuple([p[i] for i in slots] for p in dpb)


def dpb_advance(dpb, head: int):
    """The ring's oldest slot, which becomes the newest: (the new head,
    the slot's three plane views [S, H, W]), for the next frame to be
    written into (the deblock writes it there)."""
    head = (head - 1) % dpb[0].shape[0]
    return head, tuple(p[head] for p in dpb)


def dpb_fill(dpb) -> int:
    """An IDR, which slot 0 holds: its planes copied into every other
    slot (the never-selected extra references stay well-formed; no copy
    with one slot).  Returns the head, 0."""
    for p in dpb:
        if p.shape[0] > 1:
            p[1:].copy_(p[0][None].expand_as(p[1:]))
    return 0


def _snapshot(slot: torch.Tensor) -> np.ndarray:
    """A DPB slot as an int32 numpy copy (the planes' values, as the JAX
    pipeline returns them), which later pushes into the ring leave as it
    is."""
    return slot.cpu().numpy().astype(np.int32)


def _psnr(sse: float, npix: int) -> float:
    mse = sse / npix
    return 99.0 if mse == 0 else float(10 * np.log10(255.0 ** 2 / mse))


class DevicePipeline:
    """I-only multi-frame pipeline: encode -> wire bitstream, and an
    N-stream fan-out decode from the device symbols, in one dispatch.

    Each dispatch encodes FRAMES_PER_DISPATCH consecutive frames of one
    device source as IDR access units (the frames ride the batch axis)
    and decodes every frame `streams` times, on `device` (the card by
    default)."""

    # frames encoded per device dispatch
    FRAMES_PER_DISPATCH = 4

    def __init__(self, config: Optional[CodecConfig] = None,
                 source_kind: str = "moving_gradient", *,
                 device="cuda", **kw):
        if config is None:
            config = CodecConfig(**kw)
        self.config = config
        self.source_kind = source_kind
        self.device = resolve_device(device)
        self.w16 = (config.width + 15) // 16 * 16
        self.h16 = (config.height + 15) // 16 * 16
        self.sps = SPS.for_size(config.width, config.height)
        self.pps = PPS()
        self.stats = StatsWindow()
        self.frame_index = 0
        self.last_stream: bytes = b""
        self.frame_streams: list = []
        self.last_psnr_y: float = 0.0
        self.fallback_packs = 0  # dispatches repacked on host (overflow)
        self._hdr = None
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None

    def _step(self, t: int, qp: int):
        """The dispatch's device work: (symbols, slice words, meta), meta =
        [entropy overflow | slice bytes (K*R) | SSE float32 bits
        (K*streams)] int32."""
        k = self.FRAMES_PER_DISPATCH
        streams = self.config.streams
        y, u, v = device_source_frames(self.w16, self.h16, k,
                                       self.source_kind, t, self.device)
        symbols, _ = iframe.encode_iframe_rows(y, u, v, qp)
        slice_hw, slice_bytes, ovf = entropy_gpu.encode_bits_iframe(
            symbols, qp, *self._hdr)
        tiled = iframe.MBSymbols(*(x.repeat_interleave(streams, 0)
                                   for x in symbols))
        dy, _, _ = iframe.decode_iframe_rows(tiled, qp)
        d = (dy.to(torch.float32)
             - y.to(torch.float32).repeat_interleave(streams, 0))
        sse = (d * d).reshape(k * streams, -1).sum(-1)  # [K*streams]
        meta = torch.cat([ovf.to(I32).reshape(1), slice_bytes.reshape(-1),
                          sse.contiguous().view(I32)])
        return symbols, slice_hw, meta

    def _dispatch(self, qp: int):
        """Issue one dispatch's device work without synchronizing."""
        if self._hdr is None:
            self._hdr = slice_headers_device(
                self.sps, self.pps, qp, 0, True, self.FRAMES_PER_DISPATCH,
                device=self.device)
        symbols, slice_hw, meta = self._step(self.frame_index, qp)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        self.frame_index += self.FRAMES_PER_DISPATCH
        self.stats.on_input(self.FRAMES_PER_DISPATCH)
        return symbols, slice_hw, meta, done

    def _sse(self, meta: np.ndarray) -> np.ndarray:
        k = self.FRAMES_PER_DISPATCH
        off = 1 + k * (self.h16 // 16)
        return meta[off:off + k * self.config.streams].view(np.float32)

    def pump_frame(self) -> None:
        """Encode/decode one dispatch (FRAMES_PER_DISPATCH frames)."""
        cfg = self.config
        qp = cfg.qp if cfg.qp is not None else 32
        k = self.FRAMES_PER_DISPATCH
        t_in = time.perf_counter()
        handles = self._dispatch(qp)
        t_dev = time.perf_counter()
        sse = self._consume(handles, qp)
        t_done = time.perf_counter()
        self.last_psnr_y = _psnr(float(sse[0]), self.w16 * self.h16)
        self.stats.on_encode(k, (t_dev - t_in) * 1e3, 0.0,
                             (t_done - t_dev) * 1e3, len(self.last_stream))
        self.stats.on_decode(k * cfg.streams, (t_dev - t_in) * 1e3)

    def _consume(self, handles, qp: int) -> np.ndarray:
        """Retire one dispatch (K frames): the metadata download, then the
        exact-size payload download and NAL framing.  Device-entropy
        overflow (MB / slice bit caps, e.g. QP-0 noise) repacks on the
        host from the symbol tensors.  Returns the [K*streams] SSE."""
        symbols, slice_hw, meta_dev, done = handles
        k = self.FRAMES_PER_DISPATCH
        r = self.h16 // 16
        meta, pays = _fetch(
            self._side, done, meta_dev,
            lambda m: [] if m[0] else [_compact(slice_hw, m[1:1 + k * r])])
        sse = self._sse(meta)
        if meta[0]:  # device entropy overflow: repack on host
            self._host_pack_i(symbols, qp)
            return sse
        rbsp = _slices(pays[0], meta[1:1 + k * r])
        self.frame_streams = []
        for f in range(k):
            self._frame_nals(rbsp[f * r:(f + 1) * r])
            self.frame_streams.append(self.last_stream)
        return sse

    def _frame_nals(self, rbsps) -> None:
        """SPS/PPS + per-slice NAL framing of raw RBSP payloads."""
        out = bytearray(param_sets(self.sps, self.pps))
        hdr_byte = bytes([(3 << 5) | nal.NAL_SLICE_IDR])
        for rbsp in rbsps:
            out += nal.START_CODE + hdr_byte + entropy_native.escape_rbsp(rbsp)
        self.last_stream = bytes(out)

    def _host_pack_i(self, symbols, qp: int) -> None:
        """Device-entropy overflow fallback: the host CAVLC packer on the
        downloaded symbol tensors (a conformant stream for any content)."""
        self.fallback_packs += 1
        k = self.FRAMES_PER_DISPATCH
        n = (self.h16 // 16) * (self.w16 // 16)
        npy = lambda x, *sh: x.cpu().numpy().reshape(k, n, *sh)
        mode, cmode = npy(symbols.mode), npy(symbols.cmode)
        cbp_l, cbp_c = npy(symbols.cbp_luma), npy(symbols.cbp_chroma)
        luma_dc, luma_ac = npy(symbols.luma_dc, 16), npy(symbols.luma_ac,
                                                          16, 16)
        chroma_dc = npy(symbols.chroma_dc, 2, 4)
        chroma_ac = npy(symbols.chroma_ac, 2, 4, 15)
        self.frame_streams = []
        for f in range(k):
            mb_info = np.ascontiguousarray(np.stack(
                [mode[f], cmode[f], cbp_l[f], cbp_c[f]], axis=1), np.int32)
            self.last_stream = entropy_native.pack_iframe(
                mb_info, luma_dc[f], luma_ac[f], chroma_dc[f], chroma_ac[f],
                self.sps, self.pps, qp, frame_num=0, deblock_idc=1)
            self.frame_streams.append(self.last_stream)

    def decode_bytes(self, stream: bytes):
        """The port's own decode of one of `frame_streams` (an IDR access
        unit): the native CAVLC parse, then the I reconstruction scan.
        Returns (the slice QP, (y, u, v) uint8 [1, H16, W16 (/2)])."""
        r, c = self.h16 // 16, self.w16 // 16
        qp, *recs = entropy_native.parse_dispatch_compact(
            [stream], c, r, self.sps, self.pps, threads=self.config.threads)
        up = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(
            self.device)
        sym = record_symbols(*scatter_records(*recs, (1,), r, c, up,
                                              self.device))
        return qp, iframe.decode_iframe_scan(iframe.MBSymbols(
            *(getattr(sym, f) for f in iframe.MBSymbols._fields[:8])), qp)

    def _retire(self, handles, qp: int) -> None:
        """Consume one dispatch (K frames) and update stats."""
        k = self.FRAMES_PER_DISPATCH
        sse = self._consume(handles, qp)
        self.last_psnr_y = _psnr(float(sse[0]), self.w16 * self.h16)
        self.stats.on_encode(k, 0.0, 0.0, 0.0, len(self.last_stream))
        self.stats.on_decode(k * self.config.streams, 0.0)

    def run(self, duration_s: float = 5.0, warmup: int = 3
            ) -> Dict[str, float]:
        """Measurement loop with one-dispatch-deep software pipelining: the
        host retires dispatch t (metadata, payload download, escaping, NAL
        framing) while the device executes dispatch t+1."""
        qp = self.config.qp if self.config.qp is not None else 32
        for _ in range(warmup):
            self.pump_frame()
        self.stats.snapshot(self.config.streams)
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + duration_s
        pending = None
        while time.perf_counter() < deadline:
            handles = self._dispatch(qp)
            if pending is not None:
                self._retire(pending, qp)
                n += self.FRAMES_PER_DISPATCH
            pending = handles
        if pending is not None:
            self._retire(pending, qp)
            n += self.FRAMES_PER_DISPATCH
        wall = time.perf_counter() - t0
        snap = self.stats.snapshot(self.config.streams)
        snap["frames"] = n
        snap["pipeline_fps"] = n / wall
        snap["frames_per_s_aggregate"] = n * self.config.streams / wall
        snap["psnr_y"] = self.last_psnr_y
        snap["stream_bytes"] = len(self.last_stream)
        return snap


class GOPDevicePipeline:
    """IPPP multi-stream RTC pipeline with decode-from-bits, on `device`.

    Sources: device ("rigid", "noise", "moving_gradient") or "host",
    where `pump_host_frames` feeds each dispatch's frames and the upload
    is timed (`last_copy_ms`, stage "copy").  Fixed QP or CBR; intra-in-P
    or the RTC preset; 1..4 references; `fanout` N decodes every encoded
    stream N times (decode stream ss*N+fi carries encoded stream ss), on
    a decoder DPB S*N streams wide.  The DPB halo (row sharding) is not
    ported.  `device` is the card unless the caller asks for another."""

    FRAMES_PER_DISPATCH = 4
    MB_SLOTS = entropy_native.MB_SLOTS  # coefficient slots per parsed MB

    def __init__(self, config: Optional[CodecConfig] = None,
                 gop_size: int = 16, source_kind: str = "moving_gradient",
                 fanout: int = 1, *, device="cuda", **kw):
        if config is None:
            config = CodecConfig(**kw)
        self.config = config
        self.source_kind = source_kind
        self.fanout = max(1, fanout)
        self.s_dec = config.streams * self.fanout
        self.device = resolve_device(device)
        k = self.FRAMES_PER_DISPATCH
        if gop_size % k:
            raise ValueError("gop_size must be a multiple of "
                             f"FRAMES_PER_DISPATCH={k}")
        self.gop_dispatches = gop_size // k
        self.n_refs = max(1, config.num_ref_frames)
        if self.n_refs > k:
            raise ValueError(
                f"num_ref_frames {self.n_refs} > FRAMES_PER_DISPATCH {k}")
        self.w16 = (config.width + 15) // 16 * 16
        self.h16 = (config.height + 15) // 16 * 16
        self.sps = SPS.for_size(config.width, config.height)
        if self.n_refs > 1:
            self.sps.max_num_ref_frames = self.n_refs
        if gop_size > (1 << (self.sps.log2_max_frame_num_minus4 + 4)):
            raise ValueError("gop_size exceeds max_frame_num")
        self.pps = PPS()
        self.stats = StatsWindow()
        self.dispatch_index = 0
        # GOP phase decoupled from the time axis: _gop_pos drives
        # frame_num/IDR cadence, dispatch_index + time_offset the source
        # clock (drop_frames advances time_offset past dropped frames)
        self._gop_pos = 0
        self.time_offset = 0
        self.last_stream: bytes = b""
        self.frame_streams: list = []
        self.last_psnr_y: float = 0.0
        self.fallback_packs = 0  # dispatches repacked on host (overflow)
        self.qp_mismatches = 0   # slice-header QP != pipeline QP (stats)
        self._dpb_enc = self._zero_dpb(config.streams)
        self._dpb_dec = self._zero_dpb(self.s_dec)
        self._head_enc = self._head_dec = 0  # the rings' newest slots
        self._host_frames = None  # pending host YUV (source_kind "host")
        self._staging: Dict[int, torch.Tensor] = {}  # pinned, per plane
        self.last_copy_ms = 0.0
        self._sse_dev = None  # decode-side SSE [k, S*fanout] int64
        self.rc = RateController(config)
        self._cuda = self.device.type == "cuda"
        self._side = torch.cuda.Stream(self.device) if self._cuda else None
        self.stage_ms = {"wire": 0.0, "dev_wait": 0.0, "d2h": 0.0,
                         "parse": 0.0, "dec_dispatch": 0.0,
                         "enc_dispatch": 0.0, "copy": 0.0, "n": 0}

    def _zero_dpb(self, s: int):
        z = lambda h, w: torch.zeros((self.n_refs, s, h, w),
                                     dtype=torch.uint8, device=self.device)
        return (z(self.h16, self.w16), z(self.h16 // 2, self.w16 // 2),
                z(self.h16 // 2, self.w16 // 2))

    # -- headers ---------------------------------------------------------

    def _headers(self, pos: int, qp: int):
        """Slice-header strings for GOP position `pos` (dispatch index
        within the GOP): (hdr_i or None, hdr_p stacked P-major)."""
        k = self.FRAMES_PER_DISPATCH
        s = self.config.streams
        dev = self.device
        hdr_i = None
        if pos == 0:
            hdr_i = slice_headers_device(self.sps, self.pps, qp, 0, True, s,
                                         deblock_idc=2, device=dev)
        first = pos * k + (1 if pos == 0 else 0)
        nra = 1 if pos == 0 else self.n_refs
        per = [slice_headers_device(self.sps, self.pps, qp, fn, False, s,
                                    slice_type=SLICE_P, deblock_idc=2,
                                    num_ref_active=nra, device=dev)
               for fn in range(first, pos * k + k)]
        return hdr_i, (torch.cat([p[0] for p in per], 0),
                       torch.cat([p[1] for p in per], 0))

    # -- encode ----------------------------------------------------------

    def _encode(self, start: bool, t: int, qp: int, hdr_i, hdr_p,
                frames=None):
        """The dispatch's device work on `frames` (the uploaded host
        frames, or None for the device source at time t), advancing the
        encoder DPB ring: returns (sym_i, syms_p, hw_i, hw_p, meta, the
        source luma y [k, S, H, W] uint8).  meta = [entropy overflow | I
        slice bytes (S*R, GOP start only) | P slice bytes (P*S*R)] int32.
        The P frames' symbols land in one dispatch-wide MBSymbolsP [P*S,
        R, C] (K9 writes them there on the card), which the slice stage
        reads in place."""
        k = self.FRAMES_PER_DISPATCH
        s = self.config.streams
        if frames is None:
            frames = device_source_gop(self.w16, self.h16, k, s,
                                       self.source_kind, t, self.device)
        y, u, v = frames
        dpb = self._dpb_enc
        sym_i = hw_i = bytes_i = None
        ovf = torch.zeros(1, dtype=I32, device=self.device)
        if start:
            sym_i, recon = iframe.encode_iframe_rows(y[0], u[0], v[0], qp)
            # IDR resets the DPB: deblocked into slot 0, then copied on
            kdeblock.deblock_i(recon, qp, out=tuple(p[0] for p in dpb))
            self._head_enc = dpb_fill(dpb)
            hw_i, bytes_i, _ = entropy_gpu.encode_bits_iframe(
                sym_i, qp, *hdr_i, ovf=ovf)
        # the dispatch right after an IDR caps ref_idx at the refs that
        # exist in a conformant decoder's DPB (1 after the IDR)
        nra = 1 if start else self.n_refs
        f0 = 1 if start else 0
        syms_p = pframe.empty_symbols((s * (k - f0),), self.h16 // 16,
                                      self.w16 // 16, self.device)
        for f in range(f0, k):
            out = pframe.MBSymbolsP(*(x[(f - f0) * s:(f - f0 + 1) * s]
                                      for x in syms_p))
            sym, recon, motion = pframe.encode_pframe_rows_multi(
                y[f], u[f], v[f], *dpb_refs(dpb, self._head_enc, nra), qp,
                intra_in_p=self.config.intra_in_p, out=out)
            # deblocked into the oldest slot: its reference planes are
            # built, nothing reads the slot again
            self._head_enc, slot = dpb_advance(dpb, self._head_enc)
            kdeblock.deblock_p(recon, sym, motion, qp, out=slot)
        hw_p, bytes_p, _ = entropy_gpu.encode_bits_pframe(
            syms_p, qp, *hdr_p, nra=nra, ovf=ovf)
        parts = [ovf]
        if start:
            parts.append(bytes_i.reshape(-1))
        parts.append(bytes_p.reshape(-1))
        return sym_i, syms_p, hw_i, hw_p, torch.cat(parts), y

    # -- decode-from-bits -------------------------------------------------

    def _fan_out(self, pos: np.ndarray, unit: int) -> np.ndarray:
        """Record positions [k, S, unit] -> [k, S*fanout, unit]: each
        record once per decode stream, stream ss*fanout+fi carrying
        encoded stream ss (int64 throughout)."""
        fan, se = self.fanout, self.config.streams
        kk, rest = np.divmod(pos.astype(np.int64), se * unit)
        ss, pp = np.divmod(rest, unit)
        fi = np.arange(fan, dtype=np.int64)
        return ((kk[:, None] * self.s_dec + ss[:, None] * fan + fi) * unit
                + pp[:, None]).reshape(-1)

    def _decode_dispatch(self, frames_k, qp: int, start: bool = False,
                         src=None) -> None:
        """Entropy-decode the dispatch's annex-B bytes (native threaded
        CAVLC front end) and reconstruct on the device from the parsed
        records, advancing the decoder DPB ring; then the SSE of each
        decoded luma plane against `src` (the source luma [k, S, H, W]
        uint8 the dispatch's encode read; decode stream d against encoded
        stream d // fanout), or against zeros for host-fed frames, whose
        quality the caller measures."""
        t0 = time.perf_counter()
        flat = [b for fr in frames_k for b in fr]
        r, c = self.h16 // 16, self.w16 // 16
        pqp, mb_pos, mb_fields, cpos, cval = (
            entropy_native.parse_dispatch_compact(
                flat, c, r, self.sps, self.pps, threads=self.config.threads))
        if pqp != qp:
            # a decoder trusts the bitstream: reconstruct at the QP the
            # slice headers carry; the counter keeps a mismatch visible
            self.qp_mismatches += 1
            qp = pqp
        k = self.FRAMES_PER_DISPATCH
        s = self.s_dec
        n = r * c
        fan = self.fanout
        if fan > 1:
            mb_pos = self._fan_out(mb_pos, n)
            mb_fields = np.repeat(mb_fields, fan, axis=0)
            cpos = self._fan_out(cpos, n * self.MB_SLOTS)
            cval = np.repeat(cval, fan, axis=0)
        t1 = time.perf_counter()
        dev = self.device
        mbf, coef = scatter_records(mb_pos, mb_fields, cpos, cval, (k, s),
                                    r, c, self._upload, dev)

        dpb, n_refs = self._dpb_dec, self.n_refs
        ref = None if self.source_kind == "host" else src
        sse = torch.empty((k, s), dtype=torch.int64, device=dev)
        for f in range(k):
            sym = record_symbols(mbf[f], coef[f])
            recon, motion = pframe.decode_pframe_rows_multi(
                sym, *dpb_refs(dpb, self._head_dec, n_refs), qp)
            # the DPB mirrors the encoder's: an IDR into slot 0 and on
            # into every slot, other frames into the oldest slot
            idr = f == 0 and start
            head, slot = ((0, tuple(p[0] for p in dpb)) if idr
                          else dpb_advance(dpb, self._head_dec))
            kdeblock.deblock_p(recon, sym, motion, qp, out=slot)
            self._head_dec = dpb_fill(dpb) if idr else head
            # the frame's SSE before a later frame's deblock takes the slot
            ksse.sse([slot[0]], None if ref is None else ref[f:f + 1], fan,
                     out=sse[f:f + 1])
        self.stage_ms["parse"] += (t1 - t0) * 1e3
        self.stage_ms["dec_dispatch"] += (time.perf_counter() - t1) * 1e3
        self._sse_dev = sse

    def _upload(self, arr: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if self._cuda:
            return t.pin_memory().to(self.device, non_blocking=True)
        return t

    # -- host loop -------------------------------------------------------

    def _take_host_frames(self):
        """Upload the pending host frames (the reference's timed pixel copy
        into codec memory).  On CUDA each plane goes through a page-locked
        staging buffer that is allocated once per shape and reused, so
        `last_copy_ms` and stage "copy" time the host memcpy into that
        buffer plus the host-to-device copy up to its completion on the
        device, and no page-locked allocation."""
        if self._host_frames is None:
            raise RuntimeError(
                "host source: feed frames via pump_host_frames()")
        stream = None
        if self._cuda:
            for i, a in enumerate(self._host_frames):
                buf = self._staging.get(i)
                if buf is None or tuple(buf.shape) != a.shape:
                    self._staging[i] = torch.empty(
                        a.shape, dtype=torch.uint8, pin_memory=True)
            stream = torch.cuda.current_stream(self.device)
            stream.synchronize()  # earlier queued work is not the copy's
        tc = time.perf_counter()
        frames = []
        for i, a in enumerate(self._host_frames):
            if stream is None:
                frames.append(torch.from_numpy(a.copy()))
                continue
            buf = self._staging[i]
            np.copyto(buf.numpy(), a)
            frames.append(buf.to(self.device, non_blocking=True))
        if stream is not None:
            # the staging buffers are free again once this returns
            stream.synchronize()
        self.last_copy_ms = (time.perf_counter() - tc) * 1e3
        self.stage_ms["copy"] += self.last_copy_ms
        self._host_frames = None
        return tuple(frames)

    def _dispatch(self):
        qp = (self.config.qp if self.config.qp is not None
              else self.rc.current_qp())
        pos = self._gop_pos % self.gop_dispatches
        start = pos == 0
        t = self.dispatch_index * self.FRAMES_PER_DISPATCH + self.time_offset
        hdr_i, hdr_p = self._headers(pos, qp)
        frames = (self._take_host_frames() if self.source_kind == "host"
                  else None)
        sym_i, syms_p, hw_i, hw_p, meta, src = self._encode(
            start, t, qp, hdr_i, hdr_p, frames)
        done = None
        if self._cuda:
            done = torch.cuda.Event()
            done.record()
        self.dispatch_index += 1
        self._gop_pos += 1
        self.stats.on_input(self.FRAMES_PER_DISPATCH)
        return (start, pos, t, sym_i, syms_p, hw_i, hw_p, meta, qp, done,
                src)

    def force_idr(self) -> None:
        """Restart the GOP at the next dispatch (ForceIntraFrame analog)."""
        self._gop_pos = 0

    def drop_frames(self, n: int) -> None:
        """Skip n source frames (capture backpressure): the encoder never
        sees them; the next encoded frame still references the last
        encoded reconstruction."""
        self.time_offset += n
        self.stats.on_drop("capture", n)

    def _download(self, handles):
        """Wait for the dispatch's encode, then download its metadata and
        its exact-size compacted payload.  Returns (meta, payload_i,
        payload_p) as numpy; payloads are None after an entropy overflow."""
        start, _, _, _, _, hw_i, hw_p, meta_dev, _, done, _ = handles
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()  # this dispatch's encode (not later work)
        t1 = time.perf_counter()
        n_i = self.config.streams * (self.h16 // 16) if start else 0

        def payloads(meta):
            if meta[0]:
                return []
            pay = [_compact(hw_i, meta[1:1 + n_i])] if start else []
            return pay + [_compact(hw_p, meta[1 + n_i:])]

        meta, pays = _fetch(self._side, done, meta_dev, payloads)
        t2 = time.perf_counter()
        self.stage_ms["dev_wait"] += (t1 - t0) * 1e3
        self.stage_ms["d2h"] += (t2 - t1) * 1e3
        if meta[0]:
            return meta, None, None
        return (meta, pays[0] if start else None, pays[-1])

    def _consume(self, handles) -> list:
        """Retire one dispatch: wire download + NAL framing.

        Appends per-stream annex-B bytes for each frame of the dispatch
        to self.frame_streams ([(stream0, ..., streamS-1), ...]) and
        returns that k-frame list.  Device-entropy overflow (MB / slice
        bit caps) repacks on the host from the symbol tensors."""
        start, pos, _, sym_i, syms_p, _, _, _, qp, _, _ = handles
        meta, pay_i, pay_p = self._download(handles)
        k = self.FRAMES_PER_DISPATCH
        s = self.config.streams
        r = self.h16 // 16
        n_p = k - 1 if start else k
        if meta[0]:  # device entropy overflow: repack on host
            self._host_pack_gop(start, pos, sym_i, syms_p, qp)
            self._rc_update(k, start)
            return self.frame_streams[-k:]
        off = 1
        if start:
            bytes_i = meta[off:off + s * r]
            off += s * r
        bytes_p = meta[off:off + n_p * s * r]

        esc = entropy_native.escape_rbsp
        if start:
            rbsp_i = _slices(pay_i, bytes_i)
            idr_hdr = bytes([(3 << 5) | nal.NAL_SLICE_IDR])
            ps = param_sets(self.sps, self.pps)
            frame = []
            for si in range(s):
                out = bytearray(ps)
                for ri in range(r):
                    out += nal.START_CODE + idr_hdr + esc(rbsp_i[si * r + ri])
                frame.append(bytes(out))
            self.frame_streams.append(tuple(frame))
        rbsp_p = _slices(pay_p, bytes_p)
        p_hdr = bytes([(2 << 5) | nal.NAL_SLICE_NON_IDR])
        for pi in range(n_p):
            frame = []
            for si in range(s):
                out = bytearray()
                for ri in range(r):
                    out += (nal.START_CODE + p_hdr
                            + esc(rbsp_p[(pi * s + si) * r + ri]))
                frame.append(bytes(out))
            self.frame_streams.append(tuple(frame))
        self.last_stream = self.frame_streams[-1][0]
        self._rc_update(k, start)
        return self.frame_streams[-k:]

    def _rc_update(self, k: int, start: bool = False) -> None:
        """Feed the CBR controller the dispatch's per-frame byte counts
        (mean across streams); a bits spike on an interior P frame at
        steady QP is a scene cut and restarts the GOP next dispatch."""
        if self.config.qp is not None:
            return
        s = self.config.streams
        cut = False
        for fi, fr in enumerate(self.frame_streams[-k:]):
            fb = sum(len(b) for b in fr) / s
            self.rc.update(fb)
            if not (start and fi == 0):  # interior P frames only
                cut |= self.rc.p_frame_is_scene_cut(fb)
        if cut and self._gop_pos != 0:
            self.force_idr()

    def _host_pack_gop(self, start, pos, sym_i, syms_p, qp: int) -> None:
        """Device-entropy overflow: host CAVLC pack from the symbol
        tensors moved to numpy (same slice headers as the device path:
        frame_num = GOP position, deblock idc 2)."""
        self.fallback_packs += 1
        k = self.FRAMES_PER_DISPATCH
        s = self.config.streams
        n = (self.h16 // 16) * (self.w16 // 16)
        n_p = k - 1 if start else k
        npy = lambda x, *sh: x.cpu().numpy().reshape(*sh)
        if start:
            mode, cmode = npy(sym_i.mode, s, n), npy(sym_i.cmode, s, n)
            cbp_l, cbp_c = npy(sym_i.cbp_luma, s, n), npy(sym_i.cbp_chroma,
                                                          s, n)
            ldc, lac = npy(sym_i.luma_dc, s, n, 16), npy(sym_i.luma_ac, s, n,
                                                         16, 16)
            cdc = npy(sym_i.chroma_dc, s, n, 2, 4)
            cac = npy(sym_i.chroma_ac, s, n, 2, 4, 15)
            frame = []
            for si in range(s):
                mb_info = np.ascontiguousarray(np.stack(
                    [mode[si], cmode[si], cbp_l[si], cbp_c[si]], axis=1),
                    np.int32)
                frame.append(entropy_native.pack_iframe(
                    mb_info, ldc[si], lac[si], cdc[si], cac[si], self.sps,
                    self.pps, qp, frame_num=0, deblock_idc=2))
            self.frame_streams.append(tuple(frame))
        fields = [npy(getattr(syms_p, f), n_p, s, n) for f in (
            "kind", "mode", "cmode", "cbp_luma", "cbp_chroma", "mvdx",
            "mvdy", "refidx")]
        ldc = npy(syms_p.luma_dc, n_p, s, n, 16)
        lac = npy(syms_p.luma_ac, n_p, s, n, 16, 16)
        cdc = npy(syms_p.chroma_dc, n_p, s, n, 2, 4)
        cac = npy(syms_p.chroma_ac, n_p, s, n, 2, 4, 15)
        first = pos * k + (1 if start else 0)
        nra = 1 if start else self.n_refs
        for pi in range(n_p):
            frame = []
            for si in range(s):
                mb_info = np.ascontiguousarray(
                    np.stack([f[pi, si] for f in fields], axis=1), np.int32)
                frame.append(entropy_native.pack_pframe(
                    mb_info, ldc[pi, si], lac[pi, si], cdc[pi, si],
                    cac[pi, si], self.sps, self.pps, qp,
                    frame_num=first + pi, deblock_idc=2,
                    num_ref_active=nra))
            self.frame_streams.append(tuple(frame))
        self.last_stream = self.frame_streams[-1][0]

    def pump_host_frames(self, y, u, v) -> None:
        """Feed one dispatch of HOST frames (source_kind="host") and run
        it synchronously: y [K, S, H, W] uint8 (u/v half-size), padded
        here to the MB grid by edge replication.  The upload is timed as
        last_copy_ms / stage "copy"."""
        k = self.FRAMES_PER_DISPATCH
        s = self.config.streams

        def padded(p, hh, ww):
            p = np.asarray(p, np.uint8).reshape(k, s, *np.shape(p)[-2:])
            ph, pw = hh - p.shape[-2], ww - p.shape[-1]
            if ph or pw:
                p = np.pad(p, ((0, 0), (0, 0), (0, ph), (0, pw)),
                           mode="edge")
            return p

        self._host_frames = (padded(y, self.h16, self.w16),
                             padded(u, self.h16 // 2, self.w16 // 2),
                             padded(v, self.h16 // 2, self.w16 // 2))
        self.pump_frame()

    def pump_frame(self) -> None:
        """Encode + parse + decode one dispatch synchronously."""
        k = self.FRAMES_PER_DISPATCH
        t0 = time.perf_counter()
        handles = self._dispatch()
        frames_k = self._consume(handles)
        self._decode_dispatch(frames_k, handles[8], start=handles[0],
                              src=handles[10])
        sse = self._sse_dev.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        self.last_psnr_y = _psnr(float(sse[-1, 0]), self.w16 * self.h16)
        total = sum(len(b) for fr in frames_k for b in fr)
        self.stats.on_encode(k * self.config.streams, dt, 0.0, 0.0, total)
        self.stats.on_decode(k * self.config.streams, dt)

    def decoded_planes(self):
        """The decoder chain's current reconstruction as numpy (post-
        deblock planes of the last decoded frame, all S*fanout streams,
        int32; a copy)."""
        return tuple(_snapshot(p[self._head_dec]) for p in self._dpb_dec)

    def encoder_planes(self):
        """The encoder DPB head as numpy, S streams (decoded_planes of
        decode stream ss*fanout+fi must equal its stream ss)."""
        return tuple(_snapshot(p[self._head_enc]) for p in self._dpb_enc)

    def stream_bytes(self, stream_index: int = 0) -> bytes:
        """Concatenated annex-B bitstream of one stream so far."""
        return b"".join(fr[stream_index] for fr in self.frame_streams)

    def run(self, duration_s: float = 5.0, warmup: int = 2
            ) -> Dict[str, float]:
        """Measurement loop, one-dispatch-deep software pipelining: while
        the device encodes dispatch t, the host retires t-1 (wire
        download, NAL framing), parses its bytes and enqueues its
        reconstruction behind encode t.  Every counted frame has been
        encoded, packed to annex-B, parsed back and reconstructed.
        Eager PyTorch compiles nothing, so `warmup` dispatches only warm
        the allocator, the rate controller and the native library.
        Device sources only (host frames come through pump_host_frames)."""
        k = self.FRAMES_PER_DISPATCH
        for _ in range(warmup):
            self.pump_frame()
        self.stats.snapshot(self.config.streams)
        self.stage_ms = {kk: 0.0 for kk in self.stage_ms}
        n = 0
        t0 = time.perf_counter()
        deadline = t0 + duration_s
        pending = None
        while time.perf_counter() < deadline:
            te = time.perf_counter()
            handles = self._dispatch()
            self.stage_ms["enc_dispatch"] += (time.perf_counter() - te) * 1e3
            if pending is not None:
                tw = time.perf_counter()
                frames_k = self._consume(pending)
                self.stage_ms["wire"] += (time.perf_counter() - tw) * 1e3
                self._decode_dispatch(frames_k, pending[8],
                                      start=pending[0], src=pending[10])
                n += k
                self.stage_ms["n"] += 1
            pending = handles
        if pending is not None:
            frames_k = self._consume(pending)
            self._decode_dispatch(frames_k, pending[8], start=pending[0],
                                  src=pending[10])
            n += k
        if self._sse_dev is not None:
            self.last_psnr_y = _psnr(float(self._sse_dev[-1, 0]),
                                     self.w16 * self.h16)
        wall = time.perf_counter() - t0
        snap = self.stats.snapshot(self.config.streams)
        snap["frames"] = n * self.config.streams
        snap["pipeline_fps"] = n / wall
        snap["frames_per_s_aggregate"] = n * self.config.streams / wall
        snap["psnr_y"] = self.last_psnr_y
        snap["stream_bytes"] = len(self.last_stream)
        snap["qp"] = (self.config.qp if self.config.qp is not None
                      else self.rc.current_qp())
        if self.stage_ms["n"]:
            nn = self.stage_ms["n"]
            for kk in ("enc_dispatch", "wire", "dev_wait", "d2h", "parse",
                       "dec_dispatch"):
                snap[f"ms_{kk}"] = self.stage_ms[kk] / nn
        return snap
