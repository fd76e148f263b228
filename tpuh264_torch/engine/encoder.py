"""Encoder session on a PyTorch device: the counterpart of the reference's
encoder C ABI (init_encoder / force_key_frame / encode_frame /
encode_frame_yuv_i420), batched over `streams` independent inputs.

Port of tpuh264/engine/encoder.py.  Per encode call:

  [host  ] RGBA or I420 copy-in, edge-padded to the MB grid   ("copy")
  [device] colour convert, then the I scan (row slices, with or without
           Intra_4x4, or the single-slice wavefront) or the P encode
           (quarter-pel ME with K1 in stage A, the 8x8-vs-4x4 transform
           choice with `transform8x8`, intra-in-P), the deblock
                                                             ("encode")
  [host  ] symbols down, then the CAVLC pack by the native engine, or
           with `cabac` the CABAC pack (numpy, entropy/cabac_pack.py)
           -> annex-B                                       ("entropy")

The P route follows the JAX session: with temporal layers the reference
is forced (T0 frames of 3 layers reference the previous T0, others the
newest picture), otherwise every DPB picture is searched per MB; only
reference pictures enter the DPB, and frame_num counts reference
pictures.  `cabac` streams are Main profile; `transform8x8` (which needs
`cabac`, as in the JAX session) makes them High profile with the 8x8
transform enabled in the PPS.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from ..core.params import (PPS, PROFILE_BASELINE, PROFILE_HIGH, PROFILE_MAIN,
                           SPS)
from ..entropy import cabac_pack
from ..entropy import native as entropy_native
from ..kernels import color, iframe, pframe, wavefront
from ..kernels import deblock as kdeblock
from .config import CodecConfig
from .devpipe import resolve_device
from .ratecontrol import RateController


@dataclasses.dataclass
class EncodedFrame:
    data: bytes
    is_idr: bool
    frame_num: int
    qp: int
    timings: dict


def _pad_multiple(x: np.ndarray, mult: int, axes=(-2, -1)) -> np.ndarray:
    """Edge-pad `axes` of x up to multiples of `mult`."""
    pads = [(0, 0)] * x.ndim
    for ax in axes:
        size = x.shape[ax]
        pads[ax % x.ndim] = (0, (size + mult - 1) // mult * mult - size)
    if not any(p for _, p in pads):
        return x
    return np.pad(x, pads, mode="edge")


def sync(device: torch.device) -> None:
    """Wait for the work queued on `device` (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class EncoderSession:
    """One encoder session over a batch of `streams` independent inputs,
    on `device` (the card unless the caller asks for another; no card
    there raises).  Re-creating the object re-initialises the encoder."""

    def __init__(self, config: Optional[CodecConfig] = None, *,
                 device="cuda", **kw):
        if config is None:
            config = CodecConfig(**kw)
        self.config = config
        # the JAX session's refusals
        if config.slice_mode == "single" and config.deblock:
            raise NotImplementedError(
                "slice_mode='single' with deblock=True needs cross-row "
                "deblocking; use slice_mode='rows'")
        if config.slice_mode == "single" and config.gop_size != 1:
            raise NotImplementedError(
                "slice_mode='single' currently supports I-only GOPs "
                "(gop_size=1)")
        if config.slice_mode == "single" and config.intra44:
            raise NotImplementedError(
                "intra44 on the wavefront (single-slice) kernel lands "
                "later; use slice_mode='rows'")
        if config.transform8x8 and not config.cabac:
            raise NotImplementedError(
                "transform8x8 requires cabac=True (CAVLC 8x8 exists in "
                "the golden codec; the engine packers are CABAC-first)")
        self.device = resolve_device(device)
        self._num_ref = max(config.num_ref_frames,
                            2 if config.temporal_layers == 3 else 1)
        profile = (PROFILE_HIGH if config.transform8x8 else
                   PROFILE_MAIN if config.cabac else PROFILE_BASELINE)
        self.sps = SPS.for_size(config.width, config.height,
                                profile_idc=profile,
                                max_num_ref_frames=self._num_ref)
        self.pps = PPS(entropy_coding_mode_flag=int(config.cabac),
                       transform_8x8_mode_flag=int(config.transform8x8))
        self.frame_num = 0
        self.idr_pic_id = 0
        self._force_idr = True
        self._dpb: List = []  # device recon tuples [S, H, W] uint8, newest 1st
        self._frame_in_gop = 0
        self.rc = RateController(config)
        self.recon = None

    # -- reference API surface ------------------------------------------------

    def force_key_frame(self) -> None:
        """ForceIntraFrame analog: the next frame is an IDR."""
        self._force_idr = True

    def encode_frame(self, rgba: np.ndarray) -> List[EncodedFrame]:
        """Encode RGBA input [S, H, W, 4] (or [H, W, 4]) -> one access unit
        per stream."""
        t0 = time.perf_counter()
        if rgba.ndim == 3:
            rgba = rgba[None]
        rgba = _pad_multiple(np.ascontiguousarray(rgba), 16, axes=(1, 2))
        arr = torch.from_numpy(rgba).to(self.device)
        sync(self.device)
        t1 = time.perf_counter()
        return self._encode_common(*color.rgba_to_yuv420(arr),
                                   copy_s=t1 - t0)

    def encode_frame_yuv(self, y: np.ndarray, u: np.ndarray, v: np.ndarray
                         ) -> List[EncodedFrame]:
        """Encode planar I420 input [S, H, W] (or [H, W]; u, v half size)
        (encode_frame_yuv_i420 analog)."""
        t0 = time.perf_counter()
        if y.ndim == 2:
            y, u, v = y[None], u[None], v[None]
        up = lambda p, m: torch.from_numpy(_pad_multiple(
            np.ascontiguousarray(p, np.uint8), m)).to(self.device)
        y, u, v = up(y, 16), up(u, 8), up(v, 8)
        sync(self.device)
        t1 = time.perf_counter()
        return self._encode_common(y, u, v, copy_s=t1 - t0)

    # -- internals ------------------------------------------------------------

    def _encode_common(self, y, u, v, copy_s: float) -> List[EncodedFrame]:
        cfg = self.config
        qp = self.rc.current_qp()
        idr = (self._force_idr or not self._dpb
               or (cfg.gop_size > 0 and self._frame_in_gop >= cfg.gop_size))

        t0 = time.perf_counter()
        if idr:
            if cfg.slice_mode == "single":
                symbols, recon = wavefront.encode_iframe_single(y, u, v, qp)
            else:
                symbols, recon = iframe.encode_iframe_scan(
                    y, u, v, qp, intra44=cfg.intra44)
            if cfg.deblock:
                recon = kdeblock.deblock_i(recon, qp)
        else:
            symbols, recon, motion = self._encode_p(y, u, v, qp)
            if cfg.deblock:
                recon = kdeblock.deblock_p(recon, symbols, motion, qp,
                                           t8=cfg.transform8x8)
        sync(self.device)
        t1 = time.perf_counter()

        s = int(y.shape[0])
        n = self.sps.mb_width * self.sps.mb_height
        deblock_idc = 2 if cfg.deblock else 1
        if idr:
            frames = self._pack_i(symbols, s, n, qp, deblock_idc)
            self._frame_in_gop = 1
            self._dpb = [recon]
        else:
            is_ref = cfg.temporal_layers == 1 or self._frame_in_gop % 2 == 0
            frames = self._pack_p(symbols, s, n, qp, deblock_idc, is_ref)
            self._frame_in_gop += 1
            if is_ref:
                self._dpb.insert(0, recon)
                del self._dpb[self._num_ref:]
        t2 = time.perf_counter()

        self.rc.update(sum(len(f.data) for f in frames) / max(s, 1))
        self._force_idr = False
        self.frame_num += 1
        timings = {"copy_ms": copy_s * 1e3, "encode_ms": (t1 - t0) * 1e3,
                   "entropy_ms": (t2 - t1) * 1e3}
        for f in frames:
            f.timings = timings
        self.recon = recon
        return frames

    def _encode_p(self, y, u, v, qp: int):
        """P encode against the DPB: a forced reference with temporal
        layers (or a single picture), else a per-MB search of all."""
        cfg = self.config
        k = self._frame_in_gop
        nra = len(self._dpb)
        if cfg.temporal_layers == 3 and k % 4 == 0:
            force = min(1, nra - 1)  # T0 references the previous T0
        elif cfg.temporal_layers >= 2 or nra == 1:
            force = 0
        else:
            force = -1  # free per-MB reference search
        t8 = cfg.transform8x8
        if force >= 0:
            refs = [p[None] for p in self._dpb[force]]
            return pframe.encode_pframe_rows_multi(y, u, v, *refs, qp,
                                                   ref_base=force, t8=t8)
        refs = [torch.stack([d[i] for d in self._dpb]) for i in range(3)]
        return pframe.encode_pframe_rows_multi(y, u, v, *refs, qp, t8=t8)

    def _pack_i(self, symbols, s: int, n: int, qp: int, deblock_idc: int):
        """IDR access units: the symbols down in one flat copy, then the
        native CAVLC pack (or the CABAC pack) per stream."""
        i4 = self.config.intra44
        r, c = self.sps.mb_height, self.sps.mb_width
        sym = iframe.unflatten_symbols_np(
            iframe.flatten_symbols(symbols, i4=i4).cpu().numpy(), s, r, c, i4)
        per = lambda f, *sh: sym[f].reshape(s, n, *sh)
        info = np.stack([per("mode"), per("cmode"), per("cbp_luma"),
                         per("cbp_chroma")], -1).astype(np.int32)
        arrs = (per("luma_dc", 16), per("luma_ac", 16, 16),
                per("chroma_dc", 2, 4), per("chroma_ac", 2, 4, 15))
        i4m = per("i4modes", 16) if i4 else None
        pack = (cabac_pack.pack_iframe if self.config.cabac
                else entropy_native.pack_iframe)
        return [EncodedFrame(pack(
            info[i], *(a[i] for a in arrs), self.sps, self.pps, qp,
            slice_mode=self.config.slice_mode, frame_num=0, idr=True,
            include_ps=True, deblock_idc=deblock_idc,
            i4modes=i4m[i] if i4m is not None else None),
            True, self.frame_num, qp, {}) for i in range(s)]

    def _pack_p(self, symbols, s: int, n: int, qp: int, deblock_idc: int,
                is_ref: bool):
        """P access units; frame_num counts reference pictures (with
        temporal layers every other frame is a non-reference one).  The
        CABAC pack also takes the MBs' 8x8-transform flags."""
        cfg = self.config
        npy = lambda x, *sh: x.cpu().numpy().reshape(s, n, *sh)
        info = np.stack([npy(getattr(symbols, f)) for f in (
            "kind", "mode", "cmode", "cbp_luma", "cbp_chroma", "mvdx", "mvdy",
            "refidx")], -1).astype(np.int32)
        arrs = (npy(symbols.luma_dc, 16), npy(symbols.luma_ac, 16, 16),
                npy(symbols.chroma_dc, 2, 4), npy(symbols.chroma_ac, 2, 4, 15))
        k = self._frame_in_gop
        fnum = (k if cfg.temporal_layers == 1 else (k + 1) // 2) % (
            1 << (self.sps.log2_max_frame_num_minus4 + 4))
        pack = cabac_pack.pack_pframe if cfg.cabac else \
            entropy_native.pack_pframe
        t8f = npy(symbols.t8) if cfg.transform8x8 else None
        extra = lambda i: {} if t8f is None else {"t8flags": t8f[i]}
        return [EncodedFrame(pack(
            info[i], *(a[i] for a in arrs), self.sps, self.pps, qp,
            slice_mode=cfg.slice_mode, frame_num=fnum,
            deblock_idc=deblock_idc, ref=is_ref,
            num_ref_active=len(self._dpb), **extra(i)),
            False, self.frame_num, qp, {}) for i in range(s)]
