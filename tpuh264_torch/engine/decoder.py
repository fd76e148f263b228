"""Decoder sessions and the decoder pool on a PyTorch device.

Port of tpuh264/engine/decoder.py, the counterpart of the reference's
decoder C ABI (a pool of MAX_DECODERS = 32 slots, init_decoder /
deinit_decoder per stream, per-frame decode entry points): host CAVLC
parse by the native engine, reconstruction on the device.

Streams of the engine's own syntax subset decode here: CAVLC, I frames
with one slice per MB row (Intra_16x16 and Intra_4x4) or one slice
(the wavefront), P frames with one slice per MB row, 1..16 references,
the in-loop deblock.  Where the JAX session switches to its golden
`StreamDecoder` on `NotImplementedError` (CABAC, the 8x8 transform,
other slice layouts, MVs beyond the fast path's window, and -- unlike
the JAX session, which decodes them in the default order, a known fault
-- P slices with ref_pic_list_modification), this port lets the
`NotImplementedError` out: the general decoder is the next slice.

Error concealment: any other failure (a corrupt or undecodable access
unit) returns the session's previous frame (or None) and raises its
`needs_keyframe` flag, as the JAX session does when its golden retry
fails too.
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import nal
from ..core.bitstream import BitReader
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_P, SliceHeader
from ..entropy import native as entropy_native
from ..kernels import color, iframe, pframe, wavefront
from ..kernels import deblock as kdeblock
from .devpipe import resolve_device

Planes = Tuple[np.ndarray, np.ndarray, np.ndarray]


def _count_slices(data: bytes) -> int:
    return sum(ntype in (nal.NAL_SLICE_IDR, nal.NAL_SLICE_NON_IDR)
               for _, ntype, _ in nal.split_annexb(data))


def _i_symbols(parsed, device) -> iframe.MBSymbols:
    """`entropy_native.parse_iframe` results of B access units of one size
    -> MBSymbols [B, R, C, ...] on `device`."""
    sps = parsed[0][0]
    r, c = sps.mb_height, sps.mb_width
    up = lambda k, *sh: torch.from_numpy(np.stack(
        [p[k].reshape(r, c, *sh) for p in parsed])).to(device)
    mb = up(3, 4)
    return iframe.MBSymbols(
        mode=mb[..., 0], cmode=mb[..., 1], cbp_luma=mb[..., 2],
        cbp_chroma=mb[..., 3], luma_dc=up(4, 16), luma_ac=up(5, 16, 16),
        chroma_dc=up(6, 2, 4), chroma_ac=up(7, 2, 4, 15), i4modes=up(8, 16))


def _crop(planes, i: int, sps: SPS) -> Planes:
    """Stream i of device planes [B, H16, W16 (/2)], cropped, as numpy."""
    h, w = sps.height, sps.width
    y, u, v = (p[i].cpu().numpy() for p in planes)
    return y[:h, :w], u[:h // 2, :w // 2], v[:h // 2, :w // 2]


class DecoderSession:
    """One decoder on `device` (the card unless the caller asks for
    another; no card there raises)."""

    def __init__(self, *, device="cuda") -> None:
        self.device = resolve_device(device)
        self.last_frame: Optional[Planes] = None
        self.needs_keyframe = False
        self.frames_decoded = 0
        self.frames_concealed = 0
        self._sps: Optional[SPS] = None
        self._pps: Optional[PPS] = None
        self._dpb: List = []  # device planes [1, H, W] uint8, newest first
        self._idc = 1
        self._is_ref_frame = True
        self._nra = 1

    def decode(self, data: bytes) -> Optional[Planes]:
        """Decode one access unit -> (Y, U, V) uint8 planes (cropped).

        NotImplementedError (syntax outside the ported subset) goes to the
        caller.  Any other failure conceals: the previous frame (or None)
        comes back and `needs_keyframe` is set."""
        try:
            is_p = self._classify(data)
            out = self._decode_p(data) if is_p else self._decode_i(data)
        except NotImplementedError:
            raise
        except Exception:
            self.needs_keyframe = True
            self.frames_concealed += 1
            return self.last_frame
        self._decoded(out)
        return out

    def _decoded(self, out: Planes) -> None:
        self.last_frame = out
        self.needs_keyframe = False
        self.frames_decoded += 1

    def _classify(self, data: bytes) -> bool:
        """Parse SPS / PPS and the slice headers' state; True for a P
        access unit.  Refuses what the fast path cannot decode right."""
        is_p = False
        for ridc, ntype, rbsp in nal.split_annexb(data):
            if ntype == nal.NAL_SPS:
                self._sps = SPS.parse(BitReader(rbsp))
            elif ntype == nal.NAL_PPS:
                self._pps = PPS.parse(BitReader(rbsp))
                if self._pps.entropy_coding_mode_flag:
                    raise NotImplementedError(
                        "CABAC streams decode in the next slice")
                if self._pps.transform_8x8_mode_flag:
                    raise NotImplementedError(
                        "8x8-transform streams decode in the next slice")
            elif ntype == nal.NAL_SLICE_NON_IDR:
                h = SliceHeader.parse(BitReader(rbsp), self._sps, self._pps,
                                      False, ref=ridc != 0)
                if h.ref_list_mods:
                    # the JAX fast path ignores them and decodes with the
                    # default list order: wrong pixels, so refuse
                    raise NotImplementedError(
                        "ref_pic_list_modification: the general decoder "
                        "(next slice) takes such streams")
                self._idc = h.disable_deblocking_filter_idc
                self._is_ref_frame = ridc != 0
                self._nra = h.num_ref_idx_l0_active_minus1 + 1
                if h.slice_type == SLICE_P:
                    is_p = True
            elif ntype == nal.NAL_SLICE_IDR and self._sps is not None:
                h = SliceHeader.parse(BitReader(rbsp), self._sps, self._pps,
                                      True)
                self._idc = h.disable_deblocking_filter_idc
        return is_p

    def _decode_i(self, data: bytes) -> Planes:
        parsed = entropy_native.parse_iframe(data)
        sps, pps, qp = parsed[:3]
        self._sps, self._pps = sps, pps
        r = sps.mb_height
        symbols = _i_symbols([parsed], self.device)
        has_i4 = bool((parsed[3][:, 0] == 4).any())
        n_slices = _count_slices(data)
        if n_slices == 1 and r > 1:
            # single-slice stream: cross-row prediction -> wavefront
            if has_i4:
                raise NotImplementedError("I_NxN in single-slice streams")
            planes = wavefront.decode_iframe_single(symbols, qp)
        elif n_slices in (r, 1):
            planes = iframe.decode_iframe_scan(symbols, qp, intra44=has_i4)
        else:
            raise NotImplementedError(f"{n_slices} slices for {r} MB rows")
        if self._idc != 1:
            planes = kdeblock.deblock_i(planes, qp)
        self._dpb = [planes]
        return _crop(planes, 0, sps)

    def _parse_p_symbols(self, data: bytes):
        """Entropy-parse a P access unit -> (symbols [1, R, C, ...] as
        numpy, qp)."""
        sps, pps = self._sps, self._pps
        qp = 26 + pps.pic_init_qp_minus26
        slices = []
        for ridc, ntype, rbsp in nal.split_annexb(data):
            if ntype == nal.NAL_SLICE_NON_IDR:
                r = BitReader(rbsp)
                h = SliceHeader.parse(r, sps, pps, False, ref=ridc != 0)
                qp = 26 + pps.pic_init_qp_minus26 + h.slice_qp_delta
                slices.append((rbsp, r.bit_position, h.first_mb_in_slice))
        mb_info, ldc, lac, cdc, cac = entropy_native.parse_pframe_slices(
            slices, sps, pps, self._nra)
        rr, cc = sps.mb_height, sps.mb_width
        # the row-slice decode assumes one slice per MB row (the left-only
        # MV predictor)
        if len(slices) != rr and rr != 1:
            raise NotImplementedError(f"{len(slices)} P slices for {rr} MB "
                                      "rows")
        # resolve the row-chain MVs and bound-check them against the JAX
        # fast path's window range (its `_extract_w2` offsets), which the
        # engine's own streams never leave
        kind_a = mb_info[:, 0].reshape(rr, cc)
        mvdx_a = mb_info[:, 5].reshape(rr, cc).astype(np.int64)
        mvdy_a = mb_info[:, 6].reshape(rr, cc).astype(np.int64)
        mvx = np.zeros(rr, np.int64)
        mvy = np.zeros(rr, np.int64)
        lo, hi = 4 * -10, 4 * 9 + 3
        for c0 in range(cc):
            inter = kind_a[:, c0] == 1
            mvx = np.where(inter, mvx + mvdx_a[:, c0], 0)
            mvy = np.where(inter, mvy + mvdy_a[:, c0], 0)
            if (mvx.min() < lo or mvx.max() > hi
                    or mvy.min() < lo or mvy.max() > hi):
                raise NotImplementedError(
                    "MV beyond the fast-path window range")
        f = lambda k: mb_info[:, k].reshape(1, rr, cc)
        symbols = pframe.MBSymbolsP(
            kind=f(0), mode=f(1), cmode=f(2), cbp_luma=f(3), cbp_chroma=f(4),
            mvdx=f(5), mvdy=f(6), luma_dc=ldc.reshape(1, rr, cc, 16),
            luma_ac=lac.reshape(1, rr, cc, 16, 16),
            chroma_dc=cdc.reshape(1, rr, cc, 2, 4),
            chroma_ac=cac.reshape(1, rr, cc, 2, 4, 15), refidx=f(7),
            t8=np.zeros((1, rr, cc), np.int32))
        return symbols, qp

    def _decode_p(self, data: bytes) -> Planes:
        if not self._dpb:
            raise RuntimeError("P frame before any reference")
        symbols, qp = self._parse_p_symbols(data)
        dev = self.device
        sym = pframe.MBSymbolsP(*(torch.from_numpy(np.ascontiguousarray(x))
                                  .to(dev) for x in symbols))
        dpb = self._dpb[:max(self._nra, 1)]
        refs = [torch.stack([d[i] for d in dpb]) for i in range(3)]
        planes, motion = pframe.decode_pframe_rows_multi(sym, *refs, qp)
        if self._idc != 1:
            planes = kdeblock.deblock_p(planes, sym, motion, qp)
        if self._is_ref_frame:
            self._push(planes)
        return _crop(planes, 0, self._sps)

    def _push(self, planes) -> None:
        """A reference picture enters the DPB (newest first)."""
        self._dpb.insert(0, planes)
        del self._dpb[max(1, self._sps.max_num_ref_frames):]

    def decode_to_rgba(self, data: bytes) -> Optional[np.ndarray]:
        """decode_frame_optimized analog: decode, then YUV -> RGBA."""
        out = self.decode(data)
        if out is None:
            return None
        y, u, v = (torch.from_numpy(np.ascontiguousarray(p)).to(self.device)
                   for p in out)
        return color.yuv420_to_rgba(y, u, v).cpu().numpy()


class DecoderPool:
    """MAX_DECODERS-slot pool of DecoderSessions on `device`."""

    def __init__(self, max_decoders: int = 32, *, device="cuda"):
        self.device = resolve_device(device)
        self.max_decoders = max_decoders
        self._slots: Dict[int, DecoderSession] = {}

    def init_decoder(self, idx: int) -> None:
        if not 0 <= idx < self.max_decoders:
            raise IndexError(f"decoder index {idx} out of range")
        self._slots[idx] = DecoderSession(device=self.device)

    def deinit_decoder(self, idx: int) -> None:
        self._slots.pop(idx, None)

    def __getitem__(self, idx: int) -> DecoderSession:
        return self._slots[idx]

    def active(self) -> List[int]:
        return sorted(self._slots)

    def decode(self, idx: int, data: bytes):
        return self._slots[idx].decode(data)

    def decode_batch(self, items: List[Tuple[int, bytes]]
                     ) -> Dict[int, Optional[Planes]]:
        """Decode several streams' access units with batched device calls.

        Row-sliced I frames, and P frames with one active reference, of
        the same size, QP and deblock mode are stacked into one
        reconstruction (+ deblock) each, the sessions' DPB heads on the
        stream axis; anything else decodes per session.  (The JAX pool
        decodes deblocked I frames per session: the same planes, one
        column loop per stream.)"""
        results: Dict[int, Optional[Planes]] = {}
        i_items, p_items = [], []
        for idx, data in items:
            sess = self._slots[idx]
            try:
                is_p = sess._classify(data)
                if is_p and sess._dpb and sess._nra == 1:
                    p_items.append((idx, sess, *sess._parse_p_symbols(data)))
                    continue
                if not is_p:
                    p = entropy_native.parse_iframe(data)
                    if _count_slices(data) == p[0].mb_height or \
                            p[0].mb_height == 1:
                        i_items.append((idx, sess, p))
                        continue
            except Exception:
                pass  # the session's own decode conceals or raises
            results[idx] = sess.decode(data)
        self._decode_batch_i(i_items, results)
        self._decode_batch_p(p_items, results)
        return results

    def _decode_batch_i(self, i_items, results) -> None:
        """Batched reconstruction (+ deblock) of row-sliced I frames."""
        groups: Dict[Tuple[int, int, int, int], list] = {}
        for item in i_items:
            sps, _, qp = item[2][:3]
            groups.setdefault((sps.mb_height, sps.mb_width, qp,
                               item[1]._idc), []).append(item)
        for (_, _, qp, idc), group in groups.items():
            parsed = [g[2] for g in group]
            has_i4 = any(bool((p[3][:, 0] == 4).any()) for p in parsed)
            planes = iframe.decode_iframe_scan(
                _i_symbols(parsed, self.device), qp, intra44=has_i4)
            if idc != 1:
                planes = kdeblock.deblock_i(planes, qp)
            for i, (idx, sess, p) in enumerate(group):
                out = _crop(planes, i, p[0])
                sess._decoded(out)
                # a following P frame references this reconstruction
                sess._sps, sess._pps = p[0], p[1]
                sess._dpb = [tuple(x[i:i + 1] for x in planes)]
                results[idx] = out

    def _decode_batch_p(self, p_items, results) -> None:
        """Batched reconstruction of row-sliced P frames: one
        decode_pframe_rows_multi (+ deblock) per (size, qp, idc) group,
        the sessions' DPB heads stacked on the stream axis."""
        groups: Dict[Tuple[int, int, int, int], list] = {}
        for item in p_items:
            _, sess, symbols, qp = item
            r, c = symbols.kind.shape[1:]
            groups.setdefault((r, c, qp, sess._idc), []).append(item)
        dev = self.device
        for (_, _, qp, idc), group in groups.items():
            sym = pframe.MBSymbolsP(*(
                torch.from_numpy(np.concatenate([getattr(g[2], f)
                                                 for g in group])).to(dev)
                for f in pframe.MBSymbolsP._fields))
            refs = [torch.cat([g[1]._dpb[0][i] for g in group])[None]
                    for i in range(3)]
            planes, motion = pframe.decode_pframe_rows_multi(sym, *refs, qp)
            if idc != 1:
                planes = kdeblock.deblock_p(planes, sym, motion, qp)
            for i, (idx, sess, _, _) in enumerate(group):
                out = _crop(planes, i, sess._sps)
                sess._decoded(out)
                if sess._is_ref_frame:
                    sess._push(tuple(x[i:i + 1] for x in planes))
                results[idx] = out
