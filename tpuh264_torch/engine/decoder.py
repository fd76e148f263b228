"""Decoder sessions and the decoder pool on a PyTorch device.

Port of tpuh264/engine/decoder.py, the counterpart of the reference's
decoder C ABI (a pool of MAX_DECODERS = 32 slots, init_decoder /
deinit_decoder per stream, per-frame decode entry points): host entropy
parse (CAVLC by the native engine, CABAC by entropy/cabac_pack.py),
reconstruction on the device.

Streams of the engine's own syntax subset take this fast path: CAVLC or
CABAC, I frames with one slice per MB row (Intra_16x16 and Intra_4x4) or
one slice (the wavefront), P frames with one slice per MB row, 1..16
references, with CABAC the 8x8 transform of inter MBs, the in-loop
deblock.  Everything else goes to the golden `StreamDecoder`
(golden/codec.py), as in the JAX session: what the CABAC parser refuses
(I_PCM, Intra_8x8, a nonzero mb_qp_delta, P partitions), other slice
layouts, MVs beyond the fast path's window, third-party syntax, CAVLC
with the 8x8 transform (which the engine never emits), and P slices with
ref_pic_list_modification (the JAX fast path decodes those in the
default list order, with wrong pixels; here they divert).  A
`NotImplementedError` of the host stage switches the session to the
golden path for good; a `RuntimeError` of the host
stage (the native parse refusing general syntax, or a corrupt access
unit) gets one golden try, and only a successful one switches it.  The
golden decoder starts from the session's SPS, PPS and DPB, so a switch
mid-stream keeps decoding the true pictures.

Unlike the JAX session, only the host stage (classify, parse, the slice,
MV and reference checks) routes to the golden decoder.  Once device work
starts, whatever it raises propagates: PyTorch raises a CUDA fault as a
`RuntimeError`, and a kernel failure must not turn into a quiet golden
decode.

Error concealment: any other host-stage failure, or a golden decode
that fails, returns the session's previous frame (or None) and raises
its `needs_keyframe` flag.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core import nal
from ..core.bitstream import BitReader
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_P, SliceHeader
from ..entropy import cabac_pack
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
        self._fnums: List[int] = []  # frame_num of each DPB picture
        self._frame_num = 0
        self._idc = 1
        self._is_ref_frame = True
        self._nra = 1
        self._general = False  # syntax outside the fast path seen
        self._gold = None  # the golden StreamDecoder of the general path

    def decode(self, data: bytes) -> Optional[Planes]:
        """Decode one access unit -> (Y, U, V) uint8 planes (cropped).

        The host stage routes what the fast path cannot take to the
        golden decoder (see the module's note); the device stage's
        errors propagate.  Returns the previous frame (or None) and sets
        `needs_keyframe` where the access unit cannot be decoded."""
        if self._general:
            return self._decode_golden(data)
        try:
            device_stage = self._host_stage(data)
        except NotImplementedError:
            self._general = True
            self._gold = None  # start from the fast path's state
            return self._decode_golden(data)
        except RuntimeError:
            # general syntax or a corrupt access unit: one golden try;
            # only a decode that succeeds leaves the fast path
            self._gold = None
            out = self._decode_golden(data)
            self._general = not self.needs_keyframe
            return out
        except Exception:
            return self._conceal()
        out = device_stage()
        self._decoded(out)
        return out

    def _decoded(self, out: Planes) -> None:
        self.last_frame = out
        self.needs_keyframe = False
        self.frames_decoded += 1

    def _conceal(self) -> Optional[Planes]:
        self.needs_keyframe = True
        self.frames_concealed += 1
        return self.last_frame

    def _decode_golden(self, data: bytes) -> Optional[Planes]:
        """The general path: the golden StreamDecoder, built at the first
        call from the session's SPS, PPS and DPB (device planes brought
        to host int32, with their half-pel planes).  Only the golden
        decode conceals: a fault of the DPB's copy from the device
        propagates."""
        from ..golden import codec as gcodec
        from ..golden import inter as ginter

        if self._gold is None:
            gold = gcodec.StreamDecoder()
            gold.sps, gold.pps = self._sps, self._pps
            for planes in self._dpb:
                y, u, v = (p[0].cpu().numpy().astype(np.int32)
                           for p in planes)
                gold.dpb.append((y, u, v, ginter.build_halfpel_planes(y)))
            gold.dpb_fnums = list(self._fnums)
            self._gold = gold
        try:
            out = self._gold.decode_au(data)
            if out is None:
                raise RuntimeError("no frame in the access unit")
        except Exception:
            return self._conceal()
        out = tuple(np.asarray(p).astype(np.uint8) for p in out)
        self._decoded(out)
        return out

    def _classify(self, data: bytes) -> bool:
        """Parse SPS / PPS and the slice headers' state; True for a P
        access unit.  Raises NotImplementedError for what the fast path
        cannot decode right."""
        is_p = False
        for ridc, ntype, rbsp in nal.split_annexb(data):
            if ntype == nal.NAL_SPS:
                self._sps = SPS.parse(BitReader(rbsp))
            elif ntype == nal.NAL_PPS:
                self._pps = PPS.parse(BitReader(rbsp))
                if (self._pps.transform_8x8_mode_flag
                        and not self._pps.entropy_coding_mode_flag):
                    raise NotImplementedError("CAVLC with the 8x8 "
                                              "transform: the general path")
            elif ntype == nal.NAL_SLICE_NON_IDR:
                h = SliceHeader.parse(BitReader(rbsp), self._sps, self._pps,
                                      False, ref=ridc != 0)
                if h.ref_list_mods:
                    raise NotImplementedError(
                        "ref_pic_list_modification: the general path")
                self._idc = h.disable_deblocking_filter_idc
                self._is_ref_frame = ridc != 0
                self._nra = h.num_ref_idx_l0_active_minus1 + 1
                self._frame_num = h.frame_num
                if h.slice_type == SLICE_P:
                    is_p = True
            elif ntype == nal.NAL_SLICE_IDR and self._sps is not None:
                h = SliceHeader.parse(BitReader(rbsp), self._sps, self._pps,
                                      True)
                self._idc = h.disable_deblocking_filter_idc
                self._frame_num = h.frame_num
        return is_p

    def _host_stage(self, data: bytes):
        """Classify, parse and check one access unit on the host; returns
        the device stage, a function of no argument -> the planes."""
        if self._classify(data):
            symbols, qp = self._parse_p_symbols(data)
            return lambda: self._decode_p(symbols, qp)
        parsed = (cabac_pack.parse_iframe(data) if self._cabac()
                  else entropy_native.parse_iframe(data))
        sps = parsed[0]
        self._sps, self._pps = sps, parsed[1]
        r = sps.mb_height
        n_slices = _count_slices(data)
        if n_slices == 1 and r > 1:
            # single-slice stream: cross-row prediction -> the wavefront
            if (parsed[3][:, 0] == 4).any():
                raise NotImplementedError("I_NxN in single-slice streams")
            return lambda: self._decode_i(parsed, wave=True)
        if n_slices != r:
            raise NotImplementedError(f"{n_slices} slices for {r} MB rows")
        return lambda: self._decode_i(parsed, wave=False)

    def _cabac(self) -> bool:
        return bool(self._pps is not None
                    and self._pps.entropy_coding_mode_flag)

    def _t8(self) -> bool:
        return bool(self._pps is not None
                    and self._pps.transform_8x8_mode_flag)

    def _decode_i(self, parsed, wave: bool) -> Planes:
        sps, _, qp = parsed[:3]
        symbols = _i_symbols([parsed], self.device)
        if wave:
            planes = wavefront.decode_iframe_single(symbols, qp)
        else:
            has_i4 = bool((parsed[3][:, 0] == 4).any())
            planes = iframe.decode_iframe_scan(symbols, qp, intra44=has_i4)
        if self._idc != 1:
            planes = kdeblock.deblock_i(planes, qp)
        self._set_dpb([planes])
        return _crop(planes, 0, sps)

    def _parse_p_symbols(self, data: bytes):
        """Entropy-parse and check a P access unit -> (symbols [1, R, C,
        ...] as numpy, qp)."""
        sps, pps = self._sps, self._pps
        rr, cc = sps.mb_height, sps.mb_width
        if not self._dpb:
            raise RuntimeError("P frame before any reference")
        if tuple(self._dpb[0][0].shape[1:]) != (16 * rr, 16 * cc):
            raise RuntimeError("P frame of another size than its reference")
        qp = 26 + pps.pic_init_qp_minus26
        slices = []
        for ridc, ntype, rbsp in nal.split_annexb(data):
            if ntype == nal.NAL_SLICE_NON_IDR:
                r = BitReader(rbsp)
                h = SliceHeader.parse(r, sps, pps, False, ref=ridc != 0)
                qp = 26 + pps.pic_init_qp_minus26 + h.slice_qp_delta
                slices.append((rbsp, r.bit_position, h.first_mb_in_slice))
        if self._cabac():
            mb_info, ldc, lac, cdc, cac, t8 = cabac_pack.parse_pframe_slices(
                slices, sps, pps, qp=qp, nra=self._nra)
        else:
            mb_info, ldc, lac, cdc, cac = entropy_native.parse_pframe_slices(
                slices, sps, pps, self._nra)
            t8 = np.zeros(rr * cc, np.int32)
        # the row-slice decode assumes one slice per MB row (the left-only
        # MV predictor)
        if len(slices) != rr and rr != 1:
            raise NotImplementedError(f"{len(slices)} P slices for {rr} MB "
                                      "rows")
        if mb_info[:, 7].max() >= min(len(self._dpb), max(self._nra, 1)):
            raise RuntimeError("ref_idx beyond the reference pictures")
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
            t8=t8.reshape(1, rr, cc))
        return symbols, qp

    def _decode_p(self, symbols, qp: int) -> Planes:
        dev = self.device
        sym = pframe.MBSymbolsP(*(torch.from_numpy(np.ascontiguousarray(x))
                                  .to(dev) for x in symbols))
        dpb = self._dpb[:max(self._nra, 1)]
        refs = [torch.stack([d[i] for d in dpb]) for i in range(3)]
        t8 = self._t8()
        planes, motion = pframe.decode_pframe_rows_multi(sym, *refs, qp,
                                                         t8=t8)
        if self._idc != 1:
            planes = kdeblock.deblock_p(planes, sym, motion, qp, t8=t8)
        if self._is_ref_frame:
            self._push(planes)
        return _crop(planes, 0, self._sps)

    def _set_dpb(self, dpb) -> None:
        """An I access unit: its picture is the only reference."""
        self._dpb = dpb
        self._fnums = [self._frame_num]

    def _push(self, planes) -> None:
        """A reference picture enters the DPB (newest first)."""
        self._dpb.insert(0, planes)
        self._fnums.insert(0, self._frame_num)
        keep = max(1, self._sps.max_num_ref_frames)
        del self._dpb[keep:], self._fnums[keep:]

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
        stream axis; sessions on the golden path, CABAC access units, P
        frames with the 8x8 transform enabled, and access units the fast
        path does not take, decode per session, as in the JAX pool.  (The
        JAX pool decodes deblocked I frames per session: the same planes,
        one column loop per stream.)"""
        results: Dict[int, Optional[Planes]] = {}
        i_items, p_items = [], []
        for idx, data in items:
            sess = self._slots[idx]
            if not sess._general:
                try:
                    is_p = sess._classify(data)
                    cavlc = not sess._cabac()  # CABAC: per session
                    if (cavlc and is_p and sess._dpb and sess._nra == 1
                            and not sess._t8()):
                        p_items.append((idx, sess,
                                        *sess._parse_p_symbols(data)))
                        continue
                    if cavlc and not is_p:
                        p = entropy_native.parse_iframe(data)
                        if _count_slices(data) == p[0].mb_height or \
                                p[0].mb_height == 1:
                            i_items.append((idx, sess, p))
                            continue
                except Exception:
                    pass  # the session's own decode routes or conceals
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
                sess._set_dpb([tuple(x[i:i + 1] for x in planes)])
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
