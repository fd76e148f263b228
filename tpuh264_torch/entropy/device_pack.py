"""Host wrapper for the on-device CAVLC assembler (kernels/entropy_gpu.py).

Port of tpuh264/entropy/device_pack.py.  Per frame only the slice
payloads' used columns cross to the host; the host's remaining work is
emulation prevention (the port's native library) and NAL framing --
bytes identical to entropy.native / entropy.pack.  Slice headers are
written by the shared host `SliceHeader` writer and uploaded once per
configuration and device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core import nal
from ..core.bitstream import BitWriter
from ..core.params import PPS, SPS, param_sets
from ..core.sliceheader import SLICE_I, SLICE_P, SliceHeader
from ..kernels import entropy_gpu
from . import native

_HDR_CACHE = {}


def slice_headers_device(
    sps: SPS, pps: PPS, qp: int, frame_num: int, idr: bool, s: int,
    slice_type: int = SLICE_I, ref: bool = True, deblock_idc: int = 1,
    num_ref_active: int = 1, *, device,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-(stream, row) slice headers: (words [s, R, 4] int32 MSB-first,
    bit lengths [s, R] int32) on `device` (required: the port's entry
    points name theirs), cached per configuration."""
    device = torch.device(device)
    key = (sps.mb_width, sps.mb_height, qp, frame_num, idr, s,
           pps.pic_init_qp_minus26, slice_type, ref, deblock_idc,
           num_ref_active, str(device))
    hit = _HDR_CACHE.get(key)
    if hit is not None:
        return hit
    mbw, mbh = sps.mb_width, sps.mb_height
    hw = np.zeros((s, mbh, 4), np.int32)
    ln = np.zeros((s, mbh), np.int32)
    for r in range(mbh):
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=r * mbw,
            slice_type=slice_type,
            frame_num=frame_num % (1 << (sps.log2_max_frame_num_minus4 + 4)),
            slice_qp_delta=qp - 26 - pps.pic_init_qp_minus26,
            disable_deblocking_filter_idc=deblock_idc,
            num_ref_idx_l0_active_minus1=num_ref_active - 1,
        ).write(w, sps, pps, idr, ref=ref)
        bits = w.bit_length
        w.u((32 - bits % 32) % 32, 0)
        data = np.frombuffer(w.get_bytes(), np.uint8).astype(np.int64)
        words = ((data[0::4] << 24) | (data[1::4] << 16)
                 | (data[2::4] << 8) | data[3::4]).astype(np.uint32)
        hw[:, r, :len(words)] = words.view(np.int32)
        ln[:, r] = bits
    out = (torch.from_numpy(hw).to(device), torch.from_numpy(ln).to(device))
    _HDR_CACHE[key] = out
    return out


def _annexb(slice_hw, slice_bytes, overflow, mbh: int, prefix: bytes,
            header_byte: bytes):
    """Per-stream annex-B bytes from the device slice payloads: one read
    of the overflow flag and slice sizes, then only the columns that hold
    the fattest slice (bucketed to 512 words, as the JAX version keeps
    its download shape stable).  (None, True) on overflow."""
    meta = torch.cat([overflow.to(torch.int32).reshape(1),
                      slice_bytes.reshape(-1)]).cpu().numpy()
    if meta[0]:
        return None, True
    s = slice_hw.shape[0]
    sbytes = meta[1:].reshape(s, -1)
    n_cols = min(entropy_gpu.SLICE_W,
                 -(-((int(sbytes.max()) + 3) // 4) // 512) * 512)
    slab = (slice_hw[:, :, :n_cols].cpu().numpy().view(np.uint32)
            .astype(">u4"))
    streams = []
    for i in range(s):
        out = bytearray(prefix)
        for r in range(mbh):
            rbsp = slab[i, r].tobytes()[:int(sbytes[i, r])]
            out += nal.START_CODE + header_byte + native.escape_rbsp(rbsp)
        streams.append(bytes(out))
    return streams, False


def assemble_iframe(symbols, sps: SPS, pps: PPS, qp: int, frame_num: int = 0,
                    idr: bool = True, include_ps: bool = True):
    """I-frame symbols (on their device, S streams) -> (list of per-stream
    annex-B bytes, overflowed).  K2 and K3 run on the symbols' device.  On
    overflow the result is (None, True) and the caller packs on the host
    (entropy.native)."""
    s = int(symbols.mode.shape[0])
    hdr_hw, hdr_len = slice_headers_device(sps, pps, qp, frame_num, idr, s,
                                           device=symbols.mode.device)
    ntype = nal.NAL_SLICE_IDR if idr else nal.NAL_SLICE_NON_IDR
    return _annexb(
        *entropy_gpu.encode_bits_iframe(symbols, qp, hdr_hw, hdr_len),
        sps.mb_height, param_sets(sps, pps) if include_ps else b"",
        bytes([(3 << 5) | ntype]))


def assemble_pframe(symbols, sps: SPS, pps: PPS, qp: int, frame_num: int = 1,
                    ref: bool = True, deblock_idc: int = 1):
    """P-frame symbols (MBSymbolsP on their device, S streams) -> (list of
    per-stream annex-B slice NALs, overflowed), byte-identical to
    entropy.packp.pack_pframe."""
    s = int(symbols.kind.shape[0])
    hdr_hw, hdr_len = slice_headers_device(
        sps, pps, qp, frame_num, False, s, slice_type=SLICE_P, ref=ref,
        deblock_idc=deblock_idc, device=symbols.kind.device)
    return _annexb(
        *entropy_gpu.encode_bits_pframe(symbols, qp, hdr_hw, hdr_len),
        sps.mb_height, b"",
        bytes([((2 if ref else 0) << 5) | nal.NAL_SLICE_NON_IDR]))
