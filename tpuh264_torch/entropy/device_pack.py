"""Slice-header bit strings for the on-device CAVLC assembler.

Port of tpuh264/entropy/device_pack.py `slice_headers_device` (the
`assemble_*` helpers are not ported yet).  Headers are written by the
shared host `SliceHeader` writer and uploaded once per configuration and
device.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..core.bitstream import BitWriter
from ..core.params import PPS, SPS
from ..core.sliceheader import SLICE_I, SliceHeader

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
