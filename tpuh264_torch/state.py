"""Carry a running pipeline's state into the port.

The codec has no learned weights; what a `GOPDevicePipeline` carries
from one dispatch to the next is its state: both DPBs, the GOP position,
the source clock (dispatch index and dropped frames) and the rate
controller.  `load_jax_state` takes that
state as numpy arrays and scalars -- read off a tpuh264 (JAX)
`GOPDevicePipeline`, for example -- and puts it into a port pipeline on
its device, so both can continue from the same mid-GOP point.
`load_jax_session_state` and `load_jax_decoder_state` do the same for an
`EncoderSession` and a `DecoderSession`.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.params import PPS, SPS

_RC_FIELDS = ("qp", "_qp_f", "buf", "_window", "_p_avg_bits", "scene_cuts")


def rc_state_of(rc) -> dict:
    """The mutable state of a RateController (either package's)."""
    return {f: (list(getattr(rc, f)) if f == "_window" else getattr(rc, f))
            for f in _RC_FIELDS}


def load_jax_state(port_pipe, dpb_enc: Sequence[np.ndarray],
                   dpb_dec: Sequence[np.ndarray], gop_pos: int,
                   dispatch_index: int, rc_state: Mapping,
                   time_offset: int = 0) -> None:
    """Load pipeline state into `port_pipe` (tpuh264_torch GOPDevicePipeline).

    dpb_enc / dpb_dec: (y, u, v) arrays [N, S, H, W] and [N, S*fanout,
    H, W], newest first (N = num_ref_frames; a fan-out pipeline's decoder
    DPB is S*fanout streams wide); gop_pos / dispatch_index /
    time_offset: the JAX pipeline's `_gop_pos` / `dispatch_index` /
    `time_offset` (frames dropped so far); rc_state:
    `rc_state_of(jax_pipe.rc)`."""
    def planes(dpb, ring):
        out = []
        for p, r in zip(dpb, ring):
            a = np.asarray(p)
            if a.shape != tuple(r.shape):
                raise ValueError(f"DPB plane {a.shape} != {tuple(r.shape)}")
            if a.size and (a.min() < 0 or a.max() > 255):
                raise ValueError(f"DPB plane values {a.min()}..{a.max()} "
                                 "outside 0..255")
            out.append(torch.from_numpy(a.astype(np.uint8)))
        return out

    # every plane is checked before any slot changes
    loads = [(r, a) for dpb, rings in (
        (dpb_enc, port_pipe._dpb_enc), (dpb_dec, port_pipe._dpb_dec))
        for r, a in zip(rings, planes(dpb, rings))]
    for r, a in loads:
        r.copy_(a)  # slot i the i-th newest: the rings' heads are 0
    port_pipe._head_enc = port_pipe._head_dec = 0
    port_pipe._gop_pos = int(gop_pos)
    port_pipe.dispatch_index = int(dispatch_index)
    port_pipe.time_offset = int(time_offset)
    _load_rc(port_pipe.rc, rc_state)


def _load_rc(rc, rc_state: Mapping) -> None:
    for f in _RC_FIELDS:
        v = rc_state[f]
        setattr(rc, f, list(v) if f == "_window" else v)


def _session_dpb(dpb, device, lead=None):
    """A session DPB (newest first) of numpy (y, u, v) tuples [B, H, W]
    as uint8 device planes; B the same in every plane (and `lead` where
    given)."""
    out = []
    for pic in dpb:
        planes = tuple(torch.from_numpy(np.array(p, np.uint8)).to(device)
                       for p in pic)
        leads = {p.shape[0] if p.ndim == 3 else None for p in planes}
        if len(leads) != 1 or None in leads or lead not in (None, *leads):
            raise ValueError(f"DPB planes {[tuple(p.shape) for p in planes]}")
        out.append(planes)
    return out


def load_jax_session_state(port_enc, dpb: Sequence, frame_num: int,
                           frame_in_gop: int, idr_pic_id: int,
                           force_idr: bool, rc_state: Mapping) -> None:
    """Load an encoder session's state into `port_enc` (tpuh264_torch
    EncoderSession): dpb, its reference pictures newest first, each (y, u,
    v) [S, H16, W16] / [S, H16/2, W16/2] uint8; then the JAX session's
    `frame_num`, `_frame_in_gop`, `idr_pic_id`, `_force_idr` and
    `rc_state_of(session.rc)`."""
    port_enc._dpb = _session_dpb(dpb, port_enc.device)
    port_enc.frame_num = int(frame_num)
    port_enc._frame_in_gop = int(frame_in_gop)
    port_enc.idr_pic_id = int(idr_pic_id)
    port_enc._force_idr = bool(force_idr)
    _load_rc(port_enc.rc, rc_state)


def load_jax_decoder_state(port_dec, dpb: Sequence, sps_fields: Mapping,
                           pps_fields: Mapping, nra: int, idc: int,
                           is_ref_frame: bool) -> None:
    """Load a decoder session's state into `port_dec` (tpuh264_torch
    DecoderSession): dpb, its reference pictures newest first, each (y,
    u, v) [1, H16, W16] / [1, H16/2, W16/2] uint8; the active SPS and PPS
    as their fields (`vars(session._sps)`); the JAX session's `_nra`,
    `_idc` and `_is_ref_frame`."""
    port_dec._dpb = _session_dpb(dpb, port_dec.device, 1)
    port_dec._fnums = []  # the JAX session keeps no frame numbers
    port_dec._sps = SPS(**sps_fields)
    port_dec._pps = PPS(**pps_fields)
    port_dec._nra = int(nra)
    port_dec._idc = int(idc)
    port_dec._is_ref_frame = bool(is_ref_frame)
