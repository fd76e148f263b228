"""Carry a running pipeline's state into the port.

The codec has no learned weights; what a `GOPDevicePipeline` carries
from one dispatch to the next is its state: both DPBs, the GOP position,
the source clock (dispatch index and dropped frames) and the rate
controller.  `load_jax_state` takes that
state as numpy arrays and scalars -- read off a tpuh264 (JAX)
`GOPDevicePipeline`, for example -- and puts it into a port pipeline on
its device, so both can continue from the same mid-GOP point.
"""

from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

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
    dev = port_pipe.device

    def planes(dpb, ref):
        out = []
        for p, r in zip(dpb, ref):
            a = np.asarray(p)
            if a.shape != tuple(r.shape):
                raise ValueError(f"DPB plane {a.shape} != {tuple(r.shape)}")
            out.append(torch.from_numpy(a.astype(np.int32)).to(dev))
        return tuple(out)

    port_pipe._dpb_enc = planes(dpb_enc, port_pipe._dpb_enc)
    port_pipe._dpb_dec = planes(dpb_dec, port_pipe._dpb_dec)
    port_pipe._gop_pos = int(gop_pos)
    port_pipe.dispatch_index = int(dispatch_index)
    port_pipe.time_offset = int(time_offset)
    for f in _RC_FIELDS:
        v = rc_state[f]
        setattr(port_pipe.rc, f, list(v) if f == "_window" else v)
