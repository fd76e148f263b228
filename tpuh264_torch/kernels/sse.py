"""K14: the decoder's SSE against the dispatch's source frames, exact in
int64, in one launch.

Replaces the SSE of the JAX package's decode program
(tpuh264/engine/devpipe.py :692-696, a float32 sum there), not a
pallas_call.  `sse` launches csrc/sse.cu for CUDA tensors (or raises) and
takes the plain version `_sse_plain` for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import cuda_lib

I64 = torch.int64
MAX_FRAMES = 16  # the kernel's kMaxFrames


def _sse_plain(dec: Sequence[torch.Tensor], src: Optional[torch.Tensor],
               fanout: int = 1) -> torch.Tensor:
    """Plain version of `sse` (same arguments), in int64."""
    out = []
    for f, d in enumerate(dec):
        e = d.to(I64)
        if src is not None:
            e = e - src[f].repeat_interleave(fanout, 0).to(I64)
        out.append((e * e).reshape(d.shape[0], -1).sum(-1))
    return torch.stack(out)


def _k14_operands(dec: Sequence[torch.Tensor], src: Optional[torch.Tensor],
                  fanout: int = 1, out: Optional[torch.Tensor] = None):
    """K14's operands in its entry's order (csrc/sse.cu `sse_args`):
    (input tensors -- MAX_FRAMES decoded planes, None past k, then the
    source --, output tensors, ints); the totals `out`, or freshly
    allocated."""
    k = len(dec)
    s, h, w = dec[0].shape
    ins = list(dec) + [None] * (MAX_FRAMES - k) + [src]
    if out is None:
        out = torch.empty((k, s), dtype=I64, device=dec[0].device)
    return ins, [out], [k, s, fanout, h * w]


def sse(dec: Sequence[torch.Tensor], src: Optional[torch.Tensor],
        fanout: int = 1, out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per frame f and decode stream d, sum((dec[f][d] - src[f, d //
    fanout])^2) over the plane, int64 [k, S]: dec the k decoded luma
    planes [S, H, W] uint8, src the source frames [k, S / fanout, H, W]
    uint8, or None to measure against zeros.  The totals land in `out`
    (an int64 [k, S] tensor, e.g. row f of a dispatch's) where given,
    which is returned."""
    if dec[0].device.type == "cpu":
        got = _sse_plain(dec, src, fanout)
        return got if out is None else out.copy_(got)
    k = len(dec)
    s, h, w = dec[0].shape
    if not 1 <= k <= MAX_FRAMES or fanout < 1 or s % fanout or (h * w) % 16:
        raise ValueError(f"sse: {k} frames of {tuple(dec[0].shape)}, fanout "
                         f"{fanout}: the kernel takes 1..{MAX_FRAMES} frames "
                         f"of whole 16-byte rows, S a multiple of fanout")
    dev = dec[0].device
    specs = [(d, (s, h, w)) for d in dec]
    if src is not None:
        specs.append((src, (k, s // fanout, h, w)))
    cuda_lib.check_inputs("sse", dev, specs, dtype=torch.uint8)
    if any(x.data_ptr() % 16 for x, _ in specs):
        raise ValueError("sse: planes must be 16-byte aligned")
    if out is not None:
        cuda_lib.check_inputs("sse", dev, [(out, (k, s))], dtype=I64)
    ins, outs, ints = _k14_operands(dec, src, fanout, out)
    err = cuda_lib.load().th264_sse(cuda_lib.pointers(ins + outs),
                                    cuda_lib.ints(ints), cuda_lib.stream(dev))
    cuda_lib.check(err, "th264_sse")
    sse.launches += 1
    return outs[0]


sse.launches = 0  # launches of K14
