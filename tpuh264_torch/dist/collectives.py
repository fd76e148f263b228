"""The collectives of the distribution layer over torch.distributed.

gloo moves host tensors and NCCL device tensors, so the route follows the
group's backend: under gloo a device tensor is copied into a pinned host
buffer, exchanged on the host and copied back; under NCCL the device
tensor goes to the collective as it is.  Host tensors go as they are
under either.  (Which gloo ops would take CUDA tensors directly differs
between ops and versions; staging every one keeps the code independent
of that.)
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    """True when `t` lies on a device and `group` moves host tensors."""
    return (t.device.type != "cpu"
            and dist.get_backend(group) == dist.Backend.GLOO)


def _host(t: torch.Tensor) -> torch.Tensor:
    """A device tensor's copy in a pinned host buffer."""
    buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    buf.copy_(t)
    return buf


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum `t` in place over `group` (None: the world); returns `t`."""
    if _staged(t, group):
        h = _host(t)
        dist.all_reduce(h, group=group)
        t.copy_(h)
    else:
        dist.all_reduce(t, group=group)
    return t


def all_gather(t: torch.Tensor, group=None) -> List[torch.Tensor]:
    """Every member's `t` (all of one shape and dtype), in group rank
    order, as host tensors on every member.  The bytes travel as uint8,
    so any dtype goes (gloo reduces no int16, and a gather needs none)."""
    n = dist.get_world_size(group)
    raw = t.contiguous().reshape(-1).view(torch.uint8)
    if _staged(t, group):
        raw = _host(raw)
    out = [torch.empty_like(raw) for _ in range(n)]
    dist.all_gather(out, raw, group=group)
    return [o.cpu().view(t.dtype).reshape(t.shape) for o in out]


def neighbour_exchange(to_prev: torch.Tensor, to_next: torch.Tensor, group,
                       ranks: Sequence[int], index: int
                       ) -> Tuple[Optional[torch.Tensor],
                                  Optional[torch.Tensor]]:
    """Send `to_prev` to the previous member of the chain `ranks` (global
    ranks in order; this rank at `index`) and `to_next` to the next, and
    receive theirs: (from_prev, from_next), each shaped as what this rank
    sends the other way, None at an end of the chain.  One message pair
    per neighbour, posted together (`batch_isend_irecv`)."""
    staged = _staged(to_prev, group)
    move = _host if staged else torch.Tensor.contiguous
    ops, got = [], [None, None]
    for k, (send, peer) in enumerate(((to_prev, index - 1),
                                      (to_next, index + 1))):
        if not 0 <= peer < len(ranks):
            continue
        buf = move(send)
        got[k] = torch.empty_like(buf)
        ops.append(dist.P2POp(dist.isend, buf, ranks[peer], group))
        ops.append(dist.P2POp(dist.irecv, got[k], ranks[peer], group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    dev = to_prev.device
    return tuple(None if g is None else g.to(dev) if staged else g
                 for g in got)
