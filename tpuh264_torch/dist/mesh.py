"""Sharding of the codec over a (streams, rows) grid of torch.distributed
ranks.

Port of tpuh264/dist/mesh.py.  Two axes map the codec's independence
structure onto ranks:

  * `streams` -- independent input streams (the reference's stream
    pool, app.js:351,521, as a sharded batch axis);
  * `rows` -- bands of MB rows within a frame.  The I frame's row slices
    share no state, so its bands need no traffic; the P frame reads the
    reference across a band's edges, so the P step exchanges HALO_Y /
    HALO_C reference rows with the neighbour bands (the DPB halo), and
    the motion search's global vector sums its counts over the rows.

JAX runs one SPMD program over devices (shard_map); PyTorch runs one
process per rank.  So `make_codec_mesh` places this rank in a grid over
the initialised world and creates one process group per stream shard
(the ranks holding that shard's bands, the JAX `rows` axis), in the same
order on every rank; the step functions take and return this rank's
LOCAL band [S_loc, H_loc, W]; `shard_inputs` cuts that band from a host
array every rank holds (JAX's device_put with a sharding); `gather`
all-gathers bands into the global array for checks (JAX's
process_allgather).

The mesh's `device` decides where tensors live.  Nothing maps rank r to
card r, so several ranks may share one card under gloo.  Collectives
take the route their group's backend needs (dist/collectives.py).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..engine.devpipe import resolve_device
from ..kernels import iframe, pframe
from .collectives import all_gather, all_reduce, neighbour_exchange

I32 = torch.int32


class CodecMesh(NamedTuple):
    """This rank's place in the (streams, rows) grid of global ranks."""

    grid: np.ndarray       # [n_streams, n_rows] global ranks
    stream_index: int      # this rank's stream shard
    row_index: int         # this rank's row band
    rows_group: object     # process group of this stream shard's bands
    device: torch.device   # where this rank's tensors live

    @property
    def shape(self):
        return self.grid.shape

    @property
    def rows_ranks(self):
        """The global ranks of this rank's rows group, top band first."""
        return [int(r) for r in self.grid[self.stream_index]]


def make_codec_mesh(
    n_streams_shards: Optional[int] = None,
    n_row_shards: Optional[int] = None,
    ranks=None,
    *,
    device="cuda",
) -> CodecMesh:
    """Build a (streams, rows) grid over `ranks` (default: the world, in
    rank order).  Every rank of the world must call this, with the same
    arguments: it creates the rows groups collectively."""
    device = resolve_device(device)
    ranks = np.asarray(ranks if ranks is not None
                       else np.arange(dist.get_world_size()))
    n = ranks.size
    if n_streams_shards is None and n_row_shards is None:
        # favour stream parallelism (independent work, zero comms)
        n_streams_shards, n_row_shards = n, 1
    elif n_streams_shards is None:
        n_streams_shards = n // n_row_shards
    elif n_row_shards is None:
        n_row_shards = n // n_streams_shards
    if n_streams_shards * n_row_shards != n or n != dist.get_world_size():
        raise ValueError(f"grid {n_streams_shards}x{n_row_shards} does not "
                         f"cover the {dist.get_world_size()} ranks ({n})")
    grid = ranks.reshape(n_streams_shards, n_row_shards)
    groups = [dist.new_group([int(r) for r in row]) for row in grid]
    si, ri = (int(i) for i in np.argwhere(grid == dist.get_rank())[0])
    return CodecMesh(grid, si, ri, groups[si], device)


def shard_inputs(mesh: CodecMesh, *arrays):
    """This rank's band of each global [S, H, ...] host array (numpy, or a
    tensor on the host), copied to the mesh's device: streams split over
    the `streams` axis, rows over the `rows` axis."""
    ns, nr = mesh.shape
    out = []
    for a in arrays:
        a = np.asarray(a)
        s, h = a.shape[:2]
        if s % ns or h % nr:
            raise ValueError(f"[{s}, {h}, ...] does not split over a "
                             f"{ns}x{nr} mesh")
        sl, hl = s // ns, h // nr
        band = np.array(a[mesh.stream_index * sl:(mesh.stream_index + 1) * sl,
                          mesh.row_index * hl:(mesh.row_index + 1) * hl])
        out.append(torch.from_numpy(band).to(mesh.device))
    return tuple(out)


def gather(mesh: CodecMesh, t: torch.Tensor) -> torch.Tensor:
    """The global array of a band-sharded [S_loc, R_loc, ...] tensor, on
    the host of every rank (a collective: every rank calls it)."""
    bands = all_gather(t)
    return torch.cat([torch.cat([bands[int(r)] for r in row], 1)
                      for row in mesh.grid], 0)


def sharded_encode_step(mesh: CodecMesh):
    """The row-sliced I encode of this rank's band, plus the mesh-wide
    [sum |levels|, nonzero levels] (int64, summed over every rank): the
    per-frame accounting rate control needs.  Row slices make the bands
    independent, so the encode itself exchanges nothing."""

    def step(y, u, v, qp: int):
        symbols, recon = iframe.encode_iframe_rows(y, u, v, qp)
        levels = (symbols.luma_dc, symbols.luma_ac, symbols.chroma_dc,
                  symbols.chroma_ac)
        stats = torch.stack([
            sum(x.abs().sum(dtype=torch.int64) for x in levels),
            sum((x != 0).sum(dtype=torch.int64) for x in levels)])
        return symbols, recon, all_reduce(stats)

    return step


def _extend(plane, head, tail, halo: int):
    """[S, H, W] -> [S, H + 2 halo, W]: the neighbours' rows above and
    below, or the band's edge rows replicated where there is no neighbour
    (the frame's top and bottom: the normative Clip3 sample clamp)."""
    if head is None:
        head = plane[:, :1].expand(-1, halo, -1)
    if tail is None:
        tail = plane[:, -1:].expand(-1, halo, -1)
    return torch.cat([head, plane, tail], 1)


def _halo_extend(plane, halo: int, mesh: CodecMesh):
    """Vertically extend a row-sharded plane [S, H_loc, W] with `halo`
    rows of each neighbour band: my top rows go to the band above (its
    tail), my bottom rows to the band below (its head).  One int32
    message pair per neighbour."""
    plane = plane.to(I32)
    head, tail = neighbour_exchange(plane[:, :halo], plane[:, -halo:],
                                    mesh.rows_group, mesh.rows_ranks,
                                    mesh.row_index)
    return _extend(plane, head, tail, halo)


def _halo_extend_yuv(ry, ru, rv, halo_y: int, halo_c: int, mesh: CodecMesh):
    """The DPB halo of all three reference planes in one uint8 message
    pair per neighbour: the samples are 8-bit, and the three planes'
    boundary rows pack into one [S, halo_y*W + 2*halo_c*W/2] buffer (4x
    less volume and a third of the messages of the per-plane form).
    Returns the three extended int32 planes, bit-identical to
    `_halo_extend` of each."""
    s = ry.shape[0]
    sizes = (halo_y * ry.shape[2], halo_c * ru.shape[2], halo_c * rv.shape[2])

    def pack(rows):
        return torch.cat([p.to(torch.uint8).reshape(s, -1) for p in rows], 1)

    def unpack(buf):
        if buf is None:
            return (None,) * 3
        py, pu, pv = torch.split(buf, sizes, 1)
        return (py.reshape(s, halo_y, -1).to(I32),
                pu.reshape(s, halo_c, -1).to(I32),
                pv.reshape(s, halo_c, -1).to(I32))

    head, tail = neighbour_exchange(
        pack((ry[:, :halo_y], ru[:, :halo_c], rv[:, :halo_c])),
        pack((ry[:, -halo_y:], ru[:, -halo_c:], rv[:, -halo_c:])),
        mesh.rows_group, mesh.rows_ranks, mesh.row_index)
    return tuple(_extend(p.to(I32), h, t, halo) for p, h, t, halo in zip(
        (ry, ru, rv), unpack(head), unpack(tail), (halo_y, halo_c, halo_c)))


def sharded_gop_step(mesh: CodecMesh, fused_halo: bool = True):
    """The (I, P) encode steps of this rank's band, with a row-sharded DPB
    that stays where the band is.

    Returns (i_step, p_step):
      i_step(y, u, v, qp) -> (symbols, recon)
      p_step(y, u, v, ry, ru, rv, qp) -> (symbols, recon, motion)
    on local bands.  The P step exchanges HALO_Y / HALO_C reference rows
    with the neighbour bands before the motion search, which reads across
    the band's edges exactly as the unsharded encode reads the frame, and
    sums the search's winner counts over the rows group: the gathered
    result is bit-identical to the unsharded encode (intra-in-P on, one
    reference, as the JAX step).

    `fused_halo` picks the exchange's form, a choice of speed only (both
    are bit-identical): the fused uint8 single-message form wins where
    the rows axis crosses processes on the host (gloo charges per message
    and per byte); the per-plane form wins in-process, where the packing
    costs more than the messages it saves.  Callers that know the layout
    (dist/multihost.py) pass fused_halo = (the rows axis spans hosts)."""

    def i_step(y, u, v, qp: int):
        return iframe.encode_iframe_rows(y, u, v, qp)

    def p_step(y, u, v, ry, ru, rv, qp: int):
        if fused_halo:
            ext = _halo_extend_yuv(ry, ru, rv, pframe.HALO_Y, pframe.HALO_C,
                                   mesh)
        else:
            ext = (_halo_extend(ry, pframe.HALO_Y, mesh),
                   _halo_extend(ru, pframe.HALO_C, mesh),
                   _halo_extend(rv, pframe.HALO_C, mesh))
        return pframe.encode_pframe_rows_multi(
            y, u, v, *(e[None] for e in ext), qp, halo=True,
            group=mesh.rows_group)

    return i_step, p_step
