"""Multi-host distribution: torch.distributed process groups (config 5).

Port of tpuh264/dist/multihost.py.  The reference never leaves one
machine; the north star scales the codec across hosts: process groups in
which each rank owns a band of the (streams, rows) mesh, stream sharding
across hosts, and row sharding with the DPB halo exchange inside a host
or -- when the mesh is laid out that way -- across hosts.

This module is both a library (initialize, the global mesh, the
multi-process GOP encode step) and a runnable worker::

    python -m tpuh264_torch.dist.multihost --process-id I --num-processes N \
        [--coordinator localhost:29800 | file:///path] [--rows-across-hosts] \
        [--backend gloo|nccl] [--device cuda]

Every rank runs the same program on its band; bands are cut from host
arrays every rank reproduces, so no rank materialises another's data on
its device.  gloo carries the collectives between host buffers (the
ranks may share one card, or run on the CPU with --device cpu); NCCL
carries them between cards, one rank per card.

Verification (the reference has no multi-node story to test): each
worker encodes an IPPP sequence over the mesh, all-gathers the
reconstruction, and bit-compares it with its own unsharded encode.
Bit-exactness with the rows axis across processes proves that the DPB
halo crossed the process boundary correctly.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import time
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def initialize(coordinator: str, num_processes: int, process_id: int,
               backend: str = "gloo", device="cuda",
               timeout_s: float = 300.0) -> None:
    """Join the process group.  `coordinator` is host:port (a tcp://
    rendezvous) or a file:// path every process can reach.  A rank that
    cannot reach its rendezvous, or a collective that waits longer than
    `timeout_s`, raises."""
    init = (coordinator if coordinator.startswith(("file://", "tcp://"))
            else f"tcp://{coordinator}")
    if backend == "nccl":  # NCCL binds each rank to its card
        torch.cuda.set_device(torch.device(device).index or 0)
    dist.init_process_group(
        backend, init_method=init, world_size=num_processes,
        rank=process_id, timeout=datetime.timedelta(seconds=timeout_s))


def global_codec_mesh(rows_across_hosts: bool = False,
                      shape: Optional[Tuple[int, int]] = None, *,
                      device="cuda"):
    """(streams, rows) mesh over every rank of the world.

    Ranks are host-major; a host holds LOCAL_WORLD_SIZE of them (as
    torchrun sets it; 1 when unset: one process per host, as this
    module's CLI runs).  rows_across_hosts=False: the rows axis stays
    inside a host and the streams axis spans hosts (pure stream
    parallelism between hosts, no traffic there).  True: the rows axis
    strides across hosts, so the P step's DPB halo crosses the host
    boundary every frame (the north star's DPB page exchange).

    `shape`: force the (streams, rows) shape regardless of the host count,
    for scaling runs that must run one global workload."""
    from . import mesh as dmesh

    world = dist.get_world_size()
    per = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
    grid = np.arange(world).reshape(world // per, per)
    if rows_across_hosts:
        grid = grid.T
    if shape is not None:
        grid = grid.reshape(shape)
    return dmesh.make_codec_mesh(*grid.shape, ranks=grid, device=device)


def place_global(mesh, arr: np.ndarray) -> torch.Tensor:
    """This rank's band of a (reproducible) global host array, on the
    mesh's device; no rank ever holds another's band there."""
    from . import mesh as dmesh

    return dmesh.shard_inputs(mesh, arr)[0]


def run_gop_worker(
    coordinator: str,
    num_processes: int,
    process_id: int,
    rows_across_hosts: bool = True,
    width: int = 128,
    height: int = 64,
    qp: int = 30,
    bench_reps: int = 0,
    mesh_shape: Optional[Tuple[int, int]] = None,
    *,
    backend: str = "gloo",
    device="cuda",
) -> dict:
    """Encode I + 2 P frames over the global mesh and check them against
    this rank's unsharded encode.  Returns the result dict (the JSON the
    tests read), with the device and K1's launches in the sharded P
    steps."""
    initialize(coordinator, num_processes, process_id, backend, device)
    try:
        return _gop(num_processes, process_id, rows_across_hosts, width,
                    height, qp, bench_reps, mesh_shape, device)
    finally:
        dist.destroy_process_group()


def _gop(num_processes, process_id, rows_across_hosts, width, height, qp,
         bench_reps, mesh_shape, device) -> dict:
    from ..engine import sources
    from ..kernels import iframe, me_cuda, pframe
    from . import mesh as dmesh

    mesh = global_codec_mesh(rows_across_hosts, shape=mesh_shape,
                             device=device)
    s_shards, r_shards = mesh.shape
    # the halo's form follows the layout: the fused uint8 message pair
    # only where the rows axis crosses a process boundary (see
    # mesh.sharded_gop_step); both are bit-identical
    rows_cross = rows_across_hosts and num_processes > 1
    i_fn, p_fn = dmesh.sharded_gop_step(mesh, fused_halo=rows_cross)

    # deterministic moving content, identical in every process
    def batch(t):
        frames = [sources.yuv_frame(width, height, t + 3 * si)
                  for si in range(s_shards)]
        return tuple(np.stack([f[i] for f in frames]) for i in range(3))

    y0, u0, v0 = batch(0)
    seq = [batch(t) for t in range(1, 3)]

    k1 = me_cuda.sad_field.launches
    sym_i, recon = i_fn(*(place_global(mesh, a) for a in (y0, u0, v0)), qp)
    recs = [recon]
    for planes in seq:
        _, recon, _ = p_fn(*(place_global(mesh, a) for a in planes),
                           *recs[-1], qp)
        recs.append(recon)
    k1 = me_cuda.sad_field.launches - k1

    # gather the final reconstruction to every process and compare with
    # the local unsharded encode (bit-exact across the halo)
    got_y = dmesh.gather(mesh, recs[-1][0])
    got_u = dmesh.gather(mesh, recs[-1][1])

    dev = mesh.device
    up = lambda a: torch.from_numpy(a).to(dev)
    _, ref = iframe.encode_iframe_rows(up(y0), up(u0), up(v0), qp)
    for planes in seq:
        _, ref, _ = pframe.encode_pframe_rows_multi(
            *(up(a) for a in planes), *(r[None] for r in ref), qp)
    result = {
        "process_id": process_id,
        "processes": num_processes,
        "mesh": [int(s_shards), int(r_shards)],
        "rows_across_hosts": bool(rows_across_hosts),
        "fused_halo": bool(rows_cross),
        "bitexact": bool(torch.equal(got_y, ref[0].cpu())
                         and torch.equal(got_u, ref[1].cpu())),
        "backend": dist.get_backend(),
        "device": str(dev),
        "device_kind": (torch.cuda.get_device_name(dev)
                        if dev.type == "cuda" else "cpu"),
        "k1_launches": k1,
    }

    if bench_reps:
        # scaling measurement: the steady-state sharded P step, fenced
        args = (*(place_global(mesh, a) for a in seq[-1]), *recs[-1], qp)
        sync = (torch.cuda.synchronize if dev.type == "cuda"
                else lambda: None)
        p_fn(*args)
        sync()
        t0 = time.perf_counter()
        for _ in range(bench_reps):
            p_fn(*args)
        sync()
        result["p_step_ms"] = (time.perf_counter() - t0) / bench_reps * 1e3
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default="localhost:29800",
                    help="host:port of rank 0, or a file:// rendezvous")
    ap.add_argument("--num-processes", type=int, required=True)
    ap.add_argument("--process-id", type=int, required=True)
    ap.add_argument("--rows-across-hosts", action="store_true")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=64)
    ap.add_argument("--bench-reps", type=int, default=0)
    ap.add_argument(
        "--mesh", default=None,
        help="force (streams, rows) mesh shape, e.g. 4x2 -- for scaling "
             "runs where 1-process and N-process must share the workload",
    )
    ap.add_argument("--backend", choices=("gloo", "nccl"), default="gloo")
    ap.add_argument("--device", default="cuda",
                    help="where this rank's tensors live (cpu for a run "
                         "without a card)")
    args = ap.parse_args()
    shape = None
    if args.mesh:
        s_, r_ = args.mesh.split("x")
        shape = (int(s_), int(r_))
    result = run_gop_worker(
        args.coordinator, args.num_processes, args.process_id,
        rows_across_hosts=args.rows_across_hosts,
        width=args.width, height=args.height, bench_reps=args.bench_reps,
        mesh_shape=shape, backend=args.backend, device=args.device,
    )
    print("MULTIHOST_RESULT " + json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
