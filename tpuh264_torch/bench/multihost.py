"""Two-host scaling efficiency of the sharded P step (BASELINE north
star: >= 80%).

Port of tools/bench_multihost.py.  It runs `python -m
tpuh264_torch.dist.multihost --bench-reps` twice on the same global
(streams, rows) mesh and workload, one process a rank under gloo:

  1. every rank on one host (LOCAL_WORLD_SIZE = the world): the rows
     groups stay inside the host;
  2. the ranks split over two hosts (LOCAL_WORLD_SIZE = half the world)
     with the rows axis across them (--rows-across-hosts), so the P
     step's DPB halo crosses the host boundary every frame.

Efficiency = t(one host) / t(two hosts), each the slowest rank's mean
fenced P step.  Every rank's gathered reconstruction must equal its own
unsharded encode (bit-exact), and an efficiency above 1.05 -- identical
hardware cannot scale past 1 -- fails the run: the one-host figure is
then not the best one-host configuration.  The host layout is the
environment's spelling of it (`dist.multihost.global_codec_mesh`); the
ranks of both layouts run on this machine, so what crosses "hosts" here
crosses processes, as in the JAX tool.  On the card the ranks share it
(gloo stages the halo through host memory); NCCL between cards is not
run here.

    python -m tpuh264_torch.bench.multihost [--reps 30] [--width 832
        --height 480] [--mesh 4x2] [--device cuda]

Prints one JSON line, `2host_scaling_efficiency`, naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Tuple

from .harness import device_info

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def start_layout(tmp: str, tag: str, world: int, local_world: int,
                 rows_across_hosts: bool, mesh: Optional[Tuple[int, int]],
                 reps: int, width: int, height: int, device: str):
    """Start `world` rank processes of the multihost worker, hosts of
    `local_world` ranks, rendezvous and output files under `tmp`.
    Returns [(process, log file)]."""
    env = dict(os.environ, LOCAL_WORLD_SIZE=str(local_world),
               OMP_NUM_THREADS="1",
               PYTHONPATH=_ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                               ""))
    procs = []
    for rank in range(world):
        cmd = [sys.executable, "-m", "tpuh264_torch.dist.multihost",
               "--coordinator", f"file://{tmp}/{tag}.rdv",
               "--num-processes", str(world), "--process-id", str(rank),
               "--bench-reps", str(reps), "--width", str(width),
               "--height", str(height), "--device", str(device)]
        if rows_across_hosts:
            cmd.append("--rows-across-hosts")
        if mesh is not None:
            cmd += ["--mesh", f"{mesh[0]}x{mesh[1]}"]
        log = open(os.path.join(tmp, f"{tag}{rank}.log"), "w+")
        procs.append((subprocess.Popen(cmd, cwd=_ROOT, env=env, stdout=log,
                                       stderr=subprocess.STDOUT), log))
    return procs


def collect(procs, timeout_s: float) -> List[Dict[str, object]]:
    """Each rank's MULTIHOST_RESULT.  A rank that fails, prints no result
    or outlives `timeout_s` raises; every process is killed on the way
    out."""
    deadline = time.monotonic() + timeout_s
    results = []
    try:
        for p, log in procs:
            rc = p.wait(timeout=max(1.0, deadline - time.monotonic()))
            log.seek(0)
            out = log.read()
            lines = [ln for ln in out.splitlines()
                     if ln.startswith("MULTIHOST_RESULT ")]
            if rc != 0 or not lines:
                raise RuntimeError(f"rank exited {rc}"
                                   f"{'' if lines else ' without a result'}"
                                   f":\n{out[-3000:]}")
            results.append(json.loads(lines[-1].split(" ", 1)[1]))
    finally:
        for p, log in procs:
            p.kill()
            p.wait()
            log.close()
    return results


def run_layout(world: int, local_world: int, rows_across_hosts: bool,
               mesh: Optional[Tuple[int, int]], reps: int, width: int,
               height: int, device: str = "cuda",
               timeout_s: float = 1800.0) -> List[Dict[str, object]]:
    """One layout, start to end: every rank's result, each bit-exact."""
    with tempfile.TemporaryDirectory(prefix="tpuh264_multihost_") as tmp:
        results = collect(start_layout(
            tmp, "job", world, local_world, rows_across_hosts, mesh, reps,
            width, height, device), timeout_s)
    for r in results:
        if not r["bitexact"]:
            raise AssertionError(f"rank {r['process_id']} is not bit-exact: "
                                 f"{r}")
    return results


def measure(mesh: Tuple[int, int] = (4, 2), reps: int = 30,
            width: int = 832, height: int = 480, device: str = "cuda",
            timeout_s: float = 1800.0) -> Dict[str, object]:
    """Both layouts of the mesh's ranks, one after the other -> their
    slowest ranks' P-step ms, halo forms and efficiency (no guard), and
    each rank's K1 launches in its checked I + 2 P (one host's ranks
    first)."""
    dev = device_info(device)
    world = mesh[0] * mesh[1]
    if world < 2 or world % 2:
        raise ValueError(f"mesh {mesh}: two hosts need an even world of "
                         f"at least 2 ranks")
    one = run_layout(world, world, True, mesh, reps, width, height, device,
                     timeout_s)
    two = run_layout(world, world // 2, True, mesh, reps, width, height,
                     device, timeout_s)
    t1 = max(r["p_step_ms"] for r in one)
    t2 = max(r["p_step_ms"] for r in two)
    return {
        "metric": "2host_scaling_efficiency",
        "width": width, "height": height,
        "mesh": f"{mesh[0]}x{mesh[1]} (rows across hosts)",
        "ranks": world, "backend": one[0]["backend"],
        "bitexact": True,
        "fused_halo_1host": one[0]["fused_halo"],
        "fused_halo_2host": two[0]["fused_halo"],
        "p_step_ms_1host": round(t1, 2),
        "p_step_ms_2host": round(t2, 2),
        "efficiency": round(t1 / t2, 3),
        "k1_launches": [r["k1_launches"] for r in one + two],
        "k9_launches": [r["k9_launches"] for r in one + two],
        "device": dev,
    }


def check_efficiency(line: Dict[str, object]) -> None:
    """bench_multihost's guard: identical hardware cannot scale past ~1;
    a figure above 1.05 means the one-host baseline is not the best
    one-host configuration."""
    if line["efficiency"] > 1.05:
        raise AssertionError(
            f"efficiency {line['efficiency']:.3f} > 1.05: the one-host "
            "baseline is not the best one-host configuration -- fix the "
            "baseline, not the ratio")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--width", type=int, default=832)
    ap.add_argument("--height", type=int, default=480)
    ap.add_argument("--mesh", default="4x2",
                    help="(streams, rows) mesh, both layouts")
    ap.add_argument("--device", default="cuda",
                    help="where the ranks' tensors live (cpu for a run "
                         "without a card)")
    args = ap.parse_args(argv)
    s, r = (int(x) for x in args.mesh.split("x"))
    line = measure((s, r), args.reps, args.width, args.height, args.device)
    check_efficiency(line)
    print(json.dumps(line))


if __name__ == "__main__":
    main()
