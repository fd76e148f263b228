"""Multi-host distribution of the port: 2 torch.distributed processes
(gloo, on the CPU), bit-exact GOP -- the counterpart of
tests/test_dist_multihost.py.

Two real OS processes of `python -m tpuh264_torch.dist.multihost` encode
an IPPP sequence: with the rows axis spanning the process boundary
("dcn-halo": the P step's DPB halo crosses it), and with the streams axis
spanning it ("stream-parallel").  Each compares the all-gathered
reconstruction with its own unsharded encode.  The rendezvous is a
`file://` path under the test's temporary directory (no port to collide
with under xdist); every process has a timeout and both are killed on a
failure."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(init: str, pid: int, rows_across: bool):
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cmd = [sys.executable, "-m", "tpuh264_torch.dist.multihost",
           "--coordinator", init, "--num-processes", "2",
           "--process-id", str(pid), "--device", "cpu"]
    if rows_across:
        cmd.append("--rows-across-hosts")
    return subprocess.Popen(cmd, env=env, cwd=REPO, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)


@pytest.mark.parametrize("rows_across", [True, False],
                         ids=["dcn-halo", "stream-parallel"])
def test_two_process_gop_bitexact(rows_across, tmp_path):
    init = f"file://{tmp_path / 'rendezvous'}"
    procs = [_launch(init, 0, rows_across), _launch(init, 1, rows_across)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=180)
            assert p.returncode == 0, f"worker failed:\n{err[-3000:]}"
            outs.append(out)
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for pid, out in enumerate(outs):
        line = [l for l in out.splitlines()
                if l.startswith("MULTIHOST_RESULT ")]
        assert line, f"no result line in: {out[-500:]}"
        result = json.loads(line[0].split(" ", 1)[1])
        assert result["bitexact"], result
        assert result["processes"] == 2 and result["process_id"] == pid
        assert result["mesh"] == ([1, 2] if rows_across else [2, 1])
        assert result["fused_halo"] == rows_across
        assert (result["backend"], result["device"]) == ("gloo", "cpu")
