"""Build-at-first-use of the port's two shared libraries: the CUDA kernels
(kernels/cuda_lib.py, nvcc) and the host CAVLC engine
(entropy/native.py, g++).

Each library is compiled into `tpuh264_torch/build/` (git-ignored)
against a header generated from the port's own tables, and rebuilt when
it is missing, older than a source, or was built against other tables.
A file lock beside the library serialises builders across processes
(the CPU suite runs under xdist), and the compiler writes a temporary
name that is renamed into place, so no process loads a half-written
library.  A failed build raises.
"""

from __future__ import annotations

import fcntl
import os
import subprocess
import time
from typing import Callable, Sequence

BUILD = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build")


def stale(lib: str, header: str, header_text: str,
          sources: Sequence[str]) -> bool:
    """True when `lib` is missing, older than one of `sources`, or was
    built against another generated header than `header_text`."""
    if not os.path.exists(lib) or not os.path.exists(header):
        return True
    with open(header) as f:
        if f.read() != header_text:
            return True
    t = os.path.getmtime(lib)
    return any(os.path.getmtime(p) > t for p in sources)


def ensure(lib: str, header: str, header_text: str, sources: Sequence[str],
           command: Callable[[str], list]) -> float:
    """Build `lib` unless it is fresh: write `header`, then run
    `command(out)`: the compiler line writing the library to `out`, or a
    list of such lines whose last one writes it, the others started all at
    once before it (one compiler a source, then the link).  Returns the
    build's wall seconds, 0 when the library was fresh."""
    os.makedirs(os.path.dirname(lib), exist_ok=True)
    with open(f"{lib}.lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)  # one builder across processes
        if not stale(lib, header, header_text, sources):
            return 0.0
        t0 = time.perf_counter()
        tmp = f"{header}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(header_text)
        os.replace(tmp, header)
        tmp = f"{lib}.{os.getpid()}.tmp"
        cmds = command(tmp)
        steps = cmds if cmds and isinstance(cmds[0], list) else [cmds]
        procs = [(c, subprocess.Popen(c, stdout=subprocess.PIPE,
                                      stderr=subprocess.PIPE, text=True))
                 for c in steps[:-1]]
        results = []
        for c, p in procs:
            out, err = p.communicate()
            results.append((c, p.returncode, out, err))
        if all(rc == 0 for _, rc, _, _ in results):
            res = subprocess.run(steps[-1], capture_output=True, text=True)
            results.append((steps[-1], res.returncode, res.stdout,
                            res.stderr))
        for cmd, rc, out, err in results:
            if rc != 0:
                raise RuntimeError(f"{os.path.basename(cmd[0])} failed:\n"
                                   + " ".join(cmd) + "\n" + out + err)
        os.replace(tmp, lib)
        return time.perf_counter() - t0
