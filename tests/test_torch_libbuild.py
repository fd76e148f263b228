"""The one build-at-first-use helper behind both of the port's libraries
(the CUDA kernels and the host CAVLC engine): built once, reused while
fresh, rebuilt when the generated header or a source changes, one
builder at a time across processes, and a failed build raises and
leaves no library behind."""

import os
import subprocess
import sys

import pytest

from tpuh264_torch import libbuild
from tpuh264_torch.entropy import native
from tpuh264_torch.kernels import cuda_lib

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# a stand-in compiler: python -c COMPILE src out log appends a line to
# `log` and copies `src` to `out`
COMPILE = ("import shutil, sys, time; time.sleep(0.2); "
           "open(sys.argv[3], 'a').write('built\\n'); "
           "shutil.copy(sys.argv[1], sys.argv[2])")


def _copy_command(src, log):
    return lambda out: [sys.executable, "-c", COMPILE, str(src), out,
                        str(log)]


def _paths(tmp_path):
    src = tmp_path / "lib.c"
    src.write_text("source v1")
    return (src, str(tmp_path / "out" / "lib.so"),
            str(tmp_path / "out" / "tables.h"), tmp_path / "log")


def test_built_once_then_reused_then_rebuilt(tmp_path):
    src, lib, header, log = _paths(tmp_path)
    cmd = _copy_command(src, log)
    assert libbuild.ensure(lib, header, "tables 1", [str(src)], cmd) > 0
    assert open(lib).read() == "source v1"
    assert open(header).read() == "tables 1"
    assert libbuild.ensure(lib, header, "tables 1", [str(src)], cmd) == 0.0
    assert log.read_text().count("built") == 1
    # other tables rebuild
    assert libbuild.ensure(lib, header, "tables 2", [str(src)], cmd) > 0
    assert open(header).read() == "tables 2"
    # a source newer than the library rebuilds
    src.write_text("source v2")
    t = os.path.getmtime(lib)
    os.utime(src, (t + 10, t + 10))
    assert libbuild.ensure(lib, header, "tables 2", [str(src)], cmd) > 0
    assert open(lib).read() == "source v2"
    assert log.read_text().count("built") == 3
    assert not [f for f in os.listdir(os.path.dirname(lib))
                if f.endswith(".tmp")]


def test_concurrent_processes_build_once(tmp_path):
    """Three processes race to build one library: one builds, the others
    wait on the lock and then find it fresh."""
    src, lib, header, log = _paths(tmp_path)
    code = ("import sys; a = sys.argv; sys.path.insert(0, a[1]); "
            "from tpuh264_torch import libbuild; "
            "print(libbuild.ensure(a[3], a[4], 'tables', [a[2]], "
            "lambda out: [sys.executable, '-c', a[6], a[2], out, a[5]]))")
    procs = [subprocess.Popen([sys.executable, "-c", code, REPO, str(src),
                               lib, header, str(log), COMPILE],
                              stdout=subprocess.PIPE, text=True)
             for _ in range(3)]
    times = [float(p.communicate(timeout=60)[0]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    assert sum(t > 0 for t in times) == 1
    assert log.read_text().count("built") == 1
    assert open(lib).read() == "source v1"


def test_failed_build_raises_and_leaves_no_library(tmp_path):
    src, lib, header, _ = _paths(tmp_path)
    fail = lambda out: [sys.executable, "-c", "raise SystemExit(3)"]
    with pytest.raises(RuntimeError, match="failed"):
        libbuild.ensure(lib, header, "tables", [str(src)], fail)
    assert not os.path.exists(lib)
    assert libbuild.stale(lib, header, "tables", [str(src)])


# a stand-in object compiler: python -c STEP dir n src obj marks its start
# in `dir`, waits (up to 30 s, else exits 5) until n steps have started,
# then copies `src` to `obj`: it finishes only if all n run at once
STEP = ("import os, shutil, sys, time; d, n = sys.argv[1], int(sys.argv[2]); "
        "open(os.path.join(d, os.path.basename(sys.argv[3])), 'w').close(); "
        "t = time.time() + 30\n"
        "while len(os.listdir(d)) < n:\n"
        "    time.sleep(0.01)\n"
        "    if time.time() > t: raise SystemExit(5)\n"
        "shutil.copy(sys.argv[3], sys.argv[4])")
LINK = ("import sys; open(sys.argv[1], 'w').write("
        "''.join(open(p).read() for p in sys.argv[2:]))")


@pytest.mark.parametrize("fail", [False, True])
def test_steps_compile_at_once_then_link(tmp_path, fail):
    """A command given as a list of steps (the CUDA library's: one compiler
    a source, then the link) starts every step but the last at once and
    runs the last after them; a failing step raises, names its command
    and leaves no library."""
    srcs = []
    for i in range(3):
        srcs.append(tmp_path / f"k{i}.cu")
        srcs[-1].write_text(f"kernel {i};")
    lib, header = str(tmp_path / "out" / "lib.so"), str(tmp_path / "h.h")
    starts = tmp_path / "starts"
    starts.mkdir()

    def command(out):
        objs = [str(p) + ".o" for p in srcs]
        n = str(2 if fail else 3)  # the steps that wait for each other
        steps = [[sys.executable, "-c", STEP, str(starts), n, str(p), o]
                 for p, o in zip(srcs, objs)]
        if fail:
            steps[1] = [sys.executable, "-c", "raise SystemExit(3)"]
        return steps + [[sys.executable, "-c", LINK, out, *objs]]

    if fail:
        with pytest.raises(RuntimeError, match="SystemExit"):
            libbuild.ensure(lib, header, "t", list(map(str, srcs)), command)
        assert not os.path.exists(lib)
        return
    assert libbuild.ensure(lib, header, "t", list(map(str, srcs)),
                           command) > 0
    assert open(lib).read() == "kernel 0;kernel 1;kernel 2;"
    assert sorted(os.listdir(starts)) == ["k0.cu", "k1.cu", "k2.cu"]


@pytest.mark.parametrize("mod", [cuda_lib, native], ids=["cuda", "native"])
def test_both_libraries_build_into_the_port_build_dir(mod):
    """Both libraries go through the helper into tpuh264_torch/build/."""
    assert os.path.dirname(mod.LIB) == libbuild.BUILD
    assert libbuild.BUILD.endswith(os.path.join("tpuh264_torch", "build"))


def test_cuda_library_covers_every_source_and_header(tmp_path, monkeypatch):
    """The kernel library is built from every csrc/*.cu (one nvcc each,
    then one link of all the objects: K11's halfpel.cu and K12's
    me_winner.cu among them) and goes stale when any of them or a shared
    csrc/*.cuh header (K5 and K8's residual decode in
    intra16_common.cuh) is newer than the library."""
    names = {os.path.basename(p) for p in cuda_lib._deps()}
    assert {"halfpel.cu", "me_winner.cu", "intra_recon.cu", "wavefront.cu",
            "intra16_common.cuh", "inter_common.cuh"} <= names
    monkeypatch.setattr(cuda_lib, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(cuda_lib, "BUILD", str(tmp_path))
    steps = cuda_lib._command(str(tmp_path / "lib.so"))
    compiled = [os.path.basename(s[s.index("-c") + 1]) for s in steps[:-1]]
    assert sorted(compiled) == sorted(
        os.path.basename(p) for p in cuda_lib._sources())
    assert steps[-1][-len(compiled):] == [s[-1] for s in steps[:-1]]
    lib, header = tmp_path / "lib.so", tmp_path / "tables.cuh"
    lib.write_text("lib")
    header.write_text("tables")
    newest = max(os.path.getmtime(p) for p in cuda_lib._deps())
    os.utime(lib, (newest + 10, newest + 10))
    assert not libbuild.stale(str(lib), str(header), "tables",
                              cuda_lib._deps())
    shared = os.path.join(cuda_lib.CSRC, "intra16_common.cuh")
    t = os.path.getmtime(shared)
    os.utime(lib, (t - 10, t - 10))
    older = [p for p in cuda_lib._deps() if p != shared]
    assert not libbuild.stale(str(lib), str(header), "tables", [
        p for p in older if os.path.getmtime(p) < t - 10])
    assert libbuild.stale(str(lib), str(header), "tables", cuda_lib._deps())


def test_intra44_header_makes_the_library_stale(tmp_path):
    """K5's Intra_4x4 predictor lives in csrc/intra44_common.cuh, which
    intra_recon.cu includes: it is one of the library's dependencies, and
    a library older than it is rebuilt."""
    shared = os.path.join(cuda_lib.CSRC, "intra44_common.cuh")
    assert shared in cuda_lib._deps()
    with open(os.path.join(cuda_lib.CSRC, "intra_recon.cu")) as f:
        assert '#include "intra44_common.cuh"' in f.read()
    lib, header = tmp_path / "lib.so", tmp_path / "tables.cuh"
    lib.write_text("lib")
    header.write_text("tables")
    t = os.path.getmtime(shared)
    os.utime(lib, (t - 10, t - 10))
    assert libbuild.stale(str(lib), str(header), "tables", cuda_lib._deps())
    os.utime(lib, (t + 10, t + 10))
    assert not libbuild.stale(str(lib), str(header), "tables", [shared])
