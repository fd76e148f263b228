"""Build and load the port's CUDA kernels (../csrc/*.cu) as one library.

The sources are compiled at first use, on the machine with the card,
one nvcc a source, all started at once, then linked:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
         -Xcompiler -fPIC -I build -c csrc/X.cu -o build/obj/X.cu.o
    nvcc -gencode arch=compute_90a,code=sm_90a -shared
         -o build/libtpuh264_cuda.so build/obj/*.o

into `tpuh264_torch/build/` (git-ignored, see libbuild.py), together
with the generated header `cavlc_tables.cuh` (the CAVLC VLC tables of
the port's entropy/cavlc_tables.py as __constant__ arrays).  The
library has a plain C interface and is loaded with ctypes: every entry
takes device pointers and the CUDA stream as void* (K5's, K9-K15's, K4's
ring entry, K2's / K3's entries on the symbols and the probe's P1
`th264_probe_bits` and P2 `th264_probe_slab_sum` take their pointers and
ints as host arrays, `pointers` and `ints`), launches
on that stream and returns cudaGetLastError().  A missing nvcc or a failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import os
import shutil
import threading

import torch

from .. import libbuild

CSRC = os.path.join(os.path.dirname(libbuild.BUILD), "csrc")
BUILD = libbuild.BUILD
LIB = os.path.join(BUILD, "libtpuh264_cuda.so")
HEADER = os.path.join(BUILD, "cavlc_tables.cuh")
ARCH = "arch=compute_90a,code=sm_90a"

_lock = threading.Lock()
_lib = None
build_seconds = 0.0  # wall time of the last build (0 when it was cached)


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin", "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels of "
                       "tpuh264_torch are built from csrc/ at first use")


def _tables_header() -> str:
    from ..entropy import cavlc_tables as tbl
    from .cavlc_cuda import _tzc_dense

    arrays = {
        "kCT": tbl.coeff_token_dense().reshape(-1),
        "kTZ": tbl.total_zeros_dense().reshape(-1),
        "kTZC": _tzc_dense().reshape(-1),
        "kRB": tbl.run_before_dense().reshape(-1),
    }
    lines = ["// generated by tpuh264_torch/kernels/cuda_lib.py from",
             "// tpuh264_torch.entropy.cavlc_tables: (len << 16) | bits "
             "entries",
             "#pragma once"]
    for name, arr in arrays.items():
        vals = ", ".join(str(int(v)) for v in arr)
        lines.append(f"__constant__ int {name}[{arr.size}] = {{{vals}}};")
    return "\n".join(lines) + "\n"


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _deps():
    """The files the library is built from: the sources and the headers
    they share (*.cuh)."""
    return _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _stale(header_text: str) -> bool:
    """True when LIB is missing, older than a source or shared header, or
    was built against other VLC tables than the ones
    entropy/cavlc_tables.py gives now."""
    return libbuild.stale(LIB, HEADER, header_text, _deps())


def _command(out: str) -> list:
    """One nvcc a source into build/obj/ (libbuild starts them all at
    once), then the link of the objects into `out`."""
    nvcc, objs = _nvcc(), os.path.join(BUILD, "obj")
    os.makedirs(objs, exist_ok=True)
    steps, linked = [], []
    for src in _sources():
        obj = os.path.join(objs, os.path.basename(src) + ".o")
        steps.append([nvcc, "-gencode", ARCH, "-std=c++17", "-O3",
                      "-Xcompiler", "-fPIC", "-I", BUILD, "-c", src, "-o",
                      obj])
        linked.append(obj)
    return steps + [[nvcc, "-gencode", ARCH, "-shared", "-o", out, *linked]]


def load() -> ctypes.CDLL:
    """The kernel library, built first if it is missing or stale."""
    global _lib, build_seconds
    with _lock:
        if _lib is not None:
            return _lib
        build_seconds = libbuild.ensure(LIB, HEADER, _tables_header(),
                                        _deps(), _command)
        lib = ctypes.CDLL(LIB)
        p, i, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
        lib.th264_pack_blocks.argtypes = [p, p, p, p, p, p, p, p, i64, i, i, p]
        lib.th264_merge_tree.argtypes = [p, p, p, p, i64, i, i, i, p]
        lib.th264_deblock_rows.argtypes = [p] * 12 + [i, i, i, i, p]
        lib.th264_intra16_encode_rows.argtypes = (
            [p] * 3 + [i] + [p] * 12 + [i, i, i, i, p])
        lib.th264_intra16_in_p_rows.argtypes = (
            [p] * 3 + [i] + [p] * 17 + [i, i, i, i, p])
        lib.th264_intra44_encode_rows.argtypes = (
            [p] * 3 + [i] + [p] * 12 + [i, i, i, i, p, i, p])
        lib.th264_wavefront_encode.argtypes = (
            [p] * 3 + [i] + [p] * 12 + [i] * 5 + [p])
        lib.th264_wavefront_decode.argtypes = [p] * 11 + [i] * 5 + [p]
        lib.th264_wavefront_plan.argtypes = [i, i, p]
        lib.th264_pframe_encode_resident.argtypes = [p]
        lib.th264_pframe_decode_resident.argtypes = [p]
        lib.th264_merge_slices_resident.argtypes = [p]
        # K1, K5, K9-K15, K4's ring entry, the K2 / K3 entries on the
        # symbols and the probe's P1 / P2: a host array of device pointers,
        # one of ints, the stream
        arrays = (lib.th264_sad_field, lib.th264_intra_recon_rows,
                  lib.th264_pframe_encode, lib.th264_pframe_decode,
                  lib.th264_halfpel_refs, lib.th264_me_winner,
                  lib.th264_cavlc_prologue,
                  lib.th264_pack_symbols, lib.th264_merge_slices,
                  lib.th264_sse, lib.th264_source, lib.th264_deblock_ring,
                  lib.th264_probe_bits, lib.th264_probe_slab_sum)
        for fn in arrays:
            fn.argtypes = [p, p, p]
        for fn in (lib.th264_pack_blocks,
                   lib.th264_merge_tree, lib.th264_deblock_rows,
                   lib.th264_intra16_encode_rows,
                   lib.th264_intra16_in_p_rows, lib.th264_intra44_encode_rows,
                   lib.th264_wavefront_encode,
                   lib.th264_wavefront_decode, lib.th264_wavefront_plan,
                   lib.th264_pframe_encode_resident,
                   lib.th264_pframe_decode_resident,
                   lib.th264_merge_slices_resident, *arrays):
            fn.restype = ctypes.c_int
        lib.th264_cuda_error_string.argtypes = [ctypes.c_int]
        lib.th264_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(err: int, name: str) -> None:
    """Raise if a kernel entry reported a CUDA error at launch."""
    if err != 0:
        msg = _lib.th264_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def check_devices(name: str, device, tensors) -> None:
    """Raise unless every tensor lies on the CUDA `device`."""
    for t in tensors:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device ({device}), got {t.device}")


def check_inputs(name: str, device, specs, dtype=torch.int32) -> None:
    """Validate (tensor, shape) pairs before their pointers reach a kernel:
    each on the CUDA `device`, of `dtype`, of that shape, contiguous."""
    for t, shape in specs:
        if t.device != device or t.device.type != "cuda":
            raise ValueError(f"{name}: every input must be on one CUDA "
                             f"device ({device}), got {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: inputs must be {dtype}, got {t.dtype}")
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: shape {tuple(t.shape)} != {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def check_plane(name: str, device, t: torch.Tensor, shape) -> int:
    """Raise unless `t` is a plane as `pframe._references` lays it out: on
    the CUDA `device`, uint8, of `shape` ([4, S, Hp, Wp], [S, Hp, Wp] or
    [S, Hcp, Wcp]), its rows a pitch of a multiple of 16 bytes (at least
    the width) apart, its planes and streams one after another, its base
    16-byte aligned.  Returns the pitch."""
    if t.device != device or t.device.type != "cuda":
        raise ValueError(f"{name}: every plane must be on one CUDA device "
                         f"({device}), got {t.device}")
    if t.dtype != torch.uint8:
        raise TypeError(f"{name}: planes must be uint8, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: plane shape {tuple(t.shape)} != {shape}")
    pitch = t.stride(-2)
    want = [1, pitch]
    for k in range(t.dim() - 2, 0, -1):
        want.append(want[-1] * t.shape[k])
    if (tuple(t.stride()) != tuple(reversed(want)) or pitch % 16
            or pitch < t.shape[-1] or t.data_ptr() % 16):
        raise ValueError(f"{name}: a plane of strides {t.stride()} at "
                         f"{t.data_ptr() % 16} past 16-byte alignment is "
                         "not laid out as `pframe._references` lays it out")
    return pitch


def stream(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on `device`, as a kernel argument."""
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def pointers(tensors) -> ctypes.Array:
    """The tensors' device pointers as a host array (the `p` argument of
    the entries that take their pointers as one array); None is a null
    pointer."""
    return (ctypes.c_void_p * len(tensors))(*[
        None if t is None else t.data_ptr() for t in tensors])


def ints(values) -> ctypes.Array:
    """The values as a host array of C ints (those entries' `n`)."""
    return (ctypes.c_int * len(values))(*[int(x) for x in values])
