"""P1 and P2: the toolchain probe of tools/pallas_smoke.py, as Hopper
kernels behind the probe's own entry point.

P1 (`probe_bits`) runs the bit operations the CAVLC kernel needs on every
int32 element: a logical right shift by `x & 7`, a left shift by
`8 - (x & 7)`, OR, `+ clz(x | 1)`, `+ (x > 5)`, all wrapping mod 2^32.
P2 (`slab_sum`) sums 16 int32 slabs [16, M, L] into [M, L], wrapping.
They replace the script's `kernel` (:7, pallas_call :18) and `k2` (:35,
pallas_call :41).  Each router launches csrc/probe.cu for CUDA tensors
(or raises) and takes its plain version for CPU tensors; each counts its
launches (`probe_bits.launches`, `slab_sum.launches`).  The probe has no
parameters and carries no state: there is nothing to convert from the
JAX package.

    python -m tpuh264_torch.kernels.probe [--device cuda|cpu]

runs the script's two checks through the routers on the card (by
default; without one it raises unless `--device cpu` is given) and
prints `match: True` and `grid sum match: True`; it exits 1 on a
mismatch.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from . import cuda_lib

I64 = torch.int64
SLABS = 16  # P2's slabs (csrc/probe.cu kSlabs, the script's range(16))
THREADS = 256  # csrc/probe.cu kThreads
MAX_ELEMENTS = 1 << 30  # the kernels index in int


def _wrap32(v: torch.Tensor) -> torch.Tensor:
    """int64 values as int32, mod 2^32 (two's complement)."""
    return (((v + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)).to(torch.int32)


def _clz32(v: torch.Tensor) -> torch.Tensor:
    """Leading zeros of the 32-bit values v (int64, 1 <= v < 2^32), by a
    binary search of shifts."""
    n = torch.zeros_like(v)
    for s in (16, 8, 4, 2, 1):
        small = v < (1 << (32 - s))  # the top s bits are zero
        n = n + small.to(I64) * s
        v = torch.where(small, v << s, v)
    return n


def _probe_bits_plain(x: torch.Tensor) -> torch.Tensor:
    """Plain version of `probe_bits`, in int64, wrapped to int32."""
    x = x.to(I64)
    u = x & 0xFFFFFFFF
    sh = u & 7
    r = (u >> sh) | ((u << (8 - sh)) & 0xFFFFFFFF)
    return _wrap32(r + _clz32(u | 1) + (x > 5).to(I64))


def _slab_sum_plain(lv: torch.Tensor) -> torch.Tensor:
    """Plain version of `slab_sum`, in int64, wrapped to int32."""
    return _wrap32(lv.to(I64).sum(0))


def _grid_cap(dev) -> int:
    """The kernels' grid cap: the blocks of THREADS that fit on the card's
    SMs at once (2,048 threads an SM on sm_90)."""
    return (torch.cuda.get_device_properties(dev).multi_processor_count
            * (2048 // THREADS))


def _launch(name: str, x: torch.Tensor, out: torch.Tensor,
            count: int) -> bool:
    """Check `x` (one CUDA device, int32, contiguous, at most MAX_ELEMENTS
    in all, 4-byte aligned) and launch the entry `name` over {x, out} and
    `count` elements, unless there are none; True where it launched.
    16-byte alignment picks the route: the kernels take 16-byte chunks
    only where both pointers have it, the scalar loop otherwise."""
    cuda_lib.check_inputs(name, x.device, [(x, x.shape)])
    if x.numel() > MAX_ELEMENTS or x.data_ptr() % 4:
        raise ValueError(f"{name}: the kernel takes at most {MAX_ELEMENTS} "
                         f"4-byte-aligned int32 elements, got {x.numel()} "
                         f"at address {x.data_ptr():#x}")
    if not count:
        return False
    err = getattr(cuda_lib.load(), name)(
        cuda_lib.pointers([x, out]),
        cuda_lib.ints([count, _grid_cap(x.device)]),
        cuda_lib.stream(x.device))
    cuda_lib.check(err, name)
    return True


def probe_bits(x: torch.Tensor) -> torch.Tensor:
    """P1 on every element of the int32 tensor `x` (any shape): a new
    int32 tensor of its shape."""
    if x.device.type == "cpu":
        return _probe_bits_plain(x)
    out = torch.empty_like(x)
    if _launch("th264_probe_bits", x, out, x.numel()):
        probe_bits.launches += 1
    return out


def slab_sum(lv: torch.Tensor) -> torch.Tensor:
    """P2: the sum of the SLABS int32 slabs of lv [SLABS, M, L], int32
    [M, L], wrapping."""
    if lv.dim() != 3 or lv.shape[0] != SLABS:
        raise ValueError(f"slab_sum: shape {tuple(lv.shape)}: the kernel "
                         f"takes [{SLABS}, M, L]")
    if lv.device.type == "cpu":
        return _slab_sum_plain(lv)
    out = torch.empty(lv.shape[1:], dtype=torch.int32, device=lv.device)
    if _launch("th264_probe_slab_sum", lv, out, out.numel()):
        slab_sum.launches += 1
    return out


probe_bits.launches = 0  # launches of P1
slab_sum.launches = 0  # launches of P2


def bits_truth(xn: np.ndarray) -> np.ndarray:
    """P1 in numpy, as tools/pallas_smoke.py :25-31 computes its truth."""
    xn = xn.astype(np.int64)
    sh = xn & 7
    ref = ((xn >> sh) | (xn << np.clip(8 - sh, 0, 31))) & 0xFFFFFFFF
    clz = np.array([32 - int(v | 1).bit_length()
                    for v in xn.reshape(-1)]).reshape(xn.shape)
    return (ref + clz + (xn > 5)).astype(np.int32)


def main(argv=None) -> int:
    """The probe: P1 on arange(8 * 128) as [8, 128] and P2 on
    arange(16 * 32 * 128) as [16, 32, 128], through the routers, each
    against the script's numpy truth.  0 where both match, else 1."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default; raises without a card) or cpu")
    args = ap.parse_args(argv)
    from ..engine.devpipe import resolve_device

    dev = resolve_device(args.device)
    x = torch.arange(8 * 128, dtype=torch.int32, device=dev).reshape(8, 128)
    ok = np.array_equal(probe_bits(x).cpu().numpy(),
                        bits_truth(np.arange(8 * 128).reshape(8, 128)))
    print("match:", bool(ok))
    lv = torch.arange(16 * 32 * 128, dtype=torch.int32,
                      device=dev).reshape(16, 32, 128)
    grid_ok = bool(np.array_equal(slab_sum(lv).cpu().numpy(),
                                  lv.cpu().numpy().sum(0)))
    print("grid sum match:", grid_ok)
    return 0 if ok and grid_ok else 1


if __name__ == "__main__":
    sys.exit(main())
