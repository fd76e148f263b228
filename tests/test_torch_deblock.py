"""The deblock (D1): the port's plain version against the JAX package's
`deblock_frame_rows` on seeded edge cases, the kernel's source run on
CPU threads against the plain version, the kernel's tables against the
port's golden tables, and the wrapper's CPU route.

The inputs come from `chip_smoke.d1_case`, the generator chip_smoke.py
phase 2 holds the kernel to its plain version with on the card.  Every
comparison is exact (array_equal): this is an integer codec.
"""

import os
import re
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264.kernels import deblock as jdb
from tpuh264_torch.golden.deblock import ALPHA, BETA, TC0
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import deblock as tdb

SOURCE = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc",
                      "deblock.cu")


def _torch(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("shape,variant,qp", chip_smoke.D1_CASES)
def test_plain_deblock_matches_jax(shape, variant, qp):
    y, u, v, kind, mvx, mvy, nnz, ref, t8 = chip_smoke.d1_case(
        np, shape, variant, qp)
    j = jdb.deblock_frame_rows(y, u, v, kind, mvx, mvy, nnz, qp,
                               refidx=ref, t8=t8)
    t = tdb.deblock_frame_rows(*map(_torch, (y, u, v, kind, mvx, mvy, nnz)),
                               qp, refidx=_torch(ref), t8=_torch(t8))
    for a, b in zip(j, t):
        assert b.dtype == torch.uint8
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_edge_cases_cover_what_they_claim():
    """C = 1 and odd S, R, C; a long lane of an even C >= 16 (the register
    pipeline and the exchanges over many columns, the last MB stored after
    an even count); MV steps of 3, 4 and 5 quarter pels; refidx 0..3; t8
    both ways; all-intra; samples at 0 and 255; filtering at qp 16 and
    above, none below (alpha is 0 there)."""
    shapes = {(s, h // 16, w // 16) for s, h, w in chip_smoke.D1_SHAPES}
    assert any(c == 1 for _, _, c in shapes)
    assert any(s % 2 and r % 2 and c % 2 for s, r, c in shapes)
    assert any(c % 2 == 0 and c >= 16 for _, _, c in shapes)
    assert set(chip_smoke.D1_QPS) >= {0, 15, 16, 51}
    y, u, v, kind, mvx, mvy, nnz, ref, t8 = chip_smoke.d1_case(
        np, (3, 80, 112), "t8", 30)
    steps = {int(x) for m in (mvx, mvy) for x in np.abs(np.diff(m, axis=-1))
             .ravel()}
    assert {0, 3, 4, 5} <= steps
    assert set(np.unique(ref)) == {0, 1, 2, 3}
    assert set(np.unique(t8)) == {0, 1}
    assert set(np.unique(kind)) == {0, 1, 2}
    assert (nnz == 0).any() and (nnz > 0).any()
    for p in (y, u, v):
        assert p.min() == 0 and p.max() == 255
    assert chip_smoke.d1_case(np, (3, 80, 112), "inter", 30)[8] is None
    intra = chip_smoke.d1_case(np, (3, 80, 112), "intra", 30)
    assert (intra[3] == 2).all() and intra[7] is None and intra[8] is None
    for qp, changed in ((15, False), (16, True)):
        y, u, v, *rest = chip_smoke.d1_case(np, (3, 80, 112), "inter", qp)
        out = tdb.deblock_frame_rows(*map(_torch, (y, u, v, *rest[:4])), qp,
                                     refidx=_torch(rest[4]))
        assert (not np.array_equal(out[0].numpy(), y)) == changed


# Reads int32 S R C qp qpc has_ref has_t8, then the int32 inputs (y, u,
# v, kind, mvx, mvy, ref, t8, nnz) on stdin; writes the uint8 planes.
HARNESS = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include <thread>
#include <vector>
#include "deblock.cu"
int main() {
  int32_t a[7];
  if (fread(a, 4, 7, stdin) != 7) return 2;
  const int S = a[0], R = a[1], C = a[2], qp = a[3], qpc = a[4];
  const int has_ref = a[5], has_t8 = a[6];
  const size_t n = (size_t)S * 256 * R * C, nc = n / 4, m = (size_t)S * R * C;
  std::vector<int32_t> y(n), u(nc), v(nc), kind(m), mvx(m), mvy(m), ref(m),
      t8(m), nnz(16 * m);
  for (auto* a : {&y, &u, &v, &kind, &mvx, &mvy, &ref, &t8, &nnz})
    if (fread(a->data(), 4, a->size(), stdin) != a->size()) return 3;
  std::vector<uint8_t> o(n + 2 * nc);
  const Args args = rows_args(
      y.data(), u.data(), v.data(), kind.data(), mvx.data(), mvy.data(),
      has_ref ? ref.data() : nullptr, has_t8 ? t8.data() : nullptr,
      nnz.data(), o.data(), o.data() + n, o.data() + n + nc, S * R, C, qp,
      qpc);
  std::barrier<> luma(32), chroma(32);
  g_warp[0] = &luma;
  g_warp[1] = &chroma;
  for (int b = 0; b < (S * R + 1) / 2; ++b) {
    std::vector<std::thread> block;
    for (int t = 0; t < 64; ++t)
      block.emplace_back([&, t, b] {
        threadIdx.x = t;
        blockIdx.x = b;
        deblock_rows_kernel<int32_t, false>(args);
      });
    for (auto& th : block) th.join();
  }
  fwrite(o.data(), 1, o.size(), stdout);
  return 0;
}
"""


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """csrc/deblock.cu (all but its launch entry) built with g++ against
    the shims of cuda_threads.py: the kernel's own source, run on CPU
    threads (a block's 64 threads, each warp's __syncwarp a barrier)."""
    return cuda_threads.build(tmp_path_factory.mktemp("deblock_cpu"),
                              HARNESS, os.path.dirname(SOURCE),
                              "deblock_cpu")


@pytest.mark.parametrize("variant", chip_smoke.D1_VARIANTS)
def test_kernel_source_on_cpu_threads_matches_plain(cpu_kernel, variant):
    """The kernel's filters, bS bookkeeping, exchanges and register
    pipeline, run a block's 64 threads at a time with each warp's
    __syncwarp as a barrier, equal the plain version on every shape and
    qp of the variant."""
    from tpuh264_torch.kernels.transform import chroma_qp_from_luma

    for shape, var, qp in chip_smoke.D1_CASES:
        if var != variant:
            continue
        y, u, v, kind, mvx, mvy, nnz, ref, t8 = chip_smoke.d1_case(
            np, shape, variant, qp)
        s, h, w = shape
        zero = np.zeros(kind.shape, np.int32)
        head = np.array([s, h // 16, w // 16, qp, chroma_qp_from_luma(qp),
                         ref is not None, t8 is not None], np.int32)
        body = b"".join(np.ascontiguousarray(a, np.int32).tobytes() for a in (
            head, y, u, v, kind, mvx, mvy, zero if ref is None else ref,
            zero if t8 is None else t8, nnz))
        out = np.frombuffer(subprocess.run(
            [cpu_kernel], input=body, capture_output=True,
            check=True).stdout, np.uint8)
        n = y.size
        got = (out[:n].reshape(y.shape), out[n:n + u.size].reshape(u.shape),
               out[n + u.size:].reshape(v.shape))
        want = tdb.deblock_frame_rows(
            *map(_torch, (y, u, v, kind, mvx, mvy, nnz)), qp,
            refidx=_torch(ref), t8=_torch(t8))
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b.numpy(), err_msg=str(shape))


def _table(src, name):
    m = re.search(r"__constant__ int %s\[52\](?:\[3\])? = \{(.*?)\};" % name,
                  src, re.S)
    assert m, name
    return np.array([int(x) for x in re.findall(r"-?\d+", m.group(1))],
                    np.int32)


def test_kernel_tables_equal_golden():
    """ALPHA, BETA and TC0 are written into csrc/deblock.cu as __constant__
    arrays: they must equal the port's golden/deblock.py tables."""
    with open(SOURCE) as f:
        src = f.read()
    np.testing.assert_array_equal(_table(src, "kAlpha"), ALPHA)
    np.testing.assert_array_equal(_table(src, "kBeta"), BETA)
    np.testing.assert_array_equal(_table(src, "kTc0").reshape(52, 3), TC0)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On CPU tensors the wrapper (and deblock_i / deblock_p through it)
    takes the plain version: the kernel library is never loaded and the
    launch counter does not move."""
    def refuse():
        raise AssertionError("the kernel library was loaded for CPU tensors")

    monkeypatch.setattr(cuda_lib, "load", refuse)
    before = tdb.deblock_frame_rows.launches
    y, u, v, kind, mvx, mvy, nnz, ref, t8 = [
        _torch(a) for a in chip_smoke.d1_case(np, (2, 32, 48), "t8", 30)]
    out = tdb.deblock_frame_rows(y, u, v, kind, mvx, mvy, nnz, 30,
                                 refidx=ref, t8=t8)
    assert [o.shape for o in out] == [y.shape, u.shape, v.shape]
    tdb.deblock_i((y, u, v), 30)
    assert tdb.deblock_frame_rows.launches == before
