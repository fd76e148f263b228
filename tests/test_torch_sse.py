"""K14 (the decoder's SSE): its source on CPU threads against the plain
version, the plain version against an exact numpy sum, and the router.

The cases come from `chip_smoke.K14_CASES` / `k14_case` (fan-out 1, 2, 3
and 8, no source, one MB); the card's first case, an interior 1080p x 4
dispatch, is left to chip_smoke.py: on CPU threads it would take
minutes.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264_torch.kernels import cuda_lib, sse

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")
CASES = [c for c in chip_smoke.K14_CASES if c[0][2] * c[0][3] < 1 << 20]


@pytest.fixture(scope="module")
def k14_cpu(tmp_path_factory):
    """csrc/sse.cu (all but its launch entry) built with g++ against the
    shims: a block's 256 threads as fibers, redux.sync through their
    exchanges, the 64-bit atomic add a host atomic."""
    return cuda_threads.build_entry(tmp_path_factory.mktemp("k14_cpu"), CSRC,
                                    "sse.cu", "sse_args", "sse_kernel",
                                    "a.blocks", "kThreads")


def _inputs(case):
    dec, src = chip_smoke.k14_case(np, *case)
    return ([torch.from_numpy(d) for d in dec],
            None if src is None else torch.from_numpy(src), dec, src)


@pytest.mark.parametrize("case", CASES, ids=str)
def test_k14_source_on_cpu_threads_matches_plain(k14_cpu, case):
    """K14's 16-byte loads, 32-bit partial sums, redux and 64-bit atomics
    equal the plain version on the case (the totals start at zero, as the
    entry's memset leaves them)."""
    dec, src, _, _ = _inputs(case)
    want = sse._sse_plain(dec, src, case[1])
    ins, outs, ints = sse._k14_operands(dec, src, case[1])
    outs[0].zero_()
    (got,) = cuda_threads.run_entry(k14_cpu, ins, outs, ints, inout=(0,))
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("case", CASES, ids=str)
def test_plain_sse_is_exact(case):
    """The plain version is the exact int64 sum of squared differences,
    decode stream d against source stream d // fanout (zeros without a
    source)."""
    dec, src, d_np, s_np = _inputs(case)
    fan = case[1]
    ref = np.zeros(d_np.shape[:2], np.int64)
    for f in range(d_np.shape[0]):
        for d in range(d_np.shape[1]):
            x = d_np[f, d].astype(np.int64)
            if s_np is not None:
                x = x - s_np[f, d // fan]
            ref[f, d] = (x * x).sum()
    got = sse._sse_plain(dec, src, fan)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), ref)


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """CPU planes take the plain version without loading the library; a
    meta tensor raises rather than falling back."""
    monkeypatch.setattr(cuda_lib, "load", lambda: pytest.fail("loaded"))
    dec, src, _, _ = _inputs(CASES[0])
    n = sse.sse.launches
    sse.sse(dec, src, CASES[0][1])
    assert sse.sse.launches == n
    with pytest.raises((ValueError, TypeError, RuntimeError,
                        NotImplementedError)):
        sse.sse([d.to("meta") for d in dec], src.to("meta"), CASES[0][1])
