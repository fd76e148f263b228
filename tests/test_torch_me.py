"""K1 (stage-A motion search): the port's plain version against the JAX
reference and numpy truth, and the winner selection with ties.

The CUDA kernel itself is compared with the plain version on the card
(tests/test_torch_cuda.py, and chip_smoke.py at 1080p shapes).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

import tpuh264.kernels.pframe as JP
from tpuh264_torch.kernels import me_cuda
from tpuh264_torch.kernels import pframe as TP

SR = JP.SEARCH_RANGE
PE = JP._PE


def _truth(src2, g, h, w):
    """numpy ground-truth SAD table [S,R,C,NN] (dy-major, dx-minor)."""
    s = src2.shape[0]
    r, c = h // 16, w // 16
    out = np.zeros((s, r, c, (2 * SR + 1) ** 2), np.int64)
    k = 0
    for dy in range(-SR, SR + 1):
        for dx in range(-SR, SR + 1):
            r2 = g[:, PE + dy:PE + dy + h:2, PE + dx:PE + dx + w:2]
            out[..., k] = np.abs(src2 - r2).reshape(s, r, 8, c, 8).sum((2, 4))
            k += 1
    return out


def _case(s, h, w, seed):
    rng = np.random.default_rng(seed)
    y = rng.integers(0, 256, (s, h, w)).astype(np.int32)
    ref = rng.integers(0, 256, (s, h, w)).astype(np.int32)
    return y, ref


@pytest.mark.parametrize("s,h,w", [(1, 48, 80), (2, 64, 128)])
def test_halfpel_planes_match_jax(s, h, w):
    _, ref = _case(s, h, w, seed=s + 10)
    jp = JP.build_halfpel_planes(jnp.asarray(ref))
    tp = TP.build_halfpel_planes(torch.from_numpy(ref))
    for a, b in zip(jp, tp):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("s,h,w", [(1, 48, 80), (2, 64, 128)])
def test_sad_field_plain_matches_truth_and_jax(s, h, w):
    y, ref = _case(s, h, w, seed=s)
    g = np.array(JP.build_halfpel_planes(jnp.asarray(ref))[0])
    got = me_cuda.sad_field(torch.from_numpy(y), torch.from_numpy(g)).numpy()
    np.testing.assert_array_equal(got, _truth(y[:, ::2, ::2], g, h, w))
    jax_tab = np.asarray(JP._sad_field(jnp.asarray(y[:, ::2, ::2]),
                                       jnp.asarray(g), h, w))
    np.testing.assert_array_equal(got, jax_tab)


def _tied_sads(seed, s=2, r=3, c=5):
    """SAD tables whose costs tie at several candidates per MB."""
    rng = np.random.default_rng(seed)
    nn = (2 * SR + 1) ** 2
    sads = rng.integers(0, 6, (s, r, c, nn)).astype(np.int32) * 4
    # many exact ties: a flat plateau of equal SADs
    sads[..., ::3] = 0
    return sads


@pytest.mark.parametrize("seed,qp", [(3, 30), (4, 0), (5, 51)])
def test_int_winner_matches_jax_with_ties(seed, qp):
    sads = _tied_sads(seed)
    lam = int(JP._LAM_ME[qp])
    ref = JP._int_winner(jnp.asarray(sads), jnp.int32(lam))
    got = TP._int_winner(torch.from_numpy(sads), lam)
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_argmin_first_ties():
    x = torch.tensor([[3, 1, 1, 2], [0, 0, 0, 0], [5, 4, 4, 4]])
    np.testing.assert_array_equal(TP._argmin_first(x).numpy(), [1, 0, 1])
    np.testing.assert_array_equal(TP._argmax_first(x).numpy(), [0, 0, 0])



# K1's source on CPU threads: (S, H, W, content); W = 80 and 144 leave
# ragged 8-MB tiles (5 and 9 MB columns), H = 48 an odd MB row count.
K1_CPU_CASES = [(1, 48, 80, "noise"), (2, 32, 144, "0/255"),
                (1, 48, 144, "max"), (2, 64, 128, "noise")]


@pytest.fixture(scope="module")
def k1_cpu(tmp_path_factory):
    """csrc/me_sad.cu (all but its launch entries) built with g++ against
    the shims of tests/cuda_threads.py: a block's 288 threads as fibers."""
    import os

    import cuda_threads
    from tpuh264_torch.kernels import cuda_lib

    return cuda_threads.build_entry(
        tmp_path_factory.mktemp("k1_cpu"),
        os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc"),
        "me_sad.cu", "sad_args", "sad_field_kernel", "a.blocks", "kThreads")


def _k1_case(s, h, w, content):
    """K1's inputs: the int32 source and the G plane of a uint8 reference
    as `pframe._references` lays it out, its pitch bytes set to 0x5a (no
    sample may read them)."""
    rng = np.random.default_rng([s, h, w, len(content)])
    if content == "max":
        y = np.full((s, h, w), 255, np.int32)
        ref = np.zeros((s, h, w), np.uint8)
    elif content == "0/255":
        y, ref = (rng.integers(0, 2, (2, s, h, w)) * 255)
    else:
        y, ref = rng.integers(0, 256, (2, s, h, w))
    g = TP._references_plain(*[torch.from_numpy(
        np.ascontiguousarray(x, np.uint8))[None] for x in (
            ref, ref[:, ::2, ::2], ref[:, ::2, ::2])], False)[0][0][0]
    buf = torch.full((s, g.shape[1], TP._pitch(g.shape[2])), 0x5A,
                     dtype=torch.uint8)
    buf[..., :g.shape[2]] = g
    return torch.from_numpy(np.asarray(y, np.int32)), buf[..., :g.shape[2]]


@pytest.mark.parametrize("case", K1_CPU_CASES, ids=str)
def test_k1_source_on_cpu_threads_matches_plain(k1_cpu, case):
    """K1's staging of the byte plane (16- and 8-byte loads at aligned
    columns, the phase split by byte permutes, the columns past the
    plane's width zeroed), its SIMD SADs and its coalesced table, a block
    at a time, equal the plain version on the case, from the uint8 G
    plane with 16-byte-aligned rows that K11 writes."""
    import cuda_threads

    y, g = _k1_case(*case)
    s, h, w = y.shape
    assert g.dtype == torch.uint8 and g.stride(1) % 16 == 0
    out = torch.empty((s, h // 16, w // 16, me_cuda.NN), dtype=torch.int32)
    cuda_threads.run_entry(k1_cpu, [y, g], [out], me_cuda._k1_ints(y, g))
    want = me_cuda.sad_field(y, g)
    assert want.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), want.numpy())
    if case[3] == "max":
        assert (want == 16320).all()
