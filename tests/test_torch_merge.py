"""K3 at both levels of the port's entropy stage, against the JAX package
on the CPU: the plain `tree_merge` on the seeded edge cases of
chip_smoke.py's `k3_case`, the one-call slice finish (slice body and rbsp
trailing bits in one `merge_tree`) against `entropy_tpu._finish_slices`,
and the entropy stage reaching the merge only through `merge_tree`.
Exact comparisons throughout."""

import ast
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import k3_case
from tpuh264.kernels import entropy_tpu
from tpuh264_torch.core.params import PPS, SPS
from tpuh264_torch.core.sliceheader import SLICE_P
from tpuh264_torch.entropy import device_pack as tdp
from tpuh264_torch.kernels import cavlc_cuda, entropy_gpu
from tpuh264_torch.kernels import iframe as tif
from tpuh264_torch.kernels import pframe as TP

SLICE_BITS = 32 * entropy_gpu.SLICE_W


@pytest.mark.parametrize("k,w,n_out", [
    (1, 1, 1), (1, 128, 8192), (27, 1, 16), (27, 20, 16), (27, 20, 128),
    (123, 20, 128), (123, 128, 8192)])
def test_tree_merge_matches_xla_on_k3_cases(k, w, n_out):
    """The port's plain version equals the JAX package's: bit totals on
    every lane, words on the lanes that fit n_out words.  (Past that the
    JAX barrel shifter is out of its domain: it takes a word offset below
    n_out, and wraps a larger one.  For K = 1 it returns the W words
    uncut; the port cuts them at n_out.)"""
    rng = np.random.default_rng(k * w + n_out)
    words, bits = k3_case(rng, np, 21, k, w)
    got_w, got_b = cavlc_cuda.merge_tree(torch.from_numpy(words),
                                         torch.from_numpy(bits), n_out)
    ref_w, ref_b = entropy_tpu.tree_merge(jnp.asarray(words),
                                          jnp.asarray(bits), n_out)
    ref_w = np.asarray(ref_w)[:, :n_out]
    ref_w = np.pad(ref_w, ((0, 0), (0, n_out - ref_w.shape[-1])))
    np.testing.assert_array_equal(np.asarray(ref_b), got_b.numpy())
    assert got_w.shape == (21, n_out)
    fits = bits.sum(-1) <= 32 * n_out
    assert fits.sum() >= 5  # the empty lanes, at least
    np.testing.assert_array_equal(ref_w[fits], got_w.numpy()[fits])


def _masked(rng, bits, w, ones):
    """MSB-first strings of `bits` bits in w words: all ones, or random,
    zero past the length."""
    raw = (np.full((*bits.shape, w), 0xFFFFFFFF, np.uint64) if ones
           else rng.integers(0, 1 << 32, (*bits.shape, w), dtype=np.uint64))
    keep = np.clip(bits[..., None] - 32 * np.arange(w), 0, 32)
    low = (np.uint64(1) << (32 - keep).astype(np.uint64)) - np.uint64(1)
    return (raw & (np.uint64(0xFFFFFFFF) ^ low)).astype(np.uint32).view(
        np.int32)


def _slice_case(rng, k):
    """[2, 3] slices of k strings of MB_W words: random, every string
    empty, one string at the full 4096 bits; at k = 123 also a body 30
    bits short of 32*SLICE_W, one that ends exactly there with its rbsp
    tail, and one past it."""
    mb_w = entropy_gpu.MB_W
    bits = rng.integers(0, 400, (6, k))
    bits[1] = 0
    bits[2, k // 2] = 32 * mb_w
    if k == 123:
        for lane, body in ((3, SLICE_BITS - 30), (4, SLICE_BITS - 3),
                           (5, SLICE_BITS + 100)):
            bits[lane] = body // k
            bits[lane, :body % k] += 1
    words = _masked(rng, bits, mb_w, ones=False)
    words[3:] = _masked(rng, bits[3:], mb_w, ones=True)
    return (words.reshape(2, 3, k, mb_w),
            bits.astype(np.int32).reshape(2, 3, k))


@pytest.mark.parametrize("k", [1, 57, 123])
def test_finish_slices_matches_jax(k):
    """Body and rbsp trailing bits in one K3 call equal the JAX package's
    merge-then-append: words where the slice fits SLICE_W, byte counts and
    the overflow flag everywhere."""
    rng = np.random.default_rng(k)
    words, bits = _slice_case(rng, k)
    ref_w, ref_bytes, ref_ovf = entropy_tpu._finish_slices(
        jnp.asarray(words), jnp.asarray(bits), 2, 3)
    got_w, got_bytes, got_ovf = entropy_gpu._finish_slices(
        [torch.from_numpy(words)], [torch.from_numpy(bits)])
    ref_bytes = np.asarray(ref_bytes)
    np.testing.assert_array_equal(ref_bytes, got_bytes.numpy())
    assert bool(ref_ovf) == bool(got_ovf) == (k == 123)
    fits = 8 * ref_bytes <= SLICE_BITS
    np.testing.assert_array_equal(np.asarray(ref_w)[fits],
                                  got_w.numpy()[fits])
    if k == 123:
        assert fits.reshape(-1)[3] and fits.reshape(-1)[4]
        assert 8 * ref_bytes.reshape(-1)[4] == SLICE_BITS
        assert not fits.reshape(-1)[5]


def _symbols(seed, s=2, h=48, w=64, qp=28):
    """Port I symbols of frame 0 and intra-in-P P symbols of frame 1."""
    rng = np.random.default_rng(seed)
    frames = [[torch.from_numpy(rng.integers(0, 256, (s, h // d, w // d))
                                .astype(np.int32)) for d in (1, 2, 2)]
              for _ in range(2)]
    sym_i, rec = tif.encode_iframe_rows(*frames[0], qp)
    refs = [p.to(torch.int32)[None] for p in rec]
    sym_p, _, _ = TP.encode_pframe_rows_multi(*frames[1], *refs, qp,
                                              intra_in_p=True)
    return sym_i, sym_p


def test_entropy_reaches_the_merge_only_through_merge_tree(monkeypatch):
    """One encode_bits_pframe (and one encode_bits_iframe) call goes
    through K3 twice: cavlc_cuda.merge_tree at the MB level (128 words)
    and K3's slice entry, cavlc_cuda.merge_slices, at the slice level
    (8192 words; the header, the MBs' strings, the P tail and the rbsp
    trailer read where they lie); the plain tree_merge is reached only
    from inside those two."""
    sym_i, sym_p = _symbols(3)
    s, r, c = sym_p.kind.shape
    sps = SPS.for_size(16 * c, 16 * r)
    real_merge, real_tree = cavlc_cuda.merge_tree, cavlc_cuda.tree_merge
    real_slices = cavlc_cuda.merge_slices
    seen, inside = [], []

    def merge_spy(words, bits, n_out):
        seen.append((tuple(words.shape), n_out))
        inside.append(True)
        try:
            return real_merge(words, bits, n_out)
        finally:
            inside.pop()

    def slices_spy(hdr_hw, hdr_len, mb_hw, mb_bits, tail, n_out, ovf):
        # the strings of a slice: header, C MBs, (P) tail, trailer
        k = 1 + mb_hw.shape[-2] + (tail is not None) + 1
        seen.append(((*hdr_len.shape, k, mb_hw.shape[-1]), n_out))
        inside.append(True)
        try:
            return real_slices(hdr_hw, hdr_len, mb_hw, mb_bits, tail, n_out,
                               ovf)
        finally:
            inside.pop()

    def tree_spy(*a):
        assert inside, "tree_merge reached outside merge_tree"
        return real_tree(*a)

    monkeypatch.setattr(cavlc_cuda, "merge_tree", merge_spy)
    monkeypatch.setattr(cavlc_cuda, "merge_slices", slices_spy)
    monkeypatch.setattr(cavlc_cuda, "tree_merge", tree_spy)
    hdr_p = tdp.slice_headers_device(sps, PPS(), 28, 1, False, s,
                                     slice_type=SLICE_P, deblock_idc=2,
                                     device="cpu")
    entropy_gpu.encode_bits_pframe(sym_p, 28, *hdr_p)
    assert seen == [((s, r, c, 27, entropy_gpu.BLOCK_W), entropy_gpu.MB_W),
                    ((s, r, c + 3, entropy_gpu.MB_W), entropy_gpu.SLICE_W)]
    seen.clear()
    hdr_i = tdp.slice_headers_device(sps, PPS(), 28, 0, True, s,
                                     deblock_idc=2, device="cpu")
    entropy_gpu.encode_bits_iframe(sym_i, 28, *hdr_i)
    assert [n for _, n in seen] == [entropy_gpu.MB_W, entropy_gpu.SLICE_W]
    assert seen[1][0] == (s, r, c + 2, entropy_gpu.MB_W)


def test_entropy_gpu_names_no_plain_merge():
    """The entropy stage names neither K3's plain version nor its pairwise
    step: on the card the slice merge is the kernel."""
    tree = ast.parse(inspect.getsource(entropy_gpu))
    names = {n.id for n in ast.walk(tree) if isinstance(n, ast.Name)}
    names |= {n.attr for n in ast.walk(tree) if isinstance(n, ast.Attribute)}
    names |= {a.name for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)
              for a in n.names}
    assert not names & {"tree_merge", "merge_strings"}
    assert "merge_tree" in names


def test_slice_headers_device_requires_device():
    """The header upload names its device: no silent CPU default."""
    sps = SPS.for_size(64, 48)
    with pytest.raises(TypeError):
        tdp.slice_headers_device(sps, PPS(), 28, 0, True, 2)
    hw, ln = tdp.slice_headers_device(sps, PPS(), 28, 0, True, 2,
                                      device="cpu")
    assert hw.device.type == "cpu" and hw.shape == (2, 3, 4)
    assert ln.shape == (2, 3) and bool((ln > 0).all())
