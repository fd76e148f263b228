"""K2 / K3 plain versions and the device CAVLC stage against the JAX
reference: the Pallas kernel bodies (interpret form), the XLA
formulation (block_slots + pack_slots, tree_merge), and the full I / P
slice payloads.  Exact comparisons; lanes whose string exceeds its word
budget have unspecified words in every version (their dispatch is
flagged and repacked on the host), so words are compared where the
bit length fits and bit lengths everywhere.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from tpuh264.core.params import PPS, SPS
from tpuh264.entropy import device_pack as jdp
from tpuh264.entropy.device_pack import SLICE_P
from tpuh264.kernels import cavlc_pallas, entropy_tpu
from tpuh264.kernels import iframe as jif
from tpuh264.kernels import pframe as JP
from tpuh264_torch.entropy import device_pack as tdp
from tpuh264_torch.kernels import cavlc_cuda, entropy_gpu
from tpuh264_torch.kernels import iframe as tif
from tpuh264_torch.kernels import pframe as TP


def _rand_case(rng, n, nh=3, sparse=0.8, amp=6, hdr_bits=10):
    levels = rng.integers(-amp, amp + 1, size=(n, 16)).astype(np.int32)
    levels[rng.random((n, 16)) < sparse] = 0
    maxc = rng.choice((16, 15, 4), size=(n,)).astype(np.int32)
    for i in range(n):
        levels[i, maxc[i]:] = 0
    nc = rng.integers(0, 17, size=(n,)).astype(np.int32)
    nc[maxc == 4] = -1
    hdr_len = rng.integers(0, hdr_bits, size=(n, nh)).astype(np.int32)
    hdr_val = (rng.integers(0, 1 << 20, size=(n, nh))
               & ((1 << hdr_len) - 1)).astype(np.int32)
    return levels, nc, maxc, hdr_len, hdr_val


def _xla_ref(levels, nc, maxc, hl, hv, n_w, gate=None):
    sl, sv, _ = entropy_tpu.block_slots(levels, nc, maxc)
    if gate is not None:
        sl = jnp.where(jnp.asarray(gate)[..., None], sl, 0)
    sl = jnp.concatenate([jnp.asarray(hl), sl], -1)
    sv = jnp.concatenate([jnp.asarray(np.where(hl > 0, hv, 0)), sv], -1)
    return entropy_tpu.pack_slots(sl, sv, n_w)


def _plain(levels, nc, maxc, hl, hv, n_w, gate=None):
    t = torch.from_numpy
    return cavlc_cuda.pack_blocks(
        t(levels), t(nc), t(maxc), t(hl), t(hv), n_w, hl.shape[-1],
        code_residual=None if gate is None else t(gate.astype(np.int32)))


def _eq_words(ref, got, n_w):
    rw, rb = (np.asarray(x) for x in ref)
    gw, gb = (x.numpy() for x in got)
    np.testing.assert_array_equal(rb, gb)
    ok = rb <= 32 * n_w
    np.testing.assert_array_equal(rw[ok], gw[ok])
    return ok


@pytest.mark.parametrize("amp,sparse", [(6, 0.8), (40, 0.5), (2000, 0.6)])
def test_pack_blocks_plain_matches_xla(amp, sparse):
    rng = np.random.default_rng(1234 + amp)
    case = _rand_case(rng, 257, sparse=sparse, amp=amp)
    ok = _eq_words(_xla_ref(*case, 20), _plain(*case, 20), 20)
    assert ok.mean() > 0.5


def test_pack_blocks_plain_matches_pallas_body():
    """Against the Pallas kernel body itself (cavlc_pallas interpret form),
    with escapes, stale header values and the P-frame residual gate."""
    rng = np.random.default_rng(77)
    levels, nc, maxc, hl, hv = _rand_case(rng, 300, nh=2, sparse=0.6,
                                          amp=40, hdr_bits=12)
    hv_stale = hv.copy()
    hv_stale[hl == 0] = 0x1FF  # stale values under dead slots
    gate = rng.random(300) < 0.6
    # a narrow word budget keeps the kernel body's XLA compile short
    ref = cavlc_pallas.pack_blocks(levels, nc, maxc, hl, hv_stale, 6, 2,
                                   hdr_max=16, interpret=True,
                                   code_residual=jnp.asarray(gate))
    got = _plain(levels, nc, maxc, hl, hv_stale, 6, gate)
    assert _eq_words(ref, got, 6).mean() > 0.5


def test_pack_blocks_stale_header_values_dropped():
    rng = np.random.default_rng(7)
    levels, nc, maxc, hl, hv = _rand_case(rng, 64)
    hl[:, 1] = 0
    stale = hv.copy()
    stale[:, 1] = 0x1FF
    ref = _xla_ref(levels, nc, maxc, hl, hv, 20)
    got = _plain(levels, nc, maxc, hl, stale, 20)
    _eq_words(ref, got, 20)


def test_pack_blocks_code_residual_gate_and_multidim_lead():
    rng = np.random.default_rng(21)
    levels, nc, maxc, hl, hv = _rand_case(rng, 2 * 3 * 5, nh=6, hdr_bits=20)
    gate = rng.random(30) < 0.5
    ref = _xla_ref(levels, nc, maxc, hl, hv, 20, gate=gate)
    sh = (2, 3, 5)
    t = torch.from_numpy
    gw, gb = cavlc_cuda.pack_blocks(
        t(levels.reshape(*sh, 16)), t(nc.reshape(sh)), t(maxc.reshape(sh)),
        t(hl.reshape(*sh, 6)), t(hv.reshape(*sh, 6)), 20, 6,
        code_residual=t(gate.reshape(sh).astype(np.int32)))
    _eq_words(ref, (gw.reshape(-1, 20), gb.reshape(-1)), 20)


def _strings(rng, n, k, w, max_bits):
    bits = rng.integers(0, max_bits + 1, size=(n, k)).astype(np.int32)
    raw = rng.integers(0, 1 << 32, size=(n, k, w), dtype=np.uint64)
    t = np.arange(w)
    keep = np.clip(bits[..., None] - 32 * t, 0, 32)  # bits kept per word
    mask = np.where(keep > 0,
                    ((1 << 32) - (1 << (32 - keep).astype(np.uint64))), 0)
    words = (raw & mask.astype(np.uint64)).astype(np.uint32).view(np.int32)
    return words, bits


@pytest.mark.parametrize("n,k,w,n_out,max_bits", [
    (37, 7, 4, 16, 128), (64, 27, 20, 128, 150)])
def test_merge_tree_plain_matches_xla_and_pallas_body(n, k, w, n_out,
                                                      max_bits):
    rng = np.random.default_rng(n + k)
    words, bits = _strings(rng, n, k, w, max_bits)
    got = cavlc_cuda.merge_tree(torch.from_numpy(words),
                                torch.from_numpy(bits), n_out)
    ok = _eq_words(entropy_tpu.tree_merge(jnp.asarray(words),
                                          jnp.asarray(bits), n_out),
                   got, n_out)
    assert ok.all() or n_out == 16
    if k == 7:  # the Pallas body's interpret form: one small case
        _eq_words(cavlc_pallas.merge_tree(words, bits, n_out,
                                          interpret=True), got, n_out)


# ---------------------------------------------------------------------------
# Full slice payloads.
# ---------------------------------------------------------------------------


def _frames(seed, s, h, w):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    y = np.clip(((xx * 5 + yy * 3) % 256)[None]
                + rng.integers(-25, 26, (s, h, w)), 0, 255)
    u = rng.integers(80, 180, (s, h // 2, w // 2))
    v = rng.integers(80, 180, (s, h // 2, w // 2))
    return [a.astype(np.int32) for a in (y, u, v)]


def _torch_sym(cls, sym):
    return cls(*[None if f is None else torch.from_numpy(np.array(f))
                 for f in sym])


@pytest.mark.parametrize("qp", [12, 30])
def test_encode_bits_iframe_matches_jax(qp):
    s, h, w = 2, 48, 64
    y, u, v = _frames(qp, s, h, w)
    sym, _ = jif.encode_iframe_rows(y, u, v, qp)
    sps, pps = SPS.for_size(w, h), PPS()
    jh = jdp.slice_headers_device(sps, pps, qp, 0, True, s, deblock_idc=2)
    th = tdp.slice_headers_device(sps, pps, qp, 0, True, s, deblock_idc=2,
                                  device="cpu")
    np.testing.assert_array_equal(np.asarray(jh[0]), th[0].numpy())
    np.testing.assert_array_equal(np.asarray(jh[1]), th[1].numpy())
    ref = entropy_tpu.encode_bits_iframe(sym, qp, *jh)
    got = entropy_gpu.encode_bits_iframe(_torch_sym(tif.MBSymbols, sym),
                                         qp, *th)
    assert not bool(ref[2]) and not bool(got[2])
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    rw, gw = np.asarray(ref[0]), got[0].numpy()
    nb = np.asarray(ref[1])
    for si in range(s):
        for ri in range(h // 16):
            nw = (int(nb[si, ri]) + 3) // 4
            np.testing.assert_array_equal(rw[si, ri, :nw], gw[si, ri, :nw])


@pytest.mark.parametrize("qp,nra", [(26, 1), (34, 2)])
def test_encode_bits_pframe_matches_jax(qp, nra):
    s, h, w = 2, 48, 64
    (y0, u0, v0), (y1, u1, v1) = _frames(1, s, h, w), _frames(2, s, h, w)
    _, rec = jif.encode_iframe_rows(y0, u0, v0, qp)
    refs = [np.asarray(p).astype(np.int32)[None] for p in rec]
    sym, _, _ = JP.encode_pframe_rows_multi(y1, u1, v1, *refs, qp,
                                            intra_in_p=True)
    if nra > 1:  # exercise ref_idx signalling with some non-zero indices
        rng = np.random.default_rng(qp)
        ri = np.where(np.asarray(sym.kind) == 1,
                      rng.integers(0, nra, sym.kind.shape), 0)
        sym = sym._replace(refidx=jnp.asarray(ri, jnp.int32))
    sps, pps = SPS.for_size(w, h), PPS()
    kw = dict(slice_type=SLICE_P, deblock_idc=2, num_ref_active=nra)
    jh = jdp.slice_headers_device(sps, pps, qp, 1, False, s, **kw)
    th = tdp.slice_headers_device(sps, pps, qp, 1, False, s, **kw,
                                  device="cpu")
    ref = entropy_tpu.encode_bits_pframe(sym, qp, *jh, nra=nra)
    got = entropy_gpu.encode_bits_pframe(_torch_sym(TP.MBSymbolsP, sym),
                                         qp, *th, nra=nra)
    assert not bool(ref[2]) and not bool(got[2])
    np.testing.assert_array_equal(np.asarray(ref[1]), got[1].numpy())
    rw, gw = np.asarray(ref[0]), got[0].numpy()
    nb = np.asarray(ref[1])
    for si in range(s):
        for ri in range(h // 16):
            nw = (int(nb[si, ri]) + 3) // 4
            np.testing.assert_array_equal(rw[si, ri, :nw], gw[si, ri, :nw])

