"""The uint8 DPB rings of the GOP pipeline, K9 writing the P symbols and
K10 reading the record views in place.

The rings' helpers (`devpipe.dpb_refs` / `dpb_advance` / `dpb_fill`) against
the stacks the pipeline pushed before (newest first, `torch.cat`), the
state hand-over into the rings, the plane getters' copies; K9's source on
CPU threads writing MBSymbolsP's fields into `empty_symbols` views, the
mvds included, and K10's source on the GOP decode's strided record views,
each against its plain version.  Exact comparisons throughout.
"""

import os

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264_torch.engine import CodecConfig, devpipe
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import pframe as tpf
from tpuh264_torch.state import load_jax_state, rc_state_of

CSRC = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc")


def _planes(rng, s, h, w):
    return tuple(torch.from_numpy(rng.integers(0, 256, (s, hh, ww))
                                  .astype(np.uint8))
                 for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))


@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_ring_matches_the_pushed_stack(n):
    """After an IDR and six frames, the ring's references newest first
    equal the stack the pipeline used to build (the IDR copied into every
    slot, each frame pushed in front, the oldest dropped), at every step
    and for every prefix nra: the IDR written into slot 0 and `dpb_fill`
    copying it on, each frame written into the slot `dpb_advance` names
    (as the deblock writes it there)."""
    rng = np.random.default_rng(n)
    s, h, w = 2, 32, 48
    ring = tuple(torch.zeros((n, s, hh, ww), dtype=torch.uint8)
                 for hh, ww in ((h, w), (h // 2, w // 2), (h // 2, w // 2)))
    idr = _planes(rng, s, h, w)
    for p, x in zip(ring, idr):
        p[0].copy_(x)
    head = devpipe.dpb_fill(ring)
    stack = tuple(p[None].expand(n, *p.shape).clone() for p in idr)
    for step in range(7):
        for nra in range(1, n + 1):
            refs = devpipe.dpb_refs(ring, head, nra)
            for got, want in zip(refs, stack):
                assert len(got) == nra
                torch.testing.assert_close(torch.stack(got), want[:nra],
                                           rtol=0, atol=0)
        frame = _planes(rng, s, h, w)
        head, slot = devpipe.dpb_advance(ring, head)
        for p, x in zip(slot, frame):
            p.copy_(x)
        stack = tuple(torch.cat([f[None], p[:-1]]) for f, p in
                      zip(frame, stack))


def _pipe(**kw):
    cfg = CodecConfig(width=64, height=48, qp=28, streams=2,
                      intra_in_p=False, **kw)
    return devpipe.GOPDevicePipeline(cfg, gop_size=8, source_kind="noise",
                                     device="cpu")


def test_planes_are_copies_of_the_newest_slot():
    """decoded_planes / encoder_planes are int32 copies of the rings'
    newest slots: what a caller keeps survives the next dispatch's pushes
    into the same memory."""
    pipe = _pipe()
    pipe.pump_frame()
    dec, enc = pipe.decoded_planes(), pipe.encoder_planes()
    assert all(a.dtype == np.int32 for a in dec + enc)
    kept = [a.copy() for a in dec]
    pipe.pump_frame()
    for a, b in zip(dec, kept):
        np.testing.assert_array_equal(a, b)
    for a, ring in zip(pipe.decoded_planes(), pipe._dpb_dec):
        assert ring.dtype == torch.uint8
        np.testing.assert_array_equal(a, ring[pipe._head_dec].numpy())


def test_state_hand_over_fills_the_rings_and_checks_the_range():
    """load_jax_state casts int32 planes (newest first) into the uint8
    rings, slot i the i-th newest, both heads at slot 0; a value outside
    0..255 raises before any slot changes."""
    pipe = _pipe(num_ref_frames=2)
    rng = np.random.default_rng(3)
    enc = [rng.integers(0, 256, tuple(p.shape)).astype(np.int32)
           for p in pipe._dpb_enc]
    dec = [rng.integers(0, 256, tuple(p.shape)).astype(np.int32)
           for p in pipe._dpb_dec]
    pipe._head_enc = pipe._head_dec = 1
    load_jax_state(pipe, enc, dec, 1, 1, rc_state_of(pipe.rc))
    assert pipe._head_enc == pipe._head_dec == 0
    for got, want in zip(pipe._dpb_enc + pipe._dpb_dec, enc + dec):
        np.testing.assert_array_equal(got.numpy(), want)
    bad = [p.copy() for p in enc]
    bad[1][0, 0, 0, 0] = 256
    before = [p.clone() for p in pipe._dpb_enc + pipe._dpb_dec]
    with pytest.raises(ValueError, match="outside 0..255"):
        load_jax_state(pipe, bad, dec, 1, 1, rc_state_of(pipe.rc))
    for a, b in zip(before, pipe._dpb_enc + pipe._dpb_dec):
        assert torch.equal(a, b)


KERNELS = {
    "k9": ("pframe_enc.cu", "enc_args", "pframe_encode_kernel",
           "(a.S * a.R * a.C + kWarps - 1) / kWarps", "32 * kWarps"),
    "k10": ("pframe_dec.cu", "dec_args", "pframe_decode_kernel",
            "(a.S * a.R * a.C + kWarps - 1) / kWarps", "32 * kWarps"),
}


@pytest.fixture(scope="module")
def cpu_kernels(tmp_path_factory):
    """K9's kernel and K10's, built with g++ against the shims."""
    return {key: cuda_threads.build_entry(
        tmp_path_factory.mktemp(f"{key}_cpu"), CSRC, *spec)
        for key, spec in KERNELS.items()}


# the RTC route's K9 cases (no intra-in-P: K9 writes the symbols there)
K9_SYMBOL_CASES = [c for c in chip_smoke.K9_CASES if not c[6]][::2]


@pytest.mark.parametrize("case", K9_SYMBOL_CASES, ids=str)
def test_k9_writes_the_symbols(cpu_kernels, case):
    """K9 given `empty_symbols` views (offset into a two-frame buffer, as
    a dispatch's) writes kind, refidx, both cbps and the levels there,
    mode, cmode, t8 and luma_dc 0, and the mvds against the left MB's
    vector (the vector itself at column 0), its pair slots left empty:
    together the symbols the plain path assembles."""
    kw = chip_smoke.k9_args(torch, chip_smoke.k9_case(np, *case), "cpu")
    want = tpf._inter_encode_plain(**kw)
    s, r, c = want.kind.shape
    buf = tpf.empty_symbols((2 * s,), r, c, "cpu")
    for x in buf:
        x.fill_(-7)  # what the kernel must overwrite
    out = tpf.MBSymbolsP(*(x[s:] for x in buf))
    args = {k: v for k, v in kw.items() if k != "t8"}
    pairs = torch.zeros(s * r * c, dtype=torch.int64)
    ins, outs, ints = tpf._k9_operands(**args, out=out, pairs=pairs)
    cuda_threads.run_entry(cpu_kernels["k9"], ins, outs, ints,
                           inout=(len(outs) - 1,))
    for f in ("kind", "refidx", "cbp_luma", "cbp_chroma", "luma_ac",
              "chroma_dc", "chroma_ac"):
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      getattr(want, f).numpy(), err_msg=f)
    for f in ("mode", "cmode", "t8", "luma_dc"):
        assert not getattr(out, f).any(), f
    assert (buf.kind[:s] == -7).all()  # the other frame's views untouched
    for mv, mvd in ((want.mvx, out.mvdx), (want.mvy, out.mvdy)):
        left = torch.nn.functional.pad(mv, (1, 0))[..., :-1]
        np.testing.assert_array_equal(mvd.numpy(), (mv - left).numpy())
    assert not pairs.any()


@pytest.mark.parametrize("case", chip_smoke.K10_CASES[::3], ids=str)
def test_k10_reads_the_record_views_in_place(cpu_kernels, case):
    """K10 on the GOP decode's record views (MB fields 9 ints apart, level
    slots 400 int16 apart) takes every field as it lies, no copy, and
    equals its plain version on them."""
    kw = chip_smoke.k10_args(torch, chip_smoke.k10_case(np, *case), "cpu")
    views = chip_smoke.record_views(kw["symbols"], torch)
    kw = dict(kw, symbols=views)
    rec, mv = tpf._inter_decode_plain(**kw)
    args = {k: v for k, v in kw.items() if k != "t8"}
    ins, outs, ints = tpf._k10_operands(**args)
    fields = (views.kind, views.mvdx, views.mvdy, views.refidx,
              views.cbp_luma, views.cbp_chroma, views.luma_ac,
              views.chroma_dc, views.chroma_ac)
    assert [x.data_ptr() for x in ins[:9]] == [x.data_ptr() for x in fields]
    if views.kind.numel() > 1:  # (one MB: any stride reads it)
        assert ints[-9:] == [9] * 6 + [400] * 3
    cuda_threads.run_entry(cpu_kernels["k10"], ins, outs, ints)
    for i, (got, w) in enumerate(zip(outs, (*rec, *mv))):
        np.testing.assert_array_equal(got.numpy(), w.numpy(),
                                      err_msg=f"output {i}")
