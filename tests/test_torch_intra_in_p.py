"""Port vs JAX reference: the intra-in-P P encode (the default
`CodecConfig`), the deblock of its mixed-kind frames, the GOP pipeline
with `intra_in_p=True`, and that pipeline with `fanout=2` and a
`drop_frames(3)` between dispatches (a decoder DPB four streams wide;
decode stream ss*2+fi carries encoded stream ss).  Exact comparisons
throughout.
"""

import numpy as np
import pytest
import torch

from pipeline_checks import assert_rings_and_sse_match_jax
from tpuh264.engine import CodecConfig as JaxConfig
from tpuh264.engine.devpipe import GOPDevicePipeline as JaxPipe
from tpuh264.engine.devpipe import _deblock_i as jax_deblock_i
from tpuh264.engine.devpipe import _deblock_p as jax_deblock_p
from tpuh264.golden import codec as gcodec
from tpuh264.kernels import iframe as jif
from tpuh264.kernels import pframe as JP
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine.devpipe import GOPDevicePipeline
from tpuh264_torch.kernels import deblock as tdb
from tpuh264_torch.kernels import pframe as TP

S = 2


def _texture(rng, h, w):
    tex = rng.normal(0, 1, (h, w))
    for _ in range(3):
        tex = (tex + np.roll(tex, 1, 0) + np.roll(tex, -1, 0)
               + np.roll(tex, 1, 1) + np.roll(tex, -1, 1)) / 5.0
    return 128 + 90 * tex / np.abs(tex).max()


def _frames(h, w, seed):
    """Three frames per stream [t][plane] -> [S, ...] int32: a textured
    band, static from the second frame on (skips from the newest
    reference), a noisy texture moving a few pels per frame
    (inter) and, in the last frame, a flat patch two MBs wide that no
    reference holds (intra: its right MB is predicted from its left)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    out = [[[], [], []] for _ in range(3)]
    for si in range(S):
        tex = _texture(rng, h + 32, w + 32)
        bands = rng.integers(60, 200, (2, 16, w))
        for t in range(3):
            dy, dx = t * (1 + si), 2 * t
            y = tex[8 + dy:8 + dy + h, 8 + dx:8 + dx + w]
            y = y + rng.normal(0, 1.5, y.shape)
            y[:16] = bands[min(t, 1)]  # static from t = 1 on
            if t == 2:
                y[16:32, 16 * si:16 * si + 32] = 40 + 30 * si
            u = 128 + 30 * np.sin((xx[::2, ::2] + dx + si) / 5.0
                                  + yy[::2, ::2] / 7.0)
            v = 128 + 25 * np.cos((yy[::2, ::2] + dy) / 6.0
                                  + xx[::2, ::2] / 9.0)
            u[:8], v[:8] = 100 + xx[:16:2, ::2] // 8, 150 - yy[:16:2, ::2]
            for p, a in enumerate((y, u, v)):
                out[t][p].append(np.clip(a, 0, 255).astype(np.int32))
    return [[np.stack(p) for p in f] for f in out]


def _i_recon(y, u, v, qp):
    sym, rec = jif.encode_iframe_rows(y, u, v, qp)
    db = jax_deblock_i(rec, sym.mode.shape, qp)
    return [np.asarray(p).astype(np.int32) for p in db]


# each frame size with one reference depth (a JAX compile per pair), at
# both QPs (QP is traced: no compile)
CASES = [(h, w, qp, n) for h, w, n in ((48, 64, 1), (64, 96, 2))
         for qp in (28, 40)]


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{w}x{h}-qp{qp}-n{n}" for h, w, qp, n in CASES])
def encoded(request):
    h, w, qp, n = request.param
    f0, f1, f2 = _frames(h, w, seed=h + qp)
    r1, r0 = _i_recon(*f1, qp), _i_recon(*f0, qp)
    refs = [np.stack([a, b][:n]) for a, b in zip(r1, r0)]  # [N,S,H,W]
    jout = JP.encode_pframe_rows_multi(*f2, *refs, qp, intra_in_p=True)
    tt = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    tout = TP.encode_pframe_rows_multi(*[tt(p) for p in f2],
                                       *[tt(r) for r in refs], qp,
                                       intra_in_p=True)
    return qp, refs, jout, tout


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), b.cpu().numpy(), err_msg=msg)


def test_encode_intra_in_p_matches_jax(encoded):
    _, _, (jsym, jrec, jmot), (tsym, trec, tmot) = encoded
    for name in JP.MBSymbolsP._fields:
        _eq(getattr(jsym, name), getattr(tsym, name), name)
    for a, b in zip(jrec, trec):
        _eq(a, b, "recon")
    for a, b in zip(jmot, tmot):
        _eq(a, b, "motion")
    kinds = set(np.unique(np.asarray(jsym.kind)).tolist())
    assert kinds == {TP.KIND_SKIP, TP.KIND_INTER, TP.KIND_INTRA}, kinds


def test_deblock_mixed_kinds_matches_jax(encoded):
    qp, _, (jsym, jrec, jmot), (tsym, trec, tmot) = encoded
    j = jax_deblock_p(jrec, jsym, jmot, qp)
    t = tdb.deblock_p(trec, tsym, tmot, qp)
    for a, b in zip(j, t):
        _eq(a, b, "deblock")


def test_decode_intra_in_p_matches_encoder(encoded):
    """The port's P decoder rebuilds the mixed-kind frame from its
    symbols exactly as the encoder reconstructed it."""
    qp, refs, _, (tsym, trec, tmot) = encoded
    dec, dmot = TP.decode_pframe_rows_multi(
        tsym, *[torch.from_numpy(r) for r in refs], qp)
    for a, b in zip(dec, trec):
        assert torch.equal(a, b)
    for a, b in zip(dmot, tmot):
        assert torch.equal(a, b)


CFG = dict(width=64, height=48, streams=S, intra_in_p=True)
MODES = {"qp28": dict(qp=28), "cbr": dict(qp=None, bitrate=200_000)}
# the smooth "moving_gradient" codes no intra MB; on "noise" intra wins
SOURCE = "noise"


def _intra_counts(pipe):
    """Spy on the port pipeline's encode: the number of KIND_INTRA MBs in
    each dispatch's P frames, appended to the returned list."""
    counts = []
    enc = pipe._encode

    def spy(*a, **kw):
        out = enc(*a, **kw)
        counts.append(int((out[1].kind == TP.KIND_INTRA).sum()))
        return out

    pipe._encode = spy
    return counts


def _drive(pipe, n):
    qps = []
    for _ in range(n):
        qps.append(pipe.config.qp if pipe.config.qp is not None
                   else pipe.rc.current_qp())
        pipe.pump_frame()
    return qps


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request):
    kw = dict(CFG, **MODES[request.param])
    jax_pipe = JaxPipe(JaxConfig(**kw), gop_size=8, source_kind=SOURCE)
    port = GOPDevicePipeline(CodecConfig(**kw), gop_size=8,
                             source_kind=SOURCE, device="cpu")
    intra = _intra_counts(port)
    return (request.param, jax_pipe, port, _drive(jax_pipe, 3),
            _drive(port, 3), intra)


def test_pipeline_intra_in_p_matches_jax(runs):
    mode, jax_pipe, port, jq, pq, intra = runs
    assert pq == jq
    assert len(intra) == 3 and all(intra), intra  # intra MBs were coded
    assert len(port.frame_streams) == 12
    for si in range(S):
        assert port.stream_bytes(si) == jax_pipe.stream_bytes(si), si
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)
    assert port.fallback_packs == jax_pipe.fallback_packs == 0
    assert abs(port.last_psnr_y - jax_pipe.last_psnr_y) < 1e-3


def test_pipeline_intra_in_p_golden_decode(runs):
    _, _, port, _, _, _ = runs
    dec = port.decoded_planes()
    for d, e in zip(dec, port.encoder_planes()):
        np.testing.assert_array_equal(d, e)
    for si in range(S):
        ours = gcodec.decode_annexb_seq(port.stream_bytes(si))
        assert len(ours) == 12
        for p in range(3):
            np.testing.assert_array_equal(ours[-1][p], dec[p][si])


def test_default_config_runs():
    """`CodecConfig()`'s defaults (intra-in-P, CBR) build and run."""
    assert CodecConfig().intra_in_p
    pipe = GOPDevicePipeline(CodecConfig(width=64, height=48), gop_size=8,
                             device="cpu")
    pipe.pump_frame()
    pipe.pump_frame()
    for d, e in zip(pipe.decoded_planes(), pipe.encoder_planes()):
        np.testing.assert_array_equal(d, e)


# -- fan-out decode --------------------------------------------------------

# the "cbr" configuration above, decoded twice per encoded stream: the
# JAX encode steps are the same programs (compiled once per process)
FAN_CFG = dict(CFG, **MODES["cbr"])
K = GOPDevicePipeline.FRAMES_PER_DISPATCH


def _drive_fan(pipe):
    qps = []
    for d in range(3):
        qps.append(pipe.rc.current_qp())
        pipe.pump_frame()
        if d == 0:
            pipe.drop_frames(3)
    return qps


@pytest.fixture(scope="module")
def fan_runs():
    jax_pipe = JaxPipe(JaxConfig(**FAN_CFG), gop_size=8, source_kind=SOURCE,
                       fanout=2)
    port = GOPDevicePipeline(CodecConfig(**FAN_CFG), gop_size=8,
                             source_kind=SOURCE, fanout=2, device="cpu")
    intra = _intra_counts(port)
    return jax_pipe, port, _drive_fan(jax_pipe), _drive_fan(port), intra


def test_fanout_matches_jax(fan_runs):
    jax_pipe, port, jq, pq, intra = fan_runs
    assert pq == jq
    assert all(intra), intra  # the replicated records carry intra MBs
    for si in range(S):
        assert port.stream_bytes(si) == jax_pipe.stream_bytes(si), si
    jdec, pdec = jax_pipe.decoded_planes(), port.decoded_planes()
    for a, b in zip(jdec, pdec):
        assert b.shape[0] == 2 * S
        np.testing.assert_array_equal(np.asarray(a), b)
    # the decode-side SSE is taken against each decode stream's source
    assert abs(port.last_psnr_y - jax_pipe.last_psnr_y) < 1e-3
    assert port.time_offset == 3


def test_fanout_rings_and_sse_match_jax(fan_runs):
    """Fan-out 2: the decoder ring is S * 2 streams wide; both rings and
    the per-frame SSE (decode stream d against source stream d // 2)
    equal the JAX pipeline's."""
    jax_pipe, port, _, _, _ = fan_runs
    assert_rings_and_sse_match_jax(jax_pipe, port)


def test_fanout_decode_streams_equal_encoder(fan_runs):
    _, port, _, _, _ = fan_runs
    for e, d in zip(port.encoder_planes(), port.decoded_planes()):
        for ss in range(S):
            for fi in range(2):
                np.testing.assert_array_equal(d[ss * 2 + fi], e[ss])


def test_drop_frames_moves_source_clock(fan_runs):
    """After drop_frames(3) the encoder sees frames 7.. of the source:
    stream bytes differ from a run without the drop, from dispatch 1 on,
    and the drop is counted."""
    _, port, _, _, _ = fan_runs
    ref = GOPDevicePipeline(CodecConfig(**FAN_CFG), gop_size=8,
                            source_kind=SOURCE, device="cpu")
    ref.pump_frame()
    ref.pump_frame()
    assert ref.frame_streams[:K] == port.frame_streams[:K]
    assert ref.frame_streams[K:2 * K] != port.frame_streams[K:2 * K]
    assert port.stats.snapshot(S)["dropped_capture"] == 3


def test_load_jax_state_fanout(fan_runs):
    """A fresh fan-out port pipeline takes the JAX one's state (decoder
    DPB S*2 streams wide, the dropped frames' time offset) and both
    continue identically."""
    from tpuh264_torch.state import load_jax_state, rc_state_of

    jax_pipe, _, _, _, _ = fan_runs
    port = GOPDevicePipeline(CodecConfig(**FAN_CFG), gop_size=8,
                             source_kind=SOURCE, fanout=2, device="cpu")
    load_jax_state(
        port, [np.asarray(p) for p in jax_pipe._dpb_enc],
        [np.asarray(p) for p in jax_pipe._dpb_dec], jax_pipe._gop_pos,
        jax_pipe.dispatch_index, rc_state_of(jax_pipe.rc),
        jax_pipe.time_offset)
    assert port.time_offset == 3 and port._dpb_dec[0].shape[1] == 2 * S
    assert _drive_fan(port) == _drive_fan(jax_pipe)
    assert port.frame_streams == jax_pipe.frame_streams[-3 * K:]
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)
