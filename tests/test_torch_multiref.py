"""Multi-reference (num_ref_frames 2 and 4) GOP pipeline: the port
against the JAX GOPDevicePipeline, with intra-in-P on (N=2, on the
"noise" source, where intra MBs win) and off (N=4).

64x48 x 2 streams, gop 8, three dispatches (IDR+3P | 4P | IDR+3P: the
dispatch after each IDR signals one active reference, the interior one
N), CBR: identical bytes, decoder planes and QP sequences; some MBs
really pick an older reference; and the port's state moves into a fresh
port pipeline mid-GOP.
"""

import numpy as np
import pytest

from pipeline_checks import assert_rings_and_sse_match_jax
from tpuh264.engine import CodecConfig as JaxConfig
from tpuh264.engine.devpipe import GOPDevicePipeline as JaxPipe
from tpuh264.golden import codec as gcodec
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine.devpipe import GOPDevicePipeline
from tpuh264_torch.kernels import pframe as TP
from tpuh264_torch.state import load_jax_state, rc_state_of

# each depth once, each intra-in-P setting once: every JAX configuration
# costs a compile of its own.  The smooth "moving_gradient" codes no
# intra MB, so the intra-in-P case runs on "noise"
CASES = [(2, True), (4, False)]
SOURCE = {True: "noise", False: "moving_gradient"}


def _cfg(n, iip):
    return dict(width=64, height=48, streams=2, qp=None, bitrate=200_000,
                num_ref_frames=n, intra_in_p=iip)


class _RefIdx:
    """Records the encoder's P symbols' ref indices and MB kinds per
    dispatch."""

    def __init__(self, pipe):
        self.seen, self.kinds = [], []
        enc = pipe._encode

        def spy(*a, **kw):
            out = enc(*a, **kw)
            self.seen.append(out[1].refidx.cpu().numpy())
            self.kinds.append(out[1].kind.cpu().numpy())
            return out

        pipe._encode = spy


def _drive(pipe, n):
    qps = []
    for _ in range(n):
        qps.append(pipe.rc.current_qp())
        pipe.pump_frame()
    return qps


@pytest.fixture(scope="module", params=CASES,
                ids=[f"n{n}-{'iip' if i else 'rtc'}" for n, i in CASES])
def runs(request):
    n, iip = request.param
    jax_pipe = JaxPipe(JaxConfig(**_cfg(n, iip)), gop_size=8,
                       source_kind=SOURCE[iip])
    port = GOPDevicePipeline(CodecConfig(**_cfg(n, iip)), gop_size=8,
                             source_kind=SOURCE[iip], device="cpu")
    spy = _RefIdx(port)
    jq, pq = _drive(jax_pipe, 3), _drive(port, 3)
    return n, iip, jax_pipe, port, jq, pq, spy


def test_multiref_pipeline_matches_jax(runs):
    n, iip, jax_pipe, port, jq, pq, spy = runs
    seen = spy.seen
    assert pq == jq
    assert port.sps.max_num_ref_frames == jax_pipe.sps.max_num_ref_frames == n
    for si in range(2):
        assert port.stream_bytes(si) == jax_pipe.stream_bytes(si), si
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)
    # after an IDR only ref 0 exists; the interior dispatch uses up to n
    assert seen[0].max() == 0 and seen[2].max() == 0
    assert 0 < seen[1].max() < n, "no MB chose an older reference"
    # with intra-in-P, intra MBs are coded in every dispatch's P frames
    intra = [int((k == TP.KIND_INTRA).sum()) for k in spy.kinds]
    assert all(intra) if iip else not any(intra), intra


def test_multiref_rings_and_sse_match_jax(runs):
    """With N references the deblock writes the ring's oldest slot, whose
    reference planes K11 built first, and an IDR fills slot 0 then copies
    it on: every slot of both rings, newest first, and the per-frame SSE
    equal the JAX pipeline's."""
    _, _, jax_pipe, port, _, _, _ = runs
    assert_rings_and_sse_match_jax(jax_pipe, port)


def test_multiref_stream_decodes_to_decoder_dpb(runs):
    _, _, _, port, _, _, _ = runs
    dec = port.decoded_planes()
    for d, e in zip(dec, port.encoder_planes()):
        np.testing.assert_array_equal(d, e)
    ours = gcodec.decode_annexb_seq(port.stream_bytes(1))
    assert len(ours) == 12
    for p in range(3):
        np.testing.assert_array_equal(ours[-1][p], dec[p][1])


def test_load_jax_state_mid_gop_multiref(runs):
    """A fresh port pipeline started from the JAX pipeline's state (N
    references deep in both DPBs) continues exactly as the JAX one."""
    n, iip, jax_pipe, _, _, _, _ = runs
    port = GOPDevicePipeline(CodecConfig(**_cfg(n, iip)), gop_size=8,
                             source_kind=SOURCE[iip], device="cpu")
    # after three dispatches the JAX pipeline is mid-GOP (position 1 of 2)
    load_jax_state(
        port, [np.asarray(p) for p in jax_pipe._dpb_enc],
        [np.asarray(p) for p in jax_pipe._dpb_dec], jax_pipe._gop_pos,
        jax_pipe.dispatch_index, rc_state_of(jax_pipe.rc),
        jax_pipe.time_offset)
    assert port._gop_pos % port.gop_dispatches != 0
    assert port._dpb_enc[0].shape[0] == n
    assert _drive(port, 1) == _drive(jax_pipe, 1)
    assert port.frame_streams == jax_pipe.frame_streams[-4:]
    for a, b in zip(jax_pipe.decoded_planes(), port.decoded_planes()):
        np.testing.assert_array_equal(np.asarray(a), b)
