"""Checks shared by the GOP pipeline's CPU parity tests: the port's uint8
DPB rings (every slot, newest first) and its per-frame decoder SSE
against the JAX pipeline's int32 DPB stacks and float32 SSE."""

import numpy as np

from tpuh264_torch.engine.devpipe import dpb_refs


def assert_rings_and_sse_match_jax(jax_pipe, port):
    """Both rings, read newest first through their heads, equal the JAX
    pipeline's DPB stacks slot for slot; the last dispatch's decode-side
    SSE ([k, S * fanout], K14 once a decoded frame) equals the JAX
    decode program's, whose float32 sums are exact integers here (each
    below 2^24, asserted)."""
    for ring, head, stack in ((port._dpb_enc, port._head_enc,
                               jax_pipe._dpb_enc),
                              (port._dpb_dec, port._head_dec,
                               jax_pipe._dpb_dec)):
        n = ring[0].shape[0]
        assert np.asarray(stack[0]).shape[0] == n
        for got, want in zip(dpb_refs(ring, head, n), stack):
            np.testing.assert_array_equal(
                np.stack([g.numpy() for g in got]).astype(np.int32),
                np.asarray(want))
    want = np.asarray(jax_pipe._sse_dev)
    assert want.max() < 1 << 24
    got = port._sse_dev.numpy()
    assert got.dtype == np.int64 and got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))
