"""The port's `device_pack.assemble_iframe` / `assemble_pframe` against the
JAX package's, on the CPU (K2 and K3 through their plain versions): the
same numpy frames at 64x48 x 2 through each package's I and P encode and
assembler give identical annex-B bytes, libavcodec decodes them to the
encoder's reconstruction, and full-range noise at QP 0 sets the overflow
flag in both -- (None, True), the caller's signal to pack on the host."""

import numpy as np
import pytest
import torch

from tpuh264.core.params import PPS as JPPS, SPS as JSPS
from tpuh264.entropy import device_pack as jdp
from tpuh264.kernels import iframe as JI, pframe as JP
from tpuh264_torch.conformance import decode_with_libav, libav_available
from tpuh264_torch.core.params import PPS, SPS
from tpuh264_torch.engine import sources
from tpuh264_torch.entropy import device_pack as tdp
from tpuh264_torch.kernels import iframe as TI, pframe as TP

S, H, W = 2, 48, 64


def _frames(kind: str, n: int):
    return [[np.stack([sources.yuv_frame(W, H, t + 5 * s, kind)[p]
                       for s in range(S)]) for p in range(3)]
            for t in range(n)]


def _t(planes):
    return [torch.from_numpy(p) for p in planes]


@pytest.mark.parametrize("qp,idc", [(28, 1), (36, 2)])
def test_assemble_matches_jax_and_decodes(qp, idc):
    """I + P ("moving_gradient"), deblocking off (idc 1) and within
    slices (idc 2): the bytes of every stream equal JAX's; libavcodec
    decodes the unfiltered ones to the encoder's recon."""
    f0, f1 = _frames("moving_gradient", 2)
    jsps, tsps = JSPS.for_size(W, H), SPS.for_size(W, H)
    jsym_i, jrec = JI.encode_iframe_rows(*f0, qp)
    tsym_i, trec = TI.encode_iframe_rows(*_t(f0), qp)
    jsi, jovf = jdp.assemble_iframe(jsym_i, jsps, JPPS(), qp)
    tsi, tovf = tdp.assemble_iframe(tsym_i, tsps, PPS(), qp)
    assert not jovf and not tovf and tsi == jsi
    jsym_p, _, _ = JP.encode_pframe_rows(*f1, *jrec, qp)
    tsym_p, trec_p, _ = TP.encode_pframe_rows_multi(
        *_t(f1), *(r[None] for r in trec), qp)
    jsp, jovf = jdp.assemble_pframe(jsym_p, jsps, JPPS(), qp, frame_num=1,
                                    deblock_idc=idc)
    tsp, tovf = tdp.assemble_pframe(tsym_p, tsps, PPS(), qp, frame_num=1,
                                    deblock_idc=idc)
    assert not jovf and not tovf and tsp == jsp
    if not libav_available() or idc != 1:
        return  # idc 2 filters the P frame; the encoder's recon is not
    for s in range(S):
        frames = decode_with_libav(tsi[s] + tsp[s])
        assert len(frames) == 2
        for got, rec in zip(frames, (trec, trec_p)):
            for a, b in zip(got, rec):
                np.testing.assert_array_equal(a, b[s].numpy())


def test_assemble_overflow_at_qp0_noise():
    """QP 0 on full-range noise overflows the device caps: both packages
    return (None, True), and no bits."""
    (f0,) = _frames("noise", 1)
    jsym, _ = JI.encode_iframe_rows(*f0, 0)
    tsym, _ = TI.encode_iframe_rows(*_t(f0), 0)
    assert jdp.assemble_iframe(jsym, JSPS.for_size(W, H), JPPS(), 0) == (
        None, True)
    assert tdp.assemble_iframe(tsym, SPS.for_size(W, H), PPS(), 0) == (
        None, True)
