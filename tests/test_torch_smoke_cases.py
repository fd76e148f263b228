"""The golden decode that chip_smoke.py's phase 3 leaves to the CPU.

On the card, phase 3 holds the GPU's bytes and decoder DPB equal to the
CPU's for every case.  Here the CPU's bytes of the same cases (taken
from chip_smoke.py itself) decode in the JAX package's golden decoder to
the port's decoder DPB, which closes the chain GPU == CPU == golden; the
same for phase 3's session cases, to the EncoderSession's recon of every
frame.  Phase 9's own decode of DevicePipeline bytes (`decode_bytes`: native
parse + I scan) is held to the golden decoder and to the encoder's
reconstruction too."""

import numpy as np
import pytest
import torch

import chip_smoke
from tpuh264.golden import codec as gcodec
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine.devpipe import DevicePipeline
from tpuh264_torch.engine.sources import device_source_frames
from tpuh264_torch.kernels import iframe

CASES = chip_smoke.small_cases()


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[c[0] for c in CASES])
def test_phase3_cpu_bytes_decode_in_golden_to_decoder_dpb(case):
    name, kw, pkw, drive, need_intra = CASES[case]
    pipe = chip_smoke.small_pipe(kw, pkw, "cpu")
    spy = chip_smoke.SymbolSpy(pipe, torch)
    chip_smoke.drive_small(pipe, drive)
    kinds, _ = spy.shares()
    assert kinds[2] > 0 or not need_intra, kinds
    dec = pipe.decoded_planes()
    h, w = pipe.config.height, pipe.config.width
    shapes = ((h, w), (h // 2, w // 2), (h // 2, w // 2))
    for si in range(pipe.config.streams):
        frames = gcodec.decode_annexb_seq(pipe.stream_bytes(si))
        assert len(frames) == 12
        for p in range(3):
            np.testing.assert_array_equal(
                frames[-1][p],
                dec[p][si * pipe.fanout][:shapes[p][0], :shapes[p][1]])


def test_phase9_own_decode_of_device_pipeline_bytes():
    pipe = DevicePipeline(CodecConfig(width=60, height=44, qp=30, streams=2),
                          device="cpu")
    pipe.pump_frame()
    pipe.pump_frame()
    src = device_source_frames(pipe.w16, pipe.h16, 4, "moving_gradient",
                               pipe.frame_index - 4, "cpu")
    for f, stream in enumerate(pipe.frame_streams):
        qp, dec = pipe.decode_bytes(stream)
        assert qp == 30
        _, rec = iframe.encode_iframe_rows(*(x[f:f + 1] for x in src), 30)
        gold = gcodec.decode_annexb(stream)
        for p in range(3):
            assert torch.equal(rec[p].to(torch.uint8), dec[p])
            hh, ww = gold[p].shape
            np.testing.assert_array_equal(gold[p], dec[p][0, :hh, :ww])


SESSION_CASES = chip_smoke.session_cases()


@pytest.mark.parametrize("case", range(len(SESSION_CASES)),
                         ids=[c[0] for c in SESSION_CASES])
def test_phase3_session_cpu_bytes_decode_in_golden_to_recon(case):
    name, kw, need_i4 = SESSION_CASES[case]
    data, recon, _, idr = chip_smoke.run_session_case(
        kw, "cpu", chip_smoke.session_frames(6), decode=False)
    assert len(idr) >= 2
    for si in range(2):
        frames = gcodec.decode_annexb_seq(b"".join(d[si] for d in data))
        assert len(frames) == 6
        for t, f in enumerate(frames):
            for p in range(3):
                hh, ww = f[p].shape
                np.testing.assert_array_equal(f[p], recon[t][p][si][:hh, :ww],
                                              err_msg=f"{name} s{si} f{t}")
