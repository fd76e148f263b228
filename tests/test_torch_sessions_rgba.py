"""The port's EncoderSession from RGBA input (`encode_frame`: the colour
conversion on the device, then the session) against tpuh264.engine on the
CPU: identical annex-B bytes, recon, QPs and frame numbers over 6 frames
across an IDR, for every config of tests/test_torch_sessions.py."""

import pytest

from tests.test_torch_sessions import (CONFIGS, H, S, W, check_encoder_runs,
                                       run_session)
from tpuh264.engine import CodecConfig as JCfg
from tpuh264.engine import EncoderSession as JEnc
from tpuh264_torch.engine import CodecConfig, EncoderSession


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_rgba_encoder_bytes_match(name):
    kw = dict(width=W, height=H, streams=S, **CONFIGS[name])
    j = run_session(JEnc(JCfg(**kw)), "rgba")
    t = run_session(EncoderSession(CodecConfig(**kw), device="cpu"), "rgba")
    check_encoder_runs(j, t, CONFIGS[name].get("qp") is None)
