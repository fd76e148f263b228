"""BASELINE config 1 through the sessions on the CPU: "360p
baseline-profile I-frame-only encode -> decode roundtrip (CAVLC, single
slice, fixed QP)" (BASELINE.json configs[0]).

The port's EncoderSession (device="cpu") and the JAX package's, both
`CodecConfig(width=640, height=360, qp=28, slice_mode="single",
gop_size=1)`, take the same numpy frames of the "meeting" clip for two
frames: the annex-B bytes and the recon are identical, and the port's
DecoderSession returns the recon cropped to 360 rows (the frame is
edge-padded to 368 for the MB grid; the decoder crops by the SPS).  Both
directions go through the single-slice wavefront (on the card: K7 and
K8; here their plain versions).
"""

import numpy as np
import pytest

from tpuh264.engine import CodecConfig as JCfg
from tpuh264.engine import EncoderSession as JEnc
from tpuh264_torch.engine import CodecConfig, DecoderSession, EncoderSession
from tpuh264_torch.engine import sources
from tpuh264_torch.kernels import wavefront

W, H, N_FRAMES = 640, 360, 2
CONFIG1 = dict(width=W, height=H, qp=28, slice_mode="single", gop_size=1)


@pytest.fixture(scope="module")
def runs():
    """Both encoders' frames and the port's recon of each, and the port's
    wavefront plain-version calls (encode, decode) in the port's run."""
    clip = sources.clip_frames(W, H, N_FRAMES, "meeting")
    frames = [[np.asarray(p)[None] for p in f] for f in clip]
    jenc = JEnc(JCfg(**CONFIG1))
    tenc = EncoderSession(CodecConfig(**CONFIG1), device="cpu")
    calls = {"enc": 0, "dec": 0}
    real = (wavefront._encode_iframe_single_plain,
            wavefront._decode_iframe_single_plain)

    def count(key, f):
        def call(*a, **kw):
            calls[key] += 1
            return f(*a, **kw)
        return call

    mp = pytest.MonkeyPatch()
    mp.setattr(wavefront, "_encode_iframe_single_plain", count("enc", real[0]))
    mp.setattr(wavefront, "_decode_iframe_single_plain", count("dec", real[1]))
    try:
        dec = DecoderSession(device="cpu")
        out = []
        for f in frames:
            j, t = jenc.encode_frame_yuv(*f), tenc.encode_frame_yuv(*f)
            recon = [p.numpy() for p in tenc.recon]
            jrecon = [np.asarray(p) for p in jenc.recon]
            out.append((j, t, recon, jrecon, dec.decode(t[0].data)))
    finally:
        mp.undo()
    return out, calls


def test_config1_bytes_and_recon_match_jax(runs):
    """Every frame is an IDR of one slice; bytes, QP, frame number and
    recon equal the JAX session's."""
    out, _ = runs
    for j, t, recon, jrecon, _ in out:
        assert len(j) == len(t) == 1
        assert t[0].is_idr and j[0].is_idr
        assert t[0].data == j[0].data
        assert (t[0].qp, t[0].frame_num) == (j[0].qp, j[0].frame_num)
        for a, b in zip(recon, jrecon):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)


def test_config1_decoder_equals_the_recon(runs):
    """The port's DecoderSession decodes each access unit to the encoder's
    recon, cropped to 640 x 360 (luma) and 320 x 180 (chroma), through
    the wavefront in both directions."""
    out, calls = runs
    for _, _, recon, _, got in out:
        assert got is not None
        assert [g.shape for g in got] == [(H, W), (H // 2, W // 2),
                                          (H // 2, W // 2)]
        assert recon[0].shape == (1, 368, W)  # edge-padded to the MB grid
        for g, r in zip(got, recon):
            np.testing.assert_array_equal(g, r[0, :g.shape[0], :g.shape[1]])
    assert calls == {"enc": N_FRAMES, "dec": N_FRAMES}
