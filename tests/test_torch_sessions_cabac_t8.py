"""The port's CABAC sessions with the 8x8 transform (High profile) against
tpuh264.engine on the CPU, exactly, at the JAX package's anchors
(tests/test_transform8.py: cabac + t8, and with deblock and 2
references), and with Intra_4x4, deblock and CBR from RGBA input.
64x48 x 2 streams, 6 frames across an IDR (the helpers of
tests/test_torch_sessions_cabac.py): identical bytes, recon, QPs and
frame numbers; the port's DecoderSession and DecoderPool.decode_batch on
the fast path, and libavcodec where it loads, equal to the recon; MBs
coded with the 8x8 transform and MBs coded with the 4x4 one in the P
frames."""

import pytest

from test_torch_sessions_cabac import cached, check_bytes, check_decoders

CONFIGS = {
    "t8": dict(qp=28, transform8x8=True, gop_size=4),
    "t8 deblock 2 refs": dict(qp=28, transform8x8=True, deblock=True,
                              num_ref_frames=2, gop_size=4),
    "t8 intra44 deblock CBR RGBA": dict(bitrate=60_000, transform8x8=True,
                                        intra44=True, deblock=True,
                                        gop_size=4),
}
KIND = {"t8 intra44 deblock CBR RGBA": "rgba"}


def run(name):
    return cached(CONFIGS, name, KIND.get(name, "yuv"))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cabac_t8_encoder_bytes_match(name):
    frames, _, _ = run(name)
    check_bytes(frames, CONFIGS[name].get("qp") is None)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cabac_t8_decoders_match_the_recon(name):
    frames, _, pools = run(name)
    check_decoders(frames, pools)
    for pool in pools.values():
        assert pool[0]._pps.transform_8x8_mode_flag == 1
        assert pool[0]._sps.profile_idc == 100


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_cabac_t8_codes_both_transforms(name):
    _, syms, _ = run(name)
    inter = [(s.kind == 1) for s in syms]
    t8 = sum(int(((s.t8 == 1) & m).sum()) for s, m in zip(syms, inter))
    t4 = sum(int(((s.t8 == 0) & m).sum()) for s, m in zip(syms, inter))
    assert t8 > 0 and t4 > 0, (t8, t4)
    assert all(not bool(((s.t8 == 1) & (s.kind != 1)).any()) for s in syms)
