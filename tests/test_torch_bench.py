"""The port's bench package against the JAX package's, on the CPU:
`harness.run_single` for impls "tpu", "tpu_gop" and "libav" at 64x48
(device="cpu") returns the JAX result's keys and a sane row;
`render_table` and `render_charts` (a copy) turn the same results into
the same text and SVG files as JAX's; `machine_info` names no card where
there is none; and tests/test_quality.py's three cases on the port's
`quality` (libx264 / libavcodec on the host, our encoder on the CPU),
under the same skip."""

import pytest
import torch

from tpuh264.bench import charts as jcharts, harness as jh
from tpuh264.engine import CodecConfig as JConfig
from tpuh264_torch.bench import charts as tcharts, harness as th, quality
from tpuh264_torch.conformance import libav_available
from tpuh264_torch.conformance.ffenc import encoder_available
from tpuh264_torch.engine import CodecConfig

CFG = dict(width=64, height=48, streams=2, qp=30)
IMPLS = ["tpu", "tpu_gop", "libav"]
needs_x264 = pytest.mark.skipif(
    not (libav_available() and encoder_available()),
    reason="libavcodec/libx264 unavailable",
)


@pytest.fixture(scope="module")
def results():
    """One short run of each impl in each package (libav needs libx264)."""
    out = {}
    for impl in IMPLS:
        if impl == "libav" and not encoder_available():
            continue
        kw = dict(duration_s=0.3, warmup_frames=1, max_frames=2, impl=impl)
        out[impl] = (jh.run_single(JConfig(**CFG), **kw),
                     th.run_single(CodecConfig(**CFG), device="cpu", **kw))
    return out


@pytest.mark.parametrize("impl", IMPLS)
def test_run_single_has_the_jax_fields(results, impl):
    if impl not in results:
        pytest.skip("libx264 unavailable")
    j, t = results[impl]
    assert set(t) == set(j)
    assert set(t["config"]) == set(j["config"])
    assert t["config"]["impl"] == impl and t["config"]["streams"] == 2
    assert t["frames"] > 0 and t["pipeline_fps"] > 0
    assert t["frames_per_s_aggregate"] > 0 and t["bitrate_bps"] > 0
    assert 20 < t["psnr_y"] <= 99


def test_render_table_matches_jax(results):
    rows = [t for _, t in results.values()]
    text = th.render_table(rows)
    assert text == jh.render_table(rows)
    lines = text.splitlines()
    assert len(lines) == 1 + len(rows) and "agg fps" in lines[0]


def test_render_charts_match_jax(results, tmp_path):
    rows = [t for _, t in results.values()]
    # a second resolution, so the charts draw lines and not only points
    rows += [dict(r, config=dict(r["config"], res="480p")) for r in rows]
    tpaths = tcharts.render_charts(rows, str(tmp_path / "t"))
    jpaths = jcharts.render_charts(rows, str(tmp_path / "j"))
    assert len(tpaths) == len(jpaths) > 0
    for a, b in zip(tpaths, jpaths):
        assert open(a).read() == open(b).read()


def test_machine_info_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    info = th.machine_info()
    assert info["backend"] == "none" and info["cpus"] > 0


@needs_x264
def test_rd_points_monotone():
    frames = quality.make_sequence(64, 48, 4)
    lo = quality.our_rd_point(frames, qp=20, gop=4, device="cpu")
    hi = quality.our_rd_point(frames, qp=40, gop=4, device="cpu")
    assert lo["bits_per_s"] > hi["bits_per_s"]
    assert lo["psnr"] > hi["psnr"]
    assert lo["psnr"] > 35


@needs_x264
def test_x264_anchor_decodes():
    frames = quality.make_sequence(64, 48, 4)
    x = quality.x264_rd_point(frames, 400_000)
    assert x["bytes"] > 0 and 20 < x["psnr"] < 99


@needs_x264
def test_rd_floor_vs_x264_mid_rate():
    """Quality floor vs the external anchor, as tests/test_quality.py: at
    the mid-rate point our PSNR is within 2 dB of x264 (veryfast) at
    matched bitrate."""
    frames = quality.make_sequence(320, 192, 6)
    x = quality.x264_rd_point(frames, 500_000)
    ours = [quality.our_rd_point(frames, qp, gop=6, device="cpu")
            for qp in (24, 26, 28)]
    best = min(ours, key=lambda o: abs(o["bits_per_s"] - x["bits_per_s"]))
    rate_ratio = best["bits_per_s"] / x["bits_per_s"]
    assert 0.6 < rate_ratio < 1.4, f"no comparable rate point: {rate_ratio}"
    assert best["psnr"] >= x["psnr"] - 2.0, (
        f"PSNR floor broken: ours {best['psnr']:.2f} dB at "
        f"{best['bits_per_s']/1e3:.0f} kbps vs x264 {x['psnr']:.2f} dB at "
        f"{x['bits_per_s']/1e3:.0f} kbps"
    )
