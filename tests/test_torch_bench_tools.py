"""The port's measurement entry points (`tpuh264_torch.bench.headline`,
`config3`, `ingest`, `multihost`, `rd`, `live`) on the CPU, at small
sizes: the headline's line carries bench.py's keys with its spread and
device, and a failure of the gate or of either configuration prints
bench.py's error line and exits 1; every entry point raises for a card
that is not there; `rd.rd_table` and `live.render` equal the JAX tools'
(loaded by path: tools/bench_rd.py sets JAX's platform when imported);
config 3's session emits the JAX session's bytes and every frame decodes
through the oracle to the recon; the ingest's decode streams equal the
encoder's recon; the multihost bench is bit-exact in both host layouts
at the smallest mesh."""

import contextlib
import importlib.util
import inspect
import io
import json
import os
import statistics

import numpy as np
import pytest
import torch

from tpuh264.engine import CodecConfig as JCfg
from tpuh264.engine import EncoderSession as JEnc
from tpuh264_torch.bench import config3, headline, ingest, live, multihost, rd
from tpuh264_torch.conformance import libav_available
from tpuh264_torch.conformance.ffenc import encoder_available
from tpuh264_torch.engine import EncoderSession, sources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py's result line (:113-121) and its error line (:129-131)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "gate"}
BENCH_ERROR_KEYS = {"metric", "value", "unit", "vs_baseline", "error"}
# tools/bench_ingest.py's line (:117-127)
INGEST_KEYS = {"metric", "config", "encode_fps", "decode_fps_aggregate",
               "copy_ms_per_frame", "copy_ms_per_dispatch", "psnr_y", "qp"}
SMALL = dict(width=64, height=48, streams=2, qp=None, bitrate=200_000,
             intra_in_p=False)


def load_tool(name):
    """tools/<name>.py as a module, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        f"jax_tool_{name}", os.path.join(REPO, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture
def small_headline(monkeypatch):
    """The headline at 64x48 x 2 and x 1, gop 8, "noise", one dispatch or
    a few a run; the gate passes without running."""
    monkeypatch.setattr(headline, "HEADLINE", (SMALL, 0.3, 0))
    monkeypatch.setattr(headline, "SECONDARY",
                        (dict(SMALL, streams=1), 0.3, 0))
    monkeypatch.setattr(headline, "GOP_SIZE", 8)
    monkeypatch.setattr(headline, "SOURCE_KIND", "noise")
    monkeypatch.setattr(headline, "gate", lambda device: {})


def run_main(capsys, argv=("--device", "cpu")):
    rc = headline.main(list(argv))
    out, err = capsys.readouterr()
    return rc, json.loads(out.strip().splitlines()[-1]), err


def test_headline_line(small_headline, capsys):
    rc, line, err = run_main(capsys)
    assert rc == 0
    assert BENCH_KEYS | {"min", "max", "runs", "frames", "device"} == set(line)
    assert line["metric"] == "encode_decode_fps_1080p_gpu"
    assert line["gate"] == "pass"
    assert len(line["runs"]) == len(line["frames"]) == 3
    assert line["value"] == statistics.median(line["runs"])
    assert line["min"] == min(line["runs"]) and line["max"] == max(
        line["runs"])
    assert line["vs_baseline"] == round(line["value"] / 26.7, 3)
    assert all(f > 0 for f in line["frames"])
    assert line["device"] == {"name": "cpu", "power_limit": None}
    # the stage lines say what the enqueue-time stages time
    assert err.count("host enqueue of the encode (ms_enc_dispatch) ") == 2
    assert "host enqueue of the decode (ms_dec_dispatch)" in err
    assert "ref-config 48p x 1 x 0.2Mbps:" in err


def test_headline_measure_repeats_on_one_pipeline(small_headline):
    runs = headline.measure(headline.CodecConfig(**SMALL), 0.01, 0, 2,
                            device="cpu")
    assert len(runs) == 2
    for r in runs:
        # one dispatch a window: run() times no stage
        assert set(r) == {"frames_per_s_aggregate", "frames", "psnr_y",
                          "qp", "stream_bytes"}
        assert r["frames"] == 8
    s = headline.summary(runs)
    assert s["value"] == statistics.median(s["runs"])
    assert "(ms_parse) -" in headline.stage_line("x", runs)


def test_gate_failure_exits_1(small_headline, monkeypatch, capsys):
    def failing(device):
        raise AssertionError("gate 64x48 stream 0 Y: device decode != oracle")

    monkeypatch.setattr(headline, "gate", failing)
    monkeypatch.setattr(headline, "measure", lambda *a, **k: pytest.fail(
        "measured after a failed gate"))
    rc, line, err = run_main(capsys)
    assert rc == 1
    assert set(line) == BENCH_ERROR_KEYS and line["value"] == 0.0
    assert "device decode != oracle" in line["error"]
    assert "Traceback" in err


def test_secondary_failure_exits_1(small_headline, monkeypatch, capsys):
    calls = []
    real = headline.measure

    def second_fails(*a, **kw):
        calls.append(1)
        if len(calls) == 2:
            raise RuntimeError("480p run failed")
        return real(*a, **kw)

    monkeypatch.setattr(headline, "measure", second_fails)
    rc, line, _ = run_main(capsys)
    assert rc == 1 and len(calls) == 2
    assert set(line) == BENCH_ERROR_KEYS
    assert line["error"] == "RuntimeError: 480p run failed"


def test_check_decode_catches_a_differing_dpb():
    pipe = headline.GOPDevicePipeline(headline.CodecConfig(**SMALL),
                                      gop_size=8, source_kind="noise",
                                      device="cpu")
    pipe.pump_frame()
    headline.check_decode(pipe)
    pipe._dpb_dec[1][pipe._head_dec, 1, 3, 5] += 1  # the newest frame
    with pytest.raises(AssertionError, match="U: decoder DPB"):
        headline.check_decode(pipe)


def test_entry_points_need_the_card(monkeypatch, capsys):
    """device="cuda" (the default) without a card raises, and the
    headline exits 1 with its error line."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fn in (headline.run, headline.measure, headline.gate,
               config3.measure_session, config3.flagship_multiref,
               ingest.make_pipeline, multihost.measure, multihost.run_layout,
               rd.rd_table):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    cfg = headline.CodecConfig(**SMALL)
    makers = [lambda: headline.run(),
              lambda: headline.measure(cfg, 0.01, 0, 1),
              lambda: config3.measure_session(64, 48, 2),
              lambda: config3.flagship_multiref(64, 48, 0.01),
              lambda: ingest.make_pipeline(64, 48, 2),
              lambda: multihost.measure((1, 2), 1, 128, 64),
              lambda: rd.main([]), lambda: live.main(["--seconds", "0"])]
    for make in makers:
        with pytest.raises(RuntimeError, match="is_available"):
            make()
    rc, line, _ = run_main(capsys, ())
    assert rc == 1 and "is_available" in line["error"]


def test_rd_requires_both_libraries(monkeypatch):
    monkeypatch.setattr(rd, "encoder_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs libx264 on this host"):
        rd.require_libraries()
    monkeypatch.setattr(rd, "libav_available", lambda: False)
    with pytest.raises(RuntimeError, match="libx264 and libavcodec"):
        rd.main(["--device", "cpu"])


def test_rd_table_matches_jax(tmp_path):
    if not (libav_available() and encoder_available()):
        pytest.skip("libavcodec/libx264 unavailable")
    jrd = load_tool("bench_rd")
    clip = rd.clips(4, "64x48", None, str(tmp_path))[0]
    assert clip[0] == "meeting.y4m"
    outs = []
    for table in (lambda *a: rd.rd_table(*a, device="cpu"), jrd.rd_table):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rows = table(clip[0], clip[1], (18, 22), (100_000,))
        outs.append((buf.getvalue(), rows))
    assert outs[0] == outs[1]
    assert len(outs[0][1]) == 1  # the anchor has a rate-matched point
    assert "| 18 |" in outs[0][0]


def test_live_render_matches_jax():
    jlive = load_tool("live")
    assert [r[:2] for r in live.ROWS] == [r[:2] for r in jlive.ROWS]
    cases = [
        {},
        {"impl": "tpu_gop", "resolution": "480p", "streams": 8,
         "threads": 4, "input_fps": 30.0, "output_fps": 29.6,
         "avg_encode_ms": 12.345, "avg_copy_ms": 0.5,
         "total_decode_ms": 250.0, "avg_decode_ms": 3.21,
         "bitrate_bps": 998_765.0, "psnr_y": 38.123,
         "dropped_capture": 7},
        {"impl": "tpu", "input_fps": None, "psnr_y": "n/a",
         "bitrate_bps": 0},
    ]
    for stats in cases:
        assert live.render(stats) == jlive.render(stats)
    table = live.captured_table(cases[1:2])
    assert table.splitlines()[0] == "captured ticks:"
    assert table.splitlines()[2].split() == [
        "0", "30.0", "29.6", "12.35", "3.21", "999", "38.12"]


def test_config3_session_bytes_equal_jax():
    """Config 3's session (CABAC, 8x8, 2 refs, CBR, intra-in-P) at 64x48
    emits the JAX session's bytes frame by frame."""
    n = 4
    src = config3.source(64, 48, n)
    cfg = config3.session_config(64, 48, n)
    ours = list(config3.encode_frames(EncoderSession(cfg, device="cpu"),
                                      src))
    jcfg = JCfg(**{f: getattr(cfg, f) for f in (
        "width", "height", "qp", "bitrate", "cabac", "transform8x8",
        "num_ref_frames", "gop_size", "intra_in_p")})
    jenc = JEnc(jcfg)
    for t, (planes, got) in enumerate(zip(src, ours)):
        want = jenc.encode_frame_yuv(*planes)[0]
        assert got["au"] == want.data, f"frame {t}"
        assert set(got["timings"]) == {"copy_ms", "encode_ms", "entropy_ms"}


def test_config3_measure_session_decodes_every_frame():
    line = config3.measure_session(64, 48, 3, device="cpu")
    assert line["metric"] == "config3_session_encode"
    assert line["oracle"] in ("libavcodec", "golden")
    assert line["fps"] > 0 and 20 < line["psnr_y"] <= 99
    assert line["ms_entropy"] > 0 and line["kbps@30fps"] > 0
    assert line["device"]["name"] == "cpu"


def test_config3_check_decoded_refuses():
    rec = [[np.zeros((4, 4), np.uint8)] * 3]
    with pytest.raises(AssertionError, match="decoded 0 of 1"):
        config3.check_decoded([], rec)
    bad = [[np.ones((4, 4), np.int32)] * 3]
    with pytest.raises(AssertionError, match="frame 0"):
        config3.check_decoded(bad, rec)


def test_flagship_multiref_line():
    line = config3.flagship_multiref(64, 48, 0.01, device="cpu")
    assert line["metric"] == "flagship_multiref_cbr"
    assert line["frames"] > 0 and line["agg_fps"] > 0


def test_ingest_decode_equals_recon():
    pipe = ingest.make_pipeline(64, 48, fanout=2, device="cpu")
    line = ingest.measure(pipe, seconds=0.0, warmup=1)
    assert INGEST_KEYS | {"frames", "device"} == set(line)
    assert line["qp"] == 32 and line["frames"] == 4
    assert line["config"] == "64x48 x1 enc -> x2 dec"
    dec, enc = pipe.decoded_planes(), pipe.encoder_planes()
    for d, e in zip(dec, enc):
        assert d.shape[0] == 2
        assert np.array_equal(d[0], e[0]) and np.array_equal(d[1], e[0])
    # the source clock went on past the warm-up: 2 dispatches encoded
    assert pipe.dispatch_index == 2
    want = np.stack([sources.yuv_frame(64, 48, 7)[0]])
    got = ingest.host_batch(pipe, 4)[0][-1]
    assert np.array_equal(got, want)


def test_multihost_bitexact_in_both_layouts():
    line = multihost.measure((1, 2), reps=1, width=128, height=64,
                             device="cpu", timeout_s=240)
    assert line["bitexact"] and line["ranks"] == 2
    assert line["backend"] == "gloo"
    assert line["p_step_ms_1host"] > 0 and line["p_step_ms_2host"] > 0
    assert line["efficiency"] == round(
        line["p_step_ms_1host"] / line["p_step_ms_2host"], 3)


def test_multihost_guards():
    multihost.check_efficiency({"efficiency": 1.0})
    with pytest.raises(AssertionError, match="> 1.05"):
        multihost.check_efficiency({"efficiency": 1.2})
    with pytest.raises(ValueError, match="even world"):
        multihost.measure((1, 3), device="cpu")
