"""The port's conformance gate (tpuh264_torch.conformance.gate) on the CPU.

`run_gate` at its smallest shape (64x48 x 2, intra-in-P) and
`run_gate_extended` (128x96 x 2, CBR with a scene cut, host ingest,
fan-out 2, every dispatch) pass with either oracle, libavcodec and the
golden decoder, decoding in this process or in worker processes, and
fail with AssertionError when one decoded sample of either side is
altered.  The oracle decodes the bytes the pipeline emitted on this
device: nothing here compares the card's streams with the CPU's."""

import numpy as np
import pytest
import torch

from tpuh264_torch.conformance import ffdec, gate
from tpuh264_torch.engine.devpipe import GOPDevicePipeline

SMALL = ((64, 48, 2, True),)


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread here and in the oracle's worker processes: at
    these sizes threads cost more than they save, most of all beside the
    suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("OMP_NUM_THREADS", "1")
        yield
    torch.set_num_threads(n)


@pytest.fixture(params=["libavcodec", "golden"])
def oracle(request, monkeypatch):
    if request.param == "libavcodec" and not ffdec.libav_available():
        pytest.skip("libavcodec is not installed")
    monkeypatch.setattr(gate, "oracle_name", lambda: request.param)
    return request.param


def test_run_gate_passes(oracle):
    res = gate.run_gate(SMALL, device="cpu", workers=0, verbose=False)
    assert res["oracle"] == oracle
    assert (res["compared"], res["decoded"]) == (2, 16)
    assert res["decoded_mbs"] == 16 * 12
    assert 0 < res["oracle_seconds"] < res["seconds"]


def test_run_gate_extended_passes(oracle):
    # golden in two worker processes, libavcodec in this one
    res = gate.run_gate_extended(device="cpu", verbose=False,
                                 workers=2 if oracle == "golden" else 0)
    assert res["oracle"] == oracle
    # 4 dispatches x 4 decode streams; the oracle decodes each encoded
    # stream once a dispatch, 4 + 8 + 12 + 16 frames
    assert (res["compared"], res["decoded"], res["decoded_mbs"]) == (
        16, 80, 80 * 48)
    assert res["oracle_seconds"] > 0


def test_run_gate_decodes_in_worker_processes(oracle):
    """Two shapes, their four streams decoded by two spawned processes."""
    res = gate.run_gate(SMALL + ((96, 64, 2, False),), device="cpu",
                        workers=2, verbose=False)
    assert (res["oracle"], res["compared"], res["decoded"]) == (
        oracle, 4, 32)


def _run(which):
    if which == "run_gate":
        return gate.run_gate(SMALL, device="cpu", workers=0, verbose=False)
    # one dispatch: its checks run, and fail, before the scene-cut check
    return gate.run_gate_extended(1, device="cpu", workers=0, verbose=False)


@pytest.mark.parametrize("which", ["run_gate", "run_gate_extended"])
def test_gate_fails_on_an_altered_oracle_sample(monkeypatch, which):
    real = gate.decode_oracle

    def altered(stream, name=None):
        frames = real(stream, name)
        y = np.array(frames[-1][0])
        y[3, 5] ^= 1
        return frames[:-1] + [(y, *frames[-1][1:])]

    monkeypatch.setattr(gate, "decode_oracle", altered)
    with pytest.raises(AssertionError, match="1 samples differ"):
        _run(which)


@pytest.mark.parametrize("which", ["run_gate", "run_gate_extended"])
@pytest.mark.parametrize("plane", [0, 2])
def test_gate_fails_on_an_altered_device_sample(monkeypatch, which, plane):
    real = GOPDevicePipeline.decoded_planes

    def altered(self):
        planes = [np.array(p) for p in real(self)]
        planes[plane][-1, 7, 2] += 1  # the last stream: the gate checks it
        return tuple(planes)

    monkeypatch.setattr(GOPDevicePipeline, "decoded_planes", altered)
    with pytest.raises(AssertionError, match="YUV"[plane] + r": device"):
        _run(which)


def test_gate_fails_when_the_oracle_misses_a_frame(monkeypatch):
    real = gate.decode_oracle
    monkeypatch.setattr(gate, "decode_oracle", lambda s, o: real(s, o)[1:])
    with pytest.raises(AssertionError, match="decoded 7 of 8 frames"):
        _run("run_gate")
