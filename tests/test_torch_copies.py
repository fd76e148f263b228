"""The port's copies of the JAX package's JAX-free layers equal their
originals: parameter-set, slice-header and NAL bytes over a grid of
sizes, QPs, frame numbers and active references; every table; the motion
rate terms over their ranges.  And nothing of the port, nor
chip_smoke.py, imports the JAX package."""

import ast
import itertools
import os
import re

import numpy as np
import pytest
import torch

from tpuh264.core import bitstream as j_bs
from tpuh264.core import nal as j_nal
from tpuh264.core import params as j_params
from tpuh264.core import sliceheader as j_sh
from tpuh264.entropy import cavlc_tables as j_tbl
from tpuh264.golden import deblock as j_deblock
from tpuh264.golden import inter as j_inter
from tpuh264.golden import transform as j_transform
from tpuh264_torch.core import bitstream as t_bs
from tpuh264_torch.core import nal as t_nal
from tpuh264_torch.core import params as t_params
from tpuh264_torch.core import sliceheader as t_sh
from tpuh264_torch.entropy import cavlc_tables as t_tbl
from tpuh264_torch.golden import deblock as t_deblock
from tpuh264_torch.golden import inter as t_inter
from tpuh264_torch.golden import transform as t_transform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIZES = [(64, 48), (60, 44), (854, 480), (1280, 720), (1920, 1080),
         (3840, 2160), (176, 144)]


def _ps_bytes(mod_params, mod_bs, w, h, nrf, profile):
    sps = mod_params.SPS.for_size(w, h, profile_idc=profile)
    sps.max_num_ref_frames = nrf
    out = []
    for obj in (sps, mod_params.PPS()):
        wr = mod_bs.BitWriter()
        obj.write(wr)
        out.append(wr.get_bytes())
    return sps, out


@pytest.mark.parametrize("w,h", SIZES)
def test_parameter_sets_match(w, h):
    for nrf, profile in itertools.product((1, 2, 4), (66, 77, 100)):
        js, jb = _ps_bytes(j_params, j_bs, w, h, nrf, profile)
        ts, tb = _ps_bytes(t_params, t_bs, w, h, nrf, profile)
        assert tb == jb
        assert (ts.mb_width, ts.mb_height, ts.width, ts.height) == (
            js.mb_width, js.mb_height, js.width, js.height)
        # each package parses the other's bytes to the same fields
        assert vars(t_params.SPS.parse(t_bs.BitReader(jb[0]))) == vars(
            j_params.SPS.parse(j_bs.BitReader(tb[0])))
        assert vars(t_params.PPS.parse(t_bs.BitReader(jb[1]))) == vars(
            j_params.PPS.parse(j_bs.BitReader(tb[1])))


@pytest.mark.parametrize("w,h", SIZES)
def test_param_sets_frame_the_originals_parameter_sets(w, h):
    """The port's param_sets: the original SPS and PPS, each framed as the
    JAX package frames them (start code, nal_ref_idc 3, escaped)."""
    for nrf in (1, 2, 4):
        js, jb = _ps_bytes(j_params, j_bs, w, h, nrf, 66)
        ts, _ = _ps_bytes(t_params, t_bs, w, h, nrf, 66)
        assert t_params.param_sets(ts, t_params.PPS()) == (
            j_nal.wrap_nal(j_nal.NAL_SPS, jb[0])
            + j_nal.wrap_nal(j_nal.NAL_PPS, jb[1]))


def _slice_bytes(m_params, m_bs, m_sh, w, h, qp, fn, nra, idr, ref, idc):
    sps = m_params.SPS.for_size(w, h)
    sps.max_num_ref_frames = max(nra, 1)
    pps = m_params.PPS()
    out = []
    for first in (0, sps.mb_width * (sps.mb_height - 1)):
        wr = m_bs.BitWriter()
        m_sh.SliceHeader(
            first_mb_in_slice=first,
            slice_type=m_sh.SLICE_I if idr else m_sh.SLICE_P,
            frame_num=fn % (1 << (sps.log2_max_frame_num_minus4 + 4)),
            slice_qp_delta=qp - 26 - pps.pic_init_qp_minus26,
            disable_deblocking_filter_idc=idc,
            num_ref_idx_l0_active_minus1=nra - 1,
        ).write(wr, sps, pps, idr, ref=ref)
        out.append((wr.bit_length, wr))
        wr.rbsp_trailing_bits()
    return [(n, wr.get_bytes()) for n, wr in out]


@pytest.mark.parametrize("w,h", [(64, 48), (854, 480), (1920, 1080)])
def test_slice_headers_match(w, h):
    for qp, fn, nra, idr, ref, idc in itertools.product(
            (0, 12, 28, 40, 51), (0, 1, 7, 255, 256), (1, 2, 3, 4),
            (True, False), (True, False), (1, 2)):
        if idr and (nra > 1 or not ref):
            continue
        assert _slice_bytes(t_params, t_bs, t_sh, w, h, qp, fn, nra, idr,
                            ref, idc) == _slice_bytes(
            j_params, j_bs, j_sh, w, h, qp, fn, nra, idr, ref, idc)


def test_bit_writer_reader_match():
    rng = np.random.default_rng(0)
    ops = [(int(k), int(v)) for k, v in zip(rng.integers(0, 3, 400),
                                            rng.integers(0, 1 << 20, 400))]
    bufs = []
    for mod in (j_bs, t_bs):
        wr = mod.BitWriter()
        for kind, v in ops:
            if kind == 0:
                wr.u(21, v)
            elif kind == 1:
                wr.ue(v)
            else:
                wr.se(v - (1 << 19))
        wr.rbsp_trailing_bits()
        bufs.append(wr.get_bytes())
    assert bufs[0] == bufs[1]
    rd = [mod.BitReader(bufs[0]) for mod in (j_bs, t_bs)]
    for kind, _ in ops:
        f = ("u", "ue", "se")[kind]
        args = (21,) if kind == 0 else ()
        assert getattr(rd[0], f)(*args) == getattr(rd[1], f)(*args)
    assert rd[0].more_rbsp_data() == rd[1].more_rbsp_data()


def test_nal_framing_match():
    rng = np.random.default_rng(1)
    for n in (0, 1, 5, 100, 5000):
        # zero runs force emulation prevention bytes
        raw = rng.integers(0, 4, n).astype(np.uint8)
        raw[rng.random(n) < 0.5] = 0
        rbsp = raw.tobytes()
        assert t_nal.escape_rbsp(rbsp) == j_nal.escape_rbsp(rbsp)
        esc = j_nal.escape_rbsp(rbsp)
        assert t_nal.unescape_rbsp(esc) == j_nal.unescape_rbsp(esc) == rbsp
        for ntype in (t_nal.NAL_SPS, t_nal.NAL_SLICE_IDR,
                      t_nal.NAL_SLICE_NON_IDR):
            for idc in (0, 2, 3):
                assert t_nal.wrap_nal(ntype, rbsp, idc) == j_nal.wrap_nal(
                    ntype, rbsp, idc)
    stream = b"".join(j_nal.wrap_nal(t, rng.integers(0, 3, n).astype(
        np.uint8).tobytes()) for t, n in ((7, 9), (8, 5), (5, 6000),
                                          (1, 300)))
    assert list(t_nal.split_annexb(stream)) == list(
        j_nal.split_annexb(stream))
    for name in ("NAL_SLICE_NON_IDR", "NAL_SLICE_IDR", "NAL_SEI", "NAL_SPS",
                 "NAL_PPS", "NAL_AUD", "START_CODE"):
        assert getattr(t_nal, name) == getattr(j_nal, name)


def test_tables_match():
    for name in ("coeff_token_dense", "total_zeros_dense",
                 "run_before_dense"):
        np.testing.assert_array_equal(getattr(t_tbl, name)(),
                                      getattr(j_tbl, name)())
    for name in dir(j_tbl):
        if name.isupper():
            a, b = getattr(t_tbl, name), getattr(j_tbl, name)
            if isinstance(b, np.ndarray):
                np.testing.assert_array_equal(a, b)
            else:
                assert a == b, name
    for mod_t, mod_j, names in (
            (t_transform, j_transform,
             ("MF_TABLE", "V_TABLE", "CHROMA_QP_TABLE", "ZIGZAG4")),
            (t_deblock, j_deblock, ("ALPHA", "BETA", "TC0"))):
        for name in names:
            a, b = getattr(mod_t, name), getattr(mod_j, name)
            assert a.dtype == b.dtype, name
            np.testing.assert_array_equal(a, b)
    for name in ("SEARCH_RANGE", "REFINE_RANGE", "SEARCH_PAD",
                 "REF_COHERENCE_BITS", "LAMBDA_ME", "QPEL_TBL",
                 "OFFSETS_HALF", "OFFSETS_QUARTER"):
        assert getattr(t_inter, name) == getattr(j_inter, name), name


def test_rate_terms_match():
    for vx in range(-600, 601, 7):
        for vy in range(-300, 301, 13):
            assert t_inter.mv_rate_bits(vx, vy) == j_inter.mv_rate_bits(vx,
                                                                        vy)
    for nra in range(0, 17):
        for ri in range(0, max(nra, 1)):
            assert t_inter.ref_idx_bits(ri, nra) == j_inter.ref_idx_bits(
                ri, nra)


def _imported_modules(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_import_nothing_of_the_jax_package():
    """An ast scan of chip_smoke.py and of every module of the port (the
    distribution layer and the bench among them): no `import tpuh264...` /
    `from tpuh264... import`, and no jax."""
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "tpuh264_torch")):
        paths += [os.path.join(root, f) for f in files if f.endswith(".py")]
    assert len(paths) > 20
    rel = {os.path.relpath(p, REPO) for p in paths}
    for sub in ("dist/__init__", "dist/collectives", "dist/mesh",
                "dist/multihost", "bench/__init__", "bench/harness",
                "bench/quality", "bench/charts", "entropy/device_pack"):
        assert f"tpuh264_torch/{sub}.py" in rel
    for p in paths:
        for m in _imported_modules(p):
            top = m.split(".")[0]
            assert top not in ("tpuh264", "jax", "jaxlib"), (p, m)


def test_pipelines_default_to_the_card(monkeypatch):
    """Without `device`, GOPDevicePipeline, DevicePipeline, App, the session
    Pipeline, DecoderSession, DecoderPool, the conformance gate, the mesh,
    the bench harness and the RD measurement take the card; where there is
    none they raise instead of running on the CPU."""
    import inspect

    from tpuh264_torch.bench import harness, quality
    from tpuh264_torch.dist import mesh

    from tpuh264_torch.conformance import gate
    from tpuh264_torch.engine import (CodecConfig, DecoderPool,
                                      DecoderSession, Pipeline)
    from tpuh264_torch.engine.app import App
    from tpuh264_torch.engine.devpipe import DevicePipeline, GOPDevicePipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = CodecConfig(width=64, height=48, streams=1, qp=28)
    makers = {GOPDevicePipeline: lambda **kw: GOPDevicePipeline(cfg, **kw),
              DevicePipeline: lambda **kw: DevicePipeline(cfg, **kw),
              App: lambda **kw: App(cfg, **kw),
              Pipeline: lambda **kw: Pipeline(cfg, **kw),
              DecoderSession: lambda **kw: DecoderSession(**kw),
              DecoderPool: lambda **kw: DecoderPool(4, **kw),
              gate.run_gate: lambda **kw: gate.run_gate(
                  ((64, 48, 1, False),), verbose=False, **kw),
              gate.run_gate_extended: lambda **kw: gate.run_gate_extended(
                  verbose=False, **kw),
              mesh.make_codec_mesh: lambda **kw: mesh.make_codec_mesh(
                  1, 1, **kw),
              harness.run_single: lambda **kw: harness.run_single(
                  cfg, impl="tpu_gop", **kw),
              harness.run_matrix: lambda **kw: harness.run_matrix(
                  ("360p",), (1,), **kw),
              quality.our_rd_point: lambda **kw: quality.our_rd_point(
                  [(np.zeros((48, 64), np.uint8),)], 30, **kw)}
    for fn, make in makers.items():
        assert inspect.signature(fn).parameters["device"].default == "cuda"
        with pytest.raises(RuntimeError, match="is_available"):
            make()
        with pytest.raises(RuntimeError, match="is_available"):
            make(device="cuda:0")
    assert GOPDevicePipeline(cfg, device="cpu").device.type == "cpu"
    assert DecoderSession(device="cpu").device.type == "cpu"


# the port's verbatim copies of the JAX package's numpy and ctypes modules
COPIES = [
    "conformance/__init__.py", "conformance/ffdec.py", "conformance/ffenc.py",
    "entropy/cavlc.py", "entropy/cabac_tables.py", "entropy/cabac_arith.py",
    "entropy/pack.py", "entropy/packp.py", "entropy/cabac_pack.py",
    "golden/__init__.py", "golden/transform.py", "golden/inter.py",
    "golden/deblock.py", "golden/intra.py", "golden/intra44.py",
    "golden/intra8.py", "golden/transform8.py", "golden/codec.py",
    "golden/cabac_slice.py", "engine/libav_backend.py", "bench/charts.py",
]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_is_its_original(rel):
    """Each copy opens with a note naming its original; below the note it
    is the original, with the reference's source paths made relative."""
    lines = open(os.path.join(REPO, "tpuh264_torch", rel)).read().splitlines(
        keepends=True)
    assert lines[0].startswith(f"# Copy of tpuh264/{rel}, "), lines[0]
    body = lines[1:]
    while body[0].startswith("# "):
        body = body[1:]
    orig = open(os.path.join(REPO, "tpuh264", rel)).read()
    assert "".join(body) == re.sub(r"/\w+/reference/", "reference/", orig)


def _ring_trace(mod):
    """The same publish / read / release sequence on a FrameRing of
    `mod`: every result, every refusal, the counters."""
    ring = mod.FrameRing(pool_size=3, max_frame_size=64)
    out, claims = [], []
    for step in range(14):
        try:
            if step % 3 == 2 and claims:
                slot, gen = claims.pop(0)
                out.append(("read", ring.read(slot, gen)))
                for _ in range(2):
                    ring.release(slot, gen)
                ring.release(slot, gen)  # a third release: refused
            else:
                c = ring.try_publish(bytes([step]) * (step + 1), fanout=2)
                out.append(("publish", c))
                if c is not None:
                    claims.append(c)
        except (RuntimeError, ValueError) as e:
            out.append((type(e).__name__, str(e)))
    for data in (bytes(65), b""):
        try:
            out.append(ring.try_publish(data, fanout=1))
        except ValueError as e:
            out.append(str(e))
    out.append([ring.refcount(i) for i in range(3)])
    return out + [ring.produced, ring.dropped, ring.released]


def test_ring_copy_behaves_as_the_original():
    from tpuh264.engine import ring as j_ring
    from tpuh264_torch.engine import ring as t_ring

    assert _ring_trace(t_ring) == _ring_trace(j_ring)
    assert any(o[0] == "RuntimeError" for o in _ring_trace(t_ring)[:14])


def test_intra_tables_match():
    """The Intra_4x4 tables (weights, rounding, shifts, block scan) and the
    I16-vs-I4x4 lambda table equal the JAX package's."""
    from tpuh264.kernels import iframe as j_iframe
    from tpuh264.kernels import intra44 as j_i44
    from tpuh264_torch.kernels import iframe as t_iframe
    from tpuh264_torch.kernels import intra44 as t_i44

    for a, b in zip((t_i44._W_NP, t_i44._R_NP, t_i44._S_NP),
                    (j_i44._W_NP, j_i44._R_NP, j_i44._S_NP)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    assert t_i44.BLK_SCAN == j_i44.BLK_SCAN
    assert t_iframe._LAMBDA8 == np.asarray(j_iframe._LAMBDA8).tolist()
