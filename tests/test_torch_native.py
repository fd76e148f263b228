"""The port's own native CAVLC engine (tpuh264_torch/native/cavlc.cpp,
bound by tpuh264_torch.entropy.native) against tpuh264.entropy.native:
the same bytes from the same symbols, the same parsed records from the
same streams, and a rebuild whenever the VLC tables change.

Streams and symbols come from the port's GOP pipeline on the CPU (64x48
x 2: "noise" with intra-in-P and two references, and host frames half
still and half moving with the RTC preset; between them IDR, inter,
intra and skip MBs), which the parity tests hold byte-exact to the JAX
pipeline."""

import os

import numpy as np
import pytest

from tpuh264.entropy import native as j_native
from tpuh264_torch.engine import CodecConfig
from tpuh264_torch.engine.devpipe import GOPDevicePipeline
from tpuh264_torch.entropy import native as t_native


def _host_batch(d):
    """Host frames [4, 2, H, W]: the left half moves a pixel a frame
    (inter MBs), the right half stands still (skip MBs)."""
    rng = np.random.default_rng(9)
    planes = []
    for h, w in ((48, 64), (24, 32), (24, 32)):
        base = rng.integers(0, 256, (2, h, w + 8)).astype(np.uint8)
        fr = []
        for f in range(4 * d, 4 * d + 4):
            p = base[:, :, 8:].copy()
            p[:, :, :w // 2] = base[:, :, 8 - f % 8:8 - f % 8 + w // 2]
            fr.append(p)
        planes.append(np.stack(fr))
    return planes


# (source, CodecConfig arguments, the MB kind the P frames must code)
GOPS = {
    "noise, intra-in-P, 2 refs, CBR": (
        "noise", dict(qp=None, bitrate=200_000, num_ref_frames=2), 2),
    "host half static, RTC preset, QP 30": (
        "host", dict(qp=30, intra_in_p=False), 0),
}


@pytest.fixture(scope="module", params=sorted(GOPS))
def gop(request):
    """Two dispatches (IDR + 3 P, then 4 P) with their symbols."""
    source, kw, need = GOPS[request.param]
    pipe = GOPDevicePipeline(
        CodecConfig(**dict(dict(width=64, height=48, streams=2), **kw)),
        gop_size=8, source_kind=source, device="cpu")
    enc, seen = pipe._encode, []

    def spy(start, *a, **kw):
        out = enc(start, *a, **kw)
        seen.append((start, a[1], out[0], out[1]))  # start, qp, sym_i, P
        return out

    pipe._encode = spy
    for d in range(2):
        if source == "host":
            pipe.pump_host_frames(*_host_batch(d))
        else:
            pipe.pump_frame()
    kinds = np.bincount(np.concatenate(
        [s[3].kind.numpy().ravel() for s in seen]), minlength=3)
    assert kinds[need] > 0 and kinds[1] > 0, kinds
    return pipe, seen


def test_pack_checks_symbol_sizes(gop):
    """The engine trusts its pointers: arrays of the wrong size raise."""
    pipe, _ = gop
    n = (pipe.h16 // 16) * (pipe.w16 // 16)
    z = lambda *sh: np.zeros(sh, np.int16)
    with pytest.raises(ValueError):
        t_native.pack_iframe(np.zeros((n, 4), np.int32), z(n, 16),
                             z(n - 1, 16, 16), z(n, 2, 4), z(n, 2, 4, 15),
                             pipe.sps, pipe.pps, 30)
    with pytest.raises(ValueError):
        t_native.pack_pframe(np.zeros((n, 4), np.int32), z(n, 16),
                             z(n, 16, 16), z(n, 2, 4), z(n, 2, 4, 15),
                             pipe.sps, pipe.pps, 30)


def test_escape_rbsp_matches():
    rng = np.random.default_rng(4)
    for n in (0, 1, 3, 64, 4096, 70000):
        raw = rng.integers(0, 4, n).astype(np.uint8)
        raw[rng.random(n) < 0.6] = 0
        b = raw.tobytes()
        assert t_native.escape_rbsp(b) == j_native.escape_rbsp(b)
        e = j_native.escape_rbsp(b)
        assert t_native.unescape_rbsp(e) == j_native.unescape_rbsp(e) == b


def test_pack_iframe_matches(gop):
    pipe, seen = gop
    s = pipe.config.streams
    n = (pipe.h16 // 16) * (pipe.w16 // 16)
    start, qp, sym, _ = seen[0]
    assert start
    npy = lambda x, *sh: x.numpy().reshape(s, n, *sh)
    info = np.stack([npy(sym.mode), npy(sym.cmode), npy(sym.cbp_luma),
                     npy(sym.cbp_chroma)], -1).astype(np.int32)
    arrs = (npy(sym.luma_dc, 16), npy(sym.luma_ac, 16, 16),
            npy(sym.chroma_dc, 2, 4), npy(sym.chroma_ac, 2, 4, 15))
    for si in range(s):
        for kw in (dict(), dict(deblock_idc=2), dict(frame_num=3)):
            a = t_native.pack_iframe(info[si], *(x[si] for x in arrs),
                                     pipe.sps, pipe.pps, qp, **kw)
            b = j_native.pack_iframe(info[si], *(x[si] for x in arrs),
                                     pipe.sps, pipe.pps, qp, **kw)
            assert a == b


def test_pack_pframe_matches(gop):
    pipe, seen = gop
    s = pipe.config.streams
    n = (pipe.h16 // 16) * (pipe.w16 // 16)
    for start, qp, _, sym in seen:
        n_p = sym.kind.shape[0] // s
        npy = lambda x, *sh: x.numpy().reshape(n_p, s, n, *sh)
        info = np.stack([npy(getattr(sym, f)) for f in (
            "kind", "mode", "cmode", "cbp_luma", "cbp_chroma", "mvdx",
            "mvdy", "refidx")], -1).astype(np.int32)
        arrs = (npy(sym.luma_dc, 16), npy(sym.luma_ac, 16, 16),
                npy(sym.chroma_dc, 2, 4), npy(sym.chroma_ac, 2, 4, 15))
        nra = 1 if start else pipe.n_refs
        for pi in range(n_p):
            for si in range(s):
                args = (info[pi, si], *(x[pi, si] for x in arrs), pipe.sps,
                        pipe.pps, qp)
                for kw in (dict(frame_num=pi + 1, deblock_idc=2,
                                num_ref_active=nra), dict(frame_num=300)):
                    assert t_native.pack_pframe(*args, **kw) == \
                        j_native.pack_pframe(*args, **kw)


def test_parse_dispatch_compact_matches(gop):
    pipe, _ = gop
    r, c = pipe.h16 // 16, pipe.w16 // 16
    k = pipe.FRAMES_PER_DISPATCH
    for d in range(2):
        flat = [b for fr in pipe.frame_streams[d * k:(d + 1) * k]
                for b in fr]
        for kw in (dict(), dict(threads=1, cap_mb=1, cap_c=1)):
            a = t_native.parse_dispatch_compact(flat, c, r, pipe.sps,
                                                pipe.pps, **kw)
            b = j_native.parse_dispatch_compact(flat, c, r, pipe.sps,
                                                pipe.pps, **kw)
            assert a[0] == b[0]
            for x, y in zip(a[1:], b[1:]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
    assert t_native.MB_SLOTS == j_native.MB_SLOTS == pipe.MB_SLOTS


def test_library_rebuilt_when_tables_or_source_change(tmp_path,
                                                      monkeypatch):
    """The built engine is reused only while its generated tables match
    the port's cavlc_tables and the source is not newer; the generated
    tables are the ones native/gen_tables.py gives the original."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "gen_tables", os.path.join(os.path.dirname(j_native.__file__),
                                   "..", "..", "native", "gen_tables.py"))
    gen = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(gen)
    out = tmp_path / "orig.inc"
    with open(out, "w") as f:
        gen.emit(f)
    text = t_native._tables_inc()
    strip = lambda s: s.split("\n", 1)[1]  # the generator's comment line
    assert strip(text) == strip(out.read_text())

    lib, inc = tmp_path / "lib.so", tmp_path / "cavlc_tables.inc"
    monkeypatch.setattr(t_native, "LIB", str(lib))
    monkeypatch.setattr(t_native, "INC", str(inc))
    assert t_native._stale(text)
    inc.write_text(text)
    lib.write_bytes(b"")
    t_src = os.path.getmtime(t_native.SRC)
    os.utime(lib, (t_src + 10, t_src + 10))
    assert not t_native._stale(text)
    assert t_native._stale(text.replace("RUN_BEFORE_T", "RUN_BEFORE_X"))
    os.utime(lib, (t_src - 10, t_src - 10))
    assert t_native._stale(text)


def test_port_engine_is_its_own_library():
    """The port loads its own build, never native/libtpuh264.so."""
    lib = t_native.load()
    assert os.path.realpath(lib._name) == os.path.realpath(t_native.LIB)
    assert os.path.dirname(t_native.LIB).endswith(
        os.path.join("tpuh264_torch", "build"))
    assert os.path.isfile(t_native.SRC)


def _i44_symbols(pipe, qp=26):
    """Intra_4x4 I symbols of a gradient frame (64x48 x 1) from the port's
    I scan, as the packer's per-MB arrays; Intra_4x4 is chosen in some
    MBs."""
    import torch

    from tpuh264_torch.kernels import iframe

    yy, xx = np.mgrid[0:pipe.h16, 0:pipe.w16]
    y = np.where(((2 * xx + yy) // 5) % 2, 60, 180)[None].astype(np.uint8)
    u = np.full((1, pipe.h16 // 2, pipe.w16 // 2), 100, np.uint8)
    sym, _ = iframe.encode_iframe_scan(*(torch.from_numpy(p)
                                         for p in (y, u, u + 30)), qp,
                                       intra44=True)
    n = (pipe.h16 // 16) * (pipe.w16 // 16)
    npy = lambda x, *sh: x.numpy().reshape(n, *sh)
    info = np.stack([npy(sym.mode), npy(sym.cmode), npy(sym.cbp_luma),
                     npy(sym.cbp_chroma)], -1).astype(np.int32)
    assert (info[:, 0] == 4).any() and (info[:, 0] != 4).any()
    return info, (npy(sym.luma_dc, 16), npy(sym.luma_ac, 16, 16),
                  npy(sym.chroma_dc, 2, 4), npy(sym.chroma_ac, 2, 4, 15),
                  npy(sym.i4modes, 16))


def _slices_of(data, sps, pps):
    """The P slices of an access unit as (rbsp, header bits, first MB)."""
    from tpuh264_torch.core import nal
    from tpuh264_torch.core.bitstream import BitReader
    from tpuh264_torch.core.sliceheader import SliceHeader

    out = []
    for ridc, ntype, rbsp in nal.split_annexb(data):
        r = BitReader(rbsp)
        h = SliceHeader.parse(r, sps, pps, False, ref=ridc != 0)
        out.append((rbsp, r.bit_position, h.first_mb_in_slice))
    return out


def test_widened_pack_iframe_and_parse_iframe_match(gop):
    """pack_iframe with Intra_4x4 MBs, a single slice, a non-IDR I frame,
    no parameter sets, one thread: the JAX bytes; parse_iframe of each
    (with its parameter sets): the JAX arrays, the packed symbols back."""
    pipe, _ = gop
    info, (ldc, lac, cdc, cac, i4m) = _i44_symbols(pipe)
    args = (info, ldc, lac, cdc, cac, pipe.sps, pipe.pps, 26)
    for kw in (dict(i4modes=i4m), dict(i4modes=i4m, slice_mode="single",
                                        threads=1),
               dict(i4modes=i4m, idr=False, frame_num=5, include_ps=False,
                    deblock_idc=2)):
        a = t_native.pack_iframe(*args, **kw)
        assert a == j_native.pack_iframe(*args, **kw), kw
        if not kw.get("include_ps", True):
            a = t_native.pack_iframe(*args, **dict(kw, include_ps=True))
        for threads in (0, 1):
            pa = t_native.parse_iframe(a, threads=threads)
            pb = j_native.parse_iframe(a, threads=threads)
            assert vars(pa[0]) == vars(pb[0]) and vars(pa[1]) == vars(pb[1])
            assert pa[2] == pb[2] == 26
            for x, y in zip(pa[3:], pb[3:]):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(pa[3], info)
        np.testing.assert_array_equal(pa[8][info[:, 0] == 4],
                                      i4m[info[:, 0] == 4])
    with pytest.raises(RuntimeError):
        t_native.parse_iframe(b"\x00\x00\x01\x65garbage")


def test_widened_pack_pframe_and_parse_pframe_slices_match(gop):
    """pack_pframe as one slice, and as a non-reference picture: the JAX
    bytes; parse_pframe_slices of each: the JAX arrays, and the symbols
    of the coded (not skipped) MBs."""
    pipe, seen = gop
    s = pipe.config.streams
    n = (pipe.h16 // 16) * (pipe.w16 // 16)
    _, qp, _, sym = seen[-1]
    npy = lambda x, *sh: x.numpy().reshape(-1, s, n, *sh)[0, 0]
    info = np.stack([npy(getattr(sym, f)) for f in (
        "kind", "mode", "cmode", "cbp_luma", "cbp_chroma", "mvdx", "mvdy",
        "refidx")], -1).astype(np.int32)
    arrs = (npy(sym.luma_dc, 16), npy(sym.luma_ac, 16, 16),
            npy(sym.chroma_dc, 2, 4), npy(sym.chroma_ac, 2, 4, 15))
    nra = pipe.n_refs
    args = (info, *arrs, pipe.sps, pipe.pps, qp)
    for kw in (dict(slice_mode="single", num_ref_active=nra),
               dict(ref=False, frame_num=3, num_ref_active=nra),
               dict(slice_mode="single", ref=False, deblock_idc=2)):
        a = t_native.pack_pframe(*args, **kw)
        assert a == j_native.pack_pframe(*args, **kw), kw
        sl = _slices_of(a, pipe.sps, pipe.pps)
        assert len(sl) == (1 if kw.get("slice_mode") else pipe.h16 // 16)
        k = kw.get("num_ref_active", 1)
        pa = t_native.parse_pframe_slices(sl, pipe.sps, pipe.pps, k)
        pb = j_native.parse_pframe_slices(sl, pipe.sps, pipe.pps, k)
        for x, y, want in zip(pa, pb, (info, *arrs)):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
            if k == nra:
                coded = info[:, 0] != 0
                np.testing.assert_array_equal(x[coded], want[coded])
