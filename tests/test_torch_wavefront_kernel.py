"""The single-slice wavefront's kernels K7 (encode) and K8 (decode),
csrc/wavefront.cu: the kernel's own source run on CPU threads against the
plain versions of tpuh264_torch.kernels.wavefront, and the routers'
routes (CPU tensors never reach the kernel library; any other device
never reaches the plain versions; a failed build or launch raises).

The source runs with small clusters (at most CLUSTER CTAs, TEAMS teams a
CTA), each stream's cluster as fibers that switch at every barrier and
flag wait.  The inputs are chip_smoke.py's `W_CASES` (`wave_case`), the
seeded frames phase 2 holds the kernels to their plain versions with on
the card.  Every comparison is exact (array_equal): this is an integer
codec.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import iframe as tif
from tpuh264_torch.kernels import wavefront as W

SOURCE = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc",
                      "wavefront.cu")
IDS = [f"{s}-{c}-qp{q}" for s, c, q in chip_smoke.W_CASES]

# The cluster and team sizes the CPU threads run the source with: small,
# so that the W_SHAPES with more rows than that put several rows on a CTA
# and on a team, and a row count that is not a multiple of the cluster
# leaves the last CTA short.
CLUSTER, TEAMS = 3, 2

# Reads int32 S R C qp qpc decode u8, then the encode's source planes y u
# v (uint8 where u8, else int32), or the decode's int32 mode, cmode,
# cbp_luma, cbp_chroma and int16 luma_dc, luma_ac, chroma_dc, chroma_ac;
# writes the launch plan (K, rows a CTA, teams a CTA), then every output in
# the entry's order.  Each stream runs as one cluster of fibers.
HARNESS = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include <vector>
#include "wavefront.cu"
template <typename T> bool rd(std::vector<T>& x) {
  return fread(x.data(), sizeof(T), x.size(), stdin) == x.size();
}
template <typename T> void wr(const std::vector<T>& x) {
  fwrite(x.data(), sizeof(T), x.size(), stdout);
}
int main() {
  int32_t h[7];
  if (fread(h, 4, 7, stdin) != 7) return 2;
  const int S = h[0], R = h[1], C = h[2], qp = h[3], qpc = h[4], dec = h[5],
            u8 = h[6];
  const size_t m = (size_t)S * R * C;
  const Grid g = plan(R, C);
  const int32_t shape[3] = {g.K, g.rpc, g.teams};
  fwrite(shape, 4, 3, stdout);
  std::vector<uint8_t> ry(256 * m), ru(64 * m), rv(64 * m);
  if (dec) {
    std::vector<int32_t> mode(m), cmode(m), cbl(m), cbc(m);
    std::vector<int16_t> dc(16 * m), ac(256 * m), cdc(8 * m), cac(120 * m);
    if (!rd(mode) || !rd(cmode) || !rd(cbl) || !rd(cbc) || !rd(dc) ||
        !rd(ac) || !rd(cdc) || !rd(cac))
      return 3;
    const DecArgs a{mode.data(), cmode.data(), cbl.data(), cbc.data(),
                    dc.data(),   ac.data(),    cdc.data(), cac.data(),
                    ry.data(),   ru.data(),    rv.data(),  g, qp, qpc};
    for (int s = 0; s < S; ++s)
      run_cluster_fibers(64 * g.teams, g.K, s * g.K,
                         smem_bytes(g, sizeof(DecTeam)),
                         [&] { wavefront_dec_kernel(a); });
  } else {
    std::vector<uint8_t> by(256 * m), bu(64 * m), bv(64 * m);
    std::vector<int32_t> wy(u8 ? 0 : 256 * m), wu(u8 ? 0 : 64 * m),
        wv(u8 ? 0 : 64 * m);
    if (u8 ? !rd(by) || !rd(bu) || !rd(bv) : !rd(wy) || !rd(wu) || !rd(wv))
      return 3;
    const void* sy = u8 ? (const void*)by.data() : wy.data();
    const void* su = u8 ? (const void*)bu.data() : wu.data();
    const void* sv = u8 ? (const void*)bv.data() : wv.data();
    std::vector<int32_t> mode(m), cmode(m), cbl(m), cbc(m);
    std::vector<int16_t> dc(16 * m), ac(256 * m), cdc(8 * m), cac(120 * m),
        i4(16 * m);
    const EncArgs a{sy, su, sv, u8, mode.data(),
                    cmode.data(), cbl.data(), cbc.data(), dc.data(),
                    ac.data(), cdc.data(), cac.data(), i4.data(), ry.data(),
                    ru.data(), rv.data(), g, qp, qpc};
    for (int s = 0; s < S; ++s)
      run_cluster_fibers(64 * g.teams, g.K, s * g.K,
                         smem_bytes(g, sizeof(EncTeam)),
                         [&] { wavefront_enc_kernel(a); });
    wr(mode), wr(cmode), wr(cbl), wr(cbc), wr(dc), wr(ac), wr(cdc), wr(cac);
    wr(i4);
  }
  wr(ry), wr(ru), wr(rv);
  return 0;
}
"""


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """csrc/wavefront.cu (all but its launch entries) built with g++
    against the shims of cuda_threads.py, with clusters of at most CLUSTER
    CTAs and TEAMS teams a CTA: each stream's cluster as fibers
    (`run_cluster_fibers`), its shuffles, ballots, flag waits and cluster
    barriers switching between them."""
    return cuda_threads.build(tmp_path_factory.mktemp("wavefront_cpu"),
                              HARNESS, os.path.dirname(SOURCE),
                              "wavefront_cpu",
                              (f"WF_MAX_CLUSTER={CLUSTER}",
                               f"WF_MAX_TEAMS={TEAMS}"))


def _unpack(out, spec):
    got, off = {}, 12
    got["plan"] = tuple(np.frombuffer(out[:12], np.int32).tolist())
    for name, shape, dt in spec:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        got[name] = np.frombuffer(out[off:off + n], dt).reshape(shape)
        off += n
    assert off == len(out)
    return got


def _recon_spec(s, r, c):
    return [("rec_y", (s, 16 * r, 16 * c), np.uint8),
            ("rec_u", (s, 8 * r, 8 * c), np.uint8),
            ("rec_v", (s, 8 * r, 8 * c), np.uint8)]


def _encode(exe, planes, qp):
    """K7's source on CPU threads on uint8 or int32 planes: the MBSymbols
    fields and the recon planes, as a dict of numpy arrays."""
    s, h, w = planes[0].shape
    r, c = h // 16, w // 16
    u8 = planes[0].dtype == np.uint8
    head = np.array([s, r, c, qp, tif.T.chroma_qp_from_luma(qp), 0, u8],
                    np.int32)
    body = head.tobytes() + b"".join(np.ascontiguousarray(p).tobytes()
                                     for p in planes)
    out = subprocess.run([exe], input=body, capture_output=True,
                         check=True).stdout
    mb = (s, r, c)
    return _unpack(out, [
        ("mode", mb, np.int32), ("cmode", mb, np.int32),
        ("cbp_luma", mb, np.int32), ("cbp_chroma", mb, np.int32),
        ("luma_dc", (*mb, 16), np.int16), ("luma_ac", (*mb, 16, 16), np.int16),
        ("chroma_dc", (*mb, 2, 4), np.int16),
        ("chroma_ac", (*mb, 2, 4, 15), np.int16),
        ("i4modes", (*mb, 16), np.int16), *_recon_spec(s, r, c)])


def _decode(exe, symbols, qp):
    """K8's source on CPU threads on the symbols: the recon planes."""
    s, r, c = symbols.mode.shape
    head = np.array([s, r, c, qp, tif.T.chroma_qp_from_luma(qp), 1, 0],
                    np.int32)
    flags = (symbols.mode, symbols.cmode, symbols.cbp_luma,
             symbols.cbp_chroma)
    levels = (symbols.luma_dc, symbols.luma_ac, symbols.chroma_dc,
              symbols.chroma_ac)
    body = head.tobytes() + b"".join(
        x.to(torch.int32).contiguous().numpy().tobytes() for x in flags
    ) + b"".join(x.to(torch.int16).contiguous().numpy().tobytes()
                 for x in levels)
    out = subprocess.run([exe], input=body, capture_output=True,
                         check=True).stdout
    return _unpack(out, _recon_spec(s, r, c))


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("case", chip_smoke.W_CASES, ids=IDS)
def test_kernel_source_on_cpu_threads_matches_plain(cpu_kernel, case):
    """K7's waves, SAD reductions, transforms and DC Hadamards, run a
    stream's warps at a time, equal the plain encode on the case, from
    uint8 and from int32 planes; K8 on those symbols equals the plain
    decode (and the recon), and on the same symbols with every MB's mode
    and cmode drawn at random among the modes legal at that MB."""
    y, u, v, qp = chip_smoke.wave_case(np, *case)
    sym, rec = W._encode_iframe_single_plain(
        *map(torch.from_numpy, (y, u, v)), qp)
    for src in ((y, u, v), tuple(p.astype(np.int32) for p in (y, u, v))):
        got = _encode(cpu_kernel, src, qp)
        for f in tif.MBSymbols._fields:
            _eq(got[f], getattr(sym, f).numpy(), f"{src[0].dtype} {f}")
        for f, want in zip(("rec_y", "rec_u", "rec_v"), rec):
            _eq(got[f], want.numpy(), f"{src[0].dtype} {f}")
    dec = _decode(cpu_kernel, sym, qp)
    for f, want in zip(("rec_y", "rec_u", "rec_v"), rec):
        _eq(dec[f], want.numpy(), f"decode {f}")
    mode, cmode = chip_smoke.legal_modes(
        np, np.random.default_rng(sum(case[0]) + qp), tuple(sym.mode.shape))
    rand = sym._replace(mode=torch.from_numpy(mode),
                        cmode=torch.from_numpy(cmode))
    want = W._decode_iframe_single_plain(rand, qp)
    dec = _decode(cpu_kernel, rand, qp)
    for f, w in zip(("rec_y", "rec_u", "rec_v"), want):
        _eq(dec[f], w.numpy(), f"decode of random modes {f}")


@pytest.mark.parametrize("case", chip_smoke.W_CASES, ids=IDS)
def test_k8_any_modes_on_cpu_threads_match_plain(cpu_kernel, case):
    """K8 on the case's symbols with every MB's mode and cmode drawn from
    0-3 whatever its neighbours (`any_modes`): V and Plane in row 0, H and
    Plane in column 0 predict from the zeros and the saved corner exactly
    as the plain decode does (a column-0 MB from row 2 on takes the
    bottom-right sample of MB (r - 2, 0) as its corner)."""
    y, u, v, qp = chip_smoke.wave_case(np, *case)
    sym, _ = W._encode_iframe_single_plain(
        *map(torch.from_numpy, (y, u, v)), qp)
    mode, cmode = chip_smoke.any_modes(
        np, np.random.default_rng(sum(case[0]) + qp + 1),
        tuple(sym.mode.shape))
    rand = sym._replace(mode=torch.from_numpy(mode),
                        cmode=torch.from_numpy(cmode))
    want = W._decode_iframe_single_plain(rand, qp)
    dec = _decode(cpu_kernel, rand, qp)
    for f, w in zip(("rec_y", "rec_u", "rec_v"), want):
        _eq(dec[f], w.numpy(), f"decode of any modes {f}")


@pytest.mark.parametrize("case", chip_smoke.W_CASES, ids=IDS)
def test_k8_masked_levels_on_cpu_threads_match_plain(cpu_kernel, case):
    """K8 on the case's levels under random cbp (`masked_cbp`): where cbp
    says no luma AC, no chroma DC or no chroma AC, the levels there are
    dropped, exactly as the plain decode's masks drop them."""
    y, u, v, qp = chip_smoke.wave_case(np, *case)
    sym, _ = W._encode_iframe_single_plain(
        *map(torch.from_numpy, (y, u, v)), qp)
    cbl, cbc = chip_smoke.masked_cbp(
        np, np.random.default_rng(sum(case[0]) + qp), tuple(sym.mode.shape))
    masked = sym._replace(cbp_luma=torch.from_numpy(cbl),
                          cbp_chroma=torch.from_numpy(cbc))
    want = W._decode_iframe_single_plain(masked, qp)
    dec = _decode(cpu_kernel, masked, qp)
    for f, w in zip(("rec_y", "rec_u", "rec_v"), want):
        _eq(dec[f], w.numpy(), f"decode of masked levels {f}")


def test_masked_cases_hide_coded_levels():
    """Over the cases, `masked_cbp` says 0 where luma AC, chroma DC and
    chroma AC levels were coded, so each mask drops real levels."""
    hidden = np.zeros(3, int)
    for case in chip_smoke.W_CASES:
        y, u, v, qp = chip_smoke.wave_case(np, *case)
        sym, _ = W._encode_iframe_single_plain(
            *map(torch.from_numpy, (y, u, v)), qp)
        cbl, cbc = chip_smoke.masked_cbp(
            np, np.random.default_rng(sum(case[0]) + qp),
            tuple(sym.mode.shape))
        ac = sym.luma_ac.numpy().reshape(*cbl.shape, -1) != 0
        cdc = sym.chroma_dc.numpy().reshape(*cbl.shape, -1) != 0
        cac = sym.chroma_ac.numpy().reshape(*cbl.shape, -1) != 0
        hidden += [(ac.any(-1) & (cbl == 0)).sum(),
                   (cdc.any(-1) & (cbc == 0)).sum(),
                   (cac.any(-1) & (cbc == 1)).sum()]
    assert (hidden > 0).all(), hidden


def test_shapes_cover_the_cluster_plans(cpu_kernel):
    """Under the tests' cluster and team limits some W_SHAPES put several
    MB rows on each CTA and on a team, with a row count that is not a
    multiple of the cluster size (the last CTA short); the plan is the
    kernel's own (`plan`, read back from the harness)."""
    plans = {}
    for s, r, c in chip_smoke.W_SHAPES:
        sym, _ = W._encode_iframe_single_plain(
            *(torch.zeros((s, n * r, n * c), dtype=torch.uint8)
              for n in (16, 8, 8)), 28)
        plans[(r, c)] = _decode(cpu_kernel, sym, 28)["plan"]
    assert plans[(1, 1)] == (1, 1, 1)
    assert any(k == CLUSTER and rpc > TEAMS and r % k
               for (r, _), (k, rpc, teams) in plans.items())
    assert all(teams == min(rpc, TEAMS) and k * rpc >= r > (k - 1) * rpc
               for (r, _), (k, rpc, teams) in plans.items())


def test_any_modes_reach_the_column0_corner():
    """`any_modes` draws every mode at every kind of MB over the cases:
    luma and chroma Plane in column 0 from row 2 on (the saved corner), V
    / Plane in row 0 and H / Plane in column 0 (the zeros)."""
    col0_plane = row0 = col0 = 0
    for case in chip_smoke.W_CASES:
        s, r, c = case[0]
        qp = case[2]
        mode, cmode = chip_smoke.any_modes(
            np, np.random.default_rng(sum(case[0]) + qp + 1), (s, r, c))
        assert mode.dtype == cmode.dtype == np.int32
        assert set(np.unique(mode)) <= {0, 1, 2, 3}
        col0_plane += int((mode[:, 2:, 0] == 3).sum()
                          + (cmode[:, 2:, 0] == 3).sum())
        row0 += int(np.isin(mode[:, 0], (0, 3)).sum())
        col0 += int(np.isin(mode[:, :, 0], (1, 3)).sum())
    assert col0_plane and row0 and col0


def test_cases_cover_what_they_claim():
    """R = C = 1, R = 1, C = 1, R > C and S of 1 and 2; every content at
    every QP across the shapes; the plain encode picks every luma mode
    (V, H, DC, Plane) and every chroma mode (DC, H, V, Plane) over the
    cases; the 0 / 255 contents' recon reaches 0 and 255."""
    shapes = set(chip_smoke.W_SHAPES)
    assert (1, 1, 1) in shapes
    assert any(r == 1 and c > 1 for _, r, c in shapes)
    assert any(c == 1 and r > 1 for _, r, c in shapes)
    assert any(r > c > 1 for _, r, c in shapes)
    assert {s for s, _, _ in shapes} == {1, 2}
    pairs = {(c, q) for _, c, q in chip_smoke.W_CASES}
    assert pairs == {(c, q) for c in chip_smoke.W_CONTENT
                     for q in chip_smoke.W_QPS}
    modes, cmodes, clipped = set(), set(), set()
    for case in chip_smoke.W_CASES:
        y, u, v, qp = chip_smoke.wave_case(np, *case)
        sym, rec = W._encode_iframe_single_plain(
            *map(torch.from_numpy, (y, u, v)), qp)
        modes.update(sym.mode.unique().tolist())
        cmodes.update(sym.cmode.unique().tolist())
        if case[1] in ("flat0", "flat255", "saturate"):
            clipped |= {x for x in (0, 255) if (rec[0] == x).any()}
    assert modes == {0, 1, 2, 3} and cmodes == {0, 1, 2, 3}
    assert clipped == {0, 255}


def test_random_modes_are_legal_and_reach_every_mode():
    """chip_smoke.legal_modes draws, at each MB, only modes whose
    neighbours exist (luma V and chroma V below row 0, H right of column
    0, Plane with both; DC anywhere) and, over a frame, every one."""
    mode, cmode = chip_smoke.legal_modes(np, np.random.default_rng(0),
                                         (2, 5, 6))
    assert mode.dtype == cmode.dtype == np.int32
    row0, col0 = np.s_[:, 0, :], np.s_[:, :, 0]
    assert not np.isin(mode[row0], (0, 3)).any()
    assert not np.isin(mode[col0], (1, 3)).any()
    assert not np.isin(cmode[row0], (2, 3)).any()
    assert not np.isin(cmode[col0], (1, 3)).any()
    assert set(mode[:, 1:, 1:].ravel()) == {0, 1, 2, 3}
    assert set(cmode[:, 1:, 1:].ravel()) == {0, 1, 2, 3}


def _refuse():
    raise AssertionError("the kernel library was loaded for CPU tensors")


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On CPU tensors both routers take the plain versions: the kernel
    library is never loaded and the launch counters do not move."""
    monkeypatch.setattr(cuda_lib, "load", _refuse)
    before = (W.encode_iframe_single.launches,
              W.decode_iframe_single.launches)
    y, u, v, qp = chip_smoke.wave_case(np, (2, 3, 4), "mix", 28)
    planes = [torch.from_numpy(p) for p in (y, u, v)]
    sym, rec = W.encode_iframe_single(*planes, qp)
    psym, prec = W._encode_iframe_single_plain(*planes, qp)
    for a, b in zip((*sym, *rec), (*psym, *prec)):
        assert torch.equal(a, b)
    dec = W.decode_iframe_single(sym, qp)
    assert all(torch.equal(a, b) for a, b in zip(dec, rec))
    assert (W.encode_iframe_single.launches,
            W.decode_iframe_single.launches) == before


def _meta_case():
    """A case's frames and symbols on the meta device (a device that is
    not the CPU and that no kernel takes)."""
    y, u, v, qp = chip_smoke.wave_case(np, (1, 2, 3), "noise", 28)
    planes = [torch.from_numpy(p) for p in (y, u, v)]
    sym, _ = W._encode_iframe_single_plain(*planes, qp)
    meta = lambda x: x.to("meta")
    return [meta(p) for p in planes], sym._replace(
        **{f: meta(getattr(sym, f)) for f in sym._fields}), qp


def test_off_cpu_never_reaches_the_plain_versions(monkeypatch):
    """A tensor off the CPU never reaches a plain version: on a device the
    kernels cannot take, both routers raise before any launch; a failed
    build raises; an entry that reports a CUDA error at launch raises,
    naming the entry."""
    planes, sym, qp = _meta_case()
    plain = []
    monkeypatch.setattr(W, "_encode_iframe_single_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(W, "_decode_iframe_single_plain",
                        lambda *a, **k: plain.append(1))
    monkeypatch.setattr(cuda_lib, "load", _refuse)
    before = (W.encode_iframe_single.launches,
              W.decode_iframe_single.launches)
    with pytest.raises(ValueError):
        W.encode_iframe_single(*planes, qp)
    with pytest.raises(ValueError):
        W.decode_iframe_single(sym, qp)

    # past the input checks: the build fails, or the launch reports an error
    monkeypatch.setattr(cuda_lib, "check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "stream", lambda dev: None)

    def no_build():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(cuda_lib, "load", no_build)
    with pytest.raises(RuntimeError, match="nvcc"):
        W.encode_iframe_single(*planes, qp)
    with pytest.raises(RuntimeError, match="nvcc"):
        W.decode_iframe_single(sym, qp)

    class Refusing:
        @staticmethod
        def th264_wavefront_encode(*args):
            return 9  # cudaErrorInvalidConfiguration

        th264_wavefront_decode = th264_wavefront_encode

        @staticmethod
        def th264_cuda_error_string(err):
            return b"invalid configuration argument"

    monkeypatch.setattr(cuda_lib, "load", lambda: Refusing())
    monkeypatch.setattr(cuda_lib, "_lib", Refusing())
    with pytest.raises(RuntimeError, match="th264_wavefront_encode"):
        W.encode_iframe_single(*planes, qp)
    with pytest.raises(RuntimeError, match="th264_wavefront_decode"):
        W.decode_iframe_single(sym, qp)
    assert not plain
    assert (W.encode_iframe_single.launches,
            W.decode_iframe_single.launches) == before


def test_card_decode_is_one_launch_on_the_levels(monkeypatch):
    """Off the CPU the decode router launches K8 once on the symbols as
    they are: no `_intra_residuals`, the int16 levels and int32 flags
    handed to the entry in MBSymbols' order, then the shape and both QPs."""
    _, sym, qp = _meta_case()

    def no_residuals(*a, **k):
        raise AssertionError("the card route decoded residuals in torch")

    calls = []

    class Lib:
        @staticmethod
        def th264_wavefront_decode(*args):
            calls.append(args)
            return 0

    monkeypatch.setattr(W, "_intra_residuals", no_residuals)
    monkeypatch.setattr(cuda_lib, "load", lambda: Lib())
    monkeypatch.setattr(cuda_lib, "stream", lambda dev: "stream")
    asked = []
    monkeypatch.setattr(cuda_lib, "check_inputs",
                        lambda name, dev, specs, dtype=torch.int32:
                        asked.append((dtype, [x.dtype for x, _ in specs])))
    before = W.decode_iframe_single.launches
    rec = W.decode_iframe_single(sym, qp)
    assert W.decode_iframe_single.launches == before + 1
    assert len(calls) == 1 and len(calls[0]) == 11 + 5 + 1
    s, r, c = sym.mode.shape
    assert calls[0][11:] == (s, r, c, qp, tif.T.chroma_qp_from_luma(qp),
                             "stream")
    assert asked == [(torch.int32, [torch.int32] * 4),
                     (torch.int16, [torch.int16] * 4)]
    assert [tuple(x.shape) for x in rec] == [
        (s, 16 * r, 16 * c), (s, 8 * r, 8 * c), (s, 8 * r, 8 * c)]


@pytest.mark.parametrize("bad", ["dtype", "shape", "qp"])
def test_router_rejects_what_the_kernel_cannot_take(monkeypatch, bad):
    """Planes the input check refuses, frames not whole MBs, or a QP
    outside 0..51 raise before the library is loaded.  The check is asked
    for uint8 planes where all three are uint8 (K7 reads bytes), else for
    the planes converted to int32 (K7 reads those too)."""
    monkeypatch.setattr(cuda_lib, "load", _refuse)
    planes, _, qp = _meta_case()
    if bad == "dtype":
        asked = []

        def check(name, dev, specs, dtype=torch.int32):
            asked.append((dtype, [x.dtype for x, _ in specs]))
            raise TypeError(f"{name}: inputs must be {dtype}")

        monkeypatch.setattr(cuda_lib, "check_inputs", check)
        for ps in (planes, [planes[0].to(torch.int16), *planes[1:]]):
            with pytest.raises(TypeError):
                W.encode_iframe_single(*ps, qp)
        assert asked == [(torch.uint8, [torch.uint8] * 3),
                         (torch.int32, [torch.int32] * 3)]
        return
    if bad == "shape":
        planes = [planes[0][:, :8], *planes[1:]]
    else:
        qp = 52
    with pytest.raises(ValueError):
        W.encode_iframe_single(*planes, qp)
