"""The encoder's Intra_16x16 column scans (D3, the I encode; D4, the
intra-in-P trial of the P encode) and their kernel K6: the port's
encodes against the JAX package's on seeded frames, the algebra the
kernel's design rests on, the kernel's source run on CPU threads against
the plain versions, and the routers' routes.

The inputs come from `chip_smoke.d3_case` / `d4_args`, the generators
chip_smoke.py phase 2 holds the kernel to its plain versions with on the
card.  Every comparison is exact (array_equal): this is an integer codec.
"""

import concurrent.futures
import os
import subprocess

import numpy as np
import pytest
import torch

import chip_smoke
import cuda_threads
import test_torch_intra_recon as K5T
from tpuh264.kernels import iframe as jif
from tpuh264.kernels import pframe as jpf
from tpuh264_torch.kernels import cuda_lib
from tpuh264_torch.kernels import iframe as tif
from tpuh264_torch.kernels import intra44 as I44
from tpuh264_torch.kernels import pframe as tpf
from tpuh264_torch.kernels import transform as T

SOURCE = os.path.join(os.path.dirname(cuda_lib.__file__), os.pardir, "csrc",
                      "intra16_enc.cu")
D3_IDS = [f"{s}-{c}-qp{q}" for s, c, q in chip_smoke.D3_CASES]
D4_IDS = [f"{s}-{v}-{c}-qp{q}" for s, v, c, q in chip_smoke.D4_CASES]


def _frames(case):
    y, u, v, qp = chip_smoke.d3_case(np, *case)
    return (y, u, v), qp


def _eq(a, b, msg=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=msg)


@pytest.mark.parametrize("case", chip_smoke.D3_CASES, ids=D3_IDS)
def test_iframe_encode_matches_jax(case):
    """The port's `encode_iframe_rows` (the plain scan on the CPU) equals
    JAX `encode_iframe_scan`: every symbol field and the recon."""
    planes, qp = _frames(case)
    jsym, jrec = jif.encode_iframe_scan(*planes, qp)
    tsym, trec = tif.encode_iframe_rows(*map(torch.from_numpy, planes), qp)
    for f in tif.MBSymbols._fields:
        _eq(getattr(jsym, f), getattr(tsym, f).numpy(), f)
    for a, b in zip(jrec, trec):
        assert b.dtype == torch.uint8
        _eq(a, b.numpy(), "recon")


def _p_frames(shape, seed):
    """A P frame and its reference [1, S, H, W] (int32 numpy): the
    reference holds the frame in a random half of the MBs (inter wins at
    SAD 0) and unrelated noise elsewhere, where the frame is flat, rows
    or noise by MB (Intra_16x16 wins many of them)."""
    s, r, c = shape
    rng = np.random.default_rng([s, r, c, seed])
    cur, ref = [], []
    for n in (16, 8, 8):
        kind = rng.integers(0, 3, (s, r, c))
        flat = np.repeat(np.repeat(rng.integers(0, 256, (s, r, c)), n, 1),
                         n, 2)
        rows = np.repeat(rng.integers(0, 256, (s, r * n, c)), n, 2)
        noise = rng.integers(0, 256, (s, r * n, c * n))
        up = lambda k: np.repeat(np.repeat(kind == k, n, 1), n, 2)
        x = np.where(up(0), flat, np.where(up(1), rows, noise))
        keep = np.repeat(np.repeat(rng.random((s, r, c)) < 0.5, n, 1), n, 2)
        cur.append(x.astype(np.int32))
        ref.append(np.where(keep, x, rng.integers(0, 256, x.shape))
                   .astype(np.int32)[None])
    return cur, ref


# two shapes (a JAX compile each): short lanes, and the long one
P_SHAPES = ((3, 2, 3), (2, 2, 61))


@pytest.mark.parametrize("shape", P_SHAPES)
@pytest.mark.parametrize("qp", (0, 11, 28, 51))
def test_pframe_intra_in_p_matches_jax(shape, qp):
    """The port's `encode_pframe_rows_multi(intra_in_p=True)` (its D4
    scan the plain version on the CPU) equals JAX's: symbols, recon and
    motion; the frame codes intra and other MBs."""
    cur, ref = _p_frames(shape, qp)
    jsym, jrec, jmot = jpf.encode_pframe_rows_multi(*cur, *ref, qp,
                                                    intra_in_p=True)
    tsym, trec, tmot = tpf.encode_pframe_rows_multi(
        *map(torch.from_numpy, cur), *map(torch.from_numpy, ref), qp,
        intra_in_p=True)
    for f in jpf.MBSymbolsP._fields:
        if getattr(jsym, f) is not None:
            _eq(getattr(jsym, f), getattr(tsym, f).numpy(), f)
    for a, b in zip((*jrec, *jmot), (*trec, *tmot)):
        _eq(a, b.numpy())
    assert (tsym.kind == tpf.KIND_INTRA).any()
    assert (tsym.kind != tpf.KIND_INTRA).any()


def test_cases_cover_what_they_claim():
    """C = 1, 2, 3 and a lane of C >= 54; S and R from 1 to 4; every QP
    with every content; flat content ties DC and H, rows make H win, the
    saturated content's recon reaches 0 and 255; D4's intra shares 0,
    ~1% (at least one MB), 50% and 100% of the MBs, and exact ties."""
    shapes = set(chip_smoke.D3_SHAPES)
    assert {1, 2, 3} <= {c for _, _, c in shapes}
    assert any(c >= 54 for _, _, c in shapes)
    assert {s for s, _, _ in shapes} == {1, 2, 3, 4}
    assert {r for _, r, _ in shapes} == {1, 2, 3, 4}
    pairs = {(c, q) for _, c, q in chip_smoke.D3_CASES}
    assert pairs == {(c, q) for c in chip_smoke.D3_CONTENT
                     for q in chip_smoke.D3_QPS}
    modes, cmodes, clipped = {}, set(), set()
    for case in chip_smoke.D3_CASES:
        planes, qp = _frames(case)
        sym, rec = tif._encode_iframe_scan_plain(
            *map(torch.from_numpy, planes), qp)
        later = sym.mode[..., 1:]
        modes.setdefault(case[1], set()).update(later.unique().tolist())
        cmodes.update(sym.cmode[..., 1:].unique().tolist())
        if case[1] == "saturate":
            clipped |= {v for v in (0, 255) if (rec[0] == v).any()}
    assert modes["flat"] == {2} and 1 in modes["rows"]
    assert set().union(*modes.values()) == {1, 2} and cmodes == {0, 1}
    assert clipped == {0, 255}
    long = max(shapes, key=lambda x: x[2])
    ties = 0
    for variant, share in chip_smoke.D4_SHARE.items():
        case = next(k for k in chip_smoke.D4_CASES
                    if k[0] == long and k[1] == variant)
        kw = chip_smoke.d4_args(torch, case, "cpu")
        use, m, _ = tpf._intra_in_p_scan_plain(**kw)
        got = use.float().mean().item()
        if variant == "sparse":
            assert 0 < got < 0.05
        elif variant == "ties":
            ties += int((m.sad == kw["inter_sad"]).sum())
        else:
            assert got == pytest.approx(share, abs=0.1)
    assert ties >= long[0] * long[1]  # each lane's first tie at least


# Reads int32 lanes C qp qpc src_u8 d4 i44 lam8, then the source planes y
# u v (uint8 where src_u8, else int32), where d4 the int32 inter SAD and
# rec_inter y u v, and where i44 the 144 tap words; runs the kI44 instance
# where i44; writes every output in the entry's order.
HARNESS = r"""
#include <cuda_runtime.h>
#include <cstdio>
#include <vector>
#include "intra16_enc.cu"
template <typename T> bool rd(std::vector<T>& x) {
  return fread(x.data(), sizeof(T), x.size(), stdin) == x.size();
}
template <typename T> void wr(const std::vector<T>& x) {
  fwrite(x.data(), sizeof(T), x.size(), stdout);
}
int main() {
  int32_t h[8];
  if (fread(h, 4, 8, stdin) != 8) return 2;
  const int lanes = h[0], C = h[1], qp = h[2], qpc = h[3], u8 = h[4],
            d4 = h[5], i44 = h[6], lam8 = h[7];
  const size_t m = (size_t)lanes * C, es = u8 ? 1 : 4;
  std::vector<uint8_t> sy(256 * m * es), su(64 * m * es), sv(64 * m * es);
  std::vector<int32_t> isad(d4 ? m : 0), iy(d4 ? 256 * m : 0),
      iu(d4 ? 64 * m : 0), iv(d4 ? 64 * m : 0);
  std::vector<uint32_t> taps(i44 ? 144 : 0);
  if (!rd(sy) || !rd(su) || !rd(sv) || !rd(isad) || !rd(iy) || !rd(iu) ||
      !rd(iv) || !rd(taps))
    return 3;
  std::vector<int32_t> mode(m), cmode(m), cbl(m), cbc(m), sad(d4 ? m : 0);
  std::vector<uint8_t> use(d4 ? m : 0);
  std::vector<int16_t> dc(16 * m), ac(256 * m), cdc(8 * m), cac(120 * m),
      i4(d4 ? 0 : 16 * m);
  std::vector<uint8_t> ry8(d4 ? 0 : 256 * m), ru8(d4 ? 0 : 64 * m),
      rv8(d4 ? 0 : 64 * m);
  std::vector<int32_t> ry(d4 ? 256 * m : 0), ru(d4 ? 64 * m : 0),
      rv(d4 ? 64 * m : 0);
  auto p = [](auto& v) { return v.empty() ? nullptr : v.data(); };
  const Args args{sy.data(), su.data(), sv.data(), u8, p(isad), p(iy),
                  p(iu), p(iv), mode.data(), cmode.data(), cbl.data(),
                  cbc.data(), p(sad), p(use), dc.data(), ac.data(),
                  cdc.data(), cac.data(), p(i4), p(ry8), p(ru8), p(rv8),
                  p(ry), p(ru), p(rv), lanes, C, qp, qpc, p(taps), lam8};
  for (int b = 0; b < lanes; ++b)
    run_block_fibers(kThreads, b, [&] {
      if (i44)
        intra16_enc_kernel<true>(args);
      else
        intra16_enc_kernel<false>(args);
    });
  wr(mode), wr(cmode), wr(cbl), wr(cbc), wr(sad), wr(use), wr(dc), wr(ac);
  wr(cdc), wr(cac), wr(i4), wr(ry8), wr(ru8), wr(rv8), wr(ry), wr(ru);
  wr(rv);
  return 0;
}
"""


@pytest.fixture(scope="module")
def cpu_kernel(tmp_path_factory):
    """csrc/intra16_enc.cu (all but its launch entries) built with g++
    against the shims of cuda_threads.py: the kernel's own source, a
    lane's kThreads threads (its warps in their roles) as fibers
    (`run_block_fibers`), its shuffles, ballots and block barriers
    switching between them."""
    return cuda_threads.build(tmp_path_factory.mktemp("intra16_enc_cpu"),
                              HARNESS, os.path.dirname(SOURCE),
                              "intra16_enc_cpu")


def _run(exe, planes, qp, d4=None, i44=False):
    """K6's source on CPU threads: its outputs as a dict of numpy arrays
    (the K6Out names; recon rec_y, rec_u, rec_v), planes uint8 or int32
    [S, H, W] x 3; `i44`: the Intra_4x4 route (the kI44 instance, with
    the tap words and lam8 the router passes)."""
    s, h, w = planes[0].shape
    r, c = h // 16, w // 16
    m, u8 = s * r * c, planes[0].dtype == torch.uint8
    qpc = tif.T.chroma_qp_from_luma(qp)
    head = np.array([s * r, c, qp, qpc, u8, d4 is not None, i44,
                     tif._LAMBDA8[qp]], np.int32)
    ins = list(planes) + ([] if d4 is None else [d4[0], *d4[1]])
    if i44:
        ins.append(torch.from_numpy(I44.tap_words()))
    body = head.tobytes() + b"".join(
        x.contiguous().numpy().tobytes() for x in ins)
    out = subprocess.run([exe], input=body, capture_output=True,
                         check=True).stdout
    mb = (s, r, c)
    spec = [("mode", mb, np.int32), ("cmode", mb, np.int32),
            ("cbp_luma", mb, np.int32), ("cbp_chroma", mb, np.int32)]
    if d4 is not None:
        spec += [("sad", mb, np.int32), ("use", mb, np.uint8)]
    spec += [("luma_dc", (*mb, 16), np.int16),
             ("luma_ac", (*mb, 16, 16), np.int16),
             ("chroma_dc", (*mb, 2, 4), np.int16),
             ("chroma_ac", (*mb, 2, 4, 15), np.int16)]
    if d4 is None:
        spec += [("i4modes", (*mb, 16), np.int16),
                 ("rec_y", (s, h, w), np.uint8),
                 ("rec_u", (s, h // 2, w // 2), np.uint8),
                 ("rec_v", (s, h // 2, w // 2), np.uint8)]
    else:
        spec += [("rec_y", (*mb, 16, 16), np.int32),
                 ("rec_u", (*mb, 8, 8), np.int32),
                 ("rec_v", (*mb, 8, 8), np.int32)]
    got, off = {}, 0
    for name, shape, dt in spec:
        n = int(np.prod(shape)) * np.dtype(dt).itemsize
        got[name] = np.frombuffer(out[off:off + n], dt).reshape(shape)
        off += n
    assert off == len(out)
    return got


@pytest.mark.parametrize("case", chip_smoke.D3_CASES, ids=D3_IDS)
def test_kernel_source_on_cpu_threads_matches_plain_d3(cpu_kernel, case):
    """D3: the kernel's roles, butterflies, shuffle reductions and DC
    Hadamards, run a lane's 32 threads at a time, equal the plain I
    encode on the case, from uint8 and from int32 planes."""
    planes, qp = _frames(case)
    planes = [torch.from_numpy(p) for p in planes]
    sym, rec = tif._encode_iframe_scan_plain(*planes, qp)
    for src in (planes, [p.to(torch.int32) for p in planes]):
        got = _run(cpu_kernel, src, qp)
        for f in tif.MBSymbols._fields:
            _eq(got[f], getattr(sym, f).numpy(), f)
        for f, want in zip(("rec_y", "rec_u", "rec_v"), rec):
            _eq(got[f], want.numpy(), f)


@pytest.mark.parametrize("case", chip_smoke.D4_CASES, ids=D4_IDS)
def test_kernel_source_on_cpu_threads_matches_plain_d4(cpu_kernel, case):
    """D4: the same kernel with the inter choice equals the plain
    intra-in-P scan: the choice, every Intra16 field and the final
    reconstruction that chains into the next column."""
    kw = chip_smoke.d4_args(torch, case, "cpu")
    use, m, rec = tpf._intra_in_p_scan_plain(**kw)
    planes = [tif._mbs_to_plane(kw[k]).contiguous()
              for k in ("src_mbs", "u_mbs", "v_mbs")]
    got = _run(cpu_kernel, planes, kw["qp"], (kw["inter_sad"],
                                              kw["rec_inter"]))
    _eq(got["use"], use.numpy().astype(np.uint8), "use")
    for f in ("mode", "cmode", "sad", "cbp_luma", "cbp_chroma", "chroma_dc",
              "chroma_ac"):
        _eq(got[f], getattr(m, f).numpy(), f)
    _eq(got["luma_dc"], m.dc_zz.numpy(), "dc_zz")
    _eq(got["luma_ac"], m.ac_zz.reshape(got["luma_ac"].shape).numpy(),
        "ac_zz")
    for f, want in zip(("rec_y", "rec_u", "rec_v"), rec):
        _eq(got[f], want.numpy(), f)


# The algebra the kernel rests on (csrc/intra16_enc.cu, its note's 1.-6.),
# checked in plain torch with the port's transform.py on seeded blocks.


def _blocks(seed, n=4096):
    """Seeded source blocks [n, 4, 4] (0..255), DC predictions [n] and H
    prediction rows [n, 4] (0..255), int32."""
    rng = np.random.default_rng(seed)
    i32 = lambda x: torch.from_numpy(x.astype(np.int32))
    return (i32(rng.integers(0, 256, (n, 4, 4))), i32(rng.integers(0, 256, n)),
            i32(rng.integers(0, 256, (n, 4))))


def _vert(p):
    """forward4x4's vertical butterfly of columns p [..., 4]."""
    a0, a1 = p[..., 0] + p[..., 3], p[..., 1] + p[..., 2]
    a2, a3 = p[..., 1] - p[..., 2], p[..., 0] - p[..., 3]
    return torch.stack([a0 + a1, 2 * a3 + a2, a0 - a1, a3 - 2 * a2], -1)


@pytest.mark.parametrize("kind", ("dc", "h"))
def test_premise_transform_of_the_prediction(kind):
    """1.-3.: F(src - pred) == F(src) - F(pred) for DC and H predictions;
    a DC prediction's F is 16 pdc at raster 0, an H prediction's 4 v_r at
    rasters 0, 4, 8, 12 (v the vertical butterfly of its rows), and both
    are zero off those positions."""
    src, pdc, rows = _blocks(1)
    if kind == "dc":
        pred = pdc[:, None, None].expand(-1, 4, 4)
        want = torch.zeros_like(src)
        want[:, 0, 0] = 16 * pdc
    else:
        pred = rows[:, :, None].expand(-1, 4, 4)
        want = torch.zeros_like(src)
        want[:, :, 0] = 4 * _vert(rows)
    fp = T.forward4x4(pred)
    assert torch.equal(T.forward4x4(src - pred), T.forward4x4(src) - fp)
    assert torch.equal(fp, want)


def _row_pass(d):
    """inverse4x4's row pass of [..., 4, 4] (each row: d0 .. d3)."""
    d0, d1, d2, d3 = d.unbind(-1)
    e0, e1 = d0 + d2, d0 - d2
    e2, e3 = (d1 >> 1) - d3, d1 + (d3 >> 1)
    return torch.stack([e0 + e3, e1 + e2, e1 - e2, e0 - e3], -1)


def _col_pass(f):
    """inverse4x4's column pass of [..., 4, 4]."""
    return _row_pass(f.transpose(-1, -2)).transpose(-1, -2)


@pytest.mark.parametrize("qp", range(52))
def test_premise_row_pass_and_right_column(qp):
    """5.-6. at every QP: with the block's levels quantised and
    dequantised (and a dequantised DC in raster 0), inverse4x4 is the
    column pass of d0_r + P[r][x], P the row pass with d0 = 0; so the
    final right column is the column pass of d0_r + K_r, K_r = d2 - d1 -
    (d3 >> 1), and each of its rows is f0 + D_r, D_r off f0.  And the DC
    Hadamards: only column j = 0 of H (S - c) depends on the
    prediction, by 256 pdc at (0, 0) (DC) or 16 (H L)_i (H); chroma's 2x2
    by 2 (s a)_i."""
    src, pdc, rows = _blocks(100 + qp)
    pred = rows[:, :, None].expand(-1, 4, 4)
    w = T.forward4x4(src - pred)
    z = T.quant4x4(w, qp, intra=True).reshape(-1, 16)
    d = T.dequant_flat(z, qp).reshape(-1, 4, 4).clone()
    d[:, 0, 0] = w[:, 0, 0]  # any DC value
    p0 = d.clone()
    p0[..., 0] = 0
    parts = d[..., 0:1] + _row_pass(p0)
    assert torch.equal(T.inverse4x4(d), _col_pass(parts))
    rec = torch.clamp(pred + ((T.inverse4x4(d) + 32) >> 6), 0, 255)
    k = d[..., 2] - d[..., 1] - (d[..., 3] >> 1)
    f = d[..., 0] + k
    right = torch.clamp(rows + ((_col_pass(f[..., None].expand(-1, 4, 4))
                                 [..., 0] + 32) >> 6), 0, 255)
    assert torch.equal(rec[..., 3], right)
    no_f0 = _col_pass(torch.cat([torch.zeros_like(f[:, :1]), f[:, 1:]], 1)
                      [..., None].expand(-1, 4, 4))[..., 0]
    assert torch.equal(_col_pass(f[..., None].expand(-1, 4, 4))[..., 0],
                       f[:, :1] + no_f0)
    s = src.reshape(-1, 4, 4, 4, 4).sum((-1, -2), dtype=torch.int32)[:64]
    lb = rows.reshape(-1, 4, 4).sum(-1, dtype=torch.int32)[:64, :4]
    dc = pdc[:64, None, None]
    hs = T.hadamard4x4(s)
    want = hs.clone()
    want[:, 0, 0] -= 256 * pdc[:64]
    assert torch.equal(T.hadamard4x4(s - 16 * dc), want)
    want = hs.clone()
    want[:, :, 0] -= 16 * T.hadamard4x4(lb[:, :, None].expand(-1, 4, 4))[
        :, :, 0] // 4
    assert torch.equal(T.hadamard4x4(s - 4 * lb[:, :, None]), want)
    c = s[:, :2, :2]
    a = rows[:64, :2]
    want = T.hadamard2x2(c).clone()
    want[:, 0, 0] -= 2 * (a[:, 0] + a[:, 1])
    want[:, 1, 0] -= 2 * (a[:, 0] - a[:, 1])
    assert torch.equal(T.hadamard2x2(c - a[:, :, None]), want)


def _refuse():
    raise AssertionError("the kernel library was loaded for CPU tensors")


def test_cpu_tensors_never_reach_the_kernel(monkeypatch):
    """On CPU tensors both routers (and the I and P encodes through them)
    take the plain versions: the kernel library is never loaded and the
    launch counters do not move."""
    monkeypatch.setattr(cuda_lib, "load", _refuse)
    before = (tif.encode_iframe_scan.launches,
              tpf._intra_in_p_scan.launches)
    planes, qp = _frames(chip_smoke.D3_CASES[6])
    planes = [torch.from_numpy(p) for p in planes]
    got = tif.encode_iframe_scan(*planes, qp)
    want = tif._encode_iframe_scan_plain(*planes, qp)
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, b)
    kw = chip_smoke.d4_args(torch, chip_smoke.D4_CASES[7], "cpu")
    got = tpf._intra_in_p_scan(**kw)
    want = tpf._intra_in_p_scan_plain(**kw)
    assert torch.equal(got[0], want[0])
    cur, ref = _p_frames((2, 2, 3), 1)
    tpf.encode_pframe_rows_multi(*map(torch.from_numpy, cur),
                                 *map(torch.from_numpy, ref), 28)
    assert (tif.encode_iframe_scan.launches,
            tpf._intra_in_p_scan.launches) == before


def test_intra44_calls_reach_the_kernel(monkeypatch):
    """With `intra44` a tensor off the CPU never reaches the plain version:
    past the device checks the router reaches K6's Intra_4x4 entry with
    the tap words and lam8 = _LAMBDA8[qp] and counts a launch of the
    route; CPU tensors still take the plain version without loading the
    kernel library; on a device the kernel cannot take, or at a QP outside
    0..51, the router raises before any launch, and so does D4's router
    (`_intra_in_p_scan`) on a device the kernel cannot take."""
    def refuse(*a, **kw):
        raise AssertionError("the plain version ran off the CPU")

    # CPU tensors: the plain version, by the device alone
    monkeypatch.setattr(cuda_lib, "load", _refuse)
    planes, qp = _frames(chip_smoke.D3_CASES[6])
    planes = [torch.from_numpy(p) for p in planes]
    before = (tif.encode_iframe_scan.launches,
              tif.encode_iframe_scan.i44_launches)
    got = tif.encode_iframe_scan(*planes, qp, intra44=True)
    want = tif._encode_iframe_scan_plain(*planes, qp, True)
    for a, b in zip((*got[0], *got[1]), (*want[0], *want[1])):
        assert torch.equal(a, b)
    assert (tif.encode_iframe_scan.launches,
            tif.encode_iframe_scan.i44_launches) == before
    # off the CPU: never the plain version; a bad device or QP raises
    monkeypatch.setattr(tif, "_encode_iframe_scan_plain", refuse)
    meta = [torch.zeros(sh, dtype=torch.uint8, device="meta")
            for sh in ((2, 32, 48), (2, 16, 24), (2, 16, 24))]
    for bad_qp in (30, 52, -1):
        with pytest.raises(ValueError):
            tif.encode_iframe_scan(*meta, bad_qp, intra44=True)
    # D4's router likewise: off the CPU it raises, never the plain version
    monkeypatch.setattr(tpf, "_intra_in_p_scan_plain", refuse)
    kw = {k: (x.to("meta") if torch.is_tensor(x) else
              tuple(p.to("meta") for p in x) if isinstance(x, tuple) else x)
          for k, x in chip_smoke.d4_args(
              torch, chip_smoke.D4_CASES[7], "cpu").items()}
    with pytest.raises(ValueError):
        tpf._intra_in_p_scan(**kw)
    # past the device checks (meta tensors standing in for the card's)
    calls = []

    class Lib:
        def __getattr__(self, name):
            return lambda *a: calls.append((name, a)) or 0

    taps = torch.from_numpy(I44.tap_words())
    monkeypatch.setattr(cuda_lib, "load", Lib)
    monkeypatch.setattr(cuda_lib, "check_inputs", lambda *a, **k: None)
    monkeypatch.setattr(cuda_lib, "stream", lambda dev: None)
    monkeypatch.setattr(tif.tables, "get", lambda name, dev: (
        taps if name == "i44_taps" else None))
    for qp in (0, 30, 51):
        tif.encode_iframe_scan(*meta, qp, intra44=True)
        name, args = calls[-1]
        assert name == "th264_intra44_encode_rows"
        # lanes, columns, QPs, then the tap words and lam8, then the stream
        assert args[16:] == (2 * 2, 3, qp, T.chroma_qp_from_luma(qp),
                             taps.data_ptr(), tif._LAMBDA8[qp], None)
    tif.encode_iframe_scan(*meta, 30)
    assert calls[-1][0] == "th264_intra16_encode_rows"
    assert (tif.encode_iframe_scan.launches,
            tif.encode_iframe_scan.i44_launches) == (before[0] + 4,
                                                     before[1] + 3)


# -- the Intra_4x4 route (`intra44`, the kI44 instance) ----------------------

# each D3_I44 case and the level case from uint8 and from int32 planes
I44_RUNS = [(case, dt) for case in chip_smoke.D3_I44_CASES
            + [chip_smoke.D3_I44_LEVEL_CASE] for dt in ("uint8", "int32")]
_PLAIN44 = {}


def _i44_planes(case, dtype="uint8"):
    y, u, v, qp = chip_smoke.d3_i44_case(np, *case)
    return [torch.from_numpy(p).to(getattr(torch, dtype))
            for p in (y, u, v)], qp


def _plain44(case):
    """`_encode_iframe_scan_plain(intra44=True)` of a D3_I44 case (its
    symbols and recon), once a module."""
    if case not in _PLAIN44:
        planes, qp = _i44_planes(case)
        _PLAIN44[case] = tif._encode_iframe_scan_plain(*planes, qp, True)
    return _PLAIN44[case]


def _equal44(got, case):
    sym, rec = _plain44(case)
    return (all(np.array_equal(got[f], getattr(sym, f).numpy())
                for f in tif.MBSymbols._fields)
            and all(np.array_equal(got[f], w.numpy())
                    for f, w in zip(("rec_y", "rec_u", "rec_v"), rec)))


@pytest.mark.parametrize("case,dtype", I44_RUNS, ids=str)
def test_i44_source_on_cpu_threads_matches_plain(cpu_kernel, case, dtype):
    """The Intra_4x4 route's source on CPU threads (the two trial warps'
    10 dependency levels a column, a warp a block, meeting at a named
    barrier after a level: neighbours from the MB's samples in shared
    memory, DC and the predictions from the packed ring of neighbours
    two modes a pass, packed SAD reductions, the first least available
    mode, the transforms by shuffles; the luma warp's Intra_16x16
    candidate with its SSD and rate, the named barrier, the choice and
    the stores) equals
    `_encode_iframe_scan_plain(intra44=True)` on every field and plane."""
    planes, qp = _i44_planes(case, dtype)
    got = _run(cpu_kernel, planes, qp, i44=True)
    sym, rec = _plain44(case)
    for f in tif.MBSymbols._fields:
        _eq(got[f], getattr(sym, f).numpy(), f)
    for f, want in zip(("rec_y", "rec_u", "rec_v"), rec):
        _eq(got[f], want.numpy(), f)


def test_i44_source_matches_jax(cpu_kernel):
    """The route's source on CPU threads equals JAX's
    `encode_iframe_scan(intra44=True)` on a case where Intra_4x4 wins a
    share of the MBs."""
    case = ((2, 4, 2), "stripes", 28)
    planes, qp = _i44_planes(case)
    jsym, jrec = jif.encode_iframe_scan(*(p.numpy() for p in planes), qp,
                                        intra44=True)
    got = _run(cpu_kernel, planes, qp, i44=True)
    assert 0 < (got["mode"] == 4).mean() < 1
    for f in tif.MBSymbols._fields:
        _eq(np.asarray(getattr(jsym, f)), got[f], f)
    for a, f in zip(jrec, ("rec_y", "rec_u", "rec_v")):
        _eq(np.asarray(a), got[f], f)


def _j_ties(case):
    """The MBs of a D3_I44 case whose J = 8 SSD + lam8 rate is the same for
    Intra_16x16 and Intra_4x4 (recomputed beside the plain scan's own
    choice, `_intra44_choice`, from its arguments)."""
    ties, real = [], tif._intra44_choice

    def spy(m, ymb, left_y, first, qp):
        lead = ymb.shape[:2]
        left = torch.zeros((*lead, 16), dtype=torch.int32) if first else left_y
        _, _, coef, _, rec = I44.encode_mb(ymb, left, torch.full(
            lead, not first), qp)
        ssd = lambda r: ((r - ymb) ** 2).sum((-1, -2))
        j16 = 8 * ssd(m.rec[0]) + tif._LAMBDA8[qp] * (
            8 + tif._rate_bits(m.dc_zz, (-1,))
            + tif._rate_bits(m.ac_zz, (-1, -2, -3)))
        j44 = 8 * ssd(rec) + tif._LAMBDA8[qp] * (
            96 + tif._rate_bits(coef, (-1, -2)))
        ties.append(int((j16 == j44).sum()))
        return real(m, ymb, left_y, first, qp)

    tif._intra44_choice = spy
    try:
        planes, qp = _i44_planes(case)
        tif._encode_iframe_scan_plain(*planes, qp, True)
    finally:
        tif._intra44_choice = real
    return sum(ties)


def test_i44_cases_cover_what_they_claim():
    """D3_I44_CASES: C = 1, 2, 3 and 61; every content meets every QP;
    Intra_4x4 wins a share strictly between 0 and
    1 of some case's MBs, and an MB of column 0; every mode 0-8 is chosen
    somewhere; an exact J tie (Intra_16x16 must win it) in a small case.
    No case can tell a level's bit length capped at 16 from 32 - clz:
    every level is below 2^13 (an Intra_4x4 level at most (36 * 255 *
    5243 + 2^15 / 3) >> 15, a luma DC level (16 * 4080 * 13107 + 2^17 /
    3) >> 17)."""
    assert {c for _, _, c in chip_smoke.D3_I44_SHAPES} == {1, 2, 3, 61}
    assert {(c, q) for _, c, q in chip_smoke.D3_I44_CASES} == {
        (c, q) for c in chip_smoke.D3_I44_CONTENT
        for q in chip_smoke.D3_I44_QPS}
    shares, modes, col0 = [], set(), False
    for case in chip_smoke.D3_I44_CASES:
        sym, _ = _plain44(case)
        i4 = sym.mode == 4
        shares.append(i4.float().mean().item())
        modes |= set(sym.i4modes[i4].unique().tolist())
        col0 |= bool(i4[..., 0].any())
        assert (sym.i4modes[~i4] == -1).all()
        assert (sym.luma_dc[i4] == 0).all()
        for f in ("luma_dc", "luma_ac"):
            assert getattr(sym, f).abs().max() < 1 << 13
    assert any(0 < x < 1 for x in shares) and col0
    assert modes == set(range(9))
    assert _j_ties(chip_smoke.D3_I44_CASES[0]) > 0


def test_i44_level_case_covers_what_it_claims():
    """D3_I44_LEVEL_CASE: Intra_4x4 wins a share of the MBs, and in at
    least 8 of them the two blocks of every two-block level take different
    modes (each level's in at least 80% of them)."""
    sym, _ = _plain44(chip_smoke.D3_I44_LEVEL_CASE)
    i4 = sym.mode == 4
    m = sym.i4modes[i4]
    differ = torch.stack([m[:, a] != m[:, b]
                          for a, b in chip_smoke.I44_LEVEL_PAIRS], -1)
    assert 0 < i4.float().mean() < 1
    assert int(differ.all(-1).sum()) >= 8
    assert (differ.float().mean(0) >= 0.8).all()


# mutants of the Intra_4x4 route, each a replacement in a source (or a
# tuple of them, test_torch_intra_recon.edit): J's strict comparison
# (Intra_16x16 wins a tie) made <=; the last of tied modes winning; TR
# real where `_static_tr_kind` repeats T3; i4modes stored in raster
# order; slot 0 of an Intra_4x4 block's levels zeroed; block 4 one level
# early, beside block 1 (the table's static_assert taken out, which would
# refuse it); no hand-off between levels (the two trial warps' named
# barrier a warp barrier)
I44_MUTANTS = {
    "J tie to Intra_4x4": (
        "intra16_enc.cu",
        "8 * tr.ssd + a.lam8 * tr.rate < 8 * ssd16 + a.lam8 * r16",
        "8 * tr.ssd + a.lam8 * tr.rate <= 8 * ssd16 + a.lam8 * r16"),
    "last tied mode": (
        "intra44_common.cuh",
        ("(s.w[j] << 4) | (unsigned)(2 * j) |",
         "? (unsigned)(2 * j + 1) << 16",
         "return (int)min(m & 0xffffu, m >> 16) & 15;"),
        ("(s.w[j] << 4) | (unsigned)(8 - 2 * j) |",
         "? (unsigned)(7 - 2 * j) << 16",
         "return 8 - ((int)min(m & 0xffffu, m >> 16) & 15);")),
    "TR real where repeated": (
        "intra44_common.cuh",
        "  return blk_y(bi) > 0 && blk_x(bi) < 3 &&\n"
        "         blk_z(blk_x(bi) + 1, blk_y(bi) - 1) < bi;",
        "  return blk_y(bi) > 0 && blk_x(bi) < 3;"),
    "i4modes in raster order": (
        "intra16_enc.cu", "tr.modes[bi] = (int16_t)best;",
        "tr.modes[4 * by + bx] = (int16_t)best;"),
    "slot 0 zeroed": (
        "intra16_enc.cu", "tr.coef[4 * by + bx][ln.slot] = (int16_t)z;",
        "tr.coef[4 * by + bx][ln.slot] = (int16_t)(ln.slot ? z : 0);"),
    "block 4 beside block 1": (
        "intra44_common.cuh",
        (K5T.LEVEL_TABLE_EDIT[0], "static_assert(i44_levels_hold(),"),
        (K5T.LEVEL_TABLE_EDIT[1], "static_assert(true || i44_levels_hold(),")),
    "no hand-off between levels": (
        "intra16_enc.cu", "void level_sync() { bar_wait(2, 64); }",
        "void level_sync() { __syncwarp(); }"),
}


@pytest.fixture(scope="module")
def i44_mutants(tmp_path_factory):
    """The I44_MUTANTS, each a copy of csrc with its replacement, built
    all at once (the directories made first: tmp_path_factory is not
    thread-safe)."""
    csrc = os.path.dirname(SOURCE)
    jobs = []
    for name, (src, old, new) in I44_MUTANTS.items():
        d = tmp_path_factory.mktemp("k6_i44_mutant_src")
        for f in os.listdir(csrc):
            with open(os.path.join(csrc, f)) as fh:
                text = fh.read()
            if f == src:
                text = K5T.edit(text, old, new)
            (d / f).write_text(text)
        jobs.append((name, tmp_path_factory.mktemp("k6_i44_mutant"), str(d)))

    def one(job):
        name, out, csrc = job
        return name, cuda_threads.build(out, HARNESS, csrc, "k6_i44_mutant")

    with concurrent.futures.ThreadPoolExecutor(len(jobs)) as ex:
        return dict(ex.map(one, jobs))


@pytest.mark.parametrize("name", I44_MUTANTS)
def test_i44_mutants_fail(i44_mutants, name):
    """Each mutant of the Intra_4x4 route differs from the plain version
    on some case of D3_I44_CASES."""
    for case in chip_smoke.D3_I44_CASES:
        planes, qp = _i44_planes(case)
        if not _equal44(_run(i44_mutants[name], planes, qp, i44=True), case):
            return
    pytest.fail(f"mutant {name!r} passed every case")
