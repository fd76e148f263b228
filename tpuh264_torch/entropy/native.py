"""ctypes binding to the port's copy of the native CAVLC engine
(`tpuh264_torch/native/cavlc.cpp`, a copy of native/cavlc.cpp).

Mirrors tpuh264/entropy/native.py, with its signatures:
`parse_dispatch_compact` (the decode-from-bits front end), `pack_iframe`
/ `pack_pframe` (the sessions' packers, and the host packer of an
overflowing dispatch), `parse_iframe` / `parse_pframe_slices` (the
sessions' parsers), `escape_rbsp` / `unescape_rbsp`, and `MB_SLOTS`.
There is no fallback to a Python coder: the engine builds or raises.

The library is built with g++ at first use into `tpuh264_torch/build/`
(git-ignored, see libbuild.py), against `cavlc_tables.inc` generated
there from the port's own `entropy/cavlc_tables.py` (as
native/gen_tables.py does for the original).  A failed build raises.
"""

from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .. import libbuild
from ..core import nal
from ..core.bitstream import BitReader, BitWriter
from ..core.params import PPS, SPS, param_sets
from ..core.sliceheader import SLICE_I, SLICE_P, SliceHeader
from . import cavlc_tables as tbl

SRC = os.path.join(os.path.dirname(libbuild.BUILD), "native", "cavlc.cpp")
BUILD = libbuild.BUILD
LIB = os.path.join(BUILD, "libtpuh264_native.so")
INC = os.path.join(BUILD, "cavlc_tables.inc")

_lock = threading.Lock()
_lib = None

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_I16P = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
_I64P = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")

# per-MB slot layout of the compact coefficient records emitted by
# th264_parse_dispatch_compact: the virtual dense tensor is [F, N_mb, 400]
# = [luma DC 16 | luma AC 16x16 | chroma DC 2x4 | chroma AC 2x4x15]
MB_SLOTS = 400


def _tables_inc() -> str:
    """The C tables of cavlc.cpp, from the port's cavlc_tables (the
    output of native/gen_tables.py for the same tables)."""
    row = lambda xs: ",".join(str(int(x)) for x in xs)
    out = ["// generated by tpuh264_torch/entropy/native.py -- do not edit",
           "static const int32_t COEFF_TOKEN[5][17][4] = {"]
    ct = tbl.coeff_token_dense()
    for ctx in range(5):
        out.append("  {" + "".join("{" + row(ct[ctx, tc]) + "},"
                                   for tc in range(17)) + "},")
    out.append("};")
    out.append("static const int32_t TOTAL_ZEROS_T[15][16] = {")
    out += ["  {" + row(r) + "}," for r in tbl.total_zeros_dense()]
    out.append("};")
    out.append("static const int32_t TZ_CHROMA[3][4] = {")
    for r in tbl.TOTAL_ZEROS_CHROMA_DC:
        packed = [(ln << 16) | bits for ln, bits in r]
        out.append("  {" + row(packed + [0] * (4 - len(packed))) + "},")
    out.append("};")
    out.append("static const int32_t RUN_BEFORE_T[7][15] = {")
    out += ["  {" + row(r) + "}," for r in tbl.run_before_dense()]
    out.append("};")
    for name, fwd, inv in (("INTER", tbl.CBP_INTER, tbl.CBP_INTER_INV),
                           ("INTRA", tbl.CBP_INTRA, tbl.CBP_INTRA_INV)):
        dense = [0] * 64
        for cbp, code in inv.items():
            dense[cbp] = code
        out.append(f"static const int CBP_{name}_TAB[48] = {{{row(fwd)}}};")
        out.append(f"static const int CBP_{name}_INV[64] = {{{row(dense)}}};")
    return "\n".join(out) + "\n"


def _stale(inc_text: str) -> bool:
    """True when LIB is missing, older than the source, or was built
    against other tables than cavlc_tables gives now."""
    return libbuild.stale(LIB, INC, inc_text, [SRC])


def _command(out: str) -> list:
    return [os.environ.get("CXX", "g++"), "-O3", "-fPIC", "-std=c++17",
            "-pthread", "-shared", "-I", BUILD, "-o", out, SRC]


def load() -> ctypes.CDLL:
    """The engine library, built first if it is missing or stale."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        libbuild.ensure(LIB, INC, _tables_inc(), [SRC], _command)
        lib = ctypes.CDLL(LIB)
        for fn in (lib.th264_escape, lib.th264_unescape):
            fn.restype = ctypes.c_int64
            fn.argtypes = [_U8P, ctypes.c_int64, _U8P, ctypes.c_int64]
        lib.th264_pack_frame.restype = ctypes.c_int64
        lib.th264_pack_frame.argtypes = [
            _U8P, _I64P, _I32P,
            ctypes.c_int32, _I32P, _I32P,
            ctypes.c_uint8, ctypes.c_int32,
            _I32P, _I16P, _I16P, _I16P, _I16P,
            _I32P, _I32P, _I32P,
            _I16P, _I32P,
            _U8P, ctypes.c_int64, ctypes.c_int32,
        ]
        lib.th264_parse_dispatch_compact.restype = ctypes.c_int64
        lib.th264_parse_dispatch_compact.argtypes = [
            _U8P, _I64P, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32,
            _I32P,
            _I32P, _I16P, ctypes.c_int64,
            _I32P, _I16P, ctypes.c_int64,
            _I64P, ctypes.c_int32,
        ]
        lib.th264_pack_slice_p.restype = ctypes.c_int64
        lib.th264_pack_slice_p.argtypes = [
            _U8P, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _I32P, _I16P, _I16P, _I16P, _I16P,
            _I32P, _I32P, _I32P, ctypes.c_int32,
            _U8P, ctypes.c_int64,
        ]
        lib.th264_parse_frame.restype = ctypes.c_int64
        lib.th264_parse_frame.argtypes = [
            _U8P, _I64P, _I64P, _I64P, _I32P,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _I32P, _I16P, _I16P, _I16P, _I16P,
            _I32P, _I32P, _I32P,
            _I16P, _I32P, ctypes.c_int32,
        ]
        lib.th264_parse_slice_p.restype = ctypes.c_int64
        lib.th264_parse_slice_p.argtypes = [
            _U8P, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32,
            _I32P, _I16P, _I16P, _I16P, _I16P,
            _I32P, _I32P, _I32P, ctypes.c_int32,
        ]
        _lib = lib
        return lib


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (H.264 7.4.1.1)."""
    src = np.frombuffer(rbsp, np.uint8)
    out = np.empty(len(rbsp) * 3 // 2 + 16, np.uint8)
    n = load().th264_escape(src, len(src), out, len(out))
    if n < 0:
        raise RuntimeError("th264_escape failed")
    return out[:n].tobytes()


def unescape_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation_prevention_three_byte sequences."""
    src = np.frombuffer(ebsp, np.uint8)
    out = np.empty(len(ebsp) + 16, np.uint8)
    n = load().th264_unescape(src, len(src), out, len(out))
    if n < 0:
        raise RuntimeError("th264_unescape failed")
    return out[:n].tobytes()


def _mb_arrays(n_mb: int, n_info: int, mb_info, luma_dc, luma_ac,
               chroma_dc, chroma_ac):
    """The per-MB symbol arrays as the C engine reads them (contiguous,
    int32 info, int16 levels), after checking their sizes against the
    frame, since the engine trusts them; then zeroed nnz scratch."""
    arrs = [np.ascontiguousarray(mb_info, np.int32)] + [
        np.ascontiguousarray(a, np.int16)
        for a in (luma_dc, luma_ac, chroma_dc, chroma_ac)]
    for a, per in zip(arrs, (n_info, 16, 256, 8, 120)):
        if a.size != n_mb * per:
            raise ValueError(f"symbol array of {a.size} values for "
                             f"{n_mb} MBs x {per}")
    return arrs + [np.zeros(16 * n_mb, np.int32), np.zeros(4 * n_mb, np.int32),
                   np.zeros(4 * n_mb, np.int32)]


def _slice_qp_delta(qp: int, pps: PPS) -> int:
    return qp - 26 - pps.pic_init_qp_minus26


def _slices(slice_mode: str, mbw: int, mbh: int) -> list:
    """(first MB, MB count) of every slice: one per MB row, or one."""
    if slice_mode == "rows":
        return [(r * mbw, mbw) for r in range(mbh)]
    if slice_mode == "single":
        return [(0, mbw * mbh)]
    raise ValueError(slice_mode)


def pack_iframe(mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                sps: SPS, pps: PPS, qp: int, slice_mode: str = "rows",
                frame_num: int = 0, idr: bool = True, include_ps: bool = True,
                deblock_idc: int = 1, threads: int = 0,
                i4modes=None) -> bytes:
    """Annex-B bytes of one I access unit (SPS and PPS first where
    `include_ps`), one slice per MB row or a single slice:
    tpuh264.entropy.native.pack_iframe.  mb_info [N, 4] = (mode, cmode,
    cbp_luma, cbp_chroma), mode 4 = Intra_4x4 with its block modes in
    i4modes [N, 16].  threads=0: one per CPU."""
    lib = load()
    mbw, mbh = sps.mb_width, sps.mb_height
    n_mb = mbw * mbh
    arrs = _mb_arrays(n_mb, 4, mb_info, luma_dc, luma_ac, chroma_dc,
                      chroma_ac)
    i4modes = (np.zeros((n_mb, 16), np.int16) if i4modes is None
               else np.ascontiguousarray(i4modes, np.int16))
    if i4modes.size != 16 * n_mb:
        raise ValueError(f"i4modes of {i4modes.size} values for {n_mb} MBs")
    i4ctx = np.full(16 * n_mb, -1, np.int32)
    slices = _slices(slice_mode, mbw, mbh)
    headers = bytearray()
    header_off = np.zeros(len(slices), np.int64)
    header_bits = np.zeros(len(slices), np.int32)
    for i, (start, _) in enumerate(slices):
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=start, slice_type=SLICE_I,
            frame_num=frame_num, slice_qp_delta=_slice_qp_delta(qp, pps),
            disable_deblocking_filter_idc=deblock_idc,
        ).write(w, sps, pps, idr)
        header_off[i] = len(headers)
        header_bits[i] = w.bit_length
        w.u((8 - w.bit_length % 8) % 8, 0)
        headers += w.get_bytes()
    starts = np.asarray([st for st, _ in slices], np.int32)
    counts = np.asarray([ct for _, ct in slices], np.int32)
    ntype = nal.NAL_SLICE_IDR if idr else nal.NAL_SLICE_NON_IDR
    cap = 4096 * len(slices) + n_mb * 1400
    buf = np.empty(cap, np.uint8)
    n = lib.th264_pack_frame(
        np.frombuffer(bytes(headers), np.uint8), header_off, header_bits,
        len(slices), starts, counts, (3 << 5) | ntype, mbw, *arrs,
        i4modes, i4ctx, buf, cap, threads if threads > 0
        else (os.cpu_count() or 1))
    if n < 0:
        raise RuntimeError("th264_pack_frame failed")
    ps = param_sets(sps, pps) if include_ps else b""
    return ps + buf[:n].tobytes()


def pack_pframe(mb_info, luma_dc, luma_ac, chroma_dc, chroma_ac,
                sps: SPS, pps: PPS, qp: int, slice_mode: str = "rows",
                frame_num: int = 1, deblock_idc: int = 1, ref: bool = True,
                num_ref_active: int = 1) -> bytes:
    """Annex-B bytes of one P frame, one slice per MB row or a single
    slice, a reference picture or not (`ref`, nal_ref_idc 2 / 0):
    tpuh264.entropy.native.pack_pframe.  mb_info [N, 8] = (kind, mode,
    cmode, cbp_luma, cbp_chroma, mvdx, mvdy, refidx)."""
    lib = load()
    mbw, mbh = sps.mb_width, sps.mb_height
    arrs = _mb_arrays(mbw * mbh, 8, mb_info, luma_dc, luma_ac, chroma_dc,
                      chroma_ac)
    out = bytearray()
    cap = 4096 + mbw * mbh * 1400
    buf = np.empty(cap, np.uint8)
    nal_hdr = bytes([((2 if ref else 0) << 5) | nal.NAL_SLICE_NON_IDR])
    for start, count in _slices(slice_mode, mbw, mbh):
        w = BitWriter()
        SliceHeader(
            first_mb_in_slice=start, slice_type=SLICE_P,
            frame_num=frame_num % (1 << (sps.log2_max_frame_num_minus4 + 4)),
            slice_qp_delta=_slice_qp_delta(qp, pps),
            disable_deblocking_filter_idc=deblock_idc,
            num_ref_idx_l0_active_minus1=num_ref_active - 1,
        ).write(w, sps, pps, idr=False, ref=ref)
        header_bits = w.bit_length
        w.u((8 - header_bits % 8) % 8, 0)
        header = np.frombuffer(w.get_bytes(), np.uint8)
        n = lib.th264_pack_slice_p(header, header_bits, start, count, mbw,
                                   *arrs, num_ref_active, buf, cap)
        if n < 0:
            raise RuntimeError("th264_pack_slice_p failed")
        out += nal.START_CODE + nal_hdr + escape_rbsp(buf[:n].tobytes())
    return bytes(out)


def _check_starts(first_mbs, n_mb: int) -> None:
    """The engine trusts the slices' first MB addresses: they must rise
    and stay inside the frame, or a corrupt header would send it past
    the arrays."""
    if any(not 0 <= f < n_mb for f in first_mbs) or any(
            b <= a for a, b in zip(first_mbs, first_mbs[1:])):
        raise RuntimeError(f"slice first_mb {list(first_mbs)} invalid for "
                           f"{n_mb} MBs")


def parse_iframe(data: bytes, threads: int = 0):
    """Entropy decode of one I access unit (annex-B, with its SPS and PPS):
    (sps, pps, qp, mb_info [N, 4] int32, luma_dc [N, 16], luma_ac [N, 16,
    16], chroma_dc [N, 2, 4], chroma_ac [N, 2, 4, 15], i4modes [N, 16]
    (-1 outside Intra_4x4 MBs)) int16, as tpuh264.entropy.native.parse_iframe.
    A stream it cannot parse raises RuntimeError."""
    lib = load()
    sps = pps = None
    qp = 26
    slices = []  # (rbsp bytes, start bit, first MB)
    for _, ntype, rbsp in nal.split_annexb(data):
        if ntype == nal.NAL_SPS:
            sps = SPS.parse(BitReader(rbsp))
        elif ntype == nal.NAL_PPS:
            pps = PPS.parse(BitReader(rbsp))
        elif ntype in (nal.NAL_SLICE_IDR, nal.NAL_SLICE_NON_IDR):
            if sps is None or pps is None:
                raise RuntimeError("slice before its SPS / PPS")
            r = BitReader(rbsp)
            header = SliceHeader.parse(r, sps, pps,
                                       ntype == nal.NAL_SLICE_IDR)
            qp = 26 + pps.pic_init_qp_minus26 + header.slice_qp_delta
            slices.append((rbsp, r.bit_position, header.first_mb_in_slice))
    if not slices:
        raise RuntimeError("no slice in the access unit")
    mbw, mbh = sps.mb_width, sps.mb_height
    n = mbw * mbh
    _check_starts([f for _, _, f in slices], n)
    arrays = (np.zeros((n, 4), np.int32), np.zeros((n, 16), np.int16),
              np.zeros((n, 16, 16), np.int16), np.zeros((n, 2, 4), np.int16),
              np.zeros((n, 2, 4, 15), np.int16))
    nnz = (np.zeros(16 * n, np.int32), np.zeros(4 * n, np.int32),
           np.zeros(4 * n, np.int32))
    i4m = np.full((n, 16), -1, np.int16)
    i4ctx = np.full(16 * n, -1, np.int32)
    lens = np.asarray([len(rb) for rb, _, _ in slices], np.int64)
    off = np.zeros(len(slices), np.int64)
    np.cumsum(lens[:-1], out=off[1:])
    got = lib.th264_parse_frame(
        np.frombuffer(b"".join(rb for rb, _, _ in slices), np.uint8), off,
        lens, np.asarray([b for _, b, _ in slices], np.int64),
        np.asarray([f for _, _, f in slices], np.int32), len(slices), mbw, n,
        *arrays, *nnz, i4m, i4ctx, threads if threads > 0
        else (os.cpu_count() or 1))
    if got < 0:
        raise RuntimeError("th264_parse_frame failed")
    return (sps, pps, qp) + arrays + (i4m,)


def parse_pframe_slices(slices, sps: SPS, pps: PPS, nra: int = 1):
    """Entropy decode of one P frame's slices [(rbsp, start bit, first
    MB)] -> (mb_info [N, 8] int32, luma_dc, luma_ac, chroma_dc, chroma_ac
    int16), as tpuh264.entropy.native.parse_pframe_slices."""
    lib = load()
    mbw, mbh = sps.mb_width, sps.mb_height
    n = mbw * mbh
    _check_starts([f for _, _, f in slices], n)
    out = (np.zeros((n, 8), np.int32), np.zeros((n, 16), np.int16),
           np.zeros((n, 16, 16), np.int16), np.zeros((n, 2, 4), np.int16),
           np.zeros((n, 2, 4, 15), np.int16))
    nnz = (np.zeros(16 * n, np.int32), np.zeros(4 * n, np.int32),
           np.zeros(4 * n, np.int32))
    for rbsp, start_bit, first_mb in slices:
        rb = np.frombuffer(rbsp, np.uint8)
        got = lib.th264_parse_slice_p(rb, len(rb), start_bit, first_mb, mbw,
                                      n - first_mb, *out, *nnz, nra)
        if got < 0:
            raise RuntimeError("th264_parse_slice_p failed")
    return out


def parse_dispatch_compact(frames, mbw: int, mbh: int, sps: SPS, pps: PPS,
                           cap_mb: int = 0, cap_c: int = 0,
                           threads: int = 0):
    """Annex-B entropy decode of a batch of access units.

    `frames`: one annex-B byte string per frame-stream.  Returns (qp,
    mb_pos [n_mb] int32, mb_fields [n_mb, 9] int16, cpos [n_c] int32,
    cval [n_c] int16): compact records of the virtual dense tensors
    [F, N_mb, 9] and [F, N_mb, MB_SLOTS].  Caps grow on overflow."""
    lib = load()
    n_fs = len(frames)
    blob = np.frombuffer(b"".join(frames), np.uint8)
    fs_off = np.zeros(n_fs + 1, np.int64)
    np.cumsum([len(f) for f in frames], out=fs_off[1:])
    cap_mb = cap_mb if cap_mb > 0 else max(4096, n_fs * mbw * mbh // 4)
    cap_c = cap_c if cap_c > 0 else max(65536, len(blob))
    qp_out = np.zeros(n_fs, np.int32)
    counts = np.zeros(2, np.int64)
    while True:
        mb_pos = np.empty(cap_mb, np.int32)
        mb_fields = np.empty((cap_mb, 9), np.int16)
        cpos = np.empty(cap_c, np.int32)
        cval = np.empty(cap_c, np.int16)
        rc = lib.th264_parse_dispatch_compact(
            blob, fs_off, n_fs, mbw, mbh,
            sps.log2_max_frame_num_minus4 + 4,
            (sps.log2_max_pic_order_cnt_lsb_minus4 + 4
             if sps.pic_order_cnt_type == 0 else 0),
            pps.deblocking_filter_control_present_flag,
            26 + pps.pic_init_qp_minus26,
            qp_out, mb_pos, mb_fields, cap_mb, cpos, cval, cap_c,
            counts, threads if threads > 0 else (os.cpu_count() or 1))
        if rc == 0:
            break
        if rc != -2:
            raise RuntimeError("th264_parse_dispatch_compact failed")
        cap_mb = max(cap_mb, 2 * int(counts[0]))
        cap_c = max(cap_c, 2 * int(counts[1]))
    n_mb, n_c = int(counts[0]), int(counts[1])
    qp = int(qp_out[0])
    if not (qp_out == qp).all():
        raise RuntimeError("non-uniform slice QP in dispatch")
    return qp, mb_pos[:n_mb], mb_fields[:n_mb], cpos[:n_c], cval[:n_c]
