# Copy of tpuh264/golden/intra8.py, so that the port imports nothing of tpuh264.
"""Intra_8x8 luma prediction (H.264 8.3.2) -- numpy oracle.

High-profile I_NxN with transform_size_8x8_flag=1: nine modes over 8x8
blocks, predicting from LOW-PASS-FILTERED causal neighbor samples
(8.3.2.2.1) -- the filtering is the one structural difference from the
Intra_4x4 modes in intra44.py.  Sample sets per block: left L[0..7]
(p[-1,0..7]), top T[0..7] (p[0..7,-1]), top-right TR[0..7]
(p[8..15,-1], substituted with T[7] when unavailable per 8.3.2.2),
corner X (p[-1,-1]).

The reference decodes these MBs inside its prebuilt OpenH264 decoder
(reference/openh264_wrapper.cpp:391-422 accepts any conformant
stream); this module closes the High-profile gap for third-party
(libx264 8x8dct) streams, pixel-exact vs libavcodec
(tests/test_conformance_reverse.py).

Mode numbering: 0 V, 1 H, 2 DC, 3 DDL, 4 DDR, 5 VR, 6 HD, 7 VL, 8 HU.
"""

from __future__ import annotations

import numpy as np


def _filter_refs(L, T, TR, X, left_ok: bool, top_ok: bool):
    """Reference sample filtering (8.3.2.2.1).  Returns (l, t, x) with
    t[0..15] = filtered p'[0..15,-1], l[0..7] = p'[-1,0..7], x scalar
    p'[-1,-1].  TR must already hold the 8.3.2.2 substitution (T[7]
    replicated) when the top-right run is unavailable."""
    t_raw = np.concatenate([T, TR]).astype(np.int64)
    l_raw = L.astype(np.int64)
    x_raw = int(X)
    corner_ok = left_ok and top_ok
    t = t_raw.copy()
    l = l_raw.copy()
    x = x_raw
    if top_ok:
        if corner_ok:
            t[0] = (x_raw + 2 * t_raw[0] + t_raw[1] + 2) >> 2
        else:
            t[0] = (3 * t_raw[0] + t_raw[1] + 2) >> 2
        t[1:15] = (t_raw[0:14] + 2 * t_raw[1:15] + t_raw[2:16] + 2) >> 2
        t[15] = (t_raw[14] + 3 * t_raw[15] + 2) >> 2
    if corner_ok:
        # both p[0,-1] and p[-1,0] exist whenever the corner does here
        x = (t_raw[0] + 2 * x_raw + l_raw[0] + 2) >> 2
    if left_ok:
        if corner_ok:
            l[0] = (x_raw + 2 * l_raw[0] + l_raw[1] + 2) >> 2
        else:
            l[0] = (3 * l_raw[0] + l_raw[1] + 2) >> 2
        l[1:7] = (l_raw[0:6] + 2 * l_raw[1:7] + l_raw[2:8] + 2) >> 2
        l[7] = (l_raw[6] + 3 * l_raw[7] + 2) >> 2
    return t.astype(np.int32), l.astype(np.int32), int(x)


def pred8x8(mode: int, L, T, TR, X, left_ok: bool, top_ok: bool) -> np.ndarray:
    """One 8x8 luma prediction from raw (unfiltered) neighbors; applies
    the 8.3.2.2.1 filter internally.  L/T/TR int arrays (len 8), X int."""
    t, l, x = _filter_refs(L, T, TR, X, left_ok, top_ok)
    out = np.zeros((8, 8), np.int32)
    if mode == 0:  # Vertical (8.3.2.2.2)
        return np.broadcast_to(t[:8].reshape(1, 8), (8, 8)).copy()
    if mode == 1:  # Horizontal (8.3.2.2.3)
        return np.broadcast_to(l.reshape(8, 1), (8, 8)).copy()
    if mode == 2:  # DC (8.3.2.2.4)
        if top_ok and left_ok:
            dc = (int(t[:8].sum()) + int(l.sum()) + 8) >> 4
        elif top_ok:
            dc = (int(t[:8].sum()) + 4) >> 3
        elif left_ok:
            dc = (int(l.sum()) + 4) >> 3
        else:
            dc = 128
        out[:] = dc
        return out
    if mode == 3:  # Diagonal down-left (8.3.2.2.5)
        for yy in range(8):
            for xx in range(8):
                if xx == 7 and yy == 7:
                    out[yy, xx] = (t[14] + 3 * t[15] + 2) >> 2
                else:
                    i = xx + yy
                    out[yy, xx] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return out

    def tq(k):  # p'[k, -1] with k >= -1
        return int(t[k]) if k >= 0 else x

    def lq(k):  # p'[-1, k] with k >= -1
        return int(l[k]) if k >= 0 else x

    if mode == 4:  # Diagonal down-right (8.3.2.2.6)
        for yy in range(8):
            for xx in range(8):
                if xx > yy:
                    d = xx - yy
                    out[yy, xx] = (tq(d - 2) + 2 * tq(d - 1) + tq(d) + 2) >> 2
                elif xx < yy:
                    d = yy - xx
                    out[yy, xx] = (lq(d - 2) + 2 * lq(d - 1) + lq(d) + 2) >> 2
                else:
                    out[yy, xx] = (tq(0) + 2 * x + lq(0) + 2) >> 2
        return out
    if mode == 5:  # Vertical-right (8.3.2.2.7)
        for yy in range(8):
            for xx in range(8):
                z = 2 * xx - yy
                k = xx - (yy >> 1)
                if z >= 0 and z % 2 == 0:
                    out[yy, xx] = (tq(k - 1) + tq(k) + 1) >> 1
                elif z >= 0:
                    out[yy, xx] = (tq(k - 2) + 2 * tq(k - 1) + tq(k) + 2) >> 2
                elif z == -1:
                    out[yy, xx] = (lq(0) + 2 * x + tq(0) + 2) >> 2
                else:
                    out[yy, xx] = (
                        lq(yy - 2 * xx - 1) + 2 * lq(yy - 2 * xx - 2)
                        + lq(yy - 2 * xx - 3) + 2
                    ) >> 2
        return out
    if mode == 6:  # Horizontal-down (8.3.2.2.8)
        for yy in range(8):
            for xx in range(8):
                z = 2 * yy - xx
                k = yy - (xx >> 1)
                if z >= 0 and z % 2 == 0:
                    out[yy, xx] = (lq(k - 1) + lq(k) + 1) >> 1
                elif z >= 0:
                    out[yy, xx] = (lq(k - 2) + 2 * lq(k - 1) + lq(k) + 2) >> 2
                elif z == -1:
                    out[yy, xx] = (tq(0) + 2 * x + lq(0) + 2) >> 2
                else:
                    out[yy, xx] = (
                        tq(xx - 2 * yy - 1) + 2 * tq(xx - 2 * yy - 2)
                        + tq(xx - 2 * yy - 3) + 2
                    ) >> 2
        return out
    if mode == 7:  # Vertical-left (8.3.2.2.9)
        for yy in range(8):
            for xx in range(8):
                i = xx + (yy >> 1)
                if yy % 2 == 0:
                    out[yy, xx] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    out[yy, xx] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return out
    if mode == 8:  # Horizontal-up (8.3.2.2.10)
        for yy in range(8):
            for xx in range(8):
                z = xx + 2 * yy
                i = yy + (xx >> 1)
                if z % 2 == 0 and z <= 12:
                    out[yy, xx] = (l[i] + l[i + 1] + 1) >> 1
                elif z <= 11:
                    out[yy, xx] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 13:
                    out[yy, xx] = (l[6] + 3 * l[7] + 2) >> 2
                else:
                    out[yy, xx] = l[7]
        return out
    raise ValueError(mode)
