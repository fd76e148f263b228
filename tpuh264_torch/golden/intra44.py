# Copy of tpuh264/golden/intra44.py, so that the port imports nothing of tpuh264.
"""Intra_4x4 luma prediction (H.264 8.3.1) -- numpy oracle.

Nine modes over 4x4 blocks with causal neighbor samples from the
unfiltered reconstruction.  Sample sets per block: left L[0..3]
(p[-1,0..3]), top T[0..3] (p[0..3,-1]), top-right TR[0..3]
(p[4..7,-1], substituted with T[3] when unavailable per 8.3.1.2),
corner X (p[-1,-1]).

Mode numbering: 0 V, 1 H, 2 DC, 3 DDL, 4 DDR, 5 VR, 6 HD, 7 VL, 8 HU.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np


def pred4(mode: int, L, T, TR, X, left_ok: bool, top_ok: bool) -> np.ndarray:
    """One 4x4 prediction.  L/T/TR are int arrays (len 4), X int scalar."""
    out = np.zeros((4, 4), np.int32)
    if mode == 0:  # Vertical
        return np.broadcast_to(T.reshape(1, 4), (4, 4)).copy()
    if mode == 1:  # Horizontal
        return np.broadcast_to(L.reshape(4, 1), (4, 4)).copy()
    if mode == 2:  # DC
        if top_ok and left_ok:
            dc = (int(T.sum()) + int(L.sum()) + 4) >> 3
        elif top_ok:
            dc = (int(T.sum()) + 2) >> 2
        elif left_ok:
            dc = (int(L.sum()) + 2) >> 2
        else:
            dc = 128
        out[:] = dc
        return out
    t = np.concatenate([T, TR]).astype(np.int32)  # t[0..7]
    l = L.astype(np.int32)
    x = int(X)
    if mode == 3:  # Diagonal down-left (8.3.1.2.4)
        for yy in range(4):
            for xx in range(4):
                i = xx + yy
                if i == 6:
                    out[yy, xx] = (t[6] + 3 * t[7] + 2) >> 2
                else:
                    out[yy, xx] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return out
    def tq(k):  # p[k, -1] with k >= -1
        return int(t[k]) if k >= 0 else x

    def lq(k):  # p[-1, k] with k >= -1
        return int(l[k]) if k >= 0 else x

    if mode == 4:  # Diagonal down-right (8.3.1.2.5)
        for yy in range(4):
            for xx in range(4):
                if xx > yy:
                    d = xx - yy
                    out[yy, xx] = (tq(d - 2) + 2 * tq(d - 1) + tq(d) + 2) >> 2
                elif xx < yy:
                    d = yy - xx
                    out[yy, xx] = (lq(d - 2) + 2 * lq(d - 1) + lq(d) + 2) >> 2
                else:
                    out[yy, xx] = (tq(0) + 2 * x + lq(0) + 2) >> 2
        return out
    if mode == 5:  # Vertical-right (8.3.1.2.6)
        for yy in range(4):
            for xx in range(4):
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
                        lq(yy - 1) + 2 * lq(yy - 2) + lq(yy - 3) + 2
                    ) >> 2
        return out
    if mode == 6:  # Horizontal-down (8.3.1.2.7)
        for yy in range(4):
            for xx in range(4):
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
                        tq(xx - 1) + 2 * tq(xx - 2) + tq(xx - 3) + 2
                    ) >> 2
        return out
    if mode == 7:  # Vertical-left (8.3.1.2.8)
        for yy in range(4):
            for xx in range(4):
                i = xx + (yy >> 1)
                if yy % 2 == 0:
                    out[yy, xx] = (t[i] + t[i + 1] + 1) >> 1
                else:
                    out[yy, xx] = (t[i] + 2 * t[i + 1] + t[i + 2] + 2) >> 2
        return out
    if mode == 8:  # Horizontal-up (8.3.1.2.9)
        for yy in range(4):
            for xx in range(4):
                z = xx + 2 * yy
                if z % 2 == 0 and z <= 4:
                    i = yy + (xx >> 1)
                    out[yy, xx] = (l[i] + l[i + 1] + 1) >> 1
                elif z <= 3:
                    i = yy + (xx >> 1)
                    out[yy, xx] = (l[i] + 2 * l[i + 1] + l[i + 2] + 2) >> 2
                elif z == 5:
                    out[yy, xx] = (l[2] + 3 * l[3] + 2) >> 2
                else:
                    out[yy, xx] = l[3]
        return out
    raise ValueError(mode)


def available_modes(left_ok: bool, top_ok: bool) -> List[int]:
    modes = [2]
    if top_ok:
        modes += [0, 3, 7]
    if left_ok:
        modes += [1, 8]
    if top_ok and left_ok:
        modes += [4, 5, 6]
    return sorted(modes)
