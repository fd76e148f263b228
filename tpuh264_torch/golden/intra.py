# Copy of tpuh264/golden/intra.py, so that the port imports nothing of tpuh264.
"""Intra prediction (H.264 8.3.3 Intra_16x16, 8.3.4 chroma) -- numpy oracle.

Prediction operates on *reconstructed* neighbor samples, exactly as the
decoder will see them.  Mode numbering follows the spec:
  luma I16x16:  0=V, 1=H, 2=DC, 3=Plane
  chroma 8x8:   0=DC, 1=H, 2=V, 3=Plane
"""

from __future__ import annotations

import numpy as np


def pred16_vertical(top: np.ndarray) -> np.ndarray:
    return np.broadcast_to(top.reshape(1, 16), (16, 16)).copy()


def pred16_horizontal(left: np.ndarray) -> np.ndarray:
    return np.broadcast_to(left.reshape(16, 1), (16, 16)).copy()


def pred16_dc(top, left, top_avail: bool, left_avail: bool) -> np.ndarray:
    if top_avail and left_avail:
        dc = (int(top.sum()) + int(left.sum()) + 16) >> 5
    elif top_avail:
        dc = (int(top.sum()) + 8) >> 4
    elif left_avail:
        dc = (int(left.sum()) + 8) >> 4
    else:
        dc = 128
    return np.full((16, 16), dc, dtype=np.int32)


def pred16_plane(top, left, corner: int) -> np.ndarray:
    """H.264 8.3.3.4.  top/left are length-16 recon rows; corner = p[-1,-1]."""
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    # p[x,-1] for x=-1..15: corner then top
    px = np.concatenate([[corner], t])  # index x+1
    py = np.concatenate([[corner], l])
    xp = np.arange(8)
    h = int(np.sum((xp + 1) * (px[8 + xp + 1] - px[6 - xp + 1])))
    v = int(np.sum((xp + 1) * (py[8 + xp + 1] - py[6 - xp + 1])))
    a = 16 * (int(t[15]) + int(l[15]))
    b = (5 * h + 32) >> 6
    c = (5 * v + 32) >> 6
    y, x = np.mgrid[0:16, 0:16]
    out = (a + b * (x - 7) + c * (y - 7) + 16) >> 5
    return np.clip(out, 0, 255).astype(np.int32)


def pred16(mode: int, top, left, corner, top_avail, left_avail) -> np.ndarray:
    if mode == 0:
        return pred16_vertical(top)
    if mode == 1:
        return pred16_horizontal(left)
    if mode == 2:
        return pred16_dc(top, left, top_avail, left_avail)
    if mode == 3:
        return pred16_plane(top, left, corner)
    raise ValueError(mode)


def luma16_available_modes(top_avail: bool, left_avail: bool):
    modes = [2]  # DC always
    if top_avail:
        modes.append(0)
    if left_avail:
        modes.append(1)
    if top_avail and left_avail:
        modes.append(3)
    return modes


def pred8_chroma_dc(top, left, top_avail: bool, left_avail: bool) -> np.ndarray:
    """Per-4x4-quadrant chroma DC (H.264 8.3.4.1), 8x8 output."""
    out = np.zeros((8, 8), dtype=np.int32)
    for by in (0, 1):
        for bx in (0, 1):
            t = top[4 * bx : 4 * bx + 4] if top_avail else None
            l = left[4 * by : 4 * by + 4] if left_avail else None
            if bx == by:  # corner-type blocks (0,0) and (1,1): both edges
                if top_avail and left_avail:
                    dc = (int(t.sum()) + int(l.sum()) + 4) >> 3
                elif top_avail:
                    dc = (int(t.sum()) + 2) >> 2
                elif left_avail:
                    dc = (int(l.sum()) + 2) >> 2
                else:
                    dc = 128
            elif bx == 1:  # block (1,0): prefer top
                if top_avail:
                    dc = (int(t.sum()) + 2) >> 2
                elif left_avail:
                    dc = (int(l.sum()) + 2) >> 2
                else:
                    dc = 128
            else:  # block (0,1): prefer left
                if left_avail:
                    dc = (int(l.sum()) + 2) >> 2
                elif top_avail:
                    dc = (int(t.sum()) + 2) >> 2
                else:
                    dc = 128
            out[4 * by : 4 * by + 4, 4 * bx : 4 * bx + 4] = dc
    return out


def pred8_plane(top, left, corner: int) -> np.ndarray:
    """Chroma plane prediction for 4:2:0 (H.264 8.3.4.4)."""
    t = top.astype(np.int64)
    l = left.astype(np.int64)
    px = np.concatenate([[corner], t])
    py = np.concatenate([[corner], l])
    xp = np.arange(4)
    h = int(np.sum((xp + 1) * (px[4 + xp + 1] - px[2 - xp + 1])))
    v = int(np.sum((xp + 1) * (py[4 + xp + 1] - py[2 - xp + 1])))
    a = 16 * (int(t[7]) + int(l[7]))
    b = (34 * h + 32) >> 6
    c = (34 * v + 32) >> 6
    y, x = np.mgrid[0:8, 0:8]
    out = (a + b * (x - 3) + c * (y - 3) + 16) >> 5
    return np.clip(out, 0, 255).astype(np.int32)


def pred8(mode: int, top, left, corner, top_avail, left_avail) -> np.ndarray:
    if mode == 0:
        return pred8_chroma_dc(top, left, top_avail, left_avail)
    if mode == 1:
        return np.broadcast_to(left.reshape(8, 1), (8, 8)).copy()
    if mode == 2:
        return np.broadcast_to(top.reshape(1, 8), (8, 8)).copy()
    if mode == 3:
        return pred8_plane(top, left, corner)
    raise ValueError(mode)


def chroma_available_modes(top_avail: bool, left_avail: bool):
    modes = [0]
    if left_avail:
        modes.append(1)
    if top_avail:
        modes.append(2)
    if top_avail and left_avail:
        modes.append(3)
    return modes
