# Copy of the tables of tpuh264/golden/transform.py that the port reads.
"""H.264 4x4 quant / dequant tables, chroma QP map and zigzag scan."""

from __future__ import annotations

import numpy as np

# Quant multiplier MF[qp%6][i][j] and dequant scale V[qp%6][i][j],
# positions classed a=(0,0),(0,2),(2,0),(2,2); b=(1,1),(1,3),(3,1),(3,3); c=rest.
_MF_A = [13107, 11916, 10082, 9362, 8192, 7282]
_MF_B = [5243, 4660, 4194, 3647, 3355, 2893]
_MF_C = [8066, 7490, 6554, 5825, 5243, 4559]
_V_A = [10, 11, 13, 14, 16, 18]
_V_B = [16, 18, 20, 23, 25, 29]
_V_C = [13, 14, 16, 18, 20, 23]


def _pos_table(a, b, c):
    t = np.zeros((6, 4, 4), dtype=np.int32)
    for m in range(6):
        t[m, :, :] = c[m]
        for i, j in ((0, 0), (0, 2), (2, 0), (2, 2)):
            t[m, i, j] = a[m]
        for i, j in ((1, 1), (1, 3), (3, 1), (3, 3)):
            t[m, i, j] = b[m]
    return t


MF_TABLE = _pos_table(_MF_A, _MF_B, _MF_C)  # (6,4,4)
V_TABLE = _pos_table(_V_A, _V_B, _V_C)  # (6,4,4)

# Chroma QP mapping, H.264 Table 8-15 (qPi 30..51)
_CHROMA_QP_TAIL = [29, 30, 31, 32, 32, 33, 34, 34, 35, 35, 36, 36,
                   37, 37, 37, 38, 38, 38, 39, 39, 39, 39]
CHROMA_QP_TABLE = np.array(list(range(30)) + _CHROMA_QP_TAIL, dtype=np.int32)

# Zigzag scan for 4x4 blocks (Table 8-13 inverse: coeff order -> (i,j))
ZIGZAG4 = np.array(
    [0, 1, 4, 8, 5, 2, 3, 6, 9, 12, 13, 10, 7, 11, 14, 15], dtype=np.int32
)
