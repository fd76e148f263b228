# Copy of tpuh264/entropy/cavlc.py, so that the port imports nothing of tpuh264.
"""CAVLC residual block coding (H.264 9.2) -- Python golden implementation.

This is the oracle for the C++ fast path (native/cavlc.cpp) and the basis
of the TPU symbolization kernels.  A block is a zigzag-ordered coefficient
vector of length 16 (luma / I16x16 DC), 15 (I16x16 AC / chroma AC) or 4
(chroma DC).  CAVLC has no cross-block bit state: given nC, each block's
bits are independent -- which is exactly what makes the TPU-parallel
encode possible (symbolize all blocks in parallel, then concatenate).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ..core.bitstream import BitReader, BitWriter
from .cavlc_tables import (
    COEFF_TOKEN_TABLES,
    RUN_BEFORE,
    TOTAL_ZEROS,
    TOTAL_ZEROS_CHROMA_DC,
    coeff_token_ctx,
)


def _write_level(w: BitWriter, level_code: int, suffix_len: int) -> None:
    """Encode one level_code with the current suffix length (H.264 9.2.2.1)."""
    if suffix_len == 0:
        if level_code < 14:
            w.u(level_code + 1, 1)  # level_prefix zeros then stop bit
        elif level_code < 30:
            w.u(15, 1)  # prefix 14
            w.u(4, level_code - 14)
        else:
            rem = level_code - 30
            prefix = 15
            # escape: suffix size = prefix - 3; prefix 15 covers 12 bits,
            # each +1 prefix doubles the range (offset grows accordingly)
            while rem >= (1 << (prefix - 3)):
                rem -= 1 << (prefix - 3)
                prefix += 1
            w.u(prefix + 1, 1)
            w.u(prefix - 3, rem)
    else:
        if level_code < (15 << suffix_len):
            prefix = level_code >> suffix_len
            w.u(prefix + 1, 1)
            w.u(suffix_len, level_code & ((1 << suffix_len) - 1))
        else:
            rem = level_code - (15 << suffix_len)
            prefix = 15
            while rem >= (1 << (prefix - 3)):
                rem -= 1 << (prefix - 3)
                prefix += 1
            w.u(prefix + 1, 1)
            w.u(prefix - 3, rem)


def _read_level(r: BitReader, suffix_len: int) -> int:
    """Decode one level_code (H.264 9.2.2.1)."""
    prefix = 0
    while r.u(1) == 0:
        prefix += 1
        if prefix > 32:
            raise ValueError("malformed level_prefix")
    if suffix_len == 0:
        if prefix < 14:
            return prefix
        if prefix == 14:
            return 14 + r.u(4)
        # prefix >= 15
        level_code = 30 + r.u(prefix - 3)
        for p in range(15, prefix):
            level_code += 1 << (p - 3)
        return level_code
    if prefix < 15:
        return (prefix << suffix_len) + r.u(suffix_len)
    level_code = (15 << suffix_len) + r.u(prefix - 3)
    for p in range(15, prefix):
        level_code += 1 << (p - 3)
    return level_code


def encode_residual_block(
    w: BitWriter, coeffs: Sequence[int], nC: int, max_coeffs: int
) -> None:
    """Encode one zigzag-ordered coefficient vector (H.264 9.2)."""
    nz: List[Tuple[int, int]] = [
        (i, int(c)) for i, c in enumerate(coeffs[:max_coeffs]) if c
    ]
    total_coeff = len(nz)
    t1 = 0
    for idx in range(total_coeff - 1, -1, -1):
        if abs(nz[idx][1]) == 1 and t1 < 3:
            t1 += 1
        else:
            break

    ln, bits = COEFF_TOKEN_TABLES[coeff_token_ctx(nC)][(total_coeff, t1)]
    w.u(ln, bits)
    if total_coeff == 0:
        return

    # trailing-one signs, highest frequency first
    for idx in range(total_coeff - 1, total_coeff - 1 - t1, -1):
        w.u(1, 1 if nz[idx][1] < 0 else 0)

    # remaining levels, highest frequency first
    suffix_len = 1 if (total_coeff > 10 and t1 < 3) else 0
    first = True
    for idx in range(total_coeff - 1 - t1, -1, -1):
        level = nz[idx][1]
        level_code = 2 * level - 2 if level > 0 else -2 * level - 1
        if first and t1 < 3:
            level_code -= 2
        first = False
        _write_level(w, level_code, suffix_len)
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    # total_zeros
    if total_coeff < max_coeffs:
        total_zeros = nz[-1][0] + 1 - total_coeff
        if max_coeffs == 4:
            ln, bits = TOTAL_ZEROS_CHROMA_DC[total_coeff - 1][total_zeros]
        else:
            ln, bits = TOTAL_ZEROS[total_coeff - 1][total_zeros]
        w.u(ln, bits)
    else:
        total_zeros = 0

    # run_before, highest frequency first, last coefficient's run implied
    zeros_left = total_zeros
    for idx in range(total_coeff - 1, 0, -1):
        if zeros_left <= 0:
            break
        run = nz[idx][0] - nz[idx - 1][0] - 1
        ln, bits = RUN_BEFORE[min(zeros_left, 7) - 1][run]
        w.u(ln, bits)
        zeros_left -= run


_VLC_DECODE_CACHE: dict = {}


def _read_vlc(r: BitReader, table: dict) -> Tuple[int, int]:
    """Read a (total_coeff, trailing_ones) coeff_token by longest-prefix match."""
    cache = _VLC_DECODE_CACHE.get(id(table))
    if cache is None:
        cache = {(ln, bits): key for key, (ln, bits) in table.items()}
        _VLC_DECODE_CACHE[id(table)] = cache
    code = 0
    for ln in range(1, 17):
        code = (code << 1) | r.u(1)
        if (ln, code) in cache:
            return cache[(ln, code)]
    raise ValueError("invalid coeff_token")


def decode_residual_block(
    r: BitReader, nC: int, max_coeffs: int
) -> List[int]:
    """Decode one zigzag-ordered coefficient vector; returns len==max_coeffs."""
    total_coeff, t1 = _read_vlc(r, COEFF_TOKEN_TABLES[coeff_token_ctx(nC)])
    coeffs = [0] * max_coeffs
    if total_coeff == 0:
        return coeffs

    levels = [0] * total_coeff  # highest-frequency first
    for i in range(t1):
        levels[i] = -1 if r.u(1) else 1

    suffix_len = 1 if (total_coeff > 10 and t1 < 3) else 0
    for i in range(t1, total_coeff):
        level_code = _read_level(r, suffix_len)
        if i == t1 and t1 < 3:
            level_code += 2
        level = (level_code + 2) >> 1 if level_code % 2 == 0 else -((level_code + 1) >> 1)
        levels[i] = level
        if suffix_len == 0:
            suffix_len = 1
        if abs(level) > (3 << (suffix_len - 1)) and suffix_len < 6:
            suffix_len += 1

    if total_coeff < max_coeffs:
        if max_coeffs == 4:
            tz_table = TOTAL_ZEROS_CHROMA_DC[total_coeff - 1]
        else:
            tz_table = TOTAL_ZEROS[total_coeff - 1]
        # longest-prefix match over the row
        dec = {}
        for tz, (ln, bits) in enumerate(tz_table):
            dec[(ln, bits)] = tz
        code = 0
        total_zeros = None
        for ln in range(1, 10):
            code = (code << 1) | r.u(1)
            if (ln, code) in dec:
                total_zeros = dec[(ln, code)]
                break
        if total_zeros is None:
            raise ValueError("invalid total_zeros")
    else:
        total_zeros = 0

    # place coefficients: walk from highest-frequency nonzero down
    zeros_left = total_zeros
    pos = total_coeff - 1 + total_zeros  # scan index of highest nonzero
    for i in range(total_coeff):
        coeffs[pos] = levels[i]
        if i == total_coeff - 1:
            break
        if zeros_left > 0:
            row = RUN_BEFORE[min(zeros_left, 7) - 1]
            dec = {}
            for run, (ln, bits) in enumerate(row):
                dec[(ln, bits)] = run
            code = 0
            run = None
            for ln in range(1, 12):
                code = (code << 1) | r.u(1)
                if (ln, code) in dec:
                    run = dec[(ln, code)]
                    break
            if run is None:
                raise ValueError("invalid run_before")
        else:
            run = 0
        zeros_left -= run
        pos -= run + 1
    return coeffs
