# Copy of the constants and rate terms of tpuh264/golden/inter.py that the port reads.
"""Inter prediction: the motion search's geometry, rate terms and the
quarter-pel component table (shared definition of the encoder's
decisions: the port's kernels must make them bit-identically)."""

from __future__ import annotations

# integer-pel search geometry (shared with the kernels)
SEARCH_RANGE = 8          # stage-A full-search radius, integer pels
REFINE_RANGE = 1          # stage-B full-resolution refine radius, pels
SEARCH_PAD = 12           # reference padding needed (9 + subpel + margin)

# Motion cost: SAD + lambda*rate(mv); the rate proxy is the exact ue(v)
# length of 2*|v|.  A non-zero reference carries REF_COHERENCE_BITS on
# top of its te(v) bits (it forfeits P_Skip and decorrelates the MV
# prediction chain).
REF_COHERENCE_BITS = 2


def ref_idx_bits(ri: int, nra: int) -> int:
    """Bits of ref_idx_l0 as te(v) with cMax = nra-1 (7.3.5.1), plus the
    coherence penalty of a non-zero reference."""
    extra = REF_COHERENCE_BITS if ri > 0 else 0
    if nra <= 1:
        return extra
    if nra == 2:
        return 1 + extra
    return 2 * (ri + 1).bit_length() - 1 + extra


LAMBDA_ME = [max(1, int(0.92 * 2.0 ** ((q - 12) / 6.0)))
             for q in range(52)]


def mv_rate_bits(vx_q: int, vy_q: int) -> int:
    """ue(2|v|) bit length summed over both quarter-pel components."""

    def one(v):
        return 2 * int(2 * abs(v) + 1).bit_length() - 1

    return one(vx_q) + one(vy_q)


# component table: (comp1, comp2) per (xf, yf); components are
# 0:G00 1:b00 2:h00 3:j00 4:G10 5:G01 6:b01 7:h10
QPEL_TBL = {
    (0, 0): (0, 0), (1, 0): (0, 1), (2, 0): (1, 1), (3, 0): (1, 4),
    (0, 1): (0, 2), (1, 1): (1, 2), (2, 1): (1, 3), (3, 1): (1, 7),
    (0, 2): (2, 2), (1, 2): (2, 3), (2, 2): (3, 3), (3, 2): (3, 7),
    (0, 3): (2, 5), (1, 3): (2, 6), (2, 3): (3, 6), (3, 3): (7, 6),
}

OFFSETS_HALF = [(dy, dx) for dy in (-2, 0, 2) for dx in (-2, 0, 2)]
OFFSETS_QUARTER = [(dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1)]
