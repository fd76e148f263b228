# Copy of tpuh264/core/bitstream.py, so that the port imports nothing of tpuh264.
"""Bit-level I/O for H.264 RBSP payloads.

This is the host-side bit substrate that replaces the reference's reliance
on libopenh264's internal bitstream writer (the reference only ever moves
opaque NAL bytes around, e.g. copy_encoded_data at
reference/openh264_wrapper.cpp:282-311).  A C++ fast path with the
same semantics lives in native/; this module is the canonical
specification and test oracle.

All methods follow ITU-T H.264 section 7.2 (ue(v)/se(v) Exp-Golomb) and
section 7.4.1 (rbsp_trailing_bits).
"""

from __future__ import annotations


class BitWriter:
    """MSB-first bit accumulator producing an RBSP byte string."""

    __slots__ = ("_bytes", "_acc", "_nbits")

    def __init__(self) -> None:
        self._bytes = bytearray()
        self._acc = 0  # bit accumulator, MSB-aligned conceptually
        self._nbits = 0  # number of valid bits in _acc

    def u(self, n: int, value: int) -> None:
        """Write ``value`` as an ``n``-bit unsigned field, MSB first."""
        if n < 0 or (n and value >> n):
            raise ValueError(f"value {value} does not fit in {n} bits")
        self._acc = (self._acc << n) | value
        self._nbits += n
        while self._nbits >= 8:
            self._nbits -= 8
            self._bytes.append((self._acc >> self._nbits) & 0xFF)
        self._acc &= (1 << self._nbits) - 1

    def f(self, n: int, value: int) -> None:
        self.u(n, value)

    def ue(self, value: int) -> None:
        """Unsigned Exp-Golomb (H.264 9.1)."""
        if value < 0:
            raise ValueError("ue(v) requires a non-negative value")
        code = value + 1
        nbits = code.bit_length()
        self.u(2 * nbits - 1, code)

    def se(self, value: int) -> None:
        """Signed Exp-Golomb (H.264 9.1.1): k>0 -> 2k-1, k<=0 -> -2k."""
        self.ue(2 * value - 1 if value > 0 else -2 * value)

    @property
    def bit_length(self) -> int:
        return 8 * len(self._bytes) + self._nbits

    def byte_aligned(self) -> bool:
        return self._nbits == 0

    def rbsp_trailing_bits(self) -> None:
        """stop bit + zero padding to a byte boundary (H.264 7.4.1)."""
        self.u(1, 1)
        if self._nbits:
            self.u(8 - self._nbits, 0)

    def get_bytes(self) -> bytes:
        if self._nbits:
            raise ValueError(
                f"bitstream not byte aligned ({self._nbits} leftover bits); "
                "call rbsp_trailing_bits() first"
            )
        return bytes(self._bytes)


class BitReader:
    """MSB-first bit reader over an RBSP byte string."""

    __slots__ = ("_data", "_pos")

    def __init__(self, data: bytes) -> None:
        self._data = data
        self._pos = 0  # bit position

    def u(self, n: int) -> int:
        end = self._pos + n
        if end > 8 * len(self._data):
            raise EOFError("read past end of bitstream")
        value = 0
        pos = self._pos
        while n > 0:
            byte = self._data[pos >> 3]
            bit_off = pos & 7
            take = min(n, 8 - bit_off)
            chunk = (byte >> (8 - bit_off - take)) & ((1 << take) - 1)
            value = (value << take) | chunk
            pos += take
            n -= take
        self._pos = pos
        return value

    def ue(self) -> int:
        zeros = 0
        while self.u(1) == 0:
            zeros += 1
            if zeros > 32:
                raise ValueError("malformed Exp-Golomb code")
        return (1 << zeros) - 1 + (self.u(zeros) if zeros else 0)

    def se(self) -> int:
        k = self.ue()
        return (k + 1) // 2 if k % 2 else -(k // 2)

    @property
    def bit_position(self) -> int:
        return self._pos

    def bits_remaining(self) -> int:
        return 8 * len(self._data) - self._pos

    def byte_aligned(self) -> bool:
        return self._pos % 8 == 0

    def more_rbsp_data(self) -> bool:
        """True if there is RBSP payload before the trailing stop bit."""
        remaining = self.bits_remaining()
        if remaining <= 0:
            return False
        # Find the last set bit in the stream (the rbsp stop bit): in the
        # last nonzero byte, that is its least-significant set bit.
        last_one = -1
        for byte_idx in range(len(self._data) - 1, -1, -1):
            b = self._data[byte_idx]
            if b:
                ctz = (b & -b).bit_length() - 1
                last_one = 8 * byte_idx + 7 - ctz
                break
        return last_one > self._pos if last_one >= 0 else False
