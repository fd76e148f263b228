# Copy of tpuh264/entropy/cabac_arith.py, so that the port imports nothing of tpuh264.
"""CABAC binary arithmetic coding engine (H.264 9.3.4 encode / 9.3.3.2
decode).

Plain-Python scalar engine used by the host entropy layer (the CABAC
analog of entropy/cavlc.py).  Context state lives in caller-owned numpy
arrays (pStateIdx / valMPS indexed by the standard's ctxIdx numbering)
so a slice coder can re-initialize per slice via
cabac_tables.init_contexts.

Encoder follows flowcharts 9.3.4.2 (EncodeDecision), 9.3.4.4 (PutBit /
RenormE), 9.3.4.5 (EncodeBypass), 9.3.4.6 (EncodeTerminate/Flush; the
flush's final 1 bit is the rbsp_stop_one_bit, after which the stream is
zero-padded to a byte boundary).
"""

from __future__ import annotations

from .cabac_tables import RANGE_LPS, TRANS_LPS, TRANS_MPS

_RLPS = RANGE_LPS.tolist()
_TLPS = TRANS_LPS.tolist()
_TMPS = TRANS_MPS.tolist()


class CabacEncoder:
    def __init__(self) -> None:
        self.low = 0
        self.range = 510
        self.outstanding = 0
        self.first = True
        self.buf = bytearray()
        self._acc = 0
        self._nbits = 0

    # -- raw bit output -------------------------------------------------------

    def _bit(self, b: int) -> None:
        self._acc = (self._acc << 1) | b
        self._nbits += 1
        if self._nbits == 8:
            self.buf.append(self._acc)
            self._acc = 0
            self._nbits = 0

    def _put(self, b: int) -> None:  # PutBit (9.3.4.4): first bit discarded
        if self.first:
            self.first = False
        else:
            self._bit(b)
        while self.outstanding:
            self._bit(1 - b)
            self.outstanding -= 1

    def _renorm(self) -> None:
        while self.range < 256:
            if self.low >= 512:
                self._put(1)
                self.low -= 512
            elif self.low < 256:
                self._put(0)
            else:
                self.outstanding += 1
                self.low -= 256
            self.range <<= 1
            self.low <<= 1

    # -- coding primitives ----------------------------------------------------

    def encode(self, state, mps, idx: int, bit: int) -> None:
        """EncodeDecision with context (state[idx], mps[idx])."""
        s = int(state[idx])
        rlps = _RLPS[s][(self.range >> 6) & 3]
        self.range -= rlps
        if bit != mps[idx]:
            self.low += self.range
            self.range = rlps
            if s == 0:
                mps[idx] ^= 1
            state[idx] = _TLPS[s]
        else:
            state[idx] = _TMPS[s]
        self._renorm()

    def bypass(self, bit: int) -> None:
        self.low <<= 1
        if bit:
            self.low += self.range
        if self.low >= 1024:
            self._put(1)
            self.low -= 1024
        elif self.low < 512:
            self._put(0)
        else:
            self.outstanding += 1
            self.low -= 512

    def terminate(self, bit: int) -> None:
        self.range -= 2
        if bit:
            self.low += self.range
            self.range = 2
            self._flush()
        else:
            self._renorm()

    def _flush(self) -> None:
        self.range = 2
        self._renorm()
        self._put((self.low >> 9) & 1)
        self._bit((self.low >> 8) & 1)
        self._bit(1)  # rbsp_stop_one_bit (spec: WriteBits(((low>>7)&3)|1, 2))
        while self._nbits:  # zero-pad to byte boundary
            self._bit(0)

    def get_bytes(self) -> bytes:
        return bytes(self.buf)


class CabacDecoder:
    def __init__(self, data: bytes, byte_offset: int) -> None:
        self.data = data
        self.pos = 8 * byte_offset
        self.range = 510
        self.offset = 0
        for _ in range(9):
            self.offset = (self.offset << 1) | self._rb()

    def _rb(self) -> int:
        byte = self.pos >> 3
        b = (
            (self.data[byte] >> (7 - (self.pos & 7))) & 1
            if byte < len(self.data)
            else 0
        )
        self.pos += 1
        return b

    def decode(self, state, mps, idx: int) -> int:
        s = int(state[idx])
        rlps = _RLPS[s][(self.range >> 6) & 3]
        self.range -= rlps
        if self.offset >= self.range:
            bit = 1 - int(mps[idx])
            self.offset -= self.range
            self.range = rlps
            if s == 0:
                mps[idx] ^= 1
            state[idx] = _TLPS[s]
        else:
            bit = int(mps[idx])
            state[idx] = _TMPS[s]
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._rb()
        return bit

    def bypass(self) -> int:
        self.offset = (self.offset << 1) | self._rb()
        if self.offset >= self.range:
            self.offset -= self.range
            return 1
        return 0

    def terminate(self) -> int:
        self.range -= 2
        if self.offset >= self.range:
            return 1
        while self.range < 256:
            self.range <<= 1
            self.offset = (self.offset << 1) | self._rb()
        return 0
