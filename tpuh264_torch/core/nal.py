# Copy of tpuh264/core/nal.py, so that the port imports nothing of tpuh264
# (its native unescape is the port's own, with no Python fallback).
"""Annex-B NAL unit framing (H.264 7.3.1, 7.4.1, B.1).

The reference treats NAL bytes as opaque (its copy_encoded_data at
reference/openh264_wrapper.cpp:282-311 just concatenates whatever
libopenh264 emitted); here we own the framing: start codes, NAL headers,
and emulation-prevention (0x000003) insertion/removal.
"""

from __future__ import annotations

from typing import Iterator, List, Tuple

import numpy as np

# nal_unit_type values (H.264 Table 7-1)
NAL_SLICE_NON_IDR = 1
NAL_SLICE_IDR = 5
NAL_SEI = 6
NAL_SPS = 7
NAL_PPS = 8
NAL_AUD = 9

START_CODE = b"\x00\x00\x00\x01"


def escape_rbsp(rbsp: bytes) -> bytes:
    """Insert emulation_prevention_three_byte (H.264 7.4.1.1)."""
    out = bytearray()
    zeros = 0
    for b in rbsp:
        if zeros >= 2 and b <= 3:
            out.append(3)
            zeros = 0
        out.append(b)
        zeros = zeros + 1 if b == 0 else 0
    return bytes(out)


def unescape_rbsp(ebsp: bytes) -> bytes:
    """Remove emulation_prevention_three_byte sequences."""
    out = bytearray()
    zeros = 0
    i, n = 0, len(ebsp)
    while i < n:
        b = ebsp[i]
        if zeros >= 2 and b == 3 and i + 1 < n and ebsp[i + 1] <= 3:
            zeros = 0  # skip the emulation byte
        else:
            out.append(b)
            zeros = zeros + 1 if b == 0 else 0
        i += 1
    return bytes(out)


def wrap_nal(nal_unit_type: int, rbsp: bytes, nal_ref_idc: int = 3) -> bytes:
    """Wrap an RBSP payload into a start-code-prefixed NAL unit."""
    header = bytes([(nal_ref_idc << 5) | nal_unit_type])
    return START_CODE + header + escape_rbsp(rbsp)


def _find_start_codes(data: bytes) -> List[Tuple[int, int]]:
    """All (payload_start, code_start) positions of 00 00 01 sequences."""
    n = len(data)
    if n >= 1 << 12:  # numpy fast path for big streams
        a = np.frombuffer(data, np.uint8)
        hits = np.flatnonzero((a[:-2] == 0) & (a[1:-1] == 0) & (a[2:] == 1))
        starts: List[Tuple[int, int]] = []
        last = -3
        for i in map(int, hits):
            if i >= last + 3:  # overlapping 000001 within a start code
                starts.append((i + 3, i))
                last = i
        return starts
    starts = []
    i = 0
    while i + 2 < n:
        if data[i] == 0 and data[i + 1] == 0 and data[i + 2] == 1:
            starts.append((i + 3, i))
            i += 3
        else:
            i += 1
    return starts


def _unescape_fast(ebsp: bytes) -> bytes:
    """Native unescape for big payloads (the Python loop is the hot spot):
    the port's own engine, which raises if it cannot be built."""
    if len(ebsp) >= 1 << 12:
        from ..entropy import native

        return native.unescape_rbsp(ebsp)
    return unescape_rbsp(ebsp)


def split_annexb(data: bytes) -> Iterator[Tuple[int, int, bytes]]:
    """Yield (nal_ref_idc, nal_unit_type, rbsp) for each NAL in the stream.

    Accepts both 3-byte and 4-byte start codes.
    """
    n = len(data)
    starts = _find_start_codes(data)
    for idx, (payload_start, _) in enumerate(starts):
        end = starts[idx + 1][1] if idx + 1 < len(starts) else n
        # Trim trailing zero bytes that belong to the next 4-byte start code.
        while end > payload_start and data[end - 1] == 0:
            end -= 1
        if end <= payload_start:
            continue
        header = data[payload_start]
        yield (header >> 5) & 3, header & 0x1F, _unescape_fast(
            data[payload_start + 1 : end]
        )
