"""Port copy of tpuh264/engine/ring.py (the original's package imports
JAX); kept identical, tests hold it so.

Bounded frame ring with refcounted fan-out -- the SAB slot protocol.

Re-expresses the reference's SharedArrayBuffer transport semantics
(reference/scripts/app.js:50-53,292-310): a fixed pool of slots,
each with a [size, refcount] control word; the producer claims a slot
only when its refcount is 0 and otherwise *drops the frame*
(encoder_worker.js:177-183); the refcount is set to the consumer fan-out
(refcount = numStreams, encoder_worker.js:189-191); each consumer
releases exactly once, even when it drops the work
(decoder_worker.js:141-146,221-226 -- the `finally` discipline).

The exactly-once-release invariant is enforced with an owner token per
claim generation, and tested explicitly (SURVEY.md section 5, race
detection note).
"""

from __future__ import annotations

import threading
from typing import Optional, Tuple


class FrameRing:
    def __init__(self, pool_size: int = 40, max_frame_size: int = 2 * 1024 * 1024):
        self.pool_size = pool_size
        self.max_frame_size = max_frame_size
        self._lock = threading.Lock()
        self._slots = [bytearray() for _ in range(pool_size)]
        self._refcount = [0] * pool_size
        self._generation = [0] * pool_size
        self._next = 0
        self.produced = 0
        self.dropped = 0
        self.released = 0

    def try_publish(self, data: bytes, fanout: int) -> Optional[Tuple[int, int]]:
        """Claim the next round-robin slot and publish `data` to `fanout`
        consumers.  Returns (slot, generation) or None if the slot is busy
        (frame dropped, mirroring the reference's backpressure policy)."""
        if len(data) > self.max_frame_size:
            raise ValueError(
                f"frame of {len(data)} bytes exceeds slot size "
                f"{self.max_frame_size} (reference guard encoder_worker.js:170-173)"
            )
        with self._lock:
            slot = self._next
            self._next = (self._next + 1) % self.pool_size
            if self._refcount[slot] != 0:
                self.dropped += 1
                return None
            self._slots[slot] = bytearray(data)
            self._generation[slot] += 1
            self._refcount[slot] = fanout
            self.produced += 1
            return slot, self._generation[slot]

    def read(self, slot: int, generation: int) -> bytes:
        """Read slot payload; caller must hold an unreleased claim."""
        with self._lock:
            if self._generation[slot] != generation or self._refcount[slot] <= 0:
                raise RuntimeError("read after release or stale generation")
            return bytes(self._slots[slot])

    def release(self, slot: int, generation: int) -> None:
        """Consumer releases its claim exactly once (busy-drop included)."""
        with self._lock:
            if self._generation[slot] != generation:
                raise RuntimeError("double release detected (stale generation)")
            if self._refcount[slot] <= 0:
                raise RuntimeError("release without claim")
            self._refcount[slot] -= 1
            self.released += 1

    def refcount(self, slot: int) -> int:
        with self._lock:
            return self._refcount[slot]
