"""Adaptive binary range encoder.

Mirror image of the decoder in ``models/spec.py``; behavioral spec from the
reference encoder (lzma-rs ``src/encode/rangecoder.rs:7-144``):
64-bit ``low`` with cache/cache-size carry propagation, ``encode_bit`` with
the same 11-bit adaptive probability update as the decoder, and a 5-byte
flush on ``finish``. The bit-tree and length encoders (test-only in the
reference, ``:146-274``) are provided for the exhaustive encoder/decoder
round-trip property tests.
"""

from __future__ import annotations

import numpy as np

from lzma_rs_tpu.models.state import LEN_CHOICE, LEN_CHOICE2, LEN_HIGH, LEN_LOW, LEN_MID


class RangeEncoder:
    """Carry-propagating binary range encoder (encode/rangecoder.rs:7-144):
    low:u64/cache/cachesz writer, adaptive 11-bit probabilities, 5-byte
    flush on finish()."""

    __slots__ = ("out", "range", "low", "cache", "cachesz")

    def __init__(self) -> None:
        self.out = bytearray()
        self.range = 0xFFFFFFFF
        self.low = 0  # u64
        self.cache = 0
        self.cachesz = 1

    def _write_low(self) -> None:
        if self.low < 0xFF00_0000 or self.low > 0xFFFF_FFFF:
            tmp = self.cache
            while True:
                self.out.append((tmp + (self.low >> 32)) & 0xFF)
                tmp = 0xFF
                self.cachesz -= 1
                if self.cachesz == 0:
                    break
            self.cache = (self.low >> 24) & 0xFF
        self.cachesz += 1
        self.low = (self.low << 8) & 0xFFFFFFFF

    def finish(self) -> bytes:
        for _ in range(5):
            self._write_low()
        return bytes(self.out)

    def _normalize(self) -> None:
        while self.range < 0x0100_0000:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self._write_low()

    def encode_bit(self, probs, idx: int, bit: bool) -> None:
        prob = int(probs[idx])
        bound = (self.range >> 11) * prob
        if bit:
            probs[idx] = prob - (prob >> 5)
            self.low += bound
            self.range -= bound
        else:
            probs[idx] = prob + ((0x800 - prob) >> 5)
            self.range = bound
        self._normalize()

    def encode_bit_tree(self, num_bits: int, probs, base: int, value: int) -> None:
        tmp = 1
        for i in range(num_bits):
            bit = (value >> (num_bits - i - 1)) & 1
            self.encode_bit(probs, base + tmp, bool(bit))
            tmp = (tmp << 1) ^ bit

    def encode_reverse_bit_tree(
        self, num_bits: int, probs, base: int, offset: int, value: int
    ) -> None:
        tmp = 1
        for _ in range(num_bits):
            bit = value & 1
            value >>= 1
            self.encode_bit(probs, base + offset + tmp, bool(bit))
            tmp = (tmp << 1) ^ bit

    def encode_len(self, probs, base: int, pos_state: int, value: int) -> None:
        """Length coder (encode/rangecoder.rs:253-274): value in 0..=271."""
        is_low = value < 8
        self.encode_bit(probs, base + LEN_CHOICE, not is_low)
        if is_low:
            self.encode_bit_tree(3, probs, base + LEN_LOW + pos_state * 8, value)
            return
        is_middle = value < 16
        self.encode_bit(probs, base + LEN_CHOICE2, not is_middle)
        if is_middle:
            self.encode_bit_tree(3, probs, base + LEN_MID + pos_state * 8, value - 8)
            return
        self.encode_bit_tree(8, probs, base + LEN_HIGH, value - 16)


def fresh_probs(n: int) -> np.ndarray:
    """n probabilities at the neutral initial value 0x400."""
    return np.full(n, 0x400, dtype=np.uint16)
