"""Executable specification of the LZMA decoder (scalar, host-side).

This is the oracle for the device kernels: a byte-at-a-time decoder whose
behavior (outputs AND error strings) matches the reference implementation
(lzma-rs ``src/decode/{rangecoder,lzma,lzbuffer}.rs``). It is
deliberately simple and slow; bulk decoding goes through the native C++
runtime or the device engine, both of which are validated
bit-for-bit against this spec and against golden corpus files.

Algorithmic spec (file:line refer to the reference):

- range decoder: init skips one byte then reads a big-endian u32
  (rangecoder.rs:26-27); ``decode_bit`` computes ``bound = (range >> 11) *
  prob`` with adaptive update ``prob += (0x800 - prob) >> 5`` /
  ``prob -= prob >> 5`` (rangecoder.rs:93-120); renormalize shifts in one
  stream byte when ``range < 1 << 24`` (rangecoder.rs:60-69),
- 12-state literal/match/rep machine with LRU ``rep[4]``
  (lzma.rs:278-393),
- matched-literal decoding when ``state >= 7`` (lzma.rs:526-561),
- distance decode via pos_slot tree / direct bits / align tree
  (lzma.rs:563-592),
- EOS marker = distance field 0xFFFF_FFFF (lzma.rs:374-381),
- streaming partial-input machinery: <= 20 bytes buffered, trial decode
  with ``update=False`` (lzma.rs:9-13, 403-419).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from lzma_rs_tpu.models import state as state_mod
from lzma_rs_tpu.models.state import (
    LEN_CHOICE,
    LEN_CHOICE2,
    LEN_HIGH,
    LEN_LOW,
    LEN_MID,
    PROB_INIT,
    ProbLayout,
    make_layout,
)
from lzma_rs_tpu.utils.errors import IoError, LzmaError, UNEXPECTED_EOF
from lzma_rs_tpu.utils import logging as _log
from lzma_rs_tpu.formats.lzma_header import LzmaProperties

MAX_REQUIRED_INPUT = 20  # lzma.rs:13

CONTINUE = 0
FINISHED = 1


class RangeDecoder:
    """Scalar adaptive binary range decoder (rangecoder.rs:7-152)."""

    __slots__ = ("buf", "pos", "end", "range", "code")

    def __init__(self, buf, pos: int = 0, end: Optional[int] = None):
        self.buf = buf
        self.pos = pos
        self.end = len(buf) if end is None else end
        self.range = 0xFFFFFFFF
        self.code = 0

    def init_code(self) -> None:
        """Skip one byte, read u32 BE code (rangecoder.rs:26-27)."""
        if self.end - self.pos < 5:
            self.pos = self.end
            raise IoError(UNEXPECTED_EOF)
        self.pos += 1
        self.code = int.from_bytes(self.buf[self.pos : self.pos + 4], "big")
        self.pos += 4

    @classmethod
    def new(cls, buf, pos: int = 0, end: Optional[int] = None) -> "RangeDecoder":
        dec = cls(buf, pos, end)
        dec.init_code()
        return dec

    @classmethod
    def from_parts(
        cls, buf, range_: int, code: int, pos: int = 0, end: Optional[int] = None
    ) -> "RangeDecoder":
        dec = cls(buf, pos, end)
        dec.range = range_
        dec.code = code
        return dec

    def set(self, range_: int, code: int) -> None:
        self.range = range_
        self.code = code

    def is_eof(self) -> bool:
        return self.pos >= self.end

    def is_finished_ok(self) -> bool:
        return self.code == 0 and self.is_eof()

    def _read_u8(self) -> int:
        if self.pos >= self.end:
            raise IoError(UNEXPECTED_EOF)
        b = self.buf[self.pos]
        self.pos += 1
        return b

    def normalize(self) -> None:
        if _log.LOG_ENABLED:
            _log.trace("  { range: %08x, code: %08x }", self.range, self.code)
        if self.range < 0x0100_0000:
            self.range = (self.range << 8) & 0xFFFFFFFF
            self.code = ((self.code << 8) ^ self._read_u8()) & 0xFFFFFFFF
            if _log.LOG_ENABLED:
                _log.debug(
                    "+ { range: %08x, code: %08x }", self.range, self.code
                )

    def get_bit(self) -> int:
        self.range >>= 1
        bit = self.code >= self.range
        if bit:
            self.code -= self.range
        self.normalize()
        return int(bit)

    def get(self, count: int) -> int:
        result = 0
        for _ in range(count):
            result = (result << 1) ^ self.get_bit()
        return result

    def decode_bit(self, probs: np.ndarray, idx: int, update: bool) -> int:
        prob = int(probs[idx])
        bound = (self.range >> 11) * prob
        if _log.LOG_ENABLED:
            # per-bit trace, matching rangecoder.rs:96-101 — the debugging
            # affordance lives only on the interpret-mode/spec path
            # (SURVEY.md §5: kernels never log)
            _log.trace(
                " bound: %08x, prob: %04x, bit: %d",
                bound, prob, int(self.code > bound),
            )
        if self.code < bound:
            if update:
                probs[idx] = prob + ((0x800 - prob) >> 5)
            self.range = bound
            self.normalize()
            return 0
        else:
            if update:
                probs[idx] = prob - (prob >> 5)
            self.code -= bound
            self.range -= bound
            self.normalize()
            return 1

    def parse_bit_tree(
        self, num_bits: int, probs: np.ndarray, base: int, update: bool
    ) -> int:
        tmp = 1
        for _ in range(num_bits):
            bit = self.decode_bit(probs, base + tmp, update)
            tmp = (tmp << 1) ^ bit
        return tmp - (1 << num_bits)

    def parse_reverse_bit_tree(
        self, num_bits: int, probs: np.ndarray, base: int, offset: int, update: bool
    ) -> int:
        result = 0
        tmp = 1
        for i in range(num_bits):
            bit = self.decode_bit(probs, base + offset + tmp, update)
            tmp = (tmp << 1) ^ bit
            result ^= bit << i
        return result


class AccumBuffer:
    """LZ output buffer that accumulates everything (lzbuffer.rs:39-165).

    ``reset()`` flushes to the sink on LZMA2 dict reset; ``len`` restarts at
    zero, which is what makes pos_state/literal contexts segment-local.
    """

    __slots__ = ("buf", "flushed", "memlimit", "len")

    def __init__(self, memlimit: Optional[int] = None):
        self.buf = bytearray()
        self.flushed = bytearray()
        self.memlimit = memlimit if memlimit is not None else float("inf")
        self.len = 0

    def append_bytes(self, data) -> None:
        self.buf += data
        self.len += len(data)

    def reset(self) -> None:
        self.flushed += self.buf
        self.buf.clear()
        self.len = 0

    def last_or(self, lit: int) -> int:
        return self.buf[-1] if self.buf else lit

    def last_n(self, dist: int) -> int:
        if dist > len(self.buf):
            raise LzmaError(
                f"Match distance {dist} is beyond output size {len(self.buf)}"
            )
        return self.buf[-dist]

    def append_literal(self, lit: int) -> None:
        if self.len + 1 > self.memlimit:
            raise LzmaError(f"exceeded memory limit of {self.memlimit}")
        self.buf.append(lit)
        self.len += 1

    def append_lz(self, length: int, dist: int) -> None:
        if dist > len(self.buf):
            raise LzmaError(
                f"LZ distance {dist} is beyond output size {len(self.buf)}"
            )
        offset = len(self.buf) - dist
        for _ in range(length):
            self.buf.append(self.buf[offset])
            offset += 1
        self.len += length

    def finish(self) -> bytes:
        self.flushed += self.buf
        self.buf.clear()
        return bytes(self.flushed)


class CircularBuffer:
    """Dict-sized ring buffer (lzbuffer.rs:167-321), lazily grown up to
    memlimit, flushing to an output accumulator on each wrap."""

    __slots__ = ("out", "buf", "dict_size", "memlimit", "cursor", "len")

    def __init__(self, dict_size: int, memlimit: Optional[int] = None):
        self.out = bytearray()
        self.buf = bytearray()
        self.dict_size = dict_size
        self.memlimit = memlimit if memlimit is not None else float("inf")
        self.cursor = 0
        self.len = 0

    def _get(self, index: int) -> int:
        return self.buf[index] if index < len(self.buf) else 0

    def _set(self, index: int, value: int) -> None:
        if len(self.buf) < index + 1:
            if index + 1 <= self.memlimit:
                self.buf.extend(b"\x00" * (index + 1 - len(self.buf)))
            else:
                raise LzmaError(f"exceeded memory limit of {self.memlimit}")
        self.buf[index] = value

    def last_or(self, lit: int) -> int:
        if self.len == 0:
            return lit
        return self._get((self.dict_size + self.cursor - 1) % self.dict_size)

    def last_n(self, dist: int) -> int:
        if dist > self.dict_size:
            raise LzmaError(
                f"Match distance {dist} is beyond dictionary size {self.dict_size}"
            )
        if dist > self.len:
            raise LzmaError(
                f"Match distance {dist} is beyond output size {self.len}"
            )
        return self._get((self.dict_size + self.cursor - dist) % self.dict_size)

    def append_literal(self, lit: int) -> None:
        self._set(self.cursor, lit)
        self.cursor += 1
        self.len += 1
        if self.cursor == self.dict_size:
            self.out += self.buf
            self.cursor = 0

    def append_lz(self, length: int, dist: int) -> None:
        if dist > self.dict_size:
            raise LzmaError(
                f"LZ distance {dist} is beyond dictionary size {self.dict_size}"
            )
        if dist > self.len:
            raise LzmaError(f"LZ distance {dist} is beyond output size {self.len}")
        offset = (self.dict_size + self.cursor - dist) % self.dict_size
        for _ in range(length):
            x = self._get(offset)
            self.append_literal(x)
            offset += 1
            if offset == self.dict_size:
                offset = 0

    def finish(self) -> bytes:
        if self.cursor > 0:
            self.out += self.buf[: self.cursor]
        return bytes(self.out)


class DecoderState:
    """The LZMA symbol state machine over the flat probability table."""

    def __init__(
        self,
        props: LzmaProperties,
        unpacked_size: Optional[int],
        layout: Optional[ProbLayout] = None,
    ):
        props.validate()
        self.props = props
        self.unpacked_size = unpacked_size
        self.layout = layout or make_layout(props.lc + props.lp)
        if (1 << (props.lc + props.lp)) > self.layout.nlit:
            self.layout = make_layout(props.lc + props.lp)
        self.probs = state_mod.fresh_probs(self.layout)
        self.state = 0
        self.rep = [0, 0, 0, 0]
        self.partial: bytearray = bytearray()  # streaming partial-input buffer

    def reset_state(self, new_props: LzmaProperties) -> None:
        new_props.validate()
        if (1 << (new_props.lc + new_props.lp)) > self.layout.nlit:
            self.layout = make_layout(new_props.lc + new_props.lp)
            self.probs = state_mod.fresh_probs(self.layout)
        else:
            self.probs.fill(PROB_INIT)
        self.props = new_props
        self.state = 0
        self.rep = [0, 0, 0, 0]

    def set_unpacked_size(self, unpacked_size: Optional[int]) -> None:
        self.unpacked_size = unpacked_size

    # -- symbol decode ---------------------------------------------------

    def _decode_literal(self, output, rc: RangeDecoder, update: bool) -> int:
        L = self.layout
        prev_byte = output.last_or(0)
        result = 1
        lit_state = (
            (output.len & ((1 << self.props.lp) - 1)) << self.props.lc
        ) + (prev_byte >> (8 - self.props.lc))
        base = L.lit + lit_state * 0x300

        if self.state >= 7:
            match_byte = output.last_n(self.rep[0] + 1)
            while result < 0x100:
                match_bit = (match_byte >> 7) & 1
                match_byte = (match_byte << 1) & 0xFF
                bit = rc.decode_bit(
                    self.probs, base + ((1 + match_bit) << 8) + result, update
                )
                result = (result << 1) ^ bit
                if match_bit != bit:
                    break

        while result < 0x100:
            result = (result << 1) ^ rc.decode_bit(self.probs, base + result, update)

        return result - 0x100

    def _decode_len(
        self, rc: RangeDecoder, pos_state: int, update: bool, rep: bool
    ) -> int:
        L = self.layout
        base = L.rep_len_coder if rep else L.len_coder
        if not rc.decode_bit(self.probs, base + LEN_CHOICE, update):
            return rc.parse_bit_tree(3, self.probs, base + LEN_LOW + pos_state * 8, update)
        elif not rc.decode_bit(self.probs, base + LEN_CHOICE2, update):
            return 8 + rc.parse_bit_tree(
                3, self.probs, base + LEN_MID + pos_state * 8, update
            )
        else:
            return 16 + rc.parse_bit_tree(8, self.probs, base + LEN_HIGH, update)

    def _decode_distance(self, rc: RangeDecoder, length: int, update: bool) -> int:
        L = self.layout
        len_state = min(length, 3)
        pos_slot = rc.parse_bit_tree(6, self.probs, L.pos_slot + len_state * 64, update)
        if pos_slot < 4:
            return pos_slot
        num_direct_bits = (pos_slot >> 1) - 1
        result = (2 | (pos_slot & 1)) << num_direct_bits
        if pos_slot < 14:
            result += rc.parse_reverse_bit_tree(
                num_direct_bits, self.probs, L.spec_pos, result - pos_slot, update
            )
        else:
            result += rc.get(num_direct_bits - 4) << 4
            result += rc.parse_reverse_bit_tree(4, self.probs, L.align, 0, update)
        return result

    def process_next_inner(self, output, rc: RangeDecoder, update: bool) -> int:
        L = self.layout
        pos_state = output.len & ((1 << self.props.pb) - 1)

        if not rc.decode_bit(
            self.probs, L.is_match + (self.state << 4) + pos_state, update
        ):
            byte = self._decode_literal(output, rc, update)
            if update:
                output.append_literal(byte)
                self.state = int(state_mod.STATE_AFTER_LIT[self.state])
            return CONTINUE

        if rc.decode_bit(self.probs, L.is_rep + self.state, update):
            # Repeated distance
            if not rc.decode_bit(self.probs, L.is_rep_g0 + self.state, update):
                if not rc.decode_bit(
                    self.probs, L.is_rep_0long + (self.state << 4) + pos_state, update
                ):
                    if update:
                        self.state = int(state_mod.STATE_AFTER_SHORTREP[self.state])
                        output.append_lz(1, self.rep[0] + 1)
                    return CONTINUE
            else:
                if not rc.decode_bit(self.probs, L.is_rep_g1 + self.state, update):
                    idx = 1
                elif not rc.decode_bit(self.probs, L.is_rep_g2 + self.state, update):
                    idx = 2
                else:
                    idx = 3
                if update:
                    dist = self.rep[idx]
                    for i in range(idx - 1, -1, -1):
                        self.rep[i + 1] = self.rep[i]
                    self.rep[0] = dist

            length = self._decode_len(rc, pos_state, update, rep=True)
            if update:
                self.state = int(state_mod.STATE_AFTER_REP[self.state])
        else:
            # New distance
            if update:
                self.rep[3] = self.rep[2]
                self.rep[2] = self.rep[1]
                self.rep[1] = self.rep[0]
            length = self._decode_len(rc, pos_state, update, rep=False)
            if update:
                self.state = int(state_mod.STATE_AFTER_MATCH[self.state])
            rep_0 = self._decode_distance(rc, length, update)
            if update:
                self.rep[0] = rep_0
                if rep_0 == 0xFFFFFFFF:
                    if rc.is_finished_ok():
                        return FINISHED
                    raise LzmaError(
                        "Found end-of-stream marker but more bytes are available"
                    )

        if update:
            length += 2
            output.append_lz(length, self.rep[0] + 1)
        return CONTINUE

    # -- processing loop -------------------------------------------------

    def process(self, output, rc: RangeDecoder) -> None:
        self.process_mode(output, rc, partial=False)

    def process_stream(self, output, rc: RangeDecoder) -> None:
        self.process_mode(output, rc, partial=True)

    def try_process_next(self, output, buf, range_: int, code: int) -> bool:
        """Dry-run one symbol with update=False; True iff enough input
        (lzma.rs:403-419)."""
        rc = RangeDecoder.from_parts(buf, range_, code)
        try:
            self.process_next_inner(output, rc, update=False)
            return True
        except (IoError, LzmaError):
            return False

    def process_mode(self, output, rc: RangeDecoder, partial: bool) -> None:
        while True:
            if self.unpacked_size is not None:
                if output.len >= self.unpacked_size:
                    break
            else:
                if partial:
                    if rc.is_eof() and not self.partial:
                        break
                else:
                    if rc.is_finished_ok() and not self.partial:
                        break

            if self.partial:
                # Top up the partial buffer from the stream.
                want = MAX_REQUIRED_INPUT - len(self.partial)
                take = min(want, rc.end - rc.pos)
                self.partial += rc.buf[rc.pos : rc.pos + take]
                rc.pos += take

                if (
                    partial
                    and len(self.partial) < MAX_REQUIRED_INPUT
                    and not self.try_process_next(
                        output, bytes(self.partial), rc.range, rc.code
                    )
                ):
                    return

                tmp_rc = RangeDecoder.from_parts(
                    bytes(self.partial), rc.range, rc.code
                )
                res = self.process_next_inner(output, tmp_rc, update=True)
                rc.set(tmp_rc.range, tmp_rc.code)
                del self.partial[: tmp_rc.pos]
                if res == FINISHED:
                    break
            else:
                remaining = rc.end - rc.pos
                if partial and remaining < MAX_REQUIRED_INPUT:
                    if not self.try_process_next(
                        output,
                        bytes(rc.buf[rc.pos : rc.end]),
                        rc.range,
                        rc.code,
                    ):
                        # Buffer the remainder and wait for more data.
                        self.partial += rc.buf[rc.pos : rc.end]
                        rc.pos = rc.end
                        return
                if self.process_next_inner(output, rc, update=True) == FINISHED:
                    break

        if self.unpacked_size is not None and not partial:
            if self.unpacked_size != output.len:
                raise LzmaError(
                    f"Expected unpacked size of {self.unpacked_size} but "
                    f"decompressed to {output.len}"
                )
