"""LZMA2 chunk-layer scanning.

The reference decodes LZMA2 with a sequential chunk loop
(lzma-rs ``src/decode/lzma2.rs:59-78``). Because every chunk header
carries exact packed/unpacked sizes (``:128-136``), the chunk table of a
stream can be recovered *without decoding any payload* — a cheap host-side
scan. That table is the foundation of the parallel design: chunks between
dictionary resets form independent "segments" that decode in parallel across
lanes / devices, while chunks within a segment share a window and
probability state and stay sequential.

Chunk grammar (decode/lzma2.rs:59-136):

- control ``0x00``: end of stream,
- control ``0x01``: uncompressed chunk, reset dict; ``u16be+1`` bytes follow,
- control ``0x02``: uncompressed chunk, no reset; ``u16be+1`` bytes follow,
- control ``>= 0x80``: LZMA chunk; ``unpacked = ((c & 0x1F) << 16 | u16be) + 1``,
  ``packed = u16be + 1``, reset mode ``(c >> 5) & 3`` in {0: nothing,
  1: reset state, 2: reset state+props (props byte follows), 3: reset
  dict+state+props},
- anything else (0x03..0x7F): invalid.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import IoError, LzmaError
from lzma_rs_tpu.formats.lzma_header import LzmaProperties, parse_props_byte

KIND_UNCOMPRESSED = 0
KIND_LZMA = 1


@dataclasses.dataclass
class Lzma2Chunk:
    """One scanned LZMA2 chunk (sizes in bytes, offsets into the scanned
    buffer)."""

    kind: int
    control: int
    reset_dict: bool
    reset_state: bool
    reset_props: bool
    props: Optional[LzmaProperties]  # set when reset_props
    unpacked_size: int
    packed_size: int  # == unpacked_size for uncompressed chunks
    data_off: int  # offset of payload start
    # Filled by the scanner: cumulative output offset of this chunk within
    # the stream, and the index of the segment (dict-reset group) it belongs
    # to.
    out_off: int = 0
    segment: int = 0


@dataclasses.dataclass
class Lzma2ChunkTable:
    chunks: List[Lzma2Chunk]
    end_off: int  # offset just past the terminating 0x00 control byte
    total_unpacked: int
    num_segments: int
    # Header error hit AFTER at least one recorded chunk: the reference's
    # sequential loop would decode the prefix first, so callers must
    # execute the recorded chunks and only then surface this error
    # (decode/lzma2.rs processes one chunk at a time).
    pending_error: Optional[Exception] = None

    def segments(self) -> List[List[Lzma2Chunk]]:
        segs: List[List[Lzma2Chunk]] = [[] for _ in range(self.num_segments)]
        for c in self.chunks:
            segs[c.segment].append(c)
        return segs


def _eof_err(what: str) -> LzmaError:
    # The reference maps truncation inside the chunk loop to LzmaError with
    # the underlying io message appended (decode/lzma2.rs:60-62,128-136).
    return LzmaError(f"{what}: failed to fill whole buffer")


def scan(cursor: ByteCursor) -> Lzma2ChunkTable:
    """Walk chunk headers from ``cursor`` until the end marker.

    Raises the same errors the reference's chunk loop raises for malformed
    headers. The cursor is left positioned just past the end marker.
    """
    chunks: List[Lzma2Chunk] = []
    out_off = 0
    segment = -1
    pending_error: Optional[Exception] = None
    while True:
        try:
            try:
                control = cursor.read_u8()
            except IoError:
                raise _eof_err("LZMA2 expected new status") from None

            if control == 0:
                break

            if control in (1, 2):
                try:
                    unpacked = cursor.read_u16_be() + 1
                except IoError:
                    raise _eof_err("LZMA2 expected unpacked size") from None
                reset_dict = control == 1
                if reset_dict or segment < 0:
                    segment += 1
                if reset_dict:
                    out_off = 0
                data_off = cursor.pos
                try:
                    cursor.skip(unpacked)
                except IoError:
                    raise LzmaError(
                        f"LZMA2 expected {unpacked} uncompressed bytes: "
                        "failed to fill whole buffer"
                    ) from None
                chunks.append(
                    Lzma2Chunk(
                        kind=KIND_UNCOMPRESSED,
                        control=control,
                        reset_dict=reset_dict,
                        reset_state=False,
                        reset_props=False,
                        props=None,
                        unpacked_size=unpacked,
                        packed_size=unpacked,
                        data_off=data_off,
                        out_off=out_off,
                        segment=segment,
                    )
                )
                out_off += unpacked
                continue

            if control < 0x80:
                raise LzmaError(
                    f"LZMA2 invalid status {control}, must be 0, 1, 2 or >= 128"
                )

            reset_mode = (control >> 5) & 0x3
            reset_dict = reset_mode == 3
            reset_state = reset_mode >= 1
            reset_props = reset_mode >= 2

            try:
                unpacked = cursor.read_u16_be()
            except IoError:
                raise _eof_err("LZMA2 expected unpacked size") from None
            unpacked = (((control & 0x1F) << 16) | unpacked) + 1
            try:
                packed = cursor.read_u16_be() + 1
            except IoError:
                raise _eof_err("LZMA2 expected packed size") from None

            props: Optional[LzmaProperties] = None
            if reset_props:
                try:
                    props_byte = cursor.read_u8()
                except IoError:
                    raise _eof_err("LZMA2 expected new properties") from None
                props = parse_props_byte(props_byte, context="LZMA2")
                if props.lc + props.lp > 4:
                    raise LzmaError(
                        f"LZMA2 invalid properties: lc + lp ({props.lc} + {props.lp}) "
                        "must be <= 4"
                    )

            if reset_dict or segment < 0:
                segment += 1
            if reset_dict:
                out_off = 0

            data_off = cursor.pos
            # Payload truncation is detected at decode time (the reference's
            # range decoder hits EOF); the scanner just records the extent and
            # clips, so a truncated trailing chunk still surfaces the decode-time
            # error rather than a scan-time one.
            avail = min(packed, cursor.remaining())
            cursor.skip(avail)
            truncated = avail < packed

            chunks.append(
                Lzma2Chunk(
                    kind=KIND_LZMA,
                    control=control,
                    reset_dict=reset_dict,
                    reset_state=reset_state,
                    reset_props=reset_props,
                    props=props,
                    unpacked_size=unpacked,
                    packed_size=packed,
                    data_off=data_off,
                    out_off=out_off,
                    segment=segment,
                )
            )
            out_off += unpacked
            if truncated:
                # Mid-payload truncation: the reference fails INSIDE this
                # chunk's decode (bare IoError), never reaching the next
                # status byte — scanning further would surface a scan-time
                # "LZMA2 expected new status" instead of the decode error.
                break
        except (LzmaError, IoError) as e:
            if chunks:
                # sequential parity: the reference decodes the
                # already-seen chunks before reaching this header,
                # so their decode errors must surface first
                pending_error = e
                break
            raise

    # Dict resets flush (not discard) the accumulated output, so the stream's
    # total output is simply the sum of all chunk unpacked sizes.
    total = sum(c.unpacked_size for c in chunks)
    return Lzma2ChunkTable(
        chunks=chunks,
        end_off=cursor.pos,
        total_unpacked=total,
        num_segments=segment + 1,
        pending_error=pending_error,
    )
