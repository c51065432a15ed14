"""Raw LZMA 13-byte header parsing/serialization.

Behavioral spec from the reference ``LzmaParams::read_header``
(lzma-rs ``src/decode/lzma.rs:96-161``):

- props byte ``p < 225``; ``lc = p % 9``, ``lp = (p/9) % 5``, ``pb = p/45``,
- dict size: u32 LE, clamped up to at least ``0x1000``,
- unpacked size: 8-byte LE u64 (``0xFFFF_FFFF_FFFF_FFFF`` = unknown, EOS
  marker expected), presence/interpretation governed by the three
  ``UnpackedSize`` option modes.

Truncation raises :class:`HeaderTooShort` (retryable for streaming).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import HeaderTooShort, IoError, LzmaError, UNEXPECTED_EOF
from lzma_rs_tpu.utils.options import Options, _UnpackedSizeKind

EOS_SIZE_FIELD = 0xFFFF_FFFF_FFFF_FFFF


@dataclasses.dataclass(frozen=True)
class LzmaProperties:
    """The LZMA "lclppb" properties (reference ``LzmaProperties``,
    src/decode/lzma.rs:43-58)."""

    lc: int  # 0..=8
    lp: int  # 0..=4
    pb: int  # 0..=4

    def validate(self) -> None:
        """Reject lc+lp+pb > 10 or lc > 8 (lzma.rs:113-118 properties split)."""
        assert 0 <= self.lc <= 8
        assert 0 <= self.lp <= 4
        assert 0 <= self.pb <= 4

    @property
    def props_byte(self) -> int:
        return self.lc + 9 * (self.lp + 5 * self.pb)


@dataclasses.dataclass(frozen=True)
class LzmaParams:
    """LZMA decompression parameters (reference ``LzmaParams``,
    src/decode/lzma.rs:69-78)."""

    properties: LzmaProperties
    dict_size: int
    unpacked_size: Optional[int]


def parse_props_byte(props: int, context: str = "LZMA header") -> LzmaProperties:
    """Decode an lclppb properties byte (src/decode/lzma.rs:103-114)."""
    if props >= 225:
        raise LzmaError(f"{context} invalid properties: {props} must be < 225")
    lc = props % 9
    rest = props // 9
    lp = rest % 5
    pb = rest // 5
    return LzmaProperties(lc=lc, lp=lp, pb=pb)


def read_header(cursor: ByteCursor, options: Options) -> LzmaParams:
    """Parse the raw-LZMA stream header per the reference semantics."""
    try:
        props = cursor.read_u8()
    except IoError:
        raise HeaderTooShort(UNEXPECTED_EOF) from None

    properties = parse_props_byte(props)

    try:
        dict_size_provided = cursor.read_u32_le()
    except IoError:
        raise HeaderTooShort(UNEXPECTED_EOF) from None
    dict_size = max(dict_size_provided, 0x1000)

    mode = options.unpacked_size
    if mode.kind is _UnpackedSizeKind.READ_FROM_HEADER:
        try:
            provided = cursor.read_u64_le()
        except IoError:
            raise HeaderTooShort(UNEXPECTED_EOF) from None
        unpacked_size = None if provided == EOS_SIZE_FIELD else provided
    elif mode.kind is _UnpackedSizeKind.READ_HEADER_BUT_USE_PROVIDED:
        try:
            cursor.read_u64_le()
        except IoError:
            raise HeaderTooShort(UNEXPECTED_EOF) from None
        unpacked_size = mode.value
    else:  # USE_PROVIDED
        unpacked_size = mode.value

    return LzmaParams(
        properties=properties, dict_size=dict_size, unpacked_size=unpacked_size
    )


def serialize_header(
    properties: LzmaProperties,
    dict_size: int,
    unpacked_size_field: Optional[int],
    write_size_field: bool,
) -> bytes:
    """Build the 5- or 13-byte raw LZMA header (reference encoder writes it
    at src/encode/dumbencoder.rs:27-52)."""
    out = bytearray([properties.props_byte])
    out += dict_size.to_bytes(4, "little")
    if write_size_field:
        field = EOS_SIZE_FIELD if unpacked_size_field is None else unpacked_size_field
        out += field.to_bytes(8, "little")
    return bytes(out)
