"""CRC32 (ISO-HDLC) and CRC64 (XZ) checksums.

The reference takes both from the ``crc`` crate
(lzma-rs ``src/xz/crc.rs:3-4``): CRC32 = CRC_32_ISO_HDLC (reflected,
poly 0xEDB88320, init/xorout all-ones — identical to zlib.crc32) and CRC64 =
CRC_64_XZ (reflected, poly 0xC96C5795D7870F42, init/xorout all-ones).

Host path: CRC32 via zlib (C speed); CRC64 via a NumPy slice-by-8 table
kernel, with an optional C++ native fast path (lzma_rs_tpu.native) that is
used automatically when the shared library has been built. An on-device
CRC kernel lives in ``lzma_rs_tpu.ops.crc_device`` and is validated
against these host implementations.
"""

from __future__ import annotations

import zlib

import numpy as np

_CRC64_POLY = 0xC96C5795D7870F42  # reflected form


def _build_crc64_tables(slices: int = 8) -> np.ndarray:
    table = np.zeros((slices, 256), dtype=np.uint64)
    t0 = np.zeros(256, dtype=np.uint64)
    for i in range(256):
        crc = i
        for _ in range(8):
            if crc & 1:
                crc = (crc >> 1) ^ _CRC64_POLY
            else:
                crc >>= 1
        t0[i] = crc
    table[0] = t0
    for s in range(1, slices):
        prev = table[s - 1]
        table[s] = t0[(prev & np.uint64(0xFF)).astype(np.int64)] ^ (prev >> np.uint64(8))
    return table


_CRC64_TABLES = _build_crc64_tables()
_T = [_CRC64_TABLES[i] for i in range(8)]


def crc32(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """CRC-32/ISO-HDLC over ``data`` (matches the reference's CRC32)."""
    # zlib accepts any buffer; avoid copying large block slices
    return zlib.crc32(data, value) & 0xFFFFFFFF


class Crc32Digest:
    """Incremental CRC32, mirroring the reference's digest taps
    (``src/decode/util.rs:37-67``)."""

    def __init__(self) -> None:
        self._value = 0

    def update(self, data: bytes | bytearray | memoryview) -> None:
        self._value = zlib.crc32(bytes(data), self._value) & 0xFFFFFFFF

    def finalize(self) -> int:
        return self._value


def _crc64_numpy(data: np.ndarray, crc: int) -> int:
    """Slice-by-8 CRC64 over a uint8 array."""
    n = data.size
    crc = np.uint64(crc)
    head = n % 8
    # Process unaligned head bytewise.
    for b in data[:head]:
        crc = _T[0][int((crc ^ np.uint64(b)) & np.uint64(0xFF))] ^ (crc >> np.uint64(8))
    body = data[head:]
    if body.size:
        # Slice-by-8: x = crc ^ le64(next 8 bytes);
        # crc' = T7[x_0] ^ T6[x_1] ^ ... ^ T0[x_7] (x_i = i-th LE byte of x).
        words = body.view("<u8")
        crc_v = int(crc)
        T = _T
        for w in words.tolist():
            x = crc_v ^ w
            crc_v = int(
                T[7][x & 0xFF]
                ^ T[6][(x >> 8) & 0xFF]
                ^ T[5][(x >> 16) & 0xFF]
                ^ T[4][(x >> 24) & 0xFF]
                ^ T[3][(x >> 32) & 0xFF]
                ^ T[2][(x >> 40) & 0xFF]
                ^ T[1][(x >> 48) & 0xFF]
                ^ T[0][(x >> 56) & 0xFF]
            )
        crc = np.uint64(crc_v)
    return int(crc)


def crc64(data: bytes | bytearray | memoryview, value: int = 0) -> int:
    """CRC-64/XZ over ``data`` (matches the reference's CRC64).

    Zero-copy for bytearray/memoryview inputs (block-check verification
    hashes large slices of the shared output buffer)."""
    native = _native_crc64()
    crc = value ^ 0xFFFFFFFFFFFFFFFF
    arr = np.frombuffer(data, dtype=np.uint8)
    if native is not None:
        crc = native(arr, crc)
    else:
        crc = _crc64_numpy(arr, crc)
    return crc ^ 0xFFFFFFFFFFFFFFFF


_NATIVE_CRC64 = None
_NATIVE_TRIED = False


def _native_crc64():
    """C++ slice-by-8 CRC64 from lzma_rs_tpu/native, if built."""
    global _NATIVE_CRC64, _NATIVE_TRIED
    if not _NATIVE_TRIED:
        _NATIVE_TRIED = True
        try:
            from lzma_rs_tpu.native import loader

            lib = loader.load()
            if lib is not None:
                _NATIVE_CRC64 = lib.crc64_update
        except Exception:
            _NATIVE_CRC64 = None
    return _NATIVE_CRC64
