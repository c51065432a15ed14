"""lzma_rs_tpu — a GPU-accelerated LZMA / LZMA2 / XZ codec framework.

A from-scratch re-design of the capabilities of the ``lzma-rs`` library
for an accelerator: the byte-serial reference decode loop runs once per
independent unit of the format (LZMA2 dict-reset segments, `.xz`
blocks), one unit per GPU thread through a CUDA kernel called with
``jax.ffi``, split across devices with ``shard_map``; the host runtime
(container parsing, streaming, checksums) has a native C++ fast path.

Public API mirrors the reference's eight free functions
(the reference's ``src/lib.rs:44-110``):

- :func:`lzma_decompress`, :func:`lzma_decompress_with_options`
- :func:`lzma_compress`, :func:`lzma_compress_with_options`
- :func:`lzma2_decompress`, :func:`lzma2_compress`
- :func:`xz_decompress`, :func:`xz_compress`

plus the module namespaces ``compress`` (options), ``decompress`` (options,
``Stream``, ``raw``) and ``error``.
"""

from __future__ import annotations

import os
from typing import BinaryIO, Optional, Union

from lzma_rs_tpu.utils import errors as error  # noqa: F401  (public module)
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import LzmaRsError
from lzma_rs_tpu.utils.options import (
    CompressOptions,
    Options,
    UnpackedSize,
    WriteUnpackedSize,
)

__version__ = "0.1.0"

_Input = Union[bytes, bytearray, memoryview, BinaryIO]

# Decode backend: "auto" picks the best available (native C++ for
# small/serial work, the device engine for bulk multi-segment streams on
# a CUDA GPU); "spec" forces the pure-Python executable spec; "native"
# forces C++; "device" forces the device engine (backends.py).
BACKEND = os.environ.get("LZMA_RS_TPU_BACKEND", "auto")


def _as_bytes(data: _Input) -> bytes:
    if isinstance(data, (bytes, bytearray, memoryview)):
        return bytes(data)
    return data.read()


def _emit(result: bytes, output: Optional[BinaryIO]) -> Optional[bytes]:
    if output is None:
        return result
    output.write(result)
    return None


# ---------------------------------------------------------------------------
# LZMA
# ---------------------------------------------------------------------------


def lzma_decompress(
    input: _Input, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress raw LZMA data with default options (src/lib.rs:44-49)."""
    return lzma_decompress_with_options(input, Options(), output)


def lzma_decompress_with_options(
    input: _Input, options: Options, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress raw LZMA data with the provided options (src/lib.rs:52-60)."""
    from lzma_rs_tpu import backends

    data = _as_bytes(input)
    return _emit(backends.lzma_decode(data, options), output)


def lzma_compress(input: _Input, output: Optional[BinaryIO] = None) -> Optional[bytes]:
    """Compress data as raw LZMA with default options (src/lib.rs:64-69)."""
    return lzma_compress_with_options(input, CompressOptions(), output)


def lzma_compress_with_options(
    input: _Input, options: CompressOptions, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Compress data as raw LZMA with the provided options (src/lib.rs:72-79)."""
    from lzma_rs_tpu.encode.lzma_enc import lzma_compress as _enc

    return _emit(_enc(_as_bytes(input), options), output)


# ---------------------------------------------------------------------------
# LZMA2
# ---------------------------------------------------------------------------


def lzma2_decompress(
    input: _Input, output: Optional[BinaryIO] = None
) -> Optional[bytes]:
    """Decompress an LZMA2 chunk stream (src/lib.rs:82-88)."""
    from lzma_rs_tpu import backends

    return _emit(backends.lzma2_decode(_as_bytes(input)), output)


def lzma2_compress(
    input: _Input,
    output: Optional[BinaryIO] = None,
    *,
    level: Optional[int] = 6,
    props: int = -1,
    dist_cap: int = 0,
) -> Optional[bytes]:
    """Compress data as an LZMA2 chunk stream (src/lib.rs:91-97).

    ``level`` 1-9 = real compression (beyond the reference's
    uncompressed-chunk writer); 0/None = stored chunks. ``props`` is a raw
    LZMA props byte or -1 for lc=3 lp=0 pb=2. ``dist_cap`` (0 = uncapped)
    bounds match distances (the ``tpu_profile`` archive shape)."""
    from lzma_rs_tpu.encode.lzma2_enc import lzma2_compress as _enc

    return _emit(
        _enc(_as_bytes(input), level, props=props, dist_cap=dist_cap),
        output,
    )


# ---------------------------------------------------------------------------
# XZ
# ---------------------------------------------------------------------------


def xz_decompress(input: _Input, output: Optional[BinaryIO] = None) -> Optional[bytes]:
    """Decompress a `.xz` stream (src/lib.rs:100-105)."""
    from lzma_rs_tpu import backends

    return _emit(backends.xz_decode(_as_bytes(input)), output)


def xz_compress(
    input: _Input,
    output: Optional[BinaryIO] = None,
    *,
    block_size: Optional[int] = None,
    check_method: int = 0,
    level: Optional[int] = 6,
    props: int = -1,
    dist_cap: int = 0,
    tpu_profile: bool = False,
) -> Optional[bytes]:
    """Compress data into a `.xz` stream (src/lib.rs:108-110).

    Extensions over the reference's one-block writer: ``block_size`` splits
    the input into independent blocks (block-parallel encode/decode) and
    ``check_method`` selects the per-block integrity check (0=None,
    1=CRC32, 4=CRC64), and ``level`` picks real compression (1-9, native
    greedy encoder) or stored chunks (0/None, the reference's writer).
    ``props`` is a raw LZMA props byte (-1 = lc=3 lp=0 pb=2).

    ``tpu_profile=True`` writes the many-small-lanes shape a parallel
    decoder was first tuned for: 8 KiB independent blocks, lc=0 (a
    768-entry literal table instead of 6144) and match distances capped
    at 2048 (``dist_cap``). It is a few % larger than the default; its
    decode speed on the GPU is not measured yet."""
    from lzma_rs_tpu.encode.xz_enc import xz_compress as _enc

    if tpu_profile:
        if block_size is None:
            block_size = 8192
        if props < 0:
            props = 0 + 9 * (0 + 5 * 2)  # lc=0 lp=0 pb=2
        if dist_cap == 0:
            dist_cap = 2048
    return _emit(
        _enc(_as_bytes(input), block_size=block_size,
             check_method=check_method, level=level, props=props,
             dist_cap=dist_cap),
        output,
    )


# ---------------------------------------------------------------------------
# Namespaces mirroring the reference's module layout (src/lib.rs:20-40)
# ---------------------------------------------------------------------------


class compress:  # noqa: N801 — namespace mirroring `lzma_rs::compress`
    """Compression options namespace."""

    Options = CompressOptions
    UnpackedSize = WriteUnpackedSize


class _RawNamespace:
    """Lazy proxy for the raw decoding primitives (`decompress::raw`)."""

    def __getattr__(self, name):
        import importlib

        raw_mod = importlib.import_module("lzma_rs_tpu.raw")
        return getattr(raw_mod, name)


class _DecompressMeta(type):
    @property
    def Stream(cls):
        from lzma_rs_tpu.stream import Stream as _Stream

        return _Stream

    @property
    def Lzma2Stream(cls):
        from lzma_rs_tpu.streams2 import Lzma2Stream as _S

        return _S

    @property
    def XzStream(cls):
        from lzma_rs_tpu.streams2 import XzStream as _S

        return _S


class decompress(metaclass=_DecompressMeta):  # noqa: N801 — `lzma_rs::decompress`
    """Decompression options / streaming / raw namespace."""

    Options = Options
    UnpackedSize = UnpackedSize
    raw = _RawNamespace()


def __getattr__(name):
    # Lazy imports to keep `import lzma_rs_tpu` light (no JAX import).
    if name == "Stream":
        from lzma_rs_tpu.stream import Stream

        return Stream
    if name in ("Lzma2Stream", "XzStream"):
        import importlib

        return getattr(
            importlib.import_module("lzma_rs_tpu.streams2"), name
        )
    if name == "raw":
        import importlib

        return importlib.import_module("lzma_rs_tpu.raw")
    raise AttributeError(name)


__all__ = [
    "lzma_decompress",
    "lzma_decompress_with_options",
    "lzma_compress",
    "lzma_compress_with_options",
    "lzma2_decompress",
    "lzma2_compress",
    "xz_decompress",
    "xz_compress",
    "compress",
    "decompress",
    "error",
    "Options",
    "CompressOptions",
    "UnpackedSize",
    "WriteUnpackedSize",
    "LzmaRsError",
    "Stream",
    "raw",
]
