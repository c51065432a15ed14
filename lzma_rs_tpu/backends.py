"""Decode-backend selection.

Three engines implement the same decode semantics:

- ``spec``: the pure-Python executable specification (oracle),
- ``native``: the C++ scalar runtime (fast host path, streaming engine),
- ``device``: the segment-parallel decode kernel through ``jax.ffi``
  (bulk path; one independent LZMA2 segment / .xz block per lane, lanes
  split across the local devices).

``LZMA_RS_TPU_BACKEND`` selects one (``auto`` by default). ``auto``
routes per stream (``runtime._resolve_auto_engine``): on a CUDA GPU a
stream with enough lanes and output, and no lane too long for one card
thread, decodes on the device engine; otherwise the native host engine
if built; otherwise spec. Raw
single-stream LZMA prefers the host under ``auto`` (one stream = one
lane = no parallelism for the card to exploit). All engines are
cross-validated bit-for-bit in the test suite.
"""

from __future__ import annotations

import os
from typing import Optional

from lzma_rs_tpu.models.codecs import Lzma2Decoder, LzmaDecoder, xz_decode_stream
from lzma_rs_tpu.formats.lzma_header import read_header
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.options import Options


BACKENDS = ("auto", "spec", "native", "device")


def _backend() -> str:
    backend = os.environ.get("LZMA_RS_TPU_BACKEND", "auto")
    if backend not in BACKENDS:
        raise ValueError(
            f"LZMA_RS_TPU_BACKEND={backend!r}: expected one of {BACKENDS}"
        )
    return backend


def _native():
    try:
        from lzma_rs_tpu.native import loader

        return loader.load()
    except Exception:
        return None


def lzma_decode(data: bytes, options: Options) -> bytes:
    """Raw-LZMA decode via the selected backend (LZMA_RS_TPU_BACKEND)."""
    cursor = ByteCursor(data)
    params = read_header(cursor, options)
    backend = _backend()
    if backend == "device":
        p = params.properties
        if (
            params.unpacked_size is not None
            and p.lc + p.lp <= 4
            and options.memlimit is None
        ):
            from lzma_rs_tpu.parallel import runtime

            return runtime.lzma_raw_decode_device(data, cursor.pos, params)
        # unknown size / big literal context / memlimit: host engines below
    if backend in ("auto", "native"):
        lib = _native()
        if lib is not None:
            res = lib.lzma_decode(data, cursor.pos, params, options.memlimit)
            if res is not None:
                return res
            if backend == "native":
                raise RuntimeError("native backend failed to decode")
    decoder = LzmaDecoder(params, options.memlimit)
    return decoder.decompress(cursor)


def lzma2_decode(data: bytes) -> bytes:
    """LZMA2 chunk-stream decode via the selected backend."""
    backend = _backend()
    if backend == "device" or (
        backend in ("auto", "native") and _native() is not None
    ):
        from lzma_rs_tpu.parallel import runtime

        return runtime.lzma2_decode(data, engine=backend)
    return Lzma2Decoder().decompress(ByteCursor(data))


def xz_decode(data: bytes) -> bytes:
    """.xz container decode via the selected backend."""
    backend = _backend()
    if backend == "device" or (
        backend in ("auto", "native") and _native() is not None
    ):
        # the device engine, or block/segment-parallel host cores
        from lzma_rs_tpu.parallel import runtime

        return runtime.xz_decode(data, engine=backend)
    return xz_decode_stream(ByteCursor(data))


def _native_lzma2_cursor(lib, cursor: ByteCursor) -> bytes:
    out, consumed = lib.lzma2_decode_at(bytes(cursor.buf), cursor.pos)
    cursor.pos += consumed
    return out
