"""Chunk-granular LZMA2/.xz streaming decoders (streams2.py).

The reference only streams raw LZMA; these are capability extensions, so
the oracle is one-shot equivalence: for every chunking of the input, the
streamed output must equal the one-shot decode, and the same corrupt
inputs must fail (poisoning the stream like decompress::Stream does,
lzma-rs src/decode/stream.rs:461-472).
"""

import lzma as liblzma

import pytest

from lzma_rs_tpu.streams2 import Lzma2Stream, XzStream
from lzma_rs_tpu.utils.errors import LzmaRsError

from conftest import read_ref


def _rawlzma2(data: bytes, preset: int = 6) -> bytes:
    return liblzma.compress(
        data, format=liblzma.FORMAT_RAW,
        filters=[{"id": liblzma.FILTER_LZMA2, "preset": preset}],
    )


def _feed(stream_cls, compressed: bytes, chunk: int) -> bytes:
    s = stream_cls()
    for off in range(0, len(compressed), chunk):
        s.write(compressed[off : off + chunk])
    return s.finish()


class TestLzma2Stream:
    @pytest.mark.parametrize("chunk", [1, 7, 64, 1024, 1 << 20])
    def test_chunked_equals_oneshot(self, chunk):
        data = read_ref("foo.txt")[:20000]
        c = _rawlzma2(data)
        assert _feed(Lzma2Stream, c, chunk) == data

    def test_multi_chunk_stream(self):
        import lzma_rs_tpu

        data = read_ref("foo.txt") * 2  # > 64 KiB -> several chunks
        c = lzma_rs_tpu.lzma2_compress(data, level=6)
        assert _feed(Lzma2Stream, c, 999) == data

    def test_uncompressed_chunks(self):
        import lzma_rs_tpu

        data = read_ref("foo.txt")[:5000]
        c = lzma_rs_tpu.lzma2_compress(data, level=0)  # stored chunks
        assert _feed(Lzma2Stream, c, 13) == data

    def test_sink(self):
        import io

        data = read_ref("foo.txt")[:8000]
        c = _rawlzma2(data)
        sink = io.BytesIO()
        s = Lzma2Stream(output=sink)
        s.write(c)
        s.finish()
        assert sink.getvalue() == data

    def test_truncated_finish_errors(self):
        data = read_ref("foo.txt")[:5000]
        c = _rawlzma2(data)
        s = Lzma2Stream()
        s.write(c[: len(c) // 2])
        with pytest.raises(LzmaRsError):
            s.finish()

    def test_corrupt_poisons(self):
        data = read_ref("foo.txt")[:5000]
        c = bytearray(_rawlzma2(data))
        c[10] ^= 0xFF  # corrupt early payload
        s = Lzma2Stream()
        try:
            s.write(bytes(c))
            # corruption may decode to garbage of the right length; the
            # output must then differ from the original
            assert s.finish() != data
        except LzmaRsError:
            with pytest.raises(LzmaRsError):
                s.finish()

    def test_trailing_garbage_errors(self):
        data = read_ref("foo.txt")[:2000]
        c = _rawlzma2(data)
        s = Lzma2Stream()
        with pytest.raises(LzmaRsError):
            s.write(c + b"\x01extra")
            s.finish()


class TestXzStream:
    @pytest.mark.parametrize("chunk", [1, 13, 256, 4096, 1 << 22])
    def test_chunked_equals_oneshot(self, chunk):
        data = read_ref("foo.txt")
        c = read_ref("foo.txt.xz")
        assert _feed(XzStream, c, chunk) == data

    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    def test_good_corpus(self, n):
        c = read_ref(f"good-1-lzma2-{n}.xz")
        expected = read_ref(f"good-1-lzma2-{n}")
        assert _feed(XzStream, c, 37) == expected

    def test_multiblock_own_encoder(self):
        import lzma_rs_tpu

        data = read_ref("foo.txt") * 3
        c = lzma_rs_tpu.xz_compress(data, block_size=65536, check_method=4)
        assert _feed(XzStream, c, 777) == data

    def test_liblzma_crc64(self):
        data = read_ref("foo.txt")[:30000]
        c = liblzma.compress(data, format=liblzma.FORMAT_XZ, preset=6,
                             check=liblzma.CHECK_CRC64)
        assert _feed(XzStream, c, 511) == data

    def test_liblzma_crc32(self):
        data = read_ref("foo.txt")[:30000]
        c = liblzma.compress(data, format=liblzma.FORMAT_XZ, preset=1,
                             check=liblzma.CHECK_CRC32)
        assert _feed(XzStream, c, 1000) == data

    def test_block_check_mismatch(self):
        c = bytearray(read_ref("block-check-crc32.txt.xz"))
        # corrupt a payload byte so the block CRC32 fails
        c[40] ^= 0x01
        s = XzStream()
        with pytest.raises(LzmaRsError):
            for off in range(0, len(c), 64):
                s.write(bytes(c[off : off + 64]))
            s.finish()

    def test_truncated(self):
        c = read_ref("foo.txt.xz")
        s = XzStream()
        s.write(c[: len(c) - 20])
        with pytest.raises(LzmaRsError):
            s.finish()

    def test_early_finish_header(self):
        s = XzStream()
        s.write(read_ref("foo.txt.xz")[:6])
        with pytest.raises(LzmaRsError):
            s.finish()
