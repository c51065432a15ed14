"""Namespace parity, stats, SHA-256 checks, CRC vectors, logging gating."""

import lzma as liblzma

import pytest

import lzma_rs_tpu

from conftest import read_ref


class TestNamespaces:
    def test_decompress_namespace(self):
        assert lzma_rs_tpu.decompress.Options is lzma_rs_tpu.Options
        assert lzma_rs_tpu.decompress.UnpackedSize is lzma_rs_tpu.UnpackedSize
        s = lzma_rs_tpu.decompress.Stream()
        assert s.finish() == b""

    def test_decompress_raw_namespace(self):
        raw = lzma_rs_tpu.decompress.raw
        assert raw.LzmaDecoder is not None
        assert raw.Lzma2Decoder is not None
        params = raw.LzmaParams(
            properties=raw.LzmaProperties(lc=3, lp=0, pb=2),
            dict_size=0x10000,
            unpacked_size=None,
        )
        dec = raw.LzmaDecoder(params)
        body = lzma_rs_tpu.lzma_compress(b"raw payload here")[13:]
        assert dec.decompress(body) == b"raw payload here"

    def test_raw_lzma2_decoder(self):
        raw = lzma_rs_tpu.decompress.raw
        c = lzma_rs_tpu.lzma2_compress(b"hello lzma2")
        assert raw.Lzma2Decoder().decompress(c) == b"hello lzma2"

    def test_compress_namespace(self):
        assert lzma_rs_tpu.compress.Options is lzma_rs_tpu.CompressOptions


class TestStats:
    def test_collect_native(self):
        from lzma_rs_tpu.utils import stats

        data = read_ref("foo.txt")
        c = lzma_rs_tpu.xz_compress(data, block_size=1 << 15, level=0)
        with stats.collect() as s:
            assert lzma_rs_tpu.xz_decompress(c) == data
        d = s.to_dict()
        assert d["unpacked_bytes"] == len(data)
        assert d["engine"] in ("native", "device", "")
        assert d["prefill_bytes"] == len(data)  # store mode: all uncompressed

    def test_collect_compressed(self):
        from lzma_rs_tpu.utils import stats

        data = read_ref("foo.txt")
        c = lzma_rs_tpu.xz_compress(data, block_size=1 << 15, level=6)
        assert len(c) < len(data) // 2  # real compression
        with stats.collect() as s:
            assert lzma_rs_tpu.xz_decompress(c) == data
        d = s.to_dict()
        assert d["unpacked_bytes"] == len(data)
        assert d["lanes"] >= 1 and d["chunks"] >= 1


class TestSha256Check:
    def test_sha256_block_check_verifies(self):
        data = read_ref("foo.txt")
        c = liblzma.compress(data, format=liblzma.FORMAT_XZ, check=liblzma.CHECK_SHA256)
        # the reference errors on SHA-256; we verify it (capability superset)
        assert lzma_rs_tpu.xz_decompress(c) == data

    def test_sha256_corruption_detected(self):
        import hashlib

        from lzma_rs_tpu.utils.errors import XzError

        data = read_ref("foo.txt")
        c = bytearray(
            liblzma.compress(data, format=liblzma.FORMAT_XZ, check=liblzma.CHECK_SHA256)
        )
        sha = hashlib.sha256(data).digest()
        idx = bytes(c).find(sha)
        assert idx > 0
        c[idx] ^= 0xFF
        with pytest.raises(XzError) as e:
            lzma_rs_tpu.xz_decompress(bytes(c))
        assert "Invalid block SHA-256" in str(e.value)


class TestCrcVectors:
    def test_crc32_vector(self):
        from lzma_rs_tpu.utils.crc import crc32

        assert crc32(b"123456789") == 0xCBF43926

    def test_crc64_vector(self):
        from lzma_rs_tpu.utils.crc import crc64

        assert crc64(b"123456789") == 0x995DC9BBDF1939FA

    def test_crc64_incremental(self):
        from lzma_rs_tpu.utils.crc import crc64

        data = bytes(range(256)) * 7
        whole = crc64(data)
        # CRC64-XZ xors in/out; incremental chaining needs the raw update
        from lzma_rs_tpu.native import loader

        lib = loader.load()
        if lib is None:
            pytest.skip("native lib unavailable")
        crc = 0xFFFFFFFFFFFFFFFF
        for i in range(0, len(data), 97):
            crc = lib.crc64_update(data[i : i + 97], crc)
        assert (crc ^ 0xFFFFFFFFFFFFFFFF) == whole


class TestLoggingGating:
    def test_off_by_default(self):
        from lzma_rs_tpu.utils import logging as lg

        assert lg.LOG_ENABLED == bool(__import__("os").environ.get("LZMA_RS_TPU_LOG"))
