"""Fuzz-style property tests (deterministic seeds), mirroring the reference
fuzz target taxonomy (lzma-rs ``fuzz/fuzz_targets``, README.md:3-8):

- ``decompress_{lzma,lzma2,xz}``: arbitrary bytes never crash with anything
  but a typed library error,
- ``roundtrip_{lzma,lzma2,xz}``: self-consistency on arbitrary payloads,
- ``decompress_lzma_stream``: chunked streaming output equals one-shot,
- ``compare_xz`` / ``interop_xz``: differential against liblzma.
"""

import lzma as liblzma
import random

import pytest

import lzma_rs_tpu
from lzma_rs_tpu.stream import Stream
from lzma_rs_tpu.utils.errors import LzmaRsError

N_CASES = 60


def _rand_bytes(rng, max_len=512):
    n = rng.randrange(max_len)
    return bytes(rng.randrange(256) for _ in range(n))


@pytest.mark.parametrize("seed", range(5))
class TestNoCrash:
    """Typed errors (or success) on arbitrary input — never a crash."""

    def _cases(self, seed):
        rng = random.Random(seed)
        return [_rand_bytes(rng) for _ in range(N_CASES)]

    def test_decompress_lzma(self, seed):
        for data in self._cases(seed):
            try:
                lzma_rs_tpu.lzma_decompress(data)
            except LzmaRsError:
                pass

    def test_decompress_lzma2(self, seed):
        for data in self._cases(seed):
            try:
                lzma_rs_tpu.lzma2_decompress(data)
            except LzmaRsError:
                pass

    def test_decompress_xz(self, seed):
        for data in self._cases(seed):
            try:
                lzma_rs_tpu.xz_decompress(data)
            except LzmaRsError:
                pass

    def test_stream_write(self, seed):
        for data in self._cases(seed):
            s = Stream()
            try:
                s.write(data)
                s.finish()
            except LzmaRsError:
                pass


@pytest.mark.parametrize("seed", range(3))
class TestRoundTrip:
    def _payloads(self, seed):
        rng = random.Random(1000 + seed)
        out = [_rand_bytes(rng, 2048) for _ in range(20)]
        # compressible payloads too
        out += [bytes([rng.randrange(4)]) * rng.randrange(1, 4096) for _ in range(10)]
        return out

    def test_roundtrip_lzma(self, seed):
        for p in self._payloads(seed):
            assert lzma_rs_tpu.lzma_decompress(lzma_rs_tpu.lzma_compress(p)) == p

    def test_roundtrip_lzma2(self, seed):
        for p in self._payloads(seed):
            assert lzma_rs_tpu.lzma2_decompress(lzma_rs_tpu.lzma2_compress(p)) == p

    def test_roundtrip_xz(self, seed):
        for p in self._payloads(seed):
            assert lzma_rs_tpu.xz_decompress(lzma_rs_tpu.xz_compress(p)) == p


class TestDifferential:
    """compare_xz / interop_xz fuzz targets: agree with liblzma."""

    def test_interop_xz_decode(self):
        # liblzma-compressed must decode identically
        rng = random.Random(42)
        for _ in range(15):
            p = _rand_bytes(rng, 4096) + bytes(rng.randrange(2048))
            c = liblzma.compress(p, format=liblzma.FORMAT_XZ)
            assert lzma_rs_tpu.xz_decompress(c) == p

    def test_interop_xz_encode(self):
        # our xz output must be liblzma-decodable
        rng = random.Random(43)
        for _ in range(15):
            p = _rand_bytes(rng, 4096)
            c = lzma_rs_tpu.xz_compress(p)
            assert liblzma.decompress(c) == p

    def test_compare_xz_on_corrupted(self):
        # both-fail or both-succeed-equal on mangled archives
        rng = random.Random(44)
        p = bytes(range(256)) * 16
        c = bytearray(liblzma.compress(p, format=liblzma.FORMAT_XZ))
        for _ in range(25):
            i = rng.randrange(len(c))
            old = c[i]
            c[i] ^= 1 << rng.randrange(8)
            ours = theirs = None
            ours_err = theirs_err = False
            try:
                ours = lzma_rs_tpu.xz_decompress(bytes(c))
            except LzmaRsError:
                ours_err = True
            try:
                theirs = liblzma.decompress(bytes(c))
            except liblzma.LZMAError:
                theirs_err = True
            if not ours_err and not theirs_err:
                assert ours == theirs
            # (either failing alone is acceptable: error detection points
            #  differ between implementations, as for the reference)
            c[i] = old

    def test_stream_chunked_equals_oneshot(self):
        rng = random.Random(45)
        for _ in range(8):
            p = _rand_bytes(rng, 2048)
            c = lzma_rs_tpu.lzma_compress(p)
            chunk = rng.randrange(1, 64)
            s = Stream()
            for i in range(0, len(c), chunk):
                s.write(c[i : i + chunk])
            assert s.finish() == p
