"""Round-2 behavioral fixes and ADVICE-requested coverage.

- One SHA-256 policy across one-shot and streaming decode (both verify;
  the reference rejects: lzma-rs src/decode/xz.rs:326-330).
- ``raw.LzmaDecoder.reset`` expresses the reference's full
  ``Option<Option<u64>>`` (decode/lzma.rs:624-631).
- Device-engine fallbacks and host replays are recorded in stats (no
  silent engine swaps).
- Encoder props validation raises instead of silently clamping.
- tpu_profile archives (lc=0) stage the small literal table and decode
  on the device engine; dist<4 overlap torture.
"""

import hashlib

import pytest

import lzma_rs_tpu
from lzma_rs_tpu.formats import xz as xz_fmt
from lzma_rs_tpu.parallel import runtime
from lzma_rs_tpu.streams2 import XzStream
from lzma_rs_tpu.utils import stats as stats_mod
from lzma_rs_tpu.utils.errors import XzError

from conftest import read_ref


class TestSha256Policy:
    def _archive(self, data: bytes) -> bytes:
        return lzma_rs_tpu.xz_compress(data, check_method=xz_fmt.CHECK_SHA256)

    def test_one_shot_verifies(self):
        data = read_ref("foo.txt")[:5000]
        arch = self._archive(data)
        assert lzma_rs_tpu.xz_decompress(arch) == data

    def test_streaming_verifies(self):
        data = read_ref("foo.txt")[:5000]
        arch = self._archive(data)
        s = XzStream()
        s.write(arch)
        assert s.finish() == data

    def test_both_paths_reject_corrupt_sha256_identically(self):
        data = read_ref("foo.txt")[:5000]
        arch = bytearray(self._archive(data))
        # corrupt one byte of the 32-byte check field (just before index)
        idx_off = arch.index(
            hashlib.sha256(data).digest()
        )
        arch[idx_off] ^= 0xFF
        arch = bytes(arch)
        with pytest.raises(XzError) as e1:
            lzma_rs_tpu.xz_decompress(arch)
        s = XzStream()
        with pytest.raises(XzError) as e2:
            s.write(arch)
            s.finish()
        assert "Invalid block SHA-256" in str(e1.value)
        assert str(e1.value) == str(e2.value)


class TestRawResetParity:
    def _decoder(self, unpacked):
        from lzma_rs_tpu import raw

        params = raw.LzmaParams(
            raw.LzmaProperties(3, 0, 2), 0x10000, unpacked
        )
        return raw.LzmaDecoder(params), raw

    def test_default_keeps_size(self):
        dec, raw = self._decoder(42)
        dec.reset()
        assert dec._inner.state.unpacked_size == 42

    def test_none_sets_unknown(self):
        # reference reset(Some(None)): size becomes unknown/EOS-terminated
        dec, raw = self._decoder(42)
        dec.reset(None)
        assert dec._inner.state.unpacked_size is None

    def test_int_replaces_size(self):
        dec, raw = self._decoder(42)
        dec.reset(7)
        assert dec._inner.state.unpacked_size == 7

    def test_sentinel_exported(self):
        from lzma_rs_tpu import raw

        assert hasattr(raw, "KEEP_UNPACKED_SIZE")


class TestFallbackStats:
    def test_device_unsupported_reason_recorded(self, monkeypatch):
        import lzma as liblzma

        data = read_ref("foo.txt")[:8000]
        stream = liblzma.compress(
            data, format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6}],
        )
        monkeypatch.setattr(runtime, "_DEVICE_MAX_BYTES", 4096)
        with stats_mod.collect() as st:
            out = runtime.lzma2_decode(stream, engine="device")
        assert out == data
        assert st.engine == "native"
        assert any("beyond 2 GiB" in f for f in st.fallbacks), st.fallbacks

    def test_dispatcher_records_host_replay(self):
        import lzma as liblzma

        data = read_ref("foo.txt")[:3000]
        stream = bytearray(liblzma.compress(
            data, format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6,
                      "lc": 2, "lp": 2}],
        ))
        stream[40] ^= 0x20
        with stats_mod.collect() as st:
            try:
                runtime.lzma2_decode(bytes(stream), engine="device")
            except Exception:  # noqa: BLE001 - the replay's own error
                pass
        assert any("host replay" in f for f in st.fallbacks), st.fallbacks


class TestEncoderPropsValidation:
    def test_invalid_byte_raises(self):
        with pytest.raises(ValueError, match="must be in"):
            lzma_rs_tpu.lzma2_compress(b"x" * 100, level=6, props=225)

    def test_unsupported_lclp_raises(self):
        props = 3 + 9 * (2 + 5 * 0)  # lc=3 lp=2 -> lc+lp=5
        with pytest.raises(ValueError, match="lc \\+ lp"):
            lzma_rs_tpu.lzma2_compress(b"x" * 100, level=6, props=props)

    def test_valid_props_roundtrip(self):
        props = 1 + 9 * (1 + 5 * 2)  # lc=1 lp=1 pb=2
        data = read_ref("foo.txt")[:2000]
        c = lzma_rs_tpu.lzma2_compress(data, level=6, props=props)
        assert lzma_rs_tpu.lzma2_decompress(c) == data


class TestNlitAutoBucket:
    """ADVICE item: the lc=0 (tpu_profile) shape must be CI-validated."""

    def test_tpu_profile_selects_nlit1(self):
        from lzma_rs_tpu.ops.segment_decoder import probs_per_lane

        data = read_ref("foo.txt")[:6000]
        arch = lzma_rs_tpu.xz_compress(data, tpu_profile=True)
        plans, *_ = runtime.plan_xz(arch)
        st = runtime.stage_device(arch, plans)
        assert st.nprobs == probs_per_lane(0), "lc=0 stages the small table"

    def test_tpu_profile_decodes_via_nlit1_kernel(self):
        data = read_ref("foo.txt")[:6000]
        arch = lzma_rs_tpu.xz_compress(data, tpu_profile=True,
                                       block_size=2048)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="device")
        assert out == data
        assert st.engine == "device"

    def test_overlap_torture_small_distances(self):
        # dist < 4 at varied alignments: overlapping forward copies
        pieces = []
        for period in (1, 2, 3, 4):
            for align in range(4):
                pieces.append(b"Z" * align)
                pieces.append(bytes(range(64, 64 + period)) * (97 // period))
        data = b"".join(pieces)[:3500]
        arch = lzma_rs_tpu.xz_compress(
            data, tpu_profile=True, block_size=2048
        )
        assert runtime.xz_decode(arch, engine="device") == data


class TestSha256Encoder:
    def test_cli_check_sha256_roundtrip(self):
        data = read_ref("foo.txt")[:3000]
        arch = lzma_rs_tpu.xz_compress(
            data, check_method=xz_fmt.CHECK_SHA256, level=0
        )
        assert lzma_rs_tpu.xz_decompress(arch) == data
