"""Round-3 fixes (VERDICT.md round-2 items 3 and 5; ADVICE items 1-2),
brought up to date with the device engine:

- the ``auto`` engine routes to the device engine on a CUDA GPU for
  enough lanes and output, to the native engine otherwise;
- raw-LZMA device decode runs on the device engine at any size, with the
  declared dictionary size still capping match distances.
"""

import lzma as liblzma

import pytest

import lzma_rs_tpu
from lzma_rs_tpu import CompressOptions, WriteUnpackedSize
from lzma_rs_tpu import platform
from lzma_rs_tpu.parallel import runtime
from lzma_rs_tpu.utils import stats as stats_mod

from conftest import read_ref


def _profile_archive(n=6000):
    """A many-small-lanes archive (the ``tpu_profile`` shape)."""
    data = read_ref("foo.txt")[:n]
    return data, lzma_rs_tpu.xz_compress(
        data, block_size=2048, tpu_profile=True
    )


class TestAutoEngine:
    @pytest.fixture(autouse=True)
    def _tiny_thresholds(self, monkeypatch):
        # the auto router's minimum-work gate (64 lanes / 1 MiB out)
        # would route these deliberately tiny fixtures to the host
        monkeypatch.setattr(runtime, "AUTO_MIN_LANES", 1)
        monkeypatch.setattr(runtime, "AUTO_MIN_OUT", 1)

    def test_auto_picks_device_on_gpu(self, monkeypatch):
        data, arch = _profile_archive()
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="auto")
        assert out == data
        assert st.engine == "device"
        assert not any("auto->native" in f for f in st.fallbacks)

    def test_auto_picks_native_without_gpu(self, monkeypatch):
        data, arch = _profile_archive()
        monkeypatch.setattr(platform, "has_cuda", lambda: False)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="auto")
        assert out == data
        assert st.engine == "native"

    def test_auto_falls_back_for_unsupported_plan(self, monkeypatch):
        # beyond the int32 offsets of one launch: the router keeps it on
        # the host and says why
        data = read_ref("foo.txt")[:3000]
        stream = liblzma.compress(
            data, format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6,
                      "lc": 2, "lp": 2}],
        )
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        monkeypatch.setattr(runtime, "_DEVICE_MAX_BYTES", 1000)
        with stats_mod.collect() as st:
            out = runtime.lzma2_decode(stream, engine="auto")
        assert out == data
        assert st.engine == "native"
        assert any("auto->native" in f for f in st.fallbacks), st.fallbacks

    def test_auto_takes_lc_lp_4_to_device(self, monkeypatch):
        data = read_ref("foo.txt")[:3000]
        stream = liblzma.compress(
            data, format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6,
                      "lc": 2, "lp": 2}],
        )
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        with stats_mod.collect() as st:
            out = runtime.lzma2_decode(stream, engine="auto")
        assert out == data
        assert st.engine == "device"
        assert st.fallbacks == []

    def test_public_api_auto_routes_device(self, monkeypatch):
        data, arch = _profile_archive()
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "auto")
        with stats_mod.collect() as st:
            out = lzma_rs_tpu.xz_decompress(arch)
        assert out == data
        assert st.engine == "device"


def _sized_raw(data: bytes) -> bytes:
    return lzma_rs_tpu.lzma_compress_with_options(
        data,
        CompressOptions(
            unpacked_size=WriteUnpackedSize.write_to_header(len(data))
        ),
    )


class TestRawLzmaDeviceRouting:
    def test_raw_known_size_hits_device(self, monkeypatch):
        data = read_ref("foo.txt")[:3000]
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "device")
        with stats_mod.collect() as st:
            out = lzma_rs_tpu.lzma_decompress(_sized_raw(data))
        assert out == data
        assert st.engine == "device"

    def test_raw_large_stays_on_device(self, monkeypatch):
        # the window is the flat output: no size cap sends it to the host
        data = read_ref("foo.txt")[:100_000]
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "device")
        with stats_mod.collect() as st:
            out = lzma_rs_tpu.lzma_decompress(_sized_raw(data))
        assert out == data
        assert st.engine == "device"
        assert st.fallbacks == []

    def test_raw_unknown_size_goes_to_host(self, monkeypatch):
        data = read_ref("foo.txt")[:3000]
        c = lzma_rs_tpu.lzma_compress(data)
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "device")
        with stats_mod.collect() as st:
            out = lzma_rs_tpu.lzma_decompress(c)
        assert out == data
        assert st.engine == ""

    def test_raw_small_dict_keeps_distance_semantics(self, monkeypatch):
        # dict_size < unpacked size: the device decode caps distances at
        # the declared dictionary, like the reference's window
        data = read_ref("foo.txt")[:30_000]
        c = bytearray(
            liblzma.compress(
                data, format=liblzma.FORMAT_ALONE,
                filters=[{"id": liblzma.FILTER_LZMA1, "preset": 6,
                          "dict_size": 0x1000}],
            )
        )
        # liblzma's ALONE writer always declares "unknown size"; pin the
        # real size so the device path (which needs a known size) is taken
        c[5:13] = len(data).to_bytes(8, "little")
        c = bytes(c)
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "device")
        with stats_mod.collect() as st:
            out = lzma_rs_tpu.lzma_decompress(c)
        assert out == data
        assert st.engine == "device"
        assert st.fallbacks == []

    def test_raw_distance_beyond_dict_error_parity(self, monkeypatch):
        """A distance past the declared dictionary fails on the device,
        and the host replay raises the reference's exact error."""
        import random
        import struct

        rng = random.Random(7)
        blk = bytes(rng.randrange(256) for _ in range(2000))
        data = blk + bytes(8000) + blk
        c = liblzma.compress(data, format=liblzma.FORMAT_ALONE, preset=9)
        hdr = bytearray(c[:13])
        struct.pack_into("<I", hdr, 1, 4096)
        struct.pack_into("<Q", hdr, 5, len(data))
        payload = bytes(hdr) + c[13:]

        def run(backend):
            monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
            try:
                return ("ok", lzma_rs_tpu.lzma_decompress(payload))
            except Exception as ex:  # noqa: BLE001 - compare strings
                return ("err", type(ex).__name__, str(ex))

        with stats_mod.collect() as st:
            rd = run("device")
        assert rd == run("native") == run("spec")
        assert "beyond dictionary size 4096" in rd[2]
        assert any("host replay" in f for f in st.fallbacks), st.fallbacks


class TestRawFlatFastPath:
    """The size-declared raw-LZMA flat decode (native/lzma_native.cpp
    lrt_lzma_decode flat branch + process_fast) must be byte- and
    error-string-identical to the spec oracle's circular-window path
    (reference decode/lzbuffer.rs LzCircularBuffer semantics)."""

    def _spec(self, payload, monkeypatch):
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "spec")
        try:
            return ("ok", lzma_rs_tpu.lzma_decompress(payload))
        except Exception as ex:  # noqa: BLE001 - compare classes+strings
            return ("err", type(ex).__name__, str(ex))

    def _native(self, payload, monkeypatch):
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "native")
        try:
            return ("ok", lzma_rs_tpu.lzma_decompress(payload))
        except Exception as ex:  # noqa: BLE001
            return ("err", type(ex).__name__, str(ex))

    def test_roundtrip_known_size(self, monkeypatch):
        data = read_ref("foo.txt")
        c = liblzma.compress(data, format=liblzma.FORMAT_ALONE, preset=6)
        assert self._native(c, monkeypatch) == ("ok", data)

    def test_overshoot_reports_postloop_size_mismatch(self, monkeypatch):
        """A final match overshooting the declared size must produce the
        reference's post-loop 'Expected unpacked size of X but
        decompressed to Y' (not a flat-buffer cap error)."""
        import struct

        data = b"abcabcabc" * 100
        c = liblzma.compress(data, format=liblzma.FORMAT_ALONE, preset=6)
        hdr = bytearray(c[:13])
        struct.pack_into("<Q", hdr, 5, len(data) - 5)
        payload = bytes(hdr) + c[13:]
        rn = self._native(payload, monkeypatch)
        assert rn == self._spec(payload, monkeypatch)
        assert rn[0] == "err" and "Expected unpacked size of 895" in rn[2]

    def test_distance_beyond_declared_dict(self, monkeypatch):
        """Distances past the declared dictionary stay format errors on
        the flat path (FlatOut.dict_limit), same string as the window."""
        import random
        import struct

        rng = random.Random(7)
        blk = bytes(rng.randrange(256) for _ in range(2000))
        data = blk + bytes(8000) + blk
        c = liblzma.compress(data, format=liblzma.FORMAT_ALONE, preset=9)
        hdr = bytearray(c[:13])
        struct.pack_into("<I", hdr, 1, 4096)
        payload = bytes(hdr) + c[13:]
        rn = self._native(payload, monkeypatch)
        assert rn == self._spec(payload, monkeypatch)
        assert rn[0] == "err"
        assert "LZ distance 10000 is beyond dictionary size 4096" in rn[2]

    def test_eos_stream_decodes_flat_window(self, monkeypatch):
        """Unknown-size (EOS-marker) streams without a memlimit decode
        through the flat accum window."""
        data = read_ref("foo.txt")[:5000]
        comp = liblzma.LZMACompressor(
            format=liblzma.FORMAT_ALONE,
            filters=[{"id": liblzma.FILTER_LZMA1, "preset": 6}],
        )
        c = comp.compress(data) + comp.flush()
        assert self._native(c, monkeypatch) == ("ok", data)

    def test_memlimit_keeps_circular_window(self, monkeypatch):
        """Explicit memlimits route to the reference's circular window
        (its memory charge is min(dict, len), not total output); both a
        passing and a failing memlimit must match the spec oracle."""
        from lzma_rs_tpu import Options

        data = read_ref("foo.txt")[:5000]
        comp = liblzma.LZMACompressor(
            format=liblzma.FORMAT_ALONE,
            filters=[{"id": liblzma.FILTER_LZMA1, "preset": 6}],
        )
        c = comp.compress(data) + comp.flush()

        def run(backend, ml):
            monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
            try:
                out = lzma_rs_tpu.lzma_decompress_with_options(
                    c, Options(memlimit=ml)
                )
                return ("ok", len(out))
            except Exception as ex:  # noqa: BLE001
                return ("err", type(ex).__name__, str(ex))

        for ml in (1000, 10**9):
            assert run("native", ml) == run("spec", ml), ml

    def test_memlimit_overshoot_edge_matches_spec(self, monkeypatch):
        """memlimit in [declared, declared+272] with an overshooting
        final match: the reference reports the memlimit error, not the
        size mismatch (code-review finding; circular window required)."""
        import struct

        from lzma_rs_tpu import Options

        data = b"abcabcabc" * 100
        c = liblzma.compress(data, format=liblzma.FORMAT_ALONE, preset=6)
        hdr = bytearray(c[:13])
        struct.pack_into("<Q", hdr, 5, len(data) - 5)  # declare 895
        payload = bytes(hdr) + c[13:]

        def run(backend):
            monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
            try:
                lzma_rs_tpu.lzma_decompress_with_options(
                    payload, Options(memlimit=len(data) - 5)
                )
                return ("ok",)
            except Exception as ex:  # noqa: BLE001
                return ("err", type(ex).__name__, str(ex))

        rn, rs = run("native"), run("spec")
        assert rn == rs, (rn, rs)
        assert rn[0] == "err" and "exceeded memory limit of 895" in rn[2]


def test_wrapscale_eos_stream_flat_window(monkeypatch):
    """An EOS stream whose output far exceeds the dictionary (the
    flat-accum window path must keep distances dict-bounded while the
    output grows past it) decodes bit-exactly vs liblzma."""
    import struct

    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "native")
    data = read_ref("foo.txt") * 12  # ~2 MB
    comp = liblzma.LZMACompressor(
        format=liblzma.FORMAT_ALONE,
        filters=[{"id": liblzma.FILTER_LZMA1, "preset": 6,
                  "dict_size": 1 << 16}],
    )
    c = comp.compress(data) + comp.flush()
    hdr = bytearray(c[:13])
    assert struct.unpack("<I", hdr[1:5])[0] == 1 << 16
    assert lzma_rs_tpu.lzma_decompress(bytes(c)) == data


def test_lzma2_midpayload_truncation_error_parity(monkeypatch):
    """Mid-payload truncation of an LZMA2 chunk must surface the
    decode-time IoError (reference: the range decoder hits EOF inside
    the chunk, decode/lzma2.rs), NOT a scan-time 'LZMA2 expected new
    status' from the planner walking past the clipped payload.
    Found by the extended randomized differential (FUZZ_LEDGER)."""
    import lzma as liblzma_

    data = read_ref("foo.txt")[:14000]
    c = liblzma_.compress(
        data, format=liblzma_.FORMAT_RAW,
        filters=[{"id": liblzma_.FILTER_LZMA2, "preset": 6}],
    )
    m = c[: len(c) // 2]  # cut inside the first chunk's payload

    def run(backend):
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
        try:
            lzma_rs_tpu.lzma2_decompress(m)
            return ("ok",)
        except Exception as ex:  # noqa: BLE001
            return ("err", type(ex).__name__, str(ex))

    rn, rs = run("native"), run("spec")
    assert rn == rs, (rn, rs)
    assert rn[:2] == ("err", "IoError")
    assert "failed to fill whole buffer" in rn[2]


def test_error_ordering_prefix_decode_before_header_error(monkeypatch):
    """Sequential error ordering (reference decode/lzma2.rs): corruption
    in an early chunk's payload must surface its DECODE error even when a
    later chunk header is also broken — the planner walks all headers
    first, so it defers header errors behind decodable prefixes and
    replays sequentially. Found by the randomized differential."""
    import lzma as liblzma_

    data = read_ref("foo.txt")[:30000]
    c = bytearray(liblzma_.compress(
        data, format=liblzma_.FORMAT_RAW,
        filters=[{"id": liblzma_.FILTER_LZMA2, "preset": 6}],
    ))
    # corrupt an early payload byte AND truncate inside a later header
    c[40] ^= 0x10
    m = bytes(c[: len(c) - 3])

    def run(backend):
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
        try:
            lzma_rs_tpu.lzma2_decompress(m)
            return ("ok",)
        except Exception as ex:  # noqa: BLE001
            return ("err", type(ex).__name__, str(ex))

    rn, rs = run("native"), run("spec")
    assert rn == rs, (rn, rs)


def test_xz_container_error_after_decodable_block(monkeypatch):
    """.xz: a container-structure error behind a corrupt block payload
    must not pre-empt the block's decode error (the reference
    interleaves block decode with the container walk)."""
    import lzma as liblzma_

    data = read_ref("foo.txt")[:30000]
    c = bytearray(liblzma_.compress(data, format=liblzma_.FORMAT_XZ,
                                    preset=6))
    c[100] ^= 0x04          # corrupt block payload
    m = bytes(c[: len(c) - 7])  # and truncate the footer/index

    def run(backend):
        monkeypatch.setenv("LZMA_RS_TPU_BACKEND", backend)
        try:
            lzma_rs_tpu.xz_decompress(m)
            return ("ok",)
        except Exception as ex:  # noqa: BLE001
            return ("err", type(ex).__name__, str(ex))

    rn, rs = run("native"), run("spec")
    assert rn == rs, (rn, rs)


def test_auto_small_workload_stays_on_host(monkeypatch):
    """A tiny archive never takes a device trip (or a cold compile),
    even on a GPU host."""
    data, arch = _profile_archive()  # few lanes, ~6 KB out
    monkeypatch.setattr(platform, "has_cuda", lambda: True)
    with stats_mod.collect() as st:
        out = runtime.xz_decode(arch, engine="auto")
    assert out == data
    assert st.engine == "native"
    assert any("small workload" in f for f in st.fallbacks), st.fallbacks
