"""Round-4 fixes (VERDICT round-3 items 3-4; ADVICE medium), brought up
to date with the device engine:

- the ``auto`` engine routes by a rule on what it can see in the input
  (lane count and output size) and the platform, never by a model;
- explicit ``engine="device"`` decodes every segment size on the device
  engine (no window budget sends it to the host), and the plain XLA lane
  decoder is reachable only by naming ``engine="xla"``;
- multihost scan_blocks surfaces deferred chunk-header errors via the
  sequential replay path instead of silently truncating output.
"""

import lzma as liblzma

import pytest

import lzma_rs_tpu
from lzma_rs_tpu import platform
from lzma_rs_tpu.formats import xz as xz_fmt
from lzma_rs_tpu.parallel import multihost, runtime
from lzma_rs_tpu.utils import stats as stats_mod
from lzma_rs_tpu.utils.errors import LzmaError

from conftest import read_ref


def _big_profile_archive(mb=2):
    seed = read_ref("foo.txt")
    data = (seed * (mb * 1_000_000 // len(seed) + 1))[: mb * 1_000_000]
    return data, lzma_rs_tpu.xz_compress(
        data, block_size=8192, tpu_profile=True
    )


def _no_lane_kernel(monkeypatch):
    def boom(*a, **kw):
        raise AssertionError("XLA lane kernel reached")

    monkeypatch.setattr(runtime, "execute_plan", boom)


def _plans(n_lanes: int, seg_len: int):
    lanes = [
        runtime.LanePlan(
            in_start=[0], in_end=[8], out_start=[i * seg_len],
            out_end=[(i + 1) * seg_len], reset_state=[1], lc=[3], lp=[0],
            pb=[2], seg_base=i * seg_len, size_known=1,
            dict_size=0xFFFFFFFF,
        )
        for i in range(n_lanes)
    ]
    return [runtime.DecodePlan(lanes=lanes, prefill=[],
                               total_out=n_lanes * seg_len)]


class TestAutoRule:
    def test_auto_device_for_many_lanes_on_gpu(self, monkeypatch):
        data, arch = _big_profile_archive()
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        _no_lane_kernel(monkeypatch)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="auto")
        assert out == data
        assert st.engine == "device"
        assert st.fallbacks == []

    def test_auto_native_without_gpu(self, monkeypatch):
        data, arch = _big_profile_archive()
        monkeypatch.setattr(platform, "has_cuda", lambda: False)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="auto")
        assert out == data
        assert st.engine == "native"

    def test_stock_64k_archive_routes_device_on_gpu(self, monkeypatch):
        # the stock --block-size=64KiB shape: 64 lanes / 4 MiB clears
        # the minimum-work gate, and no window budget stops it
        seed = read_ref("foo.txt")
        data = (seed * 25)[: 4 << 20]
        arch = lzma_rs_tpu.xz_compress(data, block_size=65536, level=1)
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        _no_lane_kernel(monkeypatch)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="auto")
        assert out == data
        assert st.engine == "device"
        assert st.lanes == 64

    @pytest.mark.parametrize(
        "n_lanes,seg_len,want",
        [
            (64, 1 << 14, "device"),   # exactly at both thresholds
            (63, 1 << 15, "native"),   # one lane short
            (128, 8191, "native"),     # just under 1 MiB out
            (1, 1 << 24, "native"),    # one long lane
        ],
    )
    def test_rule_thresholds(self, monkeypatch, n_lanes, seg_len, want):
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        with stats_mod.collect() as st:
            got = runtime._resolve_auto_engine(b"", _plans(n_lanes, seg_len))
        assert got == want
        assert (want == "native") == any(
            "small workload" in f for f in st.fallbacks
        )

    @pytest.mark.parametrize(
        "n_lanes,seg_len,want",
        [
            (1024, 64 << 10, "device"),         # lanes at the length limit
            (1024, (64 << 10) + 1, "native"),   # one byte longer
            (256, 256 << 10, "native"),         # 256 KiB blocks
            (64, 1 << 20, "native"),            # 1 MiB blocks: host faster
        ],
    )
    def test_long_lane_rule(self, monkeypatch, n_lanes, seg_len, want):
        monkeypatch.setattr(platform, "has_cuda", lambda: True)
        with stats_mod.collect() as st:
            got = runtime._resolve_auto_engine(b"", _plans(n_lanes, seg_len))
        assert got == want
        assert (want == "native") == any(
            "long lanes" in f for f in st.fallbacks
        )


class TestLaneKernelQuarantine:
    def test_explicit_device_without_gpu_runs_cpu_handler(self, monkeypatch):
        data, arch = _big_profile_archive(1)
        _no_lane_kernel(monkeypatch)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="device")
        assert out == data
        assert st.engine == "device"
        assert st.platform == "cpu"  # not a GPU measurement
        assert st.fallbacks == []

    def test_large_blocks_stay_on_device(self, monkeypatch):
        # 1 MiB blocks: one long lane each, decoded with the window in
        # device memory; neither the host nor the lane kernel is reached
        seed = read_ref("foo.txt")
        data = (seed * 20)[: 3 << 20]
        arch = lzma_rs_tpu.xz_compress(data, block_size=1 << 20, level=1)
        _no_lane_kernel(monkeypatch)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="device")
        assert out == data
        assert st.engine == "device"
        assert st.lanes == 3
        assert st.fallbacks == []

    def test_lzma2_explicit_device_large_segment(self, monkeypatch):
        data = read_ref("foo.txt")[:200_000]  # > 64 KiB single segment
        stream = liblzma.compress(
            data, format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6}],
        )
        _no_lane_kernel(monkeypatch)
        with stats_mod.collect() as st:
            out = runtime.lzma2_decode(stream, engine="device")
        assert out == data
        assert st.engine == "device"

    def test_xla_engine_still_reachable(self, monkeypatch):
        data = read_ref("foo.txt")[:40_000]
        arch = lzma_rs_tpu.xz_compress(data, block_size=8192,
                                       tpu_profile=True)
        called = {}
        real = runtime.execute_plan

        def spy(d, plans):
            called["lane"] = True
            return real(d, plans)

        monkeypatch.setattr(runtime, "execute_plan", spy)
        with stats_mod.collect() as st:
            out = runtime.xz_decode(arch, engine="xla")
        assert out == data
        assert called.get("lane")
        assert st.engine == "xla"

    def test_unknown_engine_rejected(self):
        with pytest.raises(ValueError, match="unknown engine"):
            runtime.xz_decode(b"", engine="fast")


class TestMultihostPendingError:
    def test_scan_blocks_raises_on_deferred_header_error(self, monkeypatch):
        # splice the bad payload into a real archive via the encoder's
        # block writer
        data = b"deferred-error-payload " * 300
        good = liblzma.compress(
            data, format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6}],
        )
        assert good[-1] == 0
        bad_payload = good[:-1] + bytes([0x7F, 0x00])
        arch = _wrap_payload(bad_payload, data)
        with pytest.raises(runtime.UnparallelizableStream):
            multihost.scan_blocks(arch)
        # the multihost entry falls back to the sequential decode and
        # surfaces the reference error (prefix decodes fine, then the
        # invalid status)
        monkeypatch.setattr("jax.process_count", lambda: 2)
        monkeypatch.setattr("jax.process_index", lambda: 0)
        with pytest.raises(LzmaError) as e:
            multihost.xz_decode_multihost(arch)
        assert "invalid status" in str(e.value)


def _wrap_payload(payload: bytes, raw: bytes) -> bytes:
    """Minimal one-block .xz around an arbitrary LZMA2 payload, using
    the format-level writers the encoder itself uses."""
    from lzma_rs_tpu.utils.cursor import ByteWriter

    flags = xz_fmt.StreamFlags(check_method=xz_fmt.CHECK_NONE)
    w = ByteWriter()
    xz_fmt.write_stream_header(w, flags)
    rec = xz_fmt.write_block(w, payload, raw)
    index_size = xz_fmt.write_index(w, [rec])
    xz_fmt.write_footer(w, flags, index_size)
    return w.getvalue()
