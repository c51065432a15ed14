"""The device engine's decode kernel (``ops/segment_decoder.py``).

On the CPU these tests run the CPU XLA FFI handler, which compiles the
same decode core as the CUDA kernel (``native/lzma_segment.h``), through
the same ``jax.ffi.ffi_call`` and the same staging
(``runtime.stage_device``). Results are checked bit-exact against
liblzma, the native host engine and the executable spec. Tests marked
``gpu`` run the CUDA handler and skip without a CUDA device.
"""

import lzma as liblzma
import os

import numpy as np
import pytest

import lzma_rs_tpu
from lzma_rs_tpu import corpus, platform
from lzma_rs_tpu.models.codecs import Lzma2Decoder
from lzma_rs_tpu.ops import segment_decoder as sd
from lzma_rs_tpu.parallel import runtime
from lzma_rs_tpu.utils import stats as stats_mod
from lzma_rs_tpu.utils.cursor import ByteCursor

from conftest import read_ref


def _rawlzma2(data: bytes, preset: int = 6, **filt_kw) -> bytes:
    filt = {"id": liblzma.FILTER_LZMA2, "preset": preset, **filt_kw}
    return liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=[filt])


def _own_lzma2(data: bytes, chunk_size: int = 1024, **kw) -> bytes:
    import lzma_rs_tpu.encode.lzma2_enc as enc

    return enc.lzma2_compress(data, level=6, chunk_size=chunk_size, **kw)


def _decode(stream: bytes) -> bytes:
    plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
    return runtime.execute_plan_device(stream, [plan])


class TestDecodeCore:
    """Bit-exactness of the shared core through the CPU ffi_call."""

    def test_single_chunk_text(self):
        data = read_ref("foo.txt")[:3000]
        assert _decode(_rawlzma2(data)) == data

    def test_runs_and_reps(self):
        data = (b"\x00" * 700 + b"abcabcabc" * 60 + b"\xff" * 500) * 2
        assert _decode(_rawlzma2(data)) == data

    def test_binary_patterns(self):
        data = bytes(range(256)) * 12
        assert _decode(_rawlzma2(data)) == data

    @pytest.mark.parametrize(
        "lc,lp,pb", [(1, 2, 1), (0, 0, 0), (4, 0, 2), (0, 4, 4), (2, 2, 0)]
    )
    def test_props_variants(self, lc, lp, pb):
        data = read_ref("foo.txt")[:2500]
        assert _decode(_rawlzma2(data, lc=lc, lp=lp, pb=pb)) == data

    def test_multi_segment(self):
        d1 = read_ref("foo.txt")[:2000]
        d2 = (read_ref("small.txt") * 8)[:2000]
        stream = _rawlzma2(d1)[:-1] + _rawlzma2(d2)
        assert _decode(stream) == d1 + d2

    def test_multi_chunk_one_segment(self):
        data = read_ref("foo.txt")[:3000]
        stream = _own_lzma2(data, chunk_size=1024)
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        assert len(plan.lanes) == 1
        assert len(plan.lanes[0].in_start) >= 2
        assert _decode(stream) == data

    def test_state_carried_across_chunks(self):
        # liblzma continues the state across its 64 KiB-packed chunks
        data = corpus.mixed(400_000, 11)
        stream = _rawlzma2(data)
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        assert 0 in plan.lanes[0].reset_state
        assert _decode(stream) == data

    def test_stored_chunk_inside_segment(self):
        import random

        random.seed(3)
        rnd = bytes(random.randrange(256) for _ in range(1024))
        data = read_ref("foo.txt")[:1024] + rnd + read_ref("foo.txt")[:1024]
        stream = _own_lzma2(data, chunk_size=1024)
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        assert plan.prefill, "expected stored chunks in the stream"
        assert _decode(stream) == data

    @pytest.mark.parametrize("n", [1, 2, 3, 4])
    def test_good_corpus(self, n):
        want = read_ref(f"good-1-lzma2-{n}")
        arch = read_ref(f"good-1-lzma2-{n}.xz")
        assert runtime.xz_decode(arch, engine="device") == want

    def test_vs_host_engine_and_spec(self):
        data = read_ref("foo.txt")[:3500]
        s = _rawlzma2(data)
        got = _decode(s)
        assert got == runtime.lzma2_decode(s, engine="native")
        assert got == Lzma2Decoder().decompress(ByteCursor(s))

    def test_long_segment(self):
        # far beyond any on-chip window: one lane, window in the output
        data = read_ref("foo.txt")
        assert _decode(_rawlzma2(data)) == data

    def test_many_lanes_ragged(self):
        datas = [read_ref("foo.txt")[i * 400:(i + 1) * 400 + 37 * i]
                 for i in range(37)]
        stream = b"".join(_rawlzma2(d)[:-1] for d in datas) + b"\x00"
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        assert len(plan.lanes) == 37
        assert _decode(stream) == b"".join(datas)

    @pytest.mark.parametrize("block", [8192, 65536, 1 << 20])
    def test_xz_block_classes(self, block):
        data = corpus.mixed(1_200_000, block)
        arch = corpus.xz_blocks(data, block, check=4)
        with stats_mod.collect() as st:
            assert runtime.xz_decode(arch, engine="device") == data
        assert st.engine == "device" and st.fallbacks == []
        assert liblzma.decompress(arch) == data

    def test_lzma2_segments_stream(self):
        data = corpus.mixed(300_000, 2)
        stream = corpus.lzma2_segments(data, 1 << 15)
        with stats_mod.collect() as st:
            assert runtime.lzma2_decode(stream, engine="device") == data
        assert st.lanes == -(-len(data) // (1 << 15))


def _op(stream: bytes, rows, dict_limit=0xFFFFFFFF, out_size=None):
    """Call the op on one lane with a hand-made chunk table."""
    import jax.numpy as jnp

    sd.register("cpu")
    chunks = np.zeros((1, max(1, len(rows)), 8), np.int32)
    for i, r in enumerate(rows):
        chunks[0, i] = r
    lanes = np.array([[len(rows), 0, np.uint32(dict_limit).view(np.int32)]],
                     np.int32)
    size = out_size or max((r[3] for r in rows), default=1)
    nprobs = sd.probs_per_lane(4)
    out, err = sd.decode(
        jnp.asarray(np.frombuffer(stream, np.uint8)), chunks, lanes,
        np.zeros((1, 3), np.int32), out_size=size, nprobs=nprobs,
    )
    return np.asarray(out).tobytes(), int(np.asarray(err)[0])


def _one_chunk(data: bytes):
    """(stream, table row) for one liblzma LZMA chunk of ``data``."""
    s = _rawlzma2(data)
    plan, _ = runtime.plan_lzma2_stream(s, 0, 0)
    lane = plan.lanes[0]
    assert len(lane.in_start) == 1
    row = [lane.in_start[0], lane.in_end[0], 0, len(data), 1,
           lane.lc[0], lane.lp[0], lane.pb[0]]
    return s, row


class TestErrorCodes:
    """Each failure the core detects returns its code; the runtime then
    replays the stream on the host for the reference's message."""

    def test_ok(self):
        data = read_ref("foo.txt")[:2000]
        s, row = _one_chunk(data)
        out, err = _op(s, [row])
        assert err == 0 and out == data

    def test_short_chunk(self):
        s, row = _one_chunk(b"hello hello hello")
        row[1] = row[0] + 4
        assert _op(s, [row])[1] == 1

    def test_truncated_input(self):
        data = read_ref("foo.txt")[:2000]
        s, row = _one_chunk(data)
        row[1] = row[0] + (row[1] - row[0]) // 2
        assert _op(s, [row])[1] == 2

    def test_size_overshoot(self):
        # a chunk declared one byte short: the last match overruns it
        data = b"abcabcabc" * 100
        s, row = _one_chunk(data)
        row[3] -= 1
        assert _op(s, [row])[1] in (3, 4)

    def test_distance_beyond_dictionary(self):
        import random

        rng = random.Random(7)
        blk = bytes(rng.randrange(256) for _ in range(2000))
        data = blk + bytes(3000) + blk
        s, row = _one_chunk(data)
        assert _op(s, [row], dict_limit=4096)[1] == 3
        assert _op(s, [row], dict_limit=1 << 20)[1] == 0

    def test_table_out_of_bounds(self):
        data = read_ref("foo.txt")[:500]
        s, row = _one_chunk(data)
        bad = list(row)
        bad[1] = len(s) + 100
        assert _op(s, [bad])[1] == 6
        assert _op(s, [row], out_size=len(data) - 1)[1] == 6

    @pytest.mark.parametrize("case", ["ok", "short", "truncated", "table"])
    def test_native_engine_runs_the_same_core(self, case):
        # the host engine's segment decode is the same lzma_segment.h:
        # the same rows give the same code and output as the ffi_call
        import ctypes

        from lzma_rs_tpu.native import loader

        data = read_ref("foo.txt")[:2000]
        s, row = _one_chunk(data)
        if case == "short":
            row[1] = row[0] + 4
        elif case == "truncated":
            row[1] = row[0] + (row[1] - row[0]) // 2
        elif case == "table":
            row[1] = len(s) + 100
        want_out, want_code = _op(s, [row])
        assert (want_code == 0) == (case == "ok")
        buf = ctypes.create_string_buffer(len(data))
        code = 0
        try:
            loader.load().lzma2_decode_segment(
                s, [row[:4] + [row[4] & 1] + row[5:]], ctypes.addressof(buf),
                len(data),
            )
        except loader.SegmentError as e:
            code = e.code
        assert code == want_code
        if case == "ok":
            assert buf.raw == want_out == data

    def test_corrupt_stream_replays_on_host(self):
        data = read_ref("foo.txt")[:20000]
        s = bytearray(_rawlzma2(data))
        s[len(s) // 2] ^= 0xFF
        s = bytes(s)

        def run(engine):
            try:
                return ("ok", runtime.lzma2_decode(s, engine=engine))
            except Exception as e:  # noqa: BLE001 - compare messages
                return ("err", type(e).__name__, str(e))

        with stats_mod.collect() as st:
            got = run("device")
        assert got == run("native")
        if got[0] == "err":
            assert any("host replay" in f for f in st.fallbacks)


    def test_misframed_chunk_raises_reference_error(self):
        # this flip leaves a chunk's range coder stopping before its packed
        # end; read along the declared boundaries the block would decode
        # and fail only its CRC32, but the reference reads the next chunk
        # header where its range coder stopped and fails there. The device
        # path must raise the reference's error.
        from lzma_rs_tpu.models.codecs import xz_decode_stream

        arch = bytearray(lzma_rs_tpu.xz_compress(
            read_ref("foo.txt")[:30000], tpu_profile=True, check_method=1,
            block_size=4096,
        ))
        arch[5700] ^= 16
        arch = bytes(arch)

        def err(fn):
            try:
                fn()
            except Exception as e:  # noqa: BLE001 - compare messages
                return f"{type(e).__name__}: {e}"
            return "no error"

        with stats_mod.collect() as st:
            got = err(lambda: runtime.xz_decode(arch, engine="device"))
        assert got == err(lambda: xz_decode_stream(ByteCursor(arch)))
        assert got == err(lambda: runtime.xz_decode(arch, engine="native"))
        assert "CRC32" not in got
        assert "host replay: lane error code 7" in st.fallbacks


@pytest.mark.parametrize("engine", ["device", "native", "xla"])
def test_chunk_ending_early_replays_for_reference_result(engine):
    """A chunk header that declares one packed byte more than its range
    coder reads (one junk byte inserted after the payload): the
    reference reads the next header at the junk byte, so the planned
    decoders must not trust the declared boundary."""
    from lzma_rs_tpu.formats import lzma2 as lzma2_fmt

    d1 = read_ref("foo.txt")[:3000]
    d2 = read_ref("foo.txt")[3000:6000]
    stream = bytearray(_rawlzma2(d1)[:-1] + _rawlzma2(d2))
    first = lzma2_fmt.scan(ByteCursor(bytes(stream))).chunks[0]
    hdr = first.data_off - 6  # control, unpacked(2), packed(2), props
    packed = int.from_bytes(stream[hdr + 3 : hdr + 5], "big") + 1
    stream[hdr + 3 : hdr + 5] = packed.to_bytes(2, "big")
    end = first.data_off + first.packed_size
    stream[end:end] = b"\x03"
    stream = bytes(stream)

    def run(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # noqa: BLE001 - compare messages
            return ("err", type(e).__name__, str(e))

    want = run(lambda: Lzma2Decoder().decompress(ByteCursor(stream)))
    assert want[0] == "err"
    assert run(lambda: runtime.lzma2_decode(stream, engine=engine)) == want


@pytest.mark.parametrize("engine", ["device", "native", "xla"])
@pytest.mark.parametrize("cut", range(1, 9))
def test_truncated_stream_raises_reference_error(engine, cut):
    """A multi-segment stream cut short: the last chunk's declared packed
    end lies past the input. The staged input is padded, so the device
    engines must not read the padding as the missing bytes."""
    d1 = read_ref("foo.txt")[:3000]
    d2 = read_ref("foo.txt")[3000:7000]
    stream = (_rawlzma2(d1)[:-1] + _rawlzma2(d2))[:-cut]

    def run(fn):
        try:
            return ("ok", fn())
        except Exception as e:  # noqa: BLE001 - compare messages
            return ("err", type(e).__name__, str(e))

    want = run(lambda: Lzma2Decoder().decompress(ByteCursor(stream)))
    assert want[0] == "err"
    assert run(lambda: runtime.lzma2_decode(stream, engine=engine)) == want


class TestStaging:
    def _plans(self, arch):
        return runtime.plan_xz(arch)[0]

    def test_bucket(self):
        assert [runtime._bucket(n) for n in (1, 3, 17, 33, 100, 1000)] == [
            1, 4, 32, 34, 100, 1024
        ]
        for n in range(33, 50000, 37):
            b = runtime._bucket(n)
            assert n <= b <= n * 1.0625

    def test_tables_single_device(self):
        data = corpus.mixed(100_000, 1)
        arch = corpus.xz_blocks(data, 8192)
        plans = self._plans(arch)
        st = runtime.stage_device(arch, plans, 1)
        lanes = [l for p in plans for l in p.lanes]
        assert st.n_dev == 1 and st.lane_counts == [len(lanes)]
        L, K = st.chunks.shape[1:3]
        assert L == runtime._next_pow2(len(lanes)) and L & (L - 1) == 0
        assert st.chunks.shape == (1, L, K, 8) and st.lanes.shape == (1, L, 3)
        assert st.inbuf.shape[0] >= len(arch)
        assert bytes(st.inbuf[: len(arch)]) == arch
        assert st.out_size >= st.total_out == len(data)
        # one device keeps the stream's own offsets; lanes longest first
        bases = sorted(st.lanes[0, : len(lanes), 1].tolist())
        assert bases == sorted(l.seg_base for l in lanes)
        used = st.lanes[0, : len(lanes)]
        seg = [st.chunks[0, i, int(n) - 1, 3] for i, n in enumerate(used[:, 0])]
        assert seg == sorted(seg, reverse=True)
        assert not st.lanes[0, len(lanes):].any()  # padding lanes idle
        assert st.nprobs == sd.probs_per_lane(3)

    def test_chunk_rows_relative_to_segment(self):
        data = read_ref("foo.txt")[:5000]
        stream = _own_lzma2(data, chunk_size=1024)
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        st = runtime.stage_device(stream, [plan], 1)
        lane = plan.lanes[0]
        rows = st.chunks[0, 0, : len(lane.in_start)]
        assert rows[:, 0].tolist() == lane.in_start
        assert rows[:, 2].tolist() == [o - lane.seg_base
                                       for o in lane.out_start]
        assert (rows[:, 4] & 1).tolist() == lane.reset_state
        assert (rows[:, 4] & 2).all(), "LZMA2 chunks must end exactly"

    def test_lanes_split_over_eight_devices(self):
        import jax

        assert len(jax.devices()) == 8
        data = corpus.mixed(400_000, 4)
        arch = corpus.xz_blocks(data, 8192)
        plans = self._plans(arch)
        st = runtime.stage_device(arch, plans, 8)
        n = sum(len(p.lanes) for p in plans)
        assert st.n_dev == 8 and sum(st.lane_counts) == n
        assert min(st.lane_counts) >= n // 8 - 1
        # every lane is stitched exactly once, slabs do not overlap
        copies = sorted(c for d in st.stitch for c in d)
        assert len(copies) == n
        for d, slab in enumerate(st.stitch):
            spans = sorted((loc, loc + ln) for _, loc, ln in slab)
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
            assert spans[-1][1] <= st.out_size
        with stats_mod.collect() as s:
            assert runtime.xz_decode(arch, engine="device") == data
        assert s.devices == 8 and s.lanes_per_device == st.lane_counts

    def test_prefill_split_between_devices_and_host(self):
        # stored chunks inside a segment travel with its lane; a stored
        # dict-reset segment (no LZMA chunk) is placed by the host
        a = read_ref("foo.txt")[:3000]
        noise = np.random.default_rng(1).integers(0, 256, 2048, np.uint8)
        seg1 = a[:1024] + noise.tobytes() + a[:1024]
        seg2 = bytes(noise[:700])
        seg3 = read_ref("foo.txt")[3000:9000]
        from lzma_rs_tpu.encode import lzma2_enc

        stream = (_own_lzma2(seg1, 1024)[:-1]
                  + lzma2_enc.lzma2_compress(seg2, 0)[:-1]
                  + _own_lzma2(seg3, 2048))
        plan, _ = runtime.plan_lzma2_stream(stream, 0, 0)
        st = runtime.stage_device(stream, [plan], 2)
        assert st.host_prefill, "stored-only segment placed on the host"
        assert st.prefill[..., 2].sum() > 0, "in-segment stored chunks"
        assert runtime.lzma2_decode(stream, engine="device") == (
            seg1 + seg2 + seg3
        )

    def test_no_lanes(self):
        stream = lzma_rs_tpu.lzma2_compress(b"stored only" * 50, level=0)
        with stats_mod.collect() as st:
            out = runtime.lzma2_decode(stream, engine="device")
        assert out == b"stored only" * 50
        assert st.lanes == 0


class TestWrapper:
    def test_result_shapes(self):
        import jax
        import jax.numpy as jnp

        L, K, P, N, T = 16, 4, 2, 4096, 65536
        args = (
            jax.ShapeDtypeStruct((N,), jnp.uint8),
            jax.ShapeDtypeStruct((L, K, 8), jnp.int32),
            jax.ShapeDtypeStruct((L, 3), jnp.int32),
            jax.ShapeDtypeStruct((P, 3), jnp.int32),
        )
        out, err = jax.eval_shape(
            lambda *a: sd.decode(*a, out_size=T, nprobs=sd.probs_per_lane(3)),
            *args,
        )
        assert out.shape == (T,) and out.dtype == jnp.uint8
        assert err.shape == (L,) and err.dtype == jnp.int32

    def test_probs_per_lane_matches_layout(self):
        from lzma_rs_tpu.models.state import make_layout

        for lclp in range(5):
            # same tables as models/state.py, reordered (+1 pad entry)
            assert sd.probs_per_lane(lclp) == make_layout(lclp).total + 1

    def test_cuda_and_cpu_handlers_bind_the_same_signature(self):
        # one ffi_call serves both platforms: operands, results and
        # attributes must match in order and type
        import re

        def binding(name):
            path = os.path.join(sd._NATIVE, name)
            src = open(path).read()
            tail = src[src.index("XLA_FFI_DEFINE_HANDLER_SYMBOL"):]
            return re.findall(r"\.(Arg|Ret|Attr)<([^>]*>?)>(?:\(\"(\w+)\"\))?",
                              tail)

        cpu = binding("segment_cpu.cc")
        cuda = binding("segment_cuda.cu")
        assert cpu == cuda
        assert [k for k, _, _ in cpu] == ["Arg"] * 4 + ["Ret"] * 3 + ["Attr"]
        assert cpu[-1][2] == "nprobs"

    def test_cuda_build_command(self):
        cmd = sd._compile_cmd("cuda", "k.cu", "k.so")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert cmd[0].endswith("nvcc") and "-shared" in cmd
        assert sd._compile_cmd("cpu", "k.cc", "k.so")[0] == "g++"

    def test_cpu_library_built_into_ignored_dir(self):
        path = sd.build("cpu")
        assert path.startswith(sd.BUILD_DIR)
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(root, ".gitignore")) as f:
            assert "lzma_rs_tpu/native/build/" in f.read()


class TestPlatform:
    def test_cpu_backend(self):
        assert platform.device_platform() == "cpu"
        assert platform.has_cuda() is False

    def test_has_cuda_follows_device_platform(self, monkeypatch):
        monkeypatch.setattr(platform, "device_platform", lambda: "cuda")
        assert platform.has_cuda() is True


@pytest.mark.gpu
class TestOnGpu:
    def test_cuda_decode_bit_exact(self, gpu_device):
        data = corpus.mixed(4 << 20, 9)
        arch = corpus.xz_blocks(data, 65536)
        with stats_mod.collect() as st:
            assert runtime.xz_decode(arch, engine="device") == data
        assert st.engine == "device" and st.fallbacks == []

    def test_auto_routes_to_device(self, gpu_device):
        data = corpus.mixed(2 << 20, 10)
        arch = corpus.xz_blocks(data, 8192)
        with stats_mod.collect() as st:
            assert lzma_rs_tpu.xz_decompress(arch) == data
        assert st.engine == "device"
