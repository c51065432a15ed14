"""Parallel decode runtime: segments -> lanes -> devices.

Host-side scheduler for the device engine (``ops/segment_decoder.py``)
and the host engine (``native/``):

1. parse the container (`.xz` blocks / LZMA2 chunk stream) on the host —
   tiny, sequential, cheap (headers carry all sizes: the reference's
   ``src/decode/lzma2.rs:128-136``, ``decode/xz.rs:109-136``),
2. split chunks into **segments** at dict-reset boundaries (the format's
   natural parallel axis; window + probability state never cross a reset,
   ``decode/lzma2.rs:104-126,147-149``),
3. pre-fill uncompressed chunks straight into the flat output (they are
   known without decoding and become part of the LZ window),
4. launch every segment as one lane of the decode kernel, all lanes
   writing one flat output at offsets known before decode,
5. verify block checks / index / footer, with reference-parity errors.

Shapes are bucketed so repeated calls hit the jit cache. If the kernel
flags any lane error, the stream is re-decoded with the host engine to
reproduce the reference's exact error message (corrupt inputs are the
rare path).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

from lzma_rs_tpu.formats import lzma2 as lzma2_fmt
from lzma_rs_tpu.formats import xz as xz_fmt
from lzma_rs_tpu.formats.lzma_header import LzmaParams, LzmaProperties
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import LzmaError, XzError
from lzma_rs_tpu.utils import logging as log


@dataclasses.dataclass
class LanePlan:
    """One lane = one dict-reset segment (or one raw-LZMA stream)."""

    in_start: List[int]
    in_end: List[int]
    out_start: List[int]
    out_end: List[int]
    reset_state: List[int]
    lc: List[int]
    lp: List[int]
    pb: List[int]
    seg_base: int
    size_known: int
    dict_size: int
    #: LZMA2: each chunk's range coder must stop at its packed end (the
    #: reference reads the next chunk header there); raw LZMA ignores
    #: what follows the declared size.
    exact_end: bool = True


@dataclasses.dataclass
class DecodePlan:
    lanes: List[LanePlan]
    prefill: List[Tuple[int, int, int]]  # (src_off, dst_off, length)
    total_out: int
    # Chunk-header error deferred by the scanner (formats/lzma2.py): the
    # reference's sequential loop decodes the recorded prefix before
    # reaching the broken header, so plan executors must not surface
    # this ahead of prefix decode errors — they replay sequentially.
    pending_error: Optional[Exception] = None


class UnparallelizableStream(Exception):
    """The stream carries probability state across a dict-reset boundary
    (legal per the reference: an uncompressed dict-reset chunk does not
    touch the probability model, decode/lzma2.rs:195-228, and a following
    reset_mode-0 chunk continues it). Segments are then not independent
    and the stream must decode sequentially."""


def plan_lzma2_stream(
    data: bytes, start: int, out_base: int
) -> Tuple[DecodePlan, int]:
    """Plan one LZMA2 chunk stream; returns (plan, consumed_bytes).

    Output offsets are absolute (``out_base`` + position in this stream).

    Raises :class:`UnparallelizableStream` when a non-initial segment's
    first LZMA chunk does not reset the probability model — parallel
    engines fall back to the sequential host decoder for exactness.
    """
    cursor = ByteCursor(data, start)
    table = lzma2_fmt.scan(cursor)

    lanes: List[LanePlan] = []
    prefill: List[Tuple[int, int, int]] = []
    lane: Optional[LanePlan] = None

    # Props inheritance: LZMA2 starts from lc=0, lp=0, pb=0
    # (decode/lzma2.rs:23-34).
    lc, lp, pb = 0, 0, 0
    abs_out = out_base

    for chunk in table.chunks:
        if chunk.reset_dict or lane is None:
            lane = LanePlan(
                in_start=[], in_end=[], out_start=[], out_end=[],
                reset_state=[], lc=[], lp=[], pb=[],
                seg_base=abs_out, size_known=1,
                dict_size=0xFFFFFFFF,  # LZMA2 has no distance cap per se
            )
            lanes.append(lane)
        if (
            chunk.kind == lzma2_fmt.KIND_LZMA
            and not chunk.reset_state
            and not lane.in_start
            and len(lanes) > 1
        ):
            # first LZMA chunk of a later segment continues the previous
            # segment's probability model: segments are not independent
            raise UnparallelizableStream()
        if chunk.kind == lzma2_fmt.KIND_UNCOMPRESSED:
            prefill.append((chunk.data_off, abs_out, chunk.unpacked_size))
        else:
            if chunk.reset_props:
                lc, lp, pb = chunk.props.lc, chunk.props.lp, chunk.props.pb
            lane.in_start.append(chunk.data_off)
            lane.in_end.append(chunk.data_off + chunk.packed_size)
            lane.out_start.append(abs_out)
            lane.out_end.append(abs_out + chunk.unpacked_size)
            lane.reset_state.append(1 if chunk.reset_state else 0)
            lane.lc.append(lc)
            lane.lp.append(lp)
            lane.pb.append(pb)
        abs_out += chunk.unpacked_size

    plan = DecodePlan(
        lanes=[l for l in lanes if l.in_start],  # drop all-uncompressed lanes
        prefill=prefill,
        total_out=abs_out - out_base,
        pending_error=table.pending_error,
    )
    return plan, table.end_off - start


def _next_pow2(n: int, lo: int = 1) -> int:
    n = max(n, lo)
    return 1 << (n - 1).bit_length()


def _enable_compile_cache() -> None:
    """Persistent XLA compilation cache: ``JAX_COMPILATION_CACHE_DIR``
    when it is set (JAX reads it itself), otherwise ``.jax_cache/`` at the
    root of the checkout (listed in ``.gitignore``; a fixed path, since
    the path is part of the cache key)."""
    import os

    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    jax.config.update("jax_compilation_cache_dir",
                      os.path.join(root, ".jax_cache"))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


@functools.lru_cache(maxsize=8)
def _jitted_decoder():
    import jax

    from lzma_rs_tpu.ops.lane_decoder import decode_lanes

    _enable_compile_cache()
    return jax.jit(decode_lanes, static_argnames=("max_iters", "unroll"))


#: Micro-ops per while-loop iteration of the XLA lane decoder: 4 beat 1
#: on an H100 on both 8 KiB and 64 KiB blocks (PERF.md).
LANE_UNROLL = 4


def execute_plan(data: bytes, plans: List[DecodePlan],
                 unroll: Optional[int] = None) -> bytes:
    """Run stream plans through the XLA lane decoder
    (``ops/lane_decoder.py``, engine ``xla``); returns the concatenated
    decompressed bytes (plans laid out in order). ``unroll`` defaults to
    :data:`LANE_UNROLL`."""
    import jax.numpy as jnp

    total_out = sum(p.total_out for p in plans)
    lanes: List[LanePlan] = []
    prefill: List[Tuple[int, int, int]] = []
    for p in plans:
        lanes.extend(p.lanes)
        prefill.extend(p.prefill)

    out = np.zeros(total_out + 1, dtype=np.uint8)  # +1 dump slot
    src = np.frombuffer(data, dtype=np.uint8)
    for src_off, dst_off, n in prefill:
        out[dst_off : dst_off + n] = src[src_off : src_off + n]

    if not lanes:
        return out[:total_out].tobytes()

    L = _next_pow2(len(lanes))
    K = _next_pow2(max(len(l.in_start) for l in lanes))

    def mk(fill, get, dtype=np.int32):
        arr = np.full((L, K), fill, dtype=dtype)
        for i, l in enumerate(lanes):
            v = get(l)
            arr[i, : len(v)] = v
        return arr

    in_start = mk(0, lambda l: l.in_start)
    in_end = mk(0, lambda l: l.in_end)
    out_start = mk(0, lambda l: l.out_start)
    out_end = mk(0, lambda l: l.out_end)
    reset_state = mk(0, lambda l: l.reset_state)
    lcs = mk(0, lambda l: l.lc)
    lps = mk(0, lambda l: l.lp)
    pbs = mk(0, lambda l: l.pb)
    nchunks = np.zeros(L, dtype=np.int32)
    seg_base = np.zeros(L, dtype=np.int32)
    size_known = np.ones(L, dtype=np.int32)
    dict_size = np.full(L, 0xFFFFFFFF, dtype=np.uint32)
    for i, l in enumerate(lanes):
        nchunks[i] = len(l.in_start)
        seg_base[i] = l.seg_base
        size_known[i] = l.size_known
        dict_size[i] = min(l.dict_size, 0xFFFFFFFF)

    inb = np.zeros(_next_pow2(len(data)), dtype=np.uint8)
    inb[: len(data)] = src
    # Pad the output buffer; the kernel treats the LAST element as the dump
    # slot for masked-off scatters, anything in (total_out, end) is slack.
    out_init = np.zeros(_next_pow2(total_out + 1), dtype=np.uint8)
    out_init[: total_out + 1] = out

    from lzma_rs_tpu.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        from lzma_rs_tpu.platform import device_platform

        st.engine = "xla"
        st.platform = device_platform()
        st.lanes += len(lanes)
        st.chunks += int(nchunks.sum())
        st.prefill_bytes += sum(n for _, _, n in prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += total_out

    fn = _jitted_decoder()
    with stats_mod.launch_timer(st):
        out_dev, err, outp, iters = fn(
            jnp.asarray(inb), jnp.asarray(out_init),
            jnp.asarray(in_start), jnp.asarray(in_end),
            jnp.asarray(out_start), jnp.asarray(out_end),
            jnp.asarray(reset_state), jnp.asarray(lcs), jnp.asarray(lps),
            jnp.asarray(pbs), jnp.asarray(nchunks), jnp.asarray(seg_base),
            jnp.asarray(size_known), jnp.asarray(dict_size),
            unroll=unroll or LANE_UNROLL,
        )
        err_np = np.asarray(err)
    if st is not None:
        st.kernel_iters += int(iters)
    if err_np[: len(lanes)].any():
        lane_idx = int(np.nonzero(err_np[: len(lanes)])[0][0])
        raise _KernelError(lane_idx, int(err_np[lane_idx]))
    return np.asarray(out_dev)[:total_out].tobytes()


def execute_plan_native(
    data: bytes, plans: List[DecodePlan], threads: Optional[int] = None
) -> bytes:
    """Segment-parallel decode on the host: a thread pool drives the native
    C++ flat decoder, one call per dict-reset segment, all writing disjoint
    ranges of one shared output buffer (ctypes releases the GIL, so threads
    scale across cores). This is the host twin of the device engine."""
    import ctypes
    import os
    from concurrent.futures import ThreadPoolExecutor

    from lzma_rs_tpu.native import loader

    lib = loader.load()
    if lib is None:
        raise RuntimeError("native library unavailable")

    total_out = sum(p.total_out for p in plans)
    lanes: List[LanePlan] = []
    prefill: List[Tuple[int, int, int]] = []
    for p in plans:
        lanes.extend(p.lanes)
        prefill.extend(p.prefill)

    out = bytearray(total_out)
    src = np.frombuffer(data, dtype=np.uint8)
    outv = np.frombuffer(out, dtype=np.uint8)
    for src_off, dst_off, n in prefill:
        outv[dst_off : dst_off + n] = src[src_off : src_off + n]

    from lzma_rs_tpu.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.engine = "native"
        st.lanes += len(lanes)
        st.chunks += sum(len(l.in_start) for l in lanes)
        st.prefill_bytes += sum(n for _, _, n in prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += total_out

    if not lanes:
        return bytes(out)

    base_addr = ctypes.addressof(ctypes.c_char.from_buffer(out))

    def run(lane: LanePlan):
        seg_cap = lane.out_end[-1] - lane.seg_base
        chunks = [
            (
                lane.in_start[i],
                lane.in_end[i],
                lane.out_start[i] - lane.seg_base,
                lane.out_end[i] - lane.seg_base,
                lane.reset_state[i],
                lane.lc[i],
                lane.lp[i],
                lane.pb[i],
            )
            for i in range(len(lane.in_start))
        ]
        lib.lzma2_decode_segment(
            data, chunks, base_addr + lane.seg_base, seg_cap
        )

    nthreads = threads or min(32, (os.cpu_count() or 1))
    with stats_mod.launch_timer(st):
        if nthreads <= 1 or len(lanes) == 1:
            for lane in lanes:
                run(lane)
        else:
            with ThreadPoolExecutor(max_workers=nthreads) as pool:
                for f in [pool.submit(run, lane) for lane in lanes]:
                    f.result()
    return bytes(out)


def _execute_native_blockwise(
    data: bytes,
    plans: List[DecodePlan],
    block_spans: List[Tuple[int, int, int, int]],
    header_flags,
) -> bytes:
    """Decode + verify per block in one fused task pipeline."""
    import ctypes
    import os
    from concurrent.futures import ThreadPoolExecutor

    from lzma_rs_tpu.native import loader
    from lzma_rs_tpu.utils import stats as stats_mod

    lib = loader.load()
    if lib is None:
        raise RuntimeError("native library unavailable")

    total_out = sum(p.total_out for p in plans)
    out = bytearray(total_out)
    outv_np = np.frombuffer(out, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    for p in plans:
        for src_off, dst_off, n in p.prefill:
            outv_np[dst_off : dst_off + n] = src[src_off : src_off + n]

    base_addr = ctypes.addressof(ctypes.c_char.from_buffer(out))
    outv = memoryview(out)

    st = stats_mod.current()
    if st is not None:
        st.engine = "native"
        st.lanes += sum(len(p.lanes) for p in plans)
        st.chunks += sum(len(l.in_start) for p in plans for l in p.lanes)
        st.prefill_bytes += sum(n for p in plans for _, _, n in p.prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += total_out

    def run_block(plan: DecodePlan, span):
        _, check_off, out0, outn = span
        for lane in plan.lanes:
            seg_cap = lane.out_end[-1] - lane.seg_base
            chunks = [
                (
                    lane.in_start[i], lane.in_end[i],
                    lane.out_start[i] - lane.seg_base,
                    lane.out_end[i] - lane.seg_base,
                    lane.reset_state[i], lane.lc[i], lane.lp[i], lane.pb[i],
                )
                for i in range(len(lane.in_start))
            ]
            lib.lzma2_decode_segment(
                data, chunks, base_addr + lane.seg_base, seg_cap
            )
        xz_fmt.validate_block_check(
            ByteCursor(data, check_off),
            outv[out0 : out0 + outn],
            header_flags.check_method,
        )

    nthreads = min(32, os.cpu_count() or 1)
    with stats_mod.launch_timer(st):
        if nthreads <= 1 or len(plans) == 1:
            for plan, span in zip(plans, block_spans):
                run_block(plan, span)
        else:
            with ThreadPoolExecutor(max_workers=nthreads) as pool:
                futures = [
                    pool.submit(run_block, plan, span)
                    for plan, span in zip(plans, block_spans)
                ]
                for f in futures:  # stream order: first error wins
                    f.result()
    return bytes(out)


def _record_fallback(reason: str) -> None:
    from lzma_rs_tpu.utils import stats as stats_mod

    st = stats_mod.current()
    if st is not None:
        st.fallbacks.append(reason)
    log.debug("fallback: %s", reason)


def _n_local_devices() -> int:
    """Local devices available to the decode runtime (capped by the
    LZMA_RS_TPU_DEVICES env var)."""
    import os

    import jax

    n = len(jax.devices())
    cap = os.environ.get("LZMA_RS_TPU_DEVICES")
    if cap:
        n = min(n, max(1, int(cap)))
    return n


class _KernelError(Exception):
    """Internal: a lane flagged an error; host replay produces the exact
    reference error."""

    def __init__(self, lane: int, code: int):
        super().__init__(f"lane {lane} error code {code}")
        self.lane = lane
        self.code = code


def _host_lzma2(data: bytes) -> bytes:
    from lzma_rs_tpu.native import loader

    lib = loader.load()
    if lib is not None:
        return lib.lzma2_decode(data)
    from lzma_rs_tpu.models.codecs import Lzma2Decoder

    return Lzma2Decoder().decompress(ByteCursor(data))


# --- device engine: staging and launch ----------------------------------

#: Offsets travel as int32, so one launch covers less than 2 GiB of
#: input and of output.
_DEVICE_MAX_BYTES = (1 << 31) - 1


def _bucket(n: int) -> int:
    """Round a byte count up to a multiple of 2^(bit_length - 5): at most
    6.25% padding and 16 shapes per doubling, so repeated calls reuse
    compiled programs."""
    if n <= 32:
        return _next_pow2(n)
    step = 1 << (n.bit_length() - 5)
    return -(-n // step) * step


@dataclasses.dataclass
class DeviceStage:
    """Operands of one device-engine launch (``ops/segment_decoder.py``),
    with a leading device axis of size ``n_dev``.

    With one device the output buffer uses the stream's own offsets, so
    ``out[:total_out]`` is the result. With several, each device decodes
    its lanes into a compact slab; ``stitch`` lists per device
    ``(global_offset, local_offset, length)`` copies and ``host_prefill``
    the stored chunks no lane reads, which the host places itself."""

    n_dev: int
    inbuf: np.ndarray    # u8[N]
    chunks: np.ndarray   # i32[n_dev, L, K, 8]
    lanes: np.ndarray    # i32[n_dev, L, 3]: chunk count, base, dict limit
    prefill: np.ndarray  # i32[n_dev, P, 3]: src, dst, length
    out_size: int        # output bytes per device
    nprobs: int          # probability entries per lane
    total_out: int
    lane_counts: List[int]
    stitch: List[List[Tuple[int, int, int]]]
    host_prefill: List[Tuple[int, int, int]]


def device_unsupported(data: bytes, plans: List[DecodePlan]) -> Optional[str]:
    """Why the device engine cannot take these plans, or None."""
    total_out = sum(p.total_out for p in plans)
    if len(data) > _DEVICE_MAX_BYTES or total_out > _DEVICE_MAX_BYTES:
        return "device: input or output beyond 2 GiB in one launch"
    for p in plans:
        for lane in p.lanes:
            if any(lc + lp > 4 for lc, lp in zip(lane.lc, lane.lp)):
                return "device: lc + lp > 4"
    return None


def stage_device(data: bytes, plans: List[DecodePlan], n_dev: int = 1
                 ) -> DeviceStage:
    """Build the device launch for ``plans``: lanes (dict-reset segments)
    sorted longest first and, with several devices, spread over them by
    decoded size (longest-processing-time greedy); chunk tables padded to
    power-of-two L and K; input and output sizes bucketed."""
    from lzma_rs_tpu.ops.segment_decoder import probs_per_lane

    lanes = [lane for p in plans for lane in p.lanes]
    prefill = [t for p in plans for t in p.prefill]
    total_out = sum(p.total_out for p in plans)
    seg_len = [lane.out_end[-1] - lane.seg_base for lane in lanes]
    order = sorted(range(len(lanes)), key=lambda i: -seg_len[i])
    n_dev = max(1, min(n_dev, len(lanes)))

    groups: List[List[int]] = [[] for _ in range(n_dev)]
    if n_dev == 1:
        groups[0] = order
        base = [lane.seg_base for lane in lanes]
        out_size = total_out
    else:
        import heapq

        base = [0] * len(lanes)
        heap = [(0, d) for d in range(n_dev)]
        for i in order:
            load, d = heapq.heappop(heap)
            base[i] = load
            groups[d].append(i)
            heapq.heappush(heap, (load + seg_len[i], d))
        out_size = max(load for load, _ in heap)

    L = _next_pow2(max(len(g) for g in groups))
    K = _next_pow2(max((len(lane.in_start) for lane in lanes), default=1))
    chunks = np.zeros((n_dev, L, K, 8), dtype=np.int32)
    lane_tab = np.zeros((n_dev, L, 3), dtype=np.int32)
    if lanes:
        dev_of = np.zeros(len(lanes), dtype=np.int64)
        slot_of = np.zeros(len(lanes), dtype=np.int64)
        for d, g in enumerate(groups):
            dev_of[g] = d
            slot_of[g] = np.arange(len(g))
        counts = np.array([len(lane.in_start) for lane in lanes])
        flat = lambda attr: np.fromiter(  # noqa: E731
            (v for lane in lanes for v in getattr(lane, attr)), np.int64,
            int(counts.sum()),
        )
        seg_base = np.repeat([lane.seg_base for lane in lanes], counts)
        rows = np.stack(
            [flat("in_start"), flat("in_end"),
             flat("out_start") - seg_base, flat("out_end") - seg_base,
             flat("reset_state")
             + 2 * np.repeat([int(lane.exact_end) for lane in lanes], counts),
             flat("lc"), flat("lp"), flat("pb")],
            axis=1,
        )
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        cidx = np.arange(len(rows)) - np.repeat(starts, counts)
        chunks[np.repeat(dev_of, counts), np.repeat(slot_of, counts),
               cidx] = rows
        lane_tab[dev_of, slot_of, 0] = counts
        lane_tab[dev_of, slot_of, 1] = base
        lane_tab[dev_of, slot_of, 2] = np.array(
            [min(lane.dict_size, 0xFFFFFFFF) for lane in lanes], np.uint32
        ).view(np.int32)

    stitch: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_dev)]
    host_prefill: List[Tuple[int, int, int]] = []
    dev_prefill: List[List[Tuple[int, int, int]]] = [[] for _ in range(n_dev)]
    if n_dev == 1:
        dev_prefill[0] = prefill
    else:
        for d, g in enumerate(groups):
            stitch[d] = [(lanes[i].seg_base, base[i], seg_len[i]) for i in g]
        # a stored chunk goes with the lane whose segment holds it (later
        # chunks of that lane read it as history); the rest go on the host
        by_start = sorted(range(len(lanes)), key=lambda i: lanes[i].seg_base)
        starts_sorted = [lanes[i].seg_base for i in by_start]
        import bisect

        for src, dst, n in prefill:
            k = bisect.bisect_right(starts_sorted, dst) - 1
            i = by_start[k] if k >= 0 else -1
            if i >= 0 and dst + n <= lanes[i].seg_base + seg_len[i]:
                dev = int(dev_of[i])
                dev_prefill[dev].append(
                    (src, base[i] + dst - lanes[i].seg_base, n)
                )
            else:
                host_prefill.append((src, dst, n))
    P = _next_pow2(max(len(p) for p in dev_prefill))
    pre = np.zeros((n_dev, P, 3), dtype=np.int32)
    for d, entries in enumerate(dev_prefill):
        if entries:
            pre[d, : len(entries)] = entries

    inbuf = np.zeros(_bucket(len(data)), dtype=np.uint8)
    inbuf[: len(data)] = np.frombuffer(data, dtype=np.uint8)
    max_lclp = max(
        (lc + lp for lane in lanes for lc, lp in zip(lane.lc, lane.lp)),
        default=0,
    )
    return DeviceStage(
        n_dev=n_dev, inbuf=inbuf, chunks=chunks, lanes=lane_tab,
        prefill=pre, out_size=_bucket(max(1, out_size)),
        nprobs=probs_per_lane(max_lclp), total_out=total_out,
        lane_counts=[len(g) for g in groups], stitch=stitch,
        host_prefill=host_prefill,
    )


def execute_plan_device(data: bytes, plans: List[DecodePlan]) -> bytes:
    """Decode stream plans on the device engine: one ``lrt_segment_decode``
    launch (``ops/segment_decoder.py``) over all lanes, split across the
    local devices. Raises :class:`_KernelError` if any lane fails."""
    import jax.numpy as jnp

    from lzma_rs_tpu.ops import segment_decoder as sd
    from lzma_rs_tpu.platform import device_platform
    from lzma_rs_tpu.utils import stats as stats_mod

    stage = stage_device(data, plans, _n_local_devices())
    st = stats_mod.current()
    if st is not None:
        st.engine = "device"
        st.platform = device_platform()
        st.lanes += sum(stage.lane_counts)
        st.chunks += int(stage.lanes[..., 0].sum())
        st.prefill_bytes += sum(n for p in plans for _, _, n in p.prefill)
        st.packed_bytes += len(data)
        st.unpacked_bytes += stage.total_out
        st.devices = max(st.devices, stage.n_dev)
        st.lanes_per_device = list(stage.lane_counts)
    if not any(stage.lane_counts):
        out = np.zeros(stage.total_out, dtype=np.uint8)
        src = np.frombuffer(data, dtype=np.uint8)
        for s, d, n in (t for p in plans for t in p.prefill):
            out[d : d + n] = src[s : s + n]
        return out.tobytes()

    fn = sd.jitted(stage.n_dev, stage.out_size, stage.nprobs)
    operands = (stage.chunks, stage.lanes, stage.prefill)
    if stage.n_dev == 1:
        operands = tuple(a[0] for a in operands)
    with stats_mod.launch_timer(st):
        out, err = fn(jnp.asarray(stage.inbuf), *operands)
        err_np = np.asarray(err).reshape(stage.n_dev, -1)
        for d, count in enumerate(stage.lane_counts):
            bad = np.nonzero(err_np[d, :count])[0]
            if bad.size:
                raise _KernelError(int(bad[0]), int(err_np[d, bad[0]]))
        out_np = np.asarray(out)
    if stage.n_dev == 1:
        return out_np[: stage.total_out].tobytes()
    slabs = out_np.reshape(stage.n_dev, stage.out_size)
    res = np.empty(stage.total_out, dtype=np.uint8)
    src = np.frombuffer(data, dtype=np.uint8)
    for s, d, n in stage.host_prefill:
        res[d : d + n] = src[s : s + n]
    for d, copies in enumerate(stage.stitch):
        for g, local, n in copies:
            res[g : g + n] = slabs[d, local : local + n]
    return res.tobytes()


# --- engines and the auto router ----------------------------------------

#: Engines a caller may name: ``native`` (host threads), ``device`` (the
#: decode kernel through jax.ffi on the default backend), ``xla`` (the
#: plain lax.while_loop lane decoder, kept as the device comparison).
ENGINES = ("auto", "native", "device", "xla")

#: ``auto`` takes the device engine on a CUDA GPU for streams with at
#: least this many lanes and this much output; smaller work stays on the
#: host, where a launch's fixed cost is not repaid.
AUTO_MIN_LANES = 64
AUTO_MIN_OUT = 1 << 20
#: ... and no lane (dict-reset segment) longer than this. One card
#: thread decodes a whole lane at a few MB/s, so long lanes bound the
#: kernel: on an H100, 64 KiB lanes decoded as fast as or faster than on
#: the host engine, 256 KiB lanes 4% slower, 1 MiB lanes 2.2x slower
#: (PERF.md).
AUTO_MAX_LANE_OUT = 64 << 10


def _resolve_auto_engine(data: bytes, plans: List[DecodePlan]) -> str:
    """``auto``: the device engine on a CUDA GPU for enough lanes and
    output (:data:`AUTO_MIN_LANES`, :data:`AUTO_MIN_OUT`) and lanes no
    longer than :data:`AUTO_MAX_LANE_OUT`, else native. The size rules
    come first so small host decodes never import JAX."""
    n_lanes = sum(len(p.lanes) for p in plans)
    total_out = sum(p.total_out for p in plans)
    if n_lanes < AUTO_MIN_LANES or total_out < AUTO_MIN_OUT:
        _record_fallback(
            f"auto->native: small workload ({n_lanes} lanes, "
            f"{total_out} B out)"
        )
        return "native"
    longest = max(lane.out_end[-1] - lane.seg_base
                  for p in plans for lane in p.lanes)
    if longest > AUTO_MAX_LANE_OUT:
        _record_fallback(f"auto->native: long lanes (longest {longest} B)")
        return "native"
    from lzma_rs_tpu.platform import has_cuda

    if not has_cuda():
        return "native"
    reason = device_unsupported(data, plans)
    if reason:
        _record_fallback(f"auto->native: {reason}")
        return "native"
    return "device"


def _check_engine(engine: str) -> None:
    if engine not in ENGINES:
        raise ValueError(
            f"unknown engine {engine!r} (expected one of {ENGINES})"
        )


def _decode_on_device(data: bytes, plans: List[DecodePlan], engine: str
                      ) -> Optional[bytes]:
    """Run ``plans`` on a device engine ("device" or "xla"). Returns None
    when the device engine cannot take them (the reason is recorded);
    raises :class:`_KernelError` on a lane error."""
    # A truncated stream declares its last chunk past the input. Both
    # device engines see a padded input buffer, so this is caught here,
    # as lrt_seg::kErrEof (2), and the host replays the stream.
    n = len(data)
    lanes = [lane for p in plans for lane in p.lanes]
    for i, lane in enumerate(lanes):
        if lane.in_end[-1] > n:
            raise _KernelError(i, 2)
    if any(s + k > n for p in plans for s, _, k in p.prefill):
        raise _KernelError(-1, 2)
    if engine == "xla":
        return execute_plan(data, plans)
    reason = device_unsupported(data, plans)
    if reason:
        _record_fallback(reason)
        return None
    return execute_plan_device(data, plans)


def lzma2_decode(data: bytes, engine: str = "device") -> bytes:
    """Parallel LZMA2 decode of a full chunk stream."""
    _check_engine(engine)
    data = bytes(data)
    try:
        plan, consumed = plan_lzma2_stream(data, 0, 0)
    except UnparallelizableStream:
        _record_fallback("host: stream carries prob state across dict reset")
        return _host_lzma2(data)
    if plan.pending_error is not None:
        # A chunk-header error behind decodable chunks: only a sequential
        # decode reproduces the reference's error ordering (the prefix's
        # own decode errors come first). _host_lzma2 is the native
        # sequential chunk loop.
        _record_fallback("host replay: chunk-header error after prefix")
        return _host_lzma2(data)
    if engine == "auto":
        engine = _resolve_auto_engine(data, [plan])
    if engine != "native":
        try:
            out = _decode_on_device(data, [plan], engine)
        except _KernelError as e:
            # corrupt stream: the host replay gives the reference's error
            _record_fallback(f"host replay: lane error code {e.code}")
            return _host_lzma2(data)
        if out is not None:
            return out
    try:
        return execute_plan_native(data, [plan])
    except Exception:
        # exact reference-parity error (or output) via sequential host
        return _host_lzma2(data)


def lzma_raw_decode_device(data: bytes, payload_off: int, params) -> bytes:
    """Raw LZMA decode on the device engine (one lane, one chunk).

    Requires a known unpacked size (the flat output is allocated up
    front) and ``lc + lp <= 4`` (raw LZMA allows lc <= 8); callers route
    other streams to the host engines. The declared dictionary size caps
    match distances, as in the reference's window."""
    p = params.properties
    if params.unpacked_size is None or p.lc + p.lp > 4:
        raise ValueError("device path needs known size and lc+lp <= 4")
    total_out = int(params.unpacked_size)
    lane = LanePlan(
        in_start=[payload_off],
        in_end=[len(data)],
        out_start=[0],
        out_end=[total_out],
        reset_state=[1],
        lc=[p.lc], lp=[p.lp], pb=[p.pb],
        seg_base=0,
        size_known=1,
        dict_size=min(params.dict_size, 0xFFFFFFFF),
        exact_end=False,
    )
    plan = DecodePlan(lanes=[lane], prefill=[], total_out=total_out)

    def _host_replay() -> bytes:
        # exact reference error strings / output via the host engines
        from lzma_rs_tpu.native import loader

        lib = loader.load()
        if lib is not None:
            res = lib.lzma_decode(data, payload_off, params, None)
            if res is not None:
                return res
        from lzma_rs_tpu.models.codecs import LzmaDecoder

        cursor = ByteCursor(data, payload_off)
        return LzmaDecoder(params, None).decompress(cursor)

    try:
        out = _decode_on_device(data, [plan], "device")
    except _KernelError as e:
        _record_fallback(f"host replay: lane error code {e.code}")
        return _host_replay()
    return _host_replay() if out is None else out


def xz_decode(data: bytes, engine: str = "device") -> bytes:
    """Parallel `.xz` decode: all blocks' segments in one launch.

    ``engine`` is one of :data:`ENGINES`: "device" = the decode kernel on
    the default JAX backend; "native" = thread pool over the C++ flat
    decoder; "xla" = the plain lane decoder; "auto" = the router.
    """
    _check_engine(engine)
    data = bytes(data)
    try:
        return _xz_decode_parallel(data, engine)
    except UnparallelizableStream:
        _record_fallback("host: stream carries prob state across dict reset")
        return _sequential_xz_replay(data)


def plan_xz(data: bytes, stop_on_error: bool = False):
    """Pass 1 of `.xz` decode: walk the container (headers + chunk tables,
    no payload decoding) and return
    ``(plans, block_spans, header_flags, records, cursor)`` with the
    cursor parked at the index. Each block's plan carries absolute output
    offsets, so placement is known before any decode.

    ``stop_on_error`` (the bounded corrupt-archive path): block-scope
    errors — a malformed block header, size mismatches, or a deferred
    chunk-header error behind decodable chunks — stop the walk instead
    of raising, and a SIXTH element carries the deferred exception. The
    returned plans then cover exactly what the reference's sequential
    decoder would decode before hitting the error (complete prefix
    blocks, plus the erroring block's decodable chunk prefix whose span
    has check_off=None); the caller decodes/verifies that prefix and
    re-raises. An adversarial input no longer costs a full sequential
    replay unless the prefix itself fails (VERDICT r4 weak #8)."""
    from lzma_rs_tpu.utils.errors import IoError

    cursor = ByteCursor(data)
    header_flags = xz_fmt.parse_stream_header(cursor)

    plans: List[DecodePlan] = []
    block_spans: List[Tuple[int, int, int, int]] = []  # start, payload, out0, outn
    records: List[xz_fmt.Record] = []
    out_base = 0
    deferred: Optional[Exception] = None

    while True:
        block_start = cursor.pos
        try:
            info = xz_fmt.read_block_header_at(cursor)
            if info is None:
                break
            filt = info.header.filters[0]
            if len(filt.props) != 1:
                raise XzError("Invalid properties for filter Lzma2")
            payload_start = cursor.pos
            plan, consumed = plan_lzma2_stream(data, payload_start, out_base)
            if plan.pending_error is not None:
                # A chunk-header error behind decodable chunks: the
                # reference surfaces prefix decode errors (then this
                # error) before any container-level size validation.
                if not stop_on_error:
                    raise UnparallelizableStream()
                deferred = plan.pending_error
                if plan.lanes or plan.prefill:
                    plans.append(plan)
                    block_spans.append(
                        (block_start, None, out_base, plan.total_out)
                    )
                break
            cursor.pos = payload_start + consumed
            if (
                info.header.packed_size is not None
                and consumed != info.header.packed_size
            ):
                raise XzError(
                    f"Invalid compressed size: expected "
                    f"{info.header.packed_size} but got {consumed}"
                )
            if (
                info.header.unpacked_size is not None
                and plan.total_out != info.header.unpacked_size
            ):
                raise XzError(
                    f"Invalid decompressed size: expected "
                    f"{info.header.unpacked_size} but got {plan.total_out}"
                )
            count = cursor.pos - block_start
            pad = xz_fmt.padding_size(count)
            xz_fmt.read_padding(cursor, pad, "block")
            check_off = cursor.pos
            cursor.skip(xz_fmt.check_size(header_flags.check_method))
        except UnparallelizableStream:
            raise
        except (LzmaError, XzError, IoError) as e:
            if not stop_on_error:
                raise
            deferred = e
            break
        plans.append(plan)
        block_spans.append((block_start, check_off, out_base, plan.total_out))
        records.append(
            xz_fmt.Record(
                unpadded_size=cursor.pos - block_start - pad,
                unpacked_size=plan.total_out,
            )
        )
        out_base += plan.total_out

    if stop_on_error:
        return plans, block_spans, header_flags, records, cursor, deferred
    return plans, block_spans, header_flags, records, cursor


def _sequential_xz_replay(data: bytes) -> bytes:
    """Reference-ordered sequential `.xz` decode for error replay.

    Uses the spec container walk (exact reference errors) with the
    NATIVE sequential LZMA2 chunk loop as the payload decoder when
    available — pure-Python payload decode is ~0.1 MB/s, which made
    replaying a large corrupt archive take minutes."""
    from lzma_rs_tpu.models.codecs import xz_decode_stream
    from lzma_rs_tpu.native import loader

    lib = loader.load()
    hook = None
    if lib is not None:
        buf = data

        def hook(cursor):
            out, consumed = lib.lzma2_decode_at(buf, cursor.pos)
            cursor.pos += consumed
            return out

    return xz_decode_stream(ByteCursor(data), decode_lzma2=hook)


def _bounded_error_replay(
    data: bytes, plans, block_spans, header_flags, deferred: Exception
) -> bytes:
    """Bounded corrupt-archive path: the planner stopped at a block-scope
    error with a clean prefix plan. Decode the prefix with the parallel
    NATIVE engine and verify its checks in stream order; if everything
    is clean the reference's first error IS the deferred one — raise it
    without replaying the archive sequentially. Any prefix failure falls
    back to the full sequential replay (exact reference ordering)."""
    try:
        if plans:
            out = execute_plan_native(data, plans)
            outv = memoryview(out)
            for block_start, check_off, out0, outn in block_spans:
                if check_off is None:
                    continue  # the erroring block never reaches its check
                xz_fmt.validate_block_check(
                    ByteCursor(data, check_off), outv[out0 : out0 + outn],
                    header_flags.check_method,
                )
    except (LzmaError, XzError) as e:
        # a prefix error surfaces before the deferred one — but only the
        # sequential decoder guarantees the reference's exact ordering
        # for multi-error prefixes
        _record_fallback(
            f"host replay: prefix error before deferred ({e})"
        )
        return _sequential_xz_replay(data)
    except Exception:
        _record_fallback("host replay: prefix decode failed (bounded path)")
        return _sequential_xz_replay(data)
    _record_fallback("bounded replay: clean prefix, raising deferred error")
    raise deferred


def _xz_decode_parallel(data: bytes, engine: str) -> bytes:
    from lzma_rs_tpu.utils.errors import IoError

    try:
        (plans, block_spans, header_flags, records, cursor,
         deferred) = plan_xz(data, stop_on_error=True)
        if deferred is not None:
            # Malformed archive with a decodable prefix: the reference
            # interleaves block decode with the walk, so the prefix must
            # decode (and check) cleanly before this error surfaces.
            # Bounded work: parallel prefix decode + one error raise
            # instead of a whole-archive sequential replay.
            return _bounded_error_replay(
                data, plans, block_spans, header_flags, deferred
            )
        index_size = xz_fmt.check_index(cursor, records)
    except UnparallelizableStream:
        raise
    except (LzmaError, XzError, IoError):
        # Stream-header or index-level error: blocks all planned clean,
        # but the reference decodes them (with checks) before reaching
        # the index/footer. The sequential decoder reproduces the
        # ordering exactly (and re-raises this error when it is first).
        _record_fallback("host replay: container error during planning")
        return _sequential_xz_replay(data)

    if engine == "auto":
        engine = _resolve_auto_engine(data, plans)

    # Pass 2: decode all blocks in one parallel launch.
    out = None
    if engine != "native":
        try:
            out = _decode_on_device(data, plans, engine)
        except _KernelError as e:
            _record_fallback(f"host replay: lane error code {e.code}")
            return _sequential_xz_replay(data)
    if out is None:
        # The native engine pipelines: each block's task decodes its
        # segments then verifies its check immediately, so hashing
        # overlaps the decode of later blocks (errors still surface in
        # stream order).
        try:
            out = _execute_native_blockwise(
                data, plans, block_spans, header_flags
            )
        except Exception:
            return _sequential_xz_replay(data)
        xz_fmt.check_footer(cursor, header_flags, index_size)
        return out

    # Pass 3: verify block checks. Stream order for error determinism; the
    # hashing itself fans out across a small thread pool (zlib / native
    # crc64 release the GIL), or runs on the card (ops/crc_device.py) for
    # CRC blocks of at least 1 MiB when LZMA_RS_TPU_DEVICE_CRC=1.
    import os

    from lzma_rs_tpu.platform import has_cuda

    device_crc = (
        engine == "device"
        and os.environ.get("LZMA_RS_TPU_DEVICE_CRC") == "1"
        and header_flags.check_method in (xz_fmt.CHECK_CRC32,
                                          xz_fmt.CHECK_CRC64)
        and has_cuda()
    )
    outv = memoryview(out)

    def check_one(span):
        block_start, check_off, out0, outn = span
        chk = ByteCursor(data, check_off)
        block_out = outv[out0 : out0 + outn]
        if device_crc and outn >= (1 << 20):
            import time as _time

            from lzma_rs_tpu.ops import crc_device
            from lzma_rs_tpu.utils import stats as stats_mod

            st = stats_mod.current()
            t0 = _time.perf_counter()
            if header_flags.check_method == xz_fmt.CHECK_CRC32:
                expected = chk.read_u32_le()
                digest = crc_device.crc32_device(bytes(block_out))
                if expected != digest:
                    raise XzError(
                        f"Invalid block CRC32, expected 0x{expected:08x} "
                        f"but got 0x{digest:08x}"
                    )
            else:
                expected = int.from_bytes(chk.read_exact(8), "little")
                digest = crc_device.crc64_device(bytes(block_out))
                if expected != digest:
                    raise XzError(
                        f"Invalid block CRC64, expected 0x{expected:016x} "
                        f"but got 0x{digest:016x}"
                    )
            if st is not None:
                st.device_crc_seconds += _time.perf_counter() - t0
                st.device_crc_bytes += outn
        else:
            xz_fmt.validate_block_check(
                chk, block_out, header_flags.check_method
            )

    if len(block_spans) > 1 and not device_crc:
        from concurrent.futures import ThreadPoolExecutor

        with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as pool:
            futures = [pool.submit(check_one, s) for s in block_spans]
            for f in futures:  # stream order preserved for first error
                f.result()
    else:
        for span in block_spans:
            check_one(span)

    xz_fmt.check_footer(cursor, header_flags, index_size)
    return out
