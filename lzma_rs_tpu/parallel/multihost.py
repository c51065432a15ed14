"""Multi-host block-parallel `.xz` decode (DP across processes).

The reference is single-process (SURVEY.md §2.3); multi-host scaling is a
new capability derived from `.xz` block independence
(the reference's ``src/decode/xz.rs:196-290``): every block carries its own
filter chain, window, and check, and the stream index records per-block
sizes, so

1. every host parses the (tiny) container and computes the same block
   table and absolute output offsets — no communication,
2. blocks are assigned greedily by packed size (static, deterministic),
3. each host decodes its blocks locally (device or native engine),
4. outputs are exchanged with one ``process_allgather`` and
   stitched by the precomputed offsets — placement is known *before*
   decode, so the gather is the only collective and ordering is
   deterministic.

Initialize with ``jax.distributed.initialize()`` before calling
:func:`xz_decode_multihost`. Single-process invocation degrades to local
decode (the gather is the identity), which is how the unit tests exercise
the path; multi-process CPU JAX stands in for several hosts.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from lzma_rs_tpu.formats import xz as xz_fmt
from lzma_rs_tpu.utils.cursor import ByteCursor


@dataclasses.dataclass(frozen=True)
class BlockSpan:
    header_off: int
    payload_start: int
    payload_len: int
    check_off: int
    out_base: int
    out_len: int


def scan_blocks(data: bytes) -> Tuple[xz_fmt.StreamFlags, List[BlockSpan], int]:
    """Walk the container once; every host derives the identical table."""
    from lzma_rs_tpu.parallel import runtime as rt

    cursor = ByteCursor(data)
    flags = xz_fmt.parse_stream_header(cursor)
    spans: List[BlockSpan] = []
    out_base = 0
    while True:
        header_off = cursor.pos
        info = xz_fmt.read_block_header_at(cursor)
        if info is None:
            break
        payload_start = cursor.pos
        plan, consumed = rt.plan_lzma2_stream(data, payload_start, 0)
        if plan.pending_error is not None:
            # A chunk-header error behind decodable chunks: only a
            # sequential decode reproduces the reference's error
            # ordering (the prefix's own decode errors come first) —
            # same rule as runtime.plan_xz / lzma2_decode.
            raise rt.UnparallelizableStream()
        cursor.pos = payload_start + consumed
        pad = xz_fmt.padding_size(cursor.pos - header_off)
        cursor.skip(pad)
        check_off = cursor.pos
        cursor.skip(xz_fmt.check_size(flags.check_method))
        spans.append(
            BlockSpan(
                header_off=header_off,
                payload_start=payload_start,
                payload_len=consumed,
                check_off=check_off,
                out_base=out_base,
                out_len=plan.total_out,
            )
        )
        out_base += plan.total_out
    return flags, spans, out_base


def assign_blocks(spans: List[BlockSpan], n_hosts: int) -> List[int]:
    """Greedy size-balanced, deterministic owner per block."""
    loads = [0] * n_hosts
    owner = []
    for s in spans:
        h = min(range(n_hosts), key=lambda i: (loads[i], i))
        owner.append(h)
        loads[h] += s.payload_len
    return owner


#: Target decoded bytes per gather wave: small enough that the first
#: gather starts early (communication overlaps later waves' decode),
#: large enough that per-collective latency amortizes. Tunable via
#: LZMA_RS_TPU_WAVE_BYTES for the network between the hosts.
import os as _os

WAVE_BYTES = int(_os.environ.get("LZMA_RS_TPU_WAVE_BYTES", 8 << 20))


def plan_waves(
    spans: List[BlockSpan], owner: List[int], n_hosts: int,
    wave_bytes: int = WAVE_BYTES,
) -> Tuple[List[List[List[BlockSpan]]], List[int]]:
    """Deterministic wave schedule, identical on every host.

    Returns ``(host_waves, wave_sizes)``: ``host_waves[h][w]`` is host
    h's block list for wave w (contiguous in stream order), and
    ``wave_sizes[w]`` the padded per-host buffer size of wave w's
    all-gather (max over hosts). Collectives must execute in the same
    order with the same shapes on every process, so the schedule is a
    pure function of the shared block table."""
    per_host = [
        [s for s, o in zip(spans, owner) if o == h] for h in range(n_hosts)
    ]
    max_owned = max(
        (sum(s.out_len for s in hs) for hs in per_host), default=0
    )
    n_waves = max(1, -(-max_owned // wave_bytes))
    host_waves: List[List[List[BlockSpan]]] = []
    for hs in per_host:
        total = sum(s.out_len for s in hs)
        groups: List[List[BlockSpan]] = [[] for _ in range(n_waves)]
        acc = 0
        for s in hs:
            w = min(n_waves - 1, acc * n_waves // max(total, 1))
            groups[w].append(s)
            acc += s.out_len
        host_waves.append(groups)
    wave_sizes = [
        max(
            (sum(s.out_len for s in host_waves[h][w]) for h in range(n_hosts)),
            default=0,
        )
        for w in range(n_waves)
    ]
    return host_waves, wave_sizes


def stitch_waves(
    host_waves: List[List[List[BlockSpan]]],
    gathered_waves: List[np.ndarray],
    n_hosts: int,
    total_out: int,
) -> np.ndarray:
    """Reassemble the ordered stream from per-wave gathered buffers.

    ``gathered_waves[w]`` is the wave-w all-gather result, shape
    ``[n_hosts, wave_sizes[w]]``: each host's dense concatenation of its
    wave-w blocks (padded with zeros to the wave size). Placement is
    known before decode (``BlockSpan.out_base`` comes from the shared
    block table), so stitching is pure bookkeeping — walk each wave's
    spans in stream order, consuming each owner's dense buffer
    sequentially."""
    full = np.zeros(total_out, dtype=np.uint8)
    for w, gathered in enumerate(gathered_waves):
        for h in range(n_hosts):
            c = 0
            for s in host_waves[h][w]:
                full[s.out_base : s.out_base + s.out_len] = gathered[
                    h, c : c + s.out_len
                ]
                c += s.out_len
    return full


def xz_decode_multihost(data: bytes, engine: str = "native") -> bytes:
    """Decode `.xz` with blocks sharded across JAX processes.

    Every process must call this with identical ``data``; every process
    returns the full decompressed bytes. Output moves in *waves*: as soon
    as a host finishes its first wave of blocks, that wave's all-gather
    runs on a background thread while the next wave decodes — network
    communication overlaps decode instead of one big end-of-job gather.
    """
    import jax

    data = bytes(data)
    n_hosts = jax.process_count()
    host = jax.process_index()

    from lzma_rs_tpu.native.loader import SegmentError
    from lzma_rs_tpu.parallel import runtime as rt

    if n_hosts == 1:
        return rt.xz_decode(data, engine=engine)

    try:
        flags, spans, total_out = scan_blocks(data)
    except rt.UnparallelizableStream:
        # Deterministic on every host (identical data -> identical
        # raise), so no process ever reaches a collective: each decodes
        # sequentially and returns the same result/error.
        return rt.xz_decode(data, engine=engine)
    owner = assign_blocks(spans, n_hosts)
    host_waves, wave_sizes = plan_waves(spans, owner, n_hosts)

    import os
    from concurrent.futures import ThreadPoolExecutor

    from jax.experimental import multihost_utils

    threads = max(1, (os.cpu_count() or 1) // n_hosts)

    def decode_wave(wave_spans, size):
        local = np.zeros(size, dtype=np.uint8)
        off = 0
        for s in wave_spans:
            plan, _ = rt.plan_lzma2_stream(data, s.payload_start, 0)
            if plan.pending_error is not None:  # scan_blocks screened it
                raise plan.pending_error
            eng = engine
            if eng == "auto":
                # same routing as the single-host paths; deterministic
                # per plan, so identical on every host (the collective
                # schedule never depends on it)
                eng = rt._resolve_auto_engine(data, [plan])
            if eng in ("native", "device", "xla"):
                # Any device failure (a lane error on corrupt data, or a
                # plan the device cannot take) falls back to the native
                # engine, and a native segment error to the block's
                # sequential decode, so errors keep reference parity like
                # the single-host paths.
                out = None
                if eng != "native":
                    try:
                        out = rt._decode_on_device(data, [plan], eng)
                    except rt._KernelError:
                        pass
                if out is None:
                    try:
                        out = rt.execute_plan_native(
                            data, [plan], threads=threads
                        )
                    except SegmentError:
                        end = s.payload_start + s.payload_len
                        out = rt._host_lzma2(data[s.payload_start : end])
            else:
                raise ValueError(
                    f"unknown engine {eng!r} (expected one of {rt.ENGINES})"
                )
            local[off : off + s.out_len] = np.frombuffer(out, dtype=np.uint8)
            off += s.out_len
        return local

    # One background worker keeps the collective order identical on every
    # process; the native decode releases the GIL, so wave w's gather
    # genuinely overlaps wave w+1's decode.
    import time as _time

    from lzma_rs_tpu.utils import stats as stats_mod

    st = stats_mod.current()
    t_decode = 0.0
    futs = []
    with ThreadPoolExecutor(max_workers=1) as gather_pool:
        for w, size in enumerate(wave_sizes):
            t0 = _time.perf_counter()
            local = decode_wave(host_waves[host][w], size)
            t_decode += _time.perf_counter() - t0
            futs.append(
                gather_pool.submit(multihost_utils.process_allgather, local)
            )
        t0 = _time.perf_counter()
        gathered_waves = [
            np.asarray(f.result()).reshape(n_hosts, -1) for f in futs
        ]
        t_gather_wait = _time.perf_counter() - t0
    if st is not None:
        st.multihost_decode_seconds += t_decode
        st.multihost_gather_wait_seconds += t_gather_wait
        st.multihost_waves += len(wave_sizes)

    full = stitch_waves(host_waves, gathered_waves, n_hosts, total_out)

    # Every host verifies checks + index + footer on the assembled result.
    for s in spans:
        chk = ByteCursor(data, s.check_off)
        xz_fmt.validate_block_check(
            chk, bytes(full[s.out_base : s.out_base + s.out_len]),
            flags.check_method,
        )
    records = [
        xz_fmt.Record(
            unpadded_size=(
                s.check_off
                + xz_fmt.check_size(flags.check_method)
                - s.header_off
                - xz_fmt.padding_size(s.payload_start + s.payload_len - s.header_off)
            ),
            unpacked_size=s.out_len,
        )
        for s in spans
    ]
    cursor = ByteCursor(data)
    if spans:
        cursor.pos = (
            spans[-1].check_off + xz_fmt.check_size(flags.check_method)
        )
    else:
        xz_fmt.parse_stream_header(cursor)
    index_size = xz_fmt.check_index(cursor, records)
    xz_fmt.check_footer(cursor, flags, index_size)
    return bytes(full)
