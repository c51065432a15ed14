"""Structured decode statistics (observability).

The reference's observability is gated logging plus descriptive error
strings (SURVEY.md §5); the framework adds a lightweight structured stats
channel: per-call and per-block counters aggregated host-side, enabled via
``LZMA_RS_TPU_STATS=1`` or programmatically. Kernels never log; the runtime
records around launches.

Usage::

    from lzma_rs_tpu.utils import stats
    with stats.collect() as s:
        lzma_rs_tpu.xz_decompress(data)
    print(s.to_dict())
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
from typing import List, Optional

_tls = threading.local()


@dataclasses.dataclass
class BlockStat:
    index: int
    packed_bytes: int
    unpacked_bytes: int
    segments: int
    chunks: int


@dataclasses.dataclass
class DecodeStats:
    engine: str = ""
    #: Where a device engine ran: "cuda" on a GPU, "cpu" for the CPU
    #: handler of the same decode core (tests); empty for host engines.
    platform: str = ""
    packed_bytes: int = 0
    unpacked_bytes: int = 0
    lanes: int = 0
    chunks: int = 0
    prefill_bytes: int = 0
    launch_seconds: float = 0.0
    kernel_iters: int = 0
    device_crc_seconds: float = 0.0
    device_crc_bytes: int = 0
    devices: int = 0
    #: Lanes each device decoded in the last device-engine launch.
    lanes_per_device: List[int] = dataclasses.field(default_factory=list)
    multihost_decode_seconds: float = 0.0
    #: Residual wait on the overlapped wave gathers after local decode
    #: finished (0 = communication fully hidden behind decode).
    multihost_gather_wait_seconds: float = 0.0
    multihost_waves: int = 0
    blocks: List[BlockStat] = dataclasses.field(default_factory=list)
    #: Why a faster engine was skipped or the host replayed a stream
    #: (e.g. "auto->native: small workload (3 lanes, 2048 B out)"). Per
    #: SURVEY's "no silent caps": device measurements must not silently
    #: measure a fallback engine.
    fallbacks: List[str] = dataclasses.field(default_factory=list)

    def to_dict(self) -> dict:
        """Serialize counters (adds derived throughput_mb_s when timed)."""
        d = dataclasses.asdict(self)
        if self.launch_seconds > 0 and self.unpacked_bytes:
            d["throughput_mb_s"] = round(
                self.unpacked_bytes / 1e6 / self.launch_seconds, 2
            )
        return d


def enabled() -> bool:
    """True when a stats collection is active (or LZMA_RS_TPU_STATS set)."""
    return getattr(_tls, "active", None) is not None or bool(
        os.environ.get("LZMA_RS_TPU_STATS")
    )


def current() -> Optional[DecodeStats]:
    """The thread's active DecodeStats, or None when not collecting."""
    s = getattr(_tls, "active", None)
    if s is None and os.environ.get("LZMA_RS_TPU_STATS"):
        s = _tls.active = DecodeStats()
    return s


@contextlib.contextmanager
def collect():
    """Collect stats for decode calls made within the context."""
    prev = getattr(_tls, "active", None)
    s = DecodeStats()
    _tls.active = s
    try:
        yield s
    finally:
        _tls.active = prev


@contextlib.contextmanager
def launch_timer(stats_obj: Optional[DecodeStats]):
    """Context manager accumulating wall time into launch_seconds."""
    if stats_obj is None:
        yield
        return
    t0 = time.perf_counter()
    try:
        yield
    finally:
        stats_obj.launch_seconds += time.perf_counter() - t0
