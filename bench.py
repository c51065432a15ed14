#!/usr/bin/env python3
"""Host benchmark: end-to-end `.xz` decode throughput of ``xz_decompress``.

Prints ONE JSON line:
  {"metric": "xz_decode_throughput", "value": <MB/s>, "unit": "MB/s",
   "vs_baseline": <ratio>, "engine": <engine>}

Baseline: single-threaded liblzma (stdlib ``lzma``) in the same process on
the same archive. Corpus: ``LZMA_RS_TPU_BENCH_MB`` MB (default 60) of
seeded text-and-binary data (``lzma_rs_tpu.corpus``) in 1 MiB liblzma
blocks, the shape of ``xz -6 -T0 --block-size=1MiB``. Bit-exactness is
asserted before timing; details go to stderr.

This measures whatever engine ``auto`` picks on this host; the device
engine's numbers on the GPU come from ``chip_smoke.py`` until the
benchmark covers it (ROADMAP S1).
"""

import json
import lzma
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
TARGET_MB = int(os.environ.get("LZMA_RS_TPU_BENCH_MB", "60"))


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def time_best(fn, reps=5):
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        best = min(best, time.perf_counter() - t0)
    return best


def main() -> None:
    import lzma_rs_tpu
    from lzma_rs_tpu import corpus
    from lzma_rs_tpu.utils import stats

    expected = corpus.mixed(TARGET_MB * 1_000_000, 0)
    cx = corpus.xz_blocks(expected, 1 << 20, check=4)
    n_mb = len(expected) / 1e6
    log(f"corpus: {n_mb:.1f} MB -> {len(cx) / 1e6:.1f} MB xz (1 MiB blocks)")

    with stats.collect() as st:
        out = lzma_rs_tpu.xz_decompress(cx)
    assert out == expected, "decode is not bit-exact — refusing to benchmark"
    del out

    ours = time_best(lambda: lzma_rs_tpu.xz_decompress(cx))
    ours_mbs = n_mb / ours
    log(f"lzma_rs_tpu xz_decompress ({st.engine}): {ours_mbs:.1f} MB/s "
        f"({ours:.2f}s)")
    base = time_best(lambda: lzma.decompress(cx))
    base_mbs = n_mb / base
    log(f"baseline stdlib lzma (liblzma, 1 thread): {base_mbs:.1f} MB/s "
        f"({base:.2f}s)")
    print(json.dumps({
        "metric": "xz_decode_throughput",
        "value": round(ours_mbs, 1),
        "unit": "MB/s",
        "vs_baseline": round(ours_mbs / base_mbs, 3),
        "engine": st.engine,
    }))


if __name__ == "__main__":
    main()
