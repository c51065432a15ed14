#!/usr/bin/env python3
"""Profile a decode: structured stats + optional jax.profiler trace.

Usage:
  python tools/profile_decode.py FILE.xz [--engine native|device|spec|auto]
                                 [--trace DIR]

Prints the per-call structured stats (utils/stats.py) and, with --trace,
writes a TensorBoard-compatible trace (jax.profiler) of the device
engine's launches.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("file")
    ap.add_argument("--engine", default="native",
                    choices=["native", "device", "spec", "auto"])
    ap.add_argument("--trace", default=None)
    args = ap.parse_args()

    data = open(args.file, "rb").read()
    os.environ["LZMA_RS_TPU_BACKEND"] = args.engine

    import lzma_rs_tpu
    from lzma_rs_tpu.utils import stats

    trace_ctx = None
    if args.trace:
        import jax

        jax.profiler.start_trace(args.trace)
        trace_ctx = True

    t0 = time.perf_counter()
    with stats.collect() as s:
        out = lzma_rs_tpu.xz_decompress(data)
    wall = time.perf_counter() - t0

    if trace_ctx:
        import jax

        jax.profiler.stop_trace()
        print(f"trace written to {args.trace}", file=sys.stderr)

    d = s.to_dict()
    d["wall_seconds"] = round(wall, 4)
    d["wall_mb_s"] = round(len(out) / 1e6 / wall, 2)
    print(json.dumps(d, indent=2))


if __name__ == "__main__":
    main()
