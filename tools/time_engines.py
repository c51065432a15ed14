#!/usr/bin/env python3
"""Warm wall time of decode engines on seeded `.xz` archive classes.

    PYTHONPATH=. python tools/time_engines.py [--engines native,device]
        [--blocks-kib 64,1024] [--mib 64] [--reps 5] [--seed 0]

Builds ``--mib`` MiB of seeded text-and-binary data
(``lzma_rs_tpu.corpus.mixed``), cuts it into liblzma blocks of each
``--blocks-kib`` size (the ``chip_smoke.py`` archive classes), decodes
each archive with ``runtime.xz_decode`` on every engine, checks the
output, and prints the median and minimum of ``--reps`` warm calls.

The package comes from ``PYTHONPATH``, so the same command times another
checkout, such as a parent commit unpacked beside this one: run parent,
change, change, parent in one session to compare them.
"""

import argparse
import time


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--engines", default="native")
    ap.add_argument("--blocks-kib", default="64,1024")
    ap.add_argument("--mib", type=int, default=64)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    import lzma_rs_tpu
    from lzma_rs_tpu import corpus
    from lzma_rs_tpu.parallel import runtime

    data = corpus.mixed(args.mib << 20, args.seed)
    for kib in (int(k) for k in args.blocks_kib.split(",")):
        arch = corpus.xz_blocks(data, kib << 10, check=4)
        for engine in args.engines.split(","):
            if runtime.xz_decode(arch, engine=engine) != data:  # warm
                raise SystemExit(f"{kib} KiB {engine}: wrong output")
            times = []
            for _ in range(args.reps):
                t0 = time.perf_counter()
                runtime.xz_decode(arch, engine=engine)
                times.append(time.perf_counter() - t0)
            times.sort()
            print(f"{lzma_rs_tpu.__file__}: {kib} KiB blocks, {engine}: "
                  f"median {times[len(times) // 2] * 1e3:.2f} ms, "
                  f"min {times[0] * 1e3:.2f} ms ({args.reps} warm calls, "
                  f"{len(data)} B out)", flush=True)


if __name__ == "__main__":
    main()
