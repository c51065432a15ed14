#!/usr/bin/env python3
"""Host-scaling harness for the multi-process decode (``multihost.py``).

Runs the multi-host block-parallel decode with 1, 2 and 4 JAX processes on
this machine and reports per-host throughput and scaling efficiency. The
workers force the CPU backend (``JAX_PLATFORMS=cpu``; gloo over loopback
stands in for the network): several processes must never open one GPU,
since each JAX process reserves most of a card's memory.

Note: on a single machine the N processes share the physical cores, so
wall-clock "scaling" here validates correctness+overhead of the protocol,
not added compute; per-host efficiency is the meaningful number.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

WORKER = r"""
import os, sys, time
# CPU only: one process per card at most, and these are several
os.environ["JAX_PLATFORMS"] = "cpu"
proc, nproc, path = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
import jax
if nproc > 1:
    jax.distributed.initialize(
        coordinator_address="127.0.0.1:9733", num_processes=nproc,
        process_id=proc)
sys.path.insert(0, %(here)r)
from lzma_rs_tpu.parallel import multihost
from lzma_rs_tpu.utils import stats as stats_mod
data = open(path, "rb").read()
# warm
out = multihost.xz_decode_multihost(data)
with stats_mod.collect() as st:
    t0 = time.time()
    out = multihost.xz_decode_multihost(data)
    dt = time.time() - t0
print(f"RESULT {proc} {len(out)} {dt:.4f} "
      f"{st.multihost_decode_seconds:.4f} "
      f"{st.multihost_gather_wait_seconds:.4f}", flush=True)
"""


def run(nproc: int, path: str):
    script = WORKER % {"here": HERE}
    with tempfile.NamedTemporaryFile("w", suffix=".py", delete=False) as f:
        f.write(script)
        spath = f.name
    procs = [
        subprocess.Popen(
            [sys.executable, spath, str(i), str(nproc), path],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )
        for i in range(nproc)
    ]
    times, decodes, waits = [], [], []
    for p in procs:
        out, _ = p.communicate(timeout=600)
        for line in out.splitlines():
            if line.startswith("RESULT"):
                parts = line.split()
                times.append(float(parts[3]))
                decodes.append(float(parts[4]))
                waits.append(float(parts[5]))
    assert len(times) == nproc, f"missing results: {times}"
    return max(times), max(decodes) if decodes else 0.0, \
        max(waits) if waits else 0.0


def main():
    sys.path.insert(0, HERE)
    import lzma_rs_tpu

    from lzma_rs_tpu import corpus

    data = corpus.mixed(32 << 20, 0)
    c = lzma_rs_tpu.xz_compress(data, block_size=1 << 21, check_method=4)
    with tempfile.NamedTemporaryFile(delete=False, suffix=".xz") as f:
        f.write(c)
        path = f.name

    n_mb = len(data) / 1e6
    curve, dec, wait = {}, {}, {}
    for n in (1, 2, 4):
        best = (1e18, 0, 0)
        for _ in range(2):  # best-of-2: noisy shared-core machine
            r = run(n, path)
            if r[0] < best[0]:
                best = r
        curve[n], dec[n], wait[n] = best
    if not dec[1]:
        dec[1] = curve[1]  # single-proc short-circuits multihost stats
    result = {
        "corpus_mb": round(n_mb, 1),
        "note": (
            "single machine, CPU loopback: N processes SHARE the "
            "physical cores, so added compute is impossible by "
            "construction — decode_s measures the per-host compute "
            "share (ideal: t1/N per host), gather_wait_s the residual "
            "communication NOT hidden behind decode (gloo loopback is "
            "~10 MB/s; a real network moves far more)"
        ),
        "wall_s": {str(n): round(t, 3) for n, t in curve.items()},
        "decode_s": {str(n): round(t, 3) for n, t in dec.items()},
        "gather_wait_s": {str(n): round(t, 3) for n, t in wait.items()},
        # shared cores: total core-seconds are constant, so ideal decode
        # wall time is EQUAL across N (each host: 1/N the data on 1/N
        # the cores) — efficiency = dec_1 / dec_N
        "decode_scaling_efficiency": {
            str(n): round(dec[1] / dec[n], 3) if dec[n] else None
            for n in curve
        },
        "throughput_mb_s": {
            str(n): round(n_mb / t, 1) for n, t in curve.items()
        },
    }
    print(json.dumps(result))
    out_path = os.path.join(HERE, "benches", "SCALING.json")
    with open(out_path, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {out_path}")


if __name__ == "__main__":
    main()
