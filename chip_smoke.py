#!/usr/bin/env python3
"""Smoke run of the decode path on one CUDA GPU (or, with ``--cards 4``,
the lane split over four).

    python chip_smoke.py [--seed N] [--mib 64]
    python chip_smoke.py --cards 4

It builds seeded archives (``lzma_rs_tpu.corpus``): ``--mib`` MiB of
text-and-binary data cut into 8 KiB, 64 KiB, 256 KiB and 1 MiB liblzma
blocks (preset 6) in `.xz` framing, a small ``tpu_profile`` archive from
this package's encoder, a multi-segment raw LZMA2 stream and a sized raw
LZMA stream. Each decodes through the public entry points: first under
the ``auto`` router, which must pick the engine its rule names (the
device for lanes of at most 64 KiB, else the host), then with the device
backend selected, on the CUDA kernel with no fallback, bit-exact against
stdlib ``lzma``. A slice is checked against the executable spec, a
corrupt archive must raise the reference's error, and the device
CRC32/CRC64 against zlib and the native CRC64. Warm times of the CUDA
kernel, the plain XLA lane decoder, the native host engine and stdlib
``lzma`` are printed beside the card's name and power limit, with the
device path split into planning, staging, transfers and the kernel.

With ``--cards 4`` only the multi-card path runs: the same archives with
lanes split over four cards, against the same decode on one card.

The last line is one JSON object: ``{"ok": true, "device": {...}}``. Any
failed phase, or no GPU, exits non-zero without it.
"""

from __future__ import annotations

import argparse
import json
import lzma
import os
import subprocess
import sys
import time
import traceback
import zlib

MiB = 1 << 20


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
        return r.stdout.strip() or f"nvidia-smi: {r.stderr.strip()}"
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable: {e}"


def timed(fn, reps: int = 3):
    """(median seconds, result) over ``reps`` calls, each ending in a
    finished host result."""
    times, out = [], None
    for _ in range(reps):
        t0 = time.perf_counter()
        out = fn()
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2], out


class Smoke:
    def __init__(self, args):
        self.args = args
        self.failures = []
        self.card = ""

    def phase(self, name, fn):
        log(f"--- {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception as e:  # noqa: BLE001 - report every failed phase
            self.failures.append(f"{name}: {type(e).__name__}: {e}")
            traceback.print_exc(file=sys.stdout)
        log(f"    ({time.perf_counter() - t0:.1f} s)")

    def rate(self, label, nbytes, seconds):
        # one entry per distinct card model and power limit
        cards = " | ".join(sorted(set(self.card.splitlines())))
        log(f"    {label}: {seconds * 1e3:.2f} ms, "
            f"{nbytes / MiB / seconds:.1f} MiB/s  [{cards}]")


def build_archives(args):
    from lzma_rs_tpu import corpus
    import lzma_rs_tpu

    data = corpus.mixed(args.mib * MiB, args.seed)
    archives = {}
    for label, block, check in (("8KiB", 8 << 10, 1), ("64KiB", 64 << 10, 4),
                                ("256KiB", 256 << 10, 4), ("1MiB", 1 << 20, 4)):
        t0 = time.perf_counter()
        archives[label] = corpus.xz_blocks(data, block, check=check)
        log(f"    {label} blocks: {len(data)} -> {len(archives[label])} B "
            f"({time.perf_counter() - t0:.1f} s)")
    return data, archives, corpus, lzma_rs_tpu


def run_one_card(args, smoke: Smoke):
    import jax

    from lzma_rs_tpu.ops import segment_decoder as sd
    from lzma_rs_tpu.parallel import runtime
    from lzma_rs_tpu.utils import stats

    state = {}

    def setup():
        t0 = time.perf_counter()
        sd.register("cuda")
        log(f"    CUDA build + register: {time.perf_counter() - t0:.1f} s "
            "(set-up)")
        state["data"], state["archives"], state["corpus"], state["api"] = (
            build_archives(args)
        )

    smoke.phase("set-up: CUDA library and seeded archives", setup)
    if "archives" not in state:
        return
    data, archives, corpus, api = (state["data"], state["archives"],
                                   state["corpus"], state["api"])

    def decode_class(label, arch, want, fn, expect="device"):
        """Decode through a public entry point; ``expect`` is the engine
        the call must end on, with no fallback unless the router sent it
        to the host."""
        with stats.collect() as st:
            t0 = time.perf_counter()
            out = fn(arch)
            first = time.perf_counter() - t0
        if out != want:
            raise AssertionError(f"{label}: output differs from the original")
        if expect == "device":
            ok = (st.engine == "device" and st.platform == "cuda"
                  and not st.fallbacks)
        else:
            ok = (st.engine == expect and len(st.fallbacks) == 1
                  and st.fallbacks[0].startswith("auto->native"))
        if not ok:
            raise AssertionError(
                f"{label}: engine {st.engine!r} on {st.platform!r}, "
                f"fallbacks {st.fallbacks}, expected {expect}"
            )
        log(f"    {label}: {len(arch)} B in, {len(out)} B out, "
            f"{st.lanes} lanes, engine {st.engine} ({st.platform or 'host'})"
            f", fallbacks {st.fallbacks}, first call {first:.2f} s "
            "(incl. compile)")

    def with_backend(fn):
        def call(arch):
            os.environ["LZMA_RS_TPU_BACKEND"] = "device"
            try:
                return fn(arch)
            finally:
                del os.environ["LZMA_RS_TPU_BACKEND"]
        return call

    def main_path():
        for label, arch in archives.items():
            if lzma.decompress(arch) != data:
                raise AssertionError(f"{label}: stdlib lzma disagrees")
            # the router's rule, restated: enough lanes and output, and
            # no lane too long for one card thread
            lanes = [lane for p in runtime.plan_xz(arch)[0]
                     for lane in p.lanes]
            longest = max(lane.out_end[-1] - lane.seg_base for lane in lanes)
            expect = ("device" if len(lanes) >= runtime.AUTO_MIN_LANES
                      and len(data) >= runtime.AUTO_MIN_OUT
                      and longest <= runtime.AUTO_MAX_LANE_OUT else "native")
            decode_class(f".xz {label} (auto)", arch, data,
                         api.xz_decompress, expect)
            if expect != "device":
                decode_class(f".xz {label} (device backend)", arch, data,
                             with_backend(api.xz_decompress))
        small = data[: 8 * MiB]
        tp = api.xz_compress(small, tpu_profile=True, check_method=1)
        if lzma.decompress(tp) != small:
            raise AssertionError("tpu_profile: stdlib lzma disagrees")
        state["tpu_profile"] = tp
        decode_class(".xz tpu_profile", tp, small, api.xz_decompress)
        seg = corpus.lzma2_segments(data[: 16 * MiB], 64 << 10)
        decode_class("lzma2 64KiB segments", seg, data[: 16 * MiB],
                     api.lzma2_decompress)
        raw_in = data[: 4 * MiB]
        raw = bytearray(lzma.compress(raw_in, format=lzma.FORMAT_ALONE))
        raw[5:13] = len(raw_in).to_bytes(8, "little")  # declare the size
        decode_class("raw lzma (known size)", bytes(raw), raw_in,
                     with_backend(api.lzma_decompress))

    smoke.phase("main path: auto router, then the device backend", main_path)

    def spec_slice():
        from lzma_rs_tpu.models.codecs import xz_decode_stream
        from lzma_rs_tpu.utils.cursor import ByteCursor

        piece = data[: 256 << 10]
        for label, block in (("8KiB", 8 << 10), ("64KiB", 64 << 10)):
            arch = corpus.xz_blocks(piece, block, check=1)
            dev = runtime.xz_decode(arch, engine="device")
            spec = xz_decode_stream(ByteCursor(arch))
            if not dev == spec == piece:
                raise AssertionError(f"{label}: device != spec on a slice")
            log(f"    {label} slice of {len(piece)} B: device == spec")

    smoke.phase("spec check on a slice", spec_slice)

    def corrupt():
        from lzma_rs_tpu.models.codecs import xz_decode_stream
        from lzma_rs_tpu.utils.cursor import ByteCursor

        arch = bytearray(corpus.xz_blocks(data[: 512 << 10], 8 << 10))
        arch[len(arch) // 2] ^= 0x55

        def err(fn):
            try:
                fn(bytes(arch))
            except Exception as e:  # noqa: BLE001 - compare the errors
                return f"{type(e).__name__}: {e}"
            return "no error"

        with stats.collect() as st:
            got = err(lambda a: runtime.xz_decode(a, engine="device"))
        want = err(lambda a: xz_decode_stream(ByteCursor(a)))
        log(f"    device: {got}\n    spec:   {want}\n    stats: "
            f"{st.fallbacks}")
        if got != want or got == "no error":
            raise AssertionError("corrupt archive: error differs from spec")

    smoke.phase("corrupt archive raises the reference error", corrupt)

    def timings():
        native = lambda a: runtime.xz_decode(a, engine="native")  # noqa
        device = lambda a: runtime.xz_decode(a, engine="device")  # noqa
        archs = dict(archives, tpu_profile=state.get("tpu_profile"))
        for label, arch in archs.items():
            if arch is None:
                continue
            want = lzma.decompress(arch)
            for name, fn in (("CUDA kernel (device engine)", device),
                             ("native host engine", native),
                             ("stdlib lzma", lzma.decompress)):
                fn(arch)  # warm
                sec, out = timed(lambda: fn(arch))
                if out != want:
                    raise AssertionError(f"{label} {name}: wrong output")
                smoke.rate(f"{label} {name}", len(want), sec)

    smoke.phase("warm wall times to a finished host result", timings)

    def breakdown():
        # the device path of runtime.xz_decode, one part at a time (warm,
        # median of 3): container walk and chunk tables, staging, the
        # input's copy to the card, the kernel on card-resident operands,
        # and the kernel with the output's copy back to the host
        import numpy as np

        archs = dict(archives, tpu_profile=state.get("tpu_profile"))
        for label, arch in archs.items():
            if arch is None:
                continue
            t_plan, plans = timed(lambda: runtime.plan_xz(arch)[0])
            t_stage, stage = timed(lambda: runtime.stage_device(arch, plans))
            fn = sd.jitted(1, stage.out_size, stage.nprobs)
            ops = [jax.device_put(a) for a in (
                stage.chunks[0], stage.lanes[0], stage.prefill[0])]
            t_h2d, inbuf = timed(
                lambda: jax.device_put(stage.inbuf).block_until_ready())
            jax.block_until_ready(fn(inbuf, *ops))  # warm
            t_kernel, (out, err) = timed(
                lambda: jax.block_until_ready(fn(inbuf, *ops)))
            if int(np.asarray(err).any()):
                raise AssertionError(f"{label}: lane error")
            t_d2h, _ = timed(lambda: np.asarray(fn(inbuf, *ops)[0]))
            log(f"    {label}: plan_xz {t_plan * 1e3:.2f} ms, stage "
                f"{t_stage * 1e3:.2f} ms, input to card "
                f"{t_h2d * 1e3:.2f} ms ({stage.inbuf.size} B), kernel "
                f"{t_kernel * 1e3:.2f} ms, kernel + output to host "
                f"{t_d2h * 1e3:.2f} ms ({stage.out_size} B), "
                f"{sum(stage.lane_counts)} lanes  [{smoke.card}]")

    smoke.phase("device path breakdown: plan, stage, transfers, kernel",
                breakdown)

    def xla_lane():
        # the plain XLA lane decoder on a prefix of each class, against
        # the CUDA kernel on the same prefix
        for label, block in (("8KiB", 8 << 10), ("64KiB", 64 << 10)):
            piece = data[: args.xla_mib * MiB]
            arch = corpus.xz_blocks(piece, block, check=1)
            best = None
            default_unroll = runtime.LANE_UNROLL
            for unroll in (1, 4):
                runtime.LANE_UNROLL = unroll
                try:
                    t0 = time.perf_counter()
                    out = runtime.xz_decode(arch, engine="xla")
                    compile_s = time.perf_counter() - t0
                    if out != piece:
                        raise AssertionError(f"xla {label} unroll {unroll}")
                    sec, _ = timed(
                        lambda: runtime.xz_decode(arch, engine="xla"), reps=1)
                finally:
                    runtime.LANE_UNROLL = default_unroll
                log(f"    xla {label} unroll {unroll}: first call "
                    f"{compile_s:.1f} s (incl. compile)")
                smoke.rate(f"{label} prefix {args.xla_mib} MiB XLA lane "
                           f"decoder unroll {unroll}", len(piece), sec)
                best = sec if best is None else min(best, sec)
            sec, _ = timed(lambda: runtime.xz_decode(arch, engine="device"))
            smoke.rate(f"{label} prefix {args.xla_mib} MiB CUDA kernel",
                       len(piece), sec)
            log(f"    {label}: CUDA kernel / best XLA = {sec / best:.4f}")

    if args.xla_mib > 0:
        smoke.phase("CUDA kernel vs the XLA lane decoder", xla_lane)

    def device_crc():
        from lzma_rs_tpu.ops import crc_device
        from lzma_rs_tpu.utils.crc import crc64

        blocks = [data[i * MiB : (i + 2) * MiB] for i in range(0, 16, 2)]
        for name, dev, host in (
            ("crc32", crc_device.crc32_device,
             lambda b: zlib.crc32(b) & 0xFFFFFFFF),
            ("crc64", crc_device.crc64_device, crc64),
        ):
            for b in blocks:
                if dev(b) != host(b):
                    raise AssertionError(f"{name}: device != host")
            t_dev, _ = timed(lambda: [dev(b) for b in blocks])
            t_host, _ = timed(lambda: [host(b) for b in blocks])
            n = sum(map(len, blocks))
            smoke.rate(f"{name} device ({len(blocks)} x 2 MiB)", n, t_dev)
            smoke.rate(f"{name} host", n, t_host)
        os.environ["LZMA_RS_TPU_DEVICE_CRC"] = "1"
        try:
            with stats.collect() as st:
                out = runtime.xz_decode(archives["1MiB"], engine="device")
        finally:
            del os.environ["LZMA_RS_TPU_DEVICE_CRC"]
        if out != data or st.device_crc_bytes != len(data):
            raise AssertionError(
                f"device CRC in xz_decode: {st.device_crc_bytes} B checked")
        log(f"    xz_decode with device CRC64: {st.device_crc_bytes} B "
            f"checked on the card in {st.device_crc_seconds:.3f} s")

    smoke.phase("device CRC32/CRC64 vs zlib and native", device_crc)

    stats_mem = jax.devices()[0].memory_stats() or {}
    log(f"--- peak_bytes_in_use: {stats_mem.get('peak_bytes_in_use')}")


def run_cards(args, smoke: Smoke, n_cards: int):
    import jax
    import jax.numpy as jnp

    from lzma_rs_tpu.ops import segment_decoder as sd
    from lzma_rs_tpu.parallel import runtime
    from lzma_rs_tpu.utils import stats

    if len(jax.devices()) < n_cards:
        smoke.failures.append(f"need {n_cards} cards, "
                              f"found {len(jax.devices())}")
        return
    state = {}

    def setup():
        sd.register("cuda")
        state["data"], state["archives"], _, _ = build_archives(args)

    smoke.phase("set-up: CUDA library and seeded archives", setup)
    if "archives" not in state:
        return
    data, archives = state["data"], state["archives"]

    def sharded():
        for label, arch in archives.items():
            plans = runtime.plan_xz(arch)[0]
            stage = runtime.stage_device(arch, plans, n_cards)
            if stage.n_dev != n_cards:
                raise AssertionError(f"{label}: {stage.n_dev} lanes' worth "
                                     f"of work for {n_cards} cards")
            fn = sd.jitted(n_cards, stage.out_size, stage.nprobs)
            out, err = fn(jnp.asarray(stage.inbuf), stage.chunks,
                          stage.lanes, stage.prefill)
            cards = sorted({s.device.id for s in out.addressable_shards})
            if len(cards) != n_cards or int(jnp.abs(err).sum()):
                raise AssertionError(f"{label}: shards on {cards}, "
                                     "or a lane error")
            results = {}
            for n in (1, n_cards):
                os.environ["LZMA_RS_TPU_DEVICES"] = str(n)
                try:
                    runtime.xz_decode(arch, engine="device")  # warm
                    with stats.collect() as st:
                        sec, out = timed(
                            lambda: runtime.xz_decode(arch, engine="device"))
                finally:
                    del os.environ["LZMA_RS_TPU_DEVICES"]
                if out != data or st.engine != "device" or st.fallbacks:
                    raise AssertionError(f"{label} on {n} card(s): wrong "
                                         f"output or {st.fallbacks}")
                results[n] = sec
                log(f"    {label} on {n} card(s): lanes per card "
                    f"{st.lanes_per_device[:n]}, bit-exact")
                smoke.rate(f"{label} {n} card(s)", len(data), sec)
            log(f"    {label}: output shards on cards {cards}; 1-card / "
                f"{n_cards}-card time = {results[1] / results[n_cards]:.3f}")

    smoke.phase(f"lanes split over {n_cards} cards vs one card", sharded)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mib", type=int, default=64,
                    help="MiB of data per archive class (default 64)")
    ap.add_argument("--xla-mib", type=int, default=2,
                    help="MiB prefix timed on the XLA lane decoder "
                         "(0 skips it)")
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the lane split over this many cards")
    args = ap.parse_args()

    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX found {devs})", file=sys.stderr)
        return 2
    smoke = Smoke(args)
    smoke.card = card_line()
    log(smoke.card)
    log(f"jax {jax.__version__}, devices {devs}, platform "
        f"{devs[0].platform}, kind {devs[0].device_kind}")

    if args.cards > 1:
        run_cards(args, smoke, args.cards)
    else:
        run_one_card(args, smoke)

    if smoke.failures:
        log("FAILED phases:")
        for f in smoke.failures:
            log(f"  {f}")
        return 1
    log(smoke.card)
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
