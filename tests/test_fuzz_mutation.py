"""Mutation-based differential fuzzing (reference fuzz tier,
lzma-rs fuzz/fuzz_targets/compare_xz.rs and fuzz/README.md:3-8).

Coverage-guided libFuzzer is out of scope in this environment; this tier
replaces it with *mutation* of valid archives — bit/byte flips,
truncations, insertions, deletions of every corpus archive plus this
framework's own encoder output — cross-checked between engines:

- `.xz`: our decoder vs liblzma — both-fail or both-succeed-equal
  (the reference's compare_xz contract).
- LZMA2 / raw LZMA: native engine vs the executable spec — identical
  success/output, identical failure classification.

Found-divergence ledger: docs/FUZZ_LEDGER.md. Deterministic seeds; the
slow tier runs thousands of cases, the default tier a smoke subset.
"""

import hashlib
import lzma as liblzma
import os
import random
import time

import pytest

import lzma_rs_tpu
from lzma_rs_tpu.models.codecs import Lzma2Decoder, xz_decode_stream
from lzma_rs_tpu.native import loader
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import LzmaRsError as Error

from conftest import read_ref

# Divergences vs liblzma that are understood and accepted (ledger):
# - none currently.
ALLOWED_XZ_DIVERGENCES = ()


def _mutate_once(rng: random.Random, b: bytearray) -> None:
    if not b:
        return
    kind = rng.randrange(5)
    pos = rng.randrange(len(b))
    if kind == 0:  # bit flip
        b[pos] ^= 1 << rng.randrange(8)
    elif kind == 1:  # byte set
        b[pos] = rng.randrange(256)
    elif kind == 2:  # truncate
        del b[pos:]
    elif kind == 3:  # insert
        b[pos:pos] = bytes([rng.randrange(256)])
    else:  # delete
        del b[pos]


def _mutations(rng: random.Random, data: bytes, n: int, stacked: bool = False):
    """Yield n mutated variants of data (deterministic given rng).

    ``stacked`` applies 1-4 mutations per case (deeper tier): single
    mutations mostly probe header/CRC validation, stacks reach decode
    states that one flip cannot."""
    for _ in range(n):
        b = bytearray(data)
        for _ in range(rng.randrange(1, 5) if stacked else 1):
            _mutate_once(rng, b)
        yield bytes(b)


def _splices(rng: random.Random, seeds, n: int):
    """Cross-seed splices: prefix of one archive + suffix of another — the
    classic libFuzzer crossover, good at confusing framing/index logic."""
    for _ in range(n):
        a, b = rng.choice(seeds), rng.choice(seeds)
        if not a or not b:
            continue
        cut_a = rng.randrange(len(a))
        cut_b = rng.randrange(len(b))
        yield a[:cut_a] + b[cut_b:]


# Accumulated regression corpus: every case that ever produced a
# divergence (before triage) is saved here and replayed as extra seeds on
# later runs, libFuzzer-corpus style.
FUZZ_CORPUS_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench", "fuzz",
)


def _corpus_cases():
    try:
        names = sorted(os.listdir(FUZZ_CORPUS_DIR))
    except OSError:
        return []
    out = []
    for nm in names:
        if nm.endswith(".bin"):
            with open(os.path.join(FUZZ_CORPUS_DIR, nm), "rb") as f:
                out.append(f.read())
    return out


def _save_to_corpus(case: bytes, tag: str) -> str:
    os.makedirs(FUZZ_CORPUS_DIR, exist_ok=True)
    h = hashlib.sha256(case).hexdigest()[:16]
    path = os.path.join(FUZZ_CORPUS_DIR, f"{tag}-{h}.bin")
    with open(path, "wb") as f:
        f.write(case)
    return path


def _ours_xz(data: bytes):
    try:
        return (True, lzma_rs_tpu.xz_decompress(data))
    except Error as e:
        return (False, type(e).__name__)
    except OverflowError:
        # 64-bit varint fields can exceed host sizes; classified failure
        return (False, "OverflowError")


def _liblzma_xz(data: bytes):
    try:
        out = liblzma.decompress(data, format=liblzma.FORMAT_XZ)
        return (True, out)
    except Exception as e:
        return (False, type(e).__name__)


def _xz_agree(case: bytes) -> str:
    """Returns '' when engines agree, else a description."""
    ok_a, a = _ours_xz(case)
    ok_b, b = _liblzma_xz(case)
    if ok_a and ok_b:
        if a != b:
            return f"output mismatch: ours {len(a)}B vs liblzma {len(b)}B"
        return ""
    if ok_a and not ok_b:
        # Known reference divergence (ledger entry 2026-08-20): lzma-rs
        # terminates a known-size LZMA chunk the moment the output is
        # complete and never validates the trailing compressed bytes
        # (they sit prefetched in the range coder's `code` register,
        # lzma-rs src/decode/lzma.rs:442-455); liblzma validates
        # them. Accepting such inputs is reference parity — allowed iff
        # the reference-parity spec decoder also accepts AND produces
        # the same bytes.
        try:
            spec_out = xz_decode_stream(ByteCursor(case))
        except (Error, OverflowError):
            return f"we accepted ({len(a)}B out), liblzma AND spec rejected"
        if spec_out != a:
            return "dispatch/spec output mismatch on liblzma-rejected case"
        return ""
    # ok_b and not ok_a: liblzma is more lenient in known ways (e.g. it
    # streams concatenated archives); we match the REFERENCE, which is
    # stricter. Cross-check against the reference-parity spec decoder:
    # if the spec decoder also rejects, we're consistent.
    if ok_b and not ok_a:
        try:
            xz_decode_stream(ByteCursor(case))
            return f"spec accepted but dispatch path rejected ({a})"
        except Error:
            return ""  # consistently strict (reference semantics)
        except OverflowError:
            return ""
    return ""


def _xz_seed_cases():
    seeds = [
        read_ref("foo.txt.xz"),
        read_ref("good-1-lzma2-1.xz"),
        read_ref("good-1-lzma2-4.xz"),
        read_ref("block-check-crc32.txt.xz"),
        lzma_rs_tpu.xz_compress(read_ref("foo.txt")[:20000], check_method=4),
        lzma_rs_tpu.xz_compress(
            read_ref("foo.txt")[:20000], tpu_profile=True, check_method=1
        ),
        lzma_rs_tpu.xz_compress(read_ref("small.txt") * 20, level=0),
    ]
    return seeds


def _run_xz_mutations(cases_per_seed: int, rng=None, save=False,
                      stacked=False):
    rng = rng or random.Random(0xF00D)
    failures = []
    for si, seed in enumerate(_xz_seed_cases()):
        for case in _mutations(rng, seed, cases_per_seed, stacked=stacked):
            why = _xz_agree(case)
            if why and why not in ALLOWED_XZ_DIVERGENCES:
                loc = _save_to_corpus(case, "xz") if save else f"seed {si}"
                failures.append(f"{loc}: {why}")
                if len(failures) > 5:
                    return failures
    return failures


def _native_vs_spec_lzma2(case: bytes) -> str:
    lib = loader.load()
    if lib is None:
        pytest.skip("native library unavailable")
    try:
        a = (True, lib.lzma2_decode(case))
    except Exception as e:
        a = (False, str(e))
    try:
        b = (True, Lzma2Decoder().decompress(ByteCursor(case)))
    except Error as e:
        b = (False, str(e))
    if a[0] != b[0]:
        return f"native ok={a[0]} spec ok={b[0]} ({a[1]!r:.60} vs {b[1]!r:.60})"
    if a[0] and a[1] != b[1]:
        return "native/spec output mismatch"
    if not a[0] and a[1] != b[1]:
        return f"error-string mismatch: {a[1]!r} vs {b[1]!r}"
    return ""


def _run_lzma2_mutations(cases_per_seed: int, rng=None):
    rng = rng or random.Random(0xBEEF)
    text = read_ref("foo.txt")[:8000]
    seeds = [
        lzma_rs_tpu.lzma2_compress(text, level=6),
        lzma_rs_tpu.lzma2_compress(text, level=0),
        lzma_rs_tpu.lzma2_compress(text, level=6, dist_cap=512,
                                   props=0 + 9 * (0 + 5 * 2)),
    ]
    failures = []
    for si, seed in enumerate(seeds):
        for case in _mutations(rng, seed, cases_per_seed):
            why = _native_vs_spec_lzma2(case)
            if why:
                failures.append(f"seed {si}: {why}")
                if len(failures) > 5:
                    return failures
    return failures


class TestMutationSmoke:
    def test_xz_differential(self):
        failures = _run_xz_mutations(cases_per_seed=30)
        assert not failures, failures

    def test_lzma2_native_vs_spec(self):
        failures = _run_lzma2_mutations(cases_per_seed=12)
        assert not failures, failures


class TestCorpusReplay:
    def test_accumulated_corpus_still_agrees(self):
        """Replay every saved divergence case (regression corpus) through
        the differential check — the nightly tier's findings must stay
        triaged (either fixed or ledgered in ALLOWED_XZ_DIVERGENCES)."""
        cases = _corpus_cases()
        failures = []
        for case in cases:
            why = _xz_agree(case)
            if why and why not in ALLOWED_XZ_DIVERGENCES:
                failures.append(why)
        assert not failures, failures


@pytest.mark.slow
class TestMutationDeep:
    def test_xz_differential_deep(self):
        failures = _run_xz_mutations(cases_per_seed=400)
        assert not failures, failures

    def test_lzma2_native_vs_spec_deep(self):
        failures = _run_lzma2_mutations(cases_per_seed=150)
        assert not failures, failures


@pytest.mark.slow
class TestMutationNightly:
    """Time-budgeted randomized tier (nightly: LZMA_RS_TPU_FUZZ_MINUTES,
    default 3). Unlike the deterministic smoke/deep tiers, the RNG seed is
    drawn fresh per run (printed for reproduction), mutations stack, and
    cross-seed splices are mixed in. Divergent cases are written to
    .bench/fuzz/ so they replay as regression seeds in every future run
    (TestCorpusReplay)."""

    def test_xz_differential_nightly(self, capsys):
        minutes = float(os.environ.get("LZMA_RS_TPU_FUZZ_MINUTES", "3"))
        seed = int(os.environ.get(
            "LZMA_RS_TPU_FUZZ_SEED", str(random.SystemRandom().randrange(1 << 48))
        ))
        print(f"nightly fuzz seed: {seed} (LZMA_RS_TPU_FUZZ_SEED to repro)")
        rng = random.Random(seed)
        deadline = time.monotonic() + minutes * 60
        seeds = _xz_seed_cases() + _corpus_cases()
        failures = []
        rounds = cases = 0
        while time.monotonic() < deadline and len(failures) <= 5:
            rounds += 1
            for si, s in enumerate(seeds):
                for case in _mutations(rng, s, 40, stacked=True):
                    cases += 1
                    why = _xz_agree(case)
                    if why and why not in ALLOWED_XZ_DIVERGENCES:
                        failures.append(f"{_save_to_corpus(case, 'xz')}: {why}")
                if time.monotonic() >= deadline:
                    break
            for case in _splices(rng, seeds, 40):
                cases += 1
                why = _xz_agree(case)
                if why and why not in ALLOWED_XZ_DIVERGENCES:
                    failures.append(f"{_save_to_corpus(case, 'xz')}: {why}")
        print(f"nightly fuzz: {cases} cases in {rounds} rounds")
        assert not failures, (
            f"seed {seed}: divergences saved to corpus: {failures}"
        )

    def test_lzma2_native_vs_spec_nightly(self):
        minutes = float(os.environ.get("LZMA_RS_TPU_FUZZ_MINUTES", "3")) / 3
        seed = random.SystemRandom().randrange(1 << 48)
        rng = random.Random(seed)
        deadline = time.monotonic() + minutes * 60
        failures = []
        while time.monotonic() < deadline and not failures:
            failures = _run_lzma2_mutations(cases_per_seed=50, rng=rng)
        assert not failures, f"seed {seed}: {failures}"


# --- coverage-guided nightly tier (round 4) ---------------------------
#
# The reference fuzzes with instrumentation-guided libFuzzer
# (lzma-rs fuzz/README.md:3-8); the tiers above explore blindly.
# This tier closes most of the gap: nightly mutants run the pure-Python
# spec decoder under sys.monitoring line coverage restricted to the
# decode modules, and any mutant that reaches a new arc is kept as a
# corpus seed (.bench/fuzz/cov-*.bin, replayed forever by
# TestCorpusReplay). The cumulative arc set persists in
# .bench/fuzz/coverage_arcs.json so exploration compounds across runs
# — a poor-man's libFuzzer corpus distiller.

import json as _json
import sys as _sys

_COV_MODULES = (
    "models/spec.py", "models/codecs.py", "formats/xz.py",
    "formats/lzma2.py", "formats/lzma_header.py", "utils/cursor.py",
)
_ARCS_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".bench", "fuzz", "coverage_arcs.json",
)


def _structure_seeds():
    """Structure-aware seeds (VERDICT r4 item 3): archives whose shapes
    hit the decode paths plain mutation almost never constructs — the
    classes that actually bit the kernel in rounds 4-5:

    - dist == RING (2048) copies with every byte-in-word phase (the
      round-4 ring-aliasing regression shape);
    - long word-aligned matches at dist % 4 == 0 and RLE dists 1/2/3
      (the m8 8-byte copy path and copy-end chains C/D);
    - literal-run/match alternations at match-length edges 8/9 (chain
      ladder firing boundaries);
    - every check method including SHA-256 (the documented intentional
      superset, formats/xz.py).
    """
    seeds = []
    # ring-edge pages, phase-shifted
    page = bytes((i * 73 + 5) & 0xFF for i in range(2048))
    for shift in (0, 1, 3):
        seeds.append(lzma_rs_tpu.xz_compress(
            (b"x" * shift + page * 5)[:9000], tpu_profile=True,
            check_method=1,
        ))
    # aligned long matches + RLE runs + length edges
    p64 = bytes((i * 29 + 7) & 0xFF for i in range(64))
    chunks = [p64 * 40]
    for n in (8, 9, 16, 33):
        chunks.append(bytes(range(1, 13)) * 4)
        chunks.append(b"." * n)
    chunks.append(b"\x00" * 900 + b"ab" * 400 + b"xyz" * 130)
    seeds.append(lzma_rs_tpu.xz_compress(
        b"".join(chunks), tpu_profile=True, check_method=1
    ))
    # check-method corners (0 none, 1 crc32, 4 crc64, 10 sha256)
    body = read_ref("foo.txt")[:4000]
    for cm in (0, 4, 10):
        seeds.append(lzma_rs_tpu.xz_compress(body, check_method=cm))
    return seeds


class _ArcTracker:
    """Edge-granularity coverage over the spec decode modules via
    sys.monitoring (PEP 669): LINE events plus BRANCH source->dest arcs,
    so a revisited line via a new branch still counts as exploration
    (the round-4 line-only tier saturated after one run)."""

    def __init__(self):
        self.current = set()
        mon = _sys.monitoring
        # COVERAGE_ID may already be claimed (tools/coverage_report.py
        # runs the suite under its own LINE tracer): fall back to any
        # free tool id so coverage and the fuzz tier compose.
        self.TOOL = None
        for tid in (mon.COVERAGE_ID, 3, 4, 5):
            try:
                mon.use_tool_id(tid, "lzma_rs_tpu-fuzz-cov")
                self.TOOL = tid
                break
            except ValueError:
                continue
        if self.TOOL is None:
            raise RuntimeError("no free sys.monitoring tool id")
        mon.register_callback(
            self.TOOL, mon.events.LINE, self._on_line
        )
        mon.register_callback(
            self.TOOL, mon.events.BRANCH, self._on_branch
        )
        self._events = mon.events.LINE | mon.events.BRANCH

    def _on_line(self, code, line):
        fn = code.co_filename
        for suffix in _COV_MODULES:
            if fn.endswith(suffix):
                self.current.add(f"{suffix}:{line}")
                return
        return _sys.monitoring.DISABLE

    def _on_branch(self, code, src, dst):
        fn = code.co_filename
        for suffix in _COV_MODULES:
            if fn.endswith(suffix):
                self.current.add(f"{suffix}:b{src}>{dst}")
                return
        return _sys.monitoring.DISABLE

    def run(self, fn):
        """Run fn() with tracing; returns the arc set it touched."""
        self.current = set()
        mon = _sys.monitoring
        mon.set_events(self.TOOL, self._events)
        # per-code-object DISABLE sticks until events are restarted
        mon.restart_events()
        try:
            fn()
        except Exception:
            pass  # error paths are exactly the arcs worth finding
        finally:
            mon.set_events(self.TOOL, 0)
        return self.current

    def close(self):
        _sys.monitoring.free_tool_id(self.TOOL)


def _spec_xz_decode(case: bytes):
    xz_decode_stream(ByteCursor(case))


@pytest.mark.slow
class TestCoverageGuidedNightly:
    def test_xz_spec_coverage_guided(self):
        minutes = float(os.environ.get("LZMA_RS_TPU_FUZZ_MINUTES", "3")) / 3
        seed = int(os.environ.get(
            "LZMA_RS_TPU_FUZZ_SEED",
            str(random.SystemRandom().randrange(1 << 48)),
        ))
        print(f"coverage fuzz seed: {seed}")
        rng = random.Random(seed)

        known = set()
        if os.path.exists(_ARCS_PATH):
            known = set(_json.load(open(_ARCS_PATH)))
        start_arcs = len(known)

        tracker = _ArcTracker()
        try:
            seeds = (
                _xz_seed_cases() + _structure_seeds() + _corpus_cases()
            )
            # warm: replay seeds so only genuinely new arcs count
            for s in seeds:
                known |= tracker.run(lambda: _spec_xz_decode(s))

            deadline = time.monotonic() + minutes * 60
            kept = cases = 0
            failures = []
            while time.monotonic() < deadline and len(failures) <= 5:
                for s in seeds:
                    for case in _mutations(rng, s, 20, stacked=True):
                        cases += 1
                        arcs = tracker.run(
                            lambda: _spec_xz_decode(case)
                        )
                        new = arcs - known
                        if new:
                            known |= new
                            kept += 1
                            path = _save_to_corpus(case, "cov")
                            # new-arc cases must still satisfy the
                            # differential contract
                            why = _xz_agree(case)
                            if why and why not in ALLOWED_XZ_DIVERGENCES:
                                failures.append(f"{path}: {why}")
                    if time.monotonic() >= deadline:
                        break
        finally:
            tracker.close()

        os.makedirs(os.path.dirname(_ARCS_PATH), exist_ok=True)
        with open(_ARCS_PATH, "w") as f:
            _json.dump(sorted(known), f)
        print(
            f"coverage fuzz: {cases} cases, arcs {start_arcs} -> "
            f"{len(known)} (+{kept} corpus seeds)"
        )
        assert not failures, f"seed {seed}: {failures}"


# --- native-engine edge coverage (round 5) ----------------------------
#
# The production host path is the C++ engine; round 4's coverage tier
# instrumented only the Python spec, so the native decoder ran fuzz
# inputs blind (VERDICT r4 missing #1). This tier runs mutants against
# the -fsanitize-coverage=trace-pc build (native/cov_runtime.cpp) and
# keeps arc-novel cases, persisting the cumulative native arc set keyed
# by the instrumented build's hash (arc ids are code offsets — valid
# only within one build).

_NARCS_PATH = os.path.join(
    os.path.dirname(_ARCS_PATH), "native_arcs.json"
)


def _native_lzma2_seeds():
    text = read_ref("foo.txt")[:8000]
    seeds = [
        lzma_rs_tpu.lzma2_compress(text, level=6),
        lzma_rs_tpu.lzma2_compress(text, level=0),
        lzma_rs_tpu.lzma2_compress(text, level=6, dist_cap=512,
                                   props=0 + 9 * (0 + 5 * 2)),
        liblzma.compress(text, format=liblzma.FORMAT_RAW,
                         filters=[{"id": liblzma.FILTER_LZMA2,
                                   "preset": 6}]),
    ]
    # structure shapes: ring-distance pages, aligned long matches, RLE
    page = bytes((i * 73 + 5) & 0xFF for i in range(2048))
    p64 = bytes((i * 29 + 7) & 0xFF for i in range(64))
    for body in (
        (page * 4)[:7000],
        p64 * 100 + b"\x00" * 800 + b"ab" * 300,
    ):
        seeds.append(lzma_rs_tpu.lzma2_compress(body, level=6))
    return seeds


@pytest.mark.slow
class TestNativeCoverageGuidedNightly:
    def test_native_edge_coverage_guided(self):
        cov = loader.load_instrumented()
        if cov is None:
            pytest.skip("instrumented native build unavailable")
        import ctypes

        lib = cov._lib

        def decode(case: bytes):
            out = ctypes.c_void_p()
            n = ctypes.c_size_t()
            consumed = ctypes.c_size_t()
            err = ctypes.create_string_buffer(256)
            lib.lrt_lzma2_decode(
                bytes(case), len(case), 0, ctypes.byref(out),
                ctypes.byref(n), ctypes.byref(consumed), err,
            )
            if out.value:
                lib.lrt_free(out)

        minutes = float(os.environ.get("LZMA_RS_TPU_FUZZ_MINUTES", "3")) / 3
        seed = int(os.environ.get(
            "LZMA_RS_TPU_FUZZ_SEED",
            str(random.SystemRandom().randrange(1 << 48)),
        ))
        print(f"native coverage fuzz seed: {seed}")
        rng = random.Random(seed)

        build = cov.build_id()
        known = set()
        if os.path.exists(_NARCS_PATH):
            saved = _json.load(open(_NARCS_PATH))
            if saved.get("build") == build:
                known = set(saved["arcs"])
        start_arcs = len(known)

        seeds = _native_lzma2_seeds()
        for s in seeds:
            known |= cov.cov_run(lambda: decode(s))

        deadline = time.monotonic() + minutes * 60
        kept = cases = 0
        failures = []
        while time.monotonic() < deadline and len(failures) <= 5:
            for s in seeds:
                for case in _mutations(rng, s, 20, stacked=True):
                    cases += 1
                    arcs = cov.cov_run(lambda: decode(case))
                    new = arcs - known
                    if new:
                        known |= new
                        kept += 1
                        path = _save_to_corpus(case, "ncov")
                        # arc-novel cases must still satisfy the
                        # native-vs-spec differential contract
                        why = _native_vs_spec_lzma2(case)
                        if why:
                            failures.append(f"{path}: {why}")
                if time.monotonic() >= deadline:
                    break

        os.makedirs(os.path.dirname(_NARCS_PATH), exist_ok=True)
        with open(_NARCS_PATH, "w") as f:
            _json.dump({"build": build, "arcs": sorted(known)}, f)
        print(
            f"native coverage fuzz: {cases} cases, arcs {start_arcs} -> "
            f"{len(known)} (+{kept} corpus seeds)"
        )
        assert not failures, f"seed {seed}: {failures}"
