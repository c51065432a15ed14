"""Per-level compression-ratio pins (VERDICT round-2 item 7).

The reference's encoder floor is trivial (literal-only LZMA, stored-chunk
LZMA2: the reference's src/encode/dumbencoder.rs, encode/lzma2.rs:4-26);
the native match-finding encoder is this framework's superset track, so
its ratio is pinned against liblzma presets on a fixed corpus — a
regression of more than ~0.3% against the recorded value fails.

Pins record ours/liblzma compressed-size ratios measured on the seeded
corpus. Lower is better.
"""

import lzma as liblzma

import pytest

import lzma_rs_tpu

from conftest import read_ref

# (file, level) -> max allowed ours/liblzma size ratio, pinned on the
# seeded corpus (lzma_rs_tpu.corpus). Measured on it:
#   foo.txt {1: 0.9816, 4: 0.9815, 6: 1.0011, 9: 1.0011},
#   range-coder-edge-case {1: 0.9791, 4: 0.9944, 6: 0.9993, 9: 0.9993}
# Each pin sits ~0.3% above its measured value.
RATIO_PINS = {
    ("foo.txt", 1): 0.985,
    ("foo.txt", 4): 0.985,
    ("foo.txt", 6): 1.0045,
    ("foo.txt", 9): 1.0045,
    ("range-coder-edge-case", 1): 0.982,
    ("range-coder-edge-case", 4): 0.9975,
    ("range-coder-edge-case", 6): 1.0025,
    ("range-coder-edge-case", 9): 1.0025,
}


@pytest.mark.parametrize("name,level", sorted(RATIO_PINS))
def test_ratio_pinned_vs_liblzma(name, level):
    data = read_ref(name)
    ours = lzma_rs_tpu.xz_compress(data, level=level)
    theirs = liblzma.compress(data, preset=level)
    ratio = len(ours) / len(theirs)
    assert ratio <= RATIO_PINS[(name, level)], (
        f"{name} level {level}: ours {len(ours)} vs liblzma {len(theirs)} "
        f"-> ratio {ratio:.4f} exceeds pin {RATIO_PINS[(name, level)]}"
    )
    # the archive must remain decodable by liblzma (interop oracle)
    assert liblzma.decompress(ours) == data


def test_levels_monotone_on_text():
    """Higher levels never compress worse on the text corpus."""
    data = read_ref("foo.txt")
    sizes = [
        len(lzma_rs_tpu.xz_compress(data, level=lvl)) for lvl in (1, 6, 9)
    ]
    assert sizes[0] >= sizes[1] >= sizes[2], sizes


def test_parse_mode_override_greedy(monkeypatch):
    """LZMA_RS_TPU_PARSE_MODE=1 keeps the price-density greedy reachable
    (no preset maps to it since the DP took levels 4-9); its output must
    round-trip and stay liblzma-decodable."""
    monkeypatch.setenv("LZMA_RS_TPU_PARSE_MODE", "1")
    data = read_ref("foo.txt")
    ours = lzma_rs_tpu.xz_compress(data, level=6)
    assert liblzma.decompress(ours) == data
    assert len(ours) < len(data) // 2
