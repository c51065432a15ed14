"""Seeded corpus: test files and benchmark archives built inside the repo.

Everything here is a pure function of its arguments (a seed, a size), so
the test suite, ``bench.py`` and ``chip_smoke.py`` decode the same bytes
on every machine without any file outside the checkout.

- :func:`text`, :func:`binary` and :func:`mixed` make seeded plaintext:
  Zipf-distributed words from a seeded vocabulary, structured binary
  records (counters, random walks, runs, a share of random bytes), and an
  interleaving of both.
- :func:`xz_blocks` compresses fixed-size blocks with liblzma (stdlib
  ``lzma``, raw LZMA2) and frames them with this package's own `.xz`
  container writer: the shape of ``xz --block-size=N``.
- :func:`golden` serves the named test files (``foo.txt``,
  ``foo.txt.xz``, ``good-1-lzma2-3.xz``, ...), memoised per process.
"""

from __future__ import annotations

import functools
import lzma as liblzma
from typing import Optional

import numpy as np

_LETTERS = np.frombuffer(b"etaoinshrdlucmfwypvbgkjqxz", dtype=np.uint8)
# English-like letter frequencies (per mille) for the vocabulary
_LETTER_P = np.array(
    [127, 91, 82, 75, 70, 67, 63, 61, 60, 43, 40, 28, 28, 24, 22, 24, 20,
     19, 10, 15, 20, 8, 2, 2, 2, 1], dtype=np.float64,
)
_SEPS = [b" "] * 14 + [b", ", b". ", b".\n", b"\n", b"; ", b" - "]


def _seed_int(seed) -> int:
    if isinstance(seed, str):
        return int.from_bytes(seed.encode(), "little") % (1 << 63)
    return int(seed)


def _rng(seed) -> np.random.Generator:
    """Generator for an int, a string, or a tuple of either."""
    if isinstance(seed, tuple):
        return np.random.default_rng([_seed_int(s) for s in seed])
    return np.random.default_rng(_seed_int(seed))


def _vocab(rng: np.random.Generator, n_words: int):
    lens = np.clip(rng.geometric(0.22, size=n_words), 1, 14)
    letters = rng.choice(
        _LETTERS, size=int(lens.sum()), p=_LETTER_P / _LETTER_P.sum()
    )
    flat = letters.astype(np.uint8)
    offs = np.concatenate([[0], np.cumsum(lens)[:-1]])
    return flat, offs, lens


def text(n: int, seed=0) -> bytes:
    """``n`` bytes of seeded English-like text (Zipf word frequencies)."""
    if n <= 0:
        return b""
    rng = _rng(seed)
    V = 8192
    flat, offs, lens = _vocab(rng, V)
    p = 1.0 / np.arange(1, V + 1) ** 1.07
    p /= p.sum()
    seps = [np.frombuffer(s, np.uint8) for s in _SEPS]
    sep_flat = np.concatenate(seps)
    sep_offs = np.concatenate([[0], np.cumsum([len(s) for s in seps])[:-1]])
    sep_lens = np.array([len(s) for s in seps])
    out = []
    have = 0
    while have < n:
        k = max(1024, (n - have) // 4)
        w = rng.choice(V, size=k, p=p)
        s = rng.integers(0, len(seps), size=k)
        wl = lens[w]
        sl = sep_lens[s]
        piece_len = wl + sl
        total = int(piece_len.sum())
        starts = np.concatenate([[0], np.cumsum(piece_len)[:-1]])
        rel = np.arange(total) - np.repeat(starts, piece_len)
        wid = np.repeat(w, piece_len)
        sid = np.repeat(s, piece_len)
        in_word = rel < np.repeat(wl, piece_len)
        src_word = flat[np.minimum(offs[wid] + rel, len(flat) - 1)]
        src_sep = sep_flat[
            np.clip(sep_offs[sid] + rel - np.repeat(wl, piece_len), 0,
                    len(sep_flat) - 1)
        ]
        out.append(np.where(in_word, src_word, src_sep).astype(np.uint8))
        have += total
    return np.concatenate(out)[:n].tobytes()


def binary(n: int, seed=0) -> bytes:
    """``n`` bytes of seeded binary records: little-endian counters with
    small deltas, a float32 random walk, byte runs and ~10% random bytes."""
    if n <= 0:
        return b""
    rng = _rng(seed)
    parts = []
    have = 0
    while have < n:
        kind = int(rng.integers(0, 10))
        m = int(rng.integers(256, 4096))
        if kind < 4:
            base = int(rng.integers(0, 1 << 30))
            v = base + np.cumsum(rng.integers(0, 16, size=m // 4))
            b = v.astype("<u4").tobytes()
        elif kind < 7:
            v = np.cumsum(rng.normal(0, 1, size=m // 4)).astype("<f4")
            b = v.tobytes()
        elif kind < 9:
            b = bytes([int(rng.integers(0, 256))]) * m
        else:
            b = rng.integers(0, 256, size=m, dtype=np.uint8).tobytes()
        parts.append(b)
        have += len(b)
    return b"".join(parts)[:n]


def mixed(n: int, seed=0) -> bytes:
    """``n`` bytes alternating seeded text (~3/4) and binary (~1/4) runs
    of 4-64 KiB each."""
    rng = _rng(seed)
    parts = []
    have = 0
    i = 0
    while have < n:
        m = int(rng.integers(4 << 10, 64 << 10))
        sub = (int(rng.integers(0, 1 << 62)), i)
        parts.append(binary(m, sub) if rng.random() < 0.25 else text(m, sub))
        have += m
        i += 1
    return b"".join(parts)[:n]


def raw_lzma2(data: bytes, preset: int = 6, dict_size: Optional[int] = None
              ) -> bytes:
    """liblzma raw LZMA2 chunk stream (stdlib ``lzma``, FORMAT_RAW).
    ``dict_size`` shrinks the encoder's window without changing the output
    of inputs no longer than it (a smaller encoder to set up per block)."""
    filt = {"id": liblzma.FILTER_LZMA2, "preset": preset}
    if dict_size:
        filt["dict_size"] = dict_size
    return liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=[filt])


def xz_blocks(data: bytes, block_size: int, check: int = 1,
              preset: int = 6, threads: Optional[int] = None) -> bytes:
    """`.xz` archive of independent ``block_size`` blocks: each block is a
    liblzma raw LZMA2 stream (``preset``), framed by this package's
    container writer with ``check`` (xz check id: 0 none, 1 CRC32,
    4 CRC64, 10 SHA-256)."""
    import os
    from concurrent.futures import ThreadPoolExecutor

    from lzma_rs_tpu.formats import xz as xz_fmt
    from lzma_rs_tpu.utils.cursor import ByteWriter

    blocks = [data[o : o + block_size] for o in range(0, len(data), block_size)]
    dict_size = max(4096, min(block_size, 1 << 26))
    # liblzma releases the GIL while it compresses
    with ThreadPoolExecutor(threads or min(16, os.cpu_count() or 1)) as pool:
        payloads = list(
            pool.map(lambda b: raw_lzma2(b, preset, dict_size), blocks)
        )
    flags = xz_fmt.StreamFlags(check_method=check)
    w = ByteWriter()
    xz_fmt.write_stream_header(w, flags)
    records = [
        xz_fmt.write_block(w, p, b, check_method=check)
        for b, p in zip(blocks, payloads)
    ]
    index_size = xz_fmt.write_index(w, records)
    xz_fmt.write_footer(w, flags, index_size)
    return w.getvalue()


def lzma2_segments(data: bytes, segment_size: int, preset: int = 6) -> bytes:
    """Raw LZMA2 stream of ``segment_size`` dict-reset segments: liblzma
    streams concatenated without their end markers (each starts with a
    dictionary reset, so each is an independent lane)."""
    parts = [
        raw_lzma2(data[o : o + segment_size], preset,
                  max(4096, segment_size))[:-1]
        for o in range(0, len(data), segment_size)
    ]
    return b"".join(parts) + b"\x00"


# --- named test files -------------------------------------------------------

def _xz_of(raw_stream: bytes, content: bytes, check: int = 0) -> bytes:
    """Frame one LZMA2 chunk stream as a single-block `.xz` archive."""
    from lzma_rs_tpu.formats import xz as xz_fmt
    from lzma_rs_tpu.utils.cursor import ByteWriter

    flags = xz_fmt.StreamFlags(check_method=check)
    w = ByteWriter()
    xz_fmt.write_stream_header(w, flags)
    rec = xz_fmt.write_block(w, raw_stream, content, check_method=check)
    xz_fmt.write_footer(w, flags, xz_fmt.write_index(w, [rec]))
    return w.getvalue()


def _good_lzma2(n: int):
    """(content, LZMA2 stream) for ``good-1-lzma2-{n}``: chunk sequences
    from this package's LZMA2 writer covering the reset combinations."""
    from lzma_rs_tpu.encode import lzma2_enc

    a = golden("foo.txt")[:6000]
    b = text(5000, ("good", n))
    r = binary(3000, ("good-bin", n))
    noise = _rng(("noise", n)).integers(0, 256, 1500, dtype=np.uint8).tobytes()
    if n == 1:
        # one segment, several LZMA chunks (state + props reset each)
        content = a
        stream = lzma2_enc.lzma2_compress(a, 6, chunk_size=1024)
    elif n == 2:
        # two dict-reset segments with different props (lc=1 lp=1 pb=1,
        # then lc=0 lp=2 pb=0)
        content = a + b
        s1 = lzma2_enc.lzma2_compress(a, 6, chunk_size=2048,
                                      props=1 + 9 * (1 + 5 * 1))
        s2 = lzma2_enc.lzma2_compress(b, 6, chunk_size=4096,
                                      props=0 + 9 * (2 + 5 * 0))
        stream = s1[:-1] + s2
    elif n == 3:
        # stored chunks inside a segment: LZMA / stored / LZMA
        content = a[:2048] + noise + a[:2048] + r
        stream = lzma2_enc.lzma2_compress(content, 6, chunk_size=1024)
    else:
        # a stored dict-reset chunk, then an LZMA segment, then liblzma's
        # own chunks (state carried across chunks without a reset)
        content = b[:3000] + a + r
        stream = (
            lzma2_enc.lzma2_compress(b[:3000], 0)[:-1]
            + lzma2_enc.lzma2_compress(a, 6, chunk_size=2048)[:-1]
            + raw_lzma2(r, 6, 1 << 16)
        )
    return content, stream


def _lzma_alone(data: bytes, **filt) -> bytes:
    f = {"id": liblzma.FILTER_LZMA1, "preset": 6, **filt}
    return liblzma.compress(data, format=liblzma.FORMAT_ALONE, filters=[f])


_CHECKS = {"crc32": liblzma.CHECK_CRC32, "crc64": liblzma.CHECK_CRC64,
           "sha256": liblzma.CHECK_SHA256}


@functools.lru_cache(maxsize=None)
def golden(name: str) -> bytes:
    """The named test file, built from fixed seeds."""
    if name == "foo.txt":
        return text(170_000, "foo.txt")
    if name == "small.txt":
        return text(420, "small.txt")
    if name == "hello.txt":
        return b"Hello world\n"
    if name == "range-coder-edge-case":
        return mixed(220_000, "range-coder-edge-case")
    if name.startswith("block-check-") and name.endswith(".txt"):
        return text(12_000, name)
    if name.startswith("good-1-lzma2-") and not name.endswith(".xz"):
        return _good_lzma2(int(name.rsplit("-", 1)[1]))[0]
    if name.startswith("good-1-lzma2-") and name.endswith(".xz"):
        n = int(name[len("good-1-lzma2-") : -len(".xz")])
        content, stream = _good_lzma2(n)
        return _xz_of(stream, content)
    if name.startswith("block-check-") and name.endswith(".txt.xz"):
        check = _CHECKS[name[len("block-check-") : -len(".txt.xz")]]
        return liblzma.compress(golden(name[:-3]), format=liblzma.FORMAT_XZ,
                                check=check)
    if name == "empty.txt.xz":
        return liblzma.compress(b"", format=liblzma.FORMAT_XZ)
    if name == "empty.txt.lzma":
        return _lzma_alone(b"")
    if name == "hugedict.txt.lzma":
        # foo.txt under a 2 GiB - 1 dictionary: encode with a small window,
        # then declare the huge one (distances stay within the small one)
        stream = bytearray(_lzma_alone(golden("foo.txt"), dict_size=1 << 20))
        stream[1:5] = (0x7FFFFFFF).to_bytes(4, "little")
        return bytes(stream)
    if name.endswith(".xz"):
        return liblzma.compress(golden(name[:-3]), format=liblzma.FORMAT_XZ)
    if name.endswith(".lzma"):
        return _lzma_alone(golden(name[:-5]))
    raise KeyError(f"no corpus file named {name!r}")
