#!/usr/bin/env python3
"""Microbenchmarks mirroring the reference's nightly bench set
(lzma-rs ``benches/lzma.rs:62-129``):

  compress_empty / decompress_after_compress_empty
  compress_hello / decompress_after_compress_hello
  compress_65536 / decompress_after_compress_65536
  decompress_big_file (foo.txt.lzma from the seeded corpus)
  decompress_stream_big_file (push-style Stream)
  decompress_huge_dict (35-byte stream, dict 0x7F7F7F7F)

Usage: python benches/microbench.py [--json]
"""

import json
import os
import sys
import time

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, HERE)
import lzma_rs_tpu
from lzma_rs_tpu import corpus
from lzma_rs_tpu.stream import Stream

HUGE_DICT_STREAM = bytes.fromhex(
    "5d7f7f7f7fffffffffffffffff00241949986f1019c6d731eb3650b29848fffea5b000"
)


def bench(name, fn, min_time=0.5):
    # warm up
    fn()
    n, t = 0, 0.0
    t0 = time.perf_counter()
    while t < min_time:
        fn()
        n += 1
        t = time.perf_counter() - t0
    return name, t / n


def main():
    foo_lzma = corpus.golden("foo.txt.lzma")

    empty_c = lzma_rs_tpu.lzma_compress(b"")
    hello_c = lzma_rs_tpu.lzma_compress(b"Hello world")
    zeros64k = bytes(0x10000)
    zeros64k_c = lzma_rs_tpu.lzma_compress(zeros64k)

    def stream_decode():
        s = Stream()
        for i in range(0, len(foo_lzma), 4096):
            s.write(foo_lzma[i : i + 4096])
        return s.finish()

    results = [
        bench("compress_empty", lambda: lzma_rs_tpu.lzma_compress(b"")),
        bench(
            "decompress_after_compress_empty",
            lambda: lzma_rs_tpu.lzma_decompress(empty_c),
        ),
        bench("compress_hello", lambda: lzma_rs_tpu.lzma_compress(b"Hello world")),
        bench(
            "decompress_after_compress_hello",
            lambda: lzma_rs_tpu.lzma_decompress(hello_c),
        ),
        bench("compress_65536", lambda: lzma_rs_tpu.lzma_compress(zeros64k)),
        bench(
            "decompress_after_compress_65536",
            lambda: lzma_rs_tpu.lzma_decompress(zeros64k_c),
        ),
        bench("decompress_big_file", lambda: lzma_rs_tpu.lzma_decompress(foo_lzma)),
        bench("decompress_stream_big_file", stream_decode),
        bench(
            "decompress_huge_dict",
            lambda: lzma_rs_tpu.lzma_decompress(HUGE_DICT_STREAM),
        ),
    ]
    if "--json" in sys.argv:
        print(json.dumps({name: sec for name, sec in results}))
    else:
        for name, sec in results:
            unit = "us" if sec < 1e-3 else "ms"
            v = sec * 1e6 if sec < 1e-3 else sec * 1e3
            print(f"{name:36s} {v:10.2f} {unit}/iter")


if __name__ == "__main__":
    main()
