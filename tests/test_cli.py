"""CLI (`python -m lzma_rs_tpu`) end-to-end tests."""

import os
import subprocess
import sys

from conftest import read_ref

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_cli(*args, input=None):
    return subprocess.run(
        [sys.executable, "-m", "lzma_rs_tpu", *args],
        input=input,
        capture_output=True,
        cwd=REPO,
        check=True,
    )


def test_compress_decompress_xz(tmp_path):
    data = read_ref("foo.txt")
    r = run_cli("compress", "--check", "crc32", input=data)
    out = run_cli("decompress", input=r.stdout)
    assert out.stdout == data


def test_lzma_format(tmp_path):
    data = read_ref("small.txt")
    r = run_cli("compress", "--format", "lzma", input=data)
    out = run_cli("decompress", "--format", "lzma", input=r.stdout)
    assert out.stdout == data


def test_info(tmp_path):
    data = read_ref("foo.txt")
    p = tmp_path / "a.xz"
    run_cli("compress", "-o", str(p), "--block-size", "65536", input=data)
    r = run_cli("info", str(p))
    assert b"blocks: 3" in r.stdout


def test_sniff_auto(tmp_path):
    data = read_ref("hello.txt")
    r = run_cli("compress", "--format", "lzma", input=data)
    out = run_cli("decompress", input=r.stdout)  # auto-sniffs raw lzma
    assert out.stdout == data
