"""Streams that carry probability state across a dict reset cannot be
segment-parallelized; the planner must detect them and fall back to the
sequential engine so results stay bit-identical with the reference
semantics."""

import pytest

import lzma_rs_tpu
from lzma_rs_tpu.parallel import runtime
from lzma_rs_tpu.models.codecs import Lzma2Decoder
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import LzmaRsError


def _mode0_after_dict_reset_stream():
    """[mode-3 chunk][control-1 uncompressed (dict reset)][mode-0 chunk]."""
    base = lzma_rs_tpu.lzma2_compress(b"hello world, hello world, hello!" * 4)
    assert base[0] & 0xE0 == 0xE0  # first chunk resets everything
    # chunk A: copy the first chunk verbatim
    usz = ((base[0] & 0x1F) << 16 | base[1] << 8 | base[2]) + 1
    psz = (base[3] << 8 | base[4]) + 1
    chunk_a = bytes(base[: 6 + psz])  # control+sizes+props+payload

    out = bytearray(chunk_a)
    # control-1 uncompressed chunk: dict reset, 4 bytes
    out += bytes([1, 0, 3]) + b"abcd"
    # mode-0 LZMA chunk: first LZMA chunk of the new segment, continues
    # probability state (reset_mode 0) — reuse chunk A's payload bytes
    payload = chunk_a[6:]
    out += bytes([0x80 | (usz - 1) >> 16, ((usz - 1) >> 8) & 0xFF, (usz - 1) & 0xFF])
    out += bytes([(psz - 1) >> 8, (psz - 1) & 0xFF])
    out += payload
    out.append(0)
    return bytes(out)


def test_planner_detects_state_carry():
    data = _mode0_after_dict_reset_stream()
    with pytest.raises(runtime.UnparallelizableStream):
        runtime.plan_lzma2_stream(data, 0, 0)


@pytest.mark.parametrize("engine", ["native", "device"])
def test_parallel_falls_back_to_sequential(engine):
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = _mode0_after_dict_reset_stream()
    # ground truth: the sequential reference-semantics decoder
    try:
        expected = Lzma2Decoder().decompress(ByteCursor(data))
        expected_err = None
    except LzmaRsError as e:
        expected = None
        expected_err = str(e)
    try:
        got = runtime.lzma2_decode(data, engine=engine)
        got_err = None
    except LzmaRsError as e:
        got = None
        got_err = str(e)
    assert (expected, expected_err) == (got, got_err)


def test_normal_streams_still_parallel():
    data = b"The quick brown fox jumps over the lazy dog. " * 200
    c = lzma_rs_tpu.lzma2_compress(data)
    plan, _ = runtime.plan_lzma2_stream(c, 0, 0)
    assert plan.total_out == len(data)
