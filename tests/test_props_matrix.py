"""Raw-LZMA property matrix: lc/lp/pb combinations beyond the default
(3,0,2), produced by liblzma, decoded by our engines (position-dependent
literal contexts, large literal tables for lc+lp>4 on the host path)."""

import lzma as liblzma

import pytest

import lzma_rs_tpu

from conftest import read_ref


@pytest.mark.parametrize(
    "lc,lp,pb",
    [
        (0, 0, 0),
        (0, 2, 0),
        (1, 1, 1),
        (4, 0, 2),
        (2, 2, 3),
        (0, 4, 4),
        # lc+lp > 4 is legal in a raw-LZMA header (reference supports it;
        # so do our host engines) but liblzma refuses to ENCODE it, so
        # there is no practical oracle stream to test against.
    ],
)
def test_lzma1_props(lc, lp, pb):
    data = read_ref("foo.txt")[:30000]
    filters = [
        {"id": liblzma.FILTER_LZMA1, "preset": 6, "lc": lc, "lp": lp, "pb": pb}
    ]
    c = liblzma.compress(data, format=liblzma.FORMAT_ALONE, filters=filters)
    assert lzma_rs_tpu.lzma_decompress(c) == data


@pytest.mark.parametrize("lc,lp", [(0, 0), (2, 2), (0, 4), (4, 0)])
def test_lzma2_props(lc, lp):
    data = read_ref("foo.txt")[:30000]
    filters = [
        {"id": liblzma.FILTER_LZMA2, "preset": 6, "lc": lc, "lp": lp, "pb": 2}
    ]
    c = liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=filters)
    assert lzma_rs_tpu.lzma2_decompress(c) == data


def test_lzma2_props_spec_engine(monkeypatch):
    data = read_ref("small.txt") * 20
    filters = [{"id": liblzma.FILTER_LZMA2, "preset": 6, "lc": 0, "lp": 2}]
    c = liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=filters)
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "spec")
    assert lzma_rs_tpu.lzma2_decompress(c) == data


def test_lzma2_props_device_engine(monkeypatch):
    import jax

    jax.config.update("jax_platforms", "cpu")
    data = read_ref("small.txt") * 20
    filters = [{"id": liblzma.FILTER_LZMA2, "preset": 6, "lc": 1, "lp": 1}]
    c = liblzma.compress(data, format=liblzma.FORMAT_RAW, filters=filters)
    monkeypatch.setenv("LZMA_RS_TPU_BACKEND", "device")
    assert lzma_rs_tpu.lzma2_decompress(c) == data
