"""Engine-equivalence property tests: for randomized inputs (valid and
corrupted), the spec, native, device and XLA lane engines must produce identical
outputs — or identical error classes — for the same stream. This is the
framework's strongest internal consistency net (the reference's analog is
its differential fuzzing vs liblzma, fuzz/README.md)."""

import lzma as liblzma
import random

import pytest

from lzma_rs_tpu.models.codecs import Lzma2Decoder, xz_decode_stream
from lzma_rs_tpu.parallel import runtime
from lzma_rs_tpu.utils.cursor import ByteCursor
from lzma_rs_tpu.utils.errors import LzmaRsError


@pytest.fixture(scope="module", autouse=True)
def _cpu():
    import jax

    jax.config.update("jax_platforms", "cpu")
    yield


def _gen_payload(rng):
    parts = []
    for _ in range(rng.randrange(1, 6)):
        kind = rng.random()
        n = rng.randrange(1, 20000)
        if kind < 0.4:
            parts.append(bytes([rng.randrange(8)]) * n)
        elif kind < 0.7:
            words = [b"alpha", b"beta", b"gamma", b"delta", b" ", b"\n"]
            parts.append(b"".join(rng.choice(words) for _ in range(n // 4)))
        else:
            parts.append(bytes(rng.randrange(256) for _ in range(min(n, 4096))))
    return b"".join(parts)


def _decode_all_engines(c: bytes):
    """Returns {engine: (output|None, err_class|None)}."""
    results = {}
    for name, fn in [
        ("spec", lambda d: Lzma2Decoder().decompress(ByteCursor(d))),
        ("native", lambda d: runtime.lzma2_decode(d, engine="native")),
        # the device engine's decode core (CPU handler here) and the
        # plain XLA lane decoder it is compared with on the card
        ("device", lambda d: runtime.lzma2_decode(d, engine="device")),
        ("xla", lambda d: runtime.lzma2_decode(d, engine="xla")),
    ]:
        try:
            results[name] = (fn(c), None)
        except LzmaRsError as e:
            results[name] = (None, type(e).__name__)
    return results


@pytest.mark.parametrize("seed", range(4))
def test_valid_streams_agree(seed):
    rng = random.Random(10_000 + seed)
    for _ in range(6):
        payload = _gen_payload(rng)
        preset = rng.choice([0, 1, 6])
        c = liblzma.compress(
            payload,
            format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": preset}],
        )
        res = _decode_all_engines(c)
        assert res["spec"] == res["native"] == res["device"] == res["xla"]
        assert res["spec"][0] == payload


@pytest.mark.parametrize("seed", range(3))
def test_corrupted_streams_agree_on_output_or_error(seed):
    rng = random.Random(20_000 + seed)
    payload = _gen_payload(rng)
    c = bytearray(
        liblzma.compress(
            payload,
            format=liblzma.FORMAT_RAW,
            filters=[{"id": liblzma.FILTER_LZMA2, "preset": 6}],
        )
    )
    for _ in range(10):
        i = rng.randrange(len(c))
        old = c[i]
        c[i] ^= 1 << rng.randrange(8)
        res = _decode_all_engines(bytes(c))
        # all engines agree: same output bytes, or all error
        outs = {r[0] for r in res.values()}
        errs = {r[1] is not None for r in res.values()}
        assert len(outs) == 1 or errs == {True}, (i, res["spec"][1], res)
        c[i] = old


@pytest.mark.parametrize("seed", range(2))
def test_own_encoder_streams_agree(seed):
    import lzma_rs_tpu

    rng = random.Random(30_000 + seed)
    for level in (0, 1, 6):
        payload = _gen_payload(rng)
        c = lzma_rs_tpu.lzma2_compress(payload, level=level)
        res = _decode_all_engines(c)
        assert res["spec"] == res["native"] == res["device"] == res["xla"]
        assert res["spec"][0] == payload
