"""Test configuration.

Tests run on the CPU with 8 virtual XLA devices, so the multi-device
sharding path (``shard_map`` over a mesh) runs without a card. Tests that
need a CUDA device carry the ``gpu`` marker; the ``gpu_device`` fixture
skips them where JAX finds none (run them on the card with
``python -m pytest tests/ -m gpu``, without the CPU override below by
setting ``LZMA_RS_TPU_TEST_GPU=1``).

Golden files come from the seeded in-repo corpus (``lzma_rs_tpu.corpus``),
built on first use in each worker process.
"""

import os
import sys

if not os.environ.get("LZMA_RS_TPU_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8"
        ).strip()

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import pytest  # noqa: E402


def read_ref(name: str) -> bytes:
    """A golden test file by its upstream name, from the seeded corpus."""
    from lzma_rs_tpu import corpus

    return corpus.golden(name)


@pytest.fixture
def gpu_device():
    """The first CUDA device; skips the test where there is none."""
    import jax

    try:
        devs = jax.devices("gpu")
    except RuntimeError:
        devs = []
    if not devs:
        pytest.skip("needs a CUDA device")
    return devs[0]
