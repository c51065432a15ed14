"""The device engine's decode kernel: ``lrt_segment_decode`` via ``jax.ffi``.

One XLA FFI target, two handlers built from the same decode core
(``native/lzma_segment.h``):

- CUDA (``native/segment_cuda.cu``, built with ``nvcc`` for sm_90a): one
  LZMA2 dict-reset segment per thread, the window in device memory, the
  threads per block chosen by the handler from the lane count;
- CPU (``native/segment_cpu.cc``, built with ``g++``): the same lanes run
  one after another, so the CPU tests drive the card's decode logic and
  this wrapper through the same ``ffi_call``.

Both libraries are built at first use from the committed sources into
``native/build/`` (listed in ``.gitignore``); ``python -m
lzma_rs_tpu.ops.segment_decoder`` builds them ahead of time.

Operands (``runtime.stage_device`` builds them):
``inbuf u8[N]``, ``chunks i32[L, K, 8]`` (in_start, in_end absolute;
out_start, out_end relative to the lane's base; flags: 1 reset state,
2 range coder must stop at in_end; lc, lp, pb),
``lanes i32[L, 3]`` (chunk count, output base, dictionary limit as u32
bits) and ``prefill i32[P, 3]`` (src, dst, length of stored chunks).
Results: the flat output ``u8[T]``, a per-lane error code ``i32[L]``
(0 = ok), and the probability scratch ``u16[L * nprobs]``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import subprocess
import threading

import numpy as np

TARGET = "lrt_segment_decode"

_NATIVE = os.path.join(os.path.dirname(os.path.dirname(__file__)), "native")
BUILD_DIR = os.path.join(_NATIVE, "build")
_HEADER = os.path.join(_NATIVE, "lzma_segment.h")
_SOURCES = {
    "cpu": (os.path.join(_NATIVE, "segment_cpu.cc"), "LrtSegmentDecodeCpu"),
    "cuda": (os.path.join(_NATIVE, "segment_cuda.cu"), "LrtSegmentDecodeCuda"),
}

_lock = threading.Lock()
_registered: set = set()


def _lib_path(platform: str) -> str:
    return os.path.join(BUILD_DIR, f"liblrt_segment_{platform}.so")


def _compile_cmd(platform: str, src: str, out: str) -> list:
    import jax.ffi

    inc = ["-I", jax.ffi.include_dir(), "-I", _NATIVE]
    if platform == "cuda":
        nvcc = os.path.join(
            os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"
        )
        return [
            nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
            "-O3", "-shared", "-Xcompiler", "-fPIC", *inc, src, "-o", out,
        ]
    return ["g++", "-std=c++17", "-O2", "-shared", "-fPIC", *inc, src,
            "-o", out]


@contextlib.contextmanager
def _build_lock():
    """Serialise builds across processes (test workers share the tree)."""
    import fcntl

    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".lock"), "w") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def build(platform: str) -> str:
    """Compile the handler library for ``platform`` ("cpu" or "cuda") if
    it is missing or older than its sources; returns its path. Raises
    ``subprocess.CalledProcessError`` with the compiler's output on a
    failed build."""
    src, _ = _SOURCES[platform]
    out = _lib_path(platform)
    newest = max(os.path.getmtime(src), os.path.getmtime(_HEADER))
    if os.path.exists(out) and os.path.getmtime(out) >= newest:
        return out
    with _build_lock():
        if os.path.exists(out) and os.path.getmtime(out) >= newest:
            return out
        tmp = f"{out}.{os.getpid()}.tmp"
        try:
            subprocess.run(
                _compile_cmd(platform, src, tmp), check=True,
                capture_output=True, text=True, timeout=600,
            )
            os.replace(tmp, out)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return out


def register(platform: str) -> None:
    """Build (if needed) and register the handler for ``platform``
    ("cpu" or "cuda") under :data:`TARGET`."""
    import ctypes

    import jax.ffi

    with _lock:
        if platform in _registered:
            return
        lib = ctypes.cdll.LoadLibrary(build(platform))
        symbol = getattr(lib, _SOURCES[platform][1])
        jax.ffi.register_ffi_target(
            TARGET, jax.ffi.pycapsule(symbol),
            platform="CUDA" if platform == "cuda" else "cpu",
        )
        _registered.add(platform)


def probs_per_lane(max_lclp: int) -> int:
    """u16 probability entries one lane needs at ``lc + lp = max_lclp``
    (``lrt_seg::probs_count``)."""
    return 1848 + (0x300 << max_lclp)


def decode(inbuf, chunks, lanes, prefill, *, out_size: int, nprobs: int):
    """The ``ffi_call``: returns ``(out u8[out_size], err i32[L])``.
    Traceable (use under ``jit`` / ``shard_map``). The probability
    scratch (``L x nprobs`` u16) is a third result, dropped here."""
    import jax
    import jax.numpy as jnp

    L = lanes.shape[0]
    out, err, _ = jax.ffi.ffi_call(
        TARGET,
        (
            jax.ShapeDtypeStruct((out_size,), jnp.uint8),
            jax.ShapeDtypeStruct((L,), jnp.int32),
            jax.ShapeDtypeStruct((max(1, L) * nprobs,), jnp.uint16),
        ),
    )(inbuf, chunks, lanes, prefill, nprobs=np.int32(nprobs))
    return out, err


@functools.lru_cache(maxsize=64)
def jitted(n_dev: int, out_size: int, nprobs: int):
    """The jitted decode step for ``n_dev`` local devices. With several,
    lanes split along the ``dp`` mesh axis (operands carry a leading
    device axis); each device writes its own output slab, and no
    collective runs."""
    import jax

    from lzma_rs_tpu.platform import device_platform

    register(device_platform())
    step = functools.partial(decode, out_size=out_size, nprobs=nprobs)
    if n_dev == 1:
        return jax.jit(step)
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from lzma_rs_tpu.parallel.mesh import MeshConfig

    mesh = MeshConfig(n_devices=n_dev).make_mesh()

    def per_device(inbuf, chunks, lanes, prefill):
        out, err = step(inbuf, chunks[0], lanes[0], prefill[0])
        return out[None], err[None]

    return jax.jit(
        shard_map(
            per_device, mesh=mesh,
            in_specs=(P(), P("dp"), P("dp"), P("dp")),
            out_specs=(P("dp"), P("dp")),
        )
    )


if __name__ == "__main__":
    import sys

    for plat in sys.argv[1:] or ["cpu"]:
        print(build(plat))
