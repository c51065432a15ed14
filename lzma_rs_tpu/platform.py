"""The one place that decides what accelerator the runtime decodes on.

The device engine runs its decode kernel through ``jax.ffi`` on JAX's
default backend: the CUDA handler on a GPU, the CPU handler (the same
decode core) elsewhere. ``auto`` routing and the device block checks go
to the card only when :func:`has_cuda` is true.
"""

from __future__ import annotations


def device_platform() -> str:
    """FFI platform of JAX's default backend: "cuda" on a GPU, else
    "cpu"."""
    import jax

    return "cuda" if jax.default_backend() == "gpu" else "cpu"


def has_cuda() -> bool:
    """True when JAX's default backend is a CUDA GPU."""
    return device_platform() == "cuda"
