"""On-device CRC32 / CRC64-XZ for block-check verification.

The reference computes checks byte-serially through table lookups
(lzma-rs ``src/xz/crc.rs``). CRC is **linear over GF(2)**, so a chunk's
raw register is a binary matrix product: unpack the chunk's bits, multiply
by a fixed weight matrix (one int8 ``dot_general`` with int32
accumulation, exact since every sum is at most ``CHUNK * 8``), and take
the parity. The host folds the per-chunk registers with precomputed
zero-advance matrices ``Z_n`` ("advance the register by n zero bytes"),
applies the init/xorout correction and absorbs the tail that does not
fill a chunk.

Plain JAX: XLA lowers the product to the GPU's int8 matrix units (the
runtime uses it only on a CUDA device, ``runtime._xz_decode_parallel``).
Verified bit-exact against zlib / the native slice-by-8 implementation for
all lengths (tests/test_crc_device.py).
"""

from __future__ import annotations

import functools

import numpy as np

CRC32_POLY = 0xEDB88320
CRC64_POLY = 0xC96C5795D7870F42

CHUNK = 4096  # bytes per lane


# ---------------------------------------------------------------------------
# GF(2) matrix machinery (host side, numpy): operators as column images.
# ---------------------------------------------------------------------------


def _zero_byte_matrix(poly: int, width: int) -> np.ndarray:
    """Matrix of 'process one zero byte' acting on the raw register."""
    cols = np.zeros(width, dtype=np.uint64)
    for i in range(width):
        reg = 1 << i
        for _ in range(8):
            reg = (reg >> 1) ^ (poly if (reg & 1) else 0)
        cols[i] = reg
    return cols


def _mat_apply(m: np.ndarray, x: int) -> int:
    y = 0
    i = 0
    while x:
        if x & 1:
            y ^= int(m[i])
        x >>= 1
        i += 1
    return y


def _mat_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a ∘ b): column i = a(b[i])."""
    return np.array([_mat_apply(a, int(c)) for c in b], dtype=np.uint64)


@functools.lru_cache(maxsize=None)
def zero_advance_matrix(poly: int, width: int, nbytes: int) -> tuple:
    """Z_n as a tuple of column images (hashable for lru_cache)."""
    base = _zero_byte_matrix(poly, width)
    # identity
    result = np.array([1 << i for i in range(width)], dtype=np.uint64)
    sq = base
    n = nbytes
    while n:
        if n & 1:
            result = _mat_compose(sq, result)
        sq = _mat_compose(sq, sq)
        n >>= 1
    return tuple(int(c) for c in result)


def combine_raw(poly: int, width: int, left: int, right: int, right_len: int) -> int:
    """raw(A||B) = raw(B) ^ Z_{|B|}(raw(A))."""
    m = np.array(zero_advance_matrix(poly, width, right_len), dtype=np.uint64)
    return right ^ _mat_apply(m, left)


# ---------------------------------------------------------------------------
# Matrix formulation: CRC is linear over GF(2), so the raw register of a
# chunk is a binary matrix product:
#
#   raw(chunk) = XOR_j Z_{C-1-j}( T(byte_j) ),   T linear in the byte's bits
#   => raw_bits = bits(chunk) [C*8]  x  W [C*8, width]   (mod 2)
#
# Bit-unpack the bytes, run one int8 matmul (exact: sums <= C*8 < 2^31),
# take the parity.
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _crc_weight_matrix(poly: int, width: int, nbytes: int):
    """W [nbytes*8, width] int8: row (j*8+i) = bits of Z_{n-1-j}(T(1<<i)).

    Bit i here is the i-th bit of the byte as XORed into the register low
    bits (reflected convention: byte ^ reg low byte).
    """
    # T(1<<i): register after processing the single byte (1<<i) from 0.
    t = []
    for i in range(8):
        reg = 1 << i
        for _ in range(8):
            reg = (reg >> 1) ^ (poly if (reg & 1) else 0)
        t.append(reg)

    zb = _zero_byte_matrix(poly, width)
    # V = Z_n, built incrementally from n=0 upward; row block for position
    # j = nbytes-1-n uses V.
    V = np.array([1 << i for i in range(width)], dtype=np.uint64)
    W = np.zeros((nbytes * 8, width), dtype=np.int8)
    bit_idx = np.arange(width, dtype=np.uint64)
    for n in range(nbytes):
        j = nbytes - 1 - n
        for i in range(8):
            v = _mat_apply(V, t[i])
            W[j * 8 + i, :] = (np.uint64(v) >> bit_idx) & np.uint64(1)
        if n != nbytes - 1:
            V = _mat_compose_np(zb, V)
    return W


def _mat_compose_np(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Vectorized GF(2) compose: column i of (a ∘ b) = a(b[i])."""
    width = a.shape[0]
    out = np.zeros_like(b)
    for i in range(width):
        mask = ((b >> np.uint64(i)) & np.uint64(1)).astype(bool)
        out[mask] ^= a[i]
    return out


@functools.lru_cache(maxsize=32)
def _jitted_crc_matmul(width: int, L: int):
    """Device part only: bit-unpack + one int8 matmul + parity.

    The log-tree fold over per-chunk registers runs on the host (numpy) —
    it is O(width * L) trivial work and would otherwise dominate compile
    time of the device graph."""
    import jax
    import jax.numpy as jnp

    from lzma_rs_tpu.parallel.runtime import _enable_compile_cache

    _enable_compile_cache()
    poly = CRC32_POLY if width == 32 else CRC64_POLY
    W = jnp.asarray(_crc_weight_matrix(poly, width, CHUNK))  # [CHUNK*8, width]

    def fn(data2d):  # [L, CHUNK] u8
        bytes_i = data2d.astype(jnp.int32)
        # bit-unpack: [L, CHUNK, 8] (bit 0 = LSB, matching the reflected
        # byte-XOR into the register's low byte)
        shifts = jnp.arange(8, dtype=jnp.int32)
        bits = ((bytes_i[:, :, None] >> shifts[None, None, :]) & 1).astype(
            jnp.int8
        )
        bits = bits.reshape(L, CHUNK * 8)
        # int8 0/1 operands, int32 accumulation: every sum is exact
        y = jax.lax.dot_general(
            bits, W,
            dimension_numbers=(((1,), (0,)), ((), ())),
            preferred_element_type=jnp.int32,
        )  # [L, width]
        # the parity matrix; the host packs it into registers
        return (y & 1).astype(jnp.uint8)  # [L, width] of 0/1

    return jax.jit(fn)


def _pack_parity(parity: np.ndarray, width: int) -> np.ndarray:
    """[L, width] 0/1 -> [L] uint64 registers (host)."""
    shifts = np.arange(width, dtype=np.uint64)
    return (parity.astype(np.uint64) << shifts[None, :]).sum(
        axis=1, dtype=np.uint64
    )


def _tree_combine_host(regs: np.ndarray, poly: int, width: int, chunk_len: int) -> int:
    """Host log-tree fold of per-chunk raw registers (stream order)."""
    vals = regs.astype(np.uint64)
    level_len = chunk_len
    while vals.size > 1:
        cols = np.array(zero_advance_matrix(poly, width, level_len), dtype=np.uint64)
        left, right = vals[0::2], vals[1::2]
        acc = right.copy()
        for i in range(width):
            mask = ((left >> np.uint64(i)) & np.uint64(1)).astype(bool)
            acc[mask] ^= cols[i]
        vals = acc
        level_len *= 2
    return int(vals[0])


def _device_raw(data: bytes, width: int) -> tuple:
    """Raw register of the full-chunk prefix of ``data``; returns
    (raw_value, covered_len). Non-power-of-two chunk counts run as a few
    power-of-two device batches combined on the host (cheap matrix ops)."""
    import jax.numpy as jnp

    poly = CRC32_POLY if width == 32 else CRC64_POLY
    pos = 0
    raw = 0
    remaining = len(data) // CHUNK
    first = True
    while remaining:
        L = 1 << (remaining.bit_length() - 1)
        seg = data[pos : pos + L * CHUNK]
        arr = np.frombuffer(seg, dtype=np.uint8).reshape(L, CHUNK)
        fn = _jitted_crc_matmul(width, L)
        parity = np.asarray(fn(jnp.asarray(arr)))
        regs = _pack_parity(parity, width)
        val = _tree_combine_host(regs, poly, width, CHUNK)
        raw = val if first else combine_raw(poly, width, raw, val, L * CHUNK)
        first = False
        pos += L * CHUNK
        remaining -= L
    return raw, pos


def _host_raw_crc(data: bytes, width: int, init: int) -> int:
    """Raw register update (no init/xorout convention) on the host."""
    if width == 32:
        import zlib

        # zlib.crc32(data, v) computes ~raw(data, ~v); so raw(data, x) =
        # ~zlib.crc32(data, ~x & 0xFFFFFFFF)
        return (zlib.crc32(data, (~init) & 0xFFFFFFFF) ^ 0xFFFFFFFF)
    from lzma_rs_tpu.native import loader

    lib = loader.load()
    if lib is not None:
        return lib.crc64_update(data, init)
    # numpy fallback via utils.crc internals
    from lzma_rs_tpu.utils import crc as crc_mod

    arr = np.frombuffer(data, dtype=np.uint8)
    return crc_mod._crc64_numpy(arr, init)


def crc32_device(data: bytes) -> int:
    """CRC-32/ISO-HDLC computed on the default JAX device (tail + affine
    correction on host)."""
    raw, covered = _device_raw(data, 32)
    tail = data[covered:]
    if tail:
        raw = _host_raw_crc(bytes(tail), 32, raw)
    # apply init: crc = raw(data, init=0xFFFFFFFF) ^ 0xFFFFFFFF
    #            = raw(data, 0) ^ Z_len(0xFFFFFFFF) ^ 0xFFFFFFFF
    m = np.array(zero_advance_matrix(CRC32_POLY, 32, len(data)), dtype=np.uint64)
    return (raw ^ _mat_apply(m, 0xFFFFFFFF)) ^ 0xFFFFFFFF


def crc64_device(data: bytes) -> int:
    """CRC-64/XZ computed on the default JAX device."""
    raw, covered = _device_raw(data, 64)
    tail = data[covered:]
    if tail:
        raw = _host_raw_crc(bytes(tail), 64, raw)
    m = np.array(
        zero_advance_matrix(CRC64_POLY, 64, len(data)), dtype=np.uint64
    )
    init = 0xFFFFFFFFFFFFFFFF
    return (raw ^ _mat_apply(m, init)) ^ init
