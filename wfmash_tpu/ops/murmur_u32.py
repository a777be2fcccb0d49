"""MurmurHash3_x64_128 low-64 on the device via uint32-pair arithmetic.

Device-side counterpart of :func:`wfmash_tpu.sketch.murmur.murmur3_x64_128_low64`
(bit-exact, cross-checked in tests). Operates on fixed key length L (static),
vectorized over arbitrary batch shapes.

Reference semantics: src/common/murmur3.h (public-domain algorithm by
Austin Appleby), consumed at src/map/include/commonFunc.hpp:173-182.
"""

from __future__ import annotations

import jax.numpy as jnp

from . import u64

_C1 = 0x87C37B91114253D5
_C2 = 0x4CF5AD432745937F

DEFAULT_SEED = 42


def _fmix64(k):
    k = u64.xor(k, u64.shr(k, 33))
    k = u64.mul(k, u64.from_int(0xFF51AFD7ED558CCD))
    k = u64.xor(k, u64.shr(k, 33))
    k = u64.mul(k, u64.from_int(0xC4CEB9FE1A85EC53))
    k = u64.xor(k, u64.shr(k, 33))
    return k


def _words_from_bytes(b):
    """Pack byte columns into little-endian u64s as (hi, lo) u32 pairs.

    ``b``: list of up to 8 uint32 arrays (byte values), b[0] = lowest byte.
    Missing bytes are treated as zero.
    """
    lo = jnp.zeros_like(b[0])
    hi = jnp.zeros_like(b[0])
    for j, byte in enumerate(b):
        if j < 4:
            lo = lo | (byte << (8 * j))
        else:
            hi = hi | (byte << (8 * (j - 4)))
    return (hi, lo)


def murmur3_low64(key_bytes, length: int, seed: int = DEFAULT_SEED):
    """Hash keys of static byte length ``length``.

    ``key_bytes``: uint8/uint32 array of shape (..., length) — the L bytes of
    each key along the last axis. Returns (hi, lo) uint32 arrays of the
    leading shape.
    """
    kb = jnp.asarray(key_bytes)
    if kb.dtype != jnp.uint32:
        kb = kb.astype(jnp.uint32)
    cols = [kb[..., j] for j in range(length)]
    return murmur3_low64_from_columns(cols, length, seed)


def murmur3_low64_from_columns(cols, length: int, seed: int = DEFAULT_SEED):
    """Hash from pre-sliced byte columns (uint32 arrays), avoiding a (…, L)
    materialization — used by the k-mer pipeline where columns are shifted
    views of the sequence buffer.
    """
    assert len(cols) == length
    shape = cols[0].shape
    h1 = u64.from_int(seed, shape)
    h2 = u64.from_int(seed, shape)
    c1 = u64.from_int(_C1)
    c2 = u64.from_int(_C2)

    nblocks = length // 16
    for i in range(nblocks):
        k1 = _words_from_bytes(cols[i * 16 : i * 16 + 8])
        k2 = _words_from_bytes(cols[i * 16 + 8 : i * 16 + 16])
        k1 = u64.mul(k1, c1)
        k1 = u64.rotl(k1, 31)
        k1 = u64.mul(k1, c2)
        h1 = u64.xor(h1, k1)
        h1 = u64.rotl(h1, 27)
        h1 = u64.add(h1, h2)
        h1 = u64.add(u64.mul(h1, u64.from_int(5)), u64.from_int(0x52DCE729))
        k2 = u64.mul(k2, c2)
        k2 = u64.rotl(k2, 33)
        k2 = u64.mul(k2, c1)
        h2 = u64.xor(h2, k2)
        h2 = u64.rotl(h2, 31)
        h2 = u64.add(h2, h1)
        h2 = u64.add(u64.mul(h2, u64.from_int(5)), u64.from_int(0x38495AB5))

    t = length & 15
    tail = cols[nblocks * 16 :]
    if t >= 9:
        k2 = _words_from_bytes(tail[8:t])
        k2 = u64.mul(k2, c2)
        k2 = u64.rotl(k2, 33)
        k2 = u64.mul(k2, c1)
        h2 = u64.xor(h2, k2)
    if t >= 1:
        k1 = _words_from_bytes(tail[: min(t, 8)])
        k1 = u64.mul(k1, c1)
        k1 = u64.rotl(k1, 31)
        k1 = u64.mul(k1, c2)
        h1 = u64.xor(h1, k1)

    ln = u64.from_int(length)
    h1 = u64.xor(h1, ln)
    h2 = u64.xor(h2, ln)
    h1 = u64.add(h1, h2)
    h2 = u64.add(h2, h1)
    h1 = _fmix64(h1)
    h2 = _fmix64(h2)
    h1 = u64.add(h1, h2)
    return h1
