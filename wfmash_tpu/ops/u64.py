"""Emulated unsigned 64-bit arithmetic on uint32 pairs.

JAX runs without 64-bit types unless jax_enable_x64 is set process-wide,
so the device code keeps to 32-bit lanes. The hash pipeline (murmur3, canonical k-mer comparison, bottom-s selection)
needs exact uint64 semantics, so we represent a u64 as a pair of uint32
arrays ``(hi, lo)`` and implement the few ops murmur3 needs:

add, xor, low-64 multiply, rotate-left, logical shift-right, comparison.

All functions are shape-polymorphic and jit-friendly (static shift counts).
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
_MASK16 = 0xFFFF


def u64(hi, lo):
    return (jnp.asarray(hi, U32), jnp.asarray(lo, U32))


def from_int(value: int, shape=()):  # broadcastable constant
    hi = jnp.full(shape, (value >> 32) & 0xFFFFFFFF, U32)
    lo = jnp.full(shape, value & 0xFFFFFFFF, U32)
    return (hi, lo)


def xor(a, b):
    return (a[0] ^ b[0], a[1] ^ b[1])


def add(a, b):
    lo = a[1] + b[1]
    carry = (lo < a[1]).astype(U32)
    hi = a[0] + b[0] + carry
    return (hi, lo)


def _mul32x32(a, b):
    """Full 32x32 -> 64 multiply via 16-bit limbs. Returns (hi32, lo32)."""
    a0 = a & _MASK16
    a1 = a >> 16
    b0 = b & _MASK16
    b1 = b >> 16
    p00 = a0 * b0
    p01 = a0 * b1
    p10 = a1 * b0
    p11 = a1 * b1
    mid = (p00 >> 16) + (p01 & _MASK16) + (p10 & _MASK16)
    lo = (p00 & _MASK16) | (mid << 16)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def mul(a, b):
    """Low 64 bits of a*b."""
    hi_ll, lo = _mul32x32(a[1], b[1])
    hi = hi_ll + a[1] * b[0] + a[0] * b[1]
    return (hi, lo)


def rotl(a, r: int):
    r = r % 64
    hi, lo = a
    if r == 0:
        return (hi, lo)
    if r == 32:
        return (lo, hi)
    if r > 32:
        hi, lo = lo, hi
        r -= 32
    return ((hi << r) | (lo >> (32 - r)), (lo << r) | (hi >> (32 - r)))


def shr(a, s: int):
    """Logical right shift by static s (0 <= s < 64)."""
    hi, lo = a
    if s == 0:
        return (hi, lo)
    if s == 32:
        return (jnp.zeros_like(hi), hi)
    if s > 32:
        return (jnp.zeros_like(hi), hi >> (s - 32))
    return (hi >> s, (lo >> s) | (hi << (32 - s)))


def shl(a, s: int):
    """Logical left shift by static s (0 <= s < 64)."""
    hi, lo = a
    if s == 0:
        return (hi, lo)
    if s == 32:
        return (lo, jnp.zeros_like(lo))
    if s > 32:
        return (lo << (s - 32), jnp.zeros_like(lo))
    return ((hi << s) | (lo >> (32 - s)), lo << s)


def lt(a, b):
    """a < b (unsigned)."""
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] < b[1]))


def le(a, b):
    return (a[0] < b[0]) | ((a[0] == b[0]) & (a[1] <= b[1]))


def eq(a, b):
    return (a[0] == b[0]) & (a[1] == b[1])


def where(pred, a, b):
    return (jnp.where(pred, a[0], b[0]), jnp.where(pred, a[1], b[1]))


def to_numpy(a):
    """Assemble to a host numpy uint64 array (for tests / host pipeline)."""
    import numpy as np

    return (np.asarray(a[0], dtype=np.uint64) << np.uint64(32)) | np.asarray(
        a[1], dtype=np.uint64
    )
