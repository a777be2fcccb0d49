"""Vectorized MurmurHash3_x64_128 (low 64 bits), seed 42.

wfmash hashes every k-mer with the public-domain MurmurHash3_x64_128
(Austin Appleby) at seed 42 and keeps the low 64 bits (h1) as the minmer
hash (reference: src/map/include/commonFunc.hpp:38,173-182 and
src/common/murmur3.h). All downstream mapping decisions (minmer selection,
Jaccard estimation, index joins) compare these 64-bit values, so the
implementation here must be bit-exact.

Three implementations, all cross-checked in tests:

* :func:`murmur3_low64_scalar` — pure-Python reference, one key at a time.
* :func:`murmur3_x64_128_low64` — NumPy, vectorized over N same-length keys
  (host-side index building).
* :mod:`wfmash_tpu.ops.murmur_u32` — JAX, 64-bit arithmetic emulated with
  uint32 pairs (device-side query sketching; JAX runs without 64-bit
  types unless jax_enable_x64 is set).

Only key lengths <= 32 bytes are required (k-mers; wfmash caps k well below
that), but the NumPy path supports arbitrary equal-length keys.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x87C37B91114253D5)
_C2 = np.uint64(0x4CF5AD432745937F)
_F1 = np.uint64(0xFF51AFD7ED558CCD)
_F2 = np.uint64(0xC4CEB9FE1A85EC53)

_M64 = (1 << 64) - 1

DEFAULT_SEED = 42  # commonFunc.hpp:38


# ---------------------------------------------------------------------------
# Pure-Python scalar reference
# ---------------------------------------------------------------------------

def _rotl64_py(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _fmix64_py(k: int) -> int:
    k ^= k >> 33
    k = (k * 0xFF51AFD7ED558CCD) & _M64
    k ^= k >> 33
    k = (k * 0xC4CEB9FE1A85EC53) & _M64
    k ^= k >> 33
    return k


def murmur3_low64_scalar(key: bytes, seed: int = DEFAULT_SEED) -> int:
    """Low 64 bits (h1) of MurmurHash3_x64_128(key, seed). Reference impl."""
    data = bytes(key)
    length = len(data)
    nblocks = length // 16
    h1 = seed & _M64
    h2 = seed & _M64
    c1 = 0x87C37B91114253D5
    c2 = 0x4CF5AD432745937F

    for i in range(nblocks):
        k1 = int.from_bytes(data[i * 16 : i * 16 + 8], "little")
        k2 = int.from_bytes(data[i * 16 + 8 : i * 16 + 16], "little")
        k1 = (k1 * c1) & _M64
        k1 = _rotl64_py(k1, 31)
        k1 = (k1 * c2) & _M64
        h1 ^= k1
        h1 = _rotl64_py(h1, 27)
        h1 = (h1 + h2) & _M64
        h1 = (h1 * 5 + 0x52DCE729) & _M64
        k2 = (k2 * c2) & _M64
        k2 = _rotl64_py(k2, 33)
        k2 = (k2 * c1) & _M64
        h2 ^= k2
        h2 = _rotl64_py(h2, 31)
        h2 = (h2 + h1) & _M64
        h2 = (h2 * 5 + 0x38495AB5) & _M64

    tail = data[nblocks * 16 :]
    k1 = 0
    k2 = 0
    t = length & 15
    for j in range(min(t, 15), 8, -1):  # bytes 8..14 -> k2
        k2 ^= tail[j - 1] << ((j - 9) * 8)
    if t >= 9:
        k2 = (k2 * c2) & _M64
        k2 = _rotl64_py(k2, 33)
        k2 = (k2 * c1) & _M64
        h2 ^= k2
    for j in range(min(t, 8), 0, -1):  # bytes 0..7 -> k1
        k1 ^= tail[j - 1] << ((j - 1) * 8)
    if t >= 1:
        k1 = (k1 * c1) & _M64
        k1 = _rotl64_py(k1, 31)
        k1 = (k1 * c2) & _M64
        h1 ^= k1

    h1 ^= length
    h2 ^= length
    h1 = (h1 + h2) & _M64
    h2 = (h2 + h1) & _M64
    h1 = _fmix64_py(h1)
    h2 = _fmix64_py(h2)
    h1 = (h1 + h2) & _M64
    return h1


# ---------------------------------------------------------------------------
# NumPy vectorized implementation
# ---------------------------------------------------------------------------

def _rotl64(x: np.ndarray, r: int) -> np.ndarray:
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _fmix64(k: np.ndarray) -> np.ndarray:
    k = k ^ (k >> np.uint64(33))
    k = k * _F1
    k = k ^ (k >> np.uint64(33))
    k = k * _F2
    k = k ^ (k >> np.uint64(33))
    return k


def murmur3_x64_128_low64(keys: np.ndarray, seed: int = DEFAULT_SEED) -> np.ndarray:
    """Hash N equal-length byte keys; returns uint64 array of shape (N,).

    ``keys``: uint8 array of shape (N, L).
    """
    keys = np.ascontiguousarray(keys, dtype=np.uint8)
    if keys.ndim == 1:
        keys = keys[None, :]
    n, length = keys.shape
    nblocks = length // 16

    with np.errstate(over="ignore"):
        h1 = np.full(n, seed, dtype=np.uint64)
        h2 = np.full(n, seed, dtype=np.uint64)

        u64 = keys[:, : nblocks * 16]
        if nblocks:
            # little-endian 8-byte words
            words = u64.reshape(n, nblocks, 2, 8).astype(np.uint64)
            shifts = (np.arange(8, dtype=np.uint64) * np.uint64(8))
            words = (words << shifts).sum(axis=-1, dtype=np.uint64)
            for i in range(nblocks):
                k1 = words[:, i, 0].copy()
                k2 = words[:, i, 1].copy()
                k1 *= _C1
                k1 = _rotl64(k1, 31)
                k1 *= _C2
                h1 ^= k1
                h1 = _rotl64(h1, 27)
                h1 += h2
                h1 = h1 * np.uint64(5) + np.uint64(0x52DCE729)
                k2 *= _C2
                k2 = _rotl64(k2, 33)
                k2 *= _C1
                h2 ^= k2
                h2 = _rotl64(h2, 31)
                h2 += h1
                h2 = h2 * np.uint64(5) + np.uint64(0x38495AB5)

        t = length & 15
        tail = keys[:, nblocks * 16 :].astype(np.uint64)
        if t >= 9:
            k2 = np.zeros(n, dtype=np.uint64)
            for j in range(9, t + 1):
                k2 ^= tail[:, j - 1] << np.uint64((j - 9) * 8)
            k2 *= _C2
            k2 = _rotl64(k2, 33)
            k2 *= _C1
            h2 ^= k2
        if t >= 1:
            k1 = np.zeros(n, dtype=np.uint64)
            for j in range(1, min(t, 8) + 1):
                k1 ^= tail[:, j - 1] << np.uint64((j - 1) * 8)
            k1 *= _C1
            k1 = _rotl64(k1, 31)
            k1 *= _C2
            h1 ^= k1

        h1 ^= np.uint64(length)
        h2 ^= np.uint64(length)
        h1 += h2
        h2 += h1
        h1 = _fmix64(h1)
        h2 = _fmix64(h2)
        h1 += h2

    return h1
