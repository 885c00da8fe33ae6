"""Threefry-2x32 counter-based random bits in numpy, drawing the same bits
as the reference package's `jax.random` calls under jax's default
`jax_threefry_partitionable = True`:

    key0 = prng_key(seed)            # jax.random.PRNGKey(seed)
    keys = split(key0, 8)            # jax.random.split(key0, 8)
    bits(keys[i], n)                 # jax.random.bits(keys[i], (n,), uint32)
    rademacher(keys[i], n)           # jax.random.rademacher(keys[i], (n,), int32)

A key is a (2,) uint32 array.  In partitionable mode element i of a draw is
threefry2x32(key, (hi, lo) of the 64-bit counter i): `split` keeps both
output words as the new key, `bits` xors them.  Rademacher is bernoulli(0.5)
through `uniform`, whose mantissa is the top 23 bits, so it is +1 exactly
where bit 31 of `bits` is 0."""
from __future__ import annotations

import numpy as np

_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
_PARITY = np.uint32(0x1BD11BDA)


def _rotl(v: np.ndarray, r: int) -> np.ndarray:
    return (v << np.uint32(r)) | (v >> np.uint32(32 - r))


def threefry2x32(key: np.ndarray, x0: np.ndarray, x1: np.ndarray
                 ) -> tuple[np.ndarray, np.ndarray]:
    """The Threefry-2x32 hash (20 rounds) of the counter words (x0, x1)
    under `key`; uint32 arithmetic wraps."""
    k0, k1 = np.uint32(key[0]), np.uint32(key[1])
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x = [np.asarray(x0, np.uint32) + ks[0], np.asarray(x1, np.uint32) + ks[1]]
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in _ROTATIONS[i % 2]:
                x[0] = x[0] + x[1]
                x[1] = _rotl(x[1], r) ^ x[0]
            x[0] = x[0] + ks[(i + 1) % 3]
            x[1] = x[1] + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x[0], x[1]


def _counters(n: int) -> tuple[np.ndarray, np.ndarray]:
    """The 64-bit counters 0..n-1 as (high, low) uint32 words."""
    c = np.arange(n, dtype=np.uint64)
    return (c >> np.uint64(32)).astype(np.uint32), \
        (c & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def prng_key(seed: int) -> np.ndarray:
    """jax.random.PRNGKey(seed): the seed's high and low 32 bits."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], np.uint32)


def split(key: np.ndarray, num: int = 2) -> np.ndarray:
    """jax.random.split(key, num): (num, 2) uint32 keys."""
    b0, b1 = threefry2x32(key, *_counters(num))
    return np.stack([b0, b1], axis=1)


def bits(key: np.ndarray, n: int) -> np.ndarray:
    """jax.random.bits(key, (n,), uint32)."""
    b0, b1 = threefry2x32(key, *_counters(n))
    return b0 ^ b1


def rademacher(key: np.ndarray, n: int) -> np.ndarray:
    """jax.random.rademacher(key, (n,), int32): +1 where bit 31 of the
    draw's bits is 0, else -1."""
    return np.where(bits(key, n) >> np.uint32(31), -1, 1).astype(np.int32)
