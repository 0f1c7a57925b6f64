"""The port's own threefry2x32 counter-based generator, in numpy.

The JAX package draws its per-node randomness (extra_trees thresholds,
the feature_fraction_bynode sample; lightgbm_tpu/ops/grow.py:455-469)
with ``jax.random`` under its defaults: the ``threefry2x32`` generator,
``jax_threefry_partitionable=True`` and 64-bit types (the package enables
``jax_enable_x64``, so ``uniform`` draws float64 and ``randint`` int64).
This module computes the same draws bit for bit without JAX, on uint32
numpy arrays: a key is a ``[2]`` uint32 array (``jax.random.key_data``).

Threefry-2x32 with 20 rounds (Salmon et al., "Parallel random numbers: as
easy as 1, 2, 3", SC 2011), in the order of jax/_src/prng.py:
``_threefry2x32_lowering``.
"""
from __future__ import annotations

import numpy as np

U32 = np.uint32
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, d: int):
    return (x << U32(d)) | (x >> U32(32 - d))


def threefry2x32(k0, k1, x0, x1):
    """The Threefry-2x32 hash of the counter pairs (x0, x1) under the key
    (k0, k1): uint32 arrays that broadcast together. Returns (y0, y1)."""
    k0, k1 = np.asarray(k0, U32), np.asarray(k1, U32)
    ks = (k0, k1, k0 ^ k1 ^ U32(0x1BD11BDA))
    with np.errstate(over="ignore"):
        v0 = np.asarray(x0, U32) + ks[0]
        v1 = np.asarray(x1, U32) + ks[1]
        for i in range(5):
            for r in _ROT[i % 2]:
                v0 = v0 + v1
                v1 = _rotl(v1, r)
                v1 = v0 ^ v1
            v0 = v0 + ks[(i + 1) % 3]
            v1 = v1 + ks[(i + 2) % 3] + U32(i + 1)
    return v0, v1


def prng_key(seed: int) -> np.ndarray:
    """``jax.random.PRNGKey(seed)``: the 64-bit seed's high and low words."""
    s = int(seed) & 0xFFFFFFFFFFFFFFFF
    return np.array([s >> 32, s & 0xFFFFFFFF], U32)


def fold_in(key, data: int) -> np.ndarray:
    """``jax.random.fold_in``: the hash of the counter pair (0, data)."""
    y0, y1 = threefry2x32(key[0], key[1], U32(0), U32(int(data) & 0xFFFFFFFF))
    return np.array([y0, y1], U32)


def split(key, num: int = 2) -> np.ndarray:
    """``jax.random.split`` (the partitionable form): [num, 2] keys, key i
    the hash of the counter pair (0, i)."""
    y0, y1 = threefry2x32(key[0], key[1], np.zeros(num, U32),
                          np.arange(num, dtype=U32))
    return np.stack([y0, y1], axis=1)


def random_bits64(key, n: int) -> np.ndarray:
    """[n] uint64 random words (``_threefry_random_bits_partitionable`` at
    64 bits): counter i's two hash words, high then low."""
    y0, y1 = threefry2x32(key[0], key[1], np.zeros(n, U32),
                          np.arange(n, dtype=U32))
    return (y0.astype(np.uint64) << np.uint64(32)) | y1.astype(np.uint64)


def uniform(key, n: int) -> np.ndarray:
    """``jax.random.uniform(key, (n,))`` in float64: the top 52 bits of a
    random word as the mantissa of a number in [1, 2), minus 1."""
    bits = (random_bits64(key, n) >> np.uint64(12)) \
        | np.uint64(0x3FF0000000000000)
    return bits.view(np.float64) - 1.0


def randint(key, n: int, minval, maxval) -> np.ndarray:
    """``jax.random.randint(key, (n,), minval, maxval)`` in int64: two
    random words per value, reduced modulo the span as jax/_src/random.py:
    ``_randint`` does (span 1 where maxval <= minval)."""
    lo = np.broadcast_to(np.asarray(minval, np.int64), (n,))
    hi = np.broadcast_to(np.asarray(maxval, np.int64), (n,))
    k1, k2 = split(key)
    higher, lower = random_bits64(k1, n), random_bits64(k2, n)
    span = np.where(hi <= lo, 1, hi - lo).astype(np.uint64)
    with np.errstate(over="ignore"):
        mult = np.uint64(1 << 32) % span
        mult = (mult * mult) % span
        off = ((higher % span) * mult + lower % span) % span
    return lo + off.astype(np.int64)


def bynode_mask(key, feature_mask: np.ndarray, k: int) -> np.ndarray:
    """The feature_fraction_bynode sample of one node (lightgbm_tpu/ops/
    grow.py:455-463): the k features of the smallest uniform draws under
    ``fold_in(key, 1)``, the tree's unsampled features drawn last (+inf),
    in a stable sort."""
    F = len(feature_mask)
    r = np.where(feature_mask, uniform(fold_in(key, 1), F), np.inf)
    out = np.zeros(F, bool)
    out[np.argsort(r, kind="stable")[:k]] = True
    return out


def extra_trees_bins(key, feat_nb: np.ndarray) -> np.ndarray:
    """The extra_trees threshold of each feature at one node (lightgbm_tpu/
    ops/grow.py:465-469): ``randint(fold_in(key, 2), (F,), 0,
    max(nb - 1, 1))``."""
    nb = np.asarray(feat_nb, np.int64)
    return randint(fold_in(key, 2), len(nb), 0, np.maximum(nb - 1, 1))
