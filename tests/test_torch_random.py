"""The port's numpy threefry (lightgbm_torch/utils/random.py) against
jax.random, bit for bit.

The JAX package draws its per-node extra_trees thresholds and
feature_fraction_bynode samples with jax.random under its defaults
(threefry2x32, jax_threefry_partitionable, x64: uniform in float64,
randint in int64). The port replays them on the host: ``PRNGKey``,
``fold_in``, ``split``, ``uniform``, ``randint`` and the two per-node draws
of lightgbm_tpu/ops/grow.py:455-469 must give the same bits over many
keys, counters and shapes.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lightgbm_tpu  # noqa: F401  (x64, as the JAX package trains)
from lightgbm_torch.utils import random as tf

SEEDS = [0, 1, 6, 11, 2 ** 31 - 1, 2 ** 32 + 7, -3]


def _jkey(seed):
    return jax.random.PRNGKey(seed)


@pytest.mark.parametrize("seed", SEEDS)
def test_key_and_fold_in(seed):
    k = _jkey(seed)
    np.testing.assert_array_equal(tf.prng_key(seed), np.asarray(k))
    key = tf.prng_key(seed)
    for data in (0, 1, 2, 3, 17, 510, 511, 65535, 2 ** 31, 2 ** 32 - 1):
        want = jax.random.key_data(jax.random.fold_in(
            jax.random.wrap_key_data(k), data))
        np.testing.assert_array_equal(tf.fold_in(key, data),
                                      np.asarray(want))


@pytest.mark.parametrize("seed", SEEDS[:4])
def test_split(seed):
    k = jax.random.wrap_key_data(_jkey(seed))
    for num in (2, 3, 8):
        want = jax.random.key_data(jax.random.split(k, num))
        np.testing.assert_array_equal(tf.split(tf.prng_key(seed), num),
                                      np.asarray(want))


@pytest.mark.parametrize("n", [1, 2, 7, 28, 137, 1000])
def test_uniform_and_randint(n):
    rng = np.random.default_rng(n)
    for seed in SEEDS:
        for tag in (0, 5, 2 ** 20):
            key = tf.fold_in(tf.prng_key(seed), tag)
            wk = jax.random.wrap_key_data(jnp.asarray(key))
            u = np.asarray(jax.random.uniform(wk, (n,)))
            assert u.dtype == np.float64
            np.testing.assert_array_equal(tf.uniform(key, n), u)
            hi = rng.integers(-2, 400, n)
            want = np.asarray(jax.random.randint(
                wk, (n,), 0, jnp.maximum(jnp.asarray(hi, jnp.int32) - 1, 1)))
            assert want.dtype == np.int64
            np.testing.assert_array_equal(
                tf.randint(key, n, 0, np.maximum(hi - 1, 1)), want)
            lo = rng.integers(-50, 50, n)
            np.testing.assert_array_equal(
                tf.randint(key, n, lo, lo + hi),
                np.asarray(jax.random.randint(wk, (n,), lo, lo + hi)))


@pytest.mark.parametrize("F,k", [(6, 3), (28, 23), (137, 40)])
def test_node_draws_match_the_jax_grower(F, k):
    """The per-node draws of the JAX eval_leaf (grow.py:455-469): the
    by-node sample (stable argsort of uniform draws, unsampled features
    last) and the extra_trees bins, for a root and split keys."""
    rng = np.random.default_rng(F)
    fmask = rng.random(F) < 0.8
    nb = rng.integers(1, 257, F).astype(np.int32)
    tree_key = tf.fold_in(tf.prng_key(6), 3)
    for tag in (0, 2, 3, 40, 41):
        key = tf.fold_in(tree_key, tag)
        jk = jax.random.wrap_key_data(jnp.asarray(key))
        r = jax.random.uniform(jax.random.fold_in(jk, 1), (F,))
        r = jnp.where(jnp.asarray(fmask), r, jnp.inf)
        order = jnp.argsort(r)
        want = np.zeros(F, bool)
        want[np.asarray(order[:k])] = True
        np.testing.assert_array_equal(tf.bynode_mask(key, fmask, k), want)
        bins = jax.random.randint(jax.random.fold_in(jk, 2), (F,), 0,
                                  jnp.maximum(jnp.asarray(nb) - 1, 1))
        np.testing.assert_array_equal(tf.extra_trees_bins(key, nb),
                                      np.asarray(bins))
