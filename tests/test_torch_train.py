"""lightgbm_torch.train against lightgbm_tpu.train, and model interop.

Both packages train on the same HIGGS-shaped rows. On the CPU the JAX
package trains in f64 (resolve_use_dp, treelearner/serial.py:170-179)
with its masked grower; the port trains on its f32 fast path (the
partitioned grower, the kernels' plain versions). The trees must be equal
in structure: split features, thresholds, children, leaf counts. Raw scores
agree within 1e-4: the leaf outputs differ by f32 rounding of the gradient
sums (about 1e-7 relative of sums that cancel), times the learning rate,
over five trees.

On data with missing values, a split whose leaf holds no row in the missing
bin has mathematically equal forward and REVERSE gains, and rounding picks
the direction (ROADMAP.md queue C): the default-left bit of such a node is
not compared. No training row takes that default path, so the scores on the
training rows stay within the tolerance.
"""
import numpy as np
import pytest

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.convert import booster_from_reference
from lightgbm_torch.data.synth import make_higgs_like


def _data(n, seed, missing):
    X, y = make_higgs_like(n, seed=seed)
    if missing:
        rng = np.random.default_rng(seed)
        X[rng.random((n, X.shape[1])) < 0.05] = np.nan
        X[rng.random(n) < 0.6, 1] = 0.0
    return X, y


def _train_both(params, X, y, rounds=5):
    bj = lt.train(dict(params), lt.Dataset(X, y), rounds)
    pp = dict(params, device_type="cpu")
    bp = lp.train(pp, lp.Dataset(X, y, params=pp), rounds)
    return bj, bp


def _defaults_taken(tree, X):
    """Per internal node: does any row reaching it take the missing-value
    default path? (Walks the JAX tree over the training rows.)"""
    ni = tree.num_leaves - 1
    out = np.zeros(ni, bool)
    node = np.zeros(X.shape[0], np.int64)
    active = np.arange(X.shape[0])
    while len(active):
        nd = node[active]
        fv = X[active, tree.split_feature[nd]]
        mt = (tree.decision_type[nd] >> 2) & 3
        miss = ((mt == 2) & np.isnan(fv)) | (
            (mt == 1) & ((np.abs(np.nan_to_num(fv)) <= 1e-35)))
        np.logical_or.at(out, nd, miss)
        go_left = tree._decision(fv, nd)
        nxt = np.where(go_left, tree.left_child[nd], tree.right_child[nd])
        node[active] = nxt
        active = active[nxt >= 0]
    return out


def _jax_trees(bj):
    return bj._booster._used_models()        # materializes pending trees


def _assert_same_trees(bj, bp, X):
    tj, tp = _jax_trees(bj), bp._booster.models
    assert len(tj) == len(tp) == 5
    for a, b in zip(tj, tp):
        assert a.num_leaves == b.num_leaves > 2
        k = a.num_leaves - 1
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k], f)
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        taken = _defaults_taken(a, X)
        np.testing.assert_array_equal(a.decision_type[:k][taken],
                                      b.decision_type[:k][taken])
        np.testing.assert_array_equal(a.decision_type[:k] & ~2,
                                      b.decision_type[:k] & ~2)


@pytest.mark.parametrize("leaves,n,seed,missing", [
    (15, 4000, 1, False), (31, 6000, 2, False), (31, 5000, 3, True)])
def test_train_matches_jax(leaves, n, seed, missing):
    X, y = _data(n, seed, missing)
    params = {"objective": "binary", "num_leaves": leaves, "max_bin": 63,
              "verbosity": -1}
    bj, bp = _train_both(params, X, y)
    _assert_same_trees(bj, bp, X)
    if not missing:
        for a, b in zip(_jax_trees(bj), bp._booster.models):
            k = a.num_leaves - 1
            np.testing.assert_array_equal(a.decision_type[:k],
                                          b.decision_type[:k])
    rj = bj.predict(X, raw_score=True)
    rp = bp.predict(X, raw_score=True)
    np.testing.assert_allclose(rp, rj, rtol=0, atol=1e-4)


def test_port_model_text_loads_in_jax():
    X, y = _data(4000, 4, True)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "device_type": "cpu", "verbosity": -1}
    bp = lp.train(params, lp.Dataset(X, y, params=params), 5)
    text = bp.model_to_string()
    bj = lt.Booster(model_str=text)
    np.testing.assert_allclose(bj.predict(X, raw_score=True),
                               bp.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(bj.predict(X), bp.predict(X), rtol=0,
                               atol=1e-12)
    again = lp.Booster(model_str=text)
    assert again.model_to_string().split("parameters:")[0] \
        == text.split("parameters:")[0]


def test_jax_model_loads_in_port():
    X, y = _data(4000, 5, True)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbosity": -1}
    bj = lt.train(dict(params), lt.Dataset(X, y), 5)
    bp = booster_from_reference(bj.model_to_string(),
                                params={"device_type": "cpu"})
    assert bp.num_trees() == 5
    np.testing.assert_allclose(bp.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(bp.predict(X), bj.predict(X), rtol=0,
                               atol=1e-12)


def test_train_stops_when_nothing_splits():
    X, y = _data(300, 6, False)
    params = {"objective": "binary", "min_data_in_leaf": 1000,
              "device_type": "cpu", "verbosity": -1}
    bp = lp.train(params, lp.Dataset(X, y, params=params), 5)
    assert bp.num_trees() == 1
    assert bp._booster.models[0].num_leaves == 1
    p = 1 / (1 + np.exp(-bp.predict(X, raw_score=True)))
    np.testing.assert_allclose(p, y.mean(), rtol=1e-9)


def test_feature_fraction_draws_the_jax_columns():
    X, y = _data(4000, 7, False)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "feature_fraction": 0.5, "verbosity": -1}
    bj, bp = _train_both(params, X, y)
    for a, b in zip(_jax_trees(bj), bp._booster.models):
        k = a.num_leaves - 1
        np.testing.assert_array_equal(a.split_feature[:k],
                                      b.split_feature[:k])
        np.testing.assert_array_equal(a.threshold[:k], b.threshold[:k])


@pytest.mark.cuda
def test_cuda_training_matches_cpu_training():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    X, y = _data(20_000, 8, True)
    models = {}
    for dev in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 63, "device_type": dev,
             "verbosity": -1}
        models[dev] = lp.train(p, lp.Dataset(X, y, params=p), 5)
    a, b = (models[d].model_to_string().split("parameters:")[0]
            for d in ("cuda", "cpu"))
    assert a == b                     # the kernels' arithmetic is the CPU's
