"""Training with bagging and GOSS: the port against the JAX package on the
CPU, on each grower with the sampling the JAX package runs there.

  * v1 grower (``tpu_persist_scan=false``, 5 iterations) against the JAX
    per-iteration path: the host draws (a numpy Generator from
    bagging_seed; GOSS's np.partition threshold and drawn rest), the
    gradients times the bag's weights, in-bag counts. Bagging (fraction
    0.7, freq 2), balanced bagging, GOSS (learning_rate 0.5: sampling from
    iteration 2), multiclass GOSS (K = 3) and L1 with bagging (the leaves
    renewed from in-bag rows; the JAX per-class path it takes is not
    deterministic on the CPU, so tests/test_torch_objectives_renew.py's
    retry rule holds the comparison);
  * persistent grower (``force``, 16 rounds) against the JAX fused driver
    with its Pallas kernels in interpret mode (its persistent path engages
    only in batches of 16 iterations, so the carry is asserted live): the
    device bag step (the row hash at the window key; GOSS's exact k-th
    largest |g * h| and Bernoulli rest), the leaf counts from the scan's
    hessian-derived counts. Bagging, GOSS and bagging with K = 3.

Trees are compared as in tests/test_torch_multiclass.py (split features,
children, internal and leaf counts, the leaf each training row reaches,
leaf values within its bounds, every |grad| at most the GOSS amplification
where GOSS multiplies it), by :func:`assert_same_bagged`, with two known
differences that a bag exposes:
  * out-of-bag rows. They ride the partition with zero gradients, so bins
    that hold only out-of-bag rows give equal gains on either side of
    them, and the packages' rounding picks the threshold and the NaN
    direction (ROADMAP.md C5). The in-bag rows reach the same leaves; an
    out-of-bag row may reach another, its score moves another way, and the
    later iterations (GOSS ranks every row by |g * h|; a bag window draws
    new rows) see other inputs. So the comparison holds the leaves of the
    tree's in-bag rows, and stops after a tree where an out-of-bag row's
    leaf differs;
  * hessian-derived counts (persistent grower only; ROADMAP.md C10). Under
    a bag its counts are the scan's (each bin's round(hess * count /
    sum_hess), summed), and a bin whose product lies within the
    histograms' rounding of a half rounds the other way in the JAX
    Pallas reference, whose histograms sum in another order and carry the
    MXU hi/lo split's error: a count may differ by up to COUNT_SLACK, and
    where one sits at min_data_in_leaf the packages can take another
    split. The comparison stops at a tree whose first differing split has
    a child within the slack of min_data_in_leaf in either package.
At least half of the trees must be held equal. Then the routing: GOSS
with K > 1 and a renewal objective with a bag raise under ``force`` and
take v1 under ``auto``, and so does RF beyond the JAX fused RF gate. Then
``reset_parameter`` on the bagging keys.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.ops import bag
from lightgbm_torch.treelearner import serial
from lightgbm_torch.utils.log import LightGBMError
from test_torch_multiclass import (BASE as MC_BASE, ROUNDS,
                                   assert_same_models, class_data,
                                   leaf_bounds, train_jax, train_port)
from test_torch_objectives_renew import (against_jax, reg_data,
                                         train_jax_fresh)

BASE = dict(MC_BASE, objective="binary")
GOSS = {"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.2,
        "other_rate": 0.1}
# GOSS multiplies the rest's gradients by (1 - top_rate) / other_rate
GOSS_AMP = 8.0

# the largest difference of a hessian-derived count of the persistent
# grower's bagged trees to the JAX Pallas reference taken as rounding
COUNT_SLACK = 2


def _near_min_data(tree, j, min_data):
    """Does split j of `tree` have a child whose count is within
    COUNT_SLACK of min_data?"""
    kids = [tree.leaf_count[~c] if c < 0 else tree.internal_count[c]
            for c in (tree.left_child[j], tree.right_child[j])]
    return any(abs(int(k) - min_data) <= COUNT_SLACK for k in kids)


def record_bags(monkeypatch, persist: bool, n: int):
    """A list that collects the [n] bool in-bag rows of every tree the port
    grows: the v1 grower's bag mask (all rows without one); on the
    persistent grower the rows whose hessian the bag step left nonzero."""
    bags = []
    if persist:
        from lightgbm_torch.ops.grow_persist import PersistGrower
        step = PersistGrower.bag_step

        def bag_step(self, pay):
            step(self, pay)
            rid = pay[self.nbw + 1, :self.n].to(torch.int64)
            m = torch.zeros(self.n, dtype=torch.bool)
            m[rid] = self._f32_row(pay, self.nbw + 3)[:self.n] != 0
            bags.append(m.numpy())
        monkeypatch.setattr(PersistGrower, "bag_step", bag_step)
    else:
        arrays = serial.SerialTreeLearner.train_arrays

        def train_arrays(self, grad, hess, bag=None):
            bags.append(np.ones(n, bool) if bag is None else bag.numpy())
            return arrays(self, grad, hess, bag)
        monkeypatch.setattr(serial.SerialTreeLearner, "train_arrays",
                            train_arrays)
    return bags


def assert_same_bagged(bj, bp, X, lr, K, gmax, bags, slack=0,
                       min_data=None):
    """The port's bagged trees against the JAX package's by the module's
    rules; `bags` the port's in-bag rows of each tree (record_bags),
    `slack` the counts' tolerance (0 on v1). Returns the number of trees
    held equal."""
    ref, mine = bj._booster._used_models(), bp._booster.models
    assert len(ref) == len(mine) == len(bags)
    n = X.shape[0]
    for i, (a, b) in enumerate(zip(ref, mine)):
        k = min(a.num_leaves, b.num_leaves) - 1
        same = list(a.split_feature[:k] == b.split_feature[:k])
        if a.num_leaves != b.num_leaves or not all(same):
            # the first split record that differs (a later split changes
            # the children arrays of earlier records)
            j = same.index(False) if not all(same) else k
            assert min_data is not None and (
                j < a.num_leaves - 1 and _near_min_data(a, j, min_data)
                or j < b.num_leaves - 1 and _near_min_data(b, j, min_data)), \
                "tree %d differs at split %d" % (i, j)
            return i
        for f in ("left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k])
        for f, m in (("internal_count", k), ("leaf_count", k + 1)):
            d = np.abs(getattr(a, f)[:m].astype(np.int64)
                       - getattr(b, f)[:m])
            assert d.max(initial=0) <= slack, (f, i, d)
        la, lb = a.predict_leaf(X), b.predict_leaf(X)
        np.testing.assert_array_equal(la[bags[i]], lb[bags[i]])
        bound = leaf_bounds(a, n, lr, slack > 0, gmax)
        assert np.all(np.abs(b.leaf_value[:k + 1] - a.leaf_value[:k + 1])
                      <= bound), i
        if not np.array_equal(la, lb):
            return i + 1
    return len(ref)


V1 = {
    "bagging": ({"bagging_fraction": 0.7, "bagging_freq": 2}, 1, 1.0),
    "balanced": ({"pos_bagging_fraction": 0.8, "neg_bagging_fraction": 0.4,
                  "bagging_freq": 1}, 1, 1.0),
    "goss": (GOSS, 1, GOSS_AMP),
    "goss multiclass": (dict(GOSS, objective="multiclass", num_class=3), 3,
                        GOSS_AMP),
}


@pytest.mark.parametrize("name", sorted(V1))
def test_v1_matches_jax(name, monkeypatch):
    extra, K, gmax = V1[name]
    params = dict(BASE, tpu_persist_scan="false", **extra)
    X, y = class_data(n=4000, K=max(K, 2), seed=4)
    bj = train_jax(params, X, y, 5)
    bags = record_bags(monkeypatch, False, len(y))
    bp = train_port(params, X, y, 5)
    assert not bp._booster.use_persist
    assert len(bp._booster.models) == 5 * K
    held = assert_same_bagged(bj, bp, X, params["learning_rate"], K, gmax,
                              bags)
    assert held >= 5 * K // 2
    # the roots count the rows in the bag
    n = len(y)
    roots = [t.internal_count[0] for t in bp._booster.models]
    if name.startswith("goss"):
        assert roots[:2 * K] == [n] * (2 * K) and max(roots[2 * K:]) < n
    else:
        assert max(roots) < n


def test_v1_l1_with_bagging_matches_jax():
    """L1's leaves are the medians of the in-bag rows' residuals: equal
    to the JAX package's bit for bit."""
    params = dict(BASE, objective="regression_l1", tpu_persist_scan="off",
                  bagging_fraction=0.6, bagging_freq=1)
    X, y = reg_data("regression_l1")
    bp = train_port(params, X, y, 5)
    assert not bp._booster.use_persist

    def check(bj):
        assert_same_models(bj, bp, X, params["learning_rate"], 1)
        for a, b in zip(bj._booster._used_models(), bp._booster.models):
            k = a.num_leaves
            np.testing.assert_array_equal(a.leaf_value[:k], b.leaf_value[:k])
        np.testing.assert_array_equal(bp.predict(X, raw_score=True),
                                      bj.predict(X, raw_score=True))
    against_jax(check, lambda: train_jax_fresh(params, X, y, 5), X)


PERSIST = {
    "bagging": ({"bagging_fraction": 0.8, "bagging_freq": 5}, 1, 1.0, 3000),
    "goss": (GOSS, 1, GOSS_AMP, 3000),
    "bagging multiclass": ({"bagging_fraction": 0.7, "bagging_freq": 3,
                            "objective": "multiclass", "num_class": 3}, 3,
                           1.0, 2000),
}


@pytest.mark.parametrize("name", sorted(PERSIST))
def test_persist_matches_jax_fused_driver(name, monkeypatch):
    extra, K, gmax, n = PERSIST[name]
    params = dict(BASE, tpu_persist_scan="force", **extra)
    X, y = class_data(n=n, K=max(K, 2), seed=6)
    bj = train_jax(params, X, y, ROUNDS, True, monkeypatch)
    bags = record_bags(monkeypatch, True, n)
    bp = train_port(params, X, y, ROUNDS)
    assert len(bp._booster.models) == ROUNDS * K
    held = assert_same_bagged(bj, bp, X, params["learning_rate"], K, gmax,
                              bags, COUNT_SLACK, params["min_data_in_leaf"])
    assert held >= ROUNDS * K // 2
    roots = [t.internal_count[0] for t in bp._booster.models]
    if name == "goss":
        assert roots[:2] == [n] * 2 and max(roots[2:]) < n
    else:
        # one bag per window, and per iteration for all classes
        freq = extra["bagging_freq"]
        per_it = [roots[i * K:(i + 1) * K] for i in range(ROUNDS)]
        assert all(len(set(r)) == 1 for r in per_it)
        firsts = [r[0] for r in per_it]
        assert all(firsts[i] == firsts[i - i % freq] for i in range(ROUNDS))
        assert len(set(firsts)) > 1 and max(firsts) < n
    gr = bp._booster.tree_learner._persist_gr
    assert gr.k.bagged == 1 and gr.bag is not None


def _learner(params, X, y):
    p = dict(BASE, device_type="cpu", tpu_persist_scan="false", **params)
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    return bst._booster


@pytest.mark.parametrize("name,extra,persist", [
    ("goss", dict(GOSS), True),
    ("bagging", {"bagging_fraction": 0.5, "bagging_freq": 1}, True),
    ("goss multiclass", dict(GOSS, objective="multiclass", num_class=3),
     False),
    ("bagging multiclass", {"bagging_fraction": 0.5, "bagging_freq": 1,
                            "objective": "multiclass", "num_class": 3}, True),
    ("l1 bagging", {"objective": "regression_l1", "bagging_fraction": 0.5,
                    "bagging_freq": 1}, False),
    ("quantile goss", dict(GOSS, objective="quantile"), False),
    ("l1", {"objective": "regression_l1"}, True),
])
def test_auto_routing_on_the_card(name, extra, persist, monkeypatch):
    """tpu_persist_scan=auto as on the card with enough rows: GOSS with K >
    1 and a renewal objective with a bag take v1, the rest the
    persistent grower."""
    X, y = class_data(n=1000, K=extra.get("num_class", 2), seed=1)
    gb = _learner(extra, X, y)
    learner = gb.tree_learner
    learner.config.tpu_persist_scan = "auto"
    monkeypatch.setattr(serial, "PARTITION_MIN_ROWS", 0)
    monkeypatch.setattr(learner, "device", torch.device("cuda"))
    assert learner.can_persist_scan(gb.objective) == persist


@pytest.mark.parametrize("extra,item", [
    (dict(GOSS, objective="multiclass", num_class=3), "item 23"),
    (dict(GOSS, objective="multiclassova", num_class=3), "item 23"),
    ({"objective": "regression_l1", "bagging_fraction": 0.5,
      "bagging_freq": 1}, "item 24"),
    ({"objective": "quantile", "pos_bagging_fraction": 0.5,
      "bagging_freq": 1}, "item 24"),
    (dict(GOSS, objective="mape"), "item 24"),
    # RF beyond the JAX fused RF gate: K > 1, an init score
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
      "objective": "multiclass", "num_class": 3}, "item 25"),
    ({"boosting": "rf", "bagging_fraction": 0.5, "bagging_freq": 1,
      "init_score": 0.25}, "item 25"),
])
def test_refused_routes(extra, item):
    extra = dict(extra)
    init = extra.pop("init_score", None)
    X, y = class_data(n=800, K=extra.get("num_class", 2), seed=2)
    if extra.get("objective") == "mape":
        y = y + 1.0
    p = dict(BASE, device_type="cpu", tpu_persist_scan="force", **extra)
    with pytest.raises(LightGBMError, match="ROADMAP.md queue A, %s" % item):
        lp.train(p, lp.Dataset(X, y, params=p, init_score=None if init is None
                                else np.full(len(y), init)), 1)


def test_reset_bagging_matches_jax_v1():
    """reset_parameter on the bagging keys (a list per iteration) on the v1
    grower: the JAX package's ResetBaggingConfig (a fresh Generator, a
    redraw at the next iteration), the same trees."""
    params = dict(BASE, tpu_persist_scan="false", bagging_fraction=0.7,
                  bagging_freq=2)
    X, y = class_data(n=3000, K=2, seed=8)
    sched = {"bagging_fraction": [0.7, 0.7, 0.5, 0.5, 0.9],
             "bagging_seed": [5, 5, 5, 11, 11]}
    bj = lt.train(dict(params), lt.Dataset(X, y), 5,
                  callbacks=[lt.reset_parameter(**sched)])
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, params=p), 5,
                  callbacks=[lp.reset_parameter(**sched)])
    assert_same_models(bj, bp, X, params["learning_rate"], 1)


def test_reset_bagging_on_the_persistent_grower():
    """On the persistent grower the bag's fraction and key are device
    scalars: after a reset the next iterations bag with the new fraction
    (the root counts the rows whose hash at the window key is below it),
    the earlier ones are unchanged; turning the bag off drops the bag step;
    a binning key still raises."""
    X, y = class_data(n=3000, K=2, seed=9)
    base = dict(BASE, device_type="cpu", tpu_persist_scan="force",
                bagging_fraction=0.8, bagging_freq=1, bagging_seed=3)
    ds = lp.Dataset(X, y, params=base)
    ref = lp.train(dict(base), ds, 2)
    sched = {"bagging_fraction": [0.8, 0.8, 0.4, 0.4, 1.0]}
    bst = lp.train(dict(base), lp.Dataset(X, y, params=base), 5,
                   callbacks=[lp.reset_parameter(**sched)])
    b = bst._booster
    assert b.use_persist
    a, r = b.models[:2], ref._booster.models
    for t, u in zip(a, r):
        np.testing.assert_array_equal(t.leaf_value, u.leaf_value)
    rid = torch.arange(len(y))
    for it in (2, 3):
        k0, k1 = bag.window_key(3, it)
        want = int((bag.hash_uniform_plain(rid, k0, k1)
                    < np.float32(0.4)).sum())
        assert b.models[it].internal_count[0] == want
    assert b.models[4].internal_count[0] == len(y)
    assert b.tree_learner._persist_gr.k.bagged == 0
    with pytest.raises(LightGBMError, match="cannot change during "
                                            "training"):
        bst._booster.reset_config({"max_bin": 31})
