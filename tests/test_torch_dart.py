"""DART: the port against the JAX package on the CPU, on both growers.

  * v1 grower (``tpu_persist_scan=false``, 8 rounds) against the JAX
    package's DART on its host (per-class) path: ``drop_rate`` 0.3, with
    ``uniform_drop``, with ``xgboost_dart_mode``, with ``max_drop`` 1; K = 3
    softmax; a validation set, whose f64 scores are held after every
    iteration's normalize. Each JAX reference run takes the retry rule of
    tests/test_torch_objectives_renew.py (:func:`against_jax`: JAX's
    caches cleared, a failed comparison held against two agreeing reruns,
    here of up to five) and runs without a race of the JAX package's host
    path (:func:`copy_leaf_values`): its ``ScoreUpdater.add_score_leaf``
    hands ``tree.leaf_value`` to an asynchronous device gather through
    ``jnp.asarray``, which on the CPU aliases the numpy array, and DART's
    next iteration negates a dropped tree's ``leaf_value`` in place
    (``_subtract_tree``). When it drops the previous iteration and that
    gather has not run yet, as on a loaded machine, the scores take the
    negated values and the later trees differ (with eight to twelve such
    processes on the machine, 7 of 78 repeats of this file's validation
    run differed from the other repeats in their process, none of 42
    with the values copied; the port's repeats were bit-identical in
    all);
  * persistent grower (``force``, 8 rounds) against the JAX package's DART
    on its fused driver with its Pallas kernels in interpret mode
    (``_persist_kernel_mode`` patched; that route engages at every
    iteration, in batches of one, so its carry is asserted live), on
    HIGGS-shaped rows and on EFB-bundled Expo-shaped rows;
  * the payload walk (ops/valid_walk.py:valid_walk_payload_plain) against
    the JAX package's ``add_score_delta`` on the same tree, bit for bit.

In every training comparison both packages drop the same iterations (the
numpy Generator seeded with drop_seed, in the same order), some iterations
drop trees, and the trees compare as tests/test_torch_multiclass.py's
(split features, children, counts, the leaf of every training row, leaf
values within its bounds, raw scores within the sum of the bounds along
each row's path). The bounds hold for DART's shrunk and renormalized
trees: every factor DART scales a tree by after the learning rate is at
most 1 in magnitude, so the learning rate bounds the tree's rate.
"""
import numpy as np
import pytest
import torch

import jax
import lightgbm_tpu as lt
from lightgbm_tpu.boosting import dart as jdart
from lightgbm_tpu.boosting import score_updater as jsu
from lightgbm_tpu.treelearner.serial import SerialTreeLearner as JaxLearner
import lightgbm_torch as lp
from lightgbm_torch.boosting import dart as pdart
from lightgbm_torch.data.synth import make_expo_like
from lightgbm_torch.ops.valid_walk import pack, valid_walk_payload_plain
from test_torch_multiclass import (BASE as MC_BASE, assert_same_models,
                                   class_data, leaf_bounds)
from test_torch_objectives_renew import same_jax_models

ROUNDS = 8
BASE = dict(MC_BASE, objective="binary", num_leaves=15, boosting="dart",
            drop_rate=0.3)


def against_jax(check, train, X, reruns=5):
    """tests/test_torch_objectives_renew.py's retry rule, with more reruns:
    check(reference) for a fresh JAX run; when it fails, JAX reruns until
    two of them agree (at most `reruns`), and the first model two runs
    agree on must pass it. (Under a fully loaded worker the JAX host path
    gave three different models in three runs; the comparison itself is
    unchanged.)"""
    try:
        return check(train())
    except AssertionError:
        pass
    runs = []
    for _ in range(reruns):
        b = train()
        agreed = next((a for a in runs if same_jax_models(a, b, X)), None)
        if agreed is not None:
            return check(agreed)
        runs.append(b)
    raise AssertionError("the JAX reference gave %d different models"
                         % (reruns + 1))


def record_drops(monkeypatch):
    """{"jax": [...], "port": [...]}: each package's dropped iterations of
    every iteration, in order."""
    drops = {"jax": [], "port": []}
    for key, cls in (("jax", jdart.DART), ("port", pdart.DART)):
        orig = cls._dropping_trees

        def wrapped(self, orig=orig, key=key):
            orig(self)
            drops[key].append(list(self.drop_index))
        monkeypatch.setattr(cls, "_dropping_trees", wrapped)
    return drops


def train_jax(params, X, y, rounds=ROUNDS, pallas=False, monkeypatch=None,
              valid=None):
    if pallas:
        monkeypatch.setattr(JaxLearner, "_persist_kernel_mode",
                            staticmethod(lambda: ("pallas", True)))
    ds = lt.Dataset(X, y)
    sets = [] if valid is None else [lt.Dataset(*valid, reference=ds)]
    bj = lt.train(dict(params), ds, rounds, valid_sets=sets)
    persist = getattr(bj._booster.tree_learner, "_persist_carry", None)
    assert (persist is not None) == (params["tpu_persist_scan"] == "force")
    return bj


def train_port(params, X, y, rounds=ROUNDS):
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, params=p), rounds)
    assert bp._booster.use_persist == (params["tpu_persist_scan"] == "force")
    return bp


def assert_same_dart(bj, bp, drops, X, K=1, mxu=False):
    assert drops["jax"] == drops["port"]
    assert sum(len(d) for d in drops["port"]) > 0, "no iteration dropped"
    assert bj.model_to_string().splitlines()[0] == "dart"
    assert bp.model_to_string().splitlines()[0] == "dart"
    assert_same_models(bj, bp, X, BASE["learning_rate"], K, mxu=mxu)


V1 = {"drop_rate": {}, "uniform_drop": {"uniform_drop": True},
      "xgboost_dart_mode": {"xgboost_dart_mode": True},
      "max_drop 1": {"max_drop": 1}}


def copy_leaf_values(mp):
    """The JAX package's ScoreUpdater.add_score_leaf given a copy of the
    leaf values (the module docstring: the asynchronous gather then reads
    the values the call was made with, whatever DART does to the tree
    afterwards)."""
    add = jsu.ScoreUpdater.add_score_leaf

    def copied(self, leaf_values, row_leaf, tree_id):
        return add(self, np.array(leaf_values, copy=True), row_leaf,
                   tree_id)
    mp.setattr(jsu.ScoreUpdater, "add_score_leaf", copied)


def jax_v1_run(params, X, y):
    """A fresh JAX host-path run (caches cleared, the module docstring's
    retry rule, the leaf values copied) with its dropped iterations in
    ``bj.drops``."""
    jax.clear_caches()
    with pytest.MonkeyPatch.context() as mp:
        copy_leaf_values(mp)
        drops = record_drops(mp)
        bj = train_jax(params, X, y)
        bj.drops = list(drops["jax"])
    return bj


def port_v1_run(params, X, y):
    with pytest.MonkeyPatch.context() as mp:
        drops = record_drops(mp)
        bp = train_port(params, X, y)
        bp.drops = list(drops["port"])
    return bp


@pytest.mark.parametrize("name", sorted(V1))
def test_v1_matches_jax_host_path(name):
    params = dict(BASE, tpu_persist_scan="false", **V1[name])
    X, y = class_data(n=3000, K=2, seed=4)
    bp = port_v1_run(params, X, y)
    assert len(bp._booster.models) == ROUNDS
    against_jax(lambda bj: assert_same_dart(
        bj, bp, {"jax": bj.drops, "port": bp.drops}, X),
        lambda: jax_v1_run(params, X, y), X)


def test_v1_multiclass_matches_jax():
    # 7 leaves a class tree, as tests/test_torch_multiclass.py grows them
    params = dict(BASE, tpu_persist_scan="false", objective="multiclass",
                  num_class=3, num_leaves=7)
    X, y = class_data(n=3000, K=3, seed=5)
    bp = port_v1_run(params, X, y)
    against_jax(lambda bj: assert_same_dart(
        bj, bp, {"jax": bj.drops, "port": bp.drops}, X, 3),
        lambda: jax_v1_run(params, X, y), X)


def _valid_run(lib, params, Xt, yt, Xv, yv):
    """A Booster of `lib` with the held-out set, trained ROUNDS updates;
    ``b.steps`` holds each iteration's (dropped iterations, validation
    scores, and for the JAX package the leaf-bound slack of its trees as
    they stand after that iteration's normalize)."""
    with pytest.MonkeyPatch.context() as mp:
        if lib is lt:
            jax.clear_caches()
            copy_leaf_values(mp)
            ds = lt.Dataset(Xt, yt)
            b = lt.Booster(dict(params), ds)
            b.add_valid(lt.Dataset(Xv, yv, reference=ds), "v")
        else:
            p = dict(params, device_type="cpu")
            ds = lp.Dataset(Xt, yt, params=p)
            b = lp.Booster(p, ds)
            b.add_valid(lp.Dataset(Xv, yv, reference=ds), "v")
        b.steps = []
        for _ in range(ROUNDS):
            b.update()
            g = b._booster
            if lib is lt:
                sc = np.array(g.valid_score[0].score_host()).reshape(-1)
                slack = np.zeros(len(yv))
                for a in g._used_models():
                    if a.num_leaves > 1:
                        slack += leaf_bounds(a, len(yt),
                                             params["learning_rate"],
                                             False)[a.predict_leaf(Xv)]
            else:
                sc, slack = g.valid_score[0].score.numpy().copy(), None
            b.steps.append((list(g.drop_index), sc, slack))
    return b


def test_v1_valid_scores_match_jax_after_every_normalize():
    """Iteration by iteration (Booster.update): the f64 validation scores
    of both packages agree within the sum, along each held-out row's path,
    of the leaf bounds of the trees as they stand after that iteration's
    normalize (the JAX trees are renormalized in place)."""
    params = dict(BASE, tpu_persist_scan="false", metric="binary_logloss",
                  verbosity=-1)
    X, y = class_data(n=3500, K=2, seed=6)
    Xt, yt, Xv, yv = X[:3000], y[:3000], X[3000:], y[3000:]
    bp = _valid_run(lp, params, Xt, yt, Xv, yv)
    assert sum(len(d) for d, _, _ in bp.steps) > 0

    def check(bj):
        for it, ((dj, sj, slack), (dp, sp, _)) in enumerate(
                zip(bj.steps, bp.steps)):
            assert dj == dp, it
            assert np.all(np.abs(sp - sj) <= slack + 1e-12), it
        assert_same_models(bj, bp, Xt, params["learning_rate"], 1)
    against_jax(check, lambda: _valid_run(lt, params, Xt, yt, Xv, yv), Xt)


PERSIST = {"higgs": 3000, "expo bundled": 2048}


@pytest.mark.parametrize("shape", sorted(PERSIST))
def test_persist_matches_jax_fused_driver(shape, monkeypatch):
    n = PERSIST[shape]
    if shape == "higgs":
        X, y = class_data(n=n, K=2, seed=7)
        params = dict(BASE, tpu_persist_scan="force")
    else:
        # make_expo_like at seed 0 has no exact ties between one-hot
        # features (tests/test_torch_level.py:_expo)
        X, y = make_expo_like(n, seed=0)
        params = dict(BASE, tpu_persist_scan="force", max_bin=31,
                      min_data_in_leaf=10)
    drops = record_drops(monkeypatch)
    bj = train_jax(params, X, y, pallas=True, monkeypatch=monkeypatch)
    bp = train_port(params, X, y)
    gr = bp._booster.tree_learner._persist_gr
    assert (gr.blocks is not None) == (shape != "higgs")
    assert_same_dart(bj, bp, drops, X, mxu=True)
    # the scores the payload holds are the trees' (one f32 add per walk)
    raw = bp.predict(X, raw_score=True)
    adds = ROUNDS + 2 * sum(len(d) for d in drops["port"])
    tol = 2 * adds * np.finfo(np.float32).eps * max(1.0, np.abs(raw).max())
    assert np.abs(bp._booster.train_score.score.numpy() - raw).max() <= tol


def test_payload_walk_matches_add_score_delta(monkeypatch):
    """A tree of the JAX package's persistent run, shrunk by -1/3, walked
    onto a copy of its payload: the port's plain payload walk (the tree
    read from the JAX model text, its node records from the port's
    Dataset, bound to it) against the JAX add_score_delta of the tree's row-ordered
    predict_binned delta, the score row bit for bit; the lanes past n are
    left alone."""
    import jax.numpy as jnp
    params = dict(BASE, tpu_persist_scan="force")
    X, y = class_data(n=2000, K=2, seed=8)
    bj = train_jax(params, X, y, 2, True, monkeypatch)
    bj._booster._materialize_pending()
    learner = bj._booster.tree_learner
    gr, pay = learner._persist_gr, np.asarray(learner._persist_carry)
    jtree = bj._booster.models[1]
    jtree.shrink(-1.0 / 3.0)
    delta = jtree.predict_binned(bj._booster.train_data)
    want = np.asarray(gr.add_score_delta(jnp.asarray(pay),
                                         jnp.asarray(delta)))
    p = dict(params, device_type="cpu")
    inner = lp.Dataset(X, y, params=p).construct()._inner
    ptree = lp.Booster(model_str=bj.model_to_string())._booster.models[1] \
        .bind_to_dataset(inner)
    assert ptree.num_leaves > 1
    np.testing.assert_array_equal(ptree.leaf_value, jtree.leaf_value)
    pt = pack([ptree], [ptree.leaf_value[:ptree.num_leaves]], inner,
              "cpu")[0]
    got = torch.as_tensor(pay.view(np.int32)).clone()
    nbw, n = gr.nbw, gr.n
    bins = inner.to_device("cpu").bins
    valid_walk_payload_plain(bins, got[nbw + 1], pt.nodes, pt.leaves,
                             got[nbw + 4].view(torch.float32), n, pt.words)
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[nbw + 4, :n],
                                  want[nbw + 4, :n])
    np.testing.assert_array_equal(got.numpy().view(np.uint32)[nbw + 4, n:],
                                  pay[nbw + 4, n:])
    assert not np.array_equal(want[nbw + 4, :n], pay[nbw + 4, :n])


def test_dart_routes_like_gbdt(monkeypatch):
    """DART takes the grower GBDT takes (auto on the card from 65536 rows:
    the persistent one), and the stop rule of the JAX path that runs: the
    fast path's on the persistent grower, the per-class path's on v1."""
    from lightgbm_torch.treelearner import serial
    X, y = class_data(n=1000, K=2, seed=1)
    p = dict(BASE, device_type="cpu", tpu_persist_scan="false")
    gb = lp.Booster(p, lp.Dataset(X, y, params=p))._booster
    assert not gb._fast_path()
    learner = gb.tree_learner
    learner.config.tpu_persist_scan = "auto"
    monkeypatch.setattr(serial, "PARTITION_MIN_ROWS", 0)
    monkeypatch.setattr(learner, "device", torch.device("cuda"))
    assert learner.can_persist_scan(gb.objective)
    p = dict(p, tpu_persist_scan="force")
    assert lp.Booster(p, lp.Dataset(X, y, params=p))._booster._fast_path()
