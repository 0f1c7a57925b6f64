"""Between iterations: rollback_one_iter and the split keys of
reset_parameter, on both growers, against the JAX package on the CPU.

- ``rollback_one_iter`` on the v1 grower: the model text equals the
  shorter run's, the f64 training and validation scores equal the walk of
  the remaining trees within 1e-12 (one f64 add and one f64 subtraction
  per row and tree), and the rolled-back model agrees with the JAX
  package's rolled-back model as tests/test_torch_multiclass.py compares
  models. On the persistent grower (``force``; K = 1 and K = 3): the model
  text equals the shorter run's and the payload's f32 scores equal the
  walk within 2 (iterations + 2) f32 ulps of the largest score (each add
  and the subtraction round once), the grower's statistics lose the
  trees, and the model agrees with the JAX package's rolled-back model
  (its host path). A rollback at iteration 0 does nothing; one more update
  grows a tree; an averaged (RF) model refuses.
- ``reset_parameter`` with split keys, as schedules (tests/test_params.py:
  247-362 of the JAX package): on the v1 grower against the JAX package's
  trees (a schedule of the scalar keys, one of num_leaves, max_depth,
  lambda_l1, max_delta_step and feature_fraction); on the persistent
  grower against the JAX package's host path and the port's own v1 run of
  the same schedule (the JAX package's fused driver applies a reset only
  at its next 16-iteration batch), with the grower rebuilt for a new leaf
  budget and its step constants rebuilt for new scalars; under ``auto`` a
  reset that turns on a knob moves training to the v1 grower (scores
  synced first) and back; under ``force`` it raises (ROADMAP.md queue A,
  item 4, step 1c) and leaves the booster as it was, so the next update
  grows the tree it would have grown without the reset; a key that shapes
  the binning still raises. ``auto`` takes the persistent grower on the CPU here by
  patching the learner's device-and-size gate.
"""
import numpy as np
import pytest

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.treelearner.serial import SerialTreeLearner
from lightgbm_torch.utils.log import LightGBMError
from test_torch_multiclass import BASE, assert_same_models, class_data

CPU = {"device_type": "cpu"}
EPS32 = float(np.finfo(np.float32).eps)
ROUNDS = 5


def _text(bst, **kw):
    return bst.model_to_string(**kw).split("parameters:")[0]


def _port(params, X, y, rounds, valid=None):
    p = dict(params, **CPU)
    ds = lp.Dataset(X, y, params=p)
    bst = lp.Booster(p, ds)
    if valid is not None:
        bst.add_valid(lp.Dataset(*valid, reference=ds), "v")
    for _ in range(rounds):
        bst.update()
    return bst


def _f32_bound(bst, raw, rounds):
    return 2 * (rounds + 2) * EPS32 * max(1.0, np.abs(raw).max())


def test_rollback_v1_matches_shorter_run_and_jax():
    params = dict(BASE, objective="binary", num_leaves=15,
                  tpu_persist_scan="false")
    X, y = class_data(n=3500, K=2, seed=31)
    Xt, yt, Xv, yv = X[:3000], y[:3000], X[3000:], y[3000:]
    bp = _port(params, Xt, yt, ROUNDS, (Xv, yv))
    bp.rollback_one_iter()
    assert bp.current_iteration() == ROUNDS - 1
    assert _text(bp) == _text(_port(params, Xt, yt, ROUNDS - 1))
    g = bp._booster
    np.testing.assert_allclose(g.train_score.score.numpy(),
                               bp.predict(Xt, raw_score=True), rtol=0,
                               atol=1e-12)
    np.testing.assert_allclose(g.valid_score[0].score.numpy(),
                               bp.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-12)
    bj = lt.train(dict(params), lt.Dataset(Xt, yt), ROUNDS)
    bj.rollback_one_iter()
    assert_same_models(bj, bp, Xt, params["learning_rate"], 1)
    assert bp.update() is False and bp.num_trees() == ROUNDS


@pytest.mark.parametrize("K", [1, 3])
def test_rollback_persist_matches_shorter_run(K):
    obj = {"objective": "binary"} if K == 1 else \
        {"objective": "multiclass", "num_class": 3}
    params = dict(BASE, tpu_persist_scan="force", **obj)
    X, y = class_data(n=3000, K=max(K, 2), seed=32)
    bp = _port(params, X, y, ROUNDS)
    g = bp._booster
    gr = g.tree_learner._persist_gr
    assert g.use_persist and g.tree_learner._persist_carry is not None
    bp.rollback_one_iter()
    assert _text(bp) == _text(_port(params, X, y, ROUNDS - 1))
    assert len(gr.grow_stats) == (ROUNDS - 1) * K
    raw = bp.predict(X, raw_score=True)
    score = g.train_score.score.numpy()
    score = score if K == 1 else score.T
    assert np.abs(score - raw).max() <= _f32_bound(bp, raw, ROUNDS)
    # the JAX package's host path (its fused driver starts at 16 rounds)
    bj = lt.train(dict(params, tpu_persist_scan="false"),
                  lt.Dataset(X, y), ROUNDS)
    bj.rollback_one_iter()
    assert_same_models(bj, bp, X, params["learning_rate"], K)
    bp.update()
    assert bp.num_trees() == ROUNDS * K and len(gr.grow_stats) == ROUNDS * K


def test_rollback_at_iteration_zero_and_rf():
    X, y = class_data(n=1000, K=2, seed=33)
    p = dict(BASE, objective="binary", **CPU)
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    bst.rollback_one_iter()
    assert bst.num_trees() == 0
    assert np.all(bst._booster.train_score.score.numpy() == 0)
    rf = dict(p, boosting="rf", bagging_fraction=0.7, bagging_freq=1)
    b = lp.train(rf, lp.Dataset(X, y, params=rf), 2)
    with pytest.raises(LightGBMError, match="averaged"):
        b.rollback_one_iter()


SCHEDULES = {
    "scalars": {"lambda_l2": [0.0, 0.0, 1.0, 1.0, 4.0],
                "min_data_in_leaf": [20, 20, 20, 60, 60],
                "min_sum_hessian_in_leaf": [1e-3, 1e-3, 1.0, 1.0, 1.0],
                "min_gain_to_split": [1e-3, 1e-3, 1e-3, 0.05, 0.05]},
    "shape and knobs": {"num_leaves": [15, 15, 7, 7, 4],
                        "max_depth": [-1, -1, 3, 3, 2],
                        "lambda_l1": [0.0, 0.5, 0.5, 0.0, 0.0],
                        "max_delta_step": [0.0, 0.0, 0.2, 0.2, 0.0],
                        "feature_fraction": [1.0, 1.0, 0.75, 0.75, 0.75]},
}


def _scheduled(lib, params, X, y, sched):
    p = dict(params, **({} if lib is lt else CPU))
    return lib.train(p, lib.Dataset(X, y, params=p), ROUNDS,
                     callbacks=[lib.reset_parameter(**sched)])


@pytest.mark.parametrize("name", sorted(SCHEDULES))
def test_reset_schedule_v1_matches_jax(name):
    params = dict(BASE, objective="binary", num_leaves=15,
                  tpu_persist_scan="false")
    X, y = class_data(n=4000, K=2, seed=34)
    sched = SCHEDULES[name]
    bp = _scheduled(lp, params, X, y, sched)
    bj = _scheduled(lt, params, X, y, sched)
    assert_same_models(bj, bp, X, params["learning_rate"], 1, min_leaves=2)
    trees = bp._booster.models
    if "num_leaves" in sched:
        assert all(t.num_leaves <= cap for t, cap in
                   zip(trees, sched["num_leaves"]))
        assert trees[0].num_leaves == 15 and trees[-1].max_depth() <= 2
    assert bp._booster.tree_learner.params.lambda_l2 == \
        sched.get("lambda_l2", [0.0])[-1]


def test_reset_schedule_persist_matches_v1():
    """The persistent grower under a schedule of scalar keys and leaf
    budgets grows the JAX package's trees (its host path) and the port's
    v1 trees; its step constants follow each scalar reset and the grower
    is rebuilt for each new budget."""
    sched = dict(SCHEDULES["scalars"], num_leaves=[15, 15, 15, 7, 7])
    params = dict(BASE, objective="binary", num_leaves=15)
    X, y = class_data(n=4000, K=2, seed=35)
    p = dict(params, tpu_persist_scan="force", **CPU)
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    growers, consts = [], []
    for i in range(ROUNDS):
        bst.reset_parameter({k: v[i] for k, v in sched.items()})
        bst.update()
        gr = bst._booster.tree_learner._persist_gr
        growers.append(gr)
        consts.append(gr.k)
    assert bst._booster.use_persist
    assert growers[3] is not growers[2] and growers[2] is growers[0]
    assert consts[2].l2 == np.float32(1.0) and consts[3].min_data == 60
    # each grower's statistics are those of the trees it grew
    assert growers[-1].gc.num_leaves == 7 and len(growers[-1].grow_stats) \
        == 2
    host = dict(params, tpu_persist_scan="false")
    bj = _scheduled(lt, host, X, y, sched)
    assert_same_models(bj, bst, X, params["learning_rate"], 1, min_leaves=2)
    v1 = _scheduled(lp, host, X, y, sched)

    class _AsRef:
        def __init__(self, b):
            self._booster = b._booster
            self.predict = b.predict
    assert_same_models(_AsRef(v1), bst, X, params["learning_rate"], 1,
                       min_leaves=2)


def test_reset_moves_auto_to_v1_and_back(monkeypatch):
    monkeypatch.setattr(SerialTreeLearner, "_auto_takes_persist",
                        lambda self: True)
    params = dict(BASE, objective="binary", tpu_persist_scan="auto", **CPU)
    X, y = class_data(n=3000, K=2, seed=36)
    bst = lp.train(params, lp.Dataset(X, y, params=params), 3)
    g = bst._booster
    assert g.use_persist
    bst.reset_parameter({"max_delta_step": 0.2})
    assert not g.use_persist and g.tree_learner._persist_carry is None
    raw = bst.predict(X, raw_score=True)
    assert np.abs(g.train_score.score.numpy() - raw).max() \
        <= _f32_bound(bst, raw, 3)
    for _ in range(2):
        bst.update()
    # the clamped outputs, rounded to f32 by the v1 grower
    lim = 0.2 * params["learning_rate"] * (1 + 2 * EPS32)
    assert all(np.abs(t.leaf_value[:t.num_leaves]).max() <= lim
               for t in g.models[3:])
    assert np.abs(g.models[3].leaf_value).max() > 0.99 * lim
    bst.reset_parameter({"max_delta_step": 0.0})
    assert g.use_persist
    bst.update()
    assert g.tree_learner._persist_carry is not None
    raw = bst.predict(X, raw_score=True)
    assert np.abs(g.train_score.score.numpy() - raw).max() \
        <= _f32_bound(bst, raw, 6)


def test_reset_refusals():
    params = dict(BASE, objective="binary", tpu_persist_scan="force", **CPU)
    X, y = class_data(n=2000, K=2, seed=37)
    bst = lp.train(params, lp.Dataset(X, y, params=params), 2)
    g = bst._booster
    k = g.tree_learner._persist_gr.k
    with pytest.raises(LightGBMError, match="item 4, step 1c"):
        bst.reset_parameter({"lambda_l1": 1.0, "num_leaves": 15,
                             "lambda_l2": 2.0, "learning_rate": 0.5})
    assert (g.config.lambda_l1, g.config.num_leaves, g.config.lambda_l2,
            g.shrinkage_rate) == (0.0, params["num_leaves"], 0.0,
                                  params["learning_rate"])
    assert g.use_persist and not g.tree_learner.knobs
    assert g.tree_learner.params.lambda_l1 == 0.0
    gr = g.tree_learner._persist_gr
    assert gr.gc.num_leaves == params["num_leaves"] and gr.k == k
    bst.update()
    assert _text(bst) == _text(_port(params, X, y, 3))
    v1 = dict(params, tpu_persist_scan="false")
    bst = lp.train(v1, lp.Dataset(X, y, params=v1), 2)
    for key in ({"max_bin": 31}, {"objective": "regression"}):
        with pytest.raises(LightGBMError, match="cannot change during "
                                                "training"):
            bst.reset_parameter(key)
    # the categorical scan's keys reach the learner's CatScan
    bst.reset_parameter({"cat_smooth": 20.0, "max_cat_to_onehot": 8})
    assert bst._booster.config.cat_smooth == 20.0
