"""Validation sets, metrics in training, early stopping and the callbacks:
the port against the JAX package on the CPU.

- Binning: a validation set binned with ``reference=`` gets the JAX
  package's bins and layout, on HIGGS-shaped rows with NaN (also with
  zero_as_missing) and on Expo-shaped EFB-bundled rows.
- The walk: the plain binned walk (models/tree.py) gives the JAX package's
  ``Tree.predict_binned`` leaves and scores bit for bit, on the same trees
  over the same validation bins.
- ``train`` with ``valid_sets=[train, valid]``, two metrics, early stopping
  and ``evals_result`` against ``lightgbm_tpu.train`` on the v1 route
  (tests/test_torch_train.py's route). The packages' raw scores agree
  within 1e-4 (f32 against f64 leaf sums, tests/test_torch_train.py:1-16),
  so a logloss (|d loss / d score| <= 1 per row) agrees within 1e-4, and an
  AUC within the share of (positive, negative) pairs whose scores lie
  within 2e-4 of each other. Record lengths and best_iteration must be
  equal; the test asserts that every improvement decision of the JAX
  run's early stopping is farther than 2e-4 from a tie, so that the
  tolerance cannot flip it.
- On the persistent route (``tpu_persist_scan=force``) every recorded
  value equals, within 1e-12 relative, the JAX package's numpy metric of
  the port's own scores: ``predict(Xv, raw_score=True, num_iteration=i)``
  for the validation set and the training scores after iteration i; and
  the trees equal those of the same run without validation.
- The callbacks: the print format, ``record_evaluation``, a user
  callback's ``CallbackEnv`` and stages, early stopping's decisions
  (``first_metric_only``, the training-only stream) against the JAX
  package's callback on the same result streams, and
  ``reset_parameter(learning_rate=[...])``'s trees against the JAX
  package's.
- The stop rule with a validation set (the JAX package's per-class path):
  binary, multiclass and regression runs that stop splitting keep
  evaluating every round, with the JAX package's trees and records.
"""
import re

import jax
import numpy as np
import pytest

import lightgbm_tpu as lt
from lightgbm_tpu import callback as jcb
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import BinnedDataset as JBinned
from lightgbm_tpu.data.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.models.tree import Tree as JTree
from lightgbm_tpu.objectives import create_objective as jobjective
import lightgbm_torch as lp
from lightgbm_torch import callback as pcb
from lightgbm_torch.config import Config as PConfig
from lightgbm_torch.data.dataset import BinnedDataset as PBinned
from lightgbm_torch.data.synth import make_expo_like, make_higgs_like
from lightgbm_torch.models.tree import Tree as PTree
from lightgbm_torch.utils.log import LightGBMError, Log
from test_torch_multiclass import BASE, assert_same_models, class_data
from test_torch_objectives_renew import same_jax_models
from test_torch_regression import reg_data
from test_torch_train import _assert_same_trees
from test_torch_train import _data as train_data

TOL = 1e-4          # raw scores, v1 route (tests/test_torch_train.py)
LAYOUT = ("group_of", "group_offset", "bin_start", "bin_end",
          "most_freq_bin", "default_bin", "missing_type_arr", "needs_fix",
          "total_bins")


def higgs_rows(n, seed, f=10, missing=0.05, noise=0.0):
    X, y = make_higgs_like(n, seed=seed)
    X = X[:, :f].copy()
    rng = np.random.default_rng(seed)
    X[rng.random(X.shape) < missing] = np.nan
    X[rng.random(n) < 0.3, 1] = 0.0
    if noise:
        y = np.where(rng.random(n) < noise, 1.0 - y, y)
    return X, y


# ---- binning ---------------------------------------------------------------

def _bin_both(X, Xv, params):
    pt = PBinned.from_matrix(X, PConfig(dict(params)))
    jt = JBinned.from_matrix(X, JConfig(dict(params)))
    pv = PBinned.from_matrix(Xv, PConfig(dict(params)), reference=pt)
    jv = JBinned.from_matrix(Xv, JConfig(dict(params)), reference=jt)
    return pt, jt, pv, jv


@pytest.mark.parametrize("data", ["higgs", "higgs zero_as_missing", "expo"])
def test_validation_bins_match_jax(data):
    if data == "expo":
        X, _ = make_expo_like(3000, seed=1)
        Xv, _ = make_expo_like(1500, seed=2)
        params = {"max_bin": 255}
    else:
        X, _ = higgs_rows(3000, 3)
        Xv, _ = higgs_rows(1500, 4)
        params = {"max_bin": 63,
                  "zero_as_missing": data.endswith("missing")}
    pt, jt, pv, jv = _bin_both(X, Xv, params)
    assert pv.groups == jv.groups == pt.groups
    assert (len(pv.groups) < pv.num_features) == (data == "expo")
    for attr in LAYOUT:
        np.testing.assert_array_equal(getattr(pv, attr), getattr(jv, attr),
                                      attr)
    np.testing.assert_array_equal(pv.binned, jv.binned)
    assert pv.binned.dtype == np.uint8 and pv.binned.shape == (len(Xv),
                                                               len(pv.groups))


# ---- the walk --------------------------------------------------------------

_TREE_FIELDS = ("split_feature_inner", "split_feature", "threshold_in_bin",
                "threshold", "decision_type", "left_child", "right_child",
                "leaf_value")


def _copy_tree(src, cls):
    dst = cls(max(src.num_leaves, 2))
    dst.num_leaves = src.num_leaves
    for f in _TREE_FIELDS:
        setattr(dst, f, np.array(getattr(src, f), copy=True))
    return dst


def _assert_walks_equal(jtrees, ptrees, jv, pv):
    leaves = set()
    for a, b in zip(jtrees, ptrees):
        if a.num_leaves > 1:
            la, lb = a.predict_leaf_binned(jv), b.predict_leaf_binned(pv)
            np.testing.assert_array_equal(la, lb)
            leaves.update(np.unique(la).tolist())
        sa, sb = a.predict_binned(jv), b.predict_binned(pv)
        assert np.array_equal(sa, sb)
    assert len(leaves) > 4


def test_plain_walk_matches_jax_predict_binned_higgs():
    X, y = higgs_rows(4000, 3)
    Xv, _ = higgs_rows(2000, 4)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "verbosity": -1}
    jds = lt.Dataset(X, y, params=params, free_raw_data=False)
    bj = lt.train(dict(params), jds, 3)
    jtrees = bj._booster._used_models()
    jv = JBinned.from_matrix(Xv, JConfig(dict(params)),
                             reference=jds._inner)
    pt = PBinned.from_matrix(X, PConfig(dict(params)))
    pv = PBinned.from_matrix(Xv, PConfig(dict(params)), reference=pt)
    ptrees = [_copy_tree(t, PTree) for t in jtrees]
    assert any((t.decision_type[:t.num_leaves - 1] >> 2 == 2).any()
               for t in jtrees)           # NaN-typed nodes are walked
    _assert_walks_equal(jtrees, ptrees, jv, pv)


def test_plain_walk_matches_jax_predict_binned_expo():
    X, y = make_expo_like(2048, seed=0)
    Xv, _ = make_expo_like(1024, seed=5)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 255,
              "tpu_persist_scan": "force", "device_type": "cpu",
              "verbosity": -1}
    bp = lp.train(dict(params), lp.Dataset(X, y, params=params), 3)
    pt = bp._booster.train_data
    assert pt.has_bundles
    ptrees = bp._booster.models
    pv = PBinned.from_matrix(Xv, PConfig(dict(params)), reference=pt)
    jt = JBinned.from_matrix(X, JConfig(dict(params)))
    jv = JBinned.from_matrix(Xv, JConfig(dict(params)), reference=jt)
    assert any(pt.needs_fix[t.split_feature_inner[:t.num_leaves - 1]].any()
               for t in ptrees)           # bundled features are walked
    _assert_walks_equal([_copy_tree(t, JTree) for t in ptrees], ptrees,
                        jv, pv)


# ---- train against the JAX package ----------------------------------------

def _train(pkg, params, X, y, Xv, yv, rounds, **kw):
    dt = pkg.Dataset(X, y, params=dict(params))
    dv = pkg.Dataset(Xv, yv, reference=dt, params=dict(params))
    rec = {}
    bst = pkg.train(dict(params), dt, rounds, valid_sets=[dt, dv],
                    evals_result=rec, verbose_eval=False, **kw)
    return bst, rec


def _near_pair_share(score, label, tol):
    """The share of (positive, negative) pairs whose scores differ by at
    most tol: what an AUC can move when every score moves by tol / 2."""
    pos, neg = np.sort(score[label > 0]), np.sort(score[label <= 0])
    lo = np.searchsorted(neg, pos - tol, side="left")
    hi = np.searchsorted(neg, pos + tol, side="right")
    return float((hi - lo).sum()) / (len(pos) * len(neg))


def test_early_stopping_matches_jax_v1():
    """The JAX run takes its per-class path (a validation set), which is
    not deterministic on the CPU (ROADMAP.md section C): its caches are
    cleared first, and a failed comparison is held again against two JAX
    reruns that agree (tests/test_torch_objectives_renew.py:
    against_jax)."""
    X, y = higgs_rows(5000, 3, noise=0.3)
    Xv, yv = higgs_rows(2000, 4, noise=0.3)
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "learning_rate": 0.3, "metric": ["binary_logloss", "auc"],
              "first_metric_only": True, "verbosity": -1}
    jax.clear_caches()
    bp, rp = _train(lp, dict(params, device_type="cpu",
                             tpu_persist_scan="false"),
                    X, y, Xv, yv, 40, early_stopping_rounds=5)
    assert not bp._booster.use_persist

    def check(ref):
        bj, rj = ref
        vj = np.array(rj["valid_1"]["binary_logloss"])
        # the JAX run stops early, and each of its improvement decisions
        # is farther than 2 * TOL from a tie
        assert 0 < bj.best_iteration < len(vj) < 40
        assert all(abs(vj[i] - vj[:i].min()) > 2 * TOL
                   for i in range(1, len(vj)))
        assert bp.best_iteration == bj.best_iteration
        assert bp.num_trees() == bj.num_trees()
        raw_j = bj.predict(Xv, raw_score=True, num_iteration=-1)
        raw_p = bp.predict(Xv, raw_score=True, num_iteration=-1)
        assert np.abs(raw_j - raw_p).max() <= TOL
        for name, lab in (("training", y), ("valid_1", yv)):
            assert rj[name].keys() == rp[name].keys()
            for metric in ("binary_logloss", "auc"):
                a, b = np.array(rj[name][metric]), np.array(rp[name][metric])
                assert len(a) == len(b) == len(vj)
                if metric == "auc":
                    sc = raw_j if name == "valid_1" else bj.predict(
                        X, raw_score=True, num_iteration=-1)
                    tol = _near_pair_share(sc, lab, 2 * TOL)
                else:
                    tol = TOL
                assert np.abs(a - b).max() <= tol, (name, metric)
        assert dict(bp.best_score["valid_1"]).keys() == \
            dict(bj.best_score["valid_1"]).keys()

    def jax_run():
        return _train(lt, params, X, y, Xv, yv, 40, early_stopping_rounds=5)

    try:
        check(jax_run())
    except AssertionError:
        r2, r3 = jax_run(), jax_run()
        assert same_jax_models(r2[0], r3[0], Xv), \
            "the JAX reference gave three different models"
        check(r2)
    # predict and the model text default to the best iteration
    assert bp.model_to_string() == bp.model_to_string(
        num_iteration=bp.best_iteration)
    np.testing.assert_array_equal(
        bp.predict(Xv), bp.predict(Xv, num_iteration=bp.best_iteration))


def _jax_metric(name, label, score, params):
    md = JMeta(len(label))
    md.set_label(label)
    m = jmetric(name, JConfig(dict(params)))
    m.init(md, len(label))
    obj = jobjective("binary", JConfig(dict(params)))
    obj.init(md, len(label))
    return m.eval(score, obj)[0]


def test_persist_records_are_metrics_of_own_predictions():
    X, y = higgs_rows(4000, 5, noise=0.3)
    Xv, yv = higgs_rows(2000, 6, noise=0.3)
    params = {"objective": "binary", "num_leaves": 31, "max_bin": 63,
              "learning_rate": 0.5, "metric": ["binary_logloss", "auc"],
              "tpu_persist_scan": "force", "device_type": "cpu",
              "verbosity": -1}
    train_scores = []

    def keep(env):
        train_scores.append(
            env.model._booster.train_score.score.numpy().copy())

    bp, rec = _train(lp, params, X, y, Xv, yv, 30, early_stopping_rounds=3,
                     callbacks=[keep])
    assert bp._booster.use_persist
    n = len(rec["valid_1"]["auc"])
    assert 0 < bp.best_iteration < n < 30
    for i in range(1, n + 1):
        raw = bp.predict(Xv, raw_score=True, num_iteration=i)
        for name, data, lab, sc in (("valid_1", Xv, yv, raw),
                                    ("training", X, y, train_scores[i - 1])):
            for metric in ("binary_logloss", "auc"):
                want = _jax_metric(metric, lab, sc, params)
                got = rec[name][metric][i - 1]
                assert abs(got - want) <= 1e-12 * abs(want), (i, name)
    plain = lp.train(dict(params, metric="none"),
                     lp.Dataset(X, y, params=params), n)
    assert plain.model_to_string().split("parameters:")[0] == \
        bp.model_to_string(num_iteration=-1).split("parameters:")[0]


# ---- callbacks -------------------------------------------------------------

def _small(n=2000, seed=3):
    X, y = higgs_rows(n, seed, noise=0.2)
    return X, y


PARAMS = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
          "learning_rate": 0.3, "metric": ["binary_logloss", "auc"],
          "device_type": "cpu", "verbosity": -1}


def test_print_evaluation_format():
    X, y = _small()
    Xv, yv = _small(1000, 4)
    lines = []
    Log.reset_callback(lines.append)
    try:
        bp, rec = _train(lp, PARAMS, X, y, Xv, yv, 6,
                         callbacks=[pcb.print_evaluation(2)])
    finally:
        Log.reset_callback(None)
    head = "[LightGBM-Torch] [Info] "
    shown = [ln[len(head):].rstrip("\n") for ln in lines
             if re.match(re.escape(head) + r"\[\d+\]\t", ln)]
    want = []
    for i in range(1, 6, 2):
        items = ["%s's %s: %g" % (d, m, rec[d][m][i])
                 for d in ("training", "valid_1")
                 for m in ("binary_logloss", "auc")]
        want.append("[%d]\t%s" % (i + 1, "\t".join(items)))
    assert shown == want


def test_user_callbacks_see_the_jax_callback_env():
    X, y = _small()
    Xv, yv = _small(1000, 4)
    seen, rec = [], {}

    def before(env):
        seen.append(("before", env.iteration,
                     env.model.current_iteration(),
                     env.evaluation_result_list))
    before.before_iteration = True

    def after(env):
        # a user callback fires ahead of the implicit ones: this round's
        # values are not recorded yet
        seen.append(("after", env.iteration, env.begin_iteration,
                     env.end_iteration, list(env.evaluation_result_list),
                     env.model.current_iteration(), dict(env.params),
                     len(rec["valid_1"]["auc"]) if rec else 0))

    dt = lp.Dataset(X, y, params=dict(PARAMS))
    dv = lp.Dataset(Xv, yv, reference=dt, params=dict(PARAMS))
    lp.train(dict(PARAMS), dt, 4, valid_sets=[dt, dv], evals_result=rec,
             verbose_eval=False, callbacks=[after, before])
    keys = [(d, m) for d in ("training", "valid_1")
            for m in ("binary_logloss", "auc")]
    assert len(seen) == 8
    for it in range(4):
        b, a = seen[2 * it: 2 * it + 2]
        assert b == ("before", it, it, None)
        assert a[:4] == ("after", it, 0, 4)
        assert [(d, m) for d, m, _, _ in a[4]] == keys
        assert [v for _, _, v, _ in a[4]] == [rec[d][m][it] for d, m in keys]
        assert [h for _, _, _, h in a[4]] == [False, True, False, True]
        assert a[5] == it + 1 and a[6]["objective"] == "binary"
        assert a[7] == it


def _streams(rng, n, k):
    """n rounds of k result tuples: (data, metric, value, higher_better),
    random walks that improve and stall."""
    names = [("training", "binary_logloss", False), ("training", "auc", True),
             ("valid_1", "binary_logloss", False), ("valid_1", "auc", True)]
    vals = np.cumsum(rng.normal(size=(n, k)) * 0.1
                     + np.linspace(-0.1, 0.1, n)[:, None], 0)
    return [[(d, m, float(vals[i, j] * (1 if hb else -1)), hb)
             for j, (d, m, hb) in enumerate(names[:k])] for i in range(n)]


@pytest.mark.parametrize("first_only", [False, True])
@pytest.mark.parametrize("seed", range(6))
def test_early_stopping_callback_matches_jax(seed, first_only):
    rng = np.random.default_rng(seed)
    rounds = 30
    streams = _streams(rng, rounds, 4 if seed % 3 else 2)
    out = []
    for mod in (jcb, pcb):
        cb = mod.early_stopping(3 + seed % 3, first_only, verbose=False)
        res = None
        for i, evals in enumerate(streams):
            env = mod.CallbackEnv(model=None, params={}, iteration=i,
                                  begin_iteration=0, end_iteration=rounds,
                                  evaluation_result_list=evals)
            try:
                cb(env)
            except mod.EarlyStopException as e:
                res = (i, e.best_iteration, e.best_score)
                break
        out.append((res, cb.state_dict()))
    assert out[0] == out[1]
    assert out[0][0] is not None


def test_reset_parameter_learning_rates_match_jax():
    X, y = train_data(4000, 11, True)
    rates = [0.3, 0.2, 0.1, 0.05, 0.2]
    params = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
              "verbosity": -1}
    bj = lt.train(dict(params), lt.Dataset(X, y), 5, learning_rates=rates)
    pp = dict(params, device_type="cpu")
    bp = lp.train(pp, lp.Dataset(X, y, params=pp), 5, learning_rates=rates)
    _assert_same_trees(bj, bp, X)
    assert [t.shrinkage for t in bp._booster.models] == rates
    assert bp._booster.shrinkage_rate == 0.2
    with pytest.raises(LightGBMError, match="cannot change during "
                                            "training"):
        lp.train(pp, lp.Dataset(X, y, params=pp), 2,
                 callbacks=[pcb.reset_parameter(max_bin=[63, 31])])


def test_persist_learning_rates_match_v1():
    """learning_rates= on the persistent route (the rate read from the
    grower's device scalar) grows the v1 route's trees."""
    X, y = train_data(4000, 12, False)
    base = dict(PARAMS, metric="none", num_leaves=15)
    runs = {}
    for route in ("force", "false"):
        p = dict(base, tpu_persist_scan=route)
        runs[route] = lp.train(p, lp.Dataset(X, y, params=p), 3,
                               learning_rates=[0.4, 0.1, 0.25])
    assert runs["force"]._booster.use_persist
    assert [t.shrinkage for t in runs["force"]._booster.models] == \
        [0.4, 0.1, 0.25]
    assert_same_models(runs["false"], runs["force"], X, 0.4, 1)


# ---- the stop rule with a validation set -----------------------------------

def _stop_data(objective):
    if objective == "multiclass":
        return class_data(n=2000, seed=5) + class_data(n=1000, seed=6)
    if objective == "regression":
        return reg_data("regression", n=2000, seed=5) + \
            reg_data("regression", n=1000, seed=6)
    X, y = make_higgs_like(2000, seed=5)
    Xv, yv = make_higgs_like(1000, seed=6)
    return X[:, :8], y, Xv[:, :8], yv


@pytest.mark.parametrize("objective,min_gain", [
    ("binary", 10.0), ("multiclass", 3.0), ("regression", 10.0)])
def test_stop_rule_with_validation_matches_jax(objective, min_gain):
    """The JAX run takes its per-class path, which is not deterministic on
    the CPU (ROADMAP.md section C): its caches are cleared first, and a
    failed comparison is held again against two JAX reruns that agree
    (tests/test_torch_objectives_renew.py:against_jax)."""
    X, y, Xv, yv = _stop_data(objective)
    params = dict(BASE, objective=objective, min_gain_to_split=min_gain,
                  learning_rate=0.3)
    if objective == "multiclass":
        params.update(num_class=3, metric="multi_logloss")

    def run(pkg, extra):
        p = dict(params, **extra)
        dt = pkg.Dataset(X, y, params=dict(p))
        dv = pkg.Dataset(Xv, yv, reference=dt, params=dict(p))
        rec = {}
        bst = pkg.train(dict(p), dt, 25, valid_sets=[dv],
                        evals_result=rec, verbose_eval=False)
        models = (bst._booster._used_models() if pkg is lt
                  else bst._booster.models)
        return bst, ([t.num_leaves for t in models], rec["valid_0"],
                     bst.predict(Xv, raw_score=True))

    jax.clear_caches()
    lp_, rp, pp_ = run(lp, {"device_type": "cpu",
                            "tpu_persist_scan": "false"})[1]
    K = 3 if objective == "multiclass" else 1

    def check(ref):
        lj, rj, pj = ref[1]
        assert lj == lp_
        assert len(lj) < 25 * K                 # training stopped early
        assert all(len(v) == 25 for v in list(rj.values()) + list(rp.values()))
        assert np.abs(pj - pp_).max() <= TOL

    try:
        ref = run(lt, {})
        check(ref)
    except AssertionError:
        ref, b3 = run(lt, {}), run(lt, {})
        assert same_jax_models(ref[0], b3[0], Xv), \
            "the JAX reference gave three different models"
        check(ref)
    lj = ref[1][0]
    if K > 1:
        # a class without a split did not stop the iteration (the per-class
        # rule); without a validation set the fast rule stops there
        its = np.array(lj).reshape(-1, K)
        assert (its[:-1] == 1).any()
        q = dict(params, device_type="cpu", tpu_persist_scan="false")
        fast = lp.train(q, lp.Dataset(X, y, params=q), 25)
        ref = lt.train(dict(params), lt.Dataset(X, y), 25)
        assert fast.num_trees() == len(ref._booster._used_models()) < len(lj)
