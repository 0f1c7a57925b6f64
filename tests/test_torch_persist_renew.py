"""The persistent grower with leaf renewal and with the row gradient mode,
against the port's v1 grower and the JAX package, on the CPU.

Renewal (L1, quantile, MAPE): the JAX package never renews on its
persistent path (its ``_fast_path_ok`` sends these objectives to its
per-class path on the v1 grower), so the port's persistent route
(``tpu_persist_scan=force``, 5 iterations) is held against the port's v1
route and the JAX package's v1 route (tests/test_torch_objectives_renew.py
holds those two equal bit for bit). The trees must be equal in structure
and row partition. A renewed value is a percentile of label - score, and
the persistent grower's scores are f32 where the v1 grower's are f64:
after t iterations they differ by at most 2 (t + 1) f32 ulps of the
largest |score| (the bound the device-score checks use), a percentile
moves by at most that much, and the leaf table rounds it once to f32. So
a leaf value may differ by 2 (t + 1) ulps of max |score| plus one ulp of
itself, and a raw score by the sum of its path's bounds times the
learning rate.

Row mode (reg_sqrt, cross_entropy, weighted cross_entropy_lambda): the
JAX package's persistent path runs them through ``fill_grad_row``; the
port is held against it with its Pallas kernels in interpret mode, 16
iterations, by tests/test_torch_multiclass.py's rules (the three costly
comparisons of this slice).

Validation: each new objective's default metric is created and recorded
as the JAX package's metric of the port's own scores, early stopping runs,
and a validation set changes no persistent tree.
"""
import jax
import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.objectives import create_objective as jobjective
import lightgbm_torch as lp
from test_torch_multiclass import (BASE, EPS32, ROUNDS, assert_same_models,
                                   train_jax, train_port)
from test_torch_objectives_renew import (against_jax, reg_data,
                                         train_jax_fresh)
from test_torch_regression import gmax

RENEW_CASES = [("regression_l1", {}, False), ("quantile", {"alpha": 0.9},
                                              False),
               ("quantile", {"alpha": 0.2}, True), ("mape", {}, False)]


def assert_renewed_close(ref, mine, X, y, lr):
    """`mine`'s trees against `ref`'s (Boosters): equal structure and
    partition, leaf values and raw scores within the module's bound (a
    renewed value is at most max |label| + max |score| in size)."""
    a_models, b_models = ref._booster._used_models(), mine._booster.models
    assert len(a_models) == len(b_models)
    smax = max(np.abs(ref.predict(X, raw_score=True)).max(), 1.0)
    vmax = np.abs(y).max() + smax
    slack = np.zeros(X.shape[0])
    for t, (a, b) in enumerate(zip(a_models, b_models)):
        k = a.num_leaves - 1
        assert a.num_leaves == b.num_leaves > 2, t
        for f in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k], "%s %d" % (f, t))
        leaf = a.predict_leaf(X)
        np.testing.assert_array_equal(leaf, b.predict_leaf(X))
        bound = lr * EPS32 * (2 * (t + 1) * smax + vmax)
        assert np.all(np.abs(a.leaf_value[:k + 1] - b.leaf_value[:k + 1])
                      <= bound), t
        slack += bound
    rj = ref.predict(X, raw_score=True)
    rp = mine.predict(X, raw_score=True)
    assert np.all(np.abs(rp - rj) <= slack)


@pytest.mark.parametrize("name,extra,weighted", RENEW_CASES, ids=[
    "%s%s-%s" % (n, e.get("alpha", ""), "w" if w else "u")
    for n, e, w in RENEW_CASES])
def test_persist_renewal_matches_v1(name, extra, weighted):
    params = dict(BASE, objective=name, tpu_persist_scan="force", **extra)
    X, y = reg_data(name, seed=21)
    w = np.random.default_rng(21).uniform(0.5, 2.0, len(y)) if weighted \
        else None
    bp = train_port(params, X, y, 5, weight=w)
    gr = bp._booster.tree_learner._persist_gr
    assert (gr.weight_row is not None) == (weighted and name != "mape")
    v1 = train_port(dict(params, tpu_persist_scan="off"), X, y, 5, weight=w)
    lr = params["learning_rate"]
    assert_renewed_close(v1, bp, X, y, lr)
    against_jax(lambda bj: assert_renewed_close(bj, bp, X, y, lr),
                lambda: train_jax_fresh(dict(params, tpu_persist_scan="off"),
                                        X, y, 5, weight=w), X)
    walk = bp.predict(X, raw_score=True)
    score = bp._booster.train_score.score.numpy()
    assert np.max(np.abs(score - walk)) <= \
        2 * 6 * EPS32 * max(1.0, np.abs(walk).max())


def test_persist_renewal_level_phase_equals_per_split():
    """L1 with max_depth 3: the level phase's eager iteration renews as
    the per-split loop does, bit for bit."""
    params = dict(BASE, objective="regression_l1", num_leaves=8,
                  max_depth=3, tpu_persist_scan="force")
    X, y = reg_data("regression_l1", seed=22)
    lvl = train_port(params, X, y, 4)
    gr = lvl._booster.tree_learner._persist_gr
    assert gr.use_level and all(a > 0 for a, _ in gr.grow_stats)
    off = train_port(dict(params, tpu_level_grow="off"), X, y, 4)
    np.testing.assert_array_equal(off.predict(X, raw_score=True),
                                  lvl.predict(X, raw_score=True))
    np.testing.assert_array_equal(off._booster.train_score.score.numpy(),
                                  lvl._booster.train_score.score.numpy())


@pytest.mark.parametrize("name,extra,weighted", [
    ("regression", {"reg_sqrt": True}, False),
    ("cross_entropy", {}, False),
    ("cross_entropy_lambda", {}, True)])
def test_row_mode_matches_jax_persist(name, extra, weighted, monkeypatch):
    params = dict(BASE, objective=name, tpu_persist_scan="force", **extra)
    X, y = reg_data(name if name != "regression" else "regression_l1",
                    seed=23)
    if extra.get("reg_sqrt"):
        y = np.abs(y)
    w = np.random.default_rng(23).uniform(0.5, 2.0, len(y)) if weighted \
        else None
    jax.clear_caches()
    bj = train_jax(params, X, y, ROUNDS, True, monkeypatch, weight=w)
    bp = train_port(params, X, y, ROUNDS, weight=w)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.weight_row is None and gr._rows is not None
    assert_same_models(bj, bp, X, params["learning_rate"], 1, mxu=True,
                       gmax=gmax(bp) * (2.0 if weighted else 1.0))


def _train(pkg, params, X, y, Xv, yv, rounds, **kw):
    dt = pkg.Dataset(X, y, params=dict(params))
    dv = pkg.Dataset(Xv, yv, reference=dt, params=dict(params))
    rec = {}
    bst = pkg.train(dict(params), dt, rounds, valid_sets=[dt, dv],
                    evals_result=rec, verbose_eval=False, **kw)
    return bst, rec


DEFAULT_METRIC = {"regression_l1": "l1", "quantile": "quantile",
                  "mape": "mape", "cross_entropy": "cross_entropy",
                  "cross_entropy_lambda": "cross_entropy_lambda"}


def jax_metric(name, params, label):
    """fn(raw) -> the JAX package's metric `name` of raw scores, the
    objective of `params` converting them."""
    md = JMeta(len(label))
    md.set_label(label)
    cfg = JConfig(dict(params))
    m = jmetric(name, cfg)
    m.init(md, len(label))
    obj = jobjective(cfg.objective, cfg)
    obj.init(md, len(label))
    return lambda raw: m.eval(raw, obj)[0]


@pytest.mark.parametrize("name", sorted(DEFAULT_METRIC))
def test_validation_with_default_metric(name):
    """The objective's default metric is created for the training and the
    held-out set, and each record is the JAX package's metric of the
    port's own scores after that iteration (1e-12 relative): the training
    scores, and predict(Xv, num_iteration=i) for the held-out set. The v1
    run stops early at its held-out records' first minimum; the persistent
    run grows the trees of a run without the validation set. (The JAX
    package's own training runs are not used here: its per-class path is
    not deterministic, tests/test_torch_objectives_renew.py.)"""
    X, y = reg_data(name, n=1500, seed=24)
    Xv, yv = reg_data(name, n=500, seed=25)
    metric = DEFAULT_METRIC[name]
    for route, rounds in (("off", 12), ("force", 6)):
        params = dict(BASE, objective=name, learning_rate=0.5,
                      tpu_persist_scan=route, device_type="cpu")
        scores = []

        def keep(env):
            scores.append(
                env.model._booster.train_score.score.numpy().copy())
        bst, rec = _train(lp, params, X, y, Xv, yv, rounds,
                          early_stopping_rounds=2 if route == "off" else None,
                          callbacks=[keep])
        assert list(rec["training"]) == list(rec["valid_1"]) == [metric]
        valid = rec["valid_1"][metric]
        on_train = jax_metric(metric, params, y)
        on_valid = jax_metric(metric, params, yv)
        for i in range(len(valid)):
            for part, want in (
                    ("training", on_train(scores[i])),
                    ("valid_1", on_valid(bst.predict(
                        Xv, raw_score=True, num_iteration=i + 1)))):
                assert abs(rec[part][metric][i] - want) <= 1e-12 * abs(want)
        if route == "off":
            assert bst.best_iteration == int(np.argmin(valid)) + 1
            continue
        assert len(valid) == rounds
        plain = lp.train(params, lp.Dataset(X, y, params=params), rounds)
        assert plain.model_to_string().split("parameters:")[0] == \
            bst.model_to_string(num_iteration=-1).split("parameters:")[0]
