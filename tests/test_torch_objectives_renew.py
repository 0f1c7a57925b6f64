"""L1, quantile, MAPE, cross-entropy and reg_sqrt's row mode in the port,
against the JAX package, on the CPU.

Objective level (seeded numpy labels, weights and f64 scores through both
packages):

  * the v1 gradients (``get_gradients``): L1, quantile and MAPE are sign
    and select operations, equal bit for bit. Cross-entropy needs exp and
    log1p, which XLA and torch round differently in the last f64 bit:
    ``cross_entropy`` within 4 f64 ulps of max(sigmoid, label) times the
    weight for the gradient and of the weight for the hessian;
    ``cross_entropy_lambda`` (weighted) within 4 ulps of the sum of its
    terms' magnitudes times 1 + 1/z, with z = 1 - exp(-w log1p(e^s)),
    whose relative error grows as 1/z where it cancels;
  * the persistent grower's mode (``device_gradients``): "payload" for L1
    and quantile (their label-only f32 functions, equal bit for bit),
    "row" for MAPE, cross-entropy and reg_sqrt, as in the JAX package;
  * BoostFromScore, the flags, the output transform and the model string:
    equal.

Training on the v1 grower (``tpu_persist_scan=off``, 5 iterations, the
JAX package's v1 route): for L1, quantile and MAPE the leaf values are the
renewed percentiles of the same f64 residuals, so trees, leaf values and
raw scores are equal bit for bit (with and without weights, with integer
labels whose ties fix the weighted cdf's order). Cross-entropy follows
tests/test_torch_regression.py: equal structure and row partition, leaf
values within tests/test_torch_multiclass.py's bounds scaled by the first
iteration's largest |grad|. Model text loads in both directions with
equal predictions.

The JAX package's per-class path (which every renewal objective takes,
and any objective with a validation set) is not deterministic on the CPU:
the same training repeated in one process gave other trees in about one
run of eight (L1, quantile and MAPE, jax 0.9.0), and more often after
other objectives were compiled in the process (MAPE after a weighted
quantile run grew another second tree; ``jax.clear_caches()`` before the
run restored the lone run's trees). The port is deterministic. So the
reference runs here start from cleared caches, and a comparison that fails
against a first reference run is made again against two more: they must
agree with each other, and the port with them (:func:`against_jax`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.utils.log import LightGBMError
from test_torch_multiclass import (BASE, assert_same_models, higgs_latent,
                                   train_jax, train_port)
from test_torch_objectives import N, _close, _pair
from test_torch_regression import gmax

EPS64 = float(np.finfo(np.float64).eps)
RENEWED = ("regression_l1", "quantile", "mape")
NEW = RENEWED + ("cross_entropy", "cross_entropy_lambda")
EXTRA = {"quantile": {"alpha": 0.9}}


def _inputs(name, weighted, seed=0):
    rng = np.random.default_rng(seed)
    if name.startswith("cross_entropy"):
        label = rng.random(N).astype(np.float32)
        label[:50], label[50:100] = 0.0, 1.0
    elif name == "mape":
        label = (rng.normal(size=N) * 4).astype(np.float32)
    else:
        label = np.round(rng.normal(size=N) * 3).astype(np.float32)
    weight = (rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted
              else None)
    return label, weight, rng.normal(size=N) * 1.5


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", NEW)
def test_v1_gradients_match_jax(name, weighted):
    label, weight, score = _inputs(name, weighted)
    jo, po, _ = _pair(name, 1, label, weight, EXTRA.get(name))
    gj, hj = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    gp, hp = (a.numpy() for a in po.get_gradients(torch.as_tensor(score)))
    if name in RENEWED:
        np.testing.assert_array_equal(gp, gj)
        np.testing.assert_array_equal(hp, hj)
        return
    y = label.astype(np.float64)
    w = 1.0 if weight is None else weight.astype(np.float64)
    if name == "cross_entropy" or weight is None:
        sig = 1.0 / (1.0 + np.exp(-score))
        _close(gp, gj, np.maximum(sig, y) * w, EPS64, 4)
        _close(hp, hj, np.ones_like(score) * w, EPS64, 4)
        return
    epf = np.exp(score)
    z = 1.0 - np.exp(-w * np.log1p(epf))
    cond = 1.0 + 1.0 / z
    c, d = 1.0 / (1.0 - z), 1.0 + epf
    a = w * epf / (d * d)
    b = c / ((c - 1.0) ** 2) * (1.0 + w * epf + c)
    _close(gp, gj, (1.0 + y / z) * w / (1.0 + 1.0 / epf) * cond, EPS64, 4)
    _close(hp, hj, a * (1.0 + y * b) * cond, EPS64, 4)


@pytest.mark.parametrize("name,extra", [
    ("regression_l1", None), ("quantile", {"alpha": 0.9}),
    ("quantile", {"alpha": 0.1}), ("mape", None), ("cross_entropy", None),
    ("cross_entropy_lambda", None),
    ("regression", {"reg_sqrt": True})])
def test_device_gradient_modes_match_jax(name, extra):
    """The persistent grower's gradient mode is the JAX package's; a
    payload function equals the JAX one bit for bit on f32 rows, a row
    function is the v1 gradient."""
    label, weight, score = _inputs(name, True, seed=1)
    if extra and extra.get("reg_sqrt"):
        label = np.abs(label)
    jo, po, _ = _pair(name, 1, label, weight, extra)
    mode, fn = po.device_gradients()
    assert mode == jo.device_gradients()[0]
    if mode == "row":
        s = torch.as_tensor(score)
        for a, b in zip(fn(s), po.get_gradients(s)):
            np.testing.assert_array_equal(a.numpy(), b.numpy())
        return
    s32 = score.astype(np.float32)
    a = jo.payload_grad_fn()(jnp.asarray(s32), jnp.asarray(label))
    b = fn(torch.as_tensor(s32), torch.as_tensor(label))
    assert b[0].dtype == b[1].dtype == torch.float32
    np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
    np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("name", NEW)
def test_scalars_match_jax(name, weighted):
    label, weight, score = _inputs(name, weighted, seed=2)
    jo, po, _ = _pair(name, 1, label, weight, EXTRA.get(name))
    assert po.boost_from_score(0) == jo.boost_from_score(0)
    assert po.is_constant_hessian == jo.is_constant_hessian
    assert po.is_renew_tree_output == jo.is_renew_tree_output \
        == (name in RENEWED)
    np.testing.assert_array_equal(po.convert_output(score),
                                  jo.convert_output(score))
    assert po.to_string() == jo.to_string()


@pytest.mark.parametrize("name,params,label,weight,match", [
    ("cross_entropy", {}, 1.5, None, "label outside"),
    ("cross_entropy", {}, 0.5, -1.0, "negative"),
    ("cross_entropy", {}, 0.5, 0.0, "sum of weights is zero"),
    ("cross_entropy_lambda", {}, -0.5, None, "label outside"),
    ("cross_entropy_lambda", {}, 0.5, 0.0, "non-positive"),
    ("quantile", {"alpha": 1.0}, 0.5, None, "alpha"),
    ("quantile", {"alpha": 0.0}, 0.5, None, "alpha")])
def test_objective_checks(name, params, label, weight, match):
    X, _ = higgs_latent(300, 2)
    y = np.full(300, 0.5)
    y[7] = label
    w = None if weight is None else np.where(np.arange(300) == 7, weight,
                                             0.0 if weight == 0.0 else 1.0)
    p = dict(params, objective=name, device_type="cpu", verbosity=-1)
    with pytest.raises(LightGBMError, match=match):
        lp.train(p, lp.Dataset(X[:, :4], y, weight=w, params=p), 1)


def train_jax_fresh(params, X, y, rounds, pallas=False, monkeypatch=None,
                    weight=None):
    """train_jax from cleared JAX caches (the module docstring)."""
    jax.clear_caches()
    return train_jax(params, X, y, rounds, pallas, monkeypatch, weight)


def same_jax_models(a, b, X):
    """Two JAX Boosters with equal trees and raw predictions."""
    ta, tb = a._booster._used_models(), b._booster._used_models()
    return len(ta) == len(tb) and all(
        x.num_leaves == y.num_leaves and np.array_equal(
            x.leaf_value[:x.num_leaves], y.leaf_value[:y.num_leaves])
        and np.array_equal(x.split_feature[:x.num_leaves - 1],
                           y.split_feature[:y.num_leaves - 1])
        for x, y in zip(ta, tb)) and np.array_equal(
        a.predict(X, raw_score=True), b.predict(X, raw_score=True))


def against_jax(check, train, X):
    """check(reference) for a JAX reference run `train()`; when it fails,
    two more runs that agree with each other must pass it (the module
    docstring: the JAX per-class path is not deterministic)."""
    try:
        check(train())
    except AssertionError:
        b2, b3 = train(), train()
        assert same_jax_models(b2, b3, X), \
            "the JAX reference gave three different models"
        check(b2)


def reg_data(name, n=2000, seed=3, f=8, missing=0.05, ties=False):
    """HIGGS-shaped rows; targets from the latent: the latent plus noise
    (L1, quantile; rounded to integers with `ties`), 3 times that (MAPE,
    mostly |label| >= 1), its sigmoid in [0, 1] (cross-entropy)."""
    X, latent = higgs_latent(n, seed)
    y = latent + np.random.default_rng(seed + 100).normal(size=n)
    if name == "mape":
        y = 3.0 * y
    elif name.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-latent))
    if ties:
        y = np.round(y)
    X = X[:, :f].copy()
    X[np.random.default_rng(seed).random(X.shape) < missing] = np.nan
    return X, y


V1_CASES = [(name, extra, weighted)
            for name, extra in (("regression_l1", {}),
                                ("quantile", {"alpha": 0.9}),
                                ("quantile", {"alpha": 0.1}),
                                ("mape", {}), ("cross_entropy", {}),
                                ("cross_entropy_lambda", {}))
            for weighted in (False, True)]


@pytest.mark.parametrize("name,extra,weighted", V1_CASES, ids=[
    "%s%s-%s" % (n, e.get("alpha", ""), "w" if w else "u")
    for n, e, w in V1_CASES])
def test_v1_training_matches_jax(name, extra, weighted):
    params = dict(BASE, objective=name, tpu_persist_scan="off", **extra)
    X, y = reg_data(name, ties=weighted and name in RENEWED)
    w = np.random.default_rng(5).uniform(0.5, 2.0, len(y)) if weighted \
        else None
    bp = train_port(params, X, y, 5, weight=w)
    assert len(bp._booster.models) == 5

    def check(bj):
        assert_same_models(bj, bp, X, params["learning_rate"], 1,
                           gmax=gmax(bp) * (2.0 if weighted else 1.0))
        if name in RENEWED:
            for a, b in zip(bj._booster._used_models(), bp._booster.models):
                k = a.num_leaves
                np.testing.assert_array_equal(a.leaf_value[:k],
                                              b.leaf_value[:k])
            np.testing.assert_array_equal(bp.predict(X, raw_score=True),
                                          bj.predict(X, raw_score=True))
    against_jax(check, lambda: train_jax_fresh(params, X, y, 5, weight=w), X)
    walk = bp.predict(X, raw_score=True)
    score = bp._booster.train_score.score.numpy()
    assert np.max(np.abs(score - walk)) <= 1e-9


@pytest.mark.parametrize("name,extra", [
    ("regression_l1", {}), ("quantile", {"alpha": 0.3}), ("mape", {}),
    ("cross_entropy", {}), ("cross_entropy_lambda", {}),
    ("regression", {"reg_sqrt": True})])
def test_model_text_loads_both_ways(name, extra):
    params = dict(BASE, objective=name, **extra)
    X, y = reg_data(name, seed=7)
    if extra.get("reg_sqrt"):
        y = np.abs(y)
    bj = lt.train(dict(params), lt.Dataset(X, y), 3)
    bp = train_port(dict(params, tpu_persist_scan="force"), X, y, 3)
    want = {"regression": "regression sqrt"}.get(name, name)
    for src, dst_cls in ((bj, lp.Booster), (bp, lt.Booster)):
        text = src.model_to_string()
        assert "objective=%s\n" % want in text
        dst = dst_cls(model_str=text, params={"device_type": "cpu"})
        for raw in (True, False):
            np.testing.assert_array_equal(src.predict(X, raw_score=raw),
                                          dst.predict(X, raw_score=raw))
