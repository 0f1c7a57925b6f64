"""Custom objectives: ``train(fobj=)`` and ``Booster.update(fobj=)`` against
the JAX package (lightgbm_tpu/engine.py:591, basic.py:544).

An ``fobj`` gets the class-major training scores (float64 numpy) and the
training Dataset and returns (grad, hess). Both packages train with
``objective=none`` on the host gradients (the port on its v1 grower), with
no BoostFromAverage. An fobj that returns the binary objective's gradients
must grow the JAX fobj run's trees (equal structure; raw scores within
1e-4, the JAX package's f64 against the port's f32 leaf sums, as
tests/test_torch_train.py), with the split scan's knobs too; a three-class
softmax fobj ([3 * n] gradients) must as well. Gradients of the wrong size
raise, and so does a Booster without an objective or fobj.
"""
import numpy as np
import pytest

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.utils.log import LightGBMError

BASE = {"num_leaves": 15, "max_bin": 63, "verbosity": -1,
        "min_gain_to_split": 1e-3}


def binary_fobj(preds, ds):
    """The binary objective's gradients (sigmoid 1): the reference's
    BinaryLogloss::GetGradients for labels in {0, 1}."""
    y = np.where(ds.get_label() > 0, 1.0, -1.0)
    resp = -y / (1.0 + np.exp(y * preds))
    a = np.abs(resp)
    return resp, a * (1.0 - a)


def softmax_fobj(preds, ds):
    """Softmax gradients of K = 3 classes from [3 * n] class-major scores."""
    lab = ds.get_label().astype(np.int64)
    s = preds.reshape(3, -1)
    p = np.exp(s - s.max(axis=0))
    p /= p.sum(axis=0)
    onehot = np.zeros_like(p)
    onehot[lab, np.arange(len(lab))] = 1.0
    return (p - onehot).reshape(-1), (2.0 * p * (1.0 - p)).reshape(-1)


def _assert_same(bj, bp, X, trees):
    tj, tp = bj._booster._used_models(), bp._booster.models
    assert len(tj) == len(tp) == trees
    for a, b in zip(tj, tp):
        assert a.num_leaves == b.num_leaves > 2
        k = a.num_leaves - 1
        for f in ("split_feature", "threshold", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k], f)
    np.testing.assert_allclose(bp.predict(X, raw_score=True),
                               bj.predict(X, raw_score=True), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("extra", [{}, {"lambda_l1": 0.5,
                                        "feature_fraction_bynode": 0.7}])
def test_fobj_grows_the_jax_trees(extra):
    X, y = make_higgs_like(5000, seed=3)
    params = dict(BASE, **extra)
    bj = lt.train(dict(params), lt.Dataset(X, y), 5, fobj=binary_fobj)
    pp = dict(params, device_type="cpu")
    bp = lp.train(pp, lp.Dataset(X, y, params=pp), 5, fobj=binary_fobj)
    assert bp._booster.objective is None and not bp._booster.use_persist
    assert "objective=" not in bp.model_to_string().split("Tree=0")[0]
    _assert_same(bj, bp, X, 5)


def test_softmax_fobj_through_update():
    X, _ = make_higgs_like(4000, seed=4)
    y = np.digitize(X[:, 0] + 0.5 * X[:, 1], [-0.5, 0.5]).astype(np.float64)
    params = dict(BASE, num_class=3, objective="none")
    bj = lt.Booster(params=dict(params), train_set=lt.Dataset(X, y))
    pp = dict(params, device_type="cpu")
    bp = lp.Booster(params=pp, train_set=lp.Dataset(X, y, params=pp))
    for _ in range(3):
        bj.update(fobj=softmax_fobj)
        bp.update(fobj=softmax_fobj)
    _assert_same(bj, bp, X, 9)


def test_fobj_misuse_raises():
    X, y = make_higgs_like(500, seed=5)
    pp = dict(BASE, device_type="cpu", objective="none")
    bp = lp.Booster(params=pp, train_set=lp.Dataset(X, y, params=pp))
    with pytest.raises(ValueError, match="Lengths of gradients"):
        bp.update(fobj=lambda p, d: (np.zeros(10), np.zeros(10)))
    with pytest.raises(LightGBMError, match="No objective function"):
        bp.update()
