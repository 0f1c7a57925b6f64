"""The port's objectives against the JAX package's, on seeded numpy inputs.

For every objective the port trains (binary, multiclass, multiclassova,
regression, huber, fair, poisson, gamma, tweedie), the same scores, labels
and weights go through both packages:

  * the v1 grower's gradients (``get_gradients`` on f64 scores, [K, n] for
    multiclass): both packages compute them in f64. Equal for L2, Huber and
    Fair; for the others within 4 f64 ulps of the largest term of the last
    operation (exp differs between XLA and torch in the last f64 bit);
  * the persistent grower's payload gradients (``payload_grad_fn``, and
    ``payload_grad_fn_multi`` for each class): equal for L2, Huber and
    Fair, which are the same f32 operations. The others are f64 rounded
    once to f32 in the port and f32 operations in the JAX package; they
    agree within 4 f32 ulps of the largest term of the last operation
    (exp(s) and the label for Poisson's gradient, its exp(s + max_delta_
    step) for the hessian, 1 for softmax and the binary losses). Measured
    in ulps of the result itself they differ by far more where the last
    subtraction cancels: that is the JAX package's f32 rounding;
  * BoostFromScore of every class, class_need_train, the output transform
    and the model-text string: equal.

The objectives the port does not train yet (ranking) raise and name
ROADMAP.md queue A, item 17. L1, quantile, MAPE and cross-entropy:
tests/test_torch_objectives_renew.py.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.objectives import create_objective as port_objective
from lightgbm_torch.utils.log import LightGBMError

N = 20_000
EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)
EXACT = ("regression", "huber", "fair")
# (objective, num_class)
CASES = [("binary", 1), ("regression", 1), ("huber", 1), ("fair", 1),
         ("poisson", 1), ("gamma", 1), ("tweedie", 1), ("multiclass", 3),
         ("multiclass", 5), ("multiclassova", 3)]
IDS = ["%s%s" % (o, "" if k == 1 else k) for o, k in CASES]


def _inputs(name, K, weighted, seed=0):
    rng = np.random.default_rng(seed)
    if K > 1:
        label = rng.integers(0, K, N).astype(np.float32)
    elif name == "binary":
        label = (rng.random(N) < 0.4).astype(np.float32)
    elif name in ("poisson", "gamma", "tweedie"):
        label = rng.gamma(2.0, 1.0, N).astype(np.float32)
    else:
        label = (rng.normal(size=N) * 3).astype(np.float32)
    weight = (rng.uniform(0.5, 2.0, N).astype(np.float32) if weighted
              else None)
    score = rng.normal(size=(K, N) if K > 1 else N) * 1.5
    return label, weight, score


def _pair(name, K, label, weight, extra=None):
    params = dict({"objective": name, "num_class": K}, **(extra or {}))
    md = SimpleNamespace(label=label, weight=weight, init_score=None)
    jc, pc = lt.Config(params), lp.Config(params)
    jo, po = jax_objective(jc.objective, jc), port_objective(pc.objective, pc)
    jo.init(md, N)
    po.init(md, N)
    return jo, po, pc


def _scales(name, s, label, cfg):
    """The largest term of the last operation of (grad, hess), f64."""
    one = np.ones_like(s)
    if name == "poisson":
        return (np.maximum(np.exp(s), np.abs(label)),
                np.exp(s + cfg.poisson_max_delta_step))
    if name == "gamma":
        r = label / np.exp(s)
        return np.maximum(1.0, r), r
    if name == "tweedie":
        rho = cfg.tweedie_variance_power
        e1, e2 = np.exp((1 - rho) * s), np.exp((2 - rho) * s)
        return (np.maximum(label * e1, e2),
                np.maximum(np.abs(label * (1 - rho) * e1), (2 - rho) * e2))
    return one, one


def _close(mine, ref, scale, eps, ulps):
    mine = np.asarray(mine, np.float64)
    ref = np.asarray(ref, np.float64)
    assert mine.shape == ref.shape
    gap = np.abs(mine - ref)
    bound = ulps * eps * scale
    assert np.all(gap <= bound), float(np.max(gap / scale / eps))


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("name,K", CASES, ids=IDS)
def test_v1_gradients_match_jax(name, K, weighted):
    label, weight, score = _inputs(name, K, weighted)
    jo, po, cfg = _pair(name, K, label, weight)
    gj, hj = jo.get_gradients(jnp.asarray(score))
    gp, hp = po.get_gradients(torch.as_tensor(score))
    assert gp.dtype == hp.dtype == torch.float64
    if name in EXACT:
        np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))
        np.testing.assert_array_equal(hp.numpy(), np.asarray(hj))
        return
    sg, sh = _scales(name, score, label.astype(np.float64), cfg)
    w = 1.0 if weight is None else weight.astype(np.float64)
    _close(gp.numpy(), gj, sg * w, EPS64, 4)
    _close(hp.numpy(), hj, sh * w, EPS64, 4)


@pytest.mark.parametrize("name,K", CASES, ids=IDS)
def test_payload_gradients_match_jax(name, K):
    label, _, score = _inputs(name, K, False, seed=1)
    s32 = score.astype(np.float32)
    jo, po, cfg = _pair(name, K, label, None)
    lab_j, lab_p = jnp.asarray(label), torch.as_tensor(label)
    for c in range(K):
        if K > 1:
            a = jo.payload_grad_fn_multi()(jnp.asarray(s32), lab_j, c)
            b = po.payload_grad_fn_multi()(torch.as_tensor(s32), lab_p, c)
            s = s32[c]
        else:
            a = jo.payload_grad_fn()(jnp.asarray(s32), lab_j)
            b = po.payload_grad_fn()(torch.as_tensor(s32), lab_p)
            s = s32
        assert b[0].dtype == b[1].dtype == torch.float32
        if name in EXACT:
            np.testing.assert_array_equal(b[0].numpy(), np.asarray(a[0]))
            np.testing.assert_array_equal(b[1].numpy(), np.asarray(a[1]))
            continue
        sg, sh = _scales(name, s.astype(np.float64),
                         label.astype(np.float64), cfg)
        _close(b[0].numpy(), a[0], sg, EPS32, 4)
        _close(b[1].numpy(), a[1], sh, EPS32, 4)


@pytest.mark.parametrize("weighted", [False, True], ids=["unweighted",
                                                         "weighted"])
@pytest.mark.parametrize("name,K", CASES, ids=IDS)
def test_scalars_match_jax(name, K, weighted):
    """BoostFromScore, class_need_train, models per iteration, the output
    transform and the model-text string."""
    label, weight, score = _inputs(name, K, weighted, seed=2)
    jo, po, _ = _pair(name, K, label, weight)
    assert po.num_model_per_iteration == jo.num_model_per_iteration == K
    assert po.is_constant_hessian == jo.is_constant_hessian
    for c in range(K):
        assert po.boost_from_score(c) == jo.boost_from_score(c)
        assert po.class_need_train(c) == jo.class_need_train(c)
    raw = score.T.copy() if K > 1 else score
    np.testing.assert_array_equal(po.convert_output(raw),
                                  jo.convert_output(raw))
    assert po.to_string() == jo.to_string()
    assert po.device_gradients()[0] == "payload"


def test_reg_sqrt_has_no_payload_gradient():
    """reg_sqrt trains on the transformed label, which the payload does not
    hold: no payload gradient (the persistent grower runs its v1 gradient
    in row order, the JAX package's "row" mode), and its label, v1
    gradients, output transform and string are the JAX package's."""
    label, _, score = _inputs("regression", 1, False, seed=3)
    jo, po, _ = _pair("regression", 1, label, None, {"reg_sqrt": True})
    assert po.payload_grad_fn() is None
    assert po.device_gradients()[0] == jo.device_gradients()[0] == "row"
    np.testing.assert_array_equal(po.label, jo.label)
    gj, _ = jo.get_gradients(jnp.asarray(score))
    gp, _ = po.get_gradients(torch.as_tensor(score))
    np.testing.assert_array_equal(gp.numpy(), np.asarray(gj))
    np.testing.assert_array_equal(po.convert_output(score),
                                  jo.convert_output(score))
    assert po.to_string() == jo.to_string() == "regression sqrt"
    assert po.boost_from_score(0) == jo.boost_from_score(0)


def test_one_vs_all_class_without_rows():
    """A one-vs-all class with no positive row has nothing to train and
    starts from the clamped log-odds, as in the JAX package."""
    label = np.random.default_rng(4).integers(0, 2, N).astype(np.float32)
    jo, po, _ = _pair("multiclassova", 3, label, None)
    assert [po.class_need_train(c) for c in range(3)] == [True, True, False]
    assert [jo.class_need_train(c) for c in range(3)] == [True, True, False]
    assert po.boost_from_score(2) == jo.boost_from_score(2)


@pytest.mark.parametrize("alias", [
    "softmax", "multiclass", "ova", "ovr", "multiclass_ova", "l2", "mse",
    "mean_squared_error", "regression_l2", "rmse", "l2_root", "huber",
    "fair", "poisson", "gamma", "tweedie"])
def test_objective_aliases_match_jax(alias):
    params = {"objective": alias, "num_class": 3 if alias in (
        "softmax", "multiclass", "ova", "ovr", "multiclass_ova") else 1}
    assert lp.Config(params).objective == lt.Config(params).objective


@pytest.mark.parametrize("name", ["lambdarank", "rank_xendcg"])
def test_unported_objectives_are_refused(name):
    X, y = make_higgs_like(600, seed=5)
    p = {"objective": name, "device_type": "cpu", "verbosity": -1}
    with pytest.raises(LightGBMError,
                       match="ROADMAP.md queue A, item 17"):
        lp.train(p, lp.Dataset(X[:, :4], y, params=p), 1)


@pytest.mark.parametrize("params,match", [
    ({"objective": "multiclass"}, "greater than 1"),
    ({"objective": "multiclassova", "num_class": 1}, "greater than 1"),
    ({"objective": "binary", "num_class": 3}, "must be 1"),
    ({"objective": "regression", "num_class": 2}, "must be 1"),
])
def test_num_class_goes_with_a_multiclass_objective(params, match):
    """config.cpp CheckParamConflict: num_class > 1 with a multiclass
    objective and only with one."""
    with pytest.raises(LightGBMError, match=match):
        lp.Config(params)
