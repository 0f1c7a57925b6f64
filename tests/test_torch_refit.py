"""Refit: the port's Booster.refit against the JAX package's on the CPU, and
the per-leaf sums (ops/refit.py) against numpy.

- ``refit`` of one model text read by both packages (the port's own v1
  model, 4000 rows, 15 leaves, 5 iterations) on 2000 new rows, for
  regression, binary and softmax with 3 classes, at ``decay_rate`` 0.9 and
  0, and once with ``lambda_l1`` and ``max_delta_step`` set: the trees'
  structures and leaf counts follow the JAX package's, and the leaf values
  agree twice:
    * against the JAX package's refit with its objective's gradients
      rounded to f32 as the port rounds them (GBDT.refit: the growers'
      precision, which keeps card and CPU equal), within 2^-40 of the
      tree's largest |leaf value|: the same sums in the same order and the
      same leaf math, apart from the last bit of f64 ``exp`` (torch's
      against XLA's) where it moves an f32 rounding;
    * against the JAX package's refit as it is (f64 gradients), within
      2e-4 of the tree's largest |leaf value|, the f32-against-f64 leaf
      tolerance of tests/test_torch_persist.py (ROADMAP.md C3, C4).
- ``leaf_sums_plain`` (the kernel's plain twin) against a float64 numpy
  reference, ``np.bincount`` (a sequential sum in row order, the order the
  kernel keeps), bit for bit: random leaves with empty ones, one leaf
  holding every row, f32 gradients and hessians widened.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
from lightgbm_tpu.objectives.base import ObjectiveFunction
import lightgbm_torch as lp
from lightgbm_torch.ops import counters
from lightgbm_torch.ops.refit import (leaf_segments, leaf_sums,
                                      leaf_sums_plain, per_leaf_sums)
from lightgbm_torch.utils.log import LightGBMError
from test_torch_multiclass import BASE, class_data

CPU = {"device_type": "cpu"}
BOUND = 2.0 ** -40
OBJECTIVES = {"regression": {"objective": "regression"},
              "binary": {"objective": "binary"},
              "softmax": {"objective": "multiclass", "num_class": 3}}


def _data(name, seed):
    X, y = class_data(n=6000, K=3 if name == "softmax" else 2, seed=seed)
    if name == "regression":
        y = y + np.nan_to_num(X[:, 1]) + 0.1 * np.nan_to_num(X[:, 2])
    return X, y


@pytest.fixture(scope="module")
def models():
    """name -> (the port's model text, new rows, their labels)."""
    out = {}
    for i, (name, obj) in enumerate(sorted(OBJECTIVES.items())):
        X, y = _data(name, 20 + i)
        p = dict(BASE, num_leaves=15, tpu_persist_scan="false", **obj, **CPU)
        bst = lp.train(p, lp.Dataset(X[:4000], y[:4000], params=p), 5)
        out[name] = (bst.model_to_string(), X[4000:], y[4000:])
    return out


CASES = [(name, decay, {}) for name in sorted(OBJECTIVES)
         for decay in (0.9, 0.0)] + \
        [("binary", 0.9, {"lambda_l1": 0.5, "max_delta_step": 0.3})]


def _jax_refit(text, p, X, y, decay, f32):
    """The JAX package's refit; with `f32` its objectives' gradients are
    rounded to f32 first, as the port rounds them (every objective here
    computes them in ObjectiveFunction.get_gradients)."""
    bj = lt.Booster(params=dict(p), model_str=text)
    if not f32:
        return bj.refit(X, y, decay_rate=decay)
    orig = ObjectiveFunction.get_gradients

    def rounded(self, score):
        return tuple(np.asarray(v).astype(np.float32).astype(np.float64)
                     for v in orig(self, score))
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ObjectiveFunction, "get_gradients", rounded)
        return bj.refit(X, y, decay_rate=decay)


@pytest.mark.parametrize("name,decay,extra", CASES)
def test_refit_matches_jax(models, name, decay, extra):
    text, X, y = models[name]
    p = dict(BASE, num_leaves=15, **OBJECTIVES[name], **extra)
    refits = {f32: _jax_refit(text, p, X, y, decay, f32)
              for f32 in (True, False)}
    src = lp.Booster(params=dict(p, **CPU), model_str=text)
    rp = src.refit(X, y, decay_rate=decay)
    tp = rp._booster.models
    changed = 0
    for f32, rtol in ((True, BOUND), (False, 2e-4)):
        tj = refits[f32]._booster.models
        assert len(tj) == len(tp) == len(src._booster.models)
        for a, b in zip(tj, tp):
            k = a.num_leaves
            assert b.num_leaves == k
            for f in ("split_feature", "threshold", "decision_type",
                      "left_child", "right_child"):
                np.testing.assert_array_equal(getattr(b, f)[:k - 1],
                                              getattr(a, f)[:k - 1], f)
            np.testing.assert_array_equal(b.leaf_count[:k],
                                          a.leaf_count[:k])
            assert b.leaf_count[:k].sum() == len(y)
            bound = rtol * np.abs(a.leaf_value[:k]).max()
            assert np.all(np.abs(b.leaf_value[:k] - a.leaf_value[:k])
                          <= bound), (f32, np.abs(
                              b.leaf_value[:k] - a.leaf_value[:k]).max(),
                              bound)
    for b, old in zip(tp, src._booster.models):
        k = b.num_leaves
        changed += not np.array_equal(b.leaf_value[:k], old.leaf_value[:k])
        if extra:
            # the fit part of the blend is clamped to max_delta_step x lr
            lim = (1 - decay) * extra["max_delta_step"] * p["learning_rate"]
            fit = b.leaf_value[:k] - decay * old.leaf_value[:k]
            assert np.all(np.abs(fit) <= lim * (1 + 1e-12))
            assert np.any(np.abs(fit) >= lim * (1 - 1e-12))
    assert changed == len(tp)            # every tree was fit again
    np.testing.assert_allclose(rp.predict(X, raw_score=True),
                               refits[True].predict(X, raw_score=True),
                               rtol=0, atol=1e-12)
    # the source model is left as it was
    assert src.model_to_string().split("parameters:")[0] == \
        text.split("parameters:")[0]


def test_refit_of_an_empty_model_raises():
    X, y = class_data(n=600, K=2, seed=3)
    p = dict(BASE, objective="binary", **CPU)
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    with pytest.raises(LightGBMError, match="empty model"):
        bst.refit(X, y)


def _numpy_sums(leaf, g, h, L):
    return np.stack([np.bincount(leaf, weights=g, minlength=L)[:L],
                     np.bincount(leaf, weights=h, minlength=L)[:L],
                     np.bincount(leaf, minlength=L)[:L].astype(np.float64)],
                    1)


LEAVES = {"random with empty leaves": (5000, 31),
          "one leaf": (3000, 1), "every row in one of many": (2000, 9)}


@pytest.mark.parametrize("case", sorted(LEAVES))
def test_leaf_sums_plain_matches_bincount(case):
    n, L = LEAVES[case]
    rng = np.random.default_rng(len(case))
    if case == "every row in one of many":
        leaf = np.full(n, 4, np.int32)
    else:
        leaf = rng.integers(0, L, n).astype(np.int32)
        leaf[leaf == min(3, L - 1)] = 0 if L > 1 else leaf[0]
    g32 = rng.normal(size=n).astype(np.float32)
    g32[::7] = -0.0
    h32 = rng.uniform(0.01, 0.25, n).astype(np.float32)
    want = _numpy_sums(leaf, g32.astype(np.float64), h32.astype(np.float64),
                       L)
    before = counters.read("cpu")["leaf_sums"]
    got = per_leaf_sums(torch.as_tensor(leaf), torch.as_tensor(g32),
                        torch.as_tensor(h32), L).numpy()
    assert counters.read("cpu")["leaf_sums"] == before + 1
    assert got.tobytes() == want.tobytes()
    order, seg = leaf_segments(torch.as_tensor(leaf), L)
    assert np.array_equal(order.numpy(), np.argsort(leaf, kind="stable"))
    assert seg[:, 1].sum() == n


def test_leaf_sums_checks_its_operands():
    order, seg = leaf_segments(torch.tensor([0, 1, 1]), 2)
    g = torch.zeros(3, dtype=torch.float32)
    out = torch.empty((2, 3), dtype=torch.float64)
    with pytest.raises(LightGBMError, match="grad"):
        leaf_sums(order, g.double(), g, seg, out)
    with pytest.raises(LightGBMError, match="out"):
        leaf_sums(order, g, g, seg, out[:1])
    with pytest.raises(LightGBMError, match="leaf index"):
        leaf_segments(torch.tensor([0, 3]), 2)
    leaf_sums_plain(order, g + 1, g + 2, seg, out)
    assert out.tolist() == [[1.0, 2.0, 1.0], [2.0, 4.0, 2.0]]
