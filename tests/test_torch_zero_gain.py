"""Zero-gain splits at the default min_gain_to_split = 0: the port against
the JAX package (ROADMAP.md queue C, item 5).

A split whose true gain is zero (a leaf whose rows all have the same
gradient ratio, so no partition of them changes the loss) gets a
rounding-sized gain of either sign: the JAX package (f64 on the CPU) sees
~1e-13, the port (f32) ~1e-5, and min_gain_to_split = 0 lets either take
such a split or not. The other parity tests set min_gain_to_split = 1e-3
to keep these splits out; this test keeps the default and holds what may
differ to that rounding.

Data: HIGGS-shaped rows (8 features) whose target is a step function of
feature 0 (softmax: three classes by its value; L2: 0/1; Poisson: counts
0/2), so after the first split the leaves are pure and every later split
has zero true gain. Both packages train 3 iterations of 15 leaves on the
v1 route.

The trees are walked in parallel from the root. Where both nodes split the
same feature and send the same training rows left, the walk goes on into
the children. Where they differ, every split of both subtrees must have a
rounding-sized |gain|: at most 8 f32 epsilons of the tree's total gain
(each gain is a sum of G^2 / H terms, none of which exceeds the tree's
total, so f32 rounds it by a few epsilons of that). Elsewhere, the rows
reach leaves whose values agree within tests/test_torch_multiclass.py's
leaf bounds. A row under a differing split gets its subtree's value, which
a zero-gain split leaves at its parent's up to rounding: it is allowed the
tree's largest leaf bound. The final raw scores agree on every row within
the sum of its trees' allowances.
"""
import numpy as np
import pytest

import lightgbm_tpu as lt
import lightgbm_torch as lp
from test_torch_multiclass import BASE, EPS32, higgs_latent, leaf_bounds
from test_torch_regression import gmax

PARAMS = {k: v for k, v in BASE.items() if k != "min_gain_to_split"}


def _data(objective):
    X, _ = higgs_latent(2000, 3)
    X = X[:, :8].copy()
    if objective == "multiclass":
        return X, np.digitize(X[:, 0], [-0.5, 0.5]).astype(np.float64)
    if objective == "regression":
        return X, (X[:, 0] > 0).astype(np.float64)
    return X, 2.0 * (X[:, 0] > 0)


def _subtree_gains(tree, node):
    """The gains of every split in the subtree under `node` (>= 0)."""
    out, stack = [], [node]
    while stack:
        k = stack.pop()
        out.append(tree.split_gain[k])
        stack += [c for c in (tree.left_child[k], tree.right_child[k])
                  if c >= 0]
    return out


def _compare(a, b, X, lr, g):
    """Walk tree a (JAX) and tree b (port) in parallel; returns each
    row's allowance for this tree's output."""
    tol = 8 * EPS32 * max(np.abs(t.split_gain[:t.num_leaves - 1]).sum()
                          for t in (a, b))
    bound = leaf_bounds(a, X.shape[0], lr, False, g)
    slack = np.full(X.shape[0], np.nan)
    stack = [(0 if a.num_leaves > 1 else ~0, 0 if b.num_leaves > 1 else ~0,
              np.arange(X.shape[0]))]
    while stack:
        na, nb, rows = stack.pop()
        if na < 0 and nb < 0:
            assert abs(a.leaf_value[~na] - b.leaf_value[~nb]) <= bound[~na]
            slack[rows] = bound[~na]
            continue
        if na >= 0 and nb >= 0 and a.split_feature[na] == \
                b.split_feature[nb]:
            fv = X[rows, a.split_feature[na]]
            la = a._decision(fv, np.full(len(rows), na))
            lb = b._decision(fv, np.full(len(rows), nb))
            if np.array_equal(la, lb):
                stack.append((a.left_child[na], b.left_child[nb], rows[la]))
                stack.append((a.right_child[na], b.right_child[nb],
                              rows[~la]))
                continue
        gains = (_subtree_gains(a, na) if na >= 0 else []) + \
            (_subtree_gains(b, nb) if nb >= 0 else [])
        assert max(np.abs(gains)) <= tol, (gains, tol)
        slack[rows] = bound.max()
    assert not np.isnan(slack).any()
    return slack


@pytest.mark.parametrize("objective", ["multiclass", "regression",
                                       "poisson"])
def test_zero_gain_splits_are_rounding_sized(objective):
    X, y = _data(objective)
    params = dict(PARAMS, objective=objective, num_leaves=15)
    if objective == "multiclass":
        params["num_class"] = 3
    bj = lt.train(dict(params), lt.Dataset(X, y), 3)
    pp = dict(params, device_type="cpu", tpu_persist_scan="false")
    bp = lp.train(pp, lp.Dataset(X, y, params=pp), 3)
    ta, tb = bj._booster._used_models(), bp._booster.models
    assert len(ta) == len(tb)
    g = 1.0 if objective == "multiclass" else gmax(bp)
    # the data make zero-gain splits: the JAX package takes some
    assert any((np.abs(t.split_gain[:t.num_leaves - 1]) < 1e-9).any()
               for t in ta)
    K = params.get("num_class", 1)
    slack = np.zeros((X.shape[0], K))
    for i, (a, b) in enumerate(zip(ta, tb)):
        slack[:, i % K] += _compare(a, b, X, params["learning_rate"], g)
    diff = np.abs(bp.predict(X, raw_score=True)
                  - bj.predict(X, raw_score=True)).reshape(-1, K)
    assert (diff <= slack).all()
