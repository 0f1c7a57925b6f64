"""Leaf renewal (ops/renew.py) against the JAX package's, on the CPU.

The JAX package renews on the host: for each leaf, the rows of the row ->
leaf map in row order, their residuals label - score, and the reference's
PercentileFun / WeightedPercentileFun (lightgbm_tpu/objectives/base.py:
214-256, boosting/gbdt.py:747-766). The port orders the rows by (segment,
residual, row) with two stable sorts and runs the ``renew_leaf`` kernel,
here its plain version. Every comparison is exact (np.testing's array
equality, and == on floats): the same f64 operations on the same values
in the same order.

Inputs: seeded numpy; residuals drawn from a few integers (ties, which
decide the weighted cdf's order), segments of 0, 1, 2 and many rows, and
alphas that reach both clamps of the unweighted percentile (pos < 1 and
pos >= n) and both ends of the weighted one.
"""
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_tpu.boosting.gbdt import GBDT as JaxGBDT
from lightgbm_tpu.models.tree import Tree as JaxTree
from lightgbm_tpu.objectives import base as jax_base
from lightgbm_tpu.objectives import create_objective as jax_objective
from lightgbm_torch.objectives import base as port_base
from lightgbm_torch.objectives import create_objective as port_objective
from lightgbm_torch.ops import counters
from lightgbm_torch.ops import grow_step as gs
from lightgbm_torch.ops.renew import renew_leaf, renew_segments, segment_order
from lightgbm_torch.utils.log import LightGBMError

ALPHAS = (0.5, 0.1, 0.9, 0.01, 0.99)
# segment sizes: empty, one row, two rows, small, and one large enough that
# 1 - alpha and alpha times it cross whole rows
SIZES = (0, 1, 2, 3, 7, 40, 0, 1, 2, 513)


def tied(rng, n, levels=5):
    """n residual-like values from a few integers (many ties), as f64."""
    return rng.integers(-levels, levels + 1, n).astype(np.float64)


def segments(rng, sizes=SIZES):
    """(key [n] int64 in row order, the sizes in key order): each row's
    segment drawn at random, so a segment's rows are not contiguous."""
    key = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(key)
    return key, np.asarray(sizes, np.int64)


def seg_table(sizes):
    sizes = torch.as_tensor(sizes)
    return torch.stack([torch.cumsum(sizes, 0) - sizes, sizes], 1)


@pytest.mark.parametrize("alpha", ALPHAS)
@pytest.mark.parametrize("n", [0, 1, 2, 3, 10, 101])
def test_percentile_helpers_match_jax(n, alpha):
    """The port's copies of the helpers give the JAX package's values, with
    ties, with equal and with zero weights."""
    rng = np.random.default_rng(n)
    data = tied(rng, n)
    assert port_base.percentile(data, alpha) == \
        jax_base.percentile(data, alpha)
    for w in (rng.uniform(0.1, 3.0, n), np.ones(n), np.full(n, 0.25),
              np.where(rng.random(n) < 0.3, 0.0, 2.0)):
        assert port_base.weighted_percentile(data, w, alpha) == \
            jax_base.weighted_percentile(data, w, alpha)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("alpha", ALPHAS)
def test_renew_segments_match_jax_percentiles(alpha, weighted):
    """Each segment's value is the JAX package's percentile of its rows in
    row order; an empty segment keeps its value."""
    rng = np.random.default_rng(int(alpha * 1000) + weighted)
    key, sizes = segments(rng)
    n = len(key)
    res = tied(rng, n)
    w = rng.uniform(0.2, 3.0, n).astype(np.float32) if weighted else None
    out = torch.full((len(sizes),), 7.25, dtype=torch.float64)
    renew_segments(torch.as_tensor(res), torch.as_tensor(key),
                   None if w is None else torch.as_tensor(w),
                   seg_table(sizes), out, alpha)
    for i, size in enumerate(sizes):
        rows = np.nonzero(key == i)[0]
        if size == 0:
            want = 7.25
        elif weighted:
            want = jax_base.weighted_percentile(res[rows], w[rows], alpha)
        else:
            want = jax_base.percentile(res[rows], alpha)
        assert float(out[i]) == want, i


def test_segment_order_keeps_row_order_on_ties():
    """Rows grouped by key, ascending residual inside, ties in row order,
    and -0.0 ordered as +0.0 once canonicalized."""
    rng = np.random.default_rng(5)
    key = rng.integers(0, 4, 300)
    res = tied(rng, 300, levels=2)
    res[(res == 0) & (rng.random(300) < 0.5)] = -0.0
    order = segment_order(torch.as_tensor(res) + 0.0,
                          torch.as_tensor(key)).numpy()
    want = np.lexsort((np.arange(300), res, key))
    np.testing.assert_array_equal(order, want)


def test_nseg_limits_the_renewal():
    """With a device scalar nseg only the first nseg segments are renewed,
    and none for a tree of one leaf (nseg = 1); f32 outputs round the f64
    value once."""
    rng = np.random.default_rng(8)
    key, sizes = segments(rng, (5, 6, 7, 8))
    res = torch.as_tensor(rng.normal(size=len(key)))
    for s, renewed in ((1, 0), (2, 2), (3, 3), (9, 4)):
        out = torch.full((4,), -1.0, dtype=torch.float32)
        renew_segments(res, torch.as_tensor(key), None, seg_table(sizes),
                       out, 0.5, torch.tensor([s]))
        assert int((out != -1.0).sum()) == renewed, s
        for i in range(renewed):
            rows = np.nonzero(key == i)[0]
            assert float(out[i]) == float(np.float32(
                jax_base.percentile(res.numpy()[rows], 0.5)))


def test_renew_leaf_counts_and_checks():
    rng = np.random.default_rng(2)
    key, sizes = segments(rng, (3, 4))
    res = torch.as_tensor(rng.normal(size=7))
    counters.reset("cpu")
    out = torch.zeros(2, dtype=torch.float64)
    renew_segments(res, torch.as_tensor(key), None, seg_table(sizes), out,
                   0.5)
    assert counters.read("cpu")["renew_leaf"] == 1
    order = segment_order(res, torch.as_tensor(key))
    for bad in (dict(order=order.int()), dict(residual=res.float()),
                dict(weight=torch.ones(7, dtype=torch.float64)),
                dict(seg=seg_table(sizes).int()),
                dict(seg=seg_table(sizes).t().contiguous().t()),
                dict(out=torch.zeros(3, dtype=torch.float64)),
                dict(nseg=torch.tensor([2], dtype=torch.int32))):
        args = dict(order=order, residual=res, weight=None,
                    seg=seg_table(sizes), out=out, alpha=0.5, nseg=None)
        args.update(bad)
        with pytest.raises(LightGBMError, match="renew_leaf"):
            renew_leaf(**args)


def _pair(name, label, weight, extra=None):
    params = dict({"objective": name}, **(extra or {}))
    md = SimpleNamespace(label=label, weight=weight, init_score=None)
    jc, pc = lt.Config(params), lp.Config(params)
    jo = jax_objective(jc.objective, jc)
    po = port_objective(pc.objective, pc)
    jo.init(md, len(label))
    po.init(md, len(label))
    return jo, po


@pytest.mark.parametrize("name,extra,weighted", [
    ("regression_l1", None, False), ("regression_l1", None, True),
    ("quantile", {"alpha": 0.9}, True), ("quantile", {"alpha": 0.1}, False),
    ("mape", None, False), ("mape", None, True),
    ("regression_l1", {"reg_sqrt": True}, False)])
def test_renew_tree_output_matches_jax_gbdt(name, extra, weighted):
    """objective.renew_tree_output over a fixed row -> leaf map equals the
    JAX package's GBDT._renew_tree_output (its label, weights or MAPE's
    label weights; with reg_sqrt the dataset's label), leaf for leaf, an
    empty leaf keeping the grower's value."""
    rng = np.random.default_rng(len(name) + weighted)
    n, L = 3000, 9
    label = np.round(rng.normal(size=n) * 4).astype(np.float32)   # ties
    if extra and extra.get("reg_sqrt"):
        label = np.abs(label)
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32) if weighted \
        else None
    score = rng.normal(size=n)
    row_leaf = rng.integers(0, L - 1, n).astype(np.int32)  # leaf 8 empty
    jo, po = _pair(name, label, weight, extra)
    grower = rng.normal(size=L).astype(np.float32)
    tree = JaxTree(L)
    tree.num_leaves = L
    tree.leaf_value[:L] = grower
    stub = SimpleNamespace(
        train_score=SimpleNamespace(score_device=lambda k: jnp.asarray(score)),
        train_data=SimpleNamespace(metadata=SimpleNamespace(
            label=label, weight=weight)),
        _bag_mask_dev=jnp.ones(n, bool), objective=jo)
    JaxGBDT._renew_tree_output(stub, tree, jnp.asarray(row_leaf), 0)
    key = torch.as_tensor(row_leaf.astype(np.int64))
    count = torch.bincount(key, minlength=L)
    out = torch.as_tensor(grower.astype(np.float64))
    assert po.is_renew_tree_output and jo.is_renew_tree_output
    po.renew_tree_output(torch.as_tensor(score), key, seg_table(count), out)
    np.testing.assert_array_equal(out.numpy(), tree.leaf_value[:L])
    assert out[L - 1] == float(grower[L - 1])


@pytest.mark.parametrize("name,weighted", [("regression_l1", False),
                                           ("quantile", True),
                                           ("mape", False)])
def test_persist_renew_matches_row_leaf_renewal(name, weighted):
    """The persistent grower's renewal reads its leaves' payload segments
    from the device leaf table; on a grown tree it gives each leaf the
    value the JAX package's renewal computes from the tree's row -> leaf
    map and the payload's f32 scores (widened), rounded once to the
    table's f32."""
    from test_torch_multiclass import BASE, higgs_latent
    n = 3000
    X, latent = higgs_latent(n, 12)
    X = X[:, :8].copy()
    y = np.round(latent * 3 + np.random.default_rng(12).normal(size=n))
    w = np.random.default_rng(13).uniform(0.5, 2.0, n) if weighted else None
    p = dict(BASE, objective=name, alpha=0.7, num_leaves=15,
             tpu_persist_scan="force", device_type="cpu")
    bst = lp.Booster(p, lp.Dataset(X, y, weight=w, params=p))
    obj, learner = bst._booster.objective, bst._booster.tree_learner
    gr = learner._persist_grower(1, obj.device_gradients()[0] == "payload")
    score = np.random.default_rng(14).normal(size=n).astype(np.float32)
    pay = gr.init_carry(torch.as_tensor(score))
    mode, fn = obj.device_gradients()
    if mode == "row":
        gr.fill_grad_row(pay, fn)
    else:
        gr.fill_grad(pay, fn)
    gr._prepare(np.ones(X.shape[1], bool))
    gr._tree(pay)
    before = gr.state.lf[:, gs.LF_VALUE].clone()
    gr.renew(pay, obj.renew_tree_output)
    lstate, _, s = gr.read_tree()
    assert s >= 8
    rid = pay[gr.nbw + 1, :n].numpy()
    row_leaf = np.empty(n, np.int64)
    for leaf in range(s):
        st, nr = int(lstate.start[leaf]), int(lstate.nrows[leaf])
        row_leaf[rid[st:st + nr]] = leaf
    md = bst._booster.train_data.metadata
    jo, _ = _pair(name, md.label, md.weight, {"alpha": 0.7})
    tree = JaxTree(15)
    tree.num_leaves = s
    tree.leaf_value[:s] = before.numpy()[:s]
    stub = SimpleNamespace(
        train_score=SimpleNamespace(score_device=lambda k: jnp.asarray(
            score.astype(np.float64))),
        train_data=SimpleNamespace(metadata=md),
        _bag_mask_dev=jnp.ones(n, bool), objective=jo)
    JaxGBDT._renew_tree_output(stub, tree, jnp.asarray(row_leaf), 0)
    np.testing.assert_array_equal(lstate.value[:s],
                                  tree.leaf_value[:s].astype(np.float32))
    assert np.any(lstate.value[:s] != before.numpy()[:s])
