"""Multiclass training (softmax and one-vs-all) of the port against the JAX
package's, on both growers.

Data: HIGGS-shaped rows (make_higgs_like, 8 of its features, 5% missing
values) and K classes cut from the latent that make_higgs_like thresholds
(the logit plus its logistic noise) at its 1/K quantiles, as chip_smoke.py
cuts the HIGGS multiclass path's five.

Routes: the persistent grower's per-split loop (``tpu_persist_scan=force``;
the JAX package's persistent path engages only in fused batches of 16
iterations, so those comparisons train 16 and assert that its carry is
live), its level phase (``max_depth=3``) and the v1 grower (``off``, 5
iterations); 7 leaves (8 at depth 3 for the level phase) keep the JAX
interpret runs short. The JAX persistent path runs its Pallas kernels in interpret
mode (``SerialTreeLearner._persist_kernel_mode`` patched, as
tests/test_torch_persist.py does): f32 payload scores and f32 histograms,
the arithmetic the port's kernels port. Its default off the TPU, the
widened XLA emulation, keeps f64 scores and histograms; against it the
hessian-estimated child counts of a small leaf can round across
min_data_in_leaf and pick another split (seen on a one-vs-all class tree
at depth 2), so these tests do not use it.

Trees must be equal in split features, children, internal and leaf counts,
and in the partition of the training rows (every row reaches the same
leaf). Thresholds are not compared apart from that: where the bins between
two thresholds hold no row of the leaf, both thresholds split the leaf's
rows the same way with equal gains, and rounding picks one. A split whose
true gain is zero (a leaf whose rows the objective cannot separate) gets a
rounding-sized gain of either sign in f32 and in f64; ``min_gain_to_split``
= 1e-3 keeps such splits out of both packages' trees. Leaf values follow
tests/test_torch_persist.py: rtol 2e-4, or, near zero, 4 f32 ulps of
sum|grad| over the leaf's hessian times the learning rate (|grad| <= 1
here, so sum|grad| <= n), plus 2 * 2^-17 * n for the MXU hi/lo split of
the Pallas kernels. The raw [n, K] scores then differ by at most the sum of
the leaf bounds along each row's path.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lt
from lightgbm_tpu.treelearner.serial import SerialTreeLearner as JaxLearner
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.ops import payload

ROUNDS = 16
EPS32 = float(np.finfo(np.float32).eps)
BASE = {"num_leaves": 7, "max_bin": 63, "min_data_in_leaf": 20,
        "min_gain_to_split": 1e-3, "learning_rate": 0.2, "verbosity": -1}


def higgs_latent(n, seed=7, n_features=28):
    """(X, latent): make_higgs_like's rows and the f32 latent it
    thresholds at 0 (its logit plus its logistic noise, redrawn from the
    same seed)."""
    X, y = make_higgs_like(n, n_features, seed)
    rng = np.random.default_rng(seed)
    rng.normal(size=(n, n_features))            # the features' draw
    x = X.astype(np.float32)
    logit = (0.8 * x[:, 0] - 0.5 * x[:, 1] + 0.4 * x[:, 21]
             - 0.3 * x[:, 22] + 0.5 * np.tanh(x[:, 4] * x[:, 5]))
    latent = logit + rng.logistic(size=n).astype(np.float32) * 0.8
    assert np.array_equal(latent > 0, y > 0)
    return X, latent


def class_data(n=4000, K=3, seed=3, f=8, missing=0.05):
    """HIGGS-shaped rows and K quantile classes of their latent."""
    X, latent = higgs_latent(n, seed)
    y = np.digitize(latent, np.quantile(latent, np.arange(1, K) / K))
    X = X[:, :f].copy()
    if missing:
        X[np.random.default_rng(seed).random(X.shape) < missing] = np.nan
    return X, y.astype(np.float64)


def train_jax(params, X, y, rounds, pallas=False, monkeypatch=None,
              weight=None):
    if pallas:
        monkeypatch.setattr(JaxLearner, "_persist_kernel_mode",
                            staticmethod(lambda: ("pallas", True)))
    bj = lt.train(dict(params), lt.Dataset(X, y, weight=weight), rounds)
    if pallas:
        monkeypatch.undo()
    persist = getattr(bj._booster.tree_learner, "_persist_carry", None)
    assert (persist is not None) == (params.get("tpu_persist_scan")
                                     == "force" and rounds >= 16)
    return bj


def train_port(params, X, y, rounds, weight=None):
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, weight=weight, params=p), rounds)
    assert bp._booster.use_persist == (p.get("tpu_persist_scan") == "force")
    return bp


def leaf_bounds(tree, n, lr, mxu, gmax=1.0):
    """The allowed |leaf value - reference| of each leaf of `tree` (the
    reference's), with every |grad| at most `gmax`."""
    k = tree.num_leaves
    v = tree.leaf_value[:k]
    cancel = (4 * EPS32 + (2 * 2.0 ** -17 if mxu else 0.0)) * n * gmax \
        / np.maximum(tree.leaf_weight[:k], 1e-300) * lr
    return np.maximum(2e-4 * np.abs(v) + 1e-7, cancel)


def assert_same_models(bj, bp, X, lr, K, mxu=False, min_leaves=3,
                       gmax=1.0):
    """The two boosters' trees agree by the module's rules, and so do
    their raw [n, K] predictions."""
    ref, mine = bj._booster._used_models(), bp._booster.models
    assert len(ref) == len(mine)
    n = X.shape[0]
    slack = np.zeros((n, K))
    for i, (a, b) in enumerate(zip(ref, mine)):
        assert a.num_leaves == b.num_leaves, i
        k = a.num_leaves - 1
        if k == 0:
            assert a.leaf_value[0] == b.leaf_value[0], i
            continue
        assert a.num_leaves >= min_leaves, i
        for f in ("split_feature", "left_child", "right_child",
                  "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k], "%s %d" % (f, i))
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        leaf = a.predict_leaf(X)
        np.testing.assert_array_equal(leaf, b.predict_leaf(X))
        bound = leaf_bounds(a, n, lr, mxu, gmax)
        assert np.all(np.abs(b.leaf_value[:k + 1] - a.leaf_value[:k + 1])
                      <= bound), i
        slack[:, i % K] += bound[leaf]
    rj = bj.predict(X, raw_score=True).reshape(n, -1)
    rp = bp.predict(X, raw_score=True).reshape(n, -1)
    assert rp.shape == rj.shape == (n, K)
    assert np.all(np.abs(rp - rj) <= slack + 1e-12)


ROUTES = {"persist": ({"tpu_persist_scan": "force"}, ROUNDS),
          "level": ({"tpu_persist_scan": "force", "max_depth": 3,
                     "num_leaves": 8}, ROUNDS),
          "v1": ({"tpu_persist_scan": "off"}, 5)}


@pytest.mark.parametrize("route", ["persist", "v1"])
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_matches_jax(objective, route, monkeypatch):
    """The per-split and v1 routes (the level phase:
    tests/test_torch_multiclass_level.py)."""
    check_route(objective, route, monkeypatch)


def check_route(objective, route, monkeypatch):
    extra, rounds = ROUTES[route]
    params = dict(BASE, objective=objective, num_class=3, **extra)
    X, y = class_data(n=3000)
    pallas = route != "v1"
    bj = train_jax(params, X, y, rounds, pallas, monkeypatch)
    bp = train_port(params, X, y, rounds)
    assert len(bp._booster.models) == 3 * rounds
    assert_same_models(bj, bp, X, params["learning_rate"], 3, mxu=pallas)
    if route != "v1":
        gr = bp._booster.tree_learner._persist_gr
        assert gr.K == 3 and gr.use_level == (route == "level")
        assert all((lv > 0) == (route == "level") for lv, _ in gr.grow_stats)
        assert len(gr.grow_stats) == 3 * rounds
    # the device scores synced from the payload are the numpy walk's
    walk = bp.predict(X, raw_score=True)
    score = bp._booster.train_score.score.numpy().T
    tol = (1e-9 if route == "v1" else
           2 * (rounds + 1) * EPS32 * max(1.0, np.abs(walk).max()))
    assert np.max(np.abs(score - walk)) <= tol


def test_weighted_softmax_matches_jax(monkeypatch):
    """Four classes with sample weights, which ride the payload as one more
    row (after the K score and K snapshot rows) and multiply each class's
    gradients."""
    params = dict(BASE, objective="multiclass", num_class=4,
                  tpu_persist_scan="force")
    X, y = class_data(n=2000, K=4, seed=9)
    w = np.random.default_rng(9).uniform(0.5, 2.0, len(y))
    bj = train_jax(params, X, y, ROUNDS, True, monkeypatch, weight=w)
    bp = train_port(params, X, y, ROUNDS, weight=w)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.weight_row == gr.nbw + 4 + 2 * 4 == gr.wp_live - 1
    assert_same_models(bj, bp, X, params["learning_rate"], 4, mxu=True)


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("K", [1, 2, 3, 4, 5, 6, 7])
def test_payload_rows_match_jax(K, weighted, monkeypatch):
    """The carry of K score rows, their snapshot and the class gradients
    sit at the JAX package's rows: after init_carry and snapshot_scores the
    port's payload equals the JAX grower's bit for bit (its f32 layout,
    the Pallas mode); after fill_grad_multi the grad/hess rows agree
    within the objective's tolerance (tests/test_torch_objectives.py)."""
    n = 3000
    X, y = class_data(n=n, K=max(K, 2), seed=K)
    params = dict(BASE, objective="multiclass" if K > 1 else "binary",
                  num_class=K, tpu_persist_scan="force")
    w = (np.random.default_rng(K).uniform(0.5, 2.0, n) if weighted
         else None)
    monkeypatch.setattr(JaxLearner, "_persist_kernel_mode",
                        staticmethod(lambda: ("pallas", True)))
    bj = lt.Booster(dict(params), lt.Dataset(X, y, weight=w))
    jl = bj._booster.tree_learner
    jassets, jgr, _ = jl._persist_cached(bj._booster.objective, 1)
    p = dict(params, device_type="cpu")
    bp = lp.Booster(p, lp.Dataset(X, y, weight=w, params=p))
    gr = bp._booster.tree_learner._persist_grower(K)
    geo = gr.assets.geometry
    assert geo == tuple(jassets.geometry)
    np.testing.assert_array_equal(gr.assets.pay0, np.asarray(jassets.pay0))
    nbw = geo[4]
    assert gr.wp_live == payload.payload_weight_row(nbw, K) + weighted
    assert gr.second.shape[0] == gr.wp_live
    assert gr.score_row == nbw + 4
    assert gr.snap_row == nbw + 4 + K
    scores = np.random.default_rng(K).normal(size=(K, n))
    pay_j = jgr.init_carry(jassets.pay0, jnp.asarray(scores.reshape(
        (K, n) if K > 1 else (n,))))
    pay_p = gr.init_carry(torch.as_tensor(scores if K > 1 else scores[0]))
    if K > 1:
        pay_j = jgr.snapshot_scores(pay_j)
        gr.snapshot_scores(pay_p)
    np.testing.assert_array_equal(pay_p.numpy().view(np.uint32),
                                  np.asarray(pay_j))
    fin = gr.finalize_scores(pay_p).numpy()
    np.testing.assert_array_equal(
        fin, scores.astype(np.float32).astype(np.float64).reshape(fin.shape))
    if K > 1:
        cls = K - 1
        pay_j = jgr.fill_grad_multi(
            pay_j, bj._booster.objective.payload_grad_fn_multi(), cls)
        gr.fill_grad_multi(pay_p, bp._booster.objective.device_gradients()[1],
                           cls)
        rows = slice(nbw + 2, nbw + 4)
        gj = np.asarray(pay_j)[rows].view(np.float32)
        gp = pay_p.numpy()[rows].view(np.float32)
        scale = 1.0 if w is None else np.pad(w, (0, gj.shape[1] - n))
        assert np.all(np.abs(gp.astype(np.float64) - gj)
                      <= 4 * EPS32 * scale)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_model_text_loads_both_ways(objective):
    """A JAX multiclass model predicts the same [n, K] in the port, raw and
    converted, and a port model the same in the JAX package."""
    params = dict(BASE, objective=objective, num_class=3)
    X, y = class_data(n=3000, seed=6)
    bj = lt.train(dict(params), lt.Dataset(X, y), 3)
    bp = train_port(dict(params, tpu_persist_scan="force"), X, y, 3)
    for src, dst_cls in ((bj, lp.Booster), (bp, lt.Booster)):
        text = src.model_to_string()
        assert "num_tree_per_iteration=3" in text
        dst = dst_cls(model_str=text, params={"device_type": "cpu"})
        assert len(dst._booster.models) == 9
        assert dst._booster.current_iteration == 3
        for raw in (True, False):
            a = src.predict(X, raw_score=raw)
            b = dst.predict(X, raw_score=raw)
            assert a.shape == b.shape == (3000, 3)
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(
            dst.predict(X, raw_score=True, num_iteration=2),
            src.predict(X, raw_score=True, num_iteration=2))
    assert bp.model_to_string().split("\nparameters:")[0] == lp.Booster(
        model_str=bp.model_to_string()).model_to_string().split(
            "\nparameters:")[0]


@pytest.mark.parametrize("route", ["persist", "v1"])
def test_class_without_rows_gets_constant_tree(route):
    """Softmax over 4 classes where class 3 has no row: it has nothing to
    train, so every iteration gets a constant tree for it (its
    BoostFromScore at the first, 0 after), which the reference also adds to
    its scores once; the other classes train as usual, on the persistent
    grower too, whose iteration holds the same three class trees every time
    (a fixed graph on the card). The JAX package takes its per-class v1
    path here (gbdt.py:670-745), in f64: the port's v1 route is held to it,
    and the persistent route (f32 payload scores) to the port's v1 route.
    Against the JAX package the constant trees and the empty class's scores
    are compared: its per-class path's trees move with the process's
    history (runs of this test after other training in one process grew
    other splits), so they are not a reference here."""
    params = dict(BASE, objective="multiclass", num_class=4,
                  **ROUTES[route][0])
    X, y = class_data(K=3, seed=5)
    rounds = 4
    bp = train_port(params, X, y, rounds)
    models = bp._booster.models
    assert len(models) == 4 * rounds
    assert [t.num_leaves for t in models[3::4]] == [1] * rounds
    assert models[3].leaf_value[0] == np.log(1e-15)
    assert all(t.leaf_value[0] == 0.0 for t in models[7::4])
    assert all(t.num_leaves > 1 for i, t in enumerate(models) if i % 4 < 3)
    bj = train_jax(params, X, y, rounds)
    jm = bj._booster._used_models()
    assert len(jm) == len(models)
    assert [t.num_leaves for t in jm[3::4]] == [1] * rounds
    assert [t.leaf_value[0] for t in jm[3::4]] == \
        [t.leaf_value[0] for t in models[3::4]]
    score = bp._booster.train_score.score.numpy()
    np.testing.assert_allclose(score[3], bj._booster.train_score._score[3],
                               rtol=1e-6)
    np.testing.assert_allclose(score[3], 2 * np.log(1e-15), rtol=1e-6)
    if route == "persist":
        ref = train_port(dict(params, tpu_persist_scan="off"), X, y, rounds)
        assert_same_models(ref, bp, X, params["learning_rate"], 4)
        gr = bp._booster.tree_learner._persist_gr
        assert len(gr.grow_stats) == 3 * rounds


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_cuda_multiclass_training_matches_cpu(objective):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    X, y = class_data(n=20_000, seed=8)
    text = {}
    for dev in ("cuda", "cpu"):
        p = dict(BASE, objective=objective, num_class=3, num_leaves=63,
                 tpu_persist_scan="force", device_type=dev)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 4)
        text[dev] = bst.model_to_string().split("parameters:")[0]
    assert text["cuda"] == text["cpu"]
