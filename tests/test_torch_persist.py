"""The port's persistent-payload grower, end to end, against the JAX
package's.

The port trains with ``tpu_persist_scan=force`` on the CPU (the kernels'
plain versions). The JAX package trains its persistent path two ways on
the CPU: with its Pallas kernels in interpret mode (``SerialTreeLearner.
_persist_kernel_mode`` patched, as tests/test_persist_sharded.py does) and
in its widened XLA emulation (the default off the TPU, f64 histograms and
scores). The JAX persistent path engages only in fused batches of 16
iterations (boosting/gbdt.py:340-400), so every comparison trains 16 rounds
and asserts that the JAX carry is live.

Tree structure (split features, thresholds, children) and leaf counts must
be equal. Leaf values follow tests/test_torch_grow.py's rules: rtol 2e-4,
or, for a value near zero, 4 f32 ulps of sum|grad| over the leaf's hessian
(times the learning rate), with sum|grad| <= n for the binary objective.
default_left is compared on the nodes where a training row takes the
missing-value path (ROADMAP.md queue C, item 2).

The data have no exact zeros, so the JAX package's EFB pass keeps every
feature in its own group in feature order: its Pallas persistent path
scans the group planes as if they were in feature order
(grow_persist.py:1188), which holds only then (ROADMAP.md, reference-side
caveats).
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
from lightgbm_tpu.treelearner.serial import SerialTreeLearner as JaxLearner
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.ops import grow_persist
from lightgbm_torch.ops import payload_kernels as pk
from lightgbm_torch.ops.histogram import hist_window
from lightgbm_torch.utils.log import LightGBMError

ROUNDS = 16
EPS32 = float(np.finfo(np.float32).eps)
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "min_data_in_leaf": 20, "learning_rate": 0.2, "verbosity": -1,
        "tpu_persist_scan": "force"}


def _data(n=4096, f=6, seed=3, missing=0.05):
    X, y = make_higgs_like(n, seed=seed)
    X = X[:, :f].copy()
    if missing:
        X[np.random.default_rng(seed).random(X.shape) < missing] = np.nan
    return X, y


def _jax(params, X, y, pallas, monkeypatch):
    if pallas:
        monkeypatch.setattr(JaxLearner, "_persist_kernel_mode",
                            staticmethod(lambda: ("pallas", True)))
    bj = lt.train(dict(params), lt.Dataset(X, y), ROUNDS)
    monkeypatch.undo()
    assert getattr(bj._booster.tree_learner, "_persist_carry", None) \
        is not None, "the JAX persistent path did not engage"
    return bj._booster._used_models()


def _port(params, X, y):
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, params=p), ROUNDS)
    assert bp._booster.use_persist == (
        str(p["tpu_persist_scan"]) == "force")
    return bp


def _defaults_taken(tree, X):
    """Per internal node: does a training row reaching it take the missing
    value's default path?"""
    out = np.zeros(tree.num_leaves - 1, bool)
    node = np.zeros(X.shape[0], np.int64)
    active = np.arange(X.shape[0])
    while len(active):
        nd = node[active]
        fv = X[active, tree.split_feature[nd]]
        mt = (tree.decision_type[nd] >> 2) & 3
        miss = ((mt == 2) & np.isnan(fv)) | (
            (mt == 1) & (np.abs(np.nan_to_num(fv)) <= 1e-35))
        np.logical_or.at(out, nd, miss)
        nxt = np.where(tree._decision(fv, nd), tree.left_child[nd],
                       tree.right_child[nd])
        node[active] = nxt
        active = active[nxt >= 0]
    return out


def _assert_same_trees(ref, mine, X, lr, min_leaves=3, mxu=False):
    """`mxu`: the reference ran the Pallas kernels, whose histograms keep
    each value to 2^-17 of its size (the MXU's bf16 hi/lo split); a leaf's
    sums then carry that error of its ancestors' histograms, at most
    2 * 2^-17 * sum|grad| (the root's and the subtracted siblings', which
    are disjoint), with sum|grad| <= n."""
    assert len(ref) == len(mine) == ROUNDS
    n = X.shape[0]
    for a, b in zip(ref, mine):
        assert a.num_leaves == b.num_leaves >= min_leaves
        k = a.num_leaves - 1
        for f in ("split_feature", "threshold_in_bin", "left_child",
                  "right_child", "internal_count"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k], f)
        np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                      b.leaf_count[:k + 1])
        taken = _defaults_taken(a, X)
        np.testing.assert_array_equal(a.decision_type[:k][taken],
                                      b.decision_type[:k][taken])
        ref_v = a.leaf_value[:k + 1]
        cancel = (4 * EPS32 + (2 * 2.0 ** -17 if mxu else 0.0)) * n \
            / a.leaf_weight[:k + 1] * lr
        assert np.all(np.abs(b.leaf_value[:k + 1] - ref_v)
                      <= np.maximum(2e-4 * np.abs(ref_v) + 1e-7, cancel))


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "widened_xla"])
def test_persist_matches_jax_persist(pallas, monkeypatch):
    X, y = _data()
    ref = _jax(BASE, X, y, pallas, monkeypatch)
    bp = _port(BASE, X, y)
    _assert_same_trees(ref, bp._booster.models, X, BASE["learning_rate"])
    # the scores synced from the payload are the numpy walk's, to f32
    walk = bp.predict(X, raw_score=True)
    dev = bp._booster.train_score.score.numpy()
    assert np.max(np.abs(dev - walk)) <= 2 * (ROUNDS + 1) * EPS32 * max(
        1.0, np.abs(walk).max())


def test_persist_weighted_matches_jax_persist(monkeypatch):
    """Sample weights ride the payload as one more row and multiply the
    objective's gradients, in both packages."""
    X, y = _data(seed=9)
    w = np.random.default_rng(9).uniform(0.5, 2.0, len(y))
    bj = lt.train(dict(BASE), lt.Dataset(X, y, weight=w), ROUNDS)
    assert bj._booster.tree_learner._persist_carry is not None
    p = dict(BASE, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, weight=w, params=p), ROUNDS)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.weight_row == gr.nbw + 5 and gr.wp_live == gr.nbw + 6
    _assert_same_trees(bj._booster._used_models(), bp._booster.models, X,
                       BASE["learning_rate"] * 2.0)


def test_persist_max_depth_matches_jax_per_split(monkeypatch):
    """max_depth > 0, each mode against its like: with tpu_level_grow=off
    both packages grow split by split (JAX in Pallas interpret mode), with
    auto both run their level phase (JAX in its widened XLA mode), which
    numbers the nodes level by level."""
    X, y = _data(seed=5)
    for mode, pallas in (("off", True), ("auto", False)):
        params = dict(BASE, max_depth=3, tpu_level_grow=mode)
        ref = _jax(params, X, y, pallas, monkeypatch)
        bp = _port(params, X, y)
        levels = sum(s[0] for s in
                     bp._booster.tree_learner._persist_gr.grow_stats)
        assert (levels > 0) == (mode == "auto"), mode
        leaves = [t.num_leaves for t in bp._booster.models]
        assert max(leaves) == 8 and min(leaves) > 2
        _assert_same_trees(ref, bp._booster.models, X,
                           BASE["learning_rate"])


def test_persist_seg_hist_branch_matches_jax(monkeypatch):
    """24 groups > SEG_HIST_MIN_GROUPS: the smaller child's histogram comes
    from seg_hist after split_pass, in both packages (in the port, its
    device form over the segment split_pass wrote; a call with the done
    flag set is a no-op step and not counted)."""
    X, y = _data(n=3000, f=24, seed=7, missing=0.0)
    params = dict(BASE, num_leaves=7)
    ref = _jax(params, X, y, True, monkeypatch)
    calls = []

    def spy(*args, **kw):
        if int(kw["done"][0]) == 0:
            calls.append(args[3].tolist())
        return pk.seg_hist_device(*args, **kw)
    monkeypatch.setattr(grow_persist, "seg_hist_device", spy)
    bp = _port(params, X, y)
    assert bp._booster.tree_learner._persist_gr.inpass_hist is False
    assert len(calls) == sum(t.num_leaves - 1 for t in bp._booster.models)
    _assert_same_trees(ref, bp._booster.models, X, BASE["learning_rate"])


def test_persist_matches_v1_grower():
    """The port's two growers grow the same trees on data without near-tied
    gains (tests/test_persist_sharded.py:91-107 pins the JAX pair on such
    data). The gradients come from different scores (the payload's f32
    scores against v1's f64 ones), so leaf values agree to rtol 1e-3."""
    rng = np.random.default_rng(23)
    X = rng.normal(size=(6144, 6))
    y = (X[:, 0] - 0.7 * X[:, 2] + 0.4 * X[:, 4]
         + rng.normal(size=6144) * 0.25 > 0).astype(float)
    params = dict(BASE, min_data_in_leaf=10)
    a = _port(params, X, y)._booster.models
    b = _port(dict(params, tpu_persist_scan="false"), X, y)._booster.models
    for ta, tb in zip(a, b):
        k = ta.num_leaves - 1
        assert ta.num_leaves == tb.num_leaves
        for f in ("split_feature", "threshold_in_bin", "left_child",
                  "right_child", "decision_type"):
            np.testing.assert_array_equal(getattr(ta, f)[:k],
                                          getattr(tb, f)[:k], f)
        np.testing.assert_array_equal(ta.leaf_count[:k + 1],
                                      tb.leaf_count[:k + 1])
        np.testing.assert_allclose(ta.leaf_value[:k + 1],
                                   tb.leaf_value[:k + 1], rtol=1e-3,
                                   atol=1e-5)


def test_routing(monkeypatch):
    """auto keeps the v1 grower on the CPU, force takes the persistent one,
    false/off/0 never do; force with an objective that has no device
    gradient (neither a payload nor a row mode) raises; with max_depth the
    level phase runs (auto), and tpu_level_grow=off keeps it off."""
    X, y = _data(n=2000)
    for opt, want in (("auto", False), ("force", True), ("false", False),
                      ("off", False), ("0", False)):
        p = dict(BASE, tpu_persist_scan=opt, device_type="cpu")
        bst = lp.Booster(p, lp.Dataset(X, y, params=p))
        assert bst._booster.use_persist is want, opt
    p = dict(BASE, device_type="cpu")
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    learner = bst._booster.tree_learner
    monkeypatch.setattr(type(bst._booster.objective), "device_gradients",
                        lambda self: None)
    with pytest.raises(LightGBMError, match="device gradient"):
        learner.can_persist_scan(bst._booster.objective)
    monkeypatch.undo()
    for level, runs in (("auto", True), ("off", False)):
        p = dict(BASE, device_type="cpu", max_depth=2, tpu_level_grow=level)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 2)
        gr = bst._booster.tree_learner._persist_gr
        assert gr.use_level is runs, level
        assert all((levels > 0) == runs for levels, _ in gr.grow_stats)


def test_persist_histograms_equal_v1_histograms():
    """On the CPU a payload histogram is the v1 kernel's histogram of the
    same rows, bit for bit: the root of a persistent tree against
    hist_window over the dataset's bins."""
    X, y = _data(n=5000)
    p = dict(BASE, device_type="cpu")
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    learner = bst._booster.tree_learner
    gr = learner._persist_grower()
    pay = gr.init_carry(torch.zeros(5000, dtype=torch.float64))
    gr.fill_grad(pay, bst._booster.objective.payload_grad_fn())
    gh, hh, _ = pk.root_hist(pay, gr.plan, gr.nbw, gr.n)
    grad = pay[gr.nbw + 2, :5000].view(torch.float32).contiguous()
    hess = pay[gr.nbw + 3, :5000].view(torch.float32).contiguous()
    ref = hist_window(learner.data.bins, grad, hess, 0, 5000, 256)
    assert torch.equal(gh, ref[:, :, 0].reshape(-1))
    assert torch.equal(hh, ref[:, :, 1].reshape(-1))


@pytest.mark.cuda
def test_cuda_persist_training_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    X, y = _data(n=20_000, seed=8)
    text = {}
    for dev in ("cuda", "cpu"):
        p = dict(BASE, num_leaves=63, device_type=dev)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 5)
        assert bst._booster.use_persist
        text[dev] = bst.model_to_string().split("parameters:")[0]
    assert text["cuda"] == text["cpu"]
