"""The persistent grower's level phase and EFB-bundled training, end to end,
against the JAX package's.

The port trains with ``tpu_persist_scan=force`` on the CPU (the kernels'
plain versions) and ``tpu_level_grow=auto``: depth-bounded trees
(``max_depth=4``, ``num_leaves=16``) grow level by level. The JAX package
grows them with its level program on its persistent path, with its Pallas
kernels in interpret mode and in its widened XLA emulation, in fused
batches of 16 iterations, so every comparison trains 16 rounds and asserts
that the JAX carry is live.

Both packages number the nodes level by level, so tree structure, node
numbering and leaf counts must be equal; leaf values follow
tests/test_torch_persist.py's rules (rtol 2e-4, or 4 f32 ulps of sum|grad|
over the leaf's hessian near zero, plus, against the Pallas kernels, the
2 * 2^-17 * sum|grad| of their bf16 hi/lo histograms), and default_left is
compared where a training row takes the missing path (ROADMAP.md queue C,
item 2).

Within the port, ``tpu_level_grow=auto`` and ``off`` give bit-equal raw
predictions: each partition is stable and the slots' segments are
disjoint, so every leaf sees the per-split path's rows in the per-split
path's order (the JAX package pins the same of itself,
tests/test_level_grow.py).

The HIGGS-like data have no exact zeros, so the JAX package's groups stay
in feature order (its Pallas path needs that; ROADMAP.md, reference-side
caveats). The Expo-like data are EFB-bundled (8 dense columns and 640
one-hot columns) and scanned by ``scan_blocks`` in both packages.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
from lightgbm_tpu.treelearner.serial import SerialTreeLearner as JaxLearner
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_expo_like
from lightgbm_torch.ops import block_scan
from lightgbm_torch.utils.log import LightGBMError
from test_torch_persist import ROUNDS, _assert_same_trees, _data

LEVEL = {"objective": "binary", "num_leaves": 16, "max_depth": 4,
         "max_bin": 63, "min_data_in_leaf": 20, "learning_rate": 0.2,
         "verbosity": -1, "tpu_persist_scan": "force"}
EXPO = dict(LEVEL, max_bin=31, min_data_in_leaf=10)


def _jax(params, X, y, pallas, monkeypatch):
    if pallas:
        monkeypatch.setattr(JaxLearner, "_persist_kernel_mode",
                            staticmethod(lambda: ("pallas", True)))
    bj = lt.train(dict(params), lt.Dataset(X, y), ROUNDS)
    monkeypatch.undo()
    assert getattr(bj._booster.tree_learner, "_persist_carry", None) \
        is not None, "the JAX persistent path did not engage"
    return bj


def _port(params, X, y, rounds=ROUNDS):
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, params=p), rounds)
    assert bp._booster.use_persist
    return bp


def _stats(bp):
    """(level programs, per-split splits) summed over the trees."""
    s = np.array(bp._booster.tree_learner._persist_gr.grow_stats)
    return int(s[:, 0].sum()), int(s[:, 1].sum())


def _expo(n=2048):
    """Expo-like data without exact ties between one-hot features: in the
    first iteration the gradients take two values, so two categories with
    equal class counts in a leaf tie exactly, and the block scan breaks
    such a tie by lane position where the JAX per-feature scan of its
    widened XLA mode takes the smaller feature id (pallas_scan.py:321-327).
    Seed 0 has none at 2048 rows."""
    return make_expo_like(n, seed=0)


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "widened_xla"])
@pytest.mark.parametrize("f", [6, 24], ids=["inpass_hist", "level_seg_hist"])
def test_level_matches_jax_level(f, pallas, monkeypatch):
    """6 groups: level_pass brings the smaller children's histograms; 24
    groups (> SEG_HIST_MIN_GROUPS): level_seg_hist does."""
    X, y = _data(n=2048, f=f, seed=3, missing=0.05 if f == 6 else 0.0)
    ref = _jax(LEVEL, X, y, pallas, monkeypatch)._booster._used_models()
    bp = _port(LEVEL, X, y)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.use_level and gr.inpass_hist == (f == 6)
    levels, fallback = _stats(bp)
    assert levels >= ROUNDS and fallback == 0
    _assert_same_trees(ref, bp._booster.models, X, LEVEL["learning_rate"],
                       mxu=pallas)


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "widened_xla"])
def test_bundled_level_matches_jax(pallas, monkeypatch):
    """Expo-like bundled data: both packages form the same groups and
    FixHistogram layout, and grow the same trees through the block scan
    (JAX in interpret mode: its scan_blocks; widened XLA: its per-feature
    f64 scan with FixHistogram at store time)."""
    X, y = _expo()
    bj = _jax(EXPO, X, y, pallas, monkeypatch)
    bp = _port(EXPO, X, y)
    jd, pd = bj._booster.tree_learner.dataset, bp._booster.train_data
    assert pd.has_bundles and len(pd.groups) < pd.num_features
    assert [list(g) for g in jd.groups] == [list(g) for g in pd.groups]
    for name in ("bin_start", "bin_end", "needs_fix", "most_freq_bin"):
        np.testing.assert_array_equal(getattr(jd, name), getattr(pd, name),
                                      name)
    assert bp._booster.tree_learner._persist_gr.blocks is not None
    assert _stats(bp)[0] >= ROUNDS
    _assert_same_trees(bj._booster._used_models(), bp._booster.models, X,
                       EXPO["learning_rate"], mxu=pallas)


@pytest.mark.parametrize("shape", ["higgs", "expo"])
def test_level_equals_per_split_bit_for_bit(shape):
    X, y = _data(n=3000, f=6, seed=9) if shape == "higgs" else _expo(3000)
    params = LEVEL if shape == "higgs" else EXPO
    auto = _port(params, X, y, rounds=8)
    off = _port(dict(params, tpu_level_grow="off"), X, y, rounds=8)
    assert _stats(auto)[0] > 0 and _stats(off)[0] == 0
    assert [t.num_leaves for t in auto._booster.models] == \
        [t.num_leaves for t in off._booster.models]
    np.testing.assert_array_equal(auto.predict(X, raw_score=True),
                                  off.predict(X, raw_score=True))
    np.testing.assert_array_equal(auto._booster.train_score.score.numpy(),
                                  off._booster.train_score.score.numpy())


def test_level_counters_and_certificate():
    """On a 2^max_depth budget every tree is level programs only (at most
    max_depth of them); with num_leaves=12 and max_depth=4 the certificate
    fails at the root (11 leaves left < 2^4 - 1), so every tree is the
    per-split loop's, and its predictions are the off run's."""
    X, y = _data(n=3000, f=6, seed=4)
    bp = _port(LEVEL, X, y, rounds=6)
    for levels, fallback in bp._booster.tree_learner._persist_gr.grow_stats:
        assert 0 < levels <= 4 and fallback == 0
    p12 = dict(LEVEL, num_leaves=12)
    cut = _port(p12, X, y, rounds=6)
    levels, fallback = _stats(cut)
    assert levels == 0 and fallback == sum(t.num_leaves - 1 for t in
                                           cut._booster.models)
    off = _port(dict(p12, tpu_level_grow="off"), X, y, rounds=6)
    np.testing.assert_array_equal(cut.predict(X, raw_score=True),
                                  off.predict(X, raw_score=True))


def test_bundled_routing():
    """Bundled data train on the persistent grower (force); the v1 grower
    (false) refuses them, naming the ROADMAP item; tpu_level_grow=off/0
    keeps the level phase off."""
    X, y = _expo()
    p = dict(EXPO, device_type="cpu", tpu_level_grow="0")
    bst = lp.train(p, lp.Dataset(X, y, params=p), 2)
    gr = bst._booster.tree_learner._persist_gr
    assert bst._booster.use_persist and not gr.use_level
    assert gr.blocks is not None and gr.blocks.do_fix
    p = dict(EXPO, device_type="cpu", tpu_persist_scan="false")
    with pytest.raises(LightGBMError, match="queue A, item 2"):
        lp.Booster(p, lp.Dataset(X, y, params=p))


def test_block_scan_runs_on_bundled_data(monkeypatch):
    """Every scan of a bundled tree is one scan_blocks call: 1 for the root
    and 1 per level program, and 1 per split of the device loop after it
    (whose steps after the tree stops growing are no-ops, with the done
    flag set, and not counted)."""
    X, y = _expo()
    calls = []

    def spy(scal, *args, **kw):
        done = kw.get("done")
        if done is None or int(done[0]) == 0:
            calls.append(scal.shape[0])
        return block_scan.scan_blocks(scal, *args, **kw)
    from lightgbm_torch.ops import grow_persist
    monkeypatch.setattr(grow_persist, "scan_blocks", spy)
    bp = _port(EXPO, X, y, rounds=3)
    levels, fallback = _stats(bp)
    assert len(calls) == 3 + levels + fallback
    assert max(calls) > 2                   # a whole level in one batch


@pytest.mark.cuda
def test_cuda_level_training_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    for X, y, params in ((*_data(n=20_000, seed=8), LEVEL),
                         (*_expo(20_000), EXPO)):
        text = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, num_leaves=64, max_depth=6, device_type=dev)
            bst = lp.train(p, lp.Dataset(X, y, params=p), 5)
            assert bst._booster.use_persist
            text[dev] = bst.model_to_string().split("parameters:")[0]
        assert text["cuda"] == text["cpu"]
