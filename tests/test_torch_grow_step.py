"""The persistent grower's device loop, end to end on the CPU, against the
JAX package's persistent path and against the port's own level phase.

The port's per-split loop now runs from a device-resident leaf table
(ops/grow_step.py) for a fixed trip count of L - 1 steps, each a no-op
once no leaf has a positive gain, as the JAX grower's while_loop does; on
the CPU the same loop runs eagerly with the kernels' plain versions. The
JAX persistent path engages only in fused batches of 16 iterations, so
every comparison trains 16 rounds and asserts that the JAX carry is live;
tree structure and leaf counts must be equal and leaf values agree to
tests/test_torch_persist.py's tolerance (its ``_assert_same_trees``).
The device counters (ops/counters.py), kept by the plain versions on the
CPU, must count one pick, commit, planes, split_pass and scan per split
grown and nothing for a no-op step.
"""
import numpy as np
import pytest

import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_expo_like
from lightgbm_torch.ops import counters
from test_torch_persist import BASE, ROUNDS, _assert_same_trees, _data, _jax


def _train(params, X, y, rounds=ROUNDS):
    p = dict(params, device_type="cpu")
    counters.reset("cpu")
    bp = lp.train(p, lp.Dataset(X, y, params=p), rounds)
    assert bp._booster.use_persist
    return bp


def _check_counts(bp, seg_hist):
    """The CPU's device counters of the run against its trees."""
    trees = bp._booster.models
    gr = bp._booster.tree_learner._persist_gr
    splits = sum(t.num_leaves - 1 for t in trees)
    got = counters.read("cpu")
    assert gr.device_counts == got           # read back with the tree
    per_split = sum(b for _, b in gr.grow_stats)
    assert per_split == splits and not gr.use_level
    for k in ("grow_pick", "grow_commit", "grow_planes", "split_pass"):
        assert got[k] == splits, k
    assert got["seg_hist"] == (splits if seg_hist else 0)
    assert got["scan_pair"] == got["grow_assemble"] == splits + len(trees)
    assert got["grow_root"] == got["root_hist"] == len(trees)
    assert got["apply_scores"] == sum(t.num_leaves > 1 for t in trees)


@pytest.mark.parametrize("pallas", [True, False],
                         ids=["pallas_interpret", "widened_xla"])
def test_device_loop_matches_jax_persist(pallas, monkeypatch):
    X, y = _data(seed=4)
    ref = _jax(BASE, X, y, pallas, monkeypatch)
    bp = _train(BASE, X, y)
    _assert_same_trees(ref, bp._booster.models, X, BASE["learning_rate"])
    _check_counts(bp, seg_hist=False)


def test_device_loop_seg_hist_matches_jax_persist(monkeypatch):
    """24 groups > 20: the steps run seg_hist's device form."""
    X, y = _data(n=3000, f=24, seed=12, missing=0.02)
    params = dict(BASE, num_leaves=11)
    ref = _jax(params, X, y, True, monkeypatch)
    bp = _train(params, X, y)
    _assert_same_trees(ref, bp._booster.models, X, BASE["learning_rate"])
    _check_counts(bp, seg_hist=True)


def test_early_stop_runs_no_op_steps(monkeypatch):
    """A large min_data_in_leaf stops every tree before num_leaves: the
    steps after the stop are no-ops (nothing counted, the tree unchanged),
    and the trees are the JAX package's."""
    X, y = _data(n=4096, seed=6)
    params = dict(BASE, num_leaves=31, min_data_in_leaf=300)
    ref = _jax(params, X, y, False, monkeypatch)
    bp = _train(params, X, y)
    leaves = [t.num_leaves for t in bp._booster.models]
    assert max(leaves) < 31 and min(leaves) > 2
    _assert_same_trees(ref, bp._booster.models, X, BASE["learning_rate"])
    _check_counts(bp, seg_hist=False)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.state.L == 31 and int(gr.state.st[1]) == 1     # done


def test_bundled_per_split_equals_level_phase():
    """The bundled data's per-split device loop (tpu_level_grow=off: the
    block scan's assembly, split_pass's in-pass histograms) grows trees
    whose raw predictions equal the level phase's, bit for bit."""
    X, y = make_expo_like(2048, seed=0)
    params = {"objective": "binary", "num_leaves": 16, "max_depth": 4,
              "max_bin": 63, "min_data_in_leaf": 20, "learning_rate": 0.2,
              "verbosity": -1, "tpu_persist_scan": "force"}
    level = _train(params, X, y, rounds=4)
    off = _train(dict(params, tpu_level_grow="off"), X, y, rounds=4)
    gl = level._booster.tree_learner._persist_gr
    go = off._booster.tree_learner._persist_gr
    assert gl.use_level and not go.use_level and go.blocks is not None
    assert sum(a for a, _ in gl.grow_stats) > 0
    assert sum(b for _, b in go.grow_stats) == sum(
        t.num_leaves - 1 for t in off._booster.models)
    assert np.array_equal(level.predict(X, raw_score=True),
                          off.predict(X, raw_score=True))
    assert np.array_equal(level._booster.train_score.score.numpy(),
                          off._booster.train_score.score.numpy())
