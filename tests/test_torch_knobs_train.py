"""Training with the split scan's numerical knobs, against the JAX package.

``lambda_l1``, ``max_delta_step``, ``monotone_constraints``,
``extra_trees`` and ``feature_fraction_bynode``, alone and all together,
train on the port's v1 grower (the knob form of scan_pair, the leaf
outputs with L1, the clamp and the monotone bounds, the per-node draws
from the port's threefry) and must grow the JAX package's trees: equal
structure (split features, thresholds, children, counts) and raw scores
within 1e-4, as tests/test_torch_train.py holds the fast path (the JAX
package trains in f64 on the CPU, the port in f32). ``min_gain_to_split``
is 1e-3 (ROADMAP.md C5: zero-gain splits flip between the packages).

Equal gains (ROADMAP.md C5) are common under max_delta_step: a child whose
output is clamped has the gain 2 * mds * |G| - mds^2 * (H + l2), linear in
its sums, and in the first tree every row has one of two gradients, so two
splits on different features that cut the same numbers of positive and
negative rows have exactly equal gains; f64 and f32 rounding then pick
different ones (seen with max_delta_step on HIGGS rows with missing
values: 28 of 154 and 13 of 24 rows positive, both 3.8800435138000013 in
f64). Where two trees differ, the first split where they differ must be
such a tie: its gain equal in both packages within 8 f32 epsilons of the
tree's total gain (tests/test_torch_zero_gain.py's bound); the trees after
it grow from other scores and are not compared.

Also: every max_delta_step-clamped leaf sits at +-max_delta_step x the
learning rate and none goes past it; with monotone constraints the raw
score moves only in each constraint's direction when a constrained feature
sweeps its thresholds; ``auto`` routes the knobs to v1 even where the
persistent grower would run, ``tpu_persist_scan=force`` refuses them, and
the knobs this slice leaves out stay refused with their ROADMAP items.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_expo_like, make_higgs_like
from lightgbm_torch.treelearner import serial
from lightgbm_torch.utils.log import LightGBMError

MONO = [1, -1, 0, 1, 0, -1] + [0] * 22
KNOBS = {
    "l1": {"lambda_l1": 2.0},
    "mds": {"max_delta_step": 0.05},
    "mono": {"monotone_constraints": MONO},
    "extra": {"extra_trees": True},
    "bynode": {"feature_fraction_bynode": 0.6},
    "all": {"lambda_l1": 1.0, "max_delta_step": 0.08,
            "monotone_constraints": MONO, "extra_trees": True,
            "feature_fraction_bynode": 0.7},
}
BASE = {"objective": "binary", "num_leaves": 15, "max_bin": 63,
        "verbosity": -1, "min_gain_to_split": 1e-3}


def _data(n, seed, missing=False):
    X, y = make_higgs_like(n, seed=seed)
    if missing:
        rng = np.random.default_rng(seed)
        X[rng.random(X.shape) < 0.05] = np.nan
    return X, y


EPS32 = 1.1920929e-07
FIELDS = ("split_feature", "threshold", "left_child", "right_child",
          "internal_count")


def _same_or_tied(bj, bp):
    """True when both packages grew the same trees; else the first split
    where they differ must be a tie (see the module docstring), and False
    is returned."""
    tj, tp = bj._booster._used_models(), bp._booster.models
    assert len(tj) == len(tp) == 5
    for a, b in zip(tj, tp):
        k = min(a.num_leaves, b.num_leaves) - 1
        differ = [n for n in range(k)
                  if any(getattr(a, f)[n] != getattr(b, f)[n]
                         for f in FIELDS)]
        if not differ and a.num_leaves == b.num_leaves:
            np.testing.assert_array_equal(a.leaf_count[:k + 1],
                                          b.leaf_count[:k + 1])
            continue
        n = differ[0] if differ else k
        total = max(np.abs(a.split_gain[:a.num_leaves - 1]).sum(),
                    np.abs(b.split_gain[:b.num_leaves - 1]).sum())
        gj = a.split_gain[n] if n < a.num_leaves - 1 else 0.0
        gp = b.split_gain[n] if n < b.num_leaves - 1 else 0.0
        assert abs(gj - gp) <= 8 * EPS32 * total, (n, gj, gp, total)
        return False
    return True


def _train_port(params, X, y, rounds=5):
    p = dict(params, device_type="cpu")
    return lp.train(p, lp.Dataset(X, y, params=p), rounds)


@pytest.mark.parametrize("name,seed,missing,tie", [
    ("l1", 1, False, False), ("mds", 2, True, True), ("mds", 12, False, False),
    ("mono", 3, False, False), ("extra", 4, True, False),
    ("bynode", 5, False, False), ("all", 6, False, False)])
def test_knobs_train_like_jax(name, seed, missing, tie):
    """`tie`: the case whose first tree meets an exact tie (module
    docstring); every other case grows the same five trees."""
    X, y = _data(5000, seed, missing)
    params = dict(BASE, **KNOBS[name])
    bj = lt.train(dict(params), lt.Dataset(X, y), 5)
    bp = _train_port(params, X, y)
    assert not bp._booster.use_persist
    assert sum(t.num_leaves - 1 for t in bp._booster.models) >= 8
    same = _same_or_tied(bj, bp)
    assert same != tie
    if same:
        np.testing.assert_allclose(bp.predict(X, raw_score=True),
                                   bj.predict(X, raw_score=True), rtol=0,
                                   atol=1e-4)


def test_max_delta_step_bounds_every_leaf():
    X, y = _data(5000, 7)
    mds, lr = 0.05, 0.1
    bp = _train_port(dict(BASE, max_delta_step=mds, learning_rate=lr), X, y)
    bound = float(np.float32(mds)) * lr
    leaves = np.concatenate([t.leaf_value[:t.num_leaves]
                             for t in bp._booster.models[1:]])
    assert np.all(np.abs(leaves) <= bound)
    assert np.sum(np.abs(leaves) == bound) >= 5


def _sweep_is_monotone(bst, X, feature, sign):
    """Raw scores of the rows as `feature` sweeps every split threshold of
    the model (with values just past each): each step moves the score only
    in the direction `sign`. Returns (thresholds, largest move)."""
    thr = sorted({float(t.threshold[k]) for t in bst._booster.models
                  for k in range(t.num_leaves - 1)
                  if t.split_feature[k] == feature})
    if not thr:
        return 0, 0.0
    col = X[:, feature]
    grid = sorted({float(np.nanmin(col)) - 1.0, float(np.nanmax(col)) + 1.0}
                  | set(thr) | {np.nextafter(t, np.inf) for t in thr})
    raw = []
    for v in grid:
        Xs = X.copy()
        Xs[:, feature] = v
        raw.append(bst.predict(Xs, raw_score=True))
    step = np.diff(np.stack(raw), axis=0) * sign
    assert step.min() >= 0, (feature, float(step.min()))
    return len(thr), float(step.max())


def test_monotone_constraints_hold():
    X, y = _data(6000, 8)
    bp = _train_port(dict(BASE, monotone_constraints=MONO), X, y)
    swept = [_sweep_is_monotone(bp, X[:1000], f, s)
             for f, s in enumerate(MONO) if s != 0]
    # the constraints were exercised: several constrained features split
    # and moved the score
    assert sum(n > 0 and m > 0 for n, m in swept) >= 2


def test_auto_routes_knobs_to_v1(monkeypatch):
    """Where `auto` would take the persistent grower (on the card, from
    PARTITION_MIN_ROWS rows; lowered here to this data's size), any knob
    keeps the learner on v1 (the JAX package's resolve_scan_impl -> xla ->
    no persist)."""
    monkeypatch.setattr(serial, "PARTITION_MIN_ROWS", 4000)
    X, y = _data(4000, 9)
    p = dict(BASE, lambda_l1=0.5, device_type="cpu")
    bst = lp.Booster(params=p, train_set=lp.Dataset(X, y, params=p))
    learner, obj = bst._booster.tree_learner, bst._booster.objective
    assert learner.knobs == ["lambda_l1"]
    learner.device = torch.device("cuda")        # as if on the card
    assert not learner.can_persist_scan(obj)
    learner.knobs = []
    assert learner.can_persist_scan(obj)


@pytest.mark.parametrize("name", ["l1", "mono", "bynode"])
def test_force_refuses_knobs(name):
    X, y = _data(800, 10)
    p = dict(BASE, tpu_persist_scan="force", device_type="cpu",
             **KNOBS[name])
    knob = next(iter(KNOBS[name]))
    with pytest.raises(LightGBMError,
                       match="%s.*ROADMAP.md queue A, item 4, step 1c.*drop"
                       % knob):
        lp.train(p, lp.Dataset(X, y, params=p), 1)


@pytest.mark.parametrize("params,item", [
    ({"tpu_use_dp": True}, "item 4, step 1b"),
    ({"tpu_hist_dtype": "f64"}, "item 4, step 1b"),
    ({"tpu_scan_impl": "xla", "lambda_l1": 1.0}, "item 4, step 1b"),
    ({"cegb_penalty_split": 0.1, "extra_trees": True}, "item 4, step 3")])
def test_knobs_left_out_stay_refused(params, item):
    X, y = _data(800, 11)
    p = dict(BASE, device_type="cpu", **params)
    with pytest.raises(LightGBMError, match="ROADMAP.md queue A, %s" % item):
        lp.train(p, lp.Dataset(X, y, params=p), 1)


def test_bundled_data_with_a_knob_stays_refused():
    X, y = make_expo_like(3000, seed=0)
    p = dict(BASE, device_type="cpu", lambda_l1=1.0)
    with pytest.raises(LightGBMError, match="EFB bundles on the v1 grower"):
        lp.train(p, lp.Dataset(X, y, params=p), 1)
