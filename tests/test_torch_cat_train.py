"""Categorical training, model text, prediction and the binned walk: the
port against the JAX package on the CPU.

- ``train`` on airline-shaped rows (lightgbm_torch/data/synth.py:
  make_airline_like: six categorical columns up to 300 categories, two
  numerical) against ``lightgbm_tpu.train``, on both routes of the
  categorical scan (the sorted many-vs-many scan; one-hot with
  ``max_cat_to_onehot=32``) and under min_data_per_group, cat_smooth,
  cat_l2, max_cat_threshold, NaN and negative codes, and the numerical
  knobs (lambda_l1, max_delta_step, a monotone numerical feature: the knob
  form). Trees are compared node by node, each node matched by the
  training rows that reach it: the same split feature, the same
  categories to the left (``cat_threshold``) or the same threshold, and
  raw scores within TOL = 1e-4 (JAX runs f64 on the CPU, the port f32;
  tests/test_torch_train.py:1-16). One difference is allowed and counted:
  a mirror tie (ROADMAP.md section C8), where the sorted scan's forward and
  reverse walks cut the node's rows into the same two sets with the sides
  swapped; their gains are equal in exact arithmetic, and the packages'
  rounding picks different sides. C8's other difference, categories with
  equal statistics at a node, is shown by
  :func:`test_equal_statistics_categories_are_a_known_difference`.
- Model text both ways (``num_cat``, ``cat_boundaries``, ``cat_threshold``
  and the category lists in ``feature_infos``), with equal predictions on
  rows with unseen categories, NaN, negative and fractional codes.
- A validation set's score through the binned walk equals ``predict`` on
  the same rows; a model read from text and bound to a Dataset
  (``Tree.bind_to_dataset``) walks the bins as the trained one does.
- Routing: ``tpu_persist_scan=force`` trains a categorical Dataset on the
  v1 grower (and says so at info level); a categorical feature that EFB
  bundles is refused with the A2 message.
"""
import re

import numpy as np
import pytest

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.data.synth import AIRLINE_CATEGORICAL, make_airline_like
from lightgbm_torch.models.tree import kCategoricalMask, kDefaultLeftMask
from lightgbm_torch.utils.log import LightGBMError

TOL = 1e-4
BASE = dict(objective="binary", num_leaves=15, min_data_in_leaf=20,
            verbose=-1, learning_rate=0.2)
CAT = list(AIRLINE_CATEGORICAL)


def airline(n=4000, seed=0, nan=0.0, neg=0.0):
    X, y = make_airline_like(n, seed)
    rng = np.random.default_rng(seed + 50)
    if nan:
        X[rng.random((n, 8)) < nan] = np.nan
    if neg:
        X[:, :6][rng.random((n, 6)) < neg] = -1.0
    return X, y


def train_both(X, y, params, rounds=3, cat=CAT):
    pj = dict(params)
    pp = dict(params, device_type="cpu")
    bj = lt.train(pj, lt.Dataset(X, y, categorical_feature=cat,
                                 params=dict(pj)), rounds)
    bp = lp.train(pp, lp.Dataset(X, y, categorical_feature=cat,
                                 params=dict(pp)), rounds)
    return bj, bp


def node_rows(tree, X):
    """[num_leaves - 1, n] bool: the rows of X that reach each internal
    node, and [num_leaves - 1, n] bool: those that go left there."""
    ni = tree.num_leaves - 1
    n = len(X)
    reach = np.zeros((ni, n), bool)
    left = np.zeros((ni, n), bool)
    node = np.zeros(n, np.int64)
    active = np.arange(n)
    while len(active):
        nd = node[active]
        go = tree._decision(X[active, tree.split_feature[nd]], nd)
        reach[nd, active] = True
        left[nd, active] = go
        nxt = np.where(go, tree.left_child[nd], tree.right_child[nd])
        node[active] = nxt
        active = active[nxt >= 0]
    return reach, left


def cat_set(tree, k):
    """The categories a categorical node sends left."""
    ci = int(tree.threshold[k])
    words = np.asarray(tree.cat_threshold[tree.cat_boundaries[ci]:
                                          tree.cat_boundaries[ci + 1]],
                       np.uint32)
    return [v for v in range(32 * len(words)) if words[v // 32] >> (v % 32)
            & 1]


def compare_trees(tj, tp, X):
    """Node-by-node comparison of a JAX and a port tree over the training
    rows X. Returns (categorical nodes, mirror ties)."""
    assert tj.num_leaves == tp.num_leaves
    rj, lj = node_rows(tj, X)
    rp, lp_ = node_rows(tp, X)
    key_p = {rp[k].tobytes(): k for k in range(tp.num_leaves - 1)}
    n_cat = mirrors = 0
    for k in range(tj.num_leaves - 1):
        kp = key_p.get(rj[k].tobytes())
        assert kp is not None, "no port node holds JAX node %d's rows" % k
        assert tj.split_feature[k] == tp.split_feature[kp]
        cj = bool(tj.decision_type[k] & kCategoricalMask)
        assert cj == bool(tp.decision_type[kp] & kCategoricalMask)
        dj, dp = int(tj.decision_type[k]), int(tp.decision_type[kp])
        assert dj & ~kDefaultLeftMask == dp & ~kDefaultLeftMask
        f = tj.split_feature[k]
        mt = (dj >> 2) & 3
        col = X[rj[k], f]
        if (mt == 2 and np.isnan(col).any()) or \
                (mt == 1 and (np.abs(np.nan_to_num(col)) <= 1e-35).any()):
            assert dj == dp     # C2: default_left only where a row takes it
        if not cj:
            # C5: equal thresholds, or the same rows to the left
            assert (tj.threshold[k] == tp.threshold[kp]
                    or np.array_equal(lj[k], lp_[kp]))
            continue
        n_cat += 1
        if cat_set(tj, k) == cat_set(tp, kp):
            continue
        # C8: the mirror tie; the rows split the same way, sides swapped
        at = rj[k]
        assert np.array_equal(lj[k][at], ~lp_[kp][at]), \
            "node %d: other categories to the left, not a mirror" % k
        # equal in exact arithmetic; the port's f32 gain, a difference of
        # leaf gains less the parent's, carries their rounding (3e-5 seen)
        np.testing.assert_allclose(tp.split_gain[kp], tj.split_gain[k],
                                   rtol=1e-4)
        mirrors += 1
    return n_cat, mirrors


def assert_same_models(bj, bp, X):
    """Every tree node by node (:func:`compare_trees`), mirror ties no
    more than a quarter of the categorical nodes, raw scores within TOL."""
    tjs = bj._booster._used_models()
    tps = bp._booster.models
    assert len(tjs) == len(tps)
    n_cat = mirrors = 0
    for tj, tp in zip(tjs, tps):
        c, m = compare_trees(tj, tp, X)
        n_cat += c
        mirrors += m
    assert n_cat > 0, "no categorical split: the comparison is vacuous"
    assert 4 * mirrors <= n_cat
    d = np.abs(bj.predict(X, raw_score=True) - bp.predict(X, raw_score=True))
    assert d.max() <= TOL
    return n_cat, mirrors


CASES = {
    "sorted": {},
    "onehot": {"max_cat_to_onehot": 32},
    "groups": {"min_data_per_group": 10, "cat_l2": 1.0},
    "max_cat": {"max_cat_threshold": 4, "min_data_per_group": 30},
    "smooth": {"cat_smooth": 40.0, "num_leaves": 7},
    "knobs": {"lambda_l1": 0.5, "max_delta_step": 0.8,
              "monotone_constraints": [0, 0, 0, 0, 0, 0, 1, 0],
              "min_data_per_group": 30},
    "max_bin": {"max_bin": 63, "max_cat_to_onehot": 8},
}
# small categories take part: equal-statistics twins (section C8)
CASES_TWINS = {"min_data_per_group": 10, "cat_smooth": 2.0, "cat_l2": 1.0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_matches_jax(case):
    X, y = airline(4000, seed=1)
    assert_same_models(*train_both(X, y, dict(BASE, **CASES[case])), X)


def test_train_with_nan_and_negative_codes():
    X, y = airline(4000, seed=2, nan=0.05, neg=0.02)
    params = dict(BASE, min_data_per_group=30)
    bj, bp = train_both(X, y, params)
    assert_same_models(bj, bp, X)
    inner = bp.train_set._inner
    for f in CAT:
        m = inner.bin_mappers[f]
        assert m.is_categorical and m.missing_type == 2     # NaN seen


def test_equal_statistics_categories_are_a_known_difference():
    """ROADMAP.md section C8. With cat_smooth=2 and min_data_per_group=10
    small categories take part, and in the first tree (one hessian for
    every row) two categories with the same rows and positives at a node
    have ratios equal in exact arithmetic. Their order, and through the
    group counter the prefix the sorted walk admits, is decided by the f32
    rounding of their histogram sums, which the packages sum in different
    orders. The test pins that the first node where the two packages'
    categories differ swaps only such statistical twins."""
    X, y = airline(4000, seed=1)
    bj, bp = train_both(X, y, dict(BASE, **CASES_TWINS), rounds=1)
    tj, tp = bj._booster._used_models()[0], bp._booster.models[0]
    rj, lj = node_rows(tj, X)
    rp, _ = node_rows(tp, X)
    key_p = {rp[k].tobytes(): k for k in range(tp.num_leaves - 1)}
    for k in range(tj.num_leaves - 1):
        kp = key_p[rj[k].tobytes()]
        if not tj.decision_type[k] & kCategoricalMask or \
                cat_set(tj, k) == cat_set(tp, kp):
            continue
        f = tj.split_feature[k]
        at = rj[k]
        only_j = sorted(set(cat_set(tj, k)) - set(cat_set(tp, kp)))
        only_p = sorted(set(cat_set(tp, kp)) - set(cat_set(tj, k)))

        def stats(cats):
            return sorted((int((at & (X[:, f] == c)).sum()),
                           float(y[at & (X[:, f] == c)].sum())) for c in cats)
        assert only_j and stats(only_j) == stats(only_p), (only_j, only_p)
        break
    else:
        pytest.fail("the packages agreed: the known difference did not show")


def test_model_text_both_ways():
    X, y = airline(3000, seed=4, nan=0.02, neg=0.01)
    bj, bp = train_both(X, y, dict(BASE, min_data_per_group=30))
    tp = bp.model_to_string()
    tj = bj.model_to_string()
    assert max(int(v) for v in re.findall(r"^num_cat=(\d+)$", tp, re.M)) > 0
    assert re.search(r"^cat_threshold=", tp, re.M)
    assert re.search(r"^cat_boundaries=", tp, re.M)
    # feature_infos lists each categorical column's categories
    infos_p = re.search(r"^feature_infos=(.*)$", tp, re.M).group(1).split()
    infos_j = re.search(r"^feature_infos=(.*)$", tj, re.M).group(1).split()
    assert infos_p == infos_j
    assert all(":" in infos_p[f] and "[" not in infos_p[f] for f in CAT)
    # rows with unseen categories, NaN, negatives and fractions
    Xt, _ = airline(2000, seed=44)
    rng = np.random.default_rng(5)
    Xt[:, :6][rng.random((2000, 6)) < 0.05] = 999.0
    Xt[:, :6][rng.random((2000, 6)) < 0.05] = np.nan
    Xt[:, :6][rng.random((2000, 6)) < 0.05] = -3.0
    Xt[:, :6][rng.random((2000, 6)) < 0.05] += 0.5
    p_port = bp.predict(Xt, raw_score=True)
    np.testing.assert_allclose(p_port, bj.predict(Xt, raw_score=True),
                               atol=TOL)
    # the port's text read by both packages
    np.testing.assert_array_equal(
        lp.Booster(model_str=tp, params={"device_type": "cpu"}).predict(
            Xt, raw_score=True), p_port)
    np.testing.assert_allclose(
        lt.Booster(model_str=tp).predict(Xt, raw_score=True), p_port,
        rtol=0, atol=1e-12)
    # the JAX package's text read by the port
    np.testing.assert_allclose(
        lp.Booster(model_str=tj, params={"device_type": "cpu"}).predict(
            Xt, raw_score=True),
        bj.predict(Xt, raw_score=True), rtol=0, atol=1e-12)
    assert lp.Booster(model_str=tp).model_to_string().split(
        "\nparameters:")[0] == tp.split("\nparameters:")[0]


def test_validation_walk_equals_predict():
    X, y = airline(4000, seed=6)
    Xv, yv = airline(1500, seed=7)
    params = dict(BASE, device_type="cpu", metric="binary_logloss",
                  min_data_per_group=30)
    dt = lp.Dataset(X, y, categorical_feature=CAT, params=dict(params))
    dv = lp.Dataset(Xv, yv, reference=dt, params=dict(params))
    rec = {}
    bst = lp.train(dict(params), dt, 4, valid_sets=[dv], evals_result=rec,
                   verbose_eval=False)
    assert sum(t.num_cat for t in bst._booster.models) > 0
    walked = bst._booster.valid_score[0].score.cpu().numpy()
    np.testing.assert_allclose(walked, bst.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-12)
    # a model read from text, bound to the validation bins, walks the same
    inner = dv._inner
    loaded = lp.Booster(model_str=bst.model_to_string(),
                        params={"device_type": "cpu"})
    for t_tr, t_ld in zip(bst._booster.models, loaded._booster.models):
        t_ld.bind_to_dataset(inner)
        np.testing.assert_array_equal(t_ld.predict_leaf_binned(inner),
                                      t_tr.predict_leaf_binned(inner))


def test_binned_walk_nan_is_a_known_difference():
    """ROADMAP.md section C8's second item: as the JAX package's
    from_grower, a categorical node's decision type carries no missing
    type, so predict() reads a NaN as category 0, while the binned walk
    sends the NaN bin right (used_bin leaves it out of every left set).
    Rows without a NaN in a categorical column agree, in both packages;
    some rows with one do not, in both packages."""
    X, y = airline(4000, seed=8, nan=0.05)
    params = dict(BASE, min_data_per_group=30)
    diff = {}
    for pkg, extra in ((lt, {}), (lp, {"device_type": "cpu"})):
        p = dict(params, **extra)
        ds = pkg.Dataset(X, y, categorical_feature=CAT, params=dict(p))
        bst = pkg.train(dict(p), ds, 3)
        models = (bst._booster._used_models() if pkg is lt
                  else bst._booster.models)
        binned = sum(t.predict_binned(ds._inner) for t in models)
        diff[pkg] = np.abs(binned - bst.predict(X, raw_score=True)) > 1e-9
    has_nan = np.isnan(X[:, :6]).any(axis=1)
    for pkg in (lp, lt):
        assert not diff[pkg][~has_nan].any(), (pkg.__name__, np.nonzero(
            diff[pkg] & ~has_nan)[0][:5])
        assert diff[pkg].any()


def test_force_trains_categoricals_on_v1():
    X, y = airline(3000, seed=9)
    p = dict(BASE, device_type="cpu", tpu_persist_scan="force")
    bst = lp.train(p, lp.Dataset(X, y, categorical_feature=CAT,
                                 params=dict(p)), 2)
    assert not bst._booster.use_persist
    q = dict(BASE, device_type="cpu", tpu_persist_scan="false")
    ref = lp.train(q, lp.Dataset(X, y, categorical_feature=CAT,
                                 params=dict(q)), 2)
    assert bst.model_to_string().split("\nparameters:")[0] == \
        ref.model_to_string().split("\nparameters:")[0]


def test_bundled_categorical_is_refused_on_v1():
    """A sparse categorical column that EFB bundles with sparse numerical
    ones (no row has two of them set): the v1 grower refuses bundles with
    the A2 message."""
    rng = np.random.default_rng(10)
    n = 3000
    X = np.zeros((n, 5))
    X[:, 0] = rng.normal(size=n)
    active = rng.integers(0, 8, n)        # at most one sparse column a row
    for j in (1, 2, 3):
        on = active == j
        X[on, j] = rng.normal(size=int(on.sum())) + 3
    on = active == 4
    X[on, 4] = rng.integers(1, 4, int(on.sum()))
    y = (X[:, 0] + (X[:, 4] == 2) > 0.3).astype(float)
    p = dict(BASE, device_type="cpu")
    ds = lp.Dataset(X, y, categorical_feature=[4], params=dict(p))
    ds.construct()
    inner = ds._inner
    assert inner.has_bundles
    assert inner.is_categorical[inner.inner_of[4]]
    assert inner.needs_fix[inner.inner_of[4]]
    with pytest.raises(LightGBMError, match="queue A, item 2"):
        lp.train(p, ds, 1)
