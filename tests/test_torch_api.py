"""The rest of the Booster and Dataset API: the port against the JAX package
on the CPU, on the same numpy inputs.

- Dataset: ``subset`` (the rows' bins, labels, weights, recomputed query
  sizes and the init scores in their three layouts: [n], [n * K]
  class-major and [n, K]) against the JAX package's subset;
  ``add_features_from`` (bins, groups, bin ranges, names) against the JAX
  package's, then a v1 training on the merged Dataset equal to one on the
  concatenated matrix and to the JAX package's trees; the field setters and
  getters (tests/test_dataset_io.py:114 and tests/test_engine.py:293 of
  the JAX package).
- Booster, on one model text read by both packages: ``dump_model``,
  ``feature_importance`` (split and gain), ``num_feature``,
  ``num_model_per_iteration`` and ``feature_name`` equal; pickle,
  ``copy`` and ``deepcopy`` predict bit for bit; ``model_from_string``
  replaces the model.
- Refusals of keys the JAX package honours and the port does not run yet:
  ``pred_early_stop`` in a binary or multiclass Booster's parameters
  (ROADMAP.md queue A, item 8, step 2) and the checkpoint and telemetry
  keys of ``train`` (queue A, item 10).
"""
import copy
import pickle

import numpy as np
import pytest

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_torch.utils.log import LightGBMError
from test_torch_multiclass import BASE, assert_same_models, class_data

CPU = {"device_type": "cpu"}


def _parents(n=600, K=1, layout="flat"):
    """(X, y, fields) of a Dataset with weights, 60 queries of 10 rows and
    init scores in `layout` ("flat": [n]; "class-major": [n * K];
    "matrix": [n, K])."""
    X, y = class_data(n=n, K=2, seed=11)
    rng = np.random.default_rng(12)
    w = rng.uniform(0.5, 1.5, n)
    if layout == "matrix":
        isc = rng.normal(size=(n, K))
    else:
        isc = rng.normal(size=n * K if layout == "class-major" else n)
    return X, y, dict(weight=w, group=np.full(n // 10, 10), init_score=isc)


@pytest.mark.parametrize("layout", ["flat", "class-major", "matrix"])
def test_subset_matches_jax(layout):
    X, y, fields = _parents(K=1 if layout == "flat" else 3, layout=layout)
    # rows that cut queries in the middle and skip some whole
    idx = np.concatenate([np.arange(95, 137), np.arange(300, 421, 2)])
    dj = lt.Dataset(X, y, free_raw_data=False, **fields).construct()
    dp = lp.Dataset(X, y, params=CPU, **fields).construct()
    sj, sp = dj.subset(idx).construct(), dp.subset(idx).construct()
    np.testing.assert_array_equal(sp._inner.binned, sj._inner.binned)
    for f in ("label", "weight", "group", "init_score"):
        want, got = sj.get_field(f), sp.get_field(f)
        np.testing.assert_array_equal(np.asarray(got).reshape(-1),
                                      np.asarray(want).reshape(-1), f)
    # query 9 cut at row 95, 10-12 whole, 13 cut at 137, 30-41 at every
    # other row, 42 one row
    assert list(sp.get_group()) == [5, 10, 10, 10, 7] + [5] * 12 + [1]
    assert sp.num_data() == len(idx)
    np.testing.assert_array_equal(sp.used_indices, idx)
    # the subset keeps the parent's mappers
    assert sp._inner.bin_mappers is dp._inner.bin_mappers


def test_subset_trains_as_rebinned_rows():
    """A subset is a training set: the same trees as the rows binned with
    the parent as the reference, and a subset of a subset takes the
    parent's rows even when the Booster re-references it."""
    X, y = class_data(n=3000, K=2, seed=13)
    p = dict(BASE, objective="binary", **CPU)
    full = lp.Dataset(X, y, params=p)
    idx = np.arange(0, 3000, 2)
    a = lp.train(p, full.subset(idx), 4)
    b = lp.train(p, lp.Dataset(X[idx], y[idx], reference=full, params=p), 4)
    assert a.model_to_string().split("parameters:")[0] == \
        b.model_to_string().split("parameters:")[0]
    tr, te = full.subset(idx), full.subset(idx + 1)
    bst = lp.Booster(p, tr)
    bst.add_valid(te, "te")
    np.testing.assert_array_equal(te._inner.binned,
                                  full._inner.binned[idx + 1])


def test_add_features_from_matches_jax():
    rng = np.random.default_rng(5)
    n = 1500
    Xa, Xb = rng.normal(size=(n, 3)), rng.normal(size=(n, 2))
    y = (Xa[:, 0] + Xb[:, 0] + 0.3 * rng.normal(size=n) > 0).astype(float)
    params = {"max_bin": 63, "enable_bundle": False, "verbosity": -1}
    merged = {}
    for lib, extra in ((lt, {}), (lp, CPU)):
        da = lib.Dataset(Xa, y, params=dict(params, **extra),
                         free_raw_data=False)
        db = lib.Dataset(Xb, params=dict(params, **extra),
                         free_raw_data=False)
        da.construct()
        db.construct()
        da.add_features_from(db)
        assert da.num_feature() == 5
        merged[lib] = da
    ij, ip = merged[lt]._inner, merged[lp]._inner
    np.testing.assert_array_equal(ip.binned, ij.binned)
    assert ip.groups == ij.groups and ip.feature_names == ij.feature_names
    for f in ("group_of", "bin_start", "bin_end", "group_offset",
              "default_bin", "most_freq_bin"):
        np.testing.assert_array_equal(getattr(ip, f), getattr(ij, f), f)
    assert ip.total_bins == ij.total_bins
    # the device copy of the bins follows
    np.testing.assert_array_equal(ip.to_device("cpu").bins.numpy(),
                                  ip.binned)
    X = np.concatenate([Xa, Xb], axis=1)
    tp = dict(BASE, objective="binary", max_bin=63, enable_bundle=False)
    whole = lp.Dataset(X, y, params=dict(tp, **CPU))
    bp = lp.train(dict(tp, **CPU), merged[lp], 5)
    bw = lp.train(dict(tp, **CPU), whole, 5)
    np.testing.assert_array_equal(bp.predict(X, raw_score=True),
                                  bw.predict(X, raw_score=True))
    bj = lt.train(dict(tp, tpu_persist_scan="false"), merged[lt], 5)
    assert_same_models(bj, bp, X, tp["learning_rate"], 1)


def test_field_setters_and_getters():
    """tests/test_dataset_io.py:114 and tests/test_engine.py:293 of the JAX
    package, on the port: every field before and after construction."""
    X, y, fields = _parents(n=600)
    w, isc, group = fields["weight"], fields["init_score"], fields["group"]
    ds = lp.Dataset(X, params=CPU)
    ds.set_label(y).set_weight(w).set_init_score(isc).set_group(group)
    ds.set_feature_name(["f%d" % i for i in range(X.shape[1])])
    ds.set_categorical_feature([])
    assert ds.get_init_score() is isc
    ds.construct()
    assert ds.get_feature_name() == ["f%d" % i for i in range(X.shape[1])]
    np.testing.assert_array_equal(ds.get_field("label"), y.astype(np.float32))
    np.testing.assert_allclose(ds.get_field("weight"), w, rtol=1e-7)
    np.testing.assert_array_equal(ds.get_field("init_score"), isc)
    np.testing.assert_array_equal(ds.get_field("group"), group)
    ds.set_field("weight", None)
    assert ds.get_weight() is None
    ds.set_field("init_score", 2 * isc)
    np.testing.assert_array_equal(ds.get_init_score(), 2 * isc)
    ds.set_categorical_feature([0])          # after construction: ignored
    assert ds.categorical_feature == []
    sub = ds.subset(np.arange(100, 300))
    sub.construct()
    np.testing.assert_array_equal(sub.get_init_score(), 2 * isc[100:300])
    np.testing.assert_array_equal(sub.get_group(), np.full(20, 10))
    assert sub.get_feature_name() == ds.get_feature_name()


@pytest.fixture(scope="module")
def model_pair():
    """One softmax model text (JAX v1, 3 classes, 4 iterations) read by
    both packages, and rows to predict."""
    X, y = class_data(n=2000, K=3, seed=14)
    p = dict(BASE, objective="multiclass", num_class=3,
             tpu_persist_scan="false")
    text = lt.train(p, lt.Dataset(X, y), 4).model_to_string()
    bj = lt.Booster(model_str=text)
    bp = lp.Booster(params=dict(CPU), model_str=text)
    return bj, bp, X


def test_booster_reports_match_jax(model_pair):
    bj, bp, X = model_pair
    assert bp.dump_model() == bj.dump_model()
    assert bp.dump_model(num_iteration=2, start_iteration=1) == \
        bj.dump_model(num_iteration=2, start_iteration=1)
    for kind in ("split", "gain"):
        np.testing.assert_array_equal(bp.feature_importance(kind),
                                      bj.feature_importance(kind))
        np.testing.assert_array_equal(bp.feature_importance(kind, 2),
                                      bj.feature_importance(kind, 2))
    assert bp.feature_importance().dtype == np.int32
    assert bp.num_feature() == bj.num_feature()
    assert bp.num_model_per_iteration() == bj.num_model_per_iteration() == 3
    assert bp.feature_name() == bj.feature_name()
    t = bp._booster.models[0]
    assert t.max_depth() == bj._booster.models[0].max_depth()
    with pytest.raises(LightGBMError, match="importance type"):
        bp.feature_importance("cover")


def test_pickle_and_copies_predict_bit_for_bit(model_pair):
    _, bp, X = model_pair
    want = bp.predict(X)
    for other in (pickle.loads(pickle.dumps(bp)), copy.copy(bp),
                  copy.deepcopy(bp)):
        assert other is not bp and other._booster is not bp._booster
        np.testing.assert_array_equal(other.predict(X), want)
        np.testing.assert_array_equal(other.predict(X, pred_leaf=True),
                                      bp.predict(X, pred_leaf=True))
    short = lp.Booster(params=dict(CPU), model_str=bp.model_to_string())
    short.model_from_string(bp.model_to_string(num_iteration=1))
    assert short.num_trees() == 3
    np.testing.assert_array_equal(short.predict(X),
                                  bp.predict(X, num_iteration=1))


def test_set_leaf_output_and_depth():
    X, y = class_data(n=1500, K=2, seed=15)
    p = dict(BASE, objective="binary", **CPU)
    t = lp.train(p, lp.Dataset(X, y, params=p), 1)._booster.models[0]
    t.set_leaf_output(1, float("nan"))
    t.set_leaf_output(2, 0.25)
    assert t.leaf_value[1] == 0.0 and t.leaf_value[2] == 0.25
    depths = t.leaf_depths()
    assert depths.min() >= 1 and t.max_depth() == depths.max()
    assert len(depths) == t.num_leaves


def test_pred_early_stop_in_params_raises():
    """C13: the JAX package's predict honours pred_early_stop from the
    Booster's parameters for binary and multiclass models; the port
    refuses it there and predicts in full elsewhere."""
    X, y = class_data(n=1500, K=3, seed=16)
    for obj, extra in (("binary", {}),
                       ("multiclass", {"num_class": 3}),
                       ("multiclassova", {"num_class": 3})):
        p = dict(BASE, objective=obj, **extra, **CPU)
        yy = (y > 0).astype(float) if obj == "binary" else y
        bst = lp.train(p, lp.Dataset(X, yy, params=p), 2)
        bst.params.update(pred_early_stop=True, pred_early_stop_freq=2)
        with pytest.raises(LightGBMError, match="item 8, step 2"):
            bst.predict(X)
        loaded = lp.Booster(params=dict(p, pred_early_stop=True),
                            model_str=bst.model_to_string())
        with pytest.raises(LightGBMError, match="item 8, step 2"):
            loaded.predict(X, raw_score=True)
    p = dict(BASE, objective="regression", pred_early_stop=True, **CPU)
    bst = lp.train(p, lp.Dataset(X, y, params=p), 2)
    assert bst.predict(X).shape == (len(y),)


@pytest.mark.parametrize("key", [{"checkpoint_dir": "ckpt"},
                                 {"snapshot_freq": 2},
                                 {"tpu_telemetry": "timers"},
                                 {"tpu_telemetry": "trace"}])
def test_checkpoint_and_telemetry_keys_raise(key, tmp_path):
    """C14: the JAX package's train checkpoints, resumes and traces under
    these keys; the port's refuses them, naming queue A item 10."""
    X, y = class_data(n=500, K=2, seed=17)
    p = dict(BASE, objective="binary", **CPU, **key)
    if "checkpoint_dir" in key:
        p["checkpoint_dir"] = str(tmp_path / "ckpt")
    with pytest.raises(LightGBMError, match="item 10"):
        lp.train(p, lp.Dataset(X, y, params=p), 2)
    assert not (tmp_path / "ckpt").exists()
    ok = dict(BASE, objective="binary", snapshot_freq=-1,
              tpu_telemetry="off", **CPU)
    assert lp.train(ok, lp.Dataset(X, y, params=ok), 1).num_trees() == 1
