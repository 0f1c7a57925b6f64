"""The port's host layer against the JAX package's: bin bounds, the dataset
group layout and bin matrix, and the parameter table."""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
from lightgbm_tpu.data.bin_mapper import BinMapper as JaxBinMapper
from lightgbm_tpu.data.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.data.synth import make_expo_like as jax_expo
from lightgbm_tpu.data.synth import make_higgs_like as jax_higgs
import lightgbm_torch as lp
from lightgbm_torch.config import PARAMS
from lightgbm_torch.data.bin_mapper import BinMapper
from lightgbm_torch.data.dataset import BinnedDataset
from lightgbm_torch.data.synth import make_expo_like, make_higgs_like
from lightgbm_torch.treelearner.serial import SerialTreeLearner, check_v1_layout
from lightgbm_torch.utils.log import LightGBMError


def _higgs_with_missing(n=6000, seed=7):
    X, y = make_higgs_like(n, seed=seed)
    rng = np.random.default_rng(seed)
    X[rng.random(n) < 0.1, 3] = np.nan             # NaN-missing column
    X[rng.random(n) < 0.7, 5] = 0.0                # zero-heavy column
    X[:, 9] = np.round(X[:, 9] * 2)                # few distinct values
    return X, y


def test_synth_is_the_jax_generator():
    a, b = make_higgs_like(1000, seed=3), jax_higgs(1000, seed=3)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])


def test_expo_synth_is_the_jax_generator():
    a, b = make_expo_like(1000, seed=3), jax_expo(1000, seed=3)
    assert a[0].shape == (1000, 648)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("col,use_missing,zero_as_missing,max_bin", [
    (0, True, False, 255), (3, True, False, 63), (5, True, False, 255),
    (5, True, True, 63), (9, True, False, 15), (3, False, False, 31),
    (3, True, True, 255)])
def test_bin_mapper_matches_jax(col, use_missing, zero_as_missing, max_bin):
    X, _ = _higgs_with_missing()
    v = X[:, col]
    nz = v[(np.abs(v) > 1e-35) | np.isnan(v)]
    a, b = BinMapper(), JaxBinMapper()
    kw = dict(use_missing=use_missing, zero_as_missing=zero_as_missing)
    a.find_bin(nz, len(v), max_bin, 3, 20, True, **kw)
    b.find_bin(nz, len(v), max_bin, 3, 20, True, **kw)
    np.testing.assert_array_equal(a.bin_upper_bound, b.bin_upper_bound)
    for k in ("num_bin", "missing_type", "is_trivial", "default_bin",
              "most_freq_bin", "min_val", "max_val", "sparse_rate"):
        assert getattr(a, k) == getattr(b, k), k
    np.testing.assert_array_equal(a.value_to_bin(v), b.value_to_bin(v))


@pytest.mark.parametrize("params", [
    {"max_bin": 255}, {"max_bin": 63, "zero_as_missing": True},
    {"max_bin": 31, "min_data_in_bin": 10, "bin_construct_sample_cnt": 2000},
    {"max_bin": 255, "enable_bundle": False}])
def test_dataset_layout_matches_jax(params):
    X, y = _higgs_with_missing()
    a = BinnedDataset.from_matrix(X, lp.Config(params), label=y)
    b = JaxDataset.from_matrix(X, lt.Config(params), label=y)
    assert a.used_features == b.used_features and a.groups == b.groups
    for k in ("group_offset", "group_of", "bin_start", "bin_end",
              "most_freq_bin", "default_bin", "missing_type_arr",
              "needs_fix", "binned"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k), k)
    assert a.total_bins == b.total_bins
    assert set(a.missing_type_arr.tolist()) >= (
        {1} if params.get("zero_as_missing") else {0, 2})
    data = a.to_device("cpu")
    assert data.bins.dtype == torch.uint8
    np.testing.assert_array_equal(data.bins.numpy(), b.binned)
    np.testing.assert_array_equal(data.bin_start.numpy(), b.bin_start)


def test_bundled_dataset_is_refused():
    """Sparse one-hot columns bundle under EFB; bundles need FixHistogram,
    which only the persistent grower's scan_blocks has, so the v1 grower
    refuses them by name while the learner (persistent grower) takes
    them."""
    rng = np.random.default_rng(0)
    n = 3000
    X = np.zeros((n, 6))
    X[np.arange(n), rng.integers(0, 6, n)] = 1.0
    X[:, 0] = rng.normal(size=n)
    ds = BinnedDataset.from_matrix(X, lp.Config({}), label=X[:, 0] > 0)
    assert ds.has_bundles
    cfg = lp.Config({"objective": "binary", "device_type": "cpu"})
    with pytest.raises(LightGBMError, match="ROADMAP.md queue A, item 2"):
        check_v1_layout(ds)
    SerialTreeLearner(cfg, ds, torch.device("cpu"))
    ds2 = BinnedDataset.from_matrix(X, lp.Config({"enable_bundle": False}),
                                    label=X[:, 0] > 0)
    assert not ds2.has_bundles
    check_v1_layout(ds2)
    SerialTreeLearner(cfg, ds2, torch.device("cpu"))


ALIAS_SETS = [
    {"num_iteration": 7, "eta": 0.05, "num_leaf": 15, "min_child_samples": 5,
     "reg_lambda": 1.5, "min_split_gain": 0.1, "subsample_for_bin": 5000,
     "colsample_bytree": 0.8, "seed": 3},
    {"objective": "binary", "max_bin": 63, "min_sum_hessian": 0.01,
     "zero_as_missing": "true", "feature_fraction_seed": 9,
     "is_unbalance": True, "verbose": -1},
    {"application": "xentropy", "boosting_type": "gbrt", "metric": "auc,l2",
     "lambda_l1": 0.5, "max_delta_step": 2.0, "monotone_constraints": "1,0,-1",
     "tree": "data_parallel", "bagging": 0.5, "subsample_freq": 2},
]


@pytest.mark.parametrize("params", ALIAS_SETS)
def test_config_matches_jax(params):
    a, b = lp.Config(params), lt.Config(params)
    for p in PARAMS:
        # cuda | cpu here, tpu there; prediction follows the device here
        if p.name in ("device_type", "predict_device"):
            continue
        assert getattr(a, p.name) == getattr(b, p.name), p.name
    assert a.predict_device == a.device_type
    assert a.extra == b.extra


@pytest.mark.parametrize("params,item", [
    # RF beyond the JAX fused RF gate (K > 1, an init score) trains on v1;
    # the persistent grower refuses it
    ({"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5,
      "objective": "multiclass", "num_class": 3,
      "tpu_persist_scan": "force"}, "item 25"),
    # GOSS with K > 1 and a renewal objective with a bag train on v1; the
    # persistent grower refuses them
    ({"boosting": "goss", "objective": "multiclass", "num_class": 3,
      "tpu_persist_scan": "force"}, "item 23"),
    ({"boosting": "rf", "bagging_freq": 1, "bagging_fraction": 0.5,
      "init_score": 0.25, "tpu_persist_scan": "force"}, "item 25"),
    ({"bagging_fraction": 0.5, "bagging_freq": 1,
      "objective": "regression_l1", "tpu_persist_scan": "force"},
     "item 24"),
    # the split scan's knobs train on v1; the persistent grower refuses
    ({"lambda_l1": 1.0, "tpu_persist_scan": "force"}, "item 4"),
    ({"max_delta_step": 1.0, "tpu_persist_scan": "force"}, "item 4"),
    ({"monotone_constraints": [1, 0, 0, 0], "tpu_persist_scan": "force"},
     "item 4"),
    ({"extra_trees": True, "tpu_persist_scan": "force"}, "item 4"),
    ({"feature_fraction_bynode": 0.5, "tpu_persist_scan": "force"},
     "item 4"),
    ({"cegb_penalty_split": 0.1}, "item 4"),
    ({"tpu_use_dp": True}, "item 4"),
    ({"tpu_scan_impl": "xla"}, "item 4"),
    ({"tpu_multival": "force"}, "item 2"),
    ({"tree_learner": "voting"}, "item 11"),
])
def test_out_of_slice_configs_are_refused(params, item):
    X, y = _higgs_with_missing(n=800)
    params = dict(params)
    init = params.pop("init_score", None)
    p = dict({"objective": "binary", "device_type": "cpu"}, **params)
    with pytest.raises(LightGBMError, match="ROADMAP.md queue A, %s" % item):
        lp.train(p, lp.Dataset(X[:, :4], y, params=p,
                               init_score=None if init is None
                               else np.full(len(y), init)), 1)
