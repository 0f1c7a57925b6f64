"""Categorical binning and the front end: the port against the JAX package.

- ``BinMapper.find_bin(..., bin_type=CATEGORICAL)`` of both packages on the
  same sampled columns: negative codes (counted as NaN), NaN, more
  categories than ``max_bin``, the 99% cut, ``min_data_in_bin``, a single
  category, category 0 as the most frequent (swapped off bin 0), codes
  with gaps. ``bin_2_categorical``, ``categorical_2_bin``, ``num_bin``,
  ``missing_type``, ``most_freq_bin``, ``default_bin``, ``is_trivial`` and
  ``value_to_bin`` on seen, unseen, negative, fractional, infinite and NaN
  values must be equal.
- ``Dataset(X, y, categorical_feature=...)`` by index, by name (resolved
  against ``feature_name``) and through the ``categorical_feature``
  parameter ("0,2" and "name:a,b") gives the JAX package's layout,
  ``is_categorical`` and bins, EFB bundles included; a name that is not a
  feature raises.
- A validation set bins its categories with the training set's mappers.
(The model text's category lists: tests/test_torch_cat_train.py.)
"""
import numpy as np
import pytest

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.bin_mapper import BinMapper as JMapper
from lightgbm_tpu.data.bin_mapper import BinType as JBinType
from lightgbm_tpu.data.dataset import BinnedDataset as JBinned
import lightgbm_torch as lp
from lightgbm_torch.data.bin_mapper import BinMapper as PMapper
from lightgbm_torch.data.bin_mapper import BinType
from lightgbm_torch.data.synth import AIRLINE_NAMES, make_airline_like
from lightgbm_torch.utils.log import LightGBMError

FIELDS = ("num_bin", "missing_type", "most_freq_bin", "default_bin",
          "is_trivial", "bin_2_categorical", "categorical_2_bin")


def column(kind, n, rng):
    if kind == "zipf300":
        return (rng.zipf(1.3, n) % 300).astype(float)
    if kind == "negatives":
        c = rng.integers(0, 20, n).astype(float)
        neg = rng.random(n) < 0.1
        c[neg] = -rng.integers(1, 5, int(neg.sum()))
        return c
    if kind == "nan":
        c = rng.integers(0, 15, n).astype(float)
        c[rng.random(n) < 0.08] = np.nan
        return c
    if kind == "single":
        return np.full(n, 7.0)
    if kind == "zero_most":
        return np.where(rng.random(n) < 0.6, 0.0, rng.integers(1, 9, n))
    if kind == "zero_only_other":
        return np.where(rng.random(n) < 0.9, 0.0, 3.0)
    if kind == "gaps":
        return rng.choice([2.0, 50.0, 51.0, 400.0, 1000.0], n)
    if kind == "long_tail":           # many rare codes: the 99% cut
        c = rng.integers(0, 5, n).astype(float)
        tail = rng.random(n) < 0.02
        c[tail] = 10 + rng.integers(0, 500, int(tail.sum()))
        return c
    raise ValueError(kind)


KINDS = ("zipf300", "negatives", "nan", "single", "zero_most",
         "zero_only_other", "gaps", "long_tail")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("max_bin,min_data_in_bin", [(255, 3), (16, 3),
                                                     (255, 40)])
def test_categorical_mapper_matches_jax(kind, max_bin, min_data_in_bin):
    rng = np.random.default_rng(KINDS.index(kind))
    n = 5000
    col = column(kind, n, rng)
    nonzero = col[(np.abs(col) > 1e-35) | np.isnan(col)]
    j, p = JMapper(), PMapper()
    j.find_bin(nonzero, n, max_bin, min_data_in_bin, 20, True,
               bin_type=JBinType.CATEGORICAL)
    p.find_bin(nonzero, n, max_bin, min_data_in_bin, 20, True,
               bin_type=BinType.CATEGORICAL)
    assert p.is_categorical
    for f in FIELDS:
        assert getattr(p, f) == getattr(j, f), f
    probe = np.concatenate([np.unique(col[~np.isnan(col)]),
                            [np.nan, -1.0, -0.5, 0.4, 2.7, 999.0, 1e12,
                             np.inf, -np.inf, 300.0, 301.0]])
    if not p.is_trivial:
        np.testing.assert_array_equal(p.value_to_bin(probe),
                                      j.value_to_bin(probe))
        assert [p.bin_to_value(b) for b in range(p.num_bin)] == \
            [j.bin_to_value(b) for b in range(j.num_bin)]


def test_most_frequent_bin_is_never_zero():
    rng = np.random.default_rng(3)
    col = column("zero_most", 4000, rng)
    p = PMapper()
    p.find_bin(col[col != 0], 4000, 255, 3, 20, True,
               bin_type=BinType.CATEGORICAL)
    assert p.bin_2_categorical[1] == 0 and p.most_freq_bin == 1


def _both(X, y, params, **kw):
    pj = dict(params)
    ds_j = JBinned.from_matrix(X, JConfig(dict(pj)), label=y,
                               categorical_features=kw.pop("cat_j"))
    dp = lp.Dataset(X, y, params=dict(params, device_type="cpu"), **kw)
    dp.construct()
    return ds_j, dp._inner


LAYOUT = ("group_of", "group_offset", "bin_start", "bin_end",
          "most_freq_bin", "default_bin", "missing_type_arr", "needs_fix",
          "is_categorical", "total_bins")


@pytest.mark.parametrize("how", ["index", "name", "param", "param_name"])
def test_dataset_matches_jax(how):
    X, y = make_airline_like(6000, seed=11)
    X[np.random.default_rng(1).random(X.shape) < 0.02] = np.nan
    names = list(AIRLINE_NAMES)
    cat = [0, 3, 4, 5]
    params = {"verbose": -1}
    kw = {"feature_name": names}
    if how == "index":
        kw["categorical_feature"] = cat
    elif how == "name":
        kw["categorical_feature"] = [names[c] for c in cat]
    elif how == "param":
        params["categorical_feature"] = "0,3,4,5"
    else:
        params["categorical_feature"] = "name:" + ",".join(
            names[c] for c in cat)
    ds_j, ds_p = _both(X, y, params, cat_j=cat, **kw)
    for a in LAYOUT:
        np.testing.assert_array_equal(np.asarray(getattr(ds_p, a)),
                                      np.asarray(getattr(ds_j, a)), a)
    assert ds_p.groups == ds_j.groups
    np.testing.assert_array_equal(ds_p.binned, ds_j.binned)
    assert [ds_p.inner_of[c] for c in cat] == [ds_j.inner_of[c] for c in cat]
    assert ds_p.is_categorical[[ds_p.inner_of[c] for c in cat]].all()
    assert ds_p.is_categorical.sum() == len(cat)


def test_bundled_categorical_layout_matches_jax():
    """EFB bundles a sparse categorical column with sparse numerical ones
    as the JAX package does."""
    rng = np.random.default_rng(12)
    n = 4000
    X = np.zeros((n, 5))
    X[:, 0] = rng.normal(size=n)
    active = rng.integers(0, 8, n)
    for j in (1, 2, 3):
        on = active == j
        X[on, j] = rng.normal(size=int(on.sum())) + 3
    on = active == 4
    X[on, 4] = rng.integers(1, 6, int(on.sum()))
    y = (X[:, 0] > 0).astype(float)
    ds_j, ds_p = _both(X, y, {"verbose": -1}, cat_j=[4],
                       categorical_feature=[4])
    assert ds_p.has_bundles
    for a in LAYOUT:
        np.testing.assert_array_equal(np.asarray(getattr(ds_p, a)),
                                      np.asarray(getattr(ds_j, a)), a)
    np.testing.assert_array_equal(ds_p.binned, ds_j.binned)


def test_unknown_categorical_name_raises():
    X, y = make_airline_like(500, seed=1)
    ds = lp.Dataset(X, y, feature_name=list(AIRLINE_NAMES),
                    categorical_feature=["Month", "Airport"],
                    params={"device_type": "cpu"})
    with pytest.raises(LightGBMError, match="Airport"):
        ds.construct()


def test_validation_set_bins_with_training_categories():
    """A validation set built with reference= bins its categories with the
    training set's mappers: an unseen category takes the last bin."""
    X, y = make_airline_like(3000, seed=13)
    Xv, yv = make_airline_like(1000, seed=14)
    Xv[:10, 4] = 777.0
    p = {"device_type": "cpu", "verbose": -1}
    dt = lp.Dataset(X, y, categorical_feature=[0, 4], params=p)
    dv = lp.Dataset(Xv, yv, reference=dt, params=p)
    dv.construct()
    m = dt._inner.bin_mappers[4]
    g = dt._inner.group_of[dt._inner.inner_of[4]]
    assert (dv._inner.binned[:10, g] == m.num_bin - 1).all()
    np.testing.assert_array_equal(dv._inner.binned[:, g],
                                  m.value_to_bin(Xv[:, 4]))
