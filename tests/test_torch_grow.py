"""The port's partitioned grower against the JAX package's.

Both growers get identical bins (the JAX BinnedDataset's arrays, carried
over with ``lightgbm_torch.convert.dataset_from_reference``) and identical
f32 gradients. The JAX side runs ``grow_tree_partitioned`` exactly as
tests/test_pallas_scan.py does on the CPU: f32 sums, scatter histograms,
and the fused ``scan_pair`` kernel in interpret mode. The port runs on the
CPU, so its kernels' plain versions do the work.

Tree structure, leaf counts and the row -> leaf map must be equal. Gains
and leaf values agree within the tolerances test_pallas_scan.py holds the
two JAX scans to (rtol 2e-4): the sums are f32 in different orders. There
the two scans share one histogram; here the histograms too are summed in
different row orders, so a leaf output, -(left grad sum) / (left hess sum),
also carries the f32 rounding of the sums it is cancelled out of: a value
near zero is held to 4 f32 ulps of sum|grad| over its hessian instead.

default_left is equal on every split whose leaf holds rows in the split
feature's missing bin (the NaN bin, or the zero bin under
zero_as_missing). Where that bin is empty the forward and REVERSE scans
describe the same partition with mathematically equal gains, and which one
wins ("forward only on strictly greater gain") is decided by f32 rounding,
differently in each package; no training row routes differently
(ROADMAP.md queue C records this).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lightgbm_tpu as lt
from lightgbm_tpu.data.dataset import BinnedDataset
from lightgbm_tpu.ops.grow import GrowConfig, grow_tree_partitioned
from lightgbm_tpu.ops.split import SplitParams as JaxSplitParams
from lightgbm_tpu.treelearner.serial import build_cat_layout, build_gw_global
from lightgbm_torch import Config
from lightgbm_torch.convert import dataset_from_reference
from lightgbm_torch.treelearner.serial import SerialTreeLearner


def _problem(n=4000, f=7, seed=3, missing=True, zero_as_missing=False):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    if missing:
        X[rng.random((n, f)) < 0.08] = np.nan
        X[:, 2] = np.where(rng.random(n) < 0.6, 0.0, X[:, 2])
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) > 0.2)
    params = {"num_leaves": 31, "max_bin": 63, "min_data_in_leaf": 20,
              "zero_as_missing": zero_as_missing}
    ds = BinnedDataset.from_matrix(X, lt.Config(params),
                                   label=y.astype(np.float32))
    grad = ((0.5 - y) * rng.uniform(0.5, 1.5, n)).astype(np.float32)
    hess = rng.uniform(0.1, 0.25, n).astype(np.float32)
    return params, ds, grad, hess


def _jax_grow(ds, params, grad, hess):
    cfg = lt.Config(params)
    layout, meta = ds.to_device(cfg)
    widths = ds.bin_end - ds.bin_start
    gc = GrowConfig(
        num_leaves=params["num_leaves"], total_bins=ds.total_bins,
        num_features=ds.num_features, use_mc=False, max_depth=-1,
        rows_per_chunk=0, cat_width=1, hist_impl="scatter",
        scan_width=int(widths.max()), use_dp=False, window_chunk=512,
        hist_dtype="f32", use_l1=False, use_mds=False, scan_impl="pallas")
    arrays, _ = grow_tree_partitioned(
        layout, jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(ds.num_data, bool), meta, JaxSplitParams.from_config(cfg),
        jnp.ones(ds.num_features, bool), ds.fix_info(), gc,
        gw_global=build_gw_global(ds), cat=build_cat_layout(ds, 1))
    return jax.device_get(arrays)


def _reference_arrays(ds):
    return {"bins": ds.binned, "group_offset": ds.group_offset,
            "bin_start": ds.bin_start, "bin_end": ds.bin_end,
            "missing_type": ds.missing_type_arr,
            "default_bin": ds.default_bin,
            "most_freq_bin": ds.most_freq_bin,
            "label": ds.metadata.label}


def _port_grow(ds, params, grad, hess):
    port_ds = dataset_from_reference(_reference_arrays(ds))
    cfg = Config(dict(params, objective="binary", device_type="cpu"))
    learner = SerialTreeLearner(cfg, port_ds, torch.device("cpu"))
    arrays, row_leaf = learner.train_arrays(torch.as_tensor(grad),
                                            torch.as_tensor(hess))
    return arrays, row_leaf.numpy()


def _missing_rows_per_split(ds, arrays):
    """Rows of the split leaf that sit in the split feature's missing bin,
    for each split, by replaying the JAX grower's partitions."""
    leaf = np.zeros(ds.num_data, np.int64)
    out = []
    for k in range(int(arrays.num_leaves) - 1):
        f, g = arrays.split_feature[k], ds.group_of[arrays.split_feature[k]]
        loc = (ds.binned[:, g].astype(np.int64) + ds.group_offset[g]
               - ds.bin_start[f])
        nb = ds.bin_end[f] - ds.bin_start[f]
        mt = ds.missing_type_arr[f]
        miss = (((mt == 2) & (loc == nb - 1))
                | ((mt == 1) & (loc == ds.default_bin[f])))
        in_leaf = leaf == arrays.split_leaf[k]
        out.append(int((in_leaf & miss).sum()))
        go_left = np.where(miss, arrays.default_left[k],
                           loc <= arrays.threshold[k])
        leaf[in_leaf & ~go_left] = k + 1
    np.testing.assert_array_equal(leaf, arrays.row_leaf)
    return np.asarray(out)


@pytest.mark.parametrize("missing,zero_as_missing,seed",
                         [(False, False, 3), (True, False, 3),
                          (True, False, 8), (True, True, 5)])
def test_port_grower_matches_jax(missing, zero_as_missing, seed):
    params, ds, grad, hess = _problem(seed=seed, missing=missing,
                                      zero_as_missing=zero_as_missing)
    assert not ds.has_bundles
    a = _jax_grow(ds, params, grad, hess)
    b, row_leaf = _port_grow(ds, params, grad, hess)
    assert int(a.num_leaves) == b.num_leaves > 20
    k = b.num_leaves - 1
    np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
    np.testing.assert_array_equal(a.threshold[:k], b.threshold[:k])
    populated = _missing_rows_per_split(ds, a) > 0
    np.testing.assert_array_equal(a.default_left[:k][populated],
                                  b.default_left[:k][populated])
    if not missing:
        np.testing.assert_array_equal(a.default_left[:k], b.default_left[:k])
    np.testing.assert_array_equal(a.split_leaf[:k], b.split_leaf[:k])
    np.testing.assert_allclose(a.gain[:k], b.gain[:k], rtol=2e-4, atol=1e-5)
    nl = b.num_leaves
    np.testing.assert_array_equal(a.leaf_count[:nl], b.leaf_count[:nl])
    ref = np.asarray(a.leaf_value[:nl], np.float64)
    cancel = 4 * np.finfo(np.float32).eps * np.abs(grad).sum() \
        / np.asarray(a.leaf_weight[:nl], np.float64)
    assert np.all(np.abs(b.leaf_value[:nl] - ref)
                  <= np.maximum(2e-4 * np.abs(ref) + 1e-7, cancel))
    np.testing.assert_array_equal(a.internal_count[:k], b.internal_count[:k])
    np.testing.assert_array_equal(a.row_leaf, row_leaf)


def test_grower_limits_depth_like_jax():
    params, ds, grad, hess = _problem(seed=4)
    params = dict(params, max_depth=3)
    cfg = lt.Config(params)
    layout, meta = ds.to_device(cfg)
    widths = ds.bin_end - ds.bin_start
    gc = GrowConfig(
        num_leaves=31, total_bins=ds.total_bins,
        num_features=ds.num_features, use_mc=False, max_depth=3,
        rows_per_chunk=0, cat_width=1, hist_impl="scatter",
        scan_width=int(widths.max()), use_dp=False, window_chunk=512,
        hist_dtype="f32", use_l1=False, use_mds=False, scan_impl="pallas")
    a = jax.device_get(grow_tree_partitioned(
        layout, jnp.asarray(grad), jnp.asarray(hess),
        jnp.ones(ds.num_data, bool), meta, JaxSplitParams.from_config(cfg),
        jnp.ones(ds.num_features, bool), ds.fix_info(), gc,
        gw_global=build_gw_global(ds), cat=build_cat_layout(ds, 1))[0])
    b, row_leaf = _port_grow(ds, params, grad, hess)
    assert int(a.num_leaves) == b.num_leaves == 8
    np.testing.assert_array_equal(a.split_feature[:7], b.split_feature[:7])
    np.testing.assert_array_equal(a.threshold[:7], b.threshold[:7])
    np.testing.assert_array_equal(a.row_leaf, row_leaf)


def test_dataset_from_reference_keeps_the_layout():
    params, ds, _, _ = _problem(seed=3, missing=True)
    port = dataset_from_reference(_reference_arrays(ds))
    np.testing.assert_array_equal(port.group_of, ds.group_of)
    assert port.groups == ds.groups and port.total_bins == ds.total_bins
    data = port.to_device("cpu")
    np.testing.assert_array_equal(data.bins.numpy(), ds.binned)
    np.testing.assert_array_equal(data.most_freq_bin.numpy(),
                                  ds.most_freq_bin)


@pytest.mark.cuda
def test_cuda_grower_matches_cpu_grower():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    params, ds, grad, hess = _problem(seed=3, missing=True)
    port_ds = dataset_from_reference(_reference_arrays(ds))
    cfg = Config(dict(params, objective="binary"))
    out = {}
    for dev in ("cpu", "cuda"):
        learner = SerialTreeLearner(cfg, port_ds, torch.device(dev))
        arrays, rl = learner.train_arrays(torch.as_tensor(grad, device=dev),
                                          torch.as_tensor(hess, device=dev))
        out[dev] = (arrays, rl.cpu().numpy())
    (a, ra), (b, rb) = out["cpu"], out["cuda"]
    k = a.num_leaves - 1
    assert a.num_leaves == b.num_leaves
    np.testing.assert_array_equal(a.split_feature[:k], b.split_feature[:k])
    np.testing.assert_array_equal(a.threshold[:k], b.threshold[:k])
    np.testing.assert_array_equal(ra, rb)
    np.testing.assert_allclose(a.leaf_value[:k + 1], b.leaf_value[:k + 1],
                               rtol=2e-4, atol=1e-7)
