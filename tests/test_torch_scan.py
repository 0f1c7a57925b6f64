"""scan_pair: the port's plain version against the JAX package's kernel.

Histograms and masks come from real layouts: data with NaN and zero-heavy
columns is binned by the JAX package (missing types None and NaN, or Zero
with zero_as_missing), the rows are split into two children, and the same
[B, Fp, Wp] planes go through ``lightgbm_torch.ops.scan.scan_pair_plain``
and the JAX ``scan_pair`` in interpret mode.

Thresholds, directions and has-split flags must be equal. Gains and left
sums agree within rtol 1e-5: the TPU kernel takes its prefix sums as a
HIGHEST-precision triangular matmul, the port as a running cumsum, so the
f32 sums are reassociated. Two constructed exact ties pin the tie rules:
REVERSE keeps the highest threshold, forward the lowest.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lt
from lightgbm_tpu.data.dataset import BinnedDataset
from lightgbm_tpu.ops.pallas_scan import ScanLayout as JaxScanLayout
from lightgbm_tpu.ops.pallas_scan import scan_pair as jax_scan_pair
from lightgbm_torch.ops.scan import (ScanLayout, pair_scalars, scan_pair,
                                     scan_pair_plain)

PARAMS = dict(lambda_l2=0.0, min_gain_to_split=0.0, min_data_in_leaf=20,
              min_sum_hessian_in_leaf=1e-3)


def _dataset(zero_as_missing, seed=3, n=3000, f=6):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, f))
    X[rng.random((n, f)) < 0.08] = np.nan
    X[:, 2] = np.where(rng.random(n) < 0.6, 0.0, X[:, 2])
    X[:, 4] = np.round(X[:, 4])            # few distinct values: narrow bins
    y = (np.nan_to_num(X[:, 0]) + 0.5 * np.nan_to_num(X[:, 1]) > 0.2)
    cfg = lt.Config({"max_bin": 63, "zero_as_missing": zero_as_missing,
                     "min_data_in_leaf": 20})
    ds = BinnedDataset.from_matrix(X, cfg, label=y.astype(np.float32))
    grad = (0.5 - y).astype(np.float32) * rng.uniform(0.5, 1.5, n).astype(
        np.float32)
    hess = rng.uniform(0.1, 0.25, n).astype(np.float32)
    return cfg, ds, grad, hess


def _layouts(cfg, ds, fmask=None):
    _, meta = ds.to_device(cfg)
    F = ds.num_features
    W = int((ds.bin_end - ds.bin_start).max())
    fm = np.ones(F, bool) if fmask is None else fmask
    jl = JaxScanLayout(meta, jnp.asarray(fm), F, W, ds.total_bins)
    pl = ScanLayout(ds.bin_start, ds.bin_end, ds.missing_type_arr,
                    ds.default_bin, ds.penalty, fm, W, ds.total_bins, "cpu")
    return jl, pl


def _children(ds, grad, hess, seed):
    """Two children of a random split: [2, TB, 2] histograms + sums."""
    rng = np.random.default_rng(seed)
    left = rng.random(ds.num_data) < 0.4
    gbin = ds.binned.astype(np.int64) + ds.group_offset[None, :]
    hists, sums = [], []
    for m in (left, ~left):
        h = np.zeros((ds.total_bins, 2), np.float32)
        for g in range(gbin.shape[1]):
            np.add.at(h[:, 0], gbin[m, g], grad[m])
            np.add.at(h[:, 1], gbin[m, g], hess[m])
        hists.append(h)
        sums.append((np.float32(grad[m].sum()), np.float32(hess[m].sum()),
                     int(m.sum())))
    return np.stack(hists), sums


def _run_both(jl, pl, hists, sums, batched_valid=False):
    gidx = np.asarray(jl.gidx)
    np.testing.assert_array_equal(gidx, pl.gidx.numpy())
    gb = np.ascontiguousarray(hists[:, :, 0][:, gidx])
    hb = np.ascontiguousarray(hists[:, :, 1][:, gidx])
    scal = pair_scalars([s[0] for s in sums], [s[1] for s in sums],
                        [s[2] for s in sums], **PARAMS)
    vr = np.array(jl.valid_r, np.float32)
    vf = np.array(jl.valid_f, np.float32)
    if batched_valid:
        vr = np.stack([vr, vr * (np.arange(vr.shape[0]) % 2 == 0)[:, None]])
        vf = np.stack([vf, vf * (np.arange(vf.shape[0]) % 2 == 0)[:, None]])
    ref = np.asarray(jax_scan_pair(
        jnp.asarray(scal), jnp.asarray(gb), jnp.asarray(hb), jl.keep_r,
        jl.keep_f, jnp.asarray(vr), jnp.asarray(vf), jl.aux,
        interpret=True))
    t = torch.as_tensor
    got = scan_pair_plain(t(scal), t(gb), t(hb), pl.keep_r, pl.keep_f,
                          t(np.ascontiguousarray(vr)),
                          t(np.ascontiguousarray(vf)),
                          pl.aux).numpy()
    return ref, got


def _assert_match(ref, got, F):
    for row in (1, 2, 6):                  # threshold, use_f, has: exact
        np.testing.assert_array_equal(got[:, row, :F], ref[:, row, :F])
    fin = np.isfinite(ref[:, 0, :F])
    np.testing.assert_array_equal(fin, np.isfinite(got[:, 0, :F]))
    np.testing.assert_allclose(got[:, 0, :F][fin], ref[:, 0, :F][fin],
                               rtol=1e-5)
    has = ref[:, 6, :F] > 0.5
    for row in (3, 4, 5):                  # left grad / hess / count
        np.testing.assert_allclose(got[:, row, :F][has], ref[:, row, :F][has],
                                   rtol=1e-5)


@pytest.mark.parametrize("zero_as_missing", [False, True])
def test_layout_masks_match_jax(zero_as_missing):
    cfg, ds, _, _ = _dataset(zero_as_missing)
    fmask = np.ones(ds.num_features, bool)
    fmask[1] = False
    jl, pl = _layouts(cfg, ds, fmask)
    for name in ("keep_r", "keep_f", "valid_r", "valid_f", "aux"):
        np.testing.assert_array_equal(getattr(pl, name).numpy(),
                                      np.asarray(getattr(jl, name)))
    np.testing.assert_array_equal(pl.forced_right,
                                  np.asarray(jl.forced_right))
    kinds = set(ds.missing_type_arr.tolist())
    assert kinds == ({1} if zero_as_missing else {2})


@pytest.mark.parametrize("zero_as_missing,seed,batched",
                         [(False, 1, False), (False, 2, True),
                          (True, 1, False), (True, 3, True)])
def test_plain_matches_jax_kernel(zero_as_missing, seed, batched):
    cfg, ds, grad, hess = _dataset(zero_as_missing, seed=seed)
    jl, pl = _layouts(cfg, ds)
    hists, sums = _children(ds, grad, hess, seed)
    ref, got = _run_both(jl, pl, hists, sums, batched_valid=batched)
    _assert_match(ref, got, ds.num_features)
    assert (ref[:, 6, :ds.num_features] > 0.5).sum() > 4   # real splits


def test_missing_type_none_features():
    """Dense columns without NaN get MissingType None: one REVERSE scan."""
    rng = np.random.default_rng(4)
    X = rng.normal(size=(2000, 4))
    y = X[:, 0] > 0
    cfg = lt.Config({"max_bin": 31})
    ds = BinnedDataset.from_matrix(X, cfg, label=y.astype(np.float32))
    assert set(ds.missing_type_arr.tolist()) == {0}
    grad = (0.5 - y).astype(np.float32)
    hess = np.full(2000, 0.25, np.float32)
    jl, pl = _layouts(cfg, ds)
    hists, sums = _children(ds, grad, hess, 7)
    ref, got = _run_both(jl, pl, hists, sums)
    _assert_match(ref, got, ds.num_features)
    assert not ref[:, 2, :4].any()                 # never forward


def _tie_case(missing_type, grad_b, hess_b):
    """One feature of len(grad_b) bins, scanned by both versions."""
    nb = len(grad_b)
    pl = ScanLayout([0], [nb], [missing_type], [0], [1.0], [True], nb, nb,
                    "cpu")
    gb = np.zeros((1, pl.Fp, pl.Wp), np.float32)
    hb = np.zeros((1, pl.Fp, pl.Wp), np.float32)
    gb[0, 0, :nb] = grad_b
    hb[0, 0, :nb] = hess_b
    cnt = int(round(sum(hess_b) * 4))            # hess 0.25 per row
    scal = pair_scalars([np.float32(sum(grad_b))], [np.float32(sum(hess_b))],
                        [cnt], lambda_l2=0.0, min_gain_to_split=0.0,
                        min_data_in_leaf=1, min_sum_hessian_in_leaf=1e-3)
    t = torch.as_tensor
    got = scan_pair_plain(t(scal), t(gb), t(hb), pl.keep_r, pl.keep_f,
                          pl.valid_r, pl.valid_f, pl.aux).numpy()
    ref = np.asarray(jax_scan_pair(
        jnp.asarray(scal), jnp.asarray(gb), jnp.asarray(hb),
        jnp.asarray(pl.keep_r.numpy()), jnp.asarray(pl.keep_f.numpy()),
        jnp.asarray(pl.valid_r.numpy()), jnp.asarray(pl.valid_f.numpy()),
        jnp.asarray(pl.aux.numpy()), interpret=True))
    return got, ref


def test_reverse_tie_keeps_highest_threshold():
    # bins 1 and 2 are empty: thresholds 0, 1, 2 split the rows the same
    # way, so their gains are exactly equal; REVERSE keeps threshold 2
    got, ref = _tie_case(0, [4.0, 0.0, 0.0, -4.0], [2.0, 0.0, 0.0, 2.0])
    np.testing.assert_array_equal(got, ref)
    assert got[0, 1, 0] == 2.0 and got[0, 2, 0] == 0.0


def test_forward_tie_keeps_lowest_threshold():
    # NaN-missing feature (last bin is NaN). Its rows and bin 3's pull the
    # opposite way of bin 0, so forward (NaN goes right) beats REVERSE (NaN
    # goes left) and threshold 3 loses; bins 1 and 2 are empty, so forward
    # thresholds 0, 1, 2 tie exactly and forward keeps threshold 0
    got, ref = _tie_case(2, [4.0, 0.0, 0.0, -1.0, -6.0],
                         [2.0, 0.0, 0.0, 1.0, 2.0])
    np.testing.assert_array_equal(got, ref)
    assert got[0, 2, 0] == 1.0 and got[0, 1, 0] == 0.0


def test_wrapper_takes_plain_version_on_cpu():
    cfg, ds, grad, hess = _dataset(False, seed=5)
    _, pl = _layouts(cfg, ds)
    hists, sums = _children(ds, grad, hess, 5)
    gb = torch.as_tensor(np.ascontiguousarray(
        hists[:, :, 0][:, pl.gidx.numpy()]))
    hb = torch.as_tensor(np.ascontiguousarray(
        hists[:, :, 1][:, pl.gidx.numpy()]))
    scal = torch.as_tensor(pair_scalars(
        [s[0] for s in sums], [s[1] for s in sums], [s[2] for s in sums],
        **PARAMS))
    args = (scal, gb, hb, pl.keep_r, pl.keep_f, pl.valid_r, pl.valid_f,
            pl.aux)
    before = scan_pair.launches
    got = scan_pair(*args)
    assert scan_pair.launches == before        # no kernel launch on the CPU
    np.testing.assert_array_equal(got.numpy(), scan_pair_plain(*args).numpy())


def test_pair_scalars_is_the_jax_scalar_block():
    """[sg, sh + 2e-15, cnt, cnt / sh, min_data, min_hess, min_gain_shift,
    l2] in f32, as ops/grow.py:_build_scal with the 2e-15 of :605-608."""
    s = pair_scalars([np.float32(3.5), np.float32(-1.25)],
                     [np.float32(10.0), np.float32(0.0)], [40, 0],
                     lambda_l2=1.5, min_gain_to_split=0.25,
                     min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    f = np.float32
    sh = f(10.0) + f(2e-15)
    np.testing.assert_array_equal(s[0], np.array(
        [3.5, sh, 40, f(40) / sh, 20, f(1e-3),
         f(3.5) * f(3.5) / (sh + f(1.5)) + f(0.25), 1.5], f))
    assert np.isfinite(s[1]).all() and s.dtype == np.float32


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    cfg, ds, grad, hess = _dataset(False, seed=6)
    _, pl = _layouts(cfg, ds)
    hists, sums = _children(ds, grad, hess, 6)
    gidx = pl.gidx.numpy()
    scal = pair_scalars([s[0] for s in sums], [s[1] for s in sums],
                        [s[2] for s in sums], **PARAMS)
    cpu = [torch.as_tensor(a) for a in (
        scal, np.ascontiguousarray(hists[:, :, 0][:, gidx]),
        np.ascontiguousarray(hists[:, :, 1][:, gidx]))] + [
        pl.keep_r, pl.keep_f, pl.valid_r, pl.valid_f, pl.aux]
    ref = scan_pair_plain(*cpu).numpy()
    got = scan_pair(*[a.cuda() for a in cpu]).cpu().numpy()
    _assert_match(ref, got, ds.num_features)
