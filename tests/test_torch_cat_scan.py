"""The categorical split scan's plain version against the JAX package.

``lightgbm_torch.ops.cat_scan`` (cat_scan on the CPU = cat_scan_plain)
against ``lightgbm_tpu.ops.split.find_best_split_categorical(...,
use_dp=False)``, the JAX package's f32 arithmetic off the CPU, on the same
f32 histograms of seeded rows: both routes (one-hot and the sorted
many-vs-many scan), min_data_per_group, cat_smooth, max_cat_threshold,
lambda_l1, max_delta_step, monotone bounds (use_mc), a feature mask, a NaN
bin and features narrower than the layout. The chosen feature, the left
bins and the counts must be equal. The gain, the sums and the outputs must
agree within RTOL = 1e-6 (about 8 f32 ulps): the port evaluates each f32
operation in turn (the CUDA kernel's arithmetic), the jitted JAX function
lets XLA fuse them, and the two differ by an ulp on about a third of these
nodes' gains.
"""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.ops.split import FeatureMeta as JMeta
from lightgbm_tpu.ops.split import SplitParams as JParams
from lightgbm_tpu.ops.split import find_best_split_categorical
from lightgbm_tpu.treelearner.serial import build_cat_layout
from lightgbm_torch.ops.cat_scan import (CatLayout, cat_candidates,
                                         cat_params, cat_scalars, cat_scan)
from lightgbm_torch.ops.split import SplitParams
from lightgbm_torch.models.tree import words_to_bins

F32 = np.float32
RTOL = 1e-6


def layout_and_hist(seed, nbins=(3, 12, 40, 7), B=3, n=4000, nan_feature=2):
    """Features with `nbins` bins each (categorical; missing type NaN for
    `nan_feature`, none for the others) plus one numerical feature, and
    the [B, TB] f32 grad/hess histograms of B nodes' seeded rows with
    Zipf-like bin frequencies and per-bin effects."""
    rng = np.random.default_rng(seed)
    nb = list(nbins) + [16]
    start = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int32)
    end = (start + np.asarray(nb)).astype(np.int32)
    F, TB = len(nb), int(end[-1])
    is_cat = np.array([True] * len(nbins) + [False])
    mt = np.zeros(F, np.int32)
    mt[nan_feature] = 2
    gh = np.zeros((B, TB), F32)
    hh = np.zeros((B, TB), F32)
    sums = []
    for b in range(B):
        m = int(n * (1 + b) / B)
        g = rng.normal(size=m).astype(F32)
        h = rng.uniform(0.05, 0.25, size=m).astype(F32)
        for f in range(F):
            p = 1.0 / np.arange(1, nb[f] + 1) ** 1.1
            bins = rng.choice(nb[f], size=m, p=p / p.sum())
            eff = rng.normal(size=nb[f]).astype(F32)
            gf = (g + 0.3 * eff[bins]).astype(F32) if f == 1 else g
            np.add.at(gh[b], start[f] + bins, gf)
            np.add.at(hh[b], start[f] + bins, h)
        sums.append((F32(g.astype(np.float64).sum()),
                     F32(h.astype(np.float64).sum()), m))
    return dict(start=start, end=end, is_cat=is_cat, mt=mt, TB=TB,
                gh=gh, hh=hh, sums=sums, F=F)


def jax_candidates(lay, cfg, node_masks, cmins, cmaxs, use_mc):
    """find_best_split_categorical (f32) per node."""
    F = lay["F"]
    ds = types.SimpleNamespace(
        is_categorical=lay["is_cat"], bin_start=lay["start"],
        bin_end=lay["end"], total_bins=lay["TB"],
        missing_type_arr=lay["mt"])
    W = int((lay["end"] - lay["start"])[lay["is_cat"]].max())
    cat = build_cat_layout(ds, W)
    feat_id = np.repeat(np.arange(F), lay["end"] - lay["start"])
    meta = JMeta(feat_id=jnp.asarray(feat_id, jnp.int32),
                 bin_start=jnp.asarray(lay["start"]),
                 bin_end=jnp.asarray(lay["end"]),
                 missing_type=jnp.asarray(lay["mt"]),
                 default_bin=jnp.zeros(F, jnp.int32),
                 monotone=jnp.zeros(F, jnp.int32),
                 is_categorical=jnp.asarray(lay["is_cat"]),
                 penalty=jnp.asarray(cfg.get("penalty", np.ones(F))))
    p = JParams.from_config(JConfig(dict(cfg["params"])))
    out = []
    for b, (sg, sh, m) in enumerate(lay["sums"]):
        hist = np.stack([lay["gh"][b], lay["hh"][b]], axis=1)
        c = find_best_split_categorical(
            jnp.asarray(hist), jnp.asarray(sg), jnp.asarray(sh),
            jnp.asarray(m, jnp.int32), cat, meta, p, jnp.asarray(cmins[b]),
            jnp.asarray(cmaxs[b]), jnp.asarray(node_masks[b]),
            use_mc=use_mc, use_dp=False)
        out.append({k: np.asarray(v) for k, v in c._asdict().items()})
    return out


def port_candidates(lay, cfg, node_masks, cmins, cmaxs, use_mc):
    conf = dict(cfg["params"])
    params = SplitParams(
        lambda_l2=conf.get("lambda_l2", 0.0),
        min_gain_to_split=conf.get("min_gain_to_split", 0.0),
        min_data_in_leaf=conf.get("min_data_in_leaf", 20),
        min_sum_hessian_in_leaf=conf.get("min_sum_hessian_in_leaf", 1e-3),
        lambda_l1=conf.get("lambda_l1", 0.0),
        max_delta_step=conf.get("max_delta_step", 0.0))
    cat_cfg = {k: conf.get(k, d) for k, d in (
        ("cat_l2", 10.0), ("cat_smooth", 10.0), ("min_data_per_group", 100),
        ("max_cat_threshold", 32), ("max_cat_to_onehot", 4))}
    F = lay["F"]
    layout = CatLayout(lay["is_cat"], lay["start"], lay["end"], lay["mt"],
                       cfg.get("penalty", np.ones(F)), lay["TB"], "cpu")
    sg = np.array([s[0] for s in lay["sums"]], F32)
    sh = np.array([s[1] for s in lay["sums"]], F32) + F32(2e-15)
    nd = np.array([s[2] for s in lay["sums"]])
    scal = cat_scalars(sg, sh, nd, params, cmins, cmaxs)
    fmask = np.ascontiguousarray(np.asarray(node_masks)[:, layout.feature],
                                 F32)
    B = len(sg)
    rec = cat_scan(torch.as_tensor(scal), torch.as_tensor(lay["gh"]),
                   torch.as_tensor(lay["hh"]), torch.arange(B),
                   layout, torch.as_tensor(fmask),
                   cat_params(params, cat_cfg, use_mc)).numpy()
    return cat_candidates(rec, layout, scal, params, use_mc), layout


CASES = {
    "default": {},
    "onehot": {"max_cat_to_onehot": 64},
    "small_groups": {"min_data_per_group": 5, "cat_smooth": 1.0,
                     "min_data_in_leaf": 5},
    "smooth": {"cat_smooth": 50.0, "cat_l2": 1.0},
    "max_cat": {"max_cat_threshold": 3, "min_data_per_group": 10},
    "l1_mds": {"lambda_l1": 2.0, "max_delta_step": 0.4,
               "min_data_per_group": 20},
    "l2_gain": {"lambda_l2": 3.0, "min_gain_to_split": 0.5,
                "min_sum_hessian_in_leaf": 5.0},
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("mono", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_cat_scan_matches_jax_f32(case, mono, seed):
    lay = layout_and_hist(seed)
    cfg = {"params": dict(CASES[case], verbose=-1)}
    B, F = len(lay["sums"]), lay["F"]
    rng = np.random.default_rng(seed + 10)
    masks = np.ones((B, F), bool)
    masks[1, 1] = False                       # a node that skips feature 1
    if mono:        # each node's monotone bounds (finite, around 0)
        cmins = -rng.uniform(0.01, 0.2, B).astype(F32)
        cmaxs = rng.uniform(0.01, 0.2, B).astype(F32)
    else:
        cmins = np.full(B, -np.inf, F32)
        cmaxs = np.full(B, np.inf, F32)
    jc = jax_candidates(lay, cfg, masks, cmins, cmaxs, mono)
    pc, layout = port_candidates(lay, cfg, masks, cmins, cmaxs, mono)
    for b in range(B):
        j, p = jc[b], pc[b]
        assert int(j["feature"]) == p["feature"], (b, j["gain"], p["gain"])
        if p["feature"] < 0:
            assert not np.isfinite(j["gain"]) and not np.isfinite(p["gain"])
            continue
        np.testing.assert_allclose(p["gain"], j["gain"], rtol=RTOL)
        left = np.nonzero(np.asarray(j["cat_mask"]))[0]
        assert np.array_equal(left, words_to_bins(p["cat_words"]))
        assert int(j["left_count"]) == p["left_count"]
        assert int(j["right_count"]) == p["right_count"]
        for k in ("left_sum_grad", "left_sum_hess", "right_sum_grad",
                  "right_sum_hess", "left_output", "right_output"):
            np.testing.assert_allclose(p[k], j[k], rtol=RTOL, err_msg=k)


def test_cat_scan_finds_splits_on_both_routes():
    """The cases above are not vacuous: the default, one-hot and l1/mds
    cases find a categorical split on most nodes, and the many-vs-many
    route sends several bins left."""
    lay = layout_and_hist(0)
    B, F = len(lay["sums"]), lay["F"]
    masks = np.ones((B, F), bool)
    inf = np.full(B, np.inf, F32)
    n_left = []
    for case in ("default", "onehot", "l1_mds"):
        pc, _ = port_candidates(lay, {"params": CASES[case]}, masks, -inf,
                                inf, False)
        assert sum(c["feature"] >= 0 for c in pc) >= 2, case
        n_left += [len(words_to_bins(c["cat_words"])) for c in pc
                   if c["feature"] >= 0]
    assert max(n_left) > 1 and min(n_left) == 1
