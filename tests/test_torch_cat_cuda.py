"""The categorical kernels on the card, against their plain versions.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_cat_cuda.py

Without a card each test skips. ``cat_scan`` (csrc/cat_scan.cu) is held bit
for bit against ``cat_scan_plain`` on the CPU over B in {1, 2, 256} nodes,
layouts as wide as W in {3, 32, 255} bins, both routes (one-hot and the
sorted scan), the knob arguments (lambda_l1, max_delta_step, monotone
bounds, cat_smooth, cat_l2, min_data_per_group, max_cat_threshold), a
feature mask, empty bins, -0.0 gradients and equal ratios (the sort's
ties). The categorical ``valid_walk`` is held bit for bit against
``walk_leaves_plain`` on trees whose nodes mix numerical and categorical
decisions, packed several to one buffer.
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import counters
from lightgbm_torch.ops.cat_scan import (CatLayout, cat_params, cat_scalars,
                                         cat_scan)
from lightgbm_torch.ops.split import SplitParams
from lightgbm_torch.ops.valid_walk import pack, valid_walk, valid_walk_plain

pytestmark = pytest.mark.cuda

F32 = np.float32


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def cat_case(B, W, seed, onehot=False, knobs=False, R=None):
    """Inputs of one cat_scan call: C = 4 categorical features (the first
    W bins wide, the others narrower, missing types None and NaN) and one
    numerical feature on [R, TB] f32 planes, B node rows, node scalars,
    a feature mask and the parameter block; every feature one-hot
    (`onehot`), every one sorted, or with `knobs` both routes and the
    knob arguments. Returns (args, layout) with args on the CPU."""
    rng = np.random.default_rng(seed)
    nb = [W, max(2, W // 2), max(2, min(W, 7)), max(2, W - 1), 16]
    start = np.concatenate([[0], np.cumsum(nb)[:-1]]).astype(np.int32)
    end = start + np.asarray(nb, np.int32)
    TB = int(end[-1])
    is_cat = np.array([True] * 4 + [False])
    mt = np.array([0, 2, 0, 2, 0], np.int32)
    R = R or max(B + 3, 8)
    n_rows = rng.integers(200, 20000, R)
    hh = (rng.uniform(0.01, 0.3, (R, TB)) * n_rows[:, None] / TB
          ).astype(F32)
    gh = (rng.normal(size=(R, TB)) * np.sqrt(hh)).astype(F32)
    empty = rng.random((R, TB)) < 0.15
    hh[empty], gh[empty] = 0.0, 0.0
    gh[rng.random((R, TB)) < 0.03] = -0.0
    # equal ratios: copies of one bin's (grad, hess) into others
    for r in range(R):
        src = int(rng.integers(0, TB))
        for d in rng.integers(0, TB, 4):
            gh[r, d], hh[r, d] = gh[r, src], hh[r, src]
    rows = rng.permutation(R)[:B]
    # a node's sums: every feature's bins hold its rows once
    sg = (gh[rows].astype(np.float64).sum(1) / 5).astype(F32)
    sh = (hh[rows].astype(np.float64).sum(1) / 5).astype(F32) + F32(2e-15)
    cf_true = rng.uniform(50, 150, B)
    nd = np.maximum(np.floor(sh * cf_true), 1).astype(np.int64)
    params = SplitParams(lambda_l2=1.0 if knobs else 0.0,
                         min_gain_to_split=0.0,
                         min_data_in_leaf=int(rng.integers(1, 40)),
                         min_sum_hessian_in_leaf=1e-3,
                         lambda_l1=0.5 if knobs else 0.0,
                         max_delta_step=0.3 if knobs else 0.0)
    if knobs:
        cmin = -rng.uniform(0.01, 0.3, B).astype(F32)
        cmax = rng.uniform(0.01, 0.3, B).astype(F32)
    else:
        cmin, cmax = np.full(B, -np.inf, F32), np.full(B, np.inf, F32)
    cat_cfg = {"cat_l2": 3.0 if knobs else 10.0,
               "cat_smooth": 2.0 if knobs else 10.0,
               "min_data_per_group": 5 if knobs else 100,
               "max_cat_threshold": 6 if knobs else 32,
               "max_cat_to_onehot": 256 if onehot else (4 if knobs else 1)}
    layout = CatLayout(is_cat, start, end, mt, np.ones(5), TB, "cpu")
    scal = cat_scalars(sg, sh, nd, params, cmin, cmax)
    fmask = (rng.random((B, 4)) < 0.9).astype(F32)
    args = (torch.as_tensor(scal), torch.as_tensor(gh), torch.as_tensor(hh),
            torch.as_tensor(rows), torch.as_tensor(fmask),
            cat_params(params, cat_cfg, knobs))
    return args, dict(is_cat=is_cat, start=start, end=end, mt=mt, TB=TB)


def run_both(args, lay, dev):
    """(card output, plain output) of one call."""
    scal, gh, hh, rows, fmask, par = args
    lc = CatLayout(lay["is_cat"], lay["start"], lay["end"], lay["mt"],
                   np.ones(5), lay["TB"], "cpu")
    ld = CatLayout(lay["is_cat"], lay["start"], lay["end"], lay["mt"],
                   np.ones(5), lay["TB"], dev)
    ref = cat_scan(scal, gh, hh, rows, lc, fmask, par)
    got = cat_scan(*(t.to(dev) for t in (scal, gh, hh, rows)), ld,
                   fmask.to(dev), par.to(dev))
    return got.cpu(), ref


@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("W", [3, 32, 255])
@pytest.mark.parametrize("route", ["sorted", "onehot", "knobs"])
def test_cat_scan_matches_plain(B, W, route):
    dev = _card()
    args, lay = cat_case(B, W, seed=B * 1000 + W, onehot=route == "onehot",
                         knobs=route == "knobs")
    before = cat_scan.launches
    counters.reset(dev)
    got, ref = run_both(args, lay, dev)
    assert cat_scan.launches == before + 1
    assert counters.read(dev)["cat_scan"] == 1
    assert torch.equal(got.view(torch.int32), ref.view(torch.int32))
    # not vacuous: some (node, feature) splits
    assert bool(torch.isfinite(ref[..., 0]).any())


def test_cat_scan_two_launches_agree():
    dev = _card()
    args, lay = cat_case(256, 255, seed=7)
    a, _ = run_both(args, lay, dev)
    b, _ = run_both(args, lay, dev)
    assert torch.equal(a.view(torch.int32), b.view(torch.int32))


# ---- the categorical binned walk --------------------------------------------

def cat_tree_case(seed, L=63, n=40_001):
    """A random tree over a bundled layout with about half its nodes
    categorical (random inner bin sets, some wider than 32 bins), and rows
    binned for it. Returns (tree, layout, bins)."""
    from test_torch_valid_cuda import Layout, random_tree
    rng = np.random.default_rng(seed)
    layout = Layout(rng.integers(2, 120, 8), 3, rng)
    tree = random_tree(L, layout, rng)
    for k in range(L - 1):
        if rng.random() < 0.5:
            f = int(tree.split_feature_inner[k])
            nb = int(layout.nbins[f])
            bins = np.nonzero(rng.random(nb) < 0.4)[0]
            tree._add_cat(k, bins, bins)
    return tree, layout, layout.rows(n, rng, skew=seed % 2 == 1)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cat_valid_walk_matches_plain(seed):
    dev = _card()
    tree, layout, bins = cat_tree_case(seed)
    assert tree.num_cat > 0
    L = tree.num_leaves
    base = np.random.default_rng(seed).normal(size=bins.shape[0])
    (pc,) = pack([tree], [tree.leaf_value[:L]], layout, "cpu")
    (pd,) = pack([tree], [tree.leaf_value[:L]], layout, dev)
    ref = torch.as_tensor(base.copy())
    valid_walk_plain(torch.as_tensor(bins), pc.nodes, pc.leaves, ref,
                     pc.words)
    s = torch.as_tensor(base, device=dev)
    valid_walk(torch.as_tensor(bins, device=dev), pd.nodes, pd.leaves, s,
               pd.words)
    assert torch.equal(s.cpu(), ref)
    assert len(np.unique((ref - torch.as_tensor(base)).numpy())) > 1


def test_cat_valid_walk_packs_many_trees():
    from test_torch_valid_cuda import random_tree
    dev = _card()
    _, layout, bins = cat_tree_case(3)
    rng = np.random.default_rng(9)
    trees = []
    for L in (7, 31, 2, 63):
        t = random_tree(L, layout, rng)
        for k in range(L - 1):
            if rng.random() < 0.6:
                nb = int(layout.nbins[int(t.split_feature_inner[k])])
                t._add_cat(k, [], np.nonzero(rng.random(nb) < 0.5)[0])
        trees.append(t)
    lvs = [t.leaf_value[:t.num_leaves] for t in trees]
    ref = torch.zeros((len(trees), bins.shape[0]), dtype=torch.float64)
    got = torch.zeros_like(ref, device=dev)
    for k, (pc, pd) in enumerate(zip(pack(trees, lvs, layout, "cpu"),
                                     pack(trees, lvs, layout, dev))):
        valid_walk_plain(torch.as_tensor(bins), pc.nodes, pc.leaves, ref[k],
                         pc.words)
        valid_walk(torch.as_tensor(bins, device=dev), pd.nodes, pd.leaves,
                   got[k], pd.words)
    assert torch.equal(got.cpu(), ref)
