"""DART and RF's kernel forms and training on the card, against the CPU.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_dart_rf_cuda.py

  * ``valid_walk_payload`` (DART's drop and normalize on the payload)
    against its plain version, bit for bit: trees with numerical and
    categorical nodes, negative and -0.0 leaf values, a tree of one leaf,
    the lanes past n untouched, a node table past shared memory;
  * ``bag_apply`` in the rows mode (RF's host bag) against its plain
    version: the grad and hess rows (-0.0 where a negative value meets 0),
    the in-bag count, the device counter ``bag_rows``;
  * ``apply_scores_avg`` (RF's running average) against its plain
    version: a -0.0 leaf with and without a bias, a tree of one leaf
    (nothing), the device counter ``apply_scores_avg``;
  * DART and RF training on the card against the CPU, model text equal,
    on both growers (the persistent grower's later iterations replay its
    graph: DART's walks between them, RF's mask and scalars written before
    them), and DART on EFB-bundled data.

Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_airline_like, make_expo_like
from lightgbm_torch.models.tree import Tree
from lightgbm_torch.ops import bag, counters
from lightgbm_torch.ops import grow_step as gs
from lightgbm_torch.ops.valid_walk import (pack, valid_walk_payload,
                                           valid_walk_payload_plain)
from test_torch_objectives_cuda import BASE, _card, class_data

pytestmark = pytest.mark.cuda

N = 200_003


def _trees(X, y, params, rounds=3):
    p = dict(BASE, device_type="cpu", tpu_persist_scan="false", **params)
    bst = lp.train(p, lp.Dataset(X, y, params=p), rounds)
    return bst._booster


@pytest.mark.parametrize("shape", ["higgs", "airline", "wide"])
def test_payload_walk_matches_plain(shape):
    _card()
    if shape == "airline":
        X, y = make_airline_like(20_000, seed=3)
        b = _trees(X, y, {"objective": "binary", "num_leaves": 31,
                          "categorical_feature": "0,1,2,3,4,5"})
        assert sum(t.num_cat for t in b.models)
    else:
        X, y = class_data(20_000, 4, 2)
        # 1500 leaves: 15 K of records past the 48 K shared memory bound
        b = _trees(X, y, {"objective": "binary", "num_leaves": 31
                          if shape == "higgs" else 1500,
                          "min_data_in_leaf": 2},
                   3 if shape == "higgs" else 1)
    inner = b.train_data
    trees = b.models + [Tree(1)]
    for t in trees:
        t.shrink(-1.0 / 3.0)
    trees[0].leaf_value[0] = -0.0
    n = inner.num_data
    rng = np.random.default_rng(1)
    pad = 777
    rid = np.zeros(n + pad, np.int32)
    rid[:n] = rng.permutation(n)
    sc = rng.normal(size=n + pad).astype(np.float32)
    out = {}
    for dev in ("cuda", "cpu"):
        bins = inner.to_device(dev).bins
        r = torch.as_tensor(rid, device=dev)
        s = torch.as_tensor(sc, device=dev).clone()
        packed = pack(trees, [t.leaf_value[:t.num_leaves] for t in trees],
                      inner, dev)
        for pt in packed:
            (valid_walk_payload if dev == "cuda" else
             valid_walk_payload_plain)(bins, r, pt.nodes, pt.leaves, s, n,
                                       pt.words)
        out[dev] = s.cpu().numpy()
    np.testing.assert_array_equal(out["cuda"].view(np.uint32),
                                  out["cpu"].view(np.uint32))
    np.testing.assert_array_equal(out["cuda"][n:], sc[n:])
    assert not np.array_equal(out["cuda"][:n], sc[:n])


def _rows(seed, n=N, pad=1000):
    rng = np.random.default_rng(seed)
    pay = np.zeros((4, n + pad), np.int32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    g[:4] = [-0.0, 0.0, -1.5, 2.0]
    pay[1, :n] = rng.permutation(n).astype(np.int32)
    pay[2, :n] = g.view(np.int32)
    pay[3, :n] = h.view(np.int32)
    mask = rng.random(n) < 0.7
    mask[pay[1, :3]] = False
    return pay, mask


def test_rows_bag_matches_plain():
    _card()
    pay, mask = _rows(3)
    out = {}
    counters.reset("cuda")
    for dev in ("cuda", "cuda", "cpu"):
        p = torch.as_tensor(pay, device=dev).clone()
        st = bag.BagState(dev)
        st.set(bag.rows_iteration(0, mask))
        g, h = p[2].view(torch.float32), p[3].view(torch.float32)
        bag.bag_apply(p[1], p[0].view(torch.float32), g, h, N,
                      bag.MODE_ROWS, st)
        got = (p.cpu().numpy(), int(st.count[0]))
        if dev in out:
            np.testing.assert_array_equal(got[0], out[dev][0])
            assert got[1] == out[dev][1]
        out[dev] = got
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][1] == out["cpu"][1] == int(mask.sum())
    g = out["cuda"][0][2].view(np.float32)
    assert g[2] == 0.0 and np.signbit(g[2])
    np.testing.assert_array_equal(out["cuda"][0][:, N:], 0)
    got = counters.read("cuda")
    assert got["bag_rows"] == 2 and got["bag_apply"] == 0


@pytest.mark.parametrize("s_leaves,t,bias", [(7, 3.0, -0.3708601),
                                              (7, 5.0, 0.0), (7, 0.0, 0.25),
                                              (1, 3.0, 0.5)])
def test_average_matches_plain(s_leaves, t, bias):
    _card()
    L, n = 7, N
    rng = np.random.default_rng(int(t))
    cuts = np.sort(rng.choice(np.arange(1, n), L - 1, replace=False))
    starts = np.concatenate([[0], cuts])
    nrows = np.concatenate([cuts, [n]]) - starts
    vals = rng.normal(size=L).astype(np.float32)
    vals[2] = -0.0
    sc = rng.normal(size=n + 100).astype(np.float32)
    sc[starts[2]:starts[2] + 5] = 0.0
    out = {}
    counters.reset("cuda")
    for dev in ("cuda", "cpu"):
        S = gs.GrowState(L, dev)
        S.li[:, gs.LI_START] = torch.as_tensor(starts, device=dev)
        S.li[:, gs.LI_NROWS] = torch.as_tensor(nrows, device=dev)
        S.lf[:, gs.LF_VALUE] = torch.as_tensor(vals, device=dev)
        S.st[gs.ST_S] = s_leaves
        s = torch.as_tensor(sc, device=dev).clone()
        gs.set_avg(S, t, bias)
        gs.apply_scores_avg(S, s[:n])
        out[dev] = s.cpu().numpy()
    np.testing.assert_array_equal(out["cuda"].view(np.uint32),
                                  out["cpu"].view(np.uint32))
    np.testing.assert_array_equal(out["cuda"][n:], sc[n:])
    launched = counters.read("cuda")["apply_scores_avg"]
    if s_leaves == 1:
        np.testing.assert_array_equal(out["cuda"], sc)
        assert launched == 0
    else:
        assert launched == 1


DART = {"boosting": "dart", "drop_rate": 0.3}
RF = {"boosting": "rf", "bagging_fraction": 0.7, "bagging_freq": 1}


@pytest.mark.parametrize("route,extra", [
    ("force", DART), ("false", DART), ("force", RF), ("false", RF),
    ("false", dict(RF, objective="multiclass", num_class=3)),
    ("false", dict(DART, objective="multiclass", num_class=3))],
    ids=["persist-dart", "v1-dart", "persist-rf", "v1-rf",
         "v1-rf-multiclass", "v1-dart-multiclass"])
def test_training_matches_cpu(route, extra):
    _card()
    K = extra.get("num_class", 2)
    X, y = class_data(30_000, 6, K)
    text, scores = {}, {}
    for dev in ("cuda", "cpu"):
        p = dict(dict(BASE, objective="binary"), num_leaves=31,
                 tpu_persist_scan=route, device_type=dev, **extra)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 8)
        text[dev] = bst.model_to_string().split("parameters:")[0]
        scores[dev] = bst._booster.train_score.score.cpu().numpy()
        if dev == "cuda" and route == "force":
            assert bst._booster.tree_learner._persist_gr.replays == 6
    assert text["cuda"] == text["cpu"]
    np.testing.assert_array_equal(scores["cuda"], scores["cpu"])


def test_dart_bundled_matches_cpu():
    _card()
    X, y = make_expo_like(30_000, seed=2)
    text = {}
    for dev in ("cuda", "cpu"):
        p = dict(BASE, objective="binary", num_leaves=31,
                 tpu_persist_scan="force", device_type=dev, **DART)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 8)
        assert bst._booster.tree_learner._persist_gr.blocks is not None
        text[dev] = bst.model_to_string().split("parameters:")[0]
    assert text["cuda"] == text["cpu"]
