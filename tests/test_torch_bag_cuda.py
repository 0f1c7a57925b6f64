"""The bag step's kernels and bagged training on the card, against the CPU.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_bag_cuda.py

  * ``bag_apply`` against its plain version, bit for bit, in the fraction,
    balanced and GOSS modes and GOSS below its skip count: the grad and
    hess rows (-0.0 where a negative gradient is zeroed), the lanes past n
    untouched, the in-bag count, two launches equal, the device counter;
  * ``goss_select`` against its plain version (``torch.kthvalue`` on the
    bit patterns) on |g * h| with many ties, at ranks 1, a middle one, n
    and past n, and below the skip count (keep flag, no count);
  * training on the card against the CPU, model text equal: bagging,
    balanced bagging and GOSS on the persistent grower (``force``, 8
    iterations: the later ones replay the captured graph with new window
    keys in device scalars), bagging and GOSS on the v1 grower, and GOSS
    with 3 classes on v1.

Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.ops import bag, counters
from test_torch_objectives_cuda import BASE, _card, class_data

pytestmark = pytest.mark.cuda

N = 200_003


def _rows(seed, n=N, pad=1000, ties=False):
    """[4, n + pad] int32: label (f32 0/1), a permutation of the row ids,
    f32 grad and hess; zeros past n."""
    rng = np.random.default_rng(seed)
    pay = np.zeros((4, n + pad), np.int32)
    lab = (rng.random(n) < 0.3).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    if ties:
        g = (np.round(g * 4) / 4).astype(np.float32)
        h = (np.round(h * 16) / 16).astype(np.float32)
    g[:4] = [-0.0, 0.0, -1.5, 2.0]
    pay[0, :n] = lab.view(np.int32)
    pay[1, :n] = rng.permutation(n).astype(np.int32)
    pay[2, :n] = g.view(np.int32)
    pay[3, :n] = h.view(np.int32)
    return pay


def _step(pay, b: bag.BagIteration, dev, n=N):
    p = torch.as_tensor(pay, device=dev).clone()
    st = bag.BagState(dev)
    st.set(b)
    g, h = p[2].view(torch.float32), p[3].view(torch.float32)
    if b.mode == bag.MODE_GOSS:
        bag.goss_select(g, h, n, st)
    bag.bag_apply(p[1], p[0].view(torch.float32), g, h, n, b.mode, st)
    return p.cpu().numpy(), int(st.count[0]), st.sel[:2].cpu().numpy()


CASES = {
    "fraction": (("bagging", 0.8, 1.0, 1.0), 7, 0),
    "balanced": (("bagging", 1.0, 0.9, 0.25), 3, 0),
    "goss": (("goss", 0.2, 0.1), 4, 2),
    "goss skip": (("goss", 0.2, 0.1), 1, 2),
}


@pytest.mark.parametrize("ties", [False, True], ids=["spread", "ties"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_bag_apply_matches_plain(name, ties):
    _card()
    spec, it, skip = CASES[name]
    pay = _rows(len(name) + ties, ties=ties)
    b = bag.bag_iteration(spec, 17, 5, it, N, skip)
    counters.reset("cuda")
    a1, c1, s1 = _step(pay, b, "cuda")
    a2, c2, s2 = _step(pay, b, "cuda")
    p, cp, sp = _step(pay, b, "cpu")
    np.testing.assert_array_equal(a1, p)
    np.testing.assert_array_equal(a2, p)
    np.testing.assert_array_equal(s1, sp)
    assert c1 == c2 == cp
    np.testing.assert_array_equal(p[:, N:], 0)
    got = counters.read("cuda")
    assert got["bag_apply"] == 2
    assert got["goss_select"] == (2 if spec[0] == "goss" and it >= skip
                                  else 0)
    if name == "goss skip":
        assert cp == N
        np.testing.assert_array_equal(p, pay)
    else:
        assert 0 < cp < N
        g_in = pay[2, :N].view(np.float32)
        g_out = p[2, :N].view(np.float32)
        assert np.any((g_out == 0) & np.signbit(g_out) & (g_in < 0))


@pytest.mark.parametrize("k", [1, 2, 40_000, N - 1, N, N + 5])
def test_goss_select_matches_plain(k):
    _card()
    pay = _rows(k % 97, ties=True)
    out = {}
    for dev in ("cuda", "cpu"):
        p = torch.as_tensor(pay, device=dev)
        st = bag.BagState(dev)
        st.set(bag.BagIteration(bag.MODE_GOSS, (0, 0), 3, 2, k, 1, 1, 1,
                                1, 1))
        bag.goss_select(p[2].view(torch.float32), p[3].view(torch.float32),
                        N, st)
        out[dev] = st.sel[:2].cpu().numpy()
    np.testing.assert_array_equal(out["cuda"], out["cpu"])
    s = np.abs(pay[2, :N].view(np.float32) * pay[3, :N].view(np.float32))
    thr = np.array([out["cpu"][0]], np.int64).astype(np.uint32) \
        .view(np.float32)[0]
    if k <= N:
        assert np.sum(s >= thr) >= k > np.sum(s > thr)
    else:
        assert thr == 0


def test_goss_select_skip():
    _card()
    pay = _rows(5)
    p = torch.as_tensor(pay, device="cuda")
    st = bag.BagState("cuda")
    st.set(bag.BagIteration(bag.MODE_GOSS, (0, 0), 1, 2, 10, 1, 1, 1, 1, 1))
    counters.reset("cuda")
    bag.goss_select(p[2].view(torch.float32), p[3].view(torch.float32), N,
                    st)
    assert st.sel[bag.SEL_KEEP].item() == 1
    assert counters.read("cuda")["goss_select"] == 0


GOSS = {"boosting": "goss", "learning_rate": 0.5, "top_rate": 0.2,
        "other_rate": 0.1}


@pytest.mark.parametrize("route,extra", [
    ("force", {"bagging_fraction": 0.7, "bagging_freq": 3}),
    ("force", {"pos_bagging_fraction": 0.8, "neg_bagging_fraction": 0.4,
               "bagging_freq": 2}),
    ("force", GOSS),
    ("false", {"bagging_fraction": 0.7, "bagging_freq": 3}),
    ("false", GOSS),
    ("false", dict(GOSS, objective="multiclass", num_class=3)),
], ids=["persist-bagging", "persist-balanced", "persist-goss", "v1-bagging",
        "v1-goss", "v1-goss-multiclass"])
def test_bagged_training_matches_cpu(route, extra):
    _card()
    K = extra.get("num_class", 2)
    X, y = class_data(30_000, 5, K)
    text, counts = {}, {}
    for dev in ("cuda", "cpu"):
        p = dict(dict(BASE, objective="binary"), num_leaves=31,
                 tpu_persist_scan=route, device_type=dev, **extra)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 8)
        text[dev] = bst.model_to_string().split("parameters:")[0]
        counts[dev] = [t.internal_count[0] for t in bst._booster.models]
        if dev == "cuda" and route == "force":
            assert bst._booster.tree_learner._persist_gr.replays == 6
    assert counts["cuda"] == counts["cpu"]
    assert text["cuda"] == text["cpu"]
