"""Refit's per-leaf sums and the rollback of the payload's scores on the
card, against the CPU.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_refit_cuda.py

  * the ``leaf_sums`` kernel against its plain version on the CPU, bit for
    bit, on inputs made with numpy: random leaves with empty ones, one leaf
    holding every row (past the kernel's 1024-lane chunk), a tree of 255
    leaves over 300k rows, -0.0 gradients; the device counter (one per
    launch) and the Python counter;
  * refit on the card against the CPU: the refitted model text equal
    (binary and softmax with 3 classes);
  * rollback on the persistent grower (``force``) on the card: the model
    text equal to the shorter run's and the payload's f32 scores equal to
    the CPU's rolled-back scores bit for bit; then a split key reset
    (num_leaves, lambda_l2) and one more iteration, model text equal to
    the CPU's.

Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.ops import counters
from lightgbm_torch.ops.refit import leaf_segments, leaf_sums
from test_torch_objectives_cuda import BASE, _card, class_data

pytestmark = pytest.mark.cuda

CASES = {"random with empty leaves": (20_000, 63), "one leaf": (5000, 1),
         "every row in one of many": (3000, 9), "255 leaves": (300_000, 255)}


def _inputs(case):
    n, L = CASES[case]
    rng = np.random.default_rng(n + L)
    if case == "every row in one of many":
        leaf = np.full(n, 5, np.int32)
    else:
        leaf = rng.integers(0, L, n).astype(np.int32)
        if L > 4:
            leaf[(leaf == 2) | (leaf == L - 1)] = 0     # two empty leaves
    g = rng.normal(size=n).astype(np.float32)
    g[::11] = -0.0
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    return torch.as_tensor(leaf), torch.as_tensor(g), torch.as_tensor(h), L


@pytest.mark.parametrize("case", sorted(CASES))
def test_leaf_sums_matches_plain(case):
    _card()
    leaf, g, h, L = _inputs(case)
    out = {}
    for dev in ("cuda", "cpu"):
        order, seg = leaf_segments(leaf.to(dev), L)
        o = torch.full((L, 3), 7.5, dtype=torch.float64, device=dev)
        counters.reset(dev)
        launches = leaf_sums.launches
        leaf_sums(order, g.to(dev), h.to(dev), seg, o)
        assert counters.read(dev)["leaf_sums"] == 1
        if dev == "cuda":
            assert leaf_sums.launches == launches + 1
        out[dev] = o.cpu()
    assert torch.equal(out["cuda"], out["cpu"])
    counts = out["cpu"][:, 2].numpy()
    assert counts.sum() == len(leaf) and (L < 5 or (counts == 0).sum() >= 2)


def _booster(dev, X, y, params, rounds):
    p = dict(params, device_type=dev)
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    for _ in range(rounds):
        bst.update()
    return bst


def _text(bst):
    return bst.model_to_string().split("parameters:")[0]


@pytest.mark.parametrize("K", [1, 3])
def test_refit_card_equals_cpu(K):
    _card()
    X, y = class_data(20_000, 41, K=max(K, 2))
    obj = {"objective": "binary"} if K == 1 else \
        {"objective": "multiclass", "num_class": 3}
    params = dict(BASE, num_leaves=31, tpu_persist_scan="false", **obj)
    src = _booster("cpu", X[:15_000], y[:15_000], params, 4)
    text = {}
    for dev in ("cuda", "cpu"):
        b = lp.Booster(params=dict(params, device_type=dev),
                       model_str=src.model_to_string())
        text[dev] = _text(b.refit(X[15_000:], y[15_000:], decay_rate=0.5))
    assert text["cuda"] == text["cpu"] != _text(src)


def test_rollback_and_reset_on_the_payload_card_equals_cpu():
    _card()
    X, y = class_data(20_000, 42, K=2)
    params = dict(BASE, num_leaves=31, tpu_persist_scan="force",
                  objective="binary")
    boosters, scores = {}, {}
    for dev in ("cuda", "cpu"):
        b = _booster(dev, X, y, params, 5)
        b.rollback_one_iter()
        scores[dev] = b._booster.train_score.score.cpu().numpy()
        boosters[dev] = b
    assert _text(boosters["cuda"]) == _text(boosters["cpu"]) == \
        _text(_booster("cpu", X, y, params, 4))
    assert np.array_equal(scores["cuda"], scores["cpu"])
    for dev, b in boosters.items():
        b.reset_parameter({"num_leaves": 15, "lambda_l2": 1.0})
        b.update()
        assert b._booster.use_persist
        assert b._booster.models[-1].num_leaves <= 15
    assert _text(boosters["cuda"]) == _text(boosters["cpu"])
