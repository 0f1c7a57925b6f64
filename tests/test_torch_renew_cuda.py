"""Leaf renewal and the new objectives on the card, against the CPU.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_renew_cuda.py

  * the ``renew_leaf`` kernel against its plain version, bit for bit, on
    inputs made with numpy: residuals from a few integers (ties, -0.0
    beside +0.0), f32 weights, segments of 0, 1, 2 and many rows, alphas
    that reach both clamps, f32 and f64 outputs, a device scalar nseg of
    1 (nothing renewed), 3 and more than the segments, and the device
    counter (one per launch that renews);
  * training on the card against the CPU, model text equal: L1 on the
    persistent (``force``) and v1 (``off``) growers, quantile at alpha 0.9
    with sample weights, MAPE, cross_entropy on labels in [0, 1],
    cross_entropy_lambda with weights, and reg_sqrt on the persistent
    grower (4 iterations, 63 leaves, HIGGS-shaped rows as
    tests/test_torch_objectives_cuda.py makes them).

Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.ops import counters
from lightgbm_torch.ops.renew import renew_leaf, renew_segments, segment_order
from test_torch_objectives_cuda import BASE, _card, higgs_latent, _rows

pytestmark = pytest.mark.cuda

SIZES = (0, 1, 2, 3, 7, 40, 0, 1, 2, 513, 4096, 5)


def _inputs(seed, sizes=SIZES):
    rng = np.random.default_rng(seed)
    key = np.repeat(np.arange(len(sizes)), sizes)
    rng.shuffle(key)
    n = len(key)
    res = rng.integers(-4, 5, n).astype(np.float64)
    res[(res == 0) & (rng.random(n) < 0.5)] = -0.0
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    sz = torch.as_tensor(np.asarray(sizes, np.int64))
    seg = torch.stack([torch.cumsum(sz, 0) - sz, sz], 1)
    return torch.as_tensor(res), torch.as_tensor(key), torch.as_tensor(w), \
        seg


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
@pytest.mark.parametrize("alpha", [0.5, 0.1, 0.9, 0.001, 0.999])
def test_renew_leaf_matches_plain(alpha, weighted, dtype):
    _card()
    res, key, w, seg = _inputs(int(alpha * 1000) + weighted)
    out = {}
    for dev in ("cuda", "cpu"):
        o = torch.full((seg.shape[0],), 9.5, dtype=dtype, device=dev)
        renew_segments(res.to(dev), key.to(dev),
                       w.to(dev) if weighted else None, seg.to(dev), o, alpha)
        out[dev] = o.cpu()
    torch.cuda.synchronize()
    assert torch.equal(out["cuda"], out["cpu"])
    assert out["cpu"][0] == 9.5 and out["cpu"][6] == 9.5


def test_segment_order_matches_cpu():
    """The card's stable sorts order the rows as the CPU's, -0.0 beside
    +0.0 once renew_segments has canonicalized them."""
    _card()
    res, key, _, _ = _inputs(3)
    r = res + 0.0
    a = segment_order(r.cuda(), key.cuda()).cpu()
    b = segment_order(r, key)
    assert torch.equal(a, b)


def test_renew_leaf_nseg_and_counter():
    _card()
    res, key, w, seg = _inputs(4)
    order = segment_order(res + 0.0, key)
    for nseg, dev_count in ((1, 0), (3, 1), (99, 1)):
        out = {}
        for dev in ("cuda", "cpu"):
            counters.reset(dev)
            o = torch.full((seg.shape[0],), 123.25, dtype=torch.float32,
                           device=dev)
            renew_leaf(order.to(dev), (res + 0.0).to(dev), w.to(dev),
                       seg.to(dev), o, 0.3,
                       torch.tensor([nseg], device=dev))
            out[dev] = o.cpu()
            assert counters.read(dev)["renew_leaf"] == dev_count, (nseg, dev)
        assert torch.equal(out["cuda"], out["cpu"])
        assert int((out["cpu"] != 123.25).sum()) == \
            (0 if nseg <= 1 else int((seg[:nseg, 1] > 0).sum()))


def _texts(X, y, extra, weight=None, rounds=4):
    text = {}
    for dev in ("cuda", "cpu"):
        p = dict(BASE, num_leaves=63, device_type=dev, **extra)
        bst = lp.train(p, lp.Dataset(X, y, weight=weight, params=p), rounds)
        assert bst._booster.use_persist == (
            extra["tpu_persist_scan"] == "force")
        text[dev] = bst.model_to_string().split("parameters:")[0]
    return text


@pytest.mark.parametrize("name,extra,weighted", [
    ("regression_l1", {"tpu_persist_scan": "force"}, False),
    ("regression_l1", {"tpu_persist_scan": "off"}, False),
    ("quantile", {"tpu_persist_scan": "force", "alpha": 0.9}, True),
    ("mape", {"tpu_persist_scan": "force"}, False),
    ("cross_entropy", {"tpu_persist_scan": "force"}, False),
    ("cross_entropy_lambda", {"tpu_persist_scan": "force"}, True),
    ("regression", {"tpu_persist_scan": "force", "reg_sqrt": True}, False)])
def test_cuda_training_matches_cpu(name, extra, weighted):
    _card()
    X, latent = higgs_latent(20_000, 31)
    X = _rows(X, 31)
    rng = np.random.default_rng(131)
    if name.startswith("cross_entropy"):
        y = 1.0 / (1.0 + np.exp(-latent))
    else:
        y = latent + rng.normal(size=len(latent))
        y = 3.0 * y if name == "mape" else y
        y = np.abs(y) if extra.get("reg_sqrt") else y
    w = rng.uniform(0.5, 2.0, len(y)) if weighted else None
    text = _texts(X, y, dict(extra, objective=name), w)
    assert text["cuda"] == text["cpu"]
