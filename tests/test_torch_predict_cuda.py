"""The prediction walk kernel and serving on the card, against the plain
version and the numpy walk.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_predict_cuda.py

  * ``predict_walk`` (csrc/predict.cu) against ``predict_walk_plain`` on
    the card, bit for bit, in raw f64, raw f32 and leaf modes: one class
    and three, NaN rows, categorical nodes with NaN, negative, unseen and
    huge categories, an averaged model (RF), a one-leaf tree; raw f64 and
    leaves also equal to the numpy walk;
  * ``Booster.predict`` on a card (the default route) goes through the
    kernel, a model read from text too, and ``predict_device=cpu`` through
    the numpy walk;
  * ``BatchServer`` and ``AsyncBatchServer`` (with a registry swap) on the
    card: every served row equal to the kernel's direct output.

Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.ops.predict import predict_walk, predict_walk_plain
from lightgbm_torch.predict import (BatchServer, CudaPredictor,
                                    compile_ensemble)
from lightgbm_torch.serving import AsyncBatchServer, ModelRegistry

pytestmark = pytest.mark.cuda

BASE = {"num_leaves": 31, "max_bin": 63, "min_data_in_leaf": 10,
        "learning_rate": 0.3, "verbosity": -1, "device_type": "cpu",
        "tpu_persist_scan": "false"}
WAIT = 120.0


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def _rows(n, seed, nan=0.05):
    X, y = make_higgs_like(n, 28, seed)
    X = X.astype(np.float64)
    X[np.random.default_rng(seed).random(X.shape) < nan] = np.nan
    return X, y


def _cat(n, seed):
    rng = np.random.default_rng(seed)
    X = np.empty((n, 5))
    X[:, 0] = rng.integers(0, 12, n)
    X[:, 1] = rng.integers(0, 150, n)
    X[:, 2:] = rng.normal(size=(n, 3))
    y = ((np.isin(X[:, 0], [1, 4, 7, 9]) ^ (X[:, 1] % 3 == 0))
         | (X[:, 2] > 1.0)).astype(np.float64)
    Xt = X.copy()
    for v in (np.nan, -3.0, 999.0, 150.0, 2.0 ** 40, 1e20, -0.0, np.inf):
        Xt[:, :2][rng.random((n, 2)) < 0.03] = v
    Xt[:, :2][rng.random((n, 2)) < 0.03] += 0.5
    return X, y, Xt


def _model(kind):
    """(booster trained on the CPU, rows to predict)."""
    if kind == "categorical":
        X, y, Xt = _cat(20_000, 3)
        p = dict(BASE, objective="binary")
        return lp.train(p, lp.Dataset(X, y, categorical_feature=[0, 1],
                                      params=p), 6), Xt
    X, y = _rows(20_000, 5)
    if kind == "multiclass":
        y = np.digitize(np.nan_to_num(X[:, 0]), [-0.4, 0.4]).astype(float)
        p = dict(BASE, objective="multiclass", num_class=3)
    elif kind == "rf":
        p = dict(BASE, objective="binary", boosting="rf",
                 bagging_fraction=0.7, bagging_freq=1)
    elif kind == "stub":
        # class 3 has no row: constant one-leaf trees
        y = np.digitize(np.nan_to_num(X[:, 0]), [-0.4, 0.4]).astype(float)
        p = dict(BASE, objective="multiclass", num_class=4)
    else:
        p = dict(BASE, objective="binary")
    return lp.train(p, lp.Dataset(X, y, params=p), 6), \
        _rows(50_003, 6, nan=0.1)[0]


def _walk(gb, dtype):
    ens = compile_ensemble(gb.models, gb.num_tree_per_iteration,
                           gb.average_output, gb.max_feature_idx)
    return CudaPredictor(ens, dtype=dtype, device="cuda")


@pytest.mark.parametrize("kind", ["binary", "multiclass", "categorical",
                                  "rf", "stub"])
@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_kernel_matches_plain(kind, dtype):
    _card()
    bst, Xt = _model(kind)
    gb = bst._booster
    pr = _walk(gb, dtype)
    K, avg = pr.num_class, gb.average_output
    X = torch.as_tensor(Xt.astype(pr.np_dtype), device="cuda")
    n0 = predict_walk.launches
    raw = predict_walk(X, pr.walk, K, avg)
    again = predict_walk(X, pr.walk, K, avg)
    leaf = predict_walk(X, pr.walk, K, leaf=True)
    torch.cuda.synchronize()
    assert predict_walk.launches == n0 + 3
    assert torch.equal(raw, again)
    assert torch.equal(raw, predict_walk_plain(X, pr.walk, K, avg))
    assert torch.equal(leaf, predict_walk_plain(X, pr.walk, K, leaf=True))
    if dtype == "f64":
        sub = Xt[:20_000]
        np.testing.assert_array_equal(raw[:20_000].cpu().numpy().reshape(
            gb.predict_raw(sub).shape), gb.predict_raw(sub))
        np.testing.assert_array_equal(
            leaf[:20_000].cpu().numpy(),
            bst.predict(sub, pred_leaf=True, predict_device="cpu"))
    else:
        want = predict_walk_plain(X.double(), _walk(gb, "f64").walk, K, avg)
        assert float((raw.double() - want).abs().max()) <= 1e-5


def test_booster_predict_reaches_the_kernel():
    _card()
    bst, Xt = _model("binary")
    text = bst.model_to_string()
    card = lp.Booster(model_str=text)                  # device_type cuda
    n0 = predict_walk.launches
    raw = card.predict(Xt, raw_score=True)
    assert predict_walk.launches == n0 + 1
    np.testing.assert_array_equal(raw, bst.predict(Xt, raw_score=True))
    np.testing.assert_allclose(card.predict(Xt), bst.predict(Xt), rtol=0,
                               atol=1e-12)
    np.testing.assert_array_equal(card.predict(Xt, pred_leaf=True),
                                  bst.predict(Xt, pred_leaf=True))
    n1 = predict_walk.launches
    np.testing.assert_array_equal(
        card.predict(Xt, raw_score=True, predict_device="cpu"), raw)
    assert predict_walk.launches == n1
    # multiclass: softmax on the card within 1e-12 of the numpy conversion
    mc, Xm = _model("multiclass")
    card = lp.Booster(model_str=mc.model_to_string())
    np.testing.assert_array_equal(card.predict(Xm, raw_score=True),
                                  mc.predict(Xm, raw_score=True))
    np.testing.assert_allclose(card.predict(Xm), mc.predict(Xm), rtol=0,
                               atol=1e-12)


def test_trained_on_the_card_predicts_on_it():
    _card()
    X, y = _rows(30_000, 8)
    p = dict(BASE, objective="binary", device_type="cuda")
    bst = lp.train(p, lp.Dataset(X, y, params=p), 4)
    n0 = predict_walk.launches
    raw = bst.predict(X, raw_score=True)
    assert predict_walk.launches == n0 + 1
    np.testing.assert_array_equal(
        raw, bst.predict(X, raw_score=True, predict_device="cpu"))
    bst.update()
    # the cached predictor was dropped: the new tree is walked
    np.testing.assert_array_equal(
        bst.predict(X, raw_score=True),
        bst.predict(X, raw_score=True, predict_device="cpu"))


def test_servers_match_the_kernel():
    _card()
    bst, Xt = _model("binary")
    other, _ = _model("rf")
    pr = bst._booster.device_predictor(device="cuda")
    direct = pr.predict(Xt, raw_score=True)
    server = BatchServer(pr, min_batch=256, max_batch=4096)
    rng = np.random.default_rng(1)
    i0 = 0
    while i0 < len(Xt):
        k = int(rng.integers(1, 9000))
        np.testing.assert_array_equal(
            server.predict(Xt[i0:i0 + k], raw_score=True), direct[i0:i0 + k])
        i0 += k
    assert server.stats()["compiles"] <= server.max_compiles()
    reg = ModelRegistry(device="cuda")
    reg.load("a", booster=bst)
    reg.load("b", booster=other)
    ref_b = other._booster.device_predictor(device="cuda").predict(
        Xt, raw_score=True)
    srv = AsyncBatchServer(reg, min_batch=256, max_batch=4096,
                           max_wait_ms=2.0).start()
    try:
        futs = [(i, srv.submit(Xt[i:i + 37], raw_score=True))
                for i in range(0, 20_000, 37)]
        for i, f in futs:
            np.testing.assert_array_equal(f.result(WAIT), direct[i:i + 37])
        reg.swap("b")
        np.testing.assert_array_equal(
            srv.predict(Xt[:5000], raw_score=True, timeout=WAIT),
            ref_b[:5000])
        reg.rollback()
        np.testing.assert_array_equal(
            srv.predict(Xt, raw_score=True, timeout=WAIT), direct)
        np.testing.assert_allclose(srv.predict(Xt[:999], timeout=WAIT),
                                   bst.predict(Xt[:999]), rtol=0,
                                   atol=1e-12)
    finally:
        srv.stop(timeout=WAIT)
    st = srv.stats()
    assert st["errors"] == 0 and st["coalesce_ratio"] > 1.0
