"""The regression objectives with a payload gradient (regression, huber,
fair, poisson, gamma, tweedie) trained by the port against the JAX
package, on both growers.

Data: HIGGS-shaped rows (make_higgs_like, 8 of its features, 5% missing
values) and targets from the latent that make_higgs_like thresholds: the
latent plus Gaussian noise for the L2 family (as chip_smoke.py's HIGGS
regression path), Poisson counts of exp(latent / 2) for poisson and
tweedie, and exp(latent / 2) times Gamma noise for gamma.

The routes, the JAX references and the tree rules are
tests/test_torch_multiclass.py's: the persistent grower against the JAX
package's persistent path with its Pallas kernels in interpret mode (16
iterations), the v1 grower against its v1 grower (5). The leaf-value bound
near zero scales with the largest |grad| of the first iteration (twice
it), since a regression gradient is not bounded by 1.
"""
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from test_torch_multiclass import (BASE, EPS32, ROUNDS, ROUTES,
                                   assert_same_models, higgs_latent,
                                   train_jax, train_port)

OBJECTIVES = ("regression", "huber", "fair", "poisson", "gamma", "tweedie")


def reg_data(objective, n=2000, seed=3, f=8, missing=0.05):
    X, latent = higgs_latent(n, seed)
    rng = np.random.default_rng(seed + 100)
    if objective in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(latent / 2)).astype(np.float64)
    elif objective == "gamma":
        y = np.exp(latent / 2) * rng.gamma(2.0, 0.5, n)
    else:
        y = latent + rng.normal(size=n)
    X = X[:, :f].copy()
    if missing:
        X[np.random.default_rng(seed).random(X.shape) < missing] = np.nan
    return X, y


def gmax(bp):
    """Twice the largest |grad| of the first iteration (the boosted-from-
    average scores)."""
    obj = bp._booster.objective
    s0 = torch.full((bp._booster.train_data.num_data,),
                    obj.boost_from_score(0), dtype=torch.float64)
    g, _ = obj.get_gradients(s0)
    return 2.0 * float(g.abs().max())


@pytest.mark.parametrize("route", ["persist", "v1"])
@pytest.mark.parametrize("objective", OBJECTIVES)
def test_regression_matches_jax(objective, route, monkeypatch):
    extra, rounds = ROUTES[route]
    params = dict(BASE, objective=objective, **extra)
    X, y = reg_data(objective)
    pallas = route != "v1"
    bj = train_jax(params, X, y, rounds, pallas, monkeypatch)
    bp = train_port(params, X, y, rounds)
    assert len(bp._booster.models) == rounds
    assert_same_models(bj, bp, X, params["learning_rate"], 1, mxu=pallas,
                       gmax=gmax(bp))
    walk = bp.predict(X, raw_score=True)
    score = bp._booster.train_score.score.numpy()
    tol = (1e-9 if route == "v1" else
           2 * (rounds + 1) * EPS32 * max(1.0, np.abs(walk).max()))
    assert np.max(np.abs(score - walk)) <= tol
    np.testing.assert_array_equal(bp.predict(X),
                                  bp._booster.objective.convert_output(walk))


@pytest.mark.parametrize("objective", ["regression", "poisson"])
def test_regression_level_matches_jax(objective, monkeypatch):
    """The level phase (max_depth 3) against the JAX package's, and bit for
    bit against the port's own per-split loop."""
    extra, rounds = ROUTES["level"]
    params = dict(BASE, objective=objective, **extra)
    X, y = reg_data(objective, seed=4)
    bj = train_jax(params, X, y, rounds, True, monkeypatch)
    bp = train_port(params, X, y, rounds)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.use_level and all(lv > 0 for lv, _ in gr.grow_stats)
    assert_same_models(bj, bp, X, params["learning_rate"], 1, mxu=True,
                       gmax=gmax(bp))
    off = train_port(dict(params, tpu_level_grow="off"), X, y, rounds)
    np.testing.assert_array_equal(off.predict(X, raw_score=True),
                                  bp.predict(X, raw_score=True))


@pytest.mark.parametrize("objective", ["regression", "gamma"])
def test_weighted_regression_matches_jax(objective, monkeypatch):
    """Sample weights ride the payload and multiply the objective's
    gradients after it (for gamma that is not the v1 grower's formula,
    which weights inside the subtraction: the JAX package does the same)."""
    params = dict(BASE, objective=objective, tpu_persist_scan="force")
    X, y = reg_data(objective, seed=5)
    w = np.random.default_rng(5).uniform(0.5, 2.0, len(y))
    bj = train_jax(params, X, y, ROUNDS, True, monkeypatch, weight=w)
    bp = train_port(params, X, y, ROUNDS, weight=w)
    assert bp._booster.tree_learner._persist_gr.weight_row is not None
    assert_same_models(bj, bp, X, params["learning_rate"], 1, mxu=True,
                       gmax=2.0 * gmax(bp))


def test_reg_sqrt_trains_on_v1():
    """reg_sqrt on the v1 grower (tpu_persist_scan=off) grows from the
    square-rooted label and predicts sign(raw) * raw^2, as the JAX
    package. (On the persistent grower it takes the row gradient mode:
    tests/test_torch_persist_renew.py.)"""
    params = dict(BASE, objective="regression", reg_sqrt=True,
                  tpu_persist_scan="off")
    X, y = reg_data("regression", seed=6)
    bj = train_jax(params, X, y, 5)
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, params=p), 5)
    assert not bp._booster.use_persist
    assert "objective=regression sqrt" in bp.model_to_string()
    assert_same_models(bj, bp, X, params["learning_rate"], 1, gmax=gmax(bp))
    raw = bp.predict(X, raw_score=True)
    np.testing.assert_array_equal(bp.predict(X), np.sign(raw) * raw * raw)


@pytest.mark.parametrize("objective", ["regression", "poisson", "tweedie"])
def test_regression_model_text_loads_both_ways(objective):
    params = dict(BASE, objective=objective)
    X, y = reg_data(objective, seed=7)
    bj = lt.train(dict(params), lt.Dataset(X, y), 3)
    bp = train_port(dict(params, tpu_persist_scan="force"), X, y, 3)
    for src, dst_cls in ((bj, lp.Booster), (bp, lt.Booster)):
        dst = dst_cls(model_str=src.model_to_string(),
                      params={"device_type": "cpu"})
        for raw in (True, False):
            np.testing.assert_array_equal(src.predict(X, raw_score=raw),
                                          dst.predict(X, raw_score=raw))


@pytest.mark.cuda
@pytest.mark.parametrize("objective", ["regression", "poisson"])
def test_cuda_regression_training_matches_cpu(objective):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    X, y = reg_data(objective, n=20_000, seed=8)
    text = {}
    for dev in ("cuda", "cpu"):
        p = dict(BASE, objective=objective, num_leaves=63,
                 tpu_persist_scan="force", device_type=dev)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 4)
        text[dev] = bst.model_to_string().split("parameters:")[0]
    assert text["cuda"] == text["cpu"]
