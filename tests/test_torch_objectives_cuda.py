"""Multiclass and regression training on the card against the CPU.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_objectives_cuda.py

They are the card-vs-CPU checks of tests/test_torch_multiclass.py
(test_cuda_multiclass_training_matches_cpu) and tests/test_torch_regression.py
(test_cuda_regression_training_matches_cpu), which sit in files that import
JAX; those stay where they are. The data are the same: HIGGS-shaped rows
(make_higgs_like, 8 of its features, 5% missing values) with K quantile
classes of its latent, or a regression target from the latent. The
persistent grower (``tpu_persist_scan=force``) trains 4 iterations on each
device; the model text must be equal. Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like

pytestmark = pytest.mark.cuda

BASE = {"num_leaves": 7, "max_bin": 63, "min_data_in_leaf": 20,
        "min_gain_to_split": 1e-3, "learning_rate": 0.2, "verbosity": -1}


def higgs_latent(n, seed=7, n_features=28):
    """(X, latent): make_higgs_like's rows and the f32 latent it
    thresholds at 0, redrawn from the same seed."""
    X, y = make_higgs_like(n, n_features, seed)
    rng = np.random.default_rng(seed)
    rng.normal(size=(n, n_features))            # the features' draw
    x = X.astype(np.float32)
    logit = (0.8 * x[:, 0] - 0.5 * x[:, 1] + 0.4 * x[:, 21]
             - 0.3 * x[:, 22] + 0.5 * np.tanh(x[:, 4] * x[:, 5]))
    latent = logit + rng.logistic(size=n).astype(np.float32) * 0.8
    assert np.array_equal(latent > 0, y > 0)
    return X, latent


def _rows(X, seed, f=8, missing=0.05):
    X = X[:, :f].copy()
    X[np.random.default_rng(seed).random(X.shape) < missing] = np.nan
    return X


def class_data(n, seed, K=3):
    X, latent = higgs_latent(n, seed)
    y = np.digitize(latent, np.quantile(latent, np.arange(1, K) / K))
    return _rows(X, seed), y.astype(np.float64)


def reg_data(objective, n, seed):
    X, latent = higgs_latent(n, seed)
    rng = np.random.default_rng(seed + 100)
    if objective in ("poisson", "tweedie"):
        y = rng.poisson(np.exp(latent / 2)).astype(np.float64)
    else:
        y = latent + rng.normal(size=n)
    return _rows(X, seed), y


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def _texts(X, y, extra):
    text = {}
    for dev in ("cuda", "cpu"):
        p = dict(BASE, num_leaves=63, tpu_persist_scan="force",
                 device_type=dev, **extra)
        bst = lp.train(p, lp.Dataset(X, y, params=p), 4)
        text[dev] = bst.model_to_string().split("parameters:")[0]
    return text


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_cuda_multiclass_training_matches_cpu(objective):
    _card()
    X, y = class_data(n=20_000, seed=8)
    text = _texts(X, y, {"objective": objective, "num_class": 3})
    assert text["cuda"] == text["cpu"]


@pytest.mark.parametrize("objective", ["regression", "poisson"])
def test_cuda_regression_training_matches_cpu(objective):
    _card()
    X, y = reg_data(objective, n=20_000, seed=8)
    text = _texts(X, y, {"objective": objective})
    assert text["cuda"] == text["cpu"]
