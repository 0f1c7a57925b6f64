"""Synthetic benchmark data: the HIGGS-shaped set of the repo's north star
and the Expo-shaped EFB-bundled set.

The port's own copies of ``make_higgs_like`` and ``make_expo_like`` from the
JAX package (lightgbm_tpu/data/synth.py), so that both packages draw the
same rows from the same seed without the port importing the JAX package.
"""
from __future__ import annotations

import numpy as np


def make_higgs_like(n_rows: int, n_features: int = 28, seed: int = 7):
    """Synthetic stand-in for HIGGS: continuous kinematic-like features,
    nonlinear decision boundary, ~53/47 class balance like the real set."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_rows, n_features)).astype(np.float32)
    # a few derived-feature couplings like HIGGS's high-level features
    X[:, 21] = np.abs(X[:, 0] * X[:, 1]) + 0.3 * X[:, 21]
    X[:, 22] = X[:, 2] ** 2 + X[:, 3] ** 2 + 0.3 * X[:, 22]
    logit = (0.8 * X[:, 0] - 0.5 * X[:, 1] + 0.4 * X[:, 21]
             - 0.3 * X[:, 22] + 0.5 * np.tanh(X[:, 4] * X[:, 5]))
    y = (logit + rng.logistic(size=n_rows).astype(np.float32) * 0.8 > 0.0)
    return X.astype(np.float64), y.astype(np.float64)


def make_expo_like(n_rows=2_000_000, seed=0):
    """Expo-shaped synthetic: a few dense numerics plus one-hot blocks
    that EFB bundles into a handful of byte groups (8 + 640 columns; the
    Expo set of the reference's docs/Experiments.rst is 11M x 700)."""
    rng = np.random.default_rng(seed)
    nd = 8
    blocks = [50, 30, 24, 24, 12, 300, 200]
    Xd = rng.normal(size=(n_rows, nd)).astype(np.float32)
    cols = [Xd]
    sig = Xd[:, 0] * 0.5
    for card in blocks:
        ids = rng.integers(0, card, n_rows)
        oh = np.zeros((n_rows, card), np.float32)
        oh[np.arange(n_rows), ids] = 1.0
        cols.append(oh)
        sig = sig + (ids % 7 == 0) * 0.4
    X = np.concatenate(cols, axis=1)
    y = (sig + rng.logistic(size=n_rows) * 0.7 > 0.3)
    # f32: a dense f64 one-hot matrix would double the host memory
    return X, y.astype(np.float64)
