"""Synthetic benchmark data: the HIGGS-shaped set of the repo's north star.

The port's own copy of ``make_higgs_like`` from the JAX package
(lightgbm_tpu/data/synth.py), so that both packages draw the same rows from
the same seed without the port importing the JAX package.
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
