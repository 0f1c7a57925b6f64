"""Cached training scores on the device.

The port of lightgbm_tpu/boosting/score_updater.py:ScoreUpdater (reference
src/boosting/score_updater.hpp:21-150) for one tree per iteration: an
[N] float64 tensor on the training device. A new tree's outputs are added
through the grower's row -> leaf map instead of re-predicting
(score_updater.hpp:84-99).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class ScoreUpdater:
    def __init__(self, num_data: int, device,
                 init_score: Optional[np.ndarray] = None):
        self.has_init_score = init_score is not None
        if init_score is not None:
            init = np.asarray(init_score, dtype=np.float64).reshape(-1)
            if init.size != num_data:
                raise ValueError("init_score size mismatch")
            self.score = torch.as_tensor(init, device=device).clone()
        else:
            self.score = torch.zeros(num_data, dtype=torch.float64,
                                     device=device)

    def add_const(self, val: float) -> None:
        self.score += val

    def add_tree(self, leaf_value: np.ndarray, row_leaf: torch.Tensor,
                 shrink: float) -> None:
        """score += leaf_value[row_leaf] * shrink, with the f32 leaf
        outputs widened to f64 first (as the JAX package's fast path)."""
        lv = torch.as_tensor(np.asarray(leaf_value, np.float64),
                             device=self.score.device)
        self.score += lv[row_leaf.long()] * shrink
