"""Cached training scores on the device.

The port of lightgbm_tpu/boosting/score_updater.py:ScoreUpdater (reference
src/boosting/score_updater.hpp:21-150) for one tree per iteration: an
[N] float64 tensor on the training device. A new tree's outputs are added
through the grower's row -> leaf map instead of re-predicting
(score_updater.hpp:84-99).

Under the persistent-payload grower the scores live in the payload, in
payload order, and the learner updates them there; :meth:`defer_to` hands
the updater a function that returns them in row order, and reading
:attr:`score` calls it first (the JAX package's ``_sync_persist_scores``,
boosting/gbdt.py:468-480), so nothing reads a stale buffer.
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
            self._score = torch.as_tensor(init, device=device).clone()
        else:
            self._score = torch.zeros(num_data, dtype=torch.float64,
                                      device=device)
        self._source = None

    @property
    def score(self) -> torch.Tensor:
        """The [N] f64 row-ordered scores, synced from their owner first."""
        if self._source is not None:
            self._score = self._source()
            self._source = None
        return self._score

    def defer_to(self, source) -> None:
        """The scores are owned elsewhere until read: `source()` returns
        them in row order."""
        self._source = source

    def add_const(self, val: float) -> None:
        self.score.add_(val)

    def add_tree(self, leaf_value: np.ndarray, row_leaf: torch.Tensor,
                 shrink: float) -> None:
        """score += leaf_value[row_leaf] * shrink, with the f32 leaf
        outputs widened to f64 first (as the JAX package's fast path)."""
        lv = torch.as_tensor(np.asarray(leaf_value, np.float64),
                             device=self.score.device)
        self.score.add_(lv[row_leaf.long()] * shrink)
