"""Cached training scores on the device.

The port of lightgbm_tpu/boosting/score_updater.py:ScoreUpdater (reference
src/boosting/score_updater.hpp:21-150): a [K, n] float64 tensor on the
training device, one row per tree of an iteration (K > 1 for multiclass,
class-major as the reference's ``num_data * k + i``). A new tree's outputs
are added to its class's row through the grower's row -> leaf map instead
of re-predicting (score_updater.hpp:84-99). :attr:`score` is the [n] row
when K = 1 and the [K, n] matrix otherwise.

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

from ..ops.valid_walk import valid_walk


class ScoreUpdater:
    def __init__(self, num_data: int, device,
                 init_score: Optional[np.ndarray] = None,
                 num_tree_per_iteration: int = 1):
        K = int(num_tree_per_iteration)
        self.num_tree_per_iteration = K
        self.has_init_score = init_score is not None
        if init_score is not None:
            init = np.asarray(init_score, dtype=np.float64).reshape(-1)
            if init.size == num_data:
                init = np.tile(init, K)
            elif init.size != num_data * K:
                raise ValueError("init_score size mismatch")
            self._score = torch.as_tensor(init.reshape(K, num_data),
                                          device=device).clone()
        else:
            self._score = torch.zeros((K, num_data), dtype=torch.float64,
                                      device=device)
        self._source = None

    @property
    def score(self) -> torch.Tensor:
        """The f64 row-ordered scores ([n] for one tree per iteration,
        else [K, n]), synced from their owner first."""
        if self._source is not None:
            self._score = self._source().reshape(self._score.shape)
            self._source = None
        return self._score[0] if self.num_tree_per_iteration == 1 \
            else self._score

    def defer_to(self, source) -> None:
        """The scores are owned elsewhere until read: `source()` returns
        them in row order."""
        self._source = source

    def _row(self, class_id: int) -> torch.Tensor:
        self.score
        return self._score[class_id]

    def add_const(self, val: float, class_id: int = 0) -> None:
        self._row(class_id).add_(val)

    def add_tree(self, leaf_value: np.ndarray, row_leaf: torch.Tensor,
                 shrink: float, class_id: int = 0) -> None:
        """score[class_id] += leaf_value[row_leaf] * shrink, with the f32
        leaf outputs widened to f64 first (as the JAX package's fast
        path)."""
        row = self._row(class_id)
        lv = torch.as_tensor(np.asarray(leaf_value, np.float64),
                             device=row.device)
        row.add_(lv[row_leaf.long()] * shrink)

    def add_tree_walk(self, packed, class_id: int, bins) -> None:
        """score[class_id] += the leaf value of each row under a packed
        tree (ops/valid_walk.py:pack), walked over the training rows'
        [n, G] uint8 bins `bins`: one f64 add per row, the JAX package's
        add_score_np of a predict_binned delta (DART's drop and
        normalize)."""
        valid_walk(bins, packed.nodes, packed.leaves, self._row(class_id),
                   packed.words)

    def multiply_score(self, val: float, class_id: int = 0) -> None:
        """score[class_id] *= val (RF's running average)."""
        self._row(class_id).mul_(val)


class ValidScoreUpdater:
    """The scores of one validation set: a [K, n] float64 tensor on the
    training device, started from the set's init_score (one value per row,
    repeated for every class, or n * K class-major values), as the JAX
    package's HostScoreUpdater (boosting/score_updater.py:114-144). A tree
    is added by the binned walk (ops/valid_walk.py), one launch per tree on
    the card; :attr:`score` is the [n] row when K = 1 and the [K, n]
    matrix otherwise."""

    def __init__(self, dataset, num_tree_per_iteration: int, device):
        K = int(num_tree_per_iteration)
        n = dataset.num_data
        self.dataset = dataset
        self.num_tree_per_iteration = K
        self.bins = dataset.to_device(device).bins
        init = dataset.metadata.init_score
        if init is not None:
            init = np.asarray(init, dtype=np.float64).reshape(-1)
            init = (init.reshape(K, n) if init.size == n * K
                    else np.tile(init.reshape(1, n), (K, 1)))
            self._score = torch.as_tensor(init, device=device).clone()
        else:
            self._score = torch.zeros((K, n), dtype=torch.float64,
                                      device=device)

    @property
    def score(self) -> torch.Tensor:
        return self._score[0] if self.num_tree_per_iteration == 1 \
            else self._score

    def add_const(self, val: float, class_id: int = 0) -> None:
        self._score[class_id].add_(val)

    def add_tree(self, packed, class_id: int = 0) -> None:
        """score[class_id] += the leaf value of each row's leaf under a
        packed tree (ops/valid_walk.py:pack)."""
        valid_walk(self.bins, packed.nodes, packed.leaves,
                   self._score[class_id], packed.words)

    def multiply_score(self, val: float, class_id: int = 0) -> None:
        """score[class_id] *= val (RF's running average)."""
        self._score[class_id].mul_(val)
