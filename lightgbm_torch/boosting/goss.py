"""GOSS: gradient-based one-side sampling (reference src/boosting/goss.hpp).

The port of lightgbm_tpu/boosting/goss.py. Each iteration from
``int(1 / learning_rate)`` on (goss.hpp:126-131) keeps the rows of the
largest |g * h| (summed over the classes) and a sample of the rest,
amplified, and multiplies their gradients by those weights before the
trees; out-of-bag rows get weight 0. As the JAX package, by grower:

  * v1 grower (the JAX per-iteration path, its goss.py:43-72): on the
    host, in numpy, from the iteration's gradients: the threshold at the
    ``top_k = max(1, int(n * top_rate))``-th largest score by
    ``np.partition``, every row at or above it at weight 1, then
    ``other_k = int(n * other_rate)`` of the rest drawn without replacement
    by the bagging Generator at weight f32((n - top_k) / max(other_k, 1));
  * persistent grower (the JAX fused driver, grow_persist.py:
    make_goss_weight_fn:540-566): on the device, the exact top_k-th
    largest |g * h| (goss_select) and a Bernoulli draw of the rest with
    probability p_rest from the row hash at the iteration's key, amplified
    by amp (bag_apply; ops/bag.py). Its constants are not the host path's
    (the JAX package's two semantics). One tree per iteration: with K > 1
    classes GOSS trains on the v1 grower (the JAX driver refuses to batch
    it: the score sums over the classes).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .gbdt import GBDT


class GOSS(GBDT):

    sub_model_name = "goss"

    def init(self, config, train_data, objective, device) -> None:
        super().init(config, train_data, objective, device)
        if config.bagging_freq > 0 and config.bagging_fraction != 1.0:
            Log.fatal("Cannot use bagging in GOSS")
        Log.info("Using GOSS")
        if config.top_rate + config.other_rate >= 1.0:
            Log.fatal("The sum of top_rate and other_rate cannot be 1.0")

    def bag_spec(self):
        cfg = self.config
        return ("goss", float(cfg.top_rate), float(cfg.other_rate))

    def bagging(self, it: int, grad=None, hess=None) -> None:
        """The iteration's GOSS weights from its [K, n] gradients (the JAX
        package's GOSS.bagging)."""
        n = self.train_data.num_data
        self._bag_mask = self._bag_weight = None
        self.bag_data_cnt = n
        if it < int(1.0 / self.config.learning_rate):
            return
        g = grad.cpu().numpy()
        h = hess.cpu().numpy()
        score = np.abs(g * h).sum(axis=0)
        cfg = self.config
        top_k = max(1, int(n * cfg.top_rate))
        other_k = int(n * cfg.other_rate)
        threshold = np.partition(score, n - top_k)[n - top_k]
        big = score >= threshold
        multiply = np.float32((n - top_k) / max(other_k, 1))
        rest_idx = np.nonzero(~big)[0]
        w = np.zeros(n, dtype=np.float32)
        w[big] = 1.0
        if other_k > 0 and len(rest_idx) > 0:
            pick = self._bagging_rng.choice(
                rest_idx, size=min(other_k, len(rest_idx)), replace=False)
            w[pick] = multiply
        mask = w > 0
        self.bag_data_cnt = int(mask.sum())
        self._bag_mask = torch.as_tensor(mask, device=self.device)
        self._bag_weight = torch.as_tensor(w, device=self.device)
