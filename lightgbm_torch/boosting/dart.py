"""DART: dropouts meet multiple additive regression trees (reference
src/boosting/dart.hpp).

The port of lightgbm_tpu/boosting/dart.py. Each iteration:

  1. drop: the dropped iterations drawn from a numpy Generator seeded with
     ``drop_seed``, in the JAX package's order (``_dropping_trees``,
     dart.py:103-141: ``skip_drop``, ``uniform_drop`` or the weighted drop,
     the ``max_drop`` cap);
  2. subtract: each dropped tree is shrunk by -1 and walked over the
     training rows onto their scores (``_subtract_tree``, :97-101);
  3. train: the iteration's trees (GBDT.train_one_iter) from the post-drop
     scores at ``learning_rate / (1 + k)`` (``xgboost_dart_mode``:
     ``learning_rate / (learning_rate + k)``), k trees dropped;
  4. normalize (``_normalize``, :143-173): each dropped tree shrunk to
     1 / (k + 1) of itself (or the xgboost variant) and walked onto every
     validation set, then shrunk by -k and walked onto the training scores;
  5. weights: ``tree_weight`` and ``sum_weight`` (without
     ``uniform_drop``).

DART never early-stops (dart.hpp:88-95; callback.py warns).

Routing: as GBDT. The walks of steps 2 and 4 run between iterations, so
the persistent grower's per-iteration CUDA graph does not change: there
the scores live in the payload as f32 and a dropped tree's values land on
them as the JAX package's add_score_delta puts them (the f64 leaf value
rounded to f32, one f32 add per lane; :meth:`GBDT._add_score_delta`,
ops/valid_walk.py:valid_walk_payload); on the v1 grower one f64 add per
row onto the ScoreUpdater (valid_walk). The JAX package's DART takes its
fast path only where its learner takes the persistent grower (dart.py:
31-41), so on the v1 grower the stop rule is its per-class path's
(:meth:`DART._fast_path`).
"""
from __future__ import annotations

import numpy as np

from ..ops.valid_walk import pack
from ..utils.log import Log
from .gbdt import GBDT


class DART(GBDT):

    sub_model_name = "dart"

    def init(self, config, train_data, objective, device) -> None:
        super().init(config, train_data, objective, device)
        self.drop_index = []
        self.tree_weight = []
        self.sum_weight = 0.0
        self._drop_rng = np.random.default_rng(config.drop_seed)
        Log.info("Using DART")

    def _fast_path(self) -> bool:
        """GBDT's, and the persistent grower (the JAX package's
        DART._fast_path_ok)."""
        return super()._fast_path() and self.use_persist

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """Drop, train, normalize (the JAX package's DART.train_one_iter:
        the drop comes with the gradients, so a custom objective's
        iteration drops nothing, and an iteration that stops is not
        normalized)."""
        if self._finished:
            return True
        if gradients is None or hessians is None:
            self._dropping_trees()
        if super().train_one_iter(gradients, hessians):
            return True
        self._normalize()
        if not self.config.uniform_drop:
            self.tree_weight.append(self.shrinkage_rate)
            self.sum_weight += self.shrinkage_rate
        return False

    def _walk_train(self, trees, classes) -> None:
        """Each tree's leaf values as they are now added to its class's
        training scores, in order, the trees uploaded with one copy."""
        packed = pack(trees, [t.leaf_value[:max(t.num_leaves, 1)]
                              for t in trees], self.train_data, self.device)
        for pt, k in zip(packed, classes):
            self._add_score_delta(pt, k)

    def _dropped(self):
        """(trees, classes) of the dropped iterations, in order."""
        K = self.num_tree_per_iteration
        return ([self.models[i * K + k] for i in self.drop_index
                 for k in range(K)],
                [k for _ in self.drop_index for k in range(K)])

    def _dropping_trees(self) -> None:
        cfg = self.config
        self.drop_index = []
        is_skip = self._drop_rng.random() < cfg.skip_drop
        if not is_skip:
            drop_rate = cfg.drop_rate
            if not cfg.uniform_drop:
                if self.sum_weight > 0:
                    inv_avg = len(self.tree_weight) / self.sum_weight
                    if cfg.max_drop > 0:
                        drop_rate = min(drop_rate, cfg.max_drop * inv_avg
                                        / self.sum_weight)
                    for i in range(self.iter):
                        if self._drop_rng.random() < \
                                drop_rate * self.tree_weight[i] * inv_avg:
                            self.drop_index.append(i)
                            if len(self.drop_index) >= cfg.max_drop:
                                break
            else:
                if cfg.max_drop > 0 and self.iter > 0:
                    drop_rate = min(drop_rate, cfg.max_drop / self.iter)
                for i in range(self.iter):
                    if self._drop_rng.random() < drop_rate:
                        self.drop_index.append(i)
                        if len(self.drop_index) >= cfg.max_drop:
                            break
        trees, classes = self._dropped()
        if trees:
            for tree in trees:
                tree.shrink(-1.0)
            self._walk_train(trees, classes)
        k = len(self.drop_index)
        if not cfg.xgboost_dart_mode:
            self.shrinkage_rate = cfg.learning_rate / (1.0 + k)
        elif k == 0:
            self.shrinkage_rate = cfg.learning_rate
        else:
            self.shrinkage_rate = cfg.learning_rate / (cfg.learning_rate + k)

    def _normalize(self) -> None:
        cfg = self.config
        k = float(len(self.drop_index))
        trees, classes = self._dropped()
        if not trees:
            return
        if not cfg.xgboost_dart_mode:
            first, second = 1.0 / (k + 1.0), -k
        else:
            first, second = self.shrinkage_rate, -k / cfg.learning_rate
        self._invalidate_predictors()      # earlier trees are rescaled
        valid_values = []
        for tree in trees:
            tree.shrink(first)
            valid_values.append(tree.leaf_value[:max(tree.num_leaves, 1)]
                                .copy())
            tree.shrink(second)
        if self.valid_score:
            packed = pack(trees, valid_values, self.train_data, self.device)
            for su in self.valid_score:
                for pt, c in zip(packed, classes):
                    su.add_tree(pt, c)
        self._walk_train(trees, classes)
        if not cfg.uniform_drop:
            for i in self.drop_index:
                if not cfg.xgboost_dart_mode:
                    self.sum_weight -= self.tree_weight[i] * (1.0 / (k + 1.0))
                    self.tree_weight[i] *= k / (k + 1.0)
                else:
                    self.sum_weight -= self.tree_weight[i] * \
                        (1.0 / (k + cfg.learning_rate))
                    self.tree_weight[i] *= k / (k + cfg.learning_rate)
