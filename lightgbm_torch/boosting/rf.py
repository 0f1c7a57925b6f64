"""Random forest (reference src/boosting/rf.hpp).

The port of lightgbm_tpu/boosting/rf.py: bagging is mandatory (a fraction
in (0, 1) with a bagging_freq), there is no shrinkage, the gradients are
computed once, from the constant init score ``boost_from_score(k)``
(rf.py:209-222), every tree gets that score as its bias, and the training
and validation scores hold the running average of the trees:
``score *= t; score += tree; score *= 1 / (t + 1)`` with t the iteration
(:314-319). A tree of one leaf is not a stop: a stub is kept and training
goes on (:284-287, 320-333). The model text carries ``average_output``
and prediction divides by the number of iterations.

The bags are the host's numpy draws (GBDT.bagging) on both growers, as on
both of the JAX package's routes (rf.py:257-265), so the two growers see
the same bags:

  * v1 grower (the JAX host path): the gradients of the constant, [K, n]
    f64 on the device, times the bag mask; a leaf-renewal objective re-fits
    each leaf from its in-bag rows against the constant
    (``_renew_rf_tree_output``, :338-355); the averages in f64;
  * persistent grower (the JAX fused RF path, :225-242; one tree per
    iteration, no init score, the "payload" gradient mode): the host mask
    uploaded into the bag step's buffer (ops/bag.py's MODE_ROWS), the
    gradient fill from the constant, the running average of the f32
    payload scores by grow_step.apply_scores_avg, all in the iteration's
    CUDA graph; t and the bias are device scalars written before each
    replay. Validation sets keep f64 averages, updated on the host side of
    the iteration as on v1 (the JAX package takes its host path there;
    ROADMAP.md C9).
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.tree import Tree
from ..ops.bag import rows_iteration
from ..ops.valid_walk import pack
from ..utils.log import Log
from .gbdt import GBDT, K_EPSILON


class RF(GBDT):

    sub_model_name = "tree"     # the reference's RF writes "tree" too
    average_output = True

    def init(self, config, train_data, objective, device) -> None:
        if not (config.bagging_freq > 0
                and 0.0 < config.bagging_fraction < 1.0):
            Log.fatal("Random forest needs bagging_freq > 0 and "
                      "bagging_fraction in (0, 1)")
        if objective is None:
            Log.fatal("RF mode does not support custom objective functions, "
                      "please use built-in objectives.")
        super().init(config, train_data, objective, device)
        self.shrinkage_rate = 1.0
        K = self.num_tree_per_iteration
        self.init_scores = [objective.boost_from_score(k) for k in range(K)]
        # the v1 grower's gradients of the constant, [K, n], computed once
        # (on the persistent grower the fill runs in the iteration)
        self._rf_grad = None
        if not self.use_persist:
            n = train_data.num_data
            score = torch.as_tensor(np.tile(np.asarray(
                self.init_scores, np.float64)[:, None], (1, n)),
                device=device)
            g, h = objective.get_gradients(score[0] if K == 1 else score)
            self._rf_grad = (g.reshape(K, n), h.reshape(K, n))

    def _average_in(self, tree, class_id: int, t: float, row_leaf=None):
        """The running average of the f64 scores over tree `tree`: the
        training scores through `row_leaf` (None: they live in the payload,
        which the iteration averaged), the validation sets by the binned
        walk."""
        nl = max(tree.num_leaves, 1)
        ups = list(self.valid_score) + (
            [self.train_score] if row_leaf is not None else [])
        for su in ups:
            su.multiply_score(t, class_id)
        if row_leaf is not None:
            self.train_score.add_tree(tree.leaf_value[:nl], row_leaf, 1.0,
                                      class_id)
        if self.valid_score:
            pt = pack([tree], [tree.leaf_value[:nl]], self.train_data,
                      self.device)[0]
            for su in self.valid_score:
                su.add_tree(pt, class_id)
        for su in ups:
            su.multiply_score(1.0 / (t + 1.0), class_id)

    def _stub(self, class_id: int, t: float, payload: bool) -> Tree:
        """A tree of one leaf: at the first iteration its constant (0 for a
        trainable class, else its BoostFromScore) averaged into the scores
        (rf.hpp:145-155; the payload's were averaged in the iteration),
        later nothing."""
        tree = Tree(1)
        if len(self.models) < self.num_tree_per_iteration:
            output = 0.0
            if not self.class_need_train[class_id]:
                output = self.objective.boost_from_score(class_id)
            tree.leaf_value[0] = output
            ups = list(self.valid_score) + ([] if payload
                                            else [self.train_score])
            for su in ups:
                su.multiply_score(t, class_id)
                su.add_const(output, class_id)
                su.multiply_score(1.0 / (t + 1.0), class_id)
        return tree

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One iteration, one tree per class; never a stop."""
        if gradients is not None or hessians is not None:
            Log.fatal("RF mode does not support custom objective functions")
        self._invalidate_predictors()
        t = float(self.iter)
        if self.use_persist:
            self._iteration_persist(t)
        else:
            self._iteration_v1(t)
        self.iter += 1
        return False

    def _iteration_v1(self, t: float) -> None:
        self.bagging(self.iter)
        g_all, h_all = self._rf_grad
        m = self._bag_mask.to(g_all.dtype)
        for k in range(self.num_tree_per_iteration):
            tree = row_leaf = None
            if self.class_need_train[k] and self.train_data.num_features > 0:
                arrays, row_leaf = self.tree_learner.train_arrays(
                    g_all[k] * m, h_all[k] * m, self._bag_mask)
                if arrays.num_leaves > 1:
                    if self.objective.is_renew_tree_output:
                        const = torch.full_like(g_all[k], self.init_scores[k],
                                                dtype=torch.float64)
                        arrays = self._renew_v1(arrays, row_leaf, k, const)
                    tree = Tree.from_grower(arrays, self.train_data)
            if tree is not None:
                if abs(self.init_scores[k]) > K_EPSILON:
                    tree.add_bias(self.init_scores[k])
                self._average_in(tree, k, t, row_leaf)
            else:
                tree = self._stub(k, t, payload=False)
            self.models.append(tree)

    def _iteration_persist(self, t: float) -> None:
        learner = self.tree_learner
        bias = float(self.init_scores[0])
        bag = rows_iteration(self.iter, self._draw_bag(self.iter))
        arrays = learner.train_persist(
            self.objective, lambda: self.train_score.score, 1.0, (0,), bag,
            rf=(t, bias))[0]
        self.train_score.defer_to(learner.persist_finalize_scores)
        if arrays.num_leaves > 1:
            tree = Tree.from_grower(arrays, self.train_data)
            if abs(bias) > K_EPSILON:
                tree.add_bias(bias)
            self._average_in(tree, 0, t)
        else:
            tree = self._stub(0, t, payload=True)
        self.models.append(tree)
