"""GBDT: the boosting driver of the port.

The port of the per-iteration path of lightgbm_tpu/boosting/gbdt.py
(reference src/boosting/gbdt.{h,cpp}): BoostFromAverage per class
(gbdt.cpp:302) -> objective gradients on the device from the iteration's
scores -> one tree per class (K = the objective's models per iteration,
num_class for multiclass) -> score update of the class's row through the
row -> leaf map -> shrinkage and the iteration-0 bias (gbdt.cpp:338-420).
A class with nothing to train (``class_need_train``) gets a constant tree.
Model text IO follows gbdt_model_text.cpp (SaveModelToString :301,
LoadModelFromString :385), K trees per iteration in class order, so the
two packages read each other's models. Prediction ([n] raw scores for K = 1
and [n, K] otherwise) runs the walk kernel on the card through a cached
:meth:`GBDT.device_predictor` (predict/runtime.py; the JAX package's
gbdt.py:1071-1093), or the numpy walk on the host for ``device="cpu"``.

When the learner takes the persistent-payload grower (its
``can_persist_scan``, decided once at init), every iteration goes through
the learner's payload (``train_persist``: for each class the gradient fill,
grow and score update on the payload, all from one snapshot of the scores)
and the row-ordered score buffer is synced from the payload only when
something reads it.

Validation sets (``add_valid_dataset``, the JAX package's gbdt.py:
139-152): each holds [K, n] f64 scores on the training device; every tree
with a split is added to them by the binned walk (ops/valid_walk.py, one
launch per tree and set on the card) from the leaf values after shrinkage
and before the iteration-0 bias, which is added to them as a constant, as
the JAX package's per-class path does (gbdt.py:154-172, 720-775). The
trees of an iteration are uploaded together, once, after the iteration's
one tree read; the per-split CUDA graph does not change.

Leaf renewal (L1, quantile, MAPE; the JAX package's gbdt.py:747-766):
each tree's leaf outputs are re-fit to a percentile of their rows'
residuals before its score update, on the device by the ``renew_leaf``
kernel (ops/renew.py): on the v1 grower from the row -> leaf map
(:meth:`GBDT._renew_v1`), on the persistent grower inside its iteration
from the leaf table's payload segments. Such an objective takes the JAX
package's per-class path (its stop rule and first-iteration constant
trees), as ``_fast_path_ok`` routes it.

Custom objectives (``train(fobj=)``, ``Booster.update(fobj=)``): the
gradients come from the host, one [K * n] pair per iteration, and the
objective is "none", so the learner takes the v1 grower and the iteration
the JAX package's per-class path (no BoostFromAverage, its stop rule).

Bagging (``bagging_fraction`` with ``bagging_freq``, balanced
``pos_``/``neg_bagging_fraction``) and GOSS (boosting/goss.py) sample rows
as the JAX package samples them on the grower the iteration runs on:
  * v1 grower (the JAX per-iteration path): the host draws of
    :meth:`GBDT.bagging` (gbdt.py:190-214; a numpy Generator seeded with
    ``bagging_seed``, one draw per ``bagging_freq`` window), the
    gradients multiplied by the bag's weights before the tree
    (gbdt.py:505-516, 692-703), the bag mask handed to the grower for its
    in-bag counts; leaf renewal from in-bag rows only (gbdt.py:747-765);
  * persistent grower (the JAX fused driver): a bag step on the device
    after each gradient fill (ops/bag.py), its window key
    ``fold_in(PRNGKey(bagging_seed), window)`` computed here per iteration
    (gbdt.py:_persist_bag_keys:449-466) and written into device scalars.
So the same run can bag differently in the two packages where the JAX
package picks its per-iteration path and the port its persistent grower
(a validation set, fewer than 16 rounds: ROADMAP.md C9).

DART (boosting/dart.py) and RF (boosting/rf.py) override the hooks below:
the stop rule (:meth:`GBDT._fast_path`), the route of a score delta
between iterations (:meth:`GBDT._add_score_delta`: the payload when the
persistent grower holds the scores, the f64 ScoreUpdater otherwise) and
``average_output`` (RF's model text and prediction divide by the number of
iterations). ``sub_model_name`` is the model text's first line.

Between iterations (the JAX package's gbdt.py:230-280, 775-831):
:meth:`GBDT.reset_config` takes the learning rate, the split keys and the
bagging keys and decides the route again; :meth:`GBDT.rollback_one_iter`
walks the last iteration's trees, negated, onto the scores where they live
and drops them; :meth:`GBDT.refit` fits every leaf output again to new rows
with the per-leaf sums on the device (ops/refit.py).

Not in this slice (ROADMAP.md queue A): the K-iteration fused scan, which
the JAX package runs in batches of 16 iterations on its persistent path (a
CUDA graph per iteration in the port, item 15).
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

import numpy as np
import torch

from ..config import _BY_NAME, Config, alias_transform
from ..models.tree import Tree
from ..objectives import parse_objective_string
from ..ops.bag import bag_iteration
from ..ops.valid_walk import pack
from ..treelearner.serial import (SerialTreeLearner, bag_configured,
                                  check_v1_layout)
from ..utils.log import Log
from .score_updater import ScoreUpdater, ValidScoreUpdater

K_EPSILON = 1e-15
K_MODEL_VERSION = "v3"


class GBDT:
    """Gradient Boosting Decision Tree driver (gbdt.h), K trees per
    iteration."""

    # the model text's first line (the JAX package's gbdt.py:1229)
    sub_model_name = "tree"
    # RF: the model's output is the mean of its iterations' trees
    average_output = False

    def __init__(self):
        self.config: Optional[Config] = None
        self.train_data = None
        self.objective = None
        self.models: List[Tree] = []
        self.iter = 0
        self.num_class = 1
        self.num_tree_per_iteration = 1
        self.class_need_train: List[bool] = [True]
        self.shrinkage_rate = 0.1
        self.max_feature_idx = 0
        self.label_idx = 0
        self.feature_names: List[str] = []
        self.feature_infos: List[str] = []
        self.monotone_constraints: List[int] = []
        self.train_score: Optional[ScoreUpdater] = None
        self.use_persist = False
        self.valid_score: List[ValidScoreUpdater] = []
        self.valid_metrics: List[list] = []
        self.valid_names: List[str] = []
        self._finished = False
        # device predictors by (iteration range, model size, device)
        self._predictors: Dict[tuple, object] = {}

    # ------------------------------------------------------------------
    def init(self, config: Config, train_data, objective, device) -> None:
        self.config = config
        self.train_data = train_data
        self.objective = objective
        self.iter = 0
        self.num_class = int(config.num_class)
        K = self.num_tree_per_iteration = (
            objective.num_model_per_iteration if objective is not None
            else self.num_class)
        self.class_need_train = [
            objective is None or objective.class_need_train(k)
            for k in range(K)]
        self.shrinkage_rate = float(config.learning_rate)
        self.device = device
        self.valid_score, self.valid_metrics, self.valid_names = [], [], []
        self._finished = False
        self.tree_learner = SerialTreeLearner(config, train_data, device)
        self.max_feature_idx = train_data.num_total_features - 1
        self.feature_names = list(train_data.feature_names)
        self.feature_infos = [self._feature_info(m)
                              for m in train_data.bin_mappers]
        self.monotone_constraints = list(config.monotone_constraints)
        self.train_score = ScoreUpdater(train_data.num_data, device,
                                        train_data.metadata.init_score, K)
        self.use_persist = (objective is not None
                            and self.tree_learner.can_persist_scan(objective))
        if not self.use_persist:
            check_v1_layout(train_data)
        # the v1 grower's bag: a [n] bool mask and GOSS's [n] f32 weights on
        # the device (None: every row, weight 1); the plan itself is set by
        # _refresh_bagging_config (the ResetBaggingConfig analog)
        self._bag_mask = None
        self._bag_weight = None
        self._refresh_bagging_config()

    @staticmethod
    def _feature_info(mapper) -> str:
        """Dataset::get feature_infos: [min:max], or the categories joined
        by ':' (the JAX package's gbdt.py:128-136)."""
        if mapper.is_trivial:
            return "none"
        if mapper.is_categorical:
            return ":".join(str(c) for c in sorted(
                c for c in mapper.bin_2_categorical if c >= 0))
        return "[%s:%s]" % (repr(float(mapper.min_val)),
                            repr(float(mapper.max_val)))

    def add_valid_dataset(self, valid_data, valid_metrics,
                          name: str = "valid") -> None:
        """A validation set (a BinnedDataset binned like the training set)
        with its metrics; the trees so far are walked onto its scores
        (the JAX package's gbdt.py:139-152)."""
        su = ValidScoreUpdater(valid_data, self.num_tree_per_iteration,
                               self.device)
        for m in valid_metrics:
            m.init(valid_data.metadata, valid_data.num_data, self.device)
        self.valid_score.append(su)
        self.valid_metrics.append(list(valid_metrics))
        self.valid_names.append(name)
        K = self.num_tree_per_iteration
        packed = pack(self.models, [t.leaf_value[:max(t.num_leaves, 1)]
                                    for t in self.models],
                      self.train_data, self.device) if self.models else []
        for i, pt in enumerate(packed):
            su.add_tree(pt, i % K)

    def _fast_path(self) -> bool:
        """The JAX package's ``_fast_path_ok`` (gbdt.py:311-324) for the
        port's objectives: no leaf renewal, every class trainable and no
        validation set. (Its training-metric term is always false under
        ``train``: the Booster gives its GBDT no training metrics.)"""
        return (self.objective is not None
                and not self.objective.is_renew_tree_output
                and all(self.class_need_train) and not self.valid_score)

    def boost_from_average(self, class_id: int) -> float:
        """gbdt.cpp:302-336: the constant class `class_id` starts from,
        added to the training and validation scores."""
        if (not self.models and not self.train_score.has_init_score
                and self.objective is not None):
            if (self.config.boost_from_average
                    or self.train_data.num_features == 0):
                init_score = self.objective.boost_from_score(class_id)
                if abs(init_score) > K_EPSILON:
                    self.train_score.add_const(init_score, class_id)
                    for su in self.valid_score:
                        su.add_const(init_score, class_id)
                    Log.info("Start training from score %f" % init_score)
                    return init_score
            elif self.objective.name in ("regression_l1", "quantile",
                                         "mape"):
                Log.warning("Disabling boost_from_average in %s may cause "
                            "the slow convergence" % self.objective.name)
        return 0.0

    # the split keys GBDT::ResetConfig hands to the learner (the JAX
    # package's _RESET_SPLIT, gbdt.py:220-225)
    _RESET_SPLIT = frozenset({
        "lambda_l1", "lambda_l2", "min_data_in_leaf",
        "min_sum_hessian_in_leaf", "min_gain_to_split", "max_delta_step",
        "num_leaves", "max_depth", "extra_trees", "feature_fraction",
        "feature_fraction_bynode", "cat_smooth", "cat_l2",
        "max_cat_threshold", "min_data_per_group", "max_cat_to_onehot"})
    # the bagging keys GBDT::ResetConfig re-applies (the JAX package's
    # _RESET_BAG, gbdt.py:226-229)
    _RESET_BAG = frozenset({
        "bagging_fraction", "bagging_freq", "pos_bagging_fraction",
        "neg_bagging_fraction", "bagging_seed"})

    def reset_config(self, updates: dict) -> None:
        """GBDT::ResetConfig (gbdt.cpp:704) between iterations, for the
        learning rate, the split keys and the bagging keys (the JAX
        package's reset_config, gbdt.py:230-280).

        A split key re-derives the learner's split parameters and grow
        configuration (SerialTreeLearner.refresh_config), then the route is
        decided again, as the JAX package decides it at every batch
        (gbdt.py:417-434): under ``tpu_persist_scan=auto`` a reset that
        turns on a knob the persistent grower does not take (``lambda_l1``,
        ``max_delta_step``, ``extra_trees``, ``feature_fraction_bynode``)
        moves the remaining iterations to the v1 grower, the payload's
        scores synced to row order first (_sync_persist_scores,
        gbdt.py:468); under ``force`` it raises (ROADMAP.md queue A, item
        4, step 1c). On the persistent grower a scalar key rebuilds the
        step constants and a new leaf budget or depth rebuilds the grower
        on the same payload; either way the next iteration captures a new
        CUDA graph.

        A bagging key re-plans the bag as _refresh_bagging_config does,
        with a new draw at the next iteration. On the persistent grower the
        bag's fractions, seed and window are device scalars written before
        every iteration, so the captured graph stays; turning the bag on or
        off changes the iteration's steps, and the grower captures a new
        graph. Any other key raises: it shapes state built once (the
        objective, the binning), and the JAX package ignores it with a
        warning. A refused reset leaves the booster as it was."""
        updates = alias_transform(dict(updates))
        other = sorted(k for k in updates if k != "learning_rate"
                       and k not in self._RESET_BAG
                       and k not in self._RESET_SPLIT)
        if other:
            Log.fatal("reset_config: %s cannot change during training (the "
                      "JAX package ignores it with a warning)"
                      % ", ".join(other))
        cfg = self.config
        new = {k: cfg._coerce(_BY_NAME[k], v) for k, v in updates.items()}
        old = {k: getattr(cfg, k) for k in new}
        shrink, was = self.shrinkage_rate, self.use_persist
        for k, v in new.items():
            setattr(cfg, k, v)
        if "learning_rate" in new:
            self.shrinkage_rate = float(cfg.learning_rate)
        if self.train_data is None:
            # a model read from text: no learner or bag to refresh
            return
        split = bool(self._RESET_SPLIT & set(new))
        bag = bool(self._RESET_BAG & set(new))
        try:
            if split:
                self._invalidate_predictors()
                self.tree_learner.refresh_config(cfg)
                self._reroute()
            if (bag and self.use_persist and bag_configured(cfg)
                    and self.objective.is_renew_tree_output):
                Log.fatal("reset_config: bagging with leaf renewal on the "
                          "persistent grower is not ported yet (ROADMAP.md "
                          "queue A, item 24); train with "
                          "tpu_persist_scan=false")
        except Exception:
            # a refused reset leaves the booster as it was
            for k, v in old.items():
                setattr(cfg, k, v)
            self.shrinkage_rate = shrink
            if split:
                self.tree_learner.refresh_config(cfg)
            self.use_persist = was
            raise
        if bag:
            self._refresh_bagging_config()

    def _reroute(self) -> None:
        """The grower after a split key reset, as the learner's gate
        decides it now (``force`` raises where the persistent grower cannot
        take the configuration, before anything changes). Leaving the
        persistent grower brings the payload's scores back to row order and
        drops the payload; coming back seeds a fresh payload from the
        row-ordered scores at the next iteration."""
        learner = self.tree_learner
        use = (self.objective is not None
               and learner.can_persist_scan(self.objective))
        if not use:
            check_v1_layout(self.train_data)
        if self.use_persist and not use:
            self.train_score.score              # the payload's scores, synced
            learner.drop_persist()
            Log.info("reset_config: %s move training to the v1 grower (the "
                     "persistent grower does not take them)"
                     % ", ".join(learner.knobs))
        self.use_persist = use

    # ---- bagging (the v1 grower's host draws) -----------------------------
    def _refresh_bagging_config(self) -> None:
        """GBDT::ResetBaggingConfig (gbdt.cpp:762-800; the JAX package's
        gbdt.py:282-309): the bag plan from the config, a fresh numpy
        Generator from bagging_seed, and a new draw at the next
        iteration."""
        cfg = self.config
        n = self.train_data.num_data
        self._bagging_rng = np.random.default_rng(cfg.bagging_seed)
        self.balanced_bagging = False
        self.bag_data_cnt = n
        bag_on = False
        if cfg.bagging_fraction < 1.0 and cfg.bagging_freq > 0:
            self.bag_data_cnt = max(1, int(cfg.bagging_fraction * n))
            bag_on = True
        if cfg.pos_bagging_fraction < 1.0 or cfg.neg_bagging_fraction < 1.0:
            if cfg.bagging_freq <= 0:
                Log.warning("pos/neg bagging needs bagging_freq > 0")
            else:
                self.balanced_bagging = True
                self.bag_data_cnt = 0
                bag_on = True
        self.need_re_bagging = bag_on
        if not bag_on:
            self._bag_mask = None
            self._bag_weight = None

    def bagging(self, it: int, grad=None, hess=None) -> None:
        """GBDT::Bagging (gbdt.cpp:210-244; the JAX package's gbdt.py:
        190-214): a new bag mask at the start of every bagging_freq window
        (or after a reset), u < bagging_fraction (balanced: the fraction of
        the row's label sign) from the numpy Generator; one row when the bag
        would be empty. `grad`/`hess` ([K, n]) are GOSS's."""
        mask = self._draw_bag(it)
        if mask is not None:
            self._bag_mask = torch.as_tensor(mask, device=self.device)
            self._bag_weight = None

    def _draw_bag(self, it: int):
        """The host draw of :meth:`bagging`: the new [n] bool numpy mask,
        or None when iteration `it` keeps the last one."""
        cfg = self.config
        do_bag = (self.bag_data_cnt < self.train_data.num_data
                  or self.balanced_bagging)
        if not ((do_bag and cfg.bagging_freq > 0
                 and it % cfg.bagging_freq == 0) or self.need_re_bagging):
            return None
        self.need_re_bagging = False
        n = self.train_data.num_data
        u = self._bagging_rng.random(n)
        if self.balanced_bagging:
            pos = self.train_data.metadata.label > 0
            mask = np.where(pos, u < cfg.pos_bagging_fraction,
                            u < cfg.neg_bagging_fraction)
        else:
            mask = u < cfg.bagging_fraction
        self.bag_data_cnt = int(mask.sum())
        if self.bag_data_cnt == 0:
            mask[self._bagging_rng.integers(n)] = True
            self.bag_data_cnt = 1
        Log.debug("Re-bagging, using %d data to train" % self.bag_data_cnt)
        return mask

    def bag_spec(self):
        """The persistent grower's bag step (the JAX package's
        _persist_bag_spec, gbdt.py:327-337): ("bagging", fraction,
        pos_fraction, neg_fraction), or ("none",)."""
        cfg = self.config
        if cfg.bagging_freq > 0 and self.balanced_bagging:
            return ("bagging", 1.0, float(cfg.pos_bagging_fraction),
                    float(cfg.neg_bagging_fraction))
        if cfg.bagging_freq > 0 and cfg.bagging_fraction < 1.0:
            return ("bagging", float(cfg.bagging_fraction), 1.0, 1.0)
        return ("none",)

    def _persist_bag(self):
        """This iteration's bag step on the persistent grower (None without
        one): the window key folded from bagging_seed at it //
        bagging_freq (GOSS: at it), the fractions or GOSS's constants."""
        spec = self.bag_spec()
        if spec[0] == "none":
            return None
        cfg = self.config
        return bag_iteration(spec, cfg.bagging_seed, cfg.bagging_freq,
                             self.iter, self.train_data.num_data,
                             int(1.0 / float(cfg.learning_rate)))

    def _bagged(self, g, h):
        """g, h of one class times the bag's weights (GOSS) or mask, in
        their dtype's promotion with f32, as the JAX package multiplies
        (gbdt.py:505-516); unchanged without a bag."""
        if self._bag_weight is not None:
            return g * self._bag_weight, h * self._bag_weight
        if self._bag_mask is not None:
            m = self._bag_mask.to(g.dtype)
            return g * m, h * m
        return g, h

    def _grow(self, classes, gradients=None):
        """The TreeArrays of this iteration's tree of each class in
        `classes`, every score row updated; `gradients` = the host's
        (grad, hess) [K, n] tensors of a custom objective."""
        if self.use_persist:
            learner = self.tree_learner
            out = learner.train_persist(
                self.objective, lambda: self.train_score.score,
                self.shrinkage_rate, classes, self._persist_bag())
            self.train_score.defer_to(learner.persist_finalize_scores)
            return out
        if gradients is not None:
            grad, hess = gradients
        else:
            grad, hess = self.objective.get_gradients(self.train_score.score)
            if self.num_tree_per_iteration == 1:
                grad, hess = grad[None], hess[None]
        self.bagging(self.iter, grad, hess)
        out = []
        for k in classes:
            g, h = self._bagged(grad[k], hess[k])
            arrays, row_leaf = self.tree_learner.train_arrays(
                g, h, self._bag_mask)
            if arrays.num_leaves > 1:
                if (self.objective is not None
                        and self.objective.is_renew_tree_output):
                    arrays = self._renew_v1(arrays, row_leaf, k)
                self.train_score.add_tree(
                    arrays.leaf_value[:arrays.num_leaves], row_leaf,
                    self.shrinkage_rate, k)
            out.append(arrays)
        return out

    def _renew_v1(self, arrays, row_leaf, class_id: int, score=None):
        """The v1 tree's leaf outputs re-fit from its in-bag rows (the JAX
        package's _renew_tree_output, gbdt.py:747-766): the rows grouped
        by leaf through the row -> leaf map (out-of-bag rows under a key
        past the last leaf, outside every segment), the f64 training
        scores before the tree's update (`score`, an [n] f64 row, in their
        place: RF's constant), one renew_leaf launch; the renewed f64
        values are read back once and replace the grower's f32 leaf
        values. A leaf without in-bag rows keeps its value."""
        L = arrays.num_leaves
        key = row_leaf.to(torch.int64)
        if self._bag_mask is not None:
            key = torch.where(self._bag_mask, key, L)
        count = torch.zeros(L + 1, dtype=torch.int64, device=key.device) \
            .scatter_add_(0, key, torch.ones_like(key))[:L]
        seg = torch.stack([torch.cumsum(count, 0) - count, count], 1)
        value = torch.as_tensor(
            np.asarray(arrays.leaf_value[:L], np.float64), device=key.device)
        if score is None:
            score = self.train_score.score
            if self.num_tree_per_iteration > 1:
                score = score[class_id]
        self.objective.renew_tree_output(score, key, seg, value)
        leaf_value = np.asarray(arrays.leaf_value, np.float64).copy()
        leaf_value[:L] = value.cpu().numpy()
        return arrays._replace(leaf_value=leaf_value)

    def _add_score_delta(self, packed, class_id: int) -> None:
        """Training score row `class_id` += a packed tree's leaf value of
        each row (ops/valid_walk.py:pack), where the scores live (the JAX
        package's DART._add_score_delta, dart.py:51-62): on the persistent
        grower's payload once it holds them (the f64 leaf value rounded to
        f32, one f32 add per lane), else on the f64 ScoreUpdater (one f64
        add per row)."""
        learner = self.tree_learner
        if self.use_persist and learner._persist_carry is not None:
            learner.persist_add_tree(packed, class_id)
            self.train_score.defer_to(learner.persist_finalize_scores)
        else:
            self.train_score.add_tree_walk(packed, class_id,
                                           learner.data.bins)

    def _add_const(self, val: float, class_id: int) -> None:
        """score row `class_id` += val, in the payload when it owns the
        scores."""
        if self.use_persist and self.tree_learner._persist_carry is not None:
            self.tree_learner.persist_add_const(val, class_id)
            self.train_score.defer_to(
                self.tree_learner.persist_finalize_scores)
        else:
            self.train_score.add_const(val, class_id)

    def train_one_iter(self, gradients=None, hessians=None) -> bool:
        """One boosting iteration, one tree per class; True when training
        should STOP (no splittable leaves), mirroring gbdt.cpp:338-420.
        `gradients`/`hessians`: a custom objective's [K * n] host arrays
        (class-major), which take the per-class path without
        BoostFromAverage (the JAX package's gbdt.py:680-689).
        Once it has stopped, a later call returns True at once: the JAX
        package's later iterations would grow the same stubs and drop them.

        The stop rule is the JAX package's, chosen as its ``_fast_path_ok``
        chooses its path (:meth:`_fast_path`). On its fast path (every
        class trainable, no validation set, gbdt.py:535-647) the first
        iteration stops only when no class split, and a later one when any
        class did not (its trees are dropped). On its per-class path (a
        validation set, or a class with nothing to train; gbdt.py:670-745)
        an iteration stops when no class split, and at the first iteration
        each class without a split gets a constant tree whose value is
        added to its scores again: its BoostFromScore for a class with
        nothing to train, else the class's init score (gbdt.cpp:396-411).
        On the fast path only the class with nothing to train adds it.
        The trees with a split are walked onto the validation scores from
        their leaf values after shrinkage, before the init-score bias
        (gbdt.py:720-775)."""
        custom = gradients is not None and hessians is not None
        if self.objective is None and not custom:
            Log.fatal("No objective function provided")
        self._invalidate_predictors()
        if self._finished:
            return True
        K = self.num_tree_per_iteration
        first = not self.models
        fast = self._fast_path() and not custom
        if custom and self.use_persist:
            Log.fatal("custom gradients train on the v1 grower, and this "
                      "Booster's objective took the persistent one: train "
                      "with objective=none (train(fobj=) sets it) or "
                      "tpu_persist_scan=false")
        if custom:
            n = self.train_data.num_data
            init_scores = [0.0] * K
            given = tuple(torch.as_tensor(np.asarray(a, np.float32)
                                          .reshape(K, n), device=self.device)
                          for a in (gradients, hessians))
        else:
            init_scores = [self.boost_from_average(k) for k in range(K)]
            given = None
        classes = ([k for k in range(K) if self.class_need_train[k]]
                   if self.train_data.num_features > 0 else [])
        trees = [None] * K
        if classes:
            for k, arrays in zip(classes, self._grow(classes, given)):
                if arrays.num_leaves > 1:
                    trees[k] = Tree.from_grower(arrays, self.train_data)
        grew = [trees[k] is not None for k in classes]
        stop = not all(grew) if fast and not first else not any(grew)
        if stop and not first:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            self._finished = True
            return True
        grown = [(k, t) for k, t in enumerate(trees) if t is not None]
        for _, tree in grown:
            tree.shrink(self.shrinkage_rate)
        if self.valid_score and grown:
            packed = pack([t for _, t in grown],
                          [t.leaf_value[:t.num_leaves] for _, t in grown],
                          self.train_data, self.device)
            for su in self.valid_score:
                for (k, _), pt in zip(grown, packed):
                    su.add_tree(pt, k)
        for k, tree in enumerate(trees):
            if tree is not None:
                if abs(init_scores[k]) > K_EPSILON:
                    tree.add_bias(init_scores[k])
            else:
                # a constant tree, kept at the start (gbdt.cpp:396-411)
                tree = Tree(1)
                if first:
                    trainable = self.class_need_train[k]
                    tree.leaf_value[0] = (
                        init_scores[k] if trainable
                        else self.objective.boost_from_score(k))
                    if not trainable or not fast:
                        self._add_const(tree.leaf_value[0], k)
                        for su in self.valid_score:
                            su.add_const(tree.leaf_value[0], k)
            self.models.append(tree)
        if stop:
            Log.warning("Stopped training because there are no more leaves "
                        "that meet the split requirements")
            self._finished = True
            return True
        self.iter += 1
        return False

    # ------------------------------------------------------------------
    def _used_models(self, start_iteration=0, num_iteration=-1):
        """The trees of iterations [start, start + num_iteration)."""
        K = self.num_tree_per_iteration
        total = len(self.models) // K
        start = max(0, min(int(start_iteration), total))
        end = (min(start + int(num_iteration), total)
               if num_iteration is not None and num_iteration > 0 else total)
        return self.models[start * K:end * K]

    def predict_raw(self, X: np.ndarray, start_iteration=0,
                    num_iteration=-1) -> np.ndarray:
        """Raw scores (PredictRaw) by the numpy walk: [N] for one tree per
        iteration, else [N, K] (tree i adds to class i % K); an averaged
        model divides by its number of iterations (gbdt.py:1146-1148)."""
        X = np.ascontiguousarray(X, dtype=np.float64)
        K = self.num_tree_per_iteration
        out = np.zeros((X.shape[0], K))
        models = self._used_models(start_iteration, num_iteration)
        for i, tree in enumerate(models):
            out[:, i % K] += tree.predict(X)
        if self.average_output:
            out /= max(len(models) // K, 1)
        return out[:, 0] if K == 1 else out

    def _invalidate_predictors(self) -> None:
        """Drop the device predictors: the model changed (a new iteration,
        DART rescaling earlier trees, a loaded model)."""
        self._predictors.clear()

    def _predict_device(self, device) -> torch.device:
        """The torch device of a kernel prediction: ``cuda`` is the
        training card (or the current one), anything else as given."""
        from ..predict.runtime import predict_device
        dev = torch.device(device)
        if dev.type == "cuda" and dev.index is None:
            trained = getattr(self, "device", None)
            if trained is not None and torch.device(trained).type == "cuda":
                dev = torch.device(trained)
        return predict_device(dev)

    def device_predictor(self, start_iteration=0, num_iteration=-1,
                         device="cuda"):
        """The predictor (predict/runtime.py:CudaPredictor) of the trees of
        iterations [start, start + num_iteration) on `device`, cached per
        (range, model size, device, dtype) while the model is unchanged.
        ``tpu_predict_dtype`` sets its dtype."""
        from ..predict import (CudaPredictor, EnsembleCompileError,
                               compile_ensemble)
        dev = self._predict_device(device)
        cfg = self.config
        dtype = str(getattr(cfg, "tpu_predict_dtype", "f64")) \
            if cfg is not None else "f64"
        key = (int(start_iteration), int(num_iteration), len(self.models),
               str(dev), dtype)
        pred = self._predictors.get(key)
        if pred is None:
            try:
                ens = compile_ensemble(
                    self._used_models(start_iteration, num_iteration),
                    self.num_tree_per_iteration, self.average_output,
                    self.max_feature_idx)
            except EnsembleCompileError as exc:
                # no quiet host fallback (the JAX package's
                # _predict_device_or_none walks on the host here)
                raise EnsembleCompileError(
                    "%s; predict_device=cpu predicts with the numpy walk"
                    % exc) from exc
            pred = CudaPredictor(ens, self.objective, dtype=dtype,
                                 device=dev)
            if len(self._predictors) >= 8:
                self._predictors.clear()
            self._predictors[key] = pred
        return pred

    def _nothing_to_walk(self, device, start_iteration,
                         num_iteration) -> bool:
        """True when a kernel prediction selects no tree (the device is
        still resolved: no card raises)."""
        self._predict_device(device)
        return not self._used_models(start_iteration, num_iteration)

    def predict(self, X: np.ndarray, raw_score=False, start_iteration=0,
                num_iteration=-1, device="cpu") -> np.ndarray:
        """predict_raw through the objective's ConvertOutput (softmax per
        row for multiclass, a sigmoid per class for one-vs-all): by the
        numpy walk for ``device="cpu"``, else by the walk kernel on
        `device` (``cuda``: the card), the objective's conversion there
        too. A range without trees gives the numpy
        walk's answer (zeros through the conversion) on either route."""
        if device != "cpu" and not self._nothing_to_walk(
                device, start_iteration, num_iteration):
            return self.device_predictor(
                start_iteration, num_iteration, device).predict(
                    X, raw_score=raw_score)
        raw = self.predict_raw(X, start_iteration, num_iteration)
        if not raw_score and self.objective is not None:
            return self.objective.convert_output(raw)
        return raw

    def predict_leaf_index(self, X: np.ndarray, start_iteration=0,
                           num_iteration=-1, device="cpu") -> np.ndarray:
        """[n, T] int32 leaf indices of the selected trees (pred_leaf), by
        the walk kernel on `device`, or the numpy walk for ``cpu``."""
        if device != "cpu" and not self._nothing_to_walk(
                device, start_iteration, num_iteration):
            return self.device_predictor(
                start_iteration, num_iteration, device).predict_leaf(X)
        X = np.ascontiguousarray(X, dtype=np.float64)
        models = self._used_models(start_iteration, num_iteration)
        out = np.zeros((X.shape[0], len(models)), dtype=np.int32)
        for i, tree in enumerate(models):
            out[:, i] = tree.predict_leaf(X)
        return out

    def feature_importance(self, importance_type: str = "split",
                           num_iteration: int = -1) -> np.ndarray:
        """GBDT::FeatureImportance (gbdt_model_text.cpp:363-400; the JAX
        package's gbdt.py:1207-1221): per feature, the number of splits
        with a positive gain ("split") or the sum of their gains ("gain"),
        over the first `num_iteration` iterations (<= 0: all)."""
        if importance_type not in ("split", "gain"):
            Log.fatal("Unknown importance type: only support split=0 and "
                      "gain=1")
        imp = np.zeros(self.max_feature_idx + 1)
        for tree in self._used_models(0, num_iteration):
            for k in range(tree.num_leaves - 1):
                if tree.split_gain[k] > 0:
                    imp[tree.split_feature[k]] += (
                        1.0 if importance_type == "split"
                        else tree.split_gain[k])
        return imp

    def dump_model(self, start_iteration=0, num_iteration=-1) -> dict:
        """GBDT::DumpModel's JSON (gbdt_model_text.cpp:21-92; the JAX
        package's gbdt.py:1407-1428)."""
        return {
            "name": "tree",
            "version": K_MODEL_VERSION,
            "num_class": self.num_class,
            "num_tree_per_iteration": self.num_tree_per_iteration,
            "label_index": self.label_idx,
            "max_feature_idx": self.max_feature_idx,
            "objective": (self.objective.to_string()
                          if self.objective else ""),
            "average_output": self.average_output,
            "feature_names": self.feature_names,
            "monotone_constraints": self.monotone_constraints,
            "tree_info": [t.to_json() for t in self._used_models(
                start_iteration, num_iteration)],
            "feature_importances": {
                self.feature_names[i]: float(v)
                for i, v in enumerate(self.feature_importance("split"))
                if v > 0},
        }

    def rollback_one_iter(self) -> None:
        """GBDT::RollbackOneIter (gbdt.cpp:422-438; the JAX package's
        gbdt.py:815-831): the last iteration's trees, negated, are walked
        onto the training scores where they live (the payload's f32 scores
        on the persistent grower, the f64 row-ordered ones on v1:
        :meth:`_add_score_delta`, DART's path) and onto every validation
        set, then dropped, and the persistent grower's statistics of them
        with them. Nothing happens at iteration 0. A model read from text
        has no scores: its trees are dropped."""
        self._invalidate_predictors()
        K = self.num_tree_per_iteration
        if self.current_iteration <= 0:
            return
        if self.average_output:
            Log.fatal("rollback_one_iter of an averaged (RF) model is not "
                      "supported: its scores are a running mean")
        trees = self.models[-K:]
        if self.train_data is not None:
            packed = pack(trees, [-t.leaf_value[:max(t.num_leaves, 1)]
                                  for t in trees], self.train_data,
                          self.device)
            for k, pt in enumerate(packed):
                self._add_score_delta(pt, k)
                for su in self.valid_score:
                    su.add_tree(pt, k)
        del self.models[-K:]
        gr = self.tree_learner._persist_gr if self.use_persist else None
        if gr is not None:
            del gr.grow_stats[-K:]
        self.iter = max(self.iter - 1, 0)
        self._finished = False

    def refit(self, X: np.ndarray, decay_rate: float = 0.9) -> None:
        """GBDT::RefitTree (gbdt.cpp:267 with FitByExistingTree and
        CalculateSplittedLeafOutput; the JAX package's gbdt.py:775-813):
        every tree keeps its structure, and its leaf outputs are fit
        again to the rows of `X` (this GBDT's training rows, whose labels
        the objective holds), iteration after iteration from zero scores.
        For each tree: the objective's gradients at the staged f64 scores
        (on the device), rounded to f32, the precision the growers take
        them in (torch's f64 ``exp`` differs between the card and the CPU
        in the last bit, and the rounding keeps the two refits equal; the
        JAX package sums its f64 gradients, so the packages differ by that
        rounding, ROADMAP.md C4), each row's leaf (predict_walk's leaf
        mode, all trees in one launch), per-leaf f64 sums of grad, hess
        and rows (the leaf_sums kernel, ops/refit.py), then on the host the
        L1 threshold, the max_delta_step clamp, the shrinkage and the
        ``decay_rate`` blend with the old output, as the JAX package does
        them; the tree's new outputs are added to the staged scores."""
        from ..ops.refit import per_leaf_sums
        if self.objective is None:
            Log.fatal("Cannot refit a booster without an objective")
        self._invalidate_predictors()
        X = np.ascontiguousarray(X, dtype=np.float64)
        n, K = X.shape[0], self.num_tree_per_iteration
        cfg = self.config
        lam1, lam2 = float(cfg.lambda_l1), float(cfg.lambda_l2)
        mds = float(cfg.max_delta_step)
        leaves = self._walk_leaves(X)                      # [T, n] int32
        dev = leaves.device
        score = torch.zeros((K, n), dtype=torch.float64, device=dev)
        for it in range(len(self.models) // K):
            g, h = self.objective.get_gradients(score[0] if K == 1
                                                else score)
            g = g.reshape(K, n).to(torch.float32)
            h = h.reshape(K, n).to(torch.float32)
            for k in range(K):
                j = it * K + k
                tree = self.models[j]
                nl = max(tree.num_leaves, 1)
                sums = per_leaf_sums(leaves[j], g[k], h[k], nl) \
                    .cpu().numpy()
                sg, sh = sums[:, 0], sums[:, 1]
                thr = np.sign(sg) * np.maximum(0.0, np.abs(sg) - lam1)
                out = -thr / (sh + lam2 + 1e-15)
                if mds > 0:
                    out = np.sign(out) * np.minimum(np.abs(out), mds)
                out *= self.shrinkage_rate
                old = tree.leaf_value[:nl]
                tree.leaf_value[:nl] = (decay_rate * old
                                        + (1 - decay_rate) * out)
                tree.leaf_count[:nl] = sums[:, 2].astype(np.int32)
                value = torch.as_tensor(tree.leaf_value[:nl], device=dev)
                score[k] += value[leaves[j].long()]
        self.iter = len(self.models) // K

    def _walk_leaves(self, X: np.ndarray) -> torch.Tensor:
        """[T, n] int32 leaf of every row of `X` under each tree, by
        predict_walk's leaf mode over f64 rows on this GBDT's device (the
        plain walk on the CPU), kept there."""
        from ..ops.predict import predict_walk
        from ..predict import CudaPredictor, compile_ensemble
        ens = compile_ensemble(self.models, self.num_tree_per_iteration,
                               self.average_output, self.max_feature_idx)
        pred = CudaPredictor(ens, None, dtype="f64", device=self.device)
        X_dev = torch.from_numpy(X).to(pred.device)
        return predict_walk(X_dev, pred.walk, pred.num_class,
                            leaf=True).t().contiguous()

    # ------------------------------------------------------------------
    def save_model_to_string(self, start_iteration=0, num_iteration=-1) -> str:
        buf = [self.sub_model_name,
               "version=%s" % K_MODEL_VERSION,
               "num_class=%d" % self.num_class,
               "num_tree_per_iteration=%d" % self.num_tree_per_iteration,
               "label_index=%d" % self.label_idx,
               "max_feature_idx=%d" % self.max_feature_idx]
        if self.objective is not None:
            buf.append("objective=%s" % self.objective.to_string())
        if self.average_output:
            buf.append("average_output")
        buf.append("feature_names=%s" % " ".join(self.feature_names))
        if self.monotone_constraints:
            buf.append("monotone_constraints=%s" % " ".join(
                str(int(m)) for m in self.monotone_constraints))
        buf.append("feature_infos=%s" % " ".join(self.feature_infos))
        models = self._used_models(start_iteration, num_iteration)
        tree_strs = ["Tree=%d\n%s\n" % (i, t.to_string())
                     for i, t in enumerate(models)]
        buf.append("tree_sizes=%s" % " ".join(str(len(s)) for s in tree_strs))
        buf.append("")
        text = "\n".join(buf) + "\n" + "".join(tree_strs) + "end of trees\n"
        imp = self.feature_importance("split", num_iteration)
        pairs = sorted(((int(imp[i]), self.feature_names[i])
                        for i in range(len(imp)) if imp[i] > 0),
                       key=lambda p: -p[0])
        text += "\nfeature importances:\n"
        text += "".join("%s=%d\n" % (name, v) for v, name in pairs)
        params = ""
        if self.config is not None:
            params = json.dumps({k: v for k, v in self.config.to_dict().items()
                                 if not callable(v)}, default=str)
        text += "\nparameters:\n%s\nend of parameters\n" % params
        return text

    def load_model_from_string(self, text: str) -> None:
        """GBDT::LoadModelFromString (gbdt_model_text.cpp:385+)."""
        self._invalidate_predictors()
        self.models = []
        lines = text.splitlines()
        kv: Dict[str, str] = {}
        i = 0
        while i < len(lines):
            line = lines[i].strip()
            if line.startswith("Tree="):
                break
            if "=" in line:
                k, v = line.split("=", 1)
                kv[k] = v
            elif line:
                kv[line] = ""
            i += 1
        if "num_class" not in kv:
            Log.fatal("Model file doesn't specify the number of classes")
        self.num_class = int(kv["num_class"])
        self.num_tree_per_iteration = int(
            kv.get("num_tree_per_iteration", self.num_class))
        self.average_output = "average_output" in kv
        self.label_idx = int(kv.get("label_index", 0))
        self.max_feature_idx = int(kv.get("max_feature_idx", 0))
        self.feature_names = kv.get("feature_names", "").split()
        self.feature_infos = kv.get("feature_infos", "").split()
        if "monotone_constraints" in kv:
            self.monotone_constraints = [
                int(x) for x in kv["monotone_constraints"].split()]
        if kv.get("objective"):
            cfg = self.config if self.config is not None else Config({})
            self.objective = parse_objective_string(kv["objective"], cfg)
        blocks: List[List[str]] = []
        cur: List[str] = []
        for line in lines[i:]:
            if line.startswith("Tree="):
                if cur:
                    blocks.append(cur)
                cur = []
            elif line.strip() == "end of trees":
                if cur:
                    blocks.append(cur)
                break
            else:
                cur.append(line)
        self.models = [Tree.from_string("\n".join(b)) for b in blocks]
        self.iter = len(self.models) // self.num_tree_per_iteration

    @property
    def current_iteration(self) -> int:
        return len(self.models) // self.num_tree_per_iteration
