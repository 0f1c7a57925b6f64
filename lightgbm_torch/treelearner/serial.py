"""Serial (single-device) tree learner of the port.

The port of lightgbm_tpu/treelearner/serial.py on its fast path: it owns the
dataset's device layout, samples features per tree (ColSampler,
src/treelearner/col_sampler.hpp), and grows trees with one of two growers,
both scanning splits with the ``scan_pair`` kernel:

  * the persistent-payload grower (ops/grow_persist.py), which
    :meth:`SerialTreeLearner.can_persist_scan` picks as the JAX package's
    gate does (serial.py:479-539): ``tpu_persist_scan=auto`` takes it on
    the card for 65536 rows or more, ``force`` on any device (on the CPU
    with the kernels' plain versions), ``off``/``false``/``0`` never. The
    payload, with the scores in it, stays on the learner between
    iterations (:meth:`train_persist`). ``tpu_level_grow`` routes its
    level phase (serial.py:550-554): ``auto`` runs it where
    ``can_level_grow`` holds (``max_depth`` in [1, 16]), ``off``/
    ``false``/``0`` never. EFB-bundled data train only here. Bagging of
    any kind and GOSS with one tree per iteration train here too, with
    the bag step on the device; GOSS with K > 1 trees per iteration and
    a leaf-renewal objective with a bag take the v1 grower under ``auto``
    (the JAX package runs them on its per-iteration path only) and raise
    under ``force``;
  * the v1 partitioned grower (ops/grow.py) otherwise, and always for
    the split scan's numerical knobs (``lambda_l1``, ``max_delta_step``,
    monotone constraints, ``extra_trees``, ``feature_fraction_bynode``),
    which the JAX package scans with its general XLA scan and so never on
    its persistent grower (``resolve_scan_impl``, serial.py:156-157,
    ``can_persist_scan``, :512). ``tpu_persist_scan=force`` with a knob
    raises: the JAX package's Pallas persistent scan would drop the knobs
    in silence (grow_persist.py:1190-1193). Categorical features train
    here too, under ``auto`` and ``force`` alike, as the JAX package's
    ``can_persist_scan`` (serial.py:529) sends them: scan_pair scans the
    numerical features and ``cat_scan`` the categorical ones.

DART trains on either grower as GBDT does. RF (always bagged: its host
draw is the bag) takes the persistent grower where the JAX package's
fused RF path runs it (rf.py:225-242: one tree per iteration, no init
score, the "payload" gradient mode) and the data suit it as GBDT's; with K
> 1, an init score or a "row"-mode objective it takes v1 under ``auto``
and raises under ``force`` (ROADMAP.md queue A, item 25).

The JAX package picks among more growers and scans (``resolve_scan_impl``,
serial.py:138-167). :func:`check_fast_path` refuses every configuration the
port's routes do not implement, naming the ROADMAP.md item that will bring
it, instead of running something else in silence.
"""
from __future__ import annotations

import numpy as np

import math

from ..config import Config
from ..objectives.base import PORTED
from ..ops.cat_scan import CatLayout, cat_params
from ..ops.grow import (CatScan, GrowConfig, Knobs, grow_tree_partitioned,
                        tb_source_index)
from ..ops.grow_persist import PersistGrower
from ..ops.payload import build_assets, persist_pack_ok
from ..ops.split import FeatureMeta, SplitParams
from ..utils import random as tf
from ..utils.log import Log

_SCAN_F64 = ("queue A, item 4, step 1b: f64 accumulation and "
             "tpu_scan_impl=xla")
_CEGB = "queue A, item 4, step 3: CEGB"
_KNOBS_PERSIST = ("queue A, item 4, step 1c: the numerical knobs on the "
                  "persistent grower")
_GOSS_MULTI = ("queue A, item 23: GOSS with K > 1 trees per iteration on the "
               "persistent grower")
_RENEW_BAG = ("queue A, item 24: leaf renewal with bagging or GOSS on the "
              "persistent grower")
_RF_PERSIST = ("queue A, item 25: RF beyond the JAX fused RF gate on the "
               "persistent grower")
# rows from which the JAX package takes the persistent grower on an
# accelerator (treelearner/serial.py:33)
PARTITION_MIN_ROWS = 65536


def _refuse(what: str, item: str) -> None:
    Log.fatal("%s is not ported yet (ROADMAP.md %s)" % (what, item))


def check_fast_path(config: Config, dataset) -> None:
    """Raise LightGBMError for any configuration outside this slice: the
    JAX package's fast-path gate (resolve_scan_impl) plus the slice's own
    limits."""
    c = config
    if c.objective not in PORTED + ("none",):
        _refuse("objective=%s" % c.objective,
                "queue A, item 17: other objectives")
    if c.tree_learner != "serial" or c.num_machines > 1:
        _refuse("tree_learner=%s" % c.tree_learner,
                "queue A, item 11: distributed training")
    if (float(c.cegb_penalty_split) > 0.0 or c.cegb_penalty_feature_coupled
            or c.cegb_penalty_feature_lazy):
        _refuse("cost-effective gradient boosting (cegb_*)", _CEGB)
    if bool(c.tpu_use_dp) or str(c.tpu_hist_dtype).lower() == "f64":
        _refuse("f64 accumulation (tpu_use_dp / tpu_hist_dtype=f64)",
                _SCAN_F64)
    if str(c.tpu_scan_impl).lower() == "xla":
        _refuse("tpu_scan_impl=xla", _SCAN_F64)
    if str(c.forcedsplits_filename):
        _refuse("forced splits (forcedsplits_filename)",
                "queue A, item 21: forced splits")
    if str(c.tpu_multival).lower() == "force":
        _refuse("tpu_multival=force",
                "queue A, item 2: binned dataset layouts")


def bynode_count(config: Config, num_features: int) -> int:
    """Features in each node's feature_fraction_bynode sample, 0 without
    one: the fraction of the by-tree sample's count, rounded up
    (ColSampler::GetByNode, col_sampler.hpp:90-140; the JAX package's
    serial.py:64-67)."""
    frac = float(config.feature_fraction_bynode)
    if frac >= 1.0:
        return 0
    by_tree = max(1, int(num_features * min(float(config.feature_fraction),
                                            1.0)))
    return int(math.ceil(frac * by_tree))


def scan_knobs(config: Config, dataset) -> list:
    """The split scan's numerical knobs this run sets, by name: each takes
    the JAX package's general scan (resolve_scan_impl, serial.py:156-157)."""
    c = config
    on = [("lambda_l1", float(c.lambda_l1) > 0.0),
          ("max_delta_step", float(c.max_delta_step) > 0.0),
          ("monotone_constraints", dataset.monotone is not None
           and bool(np.any(dataset.monotone))),
          ("extra_trees", bool(c.extra_trees)),
          ("feature_fraction_bynode", float(c.feature_fraction_bynode) < 1.0)]
    return [name for name, set_ in on if set_]


def bag_configured(config: Config) -> bool:
    """Does the run sample rows: bagging (a fraction below 1 with a
    bagging_freq, or balanced fractions with one) or GOSS?"""
    c = config
    return c.boosting in ("goss", "rf") or (c.bagging_freq > 0 and (
        c.bagging_fraction < 1.0 or c.pos_bagging_fraction < 1.0
        or c.neg_bagging_fraction < 1.0))


def check_v1_layout(dataset) -> None:
    """Raise for data the v1 grower cannot train: EFB bundles need
    FixHistogram in its scan, which only the persistent grower's
    scan_blocks has."""
    if dataset.has_bundles:
        _refuse("EFB bundles on the v1 grower (bundled data train on the "
                "persistent grower: tpu_persist_scan=force, or auto on the "
                "card from %d rows; enable_bundle=false avoids bundles)"
                % PARTITION_MIN_ROWS,
                "queue A, item 2: binned dataset layouts")


def cat_scan_setup(config: Config, dataset, params, device, use_mc: bool):
    """The grower's CatScan of a dataset with categorical features (None
    without): the JAX package's build_cat_layout (serial.py:195) and the
    scan's parameters on the device."""
    is_cat = dataset.is_categorical
    if is_cat is None or not np.any(is_cat):
        return None
    layout = CatLayout(is_cat, dataset.bin_start, dataset.bin_end,
                       dataset.missing_type_arr, dataset.penalty,
                       int(dataset.total_bins), device)
    c = config
    par = cat_params(params, {
        "cat_l2": float(c.cat_l2), "cat_smooth": float(c.cat_smooth),
        "min_data_per_group": int(c.min_data_per_group),
        "max_cat_threshold": int(c.max_cat_threshold),
        "max_cat_to_onehot": int(c.max_cat_to_onehot)}, use_mc)
    return CatScan(layout, par.to(device))


class ColSampler:
    """feature_fraction by-tree sampling (col_sampler.hpp:17-160), drawing
    from the same numpy stream as the JAX package's ColSampler."""

    def __init__(self, config: Config, num_features: int):
        self.fraction = float(config.feature_fraction)
        self.num_features = num_features
        self.rng = np.random.default_rng(config.feature_fraction_seed)

    def sample(self) -> np.ndarray:
        if self.fraction >= 1.0:
            return np.ones(self.num_features, dtype=bool)
        k = max(1, int(self.num_features * self.fraction))
        mask = np.zeros(self.num_features, dtype=bool)
        mask[self.rng.choice(self.num_features, size=k, replace=False)] = True
        return mask


def feature_meta(dataset) -> FeatureMeta:
    return FeatureMeta(
        group_of=dataset.group_of, group_offset=dataset.group_offset,
        bin_start=dataset.bin_start, bin_end=dataset.bin_end,
        missing_type=dataset.missing_type_arr,
        default_bin=dataset.default_bin,
        most_freq_bin=dataset.most_freq_bin, penalty=dataset.penalty,
        fix=dataset.fix_info())


def grow_config(config: Config, dataset) -> GrowConfig:
    widths = dataset.bin_end - dataset.bin_start
    gw = dataset.group_widths()
    return GrowConfig(
        num_leaves=int(config.num_leaves),
        total_bins=int(dataset.total_bins),
        num_features=int(dataset.num_features),
        scan_width=max(1, int(widths.max())) if len(widths) else 1,
        hist_width=max(1, int(gw.max())) if len(gw) else 1,
        max_depth=int(config.max_depth))


class SerialTreeLearner:
    """Owns the device arrays of one BinnedDataset and grows trees on it."""

    def __init__(self, config: Config, dataset, device):
        check_fast_path(config, dataset)
        self.config = config
        self.dataset = dataset
        self.device = device
        self.data = dataset.to_device(device)
        self.meta = feature_meta(dataset)
        self.params = SplitParams.from_config(config)
        self.grow_config = grow_config(config, dataset)
        self.tb_src = tb_source_index(dataset.group_offset,
                                      dataset.total_bins,
                                      self.grow_config.hist_width, device)
        self.col_sampler = ColSampler(config, dataset.num_features)
        self.knobs = scan_knobs(config, dataset)
        # the tree's key for the per-node draws: the extra seed's key with
        # the tree counter folded in (serial.py:94-95, 441-450)
        self._key_base = tf.prng_key(int(config.extra_seed))
        self._tree_counter = 0
        self._persist_gr = None
        self._persist_carry = None
        self.cat = cat_scan_setup(config, dataset, self.params, device,
                                  bool(np.any(dataset.monotone)))

    def can_persist_scan(self, objective) -> bool:
        """Does this learner grow with the persistent-payload grower? The
        JAX package's gate (serial.py:479-539) for the port's routes,
        decided by the objective's ``device_gradients`` (its "payload" or
        "row" gradient mode; lambdarank takes the row mode): ``force`` asks
        for it on any device and raises when the objective has none
        (rank_xendcg, whose draws change every iteration on the host);
        ``auto`` takes it on the card for 65536 rows or more; both need a
        payload pack plan."""
        opt = str(self.config.tpu_persist_scan).lower()
        if opt in ("false", "0", "off"):
            return False
        if self.cat is not None:
            Log.info("categorical features train on the v1 grower (the "
                     "persistent grower's scans have no categorical split; "
                     "ROADMAP.md queue A, item 4, step 2b)")
            return False
        if self.knobs:
            if opt == "force":
                Log.fatal(
                    "tpu_persist_scan=force with %s: the persistent "
                    "grower's scans do not take the split scan's numerical "
                    "knobs yet (ROADMAP.md %s); the JAX package's Pallas "
                    "persistent scan would drop them in silence (it passes "
                    "only lambda_l2). tpu_persist_scan=auto trains them on "
                    "the v1 grower" % (", ".join(self.knobs),
                                       _KNOBS_PERSIST))
            return False
        # row sampling the JAX package runs on its per-iteration path only
        if self.config.boosting == "goss" \
                and objective.num_model_per_iteration > 1:
            why = ("GOSS with %d trees per iteration" %
                   objective.num_model_per_iteration, _GOSS_MULTI,
                   "the JAX package's fused driver does not batch it: its "
                   "score sums |g * h| over the classes")
        elif bag_configured(self.config) \
                and objective.is_renew_tree_output:
            why = ("%s with bagging or GOSS" % objective.name, _RENEW_BAG,
                   "the JAX package renews leaves on its per-iteration "
                   "path only")
        elif self.config.boosting == "rf":
            why = self._rf_beyond_gate(objective)
        else:
            why = None
        if why is not None:
            if opt == "force":
                Log.fatal("tpu_persist_scan=force with %s: not ported to the "
                          "persistent grower yet (ROADMAP.md %s; %s). "
                          "tpu_persist_scan=auto trains it on the v1 grower"
                          % why)
            return False
        dg = objective.device_gradients()
        if opt == "force" and dg is None:
            Log.fatal("tpu_persist_scan=force: objective '%s' has no device "
                      "gradient" % getattr(objective, "name",
                                           type(objective).__name__))
        if opt != "force" and not self._auto_takes_persist():
            return False
        return (persist_pack_ok(self.dataset)[0]
                and self.dataset.num_features > 0
                and dg is not None)

    def _auto_takes_persist(self) -> bool:
        """``auto``'s device and size gate: the card, from 65536 rows."""
        return (self.device.type == "cuda"
                and self.dataset.num_data >= PARTITION_MIN_ROWS)

    def _rf_beyond_gate(self, objective):
        """Why RF leaves the JAX package's fused RF gate (rf.py:225-242:
        one tree per iteration, no init score, the "payload" gradient
        mode), as a refusal's (what, item, reason); None inside it."""
        K = objective.num_model_per_iteration
        dg = objective.device_gradients()
        if K > 1:
            what = "RF with %d trees per iteration" % K
        elif self.dataset.metadata.init_score is not None:
            what = "RF with an init score"
        elif dg is not None and dg[0] != "payload":
            what = "RF with objective %s (the row gradient mode)" \
                % objective.name
        else:
            return None
        return (what, _RF_PERSIST, "the JAX package runs it on its host "
                "path only, so there is no JAX reference; parity against "
                "v1")

    def _persist_grower(self, num_scores: int = 1,
                        weight_row: bool = True) -> PersistGrower:
        """The grower over a payload of `num_scores` score rows (the
        objective's trees per iteration), with the sample weights as a
        payload row when `weight_row` (the "payload" gradient mode; the
        "row" mode weights its gradients itself, serial.py:594), built
        once."""
        if self._persist_gr is None:
            level = str(self.config.tpu_level_grow).lower()
            assets = build_assets(self.dataset, self.dataset.metadata.label,
                                  num_scores=num_scores,
                                  use_weight_row=weight_row)
            self._persist_gr = PersistGrower(
                assets, self.meta, self.grow_config, self.params, self.device,
                level_mode="off" if level in ("off", "false", "0")
                else "auto")
        return self._persist_gr

    def refresh_config(self, config: Config) -> bool:
        """SerialTreeLearner::ResetConfig (serial_tree_learner.cpp:124-160;
        the JAX package's serial.py:386-404) between iterations: the split
        parameters, the grow configuration, the scan's knobs, the
        categorical scan's parameters and the by-tree feature fraction (its
        numpy stream goes on) from an updated Config. A persistent grower
        already built takes them too: new scalars rebuild its step
        constants (PersistGrower.set_params), a new ``num_leaves`` or
        ``max_depth`` rebuilds the grower over the same payload assets (its
        leaf table, planes and level slots are sized by them); either way
        its next iteration captures a new CUDA graph. Returns True when the
        grow configuration changed."""
        self.config = config
        self.params = SplitParams.from_config(config)
        self.col_sampler.fraction = float(config.feature_fraction)
        gc = grow_config(config, self.dataset)
        changed = gc != self.grow_config
        self.grow_config = gc
        self.knobs = scan_knobs(config, self.dataset)
        self.cat = cat_scan_setup(config, self.dataset, self.params,
                                  self.device,
                                  bool(np.any(self.dataset.monotone)))
        gr = self._persist_gr
        if gr is not None and changed:
            self._persist_gr = gr.rebuilt(gc, self.params)
        elif gr is not None:
            gr.set_params(self.params)
        return changed

    def drop_persist(self) -> None:
        """Forget the payload and the persistent grower (the route left
        them; the caller has read the payload's scores back)."""
        self._persist_carry = None
        self._persist_gr = None

    def train_persist(self, objective, score0, shrink: float,
                      classes=(0,), bag=None, rf=None):
        """One boosting iteration on the payload: for each class in
        `classes` (K = 1: the one tree), the objective's gradients, one
        tree and its score update, all on the payload, which stays on the
        learner (the carry). K > 1 trees all read the scores as they were
        at the iteration's start (the payload's snapshot rows). `score0()`
        returns the row-ordered scores ([n] or [K, n]) that seed the carry;
        it is called on the first call only. Returns the trees' TreeArrays,
        one per class in `classes`; the feature masks are drawn one per
        tree, in class order (the JAX package's order, gbdt.py:404-417).

        The iteration is the grower's (PersistGrower.iteration): on the
        card without a level phase, its first iteration runs eagerly with
        every synchronizing torch operation an error, and the later ones
        replay one captured CUDA graph; the trees are read back with one
        copy. An objective with leaf renewal re-fits each tree's leaves
        inside the iteration, before its score update. `bag` (ops/bag.py's
        BagIteration, None without one) is the iteration's bag step after
        each gradient fill. `rf` = (t, bias) makes it an RF iteration
        (PersistGrower.iteration): the gradients of the constant bias, the
        running average of the scores."""
        mode, grad_fn = objective.device_gradients()
        gr = self._persist_grower(objective.num_model_per_iteration,
                                  mode == "payload")
        if self._persist_carry is None:
            self._persist_carry = gr.init_carry(score0())
        objective.upload(self.device)
        masks = [self.col_sampler.sample() for _ in classes]
        renew = (objective.renew_tree_output
                 if objective.is_renew_tree_output else None)
        out = gr.iteration(self._persist_carry, grad_fn, masks, shrink,
                           classes, mode, renew, bag, rf)
        return [gr.to_tree_arrays(*t) for t in out]

    def persist_add_const(self, val: float, cls: int) -> None:
        """score row `cls` of the carry += val (a constant tree)."""
        self._persist_gr.add_const(self._persist_carry, val, cls)

    def persist_add_tree(self, packed, cls: int) -> None:
        """score row `cls` of the carry += f32(a packed tree's leaf value of
        each lane's row) (the JAX package's persist_add_score_delta,
        serial.py:711): one valid_walk_payload launch."""
        self._persist_gr.add_tree(self._persist_carry, self.data.bins,
                                  packed, cls)

    def persist_finalize_scores(self):
        """Row-ordered f64 scores ([n] or [K, n]) from the carry (None
        without one); the carry stays live."""
        if self._persist_carry is None:
            return None
        return self._persist_gr.finalize_scores(self._persist_carry)

    def tree_knobs(self):
        """The next tree's :class:`Knobs` (None without a knob): one tree
        counter step per tree grown, as the JAX learner's _next_extras."""
        self._tree_counter += 1
        if not self.knobs:
            return None
        mono = np.asarray(self.dataset.monotone, np.int64)
        return Knobs(monotone=mono, use_mc=bool(np.any(mono)),
                     extra_trees=bool(self.config.extra_trees),
                     bynode_k=bynode_count(self.config,
                                           self.dataset.num_features),
                     key=tf.fold_in(self._key_base, self._tree_counter))

    def train_arrays(self, grad, hess, bag=None):
        """Grow one tree from [N] grad/hess tensors on the learner's device
        (zero outside the bag; `bag` the [N] bool bag mask, None for every
        row); returns (TreeArrays, row_leaf tensor)."""
        mask = self.col_sampler.sample()
        return grow_tree_partitioned(self.data, grad, hess, self.meta,
                                     self.params, mask, self.grow_config,
                                     self.tb_src, self.tree_knobs(),
                                     self.cat, bag)
