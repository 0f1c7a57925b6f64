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
    ``false``/``0`` never. EFB-bundled data train only here;
  * the v1 partitioned grower (ops/grow.py) otherwise.

The JAX package picks among more growers and scans (``resolve_scan_impl``,
serial.py:138-167). :func:`check_fast_path` refuses every configuration the
port's routes do not implement, naming the ROADMAP.md item that will bring
it, instead of running something else in silence.
"""
from __future__ import annotations

import numpy as np

from ..config import Config
from ..objectives.base import PORTED
from ..ops.grow import GrowConfig, grow_tree_partitioned, tb_source_index
from ..ops.grow_persist import PersistGrower
from ..ops.payload import build_assets, persist_pack_ok
from ..ops.split import FeatureMeta, SplitParams
from ..utils.log import Log

_SCAN = "queue A, item 4: general split scan"
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
    if c.objective not in PORTED:
        _refuse("objective=%s" % c.objective,
                "queue A, item 17: other objectives")
    if c.boosting == "goss":
        _refuse("boosting=goss", "queue A, item 16: bagging and GOSS")
    if c.boosting != "gbdt":
        _refuse("boosting=%s" % c.boosting,
                "queue A, item 7: other boosting modes")
    if (c.bagging_freq > 0 and c.bagging_fraction < 1.0) \
            or c.pos_bagging_fraction < 1.0 or c.neg_bagging_fraction < 1.0:
        _refuse("bagging", "queue A, item 16: bagging and GOSS")
    if c.tree_learner != "serial" or c.num_machines > 1:
        _refuse("tree_learner=%s" % c.tree_learner,
                "queue A, item 11: distributed training")
    if float(c.lambda_l1) > 0.0:
        _refuse("lambda_l1 > 0", _SCAN)
    if float(c.max_delta_step) > 0.0:
        _refuse("max_delta_step > 0", _SCAN)
    if any(int(m) != 0 for m in c.monotone_constraints):
        _refuse("monotone_constraints", _SCAN)
    if bool(c.extra_trees):
        _refuse("extra_trees", _SCAN)
    if float(c.feature_fraction_bynode) < 1.0:
        _refuse("feature_fraction_bynode < 1", _SCAN)
    if (float(c.cegb_penalty_split) > 0.0 or c.cegb_penalty_feature_coupled
            or c.cegb_penalty_feature_lazy):
        _refuse("cost-effective gradient boosting (cegb_*)", _SCAN)
    if bool(c.tpu_use_dp) or str(c.tpu_hist_dtype).lower() == "f64":
        _refuse("f64 accumulation (tpu_use_dp / tpu_hist_dtype=f64)", _SCAN)
    if str(c.tpu_scan_impl).lower() == "xla":
        _refuse("tpu_scan_impl=xla", _SCAN)
    if str(c.forcedsplits_filename):
        _refuse("forced splits (forcedsplits_filename)",
                "queue A, item 21: forced splits")
    if str(c.tpu_multival).lower() == "force":
        _refuse("tpu_multival=force",
                "queue A, item 2: binned dataset layouts")


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
        self._persist_gr = None
        self._persist_carry = None

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
        dg = objective.device_gradients()
        if opt == "force" and dg is None:
            Log.fatal("tpu_persist_scan=force: objective '%s' has no device "
                      "gradient" % getattr(objective, "name",
                                           type(objective).__name__))
        if opt != "force" and (self.device.type != "cuda" or
                               self.dataset.num_data < PARTITION_MIN_ROWS):
            return False
        return (persist_pack_ok(self.dataset)[0]
                and self.dataset.num_features > 0
                and dg is not None)

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

    def train_persist(self, objective, score0, shrink: float,
                      classes=(0,)):
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
        inside the iteration, before its score update."""
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
                           classes, mode, renew)
        return [gr.to_tree_arrays(*t) for t in out]

    def persist_add_const(self, val: float, cls: int) -> None:
        """score row `cls` of the carry += val (a constant tree)."""
        self._persist_gr.add_const(self._persist_carry, val, cls)

    def persist_finalize_scores(self):
        """Row-ordered f64 scores ([n] or [K, n]) from the carry (None
        without one); the carry stays live."""
        if self._persist_carry is None:
            return None
        return self._persist_gr.finalize_scores(self._persist_carry)

    def train_arrays(self, grad, hess):
        """Grow one tree from [N] grad/hess tensors on the learner's device;
        returns (TreeArrays, row_leaf tensor)."""
        return grow_tree_partitioned(self.data, grad, hess, self.meta,
                                     self.params, self.col_sampler.sample(),
                                     self.grow_config, self.tb_src)
