"""Parameter/config system of the PyTorch port.

The port's own copy of the JAX package's parameter table
(lightgbm_tpu/config.py), which rebuilds the reference config layer
(include/LightGBM/config.h:32, src/io/config.cpp:186). A single PARAMS
schema table is the source of truth for names, types, defaults, aliases and
range checks, so the model text's ``parameters:`` block is written the same
way by both packages.

The whole table is parsed, including the ``tpu_*`` knobs of paths the port
has not brought over yet; the tree learner raises (naming the ROADMAP item)
only when a knob asks for such a path.

``device_type`` is where the port differs: ``cuda`` (the default; ``gpu``
is an alias) runs the hand-written kernels on the card, ``cpu`` runs their
plain PyTorch versions on the host. A CUDA request on a machine without a
card raises; it never falls back to the CPU. ``predict_device`` follows
``device_type`` where unset: ``cuda`` predicts with the walk kernel,
``cpu`` with the numpy walk (``tpu`` is refused, naming ``cuda``).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

from .utils.log import Log


class _P:
    """One parameter spec: name, type tag, default, aliases, (min, max) check."""

    __slots__ = ("name", "type", "default", "aliases", "lo", "hi", "lo_excl")

    def __init__(self, name, type_, default, aliases=(), lo=None, hi=None, lo_excl=False):
        self.name = name
        self.type = type_
        self.default = default
        self.aliases = tuple(aliases)
        self.lo = lo
        self.hi = hi
        self.lo_excl = lo_excl


# Schema: every supported parameter. Mirrors the reference's parameter inventory
# (config.h structured comments; alias table in config_auto.cpp).
PARAMS: List[_P] = [
    # ---- Core ----
    _P("config", str, "", ("config_file",)),
    _P("task", str, "train", ("task_type",)),
    _P("objective", str, "regression",
       ("objective_type", "app", "application")),
    _P("boosting", str, "gbdt", ("boosting_type", "boost")),
    _P("data", str, "", ("train", "train_data", "train_data_file", "data_filename")),
    _P("valid", "vstr", [], ("test", "valid_data", "valid_data_file", "test_data",
                             "test_data_file", "valid_filenames")),
    _P("num_iterations", int, 100,
       ("num_iteration", "n_iter", "num_tree", "num_trees", "num_round", "num_rounds",
        "num_boost_round", "n_estimators"), lo=0),
    _P("learning_rate", float, 0.1, ("shrinkage_rate", "eta"), lo=0.0, lo_excl=True),
    _P("num_leaves", int, 31, ("num_leaf", "max_leaves", "max_leaf"), lo=2, hi=131072),
    _P("tree_learner", str, "serial", ("tree", "tree_type", "tree_learner_type")),
    _P("num_threads", int, 0, ("num_thread", "nthread", "nthreads", "n_jobs")),
    _P("device_type", str, "cuda", ("device",)),
    _P("seed", "opt_int", None, ("random_seed", "random_state")),
    # ---- Learning control ----
    _P("max_depth", int, -1),
    _P("min_data_in_leaf", int, 20,
       ("min_data_per_leaf", "min_data", "min_child_samples"), lo=0),
    _P("min_sum_hessian_in_leaf", float, 1e-3,
       ("min_sum_hessian_per_leaf", "min_sum_hessian", "min_hessian", "min_child_weight"),
       lo=0.0),
    _P("bagging_fraction", float, 1.0, ("sub_row", "subsample", "bagging"),
       lo=0.0, hi=1.0, lo_excl=True),
    _P("pos_bagging_fraction", float, 1.0,
       ("pos_sub_row", "pos_subsample", "pos_bagging"), lo=0.0, hi=1.0, lo_excl=True),
    _P("neg_bagging_fraction", float, 1.0,
       ("neg_sub_row", "neg_subsample", "neg_bagging"), lo=0.0, hi=1.0, lo_excl=True),
    _P("bagging_freq", int, 0, ("subsample_freq",)),
    _P("bagging_seed", int, 3, ("bagging_fraction_seed",)),
    _P("feature_fraction", float, 1.0, ("sub_feature", "colsample_bytree"),
       lo=0.0, hi=1.0, lo_excl=True),
    _P("feature_fraction_bynode", float, 1.0,
       ("sub_feature_bynode", "colsample_bynode"), lo=0.0, hi=1.0, lo_excl=True),
    _P("feature_fraction_seed", int, 2),
    _P("early_stopping_round", int, 0,
       ("early_stopping_rounds", "early_stopping", "n_iter_no_change")),
    _P("first_metric_only", bool, False),
    _P("max_delta_step", float, 0.0, ("max_tree_output", "max_leaf_output")),
    _P("lambda_l1", float, 0.0, ("reg_alpha",), lo=0.0),
    _P("lambda_l2", float, 0.0, ("reg_lambda", "lambda"), lo=0.0),
    _P("min_gain_to_split", float, 0.0, ("min_split_gain",), lo=0.0),
    _P("drop_rate", float, 0.1, ("rate_drop",), lo=0.0, hi=1.0),
    _P("max_drop", int, 50),
    _P("skip_drop", float, 0.5, lo=0.0, hi=1.0),
    _P("xgboost_dart_mode", bool, False),
    _P("uniform_drop", bool, False),
    _P("drop_seed", int, 4),
    _P("top_rate", float, 0.2, lo=0.0, hi=1.0),
    _P("other_rate", float, 0.1, lo=0.0, hi=1.0),
    _P("min_data_per_group", int, 100, lo=1),
    _P("max_cat_threshold", int, 32, lo=1),
    _P("cat_l2", float, 10.0, lo=0.0),
    _P("cat_smooth", float, 10.0, lo=0.0),
    _P("max_cat_to_onehot", int, 4, lo=1),
    _P("top_k", int, 20, ("topk",), lo=1),
    _P("monotone_constraints", "vint", [], ("mc", "monotone_constraint")),
    _P("feature_contri", "vdouble", [],
       ("feature_contrib", "fc", "fp", "feature_penalty")),
    _P("forcedsplits_filename", str, "",
       ("fs", "forced_splits_filename", "forced_splits_file", "forced_splits")),
    _P("forcedbins_filename", str, ""),
    _P("refit_decay_rate", float, 0.9, lo=0.0, hi=1.0),
    _P("cegb_tradeoff", float, 1.0, lo=0.0),
    _P("cegb_penalty_split", float, 0.0, lo=0.0),
    _P("cegb_penalty_feature_lazy", "vdouble", []),
    _P("cegb_penalty_feature_coupled", "vdouble", []),
    _P("extra_trees", bool, False, ("extra_tree",)),
    _P("extra_seed", int, 6),
    # ---- IO / dataset ----
    _P("verbosity", int, 1, ("verbose",)),
    _P("max_bin", int, 255, lo=1),
    _P("min_data_in_bin", int, 3, lo=1),
    _P("bin_construct_sample_cnt", int, 200000, ("subsample_for_bin",), lo=1),
    _P("histogram_pool_size", float, -1.0, ("hist_pool_size",)),
    _P("data_random_seed", int, 1, ("data_seed",)),
    _P("output_model", str, "LightGBM_model.txt", ("model_output", "model_out")),
    _P("snapshot_freq", int, -1, ("save_period",)),
    _P("input_model", str, "", ("model_input", "model_in")),
    _P("output_result", str, "LightGBM_predict_result.txt",
       ("predict_result", "prediction_result", "predict_name", "prediction_name",
        "pred_name", "name_pred")),
    _P("initscore_filename", str, "",
       ("init_score_filename", "init_score_file", "init_score", "input_init_score")),
    _P("valid_data_initscores", "vstr", [],
       ("valid_data_init_scores", "valid_init_score_file", "valid_init_score")),
    _P("pre_partition", bool, False, ("is_pre_partition",)),
    _P("enable_bundle", bool, True, ("is_enable_bundle", "bundle")),
    _P("max_conflict_rate", float, 0.0, lo=0.0, hi=1.0),
    _P("is_enable_sparse", bool, True, ("is_sparse", "enable_sparse", "sparse")),
    _P("sparse_threshold", float, 0.8, lo=0.0, hi=1.0, lo_excl=True),
    _P("use_missing", bool, True),
    _P("zero_as_missing", bool, False),
    _P("two_round", bool, False, ("two_round_loading", "use_two_round_loading")),
    _P("save_binary", bool, False, ("is_save_binary", "is_save_binary_file")),
    _P("header", bool, False, ("has_header",)),
    _P("label_column", str, "", ("label",)),
    _P("weight_column", str, "", ("weight",)),
    _P("group_column", str, "",
       ("group", "group_id", "query_column", "query", "query_id")),
    _P("ignore_column", str, "", ("ignore_feature", "blacklist")),
    _P("categorical_feature", str, "",
       ("cat_feature", "categorical_column", "cat_column")),
    _P("predict_raw_score", bool, False,
       ("is_predict_raw_score", "predict_rawscore", "raw_score")),
    _P("predict_leaf_index", bool, False, ("is_predict_leaf_index", "leaf_index")),
    _P("predict_contrib", bool, False, ("is_predict_contrib", "contrib")),
    _P("num_iteration_predict", int, -1),
    _P("pred_early_stop", bool, False),
    _P("pred_early_stop_freq", int, 10),
    _P("pred_early_stop_margin", float, 10.0),
    _P("convert_model_language", str, ""),
    _P("convert_model", str, "gbdt_prediction.cpp", ("convert_model_file",)),
    # ---- Objective ----
    _P("num_class", int, 1, ("num_classes",), lo=1),
    _P("is_unbalance", bool, False, ("unbalance", "unbalanced_sets")),
    _P("scale_pos_weight", float, 1.0, lo=0.0),
    _P("sigmoid", float, 1.0, lo=0.0, lo_excl=True),
    _P("boost_from_average", bool, True),
    _P("reg_sqrt", bool, False),
    _P("alpha", float, 0.9, lo=0.0, lo_excl=True),
    _P("fair_c", float, 1.0, lo=0.0, lo_excl=True),
    _P("poisson_max_delta_step", float, 0.7, lo=0.0, lo_excl=True),
    _P("tweedie_variance_power", float, 1.5, lo=1.0, hi=2.0),
    _P("max_position", int, 20, lo=1),
    _P("lambdarank_truncation_level", int, 20, lo=1),
    _P("lambdarank_norm", bool, True, ("lambdamart_norm",)),
    _P("label_gain", "vdouble", []),
    _P("objective_seed", int, 5),
    # ---- Metric ----
    _P("metric", "vstr", [], ("metrics", "metric_types")),
    _P("metric_freq", int, 1, ("output_freq",), lo=1),
    _P("is_provide_training_metric", bool, False,
       ("training_metric", "is_training_metric", "train_metric")),
    _P("eval_at", "vint", [1, 2, 3, 4, 5],
       ("ndcg_eval_at", "ndcg_at", "map_eval_at", "map_at")),
    _P("multi_error_top_k", int, 1, lo=1),
    _P("auc_mu_weights", "vdouble", []),
    # ---- Network ----
    _P("num_machines", int, 1, ("num_machine",), lo=1),
    _P("local_listen_port", int, 12400, ("local_port", "port"), lo=1),
    _P("time_out", int, 120, lo=1),
    _P("machine_list_filename", str, "",
       ("machine_list_file", "machine_list", "mlist")),
    _P("machines", str, "", ("workers", "nodes")),
    # ---- GPU (accepted for compatibility with the reference) ----
    _P("gpu_platform_id", int, -1),
    _P("gpu_device_id", int, -1),
    _P("gpu_use_dp", bool, False),
    # ---- the JAX package's tpu_* knobs: parsed so the table matches the
    # JAX package's; the port's tree learner refuses the ones that ask
    # for a path it has not brought over yet ----
    _P("tpu_use_dp", bool, False),          # f64-emulated histograms vs f32
    _P("tpu_num_devices", int, 0),           # 0 = all local devices
    _P("tpu_mesh_axis", str, "data"),        # mesh axis name for row sharding
    _P("tpu_rows_per_chunk", int, 0),        # 0 = auto; histogram kernel chunking
    _P("tpu_histogram_impl", str, "auto"),   # auto | xla | pallas
    _P("tpu_donate_buffers", bool, True),
    _P("tpu_window_chunk", int, 0),          # 0 = auto; partitioned-grower chunk rows
    _P("tpu_hist_dtype", str, "auto"),       # auto | f32 | f64 | bf16x2
    #                                        # (auto: f64 bins on CPU —
    #                                        # reference double hist_t —
    #                                        # bf16x2 MXU on TPU)
    _P("tpu_pack_impl", str, "sort"),        # sort | matmul (partition pack)
    _P("tpu_scan_impl", str, "auto"),        # auto | xla | pallas (split scan)
    _P("tpu_persist_scan", str, "auto"),     # auto | off | force (persistent-payload scan; force = XLA kernel emulation off-TPU)
    _P("tpu_level_grow", str, "auto"),       # auto | off (level-parallel persist growth: one fused program per tree level when max_depth is set)
    _P("feature_pre_filter", bool, True),
    _P("force_col_wise", bool, False),       # CPU memory-layout hint; no-op
    _P("force_row_wise", bool, False),       # on TPU (HBM layout is fixed)
    _P("max_bin_by_feature", list, []),
    _P("predict_disable_shape_check", bool, False),
    _P("tpu_4bit_packing", bool, True),      # nibble-pack <=16-bin groups in HBM
    _P("tpu_telemetry", str, "off"),         # off | timers | trace (telemetry/)
    _P("telemetry_out", str, ""),            # Chrome-trace/metrics path base
    # ---- inference subsystem (predict/) ----
    _P("predict_device", str, "",            # cuda (gpu) = the walk kernel,
       ("predict_backend",)),                # cpu = numpy walk; unset =
    #                                        # device_type
    _P("tpu_predict_dtype", str, "f64"),     # f64 (exact parity) | f32
    _P("tpu_predict_min_batch", int, 256, lo=1),   # serve bucket ladder
    _P("tpu_predict_max_batch", int, 65536, lo=1),  # bounds (pow2-rounded)
    # ---- async serving subsystem (serving/) ----
    _P("tpu_serve_async", bool, False),      # task=predict via the async
    #                                        # continuous-batching server
    _P("tpu_serve_quant", str, "none"),      # none | f16 (certified) |
    #                                        # int8 (refused by cert)
    _P("tpu_serve_max_wait_ms", float, 5.0, lo=0.0),  # deadline budget a
    #                                        # sub-bucket batch may wait
    #                                        # to coalesce (SLO-derived)
    _P("tpu_multival", str, "auto"),         # auto | force | off: ELL row-
    #                                        # sparse device layout (the
    #                                        # MultiValBin/SparseBin analog)
    # ---- multi-model subsystem (multimodel/) ----
    _P("tpu_cv", str, "auto"),               # auto | device | off: engine.cv
    #                                        # folds as lanes of the batched
    #                                        # driver over one shared layout
    # ---- resilience subsystem (resilience/) ----
    # snapshot_freq (reference save_period) above gates HOW OFTEN; these
    # gate WHERE full training-state checkpoints land and how many stay
    _P("checkpoint_dir", str, "", ("checkpoint_directory",)),
    _P("checkpoint_keep", int, 3, lo=1),
    _P("tpu_fault_plan", str, ""),           # deterministic fault injection
    #                                        # (kill@iter= / drop_collective@
    #                                        # round= / corrupt_checkpoint@n=
    #                                        # / stall@ / resize@ /
    #                                        # corrupt_hist@round=;rank=)
    _P("tpu_collective_timeout", float, 300.0, lo=0.0),  # DCN host-
    _P("tpu_collective_retries", int, 2, lo=0),          # collective guard
    _P("tpu_collective_backoff", float, 0.25, lo=0.0),   # (resilience/retry)
    _P("tpu_collective_soft_timeout", float, 0.0, lo=0.0),  # straggler
    #                                        # watchdog soft deadline
    #                                        # (0 = auto: timeout / 4)
    # ---- runtime numerics sentinel (telemetry/health, parallel/
    # fingerprint): the runtime twin of the quant_certify static audit
    _P("tpu_numerics_stats", str, "auto"),   # auto | off: device-side
    #                                        # NaN/Inf counters + split-
    #                                        # margin histogram in the
    #                                        # persist scan carry
    _P("tpu_health_abort", str, ""),         # ""=report-only, or all/
    #                                        # comma list of anomaly kinds
    #                                        # (nonfinite_metric /
    #                                        # margin_collapse /
    #                                        # stall_burst) that abort
    _P("tpu_divergence_probe", str, "auto"),  # auto | on | off: per-
    #                                        # iteration cross-rank
    #                                        # fingerprint compare in the
    #                                        # distributed loop (auto =
    #                                        # only with >1 process; on
    #                                        # forces the world=1 short-
    #                                        # circuit path too)
    # ---- communication-efficient distributed exchange (ROADMAP item 2)
    _P("tpu_hist_quant", str, "off"),        # off | int16: quantize the
    #                                        # cross-device histogram-
    #                                        # plane reductions to int16
    #                                        # with rank-uniform seeded
    #                                        # stochastic rounding; the
    #                                        # spec must pass the
    #                                        # quant_certify certificate
    #                                        # (int8 is refused there)
    _P("tpu_comm_overlap", str, "auto"),     # auto | off: double-buffer
    #                                        # the level program's plane
    #                                        # reductions as two staged
    #                                        # half-batches (comm of half
    #                                        # A overlaps compute of half
    #                                        # B; bit-identical either
    #                                        # way)
]

_BY_NAME: Dict[str, _P] = {p.name: p for p in PARAMS}
_ALIAS2NAME: Dict[str, str] = {}
for _p in PARAMS:
    for _a in _p.aliases:
        _ALIAS2NAME[_a] = _p.name

# objective aliases the reference resolves inside ParseObjectiveAlias
_OBJECTIVE_ALIASES = {
    "regression": "regression", "regression_l2": "regression", "l2": "regression",
    "mean_squared_error": "regression", "mse": "regression", "l2_root": "regression",
    "root_mean_squared_error": "regression", "rmse": "regression",
    "regression_l1": "regression_l1", "l1": "regression_l1",
    "mean_absolute_error": "regression_l1", "mae": "regression_l1",
    "huber": "huber", "fair": "fair", "poisson": "poisson",
    "quantile": "quantile", "mape": "mape",
    "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "tweedie": "tweedie",
    "binary": "binary",
    "multiclass": "multiclass", "softmax": "multiclass",
    "multiclassova": "multiclassova", "multiclass_ova": "multiclassova",
    "ova": "multiclassova", "ovr": "multiclassova",
    "lambdarank": "lambdarank", "rank_xendcg": "rank_xendcg",
    "xendcg": "rank_xendcg", "xe_ndcg": "rank_xendcg",
    "xe_ndcg_mart": "rank_xendcg", "xendcg_mart": "rank_xendcg",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}

_METRIC_ALIASES = {
    "l1": "l1", "mean_absolute_error": "l1", "mae": "l1", "regression_l1": "l1",
    "l2": "l2", "mean_squared_error": "l2", "mse": "l2", "regression_l2": "l2",
    "regression": "l2",
    "rmse": "rmse", "root_mean_squared_error": "rmse", "l2_root": "rmse",
    "quantile": "quantile", "huber": "huber", "fair": "fair",
    "poisson": "poisson", "mape": "mape", "mean_absolute_percentage_error": "mape",
    "gamma": "gamma", "gamma_deviance": "gamma_deviance",
    "tweedie": "tweedie",
    "ndcg": "ndcg", "lambdarank": "ndcg", "rank_xendcg": "ndcg",
    "xendcg": "ndcg", "xe_ndcg": "ndcg", "xe_ndcg_mart": "ndcg",
    "xendcg_mart": "ndcg",
    "map": "map", "mean_average_precision": "map",
    "auc": "auc",
    "binary_logloss": "binary_logloss", "binary": "binary_logloss",
    "binary_error": "binary_error",
    "auc_mu": "auc_mu",
    "multi_logloss": "multi_logloss", "multiclass": "multi_logloss",
    "softmax": "multi_logloss", "multiclassova": "multi_logloss",
    "multiclass_ova": "multi_logloss", "ova": "multi_logloss", "ovr": "multi_logloss",
    "multi_error": "multi_error",
    "cross_entropy": "cross_entropy", "xentropy": "cross_entropy",
    "cross_entropy_lambda": "cross_entropy_lambda", "xentlambda": "cross_entropy_lambda",
    "kullback_leibler": "kldiv", "kldiv": "kldiv",
    "none": "none", "null": "none", "custom": "none", "na": "none",
}


def _parse_bool(v: Any) -> bool:
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return bool(v)
    s = str(v).strip().lower()
    if s in ("true", "1", "+", "yes", "y", "on"):
        return True
    if s in ("false", "0", "-", "no", "n", "off"):
        return False
    Log.fatal("Cannot parse '%s' as bool" % (v,))


def _parse_vector(v: Any, elem) -> list:
    if v is None or v == "":
        return []
    if isinstance(v, (list, tuple)):
        return [elem(x) for x in v]
    return [elem(x) for x in str(v).replace(",", " ").split()]


def kv2map(args: List[str]) -> Dict[str, str]:
    """Parse CLI-style 'key=value' tokens (reference Config::KV2Map, config.h:79)."""
    out: Dict[str, str] = {}
    for arg in args:
        arg = arg.strip()
        if not arg or arg.startswith("#"):
            continue
        if "=" not in arg:
            Log.warning("Unknown parameter format '%s', ignored", arg)
            continue
        k, v = arg.split("=", 1)
        k, v = k.strip(), v.split("#", 1)[0].strip()
        if k in out and out[k] != v:
            Log.warning("Duplicate parameter '%s': using first value '%s'", k, out[k])
            continue
        out[k] = v
    return out


def alias_transform(params: Dict[str, Any]) -> Dict[str, Any]:
    """Resolve aliases to canonical names; canonical key wins over alias
    (reference ParameterAlias::KeyAliasTransform, config.h:979)."""
    out: Dict[str, Any] = {}
    aliased: Dict[str, Tuple[str, Any]] = {}
    for k, v in params.items():
        if k in _BY_NAME:
            out[k] = v
        elif k in _ALIAS2NAME:
            name = _ALIAS2NAME[k]
            if name in aliased:
                Log.warning("Parameter '%s' and '%s' are aliases; using '%s'",
                            aliased[name][0], k, aliased[name][0])
            else:
                aliased[name] = (k, v)
        else:
            # unknown keys are kept verbatim (reference passes them through too)
            out[k] = v
    for name, (_, v) in aliased.items():
        if name not in out:
            out[name] = v
    return out


class Config:
    """Typed parameter bag with LightGBM semantics.

    Construct from a dict (Python API) or list of "k=v" strings (CLI). Unknown
    keys are stored in `extra` and carried along untouched.
    """

    def __init__(self, params: Optional[Dict[str, Any]] = None, **kwargs):
        merged = dict(params or {})
        merged.update(kwargs)
        merged = alias_transform(merged)
        self.extra: Dict[str, Any] = {}
        for p in PARAMS:
            setattr(self, p.name, self._coerce(p, merged.get(p.name, p.default)))
        for k, v in merged.items():
            if k not in _BY_NAME:
                self.extra[k] = v
        self._post_process(merged)

    # -- parsing -----------------------------------------------------------
    def _coerce(self, p: _P, v: Any) -> Any:
        if v is None and p.type != "opt_int":
            v = p.default
        try:
            if p.type is bool:
                v = _parse_bool(v)
            elif p.type is int:
                v = int(float(v))
            elif p.type is float:
                v = float(v)
            elif p.type is str:
                v = str(v)
            elif p.type == "opt_int":
                v = None if v in (None, "", "None") else int(float(v))
            elif p.type == "vint":
                v = _parse_vector(v, lambda x: int(float(x)))
            elif p.type == "vdouble":
                v = _parse_vector(v, float)
            elif p.type == "vstr":
                v = _parse_vector(v, str) if not isinstance(v, (list, tuple)) \
                    else [str(x) for x in v]
        except (TypeError, ValueError):
            Log.fatal("Cannot parse parameter %s=%r" % (p.name, v))
        if p.lo is not None and isinstance(v, (int, float)):
            if (p.lo_excl and v <= p.lo) or (not p.lo_excl and v < p.lo):
                Log.fatal("Parameter %s should be %s %s, got %s"
                          % (p.name, ">" if p.lo_excl else ">=", p.lo, v))
        if p.hi is not None and isinstance(v, (int, float)) and v > p.hi:
            Log.fatal("Parameter %s should be <= %s, got %s" % (p.name, p.hi, v))
        return v

    def _post_process(self, merged: Dict[str, Any]) -> None:
        # objective/boosting/metric canonicalization
        obj = str(self.objective).lower()
        if obj in _OBJECTIVE_ALIASES:
            self.objective = _OBJECTIVE_ALIASES[obj]
        booster = str(self.boosting).lower()
        _boost_alias = {"gbdt": "gbdt", "gbrt": "gbdt", "gbm": "gbdt",
                        "dart": "dart", "goss": "goss",
                        "rf": "rf", "random_forest": "rf"}
        if booster in _boost_alias:
            self.boosting = _boost_alias[booster]
        metrics = []
        for m in self.metric:
            ml = str(m).strip().lower()
            if ml == "":
                continue
            metrics.append(_METRIC_ALIASES.get(ml, ml))
        # dedupe keeping order
        seen = set()
        self.metric = [m for m in metrics if not (m in seen or seen.add(m))]
        # seed cascade (reference config.cpp: seed overrides sub-seeds)
        if self.seed is not None:
            self.data_random_seed = self.seed + 1
            self.bagging_seed = self.seed + 2
            self.drop_seed = self.seed + 3
            self.feature_fraction_seed = self.seed + 4
            self.extra_seed = self.seed + 5
            self.objective_seed = self.seed + 6
        tl = str(self.tree_learner).lower()
        _tl_alias = {"serial": "serial",
                     "feature": "feature", "feature_parallel": "feature",
                     "data": "data", "data_parallel": "data",
                     "voting": "voting", "voting_parallel": "voting"}
        if tl not in _tl_alias:
            Log.fatal("Unknown tree learner type %s" % tl)
        self.tree_learner = _tl_alias[tl]
        dev = str(self.device_type).lower()
        if dev == "gpu":
            dev = "cuda"
        if dev not in ("cpu", "cuda"):
            Log.fatal("Unknown device type %s (expected cuda|cpu)" % dev)
        self.device_type = dev
        pdev = str(self.predict_device).lower()
        if pdev == "tpu":
            Log.fatal("predict_device=tpu is the JAX package's; this package "
                      "predicts on cuda (alias gpu) or cpu")
        if pdev == "gpu":
            pdev = "cuda"
        if pdev == "":
            pdev = dev
        if pdev not in ("cpu", "cuda"):
            Log.fatal("Unknown predict_device %s (expected cuda|cpu)" % pdev)
        self.predict_device = pdev
        pdt = str(self.tpu_predict_dtype).lower()
        if pdt not in ("f64", "f32", "float64", "float32"):
            Log.fatal("Unknown tpu_predict_dtype %s (expected f64|f32)" % pdt)
        self.tpu_predict_dtype = "f32" if pdt in ("f32", "float32") else "f64"
        if self.tpu_predict_max_batch < self.tpu_predict_min_batch:
            Log.fatal("tpu_predict_max_batch < tpu_predict_min_batch")
        sq = str(self.tpu_serve_quant).lower()
        if sq in ("", "false", "0", "off"):
            sq = "none"
        # int8 parses here but is refused at registry load by the
        # quant_certify certificate (serving/quantized.py) with the
        # bound named in the error — same seam as tpu_hist_quant
        if sq not in ("none", "f16", "float16", "int8"):
            Log.fatal("Unknown tpu_serve_quant %s (expected "
                      "none|f16|int8)" % sq)
        self.tpu_serve_quant = "f16" if sq == "float16" else sq
        if self.tpu_serve_async and self.predict_device != "cuda":
            # asking for the async service loop IS asking for the device
            # walk; without this the serving knobs would fall through to
            # the host walk
            Log.info("tpu_serve_async=true implies predict_device=cuda")
            self.predict_device = "cuda"
        hq = str(self.tpu_hist_quant).lower()
        if hq in ("", "false", "0"):
            hq = "off"
        # int8 parses here but is refused at learner build by the
        # quant_certify certificate (parallel/distributed.
        # resolve_hist_quant) with the bound named in the error
        if hq not in ("off", "int16", "int8"):
            Log.fatal("Unknown tpu_hist_quant %s (expected off|int16)"
                      % self.tpu_hist_quant)
        self.tpu_hist_quant = hq
        # reference config.cpp CheckParamConflict: num_class goes with a
        # multiclass objective, and only with one
        if self.objective in ("multiclass", "multiclassova") or (
                self.objective == "none" and self.num_class > 1):
            if self.num_class <= 1:
                Log.fatal("Number of classes should be specified and greater "
                          "than 1 for multiclass training")
        elif str(self.task).lower() == "train" and self.num_class != 1:
            Log.fatal("Number of classes must be 1 for non-multiclass "
                      "training")
        if self.boosting == "rf":
            if not (self.bagging_freq > 0 and 0.0 < self.bagging_fraction < 1.0):
                Log.fatal("Random forest needs bagging_freq > 0 and "
                          "bagging_fraction in (0, 1)")

    # -- derived flags (reference config.h:910-911) ------------------------
    @property
    def is_parallel(self) -> bool:
        return self.num_machines > 1 or self.tree_learner != "serial"

    @property
    def is_data_based_parallel(self) -> bool:
        return self.tree_learner in ("data", "voting")

    # -- misc --------------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        d = {p.name: getattr(self, p.name) for p in PARAMS}
        d.update(self.extra)
        return d

    @classmethod
    def from_cli_args(cls, argv: List[str]) -> "Config":
        kv = kv2map(argv)
        if "config" in kv and kv["config"]:
            file_kv: Dict[str, str] = {}
            with open(kv["config"]) as f:
                file_kv = kv2map(f.read().splitlines())
            # CLI args take precedence over config file (application.cpp:49-82)
            file_kv.update(kv)
            kv = file_kv
        return cls(kv)


def params_to_config(params: Optional[Dict[str, Any]]) -> Config:
    if isinstance(params, Config):
        return params
    return Config(params or {})
