"""User-facing Dataset and Booster of the port.

The port of lightgbm_tpu/basic.py for in-memory numpy matrices: a
``Dataset`` with categorical columns (``categorical_feature=`` by index or
by name, or the ``categorical_feature`` parameter), query groups for
ranking (``group=``, ``set_group``/``get_group``; a validation set bins
with its ``reference``'s mappers and keeps its own groups), the field
setters and getters, ``subset`` (rows of its bins, lazily) and
``add_features_from``; and a ``Booster`` that trains (``update``), changes
its parameters between iterations (``reset_parameter``), rolls back an
iteration, refits its leaves to new rows (``refit``), evaluates its
training and validation sets (``add_valid``, ``eval*``), predicts, reports
feature importances, dumps its model as JSON, writes and reads LightGBM
model text, and pickles and copies through that text.

Evaluation: the metrics run on the scores' device and return 0-d tensors;
one evaluation call reads all its values back with one copy.

Device: the ``device_type`` parameter, ``cuda`` by default, ``cpu`` on
request. A CUDA request on a machine without a card raises; it never falls
back to the CPU. Prediction follows ``predict_device`` (a ``predict``
keyword or a parameter; unset, the ``device_type``): ``cuda`` walks the
trees with the CUDA kernel of predict/ (a Booster read from model text
too), ``cpu`` with the numpy walk on the host.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .boosting import GBDT, create_boosting
from .config import _METRIC_ALIASES, Config
from .data.dataset import BinnedDataset
from .metrics import create_metric
from .objectives import create_objective
from .utils.log import LightGBMError, Log


def resolve_device(config: Config) -> torch.device:
    """The torch device a configuration asks for; raises when it asks for
    CUDA and there is no card."""
    if config.device_type == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise LightGBMError(
            "device_type=cuda (the default) but torch.cuda.is_available() "
            "is False; pass device_type=cpu to run the plain PyTorch "
            "versions of the kernels on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def categorical_indices(categorical_feature, config: Config,
                        names: Optional[List[str]], num_features: int
                        ) -> List[int]:
    """The column indices that bin as categories: the ``categorical_feature``
    argument (indices, or names resolved against ``names``), else the
    ``categorical_feature`` parameter (the reference's form: "0,3,5" or
    "name:a,b"). "auto" and None name none (a numpy matrix has no category
    dtype; the JAX package's basic.py:37-90)."""
    cat = categorical_feature
    if cat in ("auto", None) or (isinstance(cat, (list, tuple))
                                 and len(cat) == 0):
        spec = str(config.categorical_feature).strip()
        if not spec:
            return []
        if spec.startswith("name:"):
            cat = [c.strip() for c in spec[5:].split(",") if c.strip()]
        else:
            cat = [int(c) for c in spec.split(",") if c.strip()]
    if isinstance(cat, (str, int)):
        cat = [cat]
    out = []
    for c in cat:
        if isinstance(c, (int, np.integer)):
            i = int(c)
        elif names is not None and c in names:
            i = names.index(c)
        else:
            raise LightGBMError("categorical_feature %r is neither a column "
                                "index nor a feature name" % (c,))
        if not 0 <= i < num_features:
            raise LightGBMError("categorical_feature %d is out of range for "
                                "%d features" % (i, num_features))
        out.append(i)
    return sorted(set(out))


class Dataset:
    """Training data container (reference basic.py:730), built lazily."""

    def __init__(self, data, label=None, reference: Optional["Dataset"] = None,
                 weight=None, group=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.reference = reference
        self.weight = weight
        self.group = group
        self.init_score = init_score
        self.feature_name = feature_name
        self.categorical_feature = categorical_feature
        self.params = dict(params or {})
        self.free_raw_data = free_raw_data
        self._inner: Optional[BinnedDataset] = None
        # the parent's rows of a subset (None: built from `data`)
        self.used_indices = None

    def construct(self) -> "Dataset":
        """Bin the matrix on the host and upload the bins to the device (a
        :meth:`subset`: take its rows of the parent's bins)."""
        if self._inner is not None:
            return self
        if self.used_indices is not None:
            return self._construct_subset()
        cfg = Config(self.params)
        if self.data is None:
            raise LightGBMError("Cannot construct Dataset since the raw data "
                                "has been freed")
        X = np.asarray(self.data, dtype=np.float64)
        if X.ndim != 2:
            raise LightGBMError("Dataset needs a 2-D matrix, got shape %s"
                                % (X.shape,))
        names = (list(self.feature_name)
                 if isinstance(self.feature_name, (list, tuple)) else None)
        ref = None
        if self.reference is not None:
            ref = self.reference.construct()._inner
        cat_idx = categorical_indices(self.categorical_feature, cfg, names,
                                      X.shape[1])
        self._inner = BinnedDataset.from_matrix(
            X, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=names, reference=ref,
            categorical_features=cat_idx)
        if ref is None:
            # a validation set is uploaded by the Booster that evaluates
            # it, to its training device
            self._inner.to_device(resolve_device(cfg))
        if self.free_raw_data:
            self.data = None
        return self

    def _construct_subset(self) -> "Dataset":
        """The parent's bins at used_indices, with this Dataset's fields."""
        inner = self._parent.construct()._inner.subset(self.used_indices)
        md = inner.metadata
        if self.label is not None:
            md.set_label(self.label)
        md.set_weight(self.weight)
        md.set_query(self.group)
        md.set_init_score(self.init_score)
        self._inner = inner
        return self

    def subset(self, used_indices, params=None) -> "Dataset":
        """A Dataset of the rows `used_indices` with this one's mappers
        (reference Dataset.subset; the JAX package's basic.py:344-391),
        built lazily from this one's bins: the labels and weights of those
        rows, the query sizes recomputed from the rows' queries (a query
        cut by the selection counts once per run of its rows), and the init
        scores of those rows in their layout ([n], [n * K] class-major or
        [n, K]). Its feature names are this one's, as in the reference."""
        self.construct()
        idx = np.asarray(used_indices)
        n = self.num_data()
        group_sub = None
        parent_group = self.get_group()
        if parent_group is not None and len(parent_group):
            qid = np.repeat(np.arange(len(parent_group)),
                            np.asarray(parent_group, dtype=np.int64))[idx]
            if len(qid):
                change = np.flatnonzero(np.diff(qid) != 0)
                group_sub = np.diff(np.concatenate(
                    [[0], change + 1, [len(qid)]]))
        init_sub = None
        isc = self.get_init_score()
        if isc is not None:
            isc = np.asarray(isc)
            if isc.ndim == 2 or isc.size == n:
                init_sub = isc[idx]
            elif isc.size % n == 0:
                init_sub = isc.reshape(-1, n)[:, idx].reshape(-1)
            else:
                raise LightGBMError(
                    "init_score size %d is not compatible with num_data %d"
                    % (isc.size, n))
        label, weight = self.get_label(), self.get_weight()
        sub = Dataset(None, label=None if label is None
                      else np.asarray(label)[idx],
                      reference=self,
                      weight=None if weight is None
                      else np.asarray(weight)[idx],
                      group=group_sub, init_score=init_sub,
                      params=params or self.params,
                      free_raw_data=self.free_raw_data)
        sub.used_indices, sub._parent = idx, self
        return sub

    def add_features_from(self, other: "Dataset") -> "Dataset":
        """Append `other`'s features (the same rows) to this Dataset
        (reference Dataset.add_features_from; the JAX package's
        basic.py:393-404): both are built, and this one's groups, mappers,
        names, bin ranges and bins, on the host and on the device, grow by
        the other's."""
        self.construct()
        other.construct()
        self._inner.add_features_from(other._inner)
        if self.data is not None and other.data is not None:
            self.data = np.concatenate([np.asarray(self.data, np.float64),
                                        np.asarray(other.data, np.float64)],
                                       axis=1)
        else:
            self.data = None
        return self

    def set_label(self, label) -> "Dataset":
        """Replace the labels (of the binned dataset too, once built): a
        later Booster trains on them over the same bins."""
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(label)
        return self

    def set_weight(self, weight) -> "Dataset":
        """Replace the sample weights (of the binned dataset too, once
        built)."""
        self.weight = weight
        if self._inner is not None:
            self._inner.metadata.set_weight(weight)
        return self

    def set_init_score(self, init_score) -> "Dataset":
        """Replace the init scores ([n], [n * K] class-major or [n, K]; of
        the binned dataset too, once built)."""
        self.init_score = init_score
        if self._inner is not None:
            self._inner.metadata.set_init_score(init_score)
        return self

    def set_feature_name(self, feature_name) -> "Dataset":
        """The feature names to build with ("auto" or None: keep them)."""
        if feature_name not in (None, "auto"):
            self.feature_name = feature_name
        return self

    def set_categorical_feature(self, categorical_feature) -> "Dataset":
        """The categorical columns to build with; after the build the
        bins are fixed, so a new set is ignored with a warning (as the JAX
        package does)."""
        if categorical_feature not in (None, "auto"):
            if self._inner is not None:
                Log.warning("categorical_feature set after construction is "
                            "ignored")
            else:
                self.categorical_feature = categorical_feature
        return self

    def get_label(self):
        if self._inner is not None:
            return self._inner.metadata.label
        return self.label

    def get_weight(self):
        if self._inner is not None:
            return self._inner.metadata.weight
        return self.weight

    def get_init_score(self):
        if self._inner is not None:
            return self._inner.metadata.init_score
        return self.init_score

    def get_field(self, field_name):
        """label, weight, group or init_score, by name."""
        return {"label": self.get_label, "weight": self.get_weight,
                "group": self.get_group,
                "init_score": self.get_init_score}[field_name]()

    def set_field(self, field_name, data) -> "Dataset":
        return {"label": self.set_label, "weight": self.set_weight,
                "group": self.set_group,
                "init_score": self.set_init_score}[field_name](data)

    def set_group(self, group) -> "Dataset":
        """Replace the query groups (per-query sizes or boundaries; of the
        binned dataset too, once built)."""
        self.group = group
        if self._inner is not None:
            self._inner.metadata.set_query(group)
        return self

    def get_group(self):
        """The per-query sizes (None without groups)."""
        if self._inner is not None and \
                self._inner.metadata.query_boundaries is not None:
            return np.diff(self._inner.metadata.query_boundaries)
        return self.group

    def set_reference(self, reference: "Dataset") -> "Dataset":
        """Bin with `reference`'s mappers and groups (a validation set);
        raises once the Dataset is built against another."""
        if self._inner is not None and self.reference is not reference:
            raise LightGBMError("Cannot set reference after constructed")
        self.reference = reference
        return self

    def _update_params(self, params) -> "Dataset":
        if params:
            self.params.update(params)
        return self

    def num_data(self) -> int:
        return self.construct()._inner.num_data

    def num_feature(self) -> int:
        return self.construct()._inner.num_total_features

    def get_feature_name(self) -> List[str]:
        return list(self.construct()._inner.feature_names)


class Booster:
    """The trained model handle (reference basic.py:1704)."""

    def __init__(self, params: Optional[Dict[str, Any]] = None,
                 train_set: Optional[Dataset] = None,
                 model_file: Optional[str] = None,
                 model_str: Optional[str] = None):
        self.params = dict(params or {})
        self.best_iteration = -1
        self.best_score: Dict = {}
        self.train_set = None
        self._train_data_name = "training"
        self._valid_sets: List[Dataset] = []
        self.name_valid_sets: List[str] = []
        self._metrics: list = []
        self._booster = GBDT()
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                "met %s" % type(train_set).__name__)
            cfg = Config(self.params)
            self._booster = create_boosting(cfg.boosting)
            device = resolve_device(cfg)
            train_set.params.update(self.params)
            inner = train_set.construct()._inner
            self.train_set = train_set
            self._cfg = cfg
            objective = create_objective(cfg.objective, cfg)
            if objective is not None:
                objective.init(inner.metadata, inner.num_data)
            self._booster.init(cfg, inner, objective, device)
            self._metrics = self._make_metrics(cfg)
            for m in self._metrics:
                m.init(inner.metadata, inner.num_data, device)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self._init_from_string(model_str)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster instance")

    def _init_from_string(self, model_str: str) -> None:
        """A GBDT read from model text, with this Booster's parameters."""
        self._booster = GBDT()
        self._booster.config = Config(self.params)
        self._booster.load_model_from_string(model_str)
        self._metrics = []

    @staticmethod
    def _make_metrics(cfg: Config) -> list:
        """The configured metrics, else the objective's own (the JAX
        package's basic.py:471-487)."""
        names = list(cfg.metric)
        if not names:
            default = _METRIC_ALIASES.get(cfg.objective)
            if default and default != "none":
                names = [default]
        return [m for m in (create_metric(n, cfg) for n in names
                            if n != "none") if m is not None]

    def reset_parameter(self, params: dict) -> "Booster":
        """Change parameters between iterations (reference
        Booster.reset_parameter): the learning rate, the split keys and the
        bagging keys, through GBDT.reset_config, which raises for any
        other key."""
        if params:
            self._booster.reset_config(params)
            self.params.update(params)
        return self

    def refit(self, data, label, decay_rate: float = 0.9,
              **kwargs) -> "Booster":
        """A new Booster over the rows `data` with labels `label` whose
        trees are this one's structures with their leaf outputs fit again
        to those rows and blended with the old ones by `decay_rate`
        (reference Booster.refit / GBDT::RefitTree; the JAX package's
        basic.py:501-521): built from this Booster's parameters, on their
        device (GBDT.refit)."""
        import copy
        if not self._booster.models:
            raise LightGBMError("Cannot refit an empty model")
        X = np.asarray(data, dtype=np.float64)
        params = dict(self.params)
        params.pop("input_model", None)
        new = Booster(params=params, train_set=Dataset(X, label,
                                                       params=params))
        new._booster.models = [copy.deepcopy(t)
                               for t in self._booster.models]
        new._booster.refit(X, decay_rate=float(decay_rate))
        return new

    def rollback_one_iter(self) -> "Booster":
        """Drop the last iteration's trees and their scores
        (GBDT.rollback_one_iter)."""
        self._booster.rollback_one_iter()
        return self

    def num_model_per_iteration(self) -> int:
        return self._booster.num_tree_per_iteration

    def num_feature(self) -> int:
        return self._booster.max_feature_idx + 1

    def feature_name(self) -> List[str]:
        return list(self._booster.feature_names)

    def feature_importance(self, importance_type: str = "split",
                           iteration: Optional[int] = None) -> np.ndarray:
        """Per feature, its splits' count ("split", int32) or their gains'
        sum ("gain"), over the first `iteration` iterations (None or 0:
        all)."""
        imp = self._booster.feature_importance(importance_type,
                                               iteration if iteration else 0)
        if importance_type == "split":
            return imp.astype(np.int32)
        return imp

    def dump_model(self, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> dict:
        """The model as the reference's JSON dict (GBDT.dump_model)."""
        return self._booster.dump_model(
            start_iteration, self._default_iterations(num_iteration))

    def model_from_string(self, model_str: str, verbose=True) -> "Booster":
        """Replace the model by the one in `model_str`."""
        self._init_from_string(model_str)
        return self

    # -- pickling and copying go through model text ---------------------
    def __getstate__(self):
        return {"params": self.params,
                "model_str": self.model_to_string(num_iteration=-1),
                "best_iteration": self.best_iteration,
                "best_score": self.best_score}

    def __setstate__(self, state):
        self.params = state["params"]
        self.best_iteration = state["best_iteration"]
        self.best_score = state["best_score"]
        self.train_set = None
        self._train_data_name = "training"
        self._valid_sets = []
        self.name_valid_sets = []
        self._init_from_string(state["model_str"])

    def __copy__(self):
        return self.__deepcopy__(None)

    def __deepcopy__(self, _):
        """A Booster read from this one's model text, with its parameters
        (so it predicts on the same device)."""
        return Booster(params=dict(self.params),
                       model_str=self.model_to_string(num_iteration=-1))

    def set_train_data_name(self, name: str) -> "Booster":
        self._train_data_name = name
        return self

    def add_valid(self, data: Dataset, name: str) -> "Booster":
        """A validation set, binned with the training set's mappers, with
        the configured metrics; its scores live on the training device."""
        if not isinstance(data, Dataset):
            raise TypeError("Validation data should be Dataset instance, "
                            "met %s" % type(data).__name__)
        if self.train_set is None:
            raise LightGBMError("add_valid needs a Booster made with a "
                                "train_set")
        if data is not self.train_set:
            data.set_reference(self.train_set)
        data.construct()
        self._valid_sets.append(data)
        self.name_valid_sets.append(name)
        self._booster.add_valid_dataset(data._inner,
                                        self._make_metrics(self._cfg), name)
        return self

    def update(self, train_set: Optional[Dataset] = None, fobj=None) -> bool:
        """One boosting round (reference basic.py:2089). Returns True when
        no further splits were possible (training finished). With `fobj`,
        ``fobj(scores, train_set) -> (grad, hess)`` gives the round's
        gradients from the class-major [K * n] f64 training scores (numpy),
        as in the JAX package (basic.py:544-567)."""
        if train_set is not None and train_set is not self.train_set:
            raise LightGBMError("Replacing train_set is not supported")
        if fobj is None:
            return self._booster.train_one_iter()
        preds = self._booster.train_score.score.detach().cpu().numpy() \
            .reshape(-1)
        grad, hess = fobj(preds, self.train_set)
        return self.__boost(grad, hess)

    def __boost(self, grad, hess) -> bool:
        grad = np.ascontiguousarray(grad, dtype=np.float32).reshape(-1)
        hess = np.ascontiguousarray(hess, dtype=np.float32).reshape(-1)
        b = self._booster
        n = b.train_data.num_data * b.num_tree_per_iteration
        if grad.size != n or hess.size != n:
            raise ValueError("Lengths of gradients (%d) and hessians (%d) "
                             "don't match the expected %d"
                             % (grad.size, hess.size, n))
        return b.train_one_iter(grad, hess)

    # ------------------------------------------------------------------
    def _eval_one(self, score, metrics, data_name: str, feval=None,
                  dataset: Optional[Dataset] = None) -> list:
        """(data_name, metric, value, is_higher_better) of each metric on
        the scores ([n] or [K, n] f64 tensor); the metric values are 0-d
        tensors on the scores' device until :meth:`_read` reads them. feval
        gets the scores as the JAX package passes them: flat class-major
        [K * n] numpy."""
        out = []
        obj = self._booster.objective
        for m in metrics:
            for name, v in zip(m.names, m.eval(score, obj)):
                out.append((data_name, name, v,
                            m.factor_to_bigger_better > 0))
        if feval is not None:
            res = feval(score.detach().cpu().numpy().reshape(-1), dataset)
            if isinstance(res, tuple):
                res = [res]
            for name, v, is_higher_better in res:
                out.append((data_name, name, v, is_higher_better))
        return out

    @staticmethod
    def _read(results: list) -> list:
        """The results with every tensor value read back as a float, with
        one device-to-host copy."""
        idx = [i for i, r in enumerate(results)
               if isinstance(r[2], torch.Tensor)]
        if not idx:
            return results
        vals = torch.stack([results[i][2].reshape(()).to(torch.float64)
                            for i in idx]).cpu().tolist()
        out = list(results)
        for i, v in zip(idx, vals):
            out[i] = (out[i][0], out[i][1], v, out[i][3])
        return out

    def _eval_train(self, feval=None) -> list:
        return self._eval_one(self._booster.train_score.score, self._metrics,
                              self._train_data_name, feval, self.train_set)

    def _eval_valid(self, feval=None) -> list:
        out = []
        b = self._booster
        for i, (su, metrics) in enumerate(zip(b.valid_score,
                                              b.valid_metrics)):
            out.extend(self._eval_one(su.score, metrics,
                                      self.name_valid_sets[i], feval,
                                      self._valid_sets[i]))
        return out

    def _evaluate(self, eval_train: bool, feval=None) -> list:
        """One round's results: the training set's when `eval_train`, then
        every validation set's, read back with one copy."""
        out = self._eval_train(feval) if eval_train else []
        return self._read(out + self._eval_valid(feval))

    def eval_train(self, feval=None) -> list:
        return self._read(self._eval_train(feval))

    def eval_valid(self, feval=None) -> list:
        return self._read(self._eval_valid(feval))

    def eval(self, data: Dataset, name: str, feval=None) -> list:
        if data is self.train_set:
            return self._read(self._eval_one(
                self._booster.train_score.score, self._metrics, name, feval,
                data))
        for i, vs in enumerate(self._valid_sets):
            if data is vs:
                return self._read(self._eval_one(
                    self._booster.valid_score[i].score,
                    self._booster.valid_metrics[i], name, feval, data))
        raise LightGBMError("Data for eval must be train or valid set")

    def current_iteration(self) -> int:
        return self._booster.current_iteration

    def num_trees(self) -> int:
        return len(self._booster.models)

    def predict(self, data, num_iteration: Optional[int] = None,
                raw_score: bool = False, pred_leaf: bool = False,
                pred_contrib: bool = False, start_iteration: int = 0,
                **kwargs):
        """Predictions of the first `num_iteration` iterations from
        `start_iteration`: [n] for one tree per iteration, [n, K] for K
        (multiclass); through the objective's output transform (softmax,
        a sigmoid per class for one-vs-all, exp for the log-link
        regressions) unless `raw_score`; with `pred_leaf` the [n, T] int32
        leaf indices. ``predict_device`` (a keyword here or a parameter of
        the Booster; unset, its ``device_type``) picks the walk: ``cuda``
        the kernel on the card, ``cpu`` the numpy walk.
        ``predict_disable_shape_check`` lets the rows have another number
        of features (the walk reads the model's features only)."""
        if pred_contrib:
            raise LightGBMError(
                "pred_contrib (SHAP values) is not ported: ROADMAP queue A, "
                "item 8, step 2 (TreeSHAP as a CUDA kernel)")
        X = np.asarray(data, dtype=np.float64)
        nf = self._booster.max_feature_idx + 1
        cfg = self._predict_config(kwargs)
        if X.ndim != 2 or (X.shape[1] != nf and not (
                cfg.predict_disable_shape_check and X.shape[1] >= nf)):
            raise LightGBMError("The number of features in data (%s) is not "
                                "the same as it was in training data (%d)"
                                % (X.shape[1:] or X.shape, nf))
        device = cfg.predict_device
        num_iteration = self._default_iterations(num_iteration)
        if pred_leaf:
            return self._booster.predict_leaf_index(
                X, start_iteration, num_iteration, device=device)
        return self._booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=num_iteration, device=device)

    _PREDICT_KEYS = ("predict_device", "predict_backend",
                     "predict_disable_shape_check")

    def _predict_config(self, kwargs: dict) -> Config:
        """The Booster's parameters with `kwargs`' prediction keys on top
        (unknown keywords raise). ``pred_early_stop`` in the parameters of
        a binary, multiclass or multiclassova model raises: the JAX package
        honours it there (basic.py:688-713), and its margin exit is not
        ported."""
        bad = [k for k in kwargs if k not in self._PREDICT_KEYS]
        if bad:
            raise TypeError("predict() got unexpected keyword arguments %s"
                            % bad)
        cfg = Config(dict(self.params, **kwargs))
        obj = self._booster.objective
        if cfg.pred_early_stop and obj is not None and obj.name in (
                "binary", "multiclass", "multiclassova"):
            raise LightGBMError(
                "pred_early_stop (the margin exit of prediction) is not "
                "ported: ROADMAP queue A, item 8, step 2")
        return cfg

    def _default_iterations(self, num_iteration: Optional[int]) -> int:
        """num_iteration, by default the best iteration when early stopping
        set one (> 0), else all (-1)."""
        if num_iteration is None:
            return self.best_iteration if self.best_iteration > 0 else -1
        return num_iteration

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return self._booster.save_model_to_string(
            start_iteration, self._default_iterations(num_iteration))

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self
