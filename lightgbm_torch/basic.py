"""User-facing Dataset and Booster of the port.

The port of the slice of lightgbm_tpu/basic.py that training needs: a
``Dataset`` from an in-memory numpy matrix, with query groups for ranking
(``group=``, ``set_group``/``get_group``; a validation set bins with its
``reference``'s mappers and keeps its own groups), and a ``Booster`` that
trains (``update``), evaluates its training and validation sets
(``add_valid``, ``eval*``), predicts, and writes and reads LightGBM model
text.

Evaluation: the metrics run on the scores' device and return 0-d tensors;
one evaluation call reads all its values back with one copy.

Device: the ``device_type`` parameter, ``cuda`` by default, ``cpu`` on
request. A CUDA request on a machine without a card raises; it never falls
back to the CPU. A Booster read from model text predicts with the numpy
walk on the host and touches no device.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .boosting import GBDT
from .config import _METRIC_ALIASES, Config
from .data.dataset import BinnedDataset
from .metrics import create_metric
from .objectives import create_objective
from .utils.log import LightGBMError


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

    def construct(self) -> "Dataset":
        """Bin the matrix on the host and upload the bins to the device."""
        if self._inner is not None:
            return self
        cfg = Config(self.params)
        cat = self.categorical_feature
        if cat not in ("auto", None) and len(cat) > 0 or cfg.categorical_feature:
            raise LightGBMError("categorical features are not ported yet "
                                "(ROADMAP.md queue A, item 4: general split "
                                "scan)")
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
        self._inner = BinnedDataset.from_matrix(
            X, cfg, label=self.label, weight=self.weight, group=self.group,
            init_score=self.init_score, feature_names=names, reference=ref)
        if ref is None:
            # a validation set is uploaded by the Booster that evaluates
            # it, to its training device
            self._inner.to_device(resolve_device(cfg))
        if self.free_raw_data:
            self.data = None
        return self

    def set_label(self, label) -> "Dataset":
        """Replace the labels (of the binned dataset too, once built): a
        later Booster trains on them over the same bins."""
        self.label = label
        if self._inner is not None:
            self._inner.metadata.set_label(label)
        return self

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
            self._booster.config = Config(self.params)
            self._booster.load_model_from_string(model_str)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster instance")

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

    def update(self) -> bool:
        """One boosting round. Returns True when no further splits were
        possible (training finished)."""
        return self._booster.train_one_iter()

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
                raw_score: bool = False, start_iteration: int = 0):
        """Predictions of the first `num_iteration` iterations from
        `start_iteration`: [n] for one tree per iteration, [n, K] for K
        (multiclass); through the objective's output transform (softmax,
        a sigmoid per class for one-vs-all, exp for the log-link
        regressions) unless `raw_score`."""
        X = np.asarray(data, dtype=np.float64)
        nf = self._booster.max_feature_idx + 1
        if X.ndim != 2 or X.shape[1] != nf:
            raise LightGBMError("The number of features in data (%s) is not "
                                "the same as it was in training data (%d)"
                                % (X.shape[1:] or X.shape, nf))
        return self._booster.predict(
            X, raw_score=raw_score, start_iteration=start_iteration,
            num_iteration=self._default_iterations(num_iteration))

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
