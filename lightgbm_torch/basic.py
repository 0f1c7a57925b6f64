"""User-facing Dataset and Booster of the port.

The port of the slice of lightgbm_tpu/basic.py that training needs: a
``Dataset`` from an in-memory numpy matrix and a ``Booster`` that trains
(``update``), predicts, and writes and reads LightGBM model text.

Device: the ``device_type`` parameter, ``cuda`` by default, ``cpu`` on
request. A CUDA request on a machine without a card raises; it never falls
back to the CPU. A Booster read from model text predicts with the numpy
walk on the host and touches no device.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from .boosting import GBDT
from .config import Config
from .data.dataset import BinnedDataset
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

    def __init__(self, data, label=None, weight=None, init_score=None,
                 feature_name="auto", categorical_feature="auto",
                 params: Optional[Dict[str, Any]] = None,
                 free_raw_data: bool = True):
        self.data = data
        self.label = label
        self.weight = weight
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
        device = resolve_device(cfg)
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
        self._inner = BinnedDataset.from_matrix(
            X, cfg, label=self.label, weight=self.weight,
            init_score=self.init_score, feature_names=names)
        self._inner.to_device(device)
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
        self._booster = GBDT()
        if train_set is not None:
            if not isinstance(train_set, Dataset):
                raise TypeError("Training data should be Dataset instance, "
                                "met %s" % type(train_set).__name__)
            cfg = Config(self.params)
            device = resolve_device(cfg)
            train_set.params.update(self.params)
            inner = train_set.construct()._inner
            objective = create_objective(cfg.objective, cfg)
            if objective is not None:
                objective.init(inner.metadata, inner.num_data)
            self._booster.init(cfg, inner, objective, device)
        elif model_file is not None or model_str is not None:
            if model_file is not None:
                with open(model_file) as f:
                    model_str = f.read()
            self._booster.config = Config(self.params)
            self._booster.load_model_from_string(model_str)
        else:
            raise TypeError("Need at least one training dataset or model "
                            "file or model string to create Booster instance")

    def update(self) -> bool:
        """One boosting round. Returns True when no further splits were
        possible (training finished)."""
        return self._booster.train_one_iter()

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
            num_iteration=-1 if num_iteration is None else num_iteration)

    def model_to_string(self, num_iteration: Optional[int] = None,
                        start_iteration: int = 0) -> str:
        return self._booster.save_model_to_string(
            start_iteration, -1 if num_iteration is None else num_iteration)

    def save_model(self, filename: str, num_iteration: Optional[int] = None,
                   start_iteration: int = 0) -> "Booster":
        with open(filename, "w") as f:
            f.write(self.model_to_string(num_iteration, start_iteration))
        return self
