"""Metric interface + factory of the port.

The port's counterpart of lightgbm_tpu/metrics/base.py (reference
include/LightGBM/metric.h, factory src/metric/metric.cpp:16-60). A metric
evaluates the raw scores where they live: ``eval(score, objective)`` takes
the f64 score tensor of a dataset ([n] for one tree per iteration, [K, n]
class-major otherwise) and returns one 0-d f64 tensor per name on the
score's device, so that an evaluation round reads all its values back
with one copy. Labels and weights are held as f64 tensors on that device;
the per-dataset constants (the sum of weights, label checks) are computed
once on the host with numpy, as the JAX package computes them.
"""
from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..utils.log import Log

K_EPSILON = 1e-15


class Metric:
    """Base metric (metric.h). ``names`` and ``factor_to_bigger_better`` as
    in the JAX package; ``eval`` returns 0-d tensors aligned with
    ``names``."""

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label: Optional[np.ndarray] = None     # host f32, as given
        self.weight: Optional[np.ndarray] = None
        self.sum_weights = 0.0
        self.label_t: Optional[torch.Tensor] = None  # device f64
        self.weight_t: Optional[torch.Tensor] = None

    @property
    def names(self) -> List[str]:
        raise NotImplementedError

    @property
    def factor_to_bigger_better(self) -> float:
        """-1 for losses (smaller is better), +1 for scores."""
        return -1.0

    def init(self, metadata, num_data: int, device="cpu") -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        if self.weight is None:
            self.sum_weights = float(num_data)
        else:
            self.sum_weights = float(np.sum(self.weight))
        self.label_t = torch.as_tensor(
            np.asarray(self.label, np.float64), device=device)
        self.weight_t = (None if self.weight is None else torch.as_tensor(
            np.asarray(self.weight, np.float64), device=device))

    def eval(self, score: torch.Tensor, objective) -> List[torch.Tensor]:
        raise NotImplementedError

    def _weighted_sum(self, pt: torch.Tensor) -> torch.Tensor:
        return (pt * self.weight_t).sum() if self.weight_t is not None \
            else pt.sum()


_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.metric_name] = cls
    return cls


def create_metric(name: str, config) -> Optional[Metric]:
    """Metric::CreateMetric (src/metric/metric.cpp:16). None for 'none' and
    for an unknown name (with a warning, as the JAX package)."""
    from . import multiclass, pointwise, rank  # noqa: F401 — the registry
    if name in ("none", "null", "custom", "na", ""):
        return None
    if name not in _REGISTRY:
        Log.warning("Unknown metric type name: %s" % name)
        return None
    return _REGISTRY[name](config)
