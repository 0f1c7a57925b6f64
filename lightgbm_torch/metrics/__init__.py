"""Evaluation metrics of the port (lightgbm_tpu/metrics/, reference
src/metric/): f64 torch functions of the scores on their device."""
from .base import Metric, create_metric
from . import multiclass, pointwise, rank  # noqa: F401 — the registry

__all__ = ["Metric", "create_metric"]
