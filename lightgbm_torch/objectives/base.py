"""Objective function interface + factory of the port.

The port's counterpart of lightgbm_tpu/objectives/base.py (reference
include/LightGBM/objective_function.h, factory
src/objective/objective_function.cpp:15-53). Per-row (grad, hess) math is a
plain torch function of the score tensor on its device; the scalar
decisions (BoostFromScore) stay host-side numpy.

Only ``binary`` is in this slice; every other objective name raises and
names the ROADMAP.md item that will bring it.
"""
from __future__ import annotations

from typing import Dict, Optional

from ..utils.log import Log

# reference include/LightGBM/meta.h:51
K_EPSILON = 1e-15

_REGISTRY: Dict[str, type] = {}


def register(cls):
    _REGISTRY[cls.name] = cls
    return cls


class ObjectiveFunction:
    """Base objective (objective_function.h)."""

    name = "none"

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label = None
        self.weight = None

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    def class_need_train(self, class_id: int) -> bool:
        return True

    def get_gradients(self, score):
        """(grad, hess) tensors for a score tensor, on its device."""
        raise NotImplementedError

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw):
        return raw

    def to_string(self) -> str:
        return self.name


def create_objective(name: str, config) -> Optional[ObjectiveFunction]:
    """ObjectiveFunction::CreateObjectiveFunction; None for 'none'."""
    from . import binary  # noqa: F401 — populates the registry
    if name in ("none", "null", "custom", "na", ""):
        return None
    if name not in _REGISTRY:
        Log.fatal("objective '%s' is not ported yet; only 'binary' is "
                  "(ROADMAP.md queue A, item 17: other objectives)" % name)
    return _REGISTRY[name](config)


def parse_objective_string(s: str, config) -> Optional[ObjectiveFunction]:
    """Rebuild an objective from a model-file string like 'binary
    sigmoid:1' (reference CreateObjectiveFunction(str) overload)."""
    parts = s.strip().split()
    if not parts:
        return None
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            if k == "sigmoid":
                config.sigmoid = float(v)
    return create_objective(parts[0], config)
