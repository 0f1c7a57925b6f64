"""Objective function interface + factory of the port.

The port's counterpart of lightgbm_tpu/objectives/base.py (reference
include/LightGBM/objective_function.h, factory
src/objective/objective_function.cpp:15-53). Per-row (grad, hess) math is a
plain torch function of the score tensor on its device; the scalar
decisions (BoostFromScore) stay host-side numpy.

Ported: ``binary``, ``multiclass`` (softmax), ``multiclassova`` and the
regression objectives with a payload gradient (``regression``, ``huber``,
``fair``, ``poisson``, ``gamma``, ``tweedie``). The objectives that need
leaf renewal (``regression_l1``, ``quantile``, ``mape``), cross-entropy and
ranking raise and name the ROADMAP.md item that will bring them.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.log import Log

# reference include/LightGBM/meta.h:51
K_EPSILON = 1e-15

_ITEM17 = "ROADMAP.md queue A, item 17: other objectives"
# objectives of the JAX package the port does not train yet, and why
_NOT_PORTED = {
    "regression_l1": "leaf renewal", "quantile": "leaf renewal",
    "mape": "leaf renewal", "cross_entropy": "cross-entropy",
    "cross_entropy_lambda": "cross-entropy", "lambdarank": "ranking",
    "rank_xendcg": "ranking",
}

# the objectives the port trains (their canonical names, config.py)
PORTED = ("binary", "multiclass", "multiclassova", "regression", "huber",
          "fair", "poisson", "gamma", "tweedie")

_REGISTRY: Dict[str, type] = {}


def exp(x):
    """exp of a numpy array or a torch tensor (``convert_output`` serves
    both: predictions on the host, metrics on the scores' device)."""
    return torch.exp(x) if isinstance(x, torch.Tensor) else np.exp(x)


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

    @property
    def is_constant_hessian(self) -> bool:
        return False

    def class_need_train(self, class_id: int) -> bool:
        return True

    def get_gradients(self, score):
        """(grad, hess) tensors for a score tensor ([n], or [K, n] class-
        major for K models per iteration), on its device."""
        raise NotImplementedError

    def payload_grad_fn(self):
        """fn(score, label) -> f32 (grad, hess) of the persistent grower,
        from the payload's f32 score and label rows; None when this
        objective needs more than the label (the learner then keeps the v1
        grower). Sample weights ride the payload and multiply after it."""
        return None

    def payload_grad_fn_multi(self):
        """The K-models-per-iteration form: fn(scores [K, n], label, cls)
        -> f32 (grad, hess) of class `cls`, from the payload's snapshot of
        the K score rows at the iteration's start. None when unsupported."""
        return None

    def device_gradients(self):
        """The persistent grower's gradient contract, ("payload", fn), or
        None when the objective has none (lightgbm_tpu/objectives/base.py:
        64-86). The JAX package also has a "pos" and a "row" mode
        (lambdarank, objectives with per-row inputs beyond the label); the
        port's objectives have the payload mode only."""
        multi = self.num_model_per_iteration > 1
        fn = self.payload_grad_fn_multi() if multi else self.payload_grad_fn()
        return None if fn is None else ("payload", fn)

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw):
        """Raw scores -> predictions (ConvertOutput), for a numpy array or
        a torch tensor."""
        return raw

    def to_string(self) -> str:
        return self.name


def create_objective(name: str, config) -> Optional[ObjectiveFunction]:
    """ObjectiveFunction::CreateObjectiveFunction; None for 'none'."""
    from . import binary, multiclass, regression  # noqa: F401 — registry
    if name in ("none", "null", "custom", "na", ""):
        return None
    if name in _NOT_PORTED:
        Log.fatal("objective '%s' is not ported yet: it needs %s (%s)"
                  % (name, _NOT_PORTED[name], _ITEM17))
    if name not in _REGISTRY:
        Log.fatal("Unknown objective type name: %s" % name)
    return _REGISTRY[name](config)


def parse_objective_string(s: str, config) -> Optional[ObjectiveFunction]:
    """Rebuild an objective from a model-file string like 'binary
    sigmoid:1' or 'multiclass num_class:5' (reference
    CreateObjectiveFunction(str) overload)."""
    parts = s.strip().split()
    if not parts:
        return None
    for tok in parts[1:]:
        if ":" in tok:
            k, v = tok.split(":", 1)
            if k == "sigmoid":
                config.sigmoid = float(v)
            elif k == "num_class":
                config.num_class = int(v)
        elif tok == "sqrt":
            config.reg_sqrt = True
    return create_objective(parts[0], config)
