"""Objective function interface + factory of the port.

The port's counterpart of lightgbm_tpu/objectives/base.py (reference
include/LightGBM/objective_function.h, factory
src/objective/objective_function.cpp:15-53). Per-row (grad, hess) math is a
plain torch function of the score tensor on its device; the scalar
decisions (BoostFromScore) stay host-side numpy.

Ported: ``binary``, ``multiclass`` (softmax), ``multiclassova``, the
regression objectives (``regression`` with ``reg_sqrt``, ``regression_l1``,
``huber``, ``fair``, ``poisson``, ``quantile``, ``mape``, ``gamma``,
``tweedie``) and cross-entropy (``cross_entropy``,
``cross_entropy_lambda``). L1, quantile and MAPE re-fit each leaf's output
from its rows' residual percentile after the tree is grown
(``is_renew_tree_output``; the percentile helpers below, the kernel in
ops/renew.py). Ranking raises and names the ROADMAP.md item that will bring
it.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from ..utils.log import Log

# reference include/LightGBM/meta.h:51
K_EPSILON = 1e-15

_ITEM17 = "ROADMAP.md queue A, item 17.4: ranking"
# objectives of the JAX package the port does not train yet, and why
_NOT_PORTED = {"lambdarank": "query groups", "rank_xendcg": "query groups"}

# the objectives the port trains (their canonical names, config.py)
PORTED = ("binary", "multiclass", "multiclassova", "regression",
          "regression_l1", "huber", "fair", "poisson", "quantile", "mape",
          "gamma", "tweedie", "cross_entropy", "cross_entropy_lambda")

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
    # the host arrays (attribute names) that the device functions read
    _DEVICE = ()

    def __init__(self, config):
        self.config = config
        self.num_data = 0
        self.label = None
        self.weight = None
        self._dev = {}

    def init(self, metadata, num_data: int) -> None:
        self.num_data = num_data
        self.label = metadata.label
        self.weight = metadata.weight
        self._dev = {}

    def _on(self, device, name: str):
        """The host array attribute `name` (None stays None) as a tensor
        on `device`, uploaded once."""
        key = (str(device), name)
        if key not in self._dev:
            a = getattr(self, name)
            self._dev[key] = (None if a is None
                              else torch.as_tensor(a, device=device))
        return self._dev[key]

    def _device_inputs(self, device):
        """(label, weight) on `device`, uploaded once."""
        return self._on(device, "label"), self._on(device, "weight")

    @property
    def num_model_per_iteration(self) -> int:
        return 1

    @property
    def is_constant_hessian(self) -> bool:
        return False

    @property
    def is_renew_tree_output(self) -> bool:
        """Does each leaf's output get re-fit from its rows after the tree
        is grown (L1, quantile, MAPE)?"""
        return False

    def class_need_train(self, class_id: int) -> bool:
        return True

    def get_gradients(self, score):
        """(grad, hess) tensors for a score tensor ([n], or [K, n] class-
        major for K models per iteration), on its device."""
        raise NotImplementedError

    def upload(self, device) -> None:
        """Copy the per-row inputs that the device functions read (labels,
        weights: ``_DEVICE``) to `device`, once: the persistent grower
        calls it before an iteration, whose first run on the card allows
        no synchronizing copy and whose later runs replay a graph."""
        for name in self._DEVICE:
            self._on(device, name)

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
        """The persistent grower's gradient contract
        (lightgbm_tpu/objectives/base.py:63-86): ("payload", fn) with fn a
        payload_grad_fn (payload_grad_fn_multi for K models per iteration;
        None when that has none), else ("row", fn) with fn(score) ->
        (grad, hess) the v1 gradient of the [n] f64 row-ordered scores,
        which reads the objective's own row-ordered label and weights
        (ops/grow_persist.py:fill_grad_row). The JAX package's "pos" mode
        comes with ranking."""
        if self.num_model_per_iteration > 1:
            fn = self.payload_grad_fn_multi()
            return None if fn is None else ("payload", fn)
        fn = self.payload_grad_fn()
        if fn is not None:
            return ("payload", fn)
        return ("row", self.get_gradients)

    def boost_from_score(self, class_id: int) -> float:
        return 0.0

    def convert_output(self, raw):
        """Raw scores -> predictions (ConvertOutput), for a numpy array or
        a torch tensor."""
        return raw

    def to_string(self) -> str:
        return self.name


def percentile(data, alpha: float) -> float:
    """Reference PercentileFun (src/objective/regression_objective.hpp:
    18-51; the JAX package's objectives/base.py:214-235): the interpolated
    percentile counted from the top of the descending order."""
    data = np.asarray(data, dtype=np.float64)
    n = len(data)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(data[0])
    s = np.sort(data)[::-1]
    float_pos = (1.0 - alpha) * n
    pos = int(float_pos)
    if pos < 1:
        return float(s[0])
    if pos >= n:
        return float(s[-1])
    bias = float_pos - pos
    v1 = float(s[pos - 1])
    v2 = float(s[pos])
    return v1 - (v1 - v2) * bias


def weighted_percentile(data, weight, alpha: float) -> float:
    """Reference WeightedPercentileFun (regression_objective.hpp:53-90; the
    JAX package's objectives/base.py:238-256): a stable ascending sort, the
    sequential f64 cdf of the weights in that order, its right-side
    search for cdf[-1] * alpha, and an interpolation where the step at the
    found position weighs at least 1."""
    data = np.asarray(data, dtype=np.float64)
    weight = np.asarray(weight, dtype=np.float64)
    n = len(data)
    if n == 0:
        return 0.0
    if n <= 1:
        return float(data[0])
    order = np.argsort(data, kind="stable")
    cdf = np.cumsum(weight[order])
    threshold = cdf[-1] * alpha
    pos = min(int(np.searchsorted(cdf, threshold, side="right")), n - 1)
    if pos == 0 or pos == n - 1:
        return float(data[order[pos]])
    v1 = float(data[order[pos - 1]])
    v2 = float(data[order[pos]])
    if cdf[pos + 1] - cdf[pos] >= 1.0:
        return float((threshold - cdf[pos]) / (cdf[pos + 1] - cdf[pos])
                     * (v2 - v1) + v1)
    return v2


def create_objective(name: str, config) -> Optional[ObjectiveFunction]:
    """ObjectiveFunction::CreateObjectiveFunction; None for 'none'."""
    from . import binary, multiclass, regression, xentropy  # noqa: F401
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
