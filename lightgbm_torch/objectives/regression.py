"""Regression objectives with a payload gradient.

The port's counterpart of lightgbm_tpu/objectives/regression.py:26-382
(reference src/objective/regression_objective.hpp): L2 (with ``reg_sqrt``),
Huber, Fair, Poisson, Gamma and Tweedie. Each has the v1 grower's
``get_gradients`` (torch ops in the score's dtype, f64 for the boosting
scores, as the JAX package's ``grad_fn``), the persistent grower's
``payload_grad_fn`` (f32 score and label rows of the payload; sample
weights multiply after it, in the grower), ``boost_from_score``,
``convert_output`` and ``to_string``.

Payload gradients: L2, Huber and Fair are the JAX package's f32 operations,
one rounding each, in its order (so equal to it bit for bit). Poisson,
Gamma and Tweedie need ``exp``, which torch computes differently in the
last f32 bit on the card and on the CPU; they are computed in f64 and
rounded once to f32, as binary's, so the card grows the CPU's trees (about
an f32 ulp from the JAX package's f32 gradients).

``reg_sqrt`` trains on a transformed label that the payload does not hold,
so it has no payload gradient and takes the v1 grower. L1, Quantile and
MAPE need leaf renewal and are refused in base.py (ROADMAP.md queue A,
item 17).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import ObjectiveFunction, exp, register


def _sign(x):
    """+-1 / 0 in x's dtype (NaN -> 0, unlike torch.sign)."""
    return torch.where(x > 0, 1.0, torch.where(x < 0, -1.0,
                                               torch.zeros_like(x)))


def _rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x with one rounding in x's dtype (python's ``c / x`` on a
    tensor is x.reciprocal() * c, two roundings). The constant is filled
    on x's device: no host-to-device copy, so a CUDA graph can hold it."""
    return torch.div(x.new_full((), c), x)


@register
class RegressionL2Loss(ObjectiveFunction):
    """L2 loss (regression_objective.hpp:93-199)."""

    name = "regression"

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)
        self._dev = {}

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.sqrt:
            lab = self.label
            self.label = (np.sign(lab) * np.sqrt(np.fabs(lab))) \
                .astype(np.float32)
        self._dev = {}

    def _device_inputs(self, device):
        """(label, weight) on `device`, uploaded once."""
        key = str(device)
        if key not in self._dev:
            w = (torch.as_tensor(self.weight, device=device)
                 if self.weight is not None else None)
            self._dev[key] = (torch.as_tensor(self.label, device=device), w)
        return self._dev[key]

    def get_gradients(self, score):
        label, weight = self._device_inputs(score.device)
        return self._grad(score, label, weight)

    def _grad(self, score, label, weight):
        diff = score - label
        if weight is None:
            return diff, torch.ones_like(diff)
        return diff * weight, weight.to(diff.dtype)

    def payload_grad_fn(self):
        # sqrt trains on the transformed label, which the payload lacks
        if self.sqrt:
            return None
        base = self._grad

        def fn(score, label):
            return base(score, label, None)
        return fn

    @property
    def is_constant_hessian(self):
        return self.weight is None

    def boost_from_score(self, class_id):
        if self.weight is not None:
            return float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        return float(np.mean(self.label))

    def convert_output(self, raw):
        if self.sqrt:
            sign = torch.sign if isinstance(raw, torch.Tensor) else np.sign
            return sign(raw) * raw * raw
        return raw

    def to_string(self):
        return self.name + (" sqrt" if self.sqrt else "")


class _NoSqrt(RegressionL2Loss):
    """The objectives for which the reference turns reg_sqrt off."""

    def __init__(self, config):
        super().__init__(config)
        if self.sqrt:
            Log.warning("Cannot use sqrt transform in %s Regression, "
                        "will auto disable it" % self.name)
            self.sqrt = False

    def convert_output(self, raw):
        return raw

    @property
    def is_constant_hessian(self):
        return False

    def to_string(self):
        return self.name


@register
class RegressionHuberLoss(_NoSqrt):
    """Huber loss (regression_objective.hpp:290)."""

    name = "huber"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = float(config.alpha)

    def _grad(self, score, label, weight):
        a = self.alpha
        diff = score - label
        g = torch.where(torch.abs(diff) <= a, diff, _sign(diff) * a)
        if weight is None:
            return g, torch.ones_like(g)
        return g * weight, weight.to(g.dtype)


@register
class RegressionFairLoss(RegressionL2Loss):
    """Fair loss (regression_objective.hpp:352). Unlike Huber it keeps
    reg_sqrt, as in the JAX package."""

    name = "fair"

    def __init__(self, config):
        super().__init__(config)
        self.c = float(config.fair_c)

    def _grad(self, score, label, weight):
        c = self.c
        x = score - label
        denom = torch.abs(x) + c
        g = c * x / denom
        h = _rdiv(c * c, denom * denom)
        if weight is None:
            return g, h
        return g * weight, h * weight

    @property
    def is_constant_hessian(self):
        return False

    def to_string(self):
        return self.name


class _Exp(_NoSqrt):
    """The log-link objectives: their payload gradients need exp, so they
    are computed in f64 and rounded once to f32."""

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if np.min(self.label) < 0.0:
            Log.fatal("[%s]: at least one target label is negative"
                      % self.name)
        if np.sum(self.label) == 0.0:
            Log.fatal("[%s]: sum of labels is zero" % self.name)

    def payload_grad_fn(self):
        base = self._grad

        def fn(score, label):
            g, h = base(score.double(), label.double(), None)
            return g.float(), h.float()
        return fn

    def boost_from_score(self, class_id):
        mean = RegressionL2Loss.boost_from_score(self, class_id)
        # Common::SafeLog
        return float(np.log(mean)) if mean > 0 else -np.inf

    def convert_output(self, raw):
        return exp(raw)


@register
class RegressionPoissonLoss(_Exp):
    """Poisson regression; the score is the log intensity
    (regression_objective.hpp:399)."""

    name = "poisson"

    def __init__(self, config):
        super().__init__(config)
        self.max_delta_step = float(config.poisson_max_delta_step)

    def _grad(self, score, label, weight):
        g = torch.exp(score) - label
        h = torch.exp(score + self.max_delta_step)
        if weight is None:
            return g, h
        return g * weight, h * weight


@register
class RegressionGammaLoss(_Exp):
    """Gamma regression (regression_objective.hpp:676)."""

    name = "gamma"

    def _grad(self, score, label, weight):
        exps = torch.exp(score)
        if weight is None:
            return 1.0 - label / exps, label / exps
        # reference :700-702 applies the weight inside the subtraction
        return 1.0 - label / exps * weight, label / exps * weight


@register
class RegressionTweedieLoss(_Exp):
    """Tweedie regression (regression_objective.hpp:711)."""

    name = "tweedie"

    def __init__(self, config):
        super().__init__(config)
        self.rho = float(config.tweedie_variance_power)

    def _grad(self, score, label, weight):
        rho = self.rho
        e1 = torch.exp((1 - rho) * score)
        e2 = torch.exp((2 - rho) * score)
        g = -label * e1 + e2
        h = -label * (1 - rho) * e1 + (2 - rho) * e2
        if weight is None:
            return g, h
        return g * weight, h * weight
