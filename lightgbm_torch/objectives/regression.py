"""Regression objectives.

The port's counterpart of lightgbm_tpu/objectives/regression.py:26-382
(reference src/objective/regression_objective.hpp): L2 (with ``reg_sqrt``),
L1, Huber, Fair, Poisson, Quantile, MAPE, Gamma and Tweedie. Each has the
v1 grower's ``get_gradients`` (torch ops in the score's dtype, f64 for the
boosting scores, as the JAX package's ``grad_fn``), the persistent grower's
``payload_grad_fn`` (f32 score and label rows of the payload; sample
weights multiply after it, in the grower) where the label is all it needs,
``boost_from_score``, ``convert_output`` and ``to_string``.

Payload gradients: L2, Huber and Fair are the JAX package's f32 operations,
one rounding each, in its order (so equal to it bit for bit). Poisson,
Gamma and Tweedie need ``exp``, which torch computes differently in the
last f32 bit on the card and on the CPU; they are computed in f64 and
rounded once to f32, as binary's, so the card grows the CPU's trees (about
an f32 ulp from the JAX package's f32 gradients).

``reg_sqrt`` trains on a transformed label that the payload does not hold,
and MAPE on a per-row label weight, so they have no payload gradient: the
persistent grower runs their ``get_gradients`` on the row-ordered scores
(its "row" mode, ``device_gradients``).

L1, Quantile and MAPE re-fit every leaf after the tree is grown
(``renew_tree_output``, the JAX package's gbdt.py:747-766): the leaf's
output becomes the (weighted) percentile of ``label - score`` over its
rows, computed per leaf by the ``renew_leaf`` kernel (ops/renew.py). As in
the JAX package the residual takes the dataset's label (not reg_sqrt's
transformed one) and the sample weights, or MAPE's label weights.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.renew import renew_segments
from ..utils.log import Log
from .base import (ObjectiveFunction, exp, percentile, register,
                   weighted_percentile)


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
    _DEVICE = ("label", "weight")

    def __init__(self, config):
        super().__init__(config)
        self.sqrt = bool(config.reg_sqrt)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        self.raw_label = self.label
        if self.sqrt:
            lab = self.label
            self.label = (np.sign(lab) * np.sqrt(np.fabs(lab))) \
                .astype(np.float32)

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


class _Renewed(RegressionL2Loss):
    """The objectives whose leaves are re-fit to a percentile of their
    rows' residuals: L1 and MAPE at the median, Quantile at alpha."""

    renew_alpha = 0.5
    renew_weight = "weight"
    _DEVICE = ("label", "weight", "raw_label")

    @property
    def is_renew_tree_output(self):
        return True

    def boost_from_score(self, class_id):
        w = getattr(self, self.renew_weight)
        if w is not None:
            return weighted_percentile(self.label, w, self.renew_alpha)
        return percentile(self.label, self.renew_alpha)

    def renew_tree_output(self, score, key, seg, out, nseg=None) -> None:
        """RenewTreeOutput (serial_tree_learner.cpp:628-666) of a tree's
        leaves: out[i] = the (weighted) percentile of label - score over
        the rows of segment i (a row's segment: the order of its `key`;
        ``seg`` [S, 2] int64 the segments' (start, count) in that order),
        for every segment with rows among the first ``nseg`` (a device
        scalar; None: all of them); the others keep their value. `score`:
        the [n] f64 row-ordered scores before the tree's update, on the
        kernel's device; `out` [S] f32 or f64, in place."""
        label = self._on(score.device, "raw_label")
        renew_segments(label.double() - score, key,
                       self._on(score.device, self.renew_weight), seg, out,
                       self.renew_alpha, nseg)


@register
class RegressionL1Loss(_Renewed):
    """L1 loss with weighted-median leaf renewal
    (regression_objective.hpp:204)."""

    name = "regression_l1"

    def _grad(self, score, label, weight):
        g = _sign(score - label)
        if weight is None:
            return g, torch.ones_like(g)
        return g * weight, weight.to(g.dtype)

    def convert_output(self, raw):
        return raw

    def to_string(self):
        return self.name


@register
class RegressionQuantileLoss(_Renewed):
    """Quantile (pinball) loss (regression_objective.hpp:479). alpha is
    kept as an f32, as in the reference and the JAX package: its gradient
    constants are f32, and the percentiles widen it."""

    name = "quantile"

    def __init__(self, config):
        super().__init__(config)
        self.alpha = np.float32(config.alpha)
        if not 0 < self.alpha < 1:
            Log.fatal("Quantile alpha should be in (0, 1)")
        self.renew_alpha = float(self.alpha)

    def _grad(self, score, label, weight):
        delta = (score - label).to(torch.float32)
        g = torch.where(delta >= 0,
                        delta.new_full((), float(np.float32(1.0)
                                                 - self.alpha)),
                        delta.new_full((), float(-self.alpha)))
        if weight is None:
            return g, torch.ones_like(g)
        return g * weight, weight

    def to_string(self):
        return self.name


@register
class RegressionMAPELoss(RegressionL1Loss):
    """MAPE loss (regression_objective.hpp:577): L1 with the label weight
    1 / max(1, |label|) (times the sample weight) in the gradient, the
    initial score and the renewal."""

    name = "mape"
    renew_weight = "label_weight"
    _DEVICE = ("label", "weight", "raw_label", "label_weight")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if np.any(np.fabs(self.label) < 1):
            Log.warning("Met 'abs(label) < 1', will convert them to '1' in "
                        "MAPE objective and metric")
        lw = 1.0 / np.maximum(1.0, np.fabs(self.label))
        if self.weight is not None:
            lw = lw * self.weight
        self.label_weight = lw.astype(np.float32)

    def get_gradients(self, score):
        label, weight = self._device_inputs(score.device)
        g = _sign(score - label) * self._on(score.device, "label_weight")
        if weight is None:
            return g, torch.ones_like(g)
        return g, weight.to(g.dtype)

    def payload_grad_fn(self):
        # the label weight is not a payload row: the "row" mode runs
        # get_gradients on the row-ordered scores
        return None

    @property
    def is_constant_hessian(self):
        return True


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
