"""Cross-entropy objectives for continuous labels in [0, 1].

The port's counterpart of lightgbm_tpu/objectives/xentropy.py:17-96
(reference src/objective/xentropy_objective.hpp:44-262): plain
cross-entropy with the logistic link (:77-96) and its weight-lambda
parameterization (:185-213), with the JAX package's label and weight
checks. The gradients are torch ops in the score's dtype (f64 for the
boosting scores, as the JAX package's ``grad_fn``). They read the sample
weights themselves (``cross_entropy_lambda``'s gradient is not linear in
the weight), so neither has a payload gradient: the persistent grower runs
them on the row-ordered scores (its "row" mode, ``device_gradients``).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import K_EPSILON, ObjectiveFunction, exp, register
from .regression import _rdiv


class _XentBase(ObjectiveFunction):
    _DEVICE = ("label", "weight")

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.label.min() < 0.0 or self.label.max() > 1.0:
            Log.fatal("[%s]: label outside [0, 1]" % self.name)

    def _average(self) -> float:
        if self.weight is not None:
            return float(np.sum(self.label * self.weight)
                         / np.sum(self.weight))
        return float(np.mean(self.label))


@register
class CrossEntropy(_XentBase):
    name = "cross_entropy"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.weight is not None:
            if self.weight.min() < 0.0:
                Log.fatal("[%s]: at least one weight is negative"
                          % self.name)
            if self.weight.sum() == 0.0:
                Log.fatal("[%s]: sum of weights is zero" % self.name)

    def get_gradients(self, score):
        label, weight = self._device_inputs(score.device)
        z = _rdiv(1.0, 1.0 + torch.exp(-score))
        g = z - label
        h = z * (1.0 - z)
        if weight is None:
            return g, h
        return g * weight, h * weight

    def boost_from_score(self, class_id):
        pavg = min(max(self._average(), K_EPSILON), 1.0 - K_EPSILON)
        initscore = float(np.log(pavg / (1.0 - pavg)))
        Log.info("[%s]: pavg = %f -> initscore = %f"
                 % (self.name, pavg, initscore))
        return initscore

    def convert_output(self, raw):
        return 1.0 / (1.0 + exp(-raw))


@register
class CrossEntropyLambda(_XentBase):
    name = "cross_entropy_lambda"

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if self.weight is not None and self.weight.min() <= 0.0:
            Log.fatal("[%s]: at least one weight is non-positive"
                      % self.name)

    def get_gradients(self, score):
        label, weight = self._device_inputs(score.device)
        if weight is None:
            z = _rdiv(1.0, 1.0 + torch.exp(-score))
            return z - label, z * (1.0 - z)
        epf = torch.exp(score)
        hhat = torch.log1p(epf)
        z = 1.0 - torch.exp(-weight * hhat)
        enf = _rdiv(1.0, epf)
        g = (1.0 - label / z) * weight / (1.0 + enf)
        c = _rdiv(1.0, 1.0 - z)
        d = 1.0 + epf
        a = weight * epf / (d * d)
        d = c - 1.0
        b = (c / (d * d)) * (1.0 + weight * epf - c)
        return g, a * (1.0 + label * b)

    def boost_from_score(self, class_id):
        havg = self._average()
        initscore = float(np.log(np.exp(havg) - 1.0))
        Log.info("[%s]: havg = %f -> initscore = %f"
                 % (self.name, havg, initscore))
        return initscore

    def convert_output(self, raw):
        if isinstance(raw, torch.Tensor):
            return torch.log1p(torch.exp(raw))
        return np.log1p(np.exp(raw))
