"""Multiclass objectives: softmax and one-vs-all.

The port's counterpart of lightgbm_tpu/objectives/multiclass.py:19-168
(reference src/objective/multiclass_objective.hpp): K trees per iteration
(NumModelPerIteration), class-major [K, n] scores (the reference's
``num_data * k + i``), the softmax grad/hess (:84-126) over the class axis,
and one binary log-loss per class for one-vs-all.

The persistent grower's per-class gradient (``payload_grad_fn_multi``)
reads the payload's snapshot of the K score rows at the iteration's start
and the label row, which holds the class index as f32. Softmax recomputes
its normalization for every class, O(K^2 n) per iteration, as the JAX
package does: the payload permutes between class trees, so a shared
denominator would need a payload row of its own. The math is f64, rounded
once to f32, with the class sums taken in class order: torch's ``exp``
differs in the last bit between the card and the CPU, and the card must
grow the CPU's trees. The v1 grower's ``get_gradients`` is the same
softmax in the scores' f64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import K_EPSILON, ObjectiveFunction, exp, register
from .binary import BinaryLogloss


def _class_of(label):
    """The class index of a label vector (numpy or torch)."""
    if isinstance(label, np.ndarray):
        return label.astype(np.int32)
    return label.to(torch.int32)


def softmax_class(scores, cls: int):
    """p[cls] of the softmax over the class axis of `scores` [K, n]: the
    maximum subtracted, the exponentials summed in class order."""
    m = scores[0]
    for k in range(1, scores.shape[0]):
        m = torch.maximum(m, scores[k])
    e = [torch.exp(scores[k] - m) for k in range(scores.shape[0])]
    total = e[0]
    for k in range(1, len(e)):
        total = total + e[k]
    return e[cls] / total


@register
class MulticlassSoftmax(ObjectiveFunction):
    name = "multiclass"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self._dev = {}

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        label_int = self.label.astype(np.int32)
        if label_int.min() < 0 or label_int.max() >= self.num_class:
            Log.fatal("Label must be in [0, %d), but found %d in label"
                      % (self.num_class, int(label_int.min()
                                             if label_int.min() < 0
                                             else label_int.max())))
        self.label_int = label_int
        if self.weight is None:
            probs = np.bincount(label_int, minlength=self.num_class) \
                .astype(np.float64)
            sum_weight = float(num_data)
        else:
            probs = np.zeros(self.num_class)
            np.add.at(probs, label_int, self.weight.astype(np.float64))
            sum_weight = float(np.sum(self.weight))
        self.class_init_probs = probs / sum_weight
        self._dev = {}

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def _device_inputs(self, device):
        key = str(device)
        if key not in self._dev:
            w = (torch.as_tensor(self.weight, device=device)
                 if self.weight is not None else None)
            self._dev[key] = (torch.as_tensor(self.label_int, device=device),
                              w)
        return self._dev[key]

    def get_gradients(self, score):
        """[K, n] grad/hess of the [K, n] scores, in their dtype."""
        label, weight = self._device_inputs(score.device)
        gs, hs = [], []
        for k in range(self.num_class):
            p = softmax_class(score, k)
            g = p - (label == k).to(p.dtype)
            h = 2.0 * p * (1.0 - p)
            if weight is not None:
                g, h = g * weight, h * weight
            gs.append(g)
            hs.append(h)
        return torch.stack(gs), torch.stack(hs)

    def payload_grad_fn_multi(self):
        """Class `cls`'s softmax grad/hess from the payload's snapshot rows
        (multiclass_objective.hpp:84-126); weights multiply after it, in
        the grower."""

        def fn(scores, label, cls):
            p = softmax_class(scores.double(), cls)
            onehot = (_class_of(label) == cls).to(p.dtype)
            return (p - onehot).float(), (2.0 * p * (1.0 - p)).float()
        return fn

    def boost_from_score(self, class_id):
        return float(np.log(max(K_EPSILON, self.class_init_probs[class_id])))

    def class_need_train(self, class_id):
        p = self.class_init_probs[class_id]
        return not (abs(p) <= K_EPSILON or abs(p) >= 1.0 - K_EPSILON)

    def convert_output(self, raw):
        """[..., K] raw scores -> softmax probabilities."""
        if isinstance(raw, torch.Tensor):
            e = torch.exp(raw - raw.amax(-1, keepdim=True))
            return e / e.sum(-1, keepdim=True)
        m = np.max(raw, axis=-1, keepdims=True)
        e = np.exp(raw - m)
        return e / np.sum(e, axis=-1, keepdims=True)

    def to_string(self):
        return "%s num_class:%d" % (self.name, self.num_class)


@register
class MulticlassOVA(ObjectiveFunction):
    name = "multiclassova"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        self.sigmoid = float(config.sigmoid)
        self.binary_losses = [
            BinaryLogloss(config, is_pos=lambda y, k=k: _class_of(y) == k)
            for k in range(self.num_class)]

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        for b in self.binary_losses:
            b.init(metadata, num_data)

    @property
    def num_model_per_iteration(self):
        return self.num_class

    def get_gradients(self, score):
        """[K, n] per-class binary grads of the [K, n] scores."""
        gs, hs = zip(*(b.get_gradients(score[k])
                       for k, b in enumerate(self.binary_losses)))
        return torch.stack(gs), torch.stack(hs)

    def payload_grad_fn_multi(self):
        """Class `cls`'s one-vs-all binary grads (multiclass_objective.hpp:
        180+), positives where the payload label is `cls`. A class with
        nothing to train has no function; the booster grows no tree for
        it."""
        fns = [b.payload_grad_fn() for b in self.binary_losses]

        def fn(scores, label, cls):
            return fns[cls](scores[cls], label)
        return fn

    def boost_from_score(self, class_id):
        return self.binary_losses[class_id].boost_from_score(0)

    def class_need_train(self, class_id):
        return self.binary_losses[class_id].class_need_train(0)

    def convert_output(self, raw):
        return 1.0 / (1.0 + exp(-self.sigmoid * raw))

    def to_string(self):
        return "%s num_class:%d sigmoid:%g" % (self.name, self.num_class,
                                               self.sigmoid)
