"""Binary log-loss objective.

The port's counterpart of lightgbm_tpu/objectives/binary.py (reference
src/objective/binary_objective.hpp:21-221): label-conditional +-1 encoding
and per-class weights (is_unbalance / scale_pos_weight, :95-105), the
sigmoid-scaled logistic grad/hess (:109-140) as torch ops on the score's
device, and the BoostFromScore prior log-odds (:143-165).
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import K_EPSILON, ObjectiveFunction, exp, register


@register
class BinaryLogloss(ObjectiveFunction):
    name = "binary"

    def __init__(self, config, is_pos=None):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid parameter %f should be greater than zero"
                      % self.sigmoid)
        self.is_unbalance = bool(config.is_unbalance)
        self.scale_pos_weight = float(config.scale_pos_weight)
        if self.is_unbalance and abs(self.scale_pos_weight - 1.0) > 1e-6:
            Log.fatal("Cannot set is_unbalance and scale_pos_weight "
                      "at the same time")
        # which labels are positives: label > 0, or one class of a
        # one-vs-all objective (multiclass.py); works on numpy and torch
        self.is_pos = is_pos if is_pos is not None else (lambda y: y > 0)
        self.need_train = True
        self._dev = {}

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        pos_mask = np.asarray(self.is_pos(self.label))
        cnt_positive = int(np.count_nonzero(pos_mask))
        cnt_negative = num_data - cnt_positive
        self.need_train = not (cnt_positive == 0 or cnt_negative == 0)
        if not self.need_train:
            Log.warning("Contains only one class")
        Log.info("Number of positive: %d, number of negative: %d"
                 % (cnt_positive, cnt_negative))
        label_weights = [1.0, 1.0]   # [negative, positive]
        if self.is_unbalance and cnt_positive > 0 and cnt_negative > 0:
            if cnt_positive > cnt_negative:
                label_weights[0] = cnt_positive / cnt_negative
            else:
                label_weights[1] = cnt_negative / cnt_positive
        label_weights[1] *= self.scale_pos_weight
        self.label_weights = label_weights
        self._pos_mask = pos_mask
        self._dev = {}

    def _device_inputs(self, device):
        """(pos_mask, weight) on `device`, uploaded once."""
        key = str(device)
        if key not in self._dev:
            w = (torch.as_tensor(self.weight, device=device)
                 if self.weight is not None else None)
            self._dev[key] = (torch.as_tensor(self._pos_mask, device=device),
                              w)
        return self._dev[key]

    def get_gradients(self, score):
        """grad/hess in the score's dtype (f64 scores: f64 math, as the
        JAX package computes them before the grower's f32 cast)."""
        if not self.need_train:
            z = torch.zeros_like(score)
            return z, z
        pos, weight = self._device_inputs(score.device)
        w_neg, w_pos = self.label_weights
        g, h = self._logloss_grad(score, pos, self.sigmoid, w_neg, w_pos)
        if weight is None:
            return g, h
        return g * weight, h * weight

    def payload_grad_fn(self):
        """The persistent grower's gradient (lightgbm_tpu/objectives/
        binary.py:63-98): fn(score, label) -> f32 (grad, hess) from the
        payload's f32 score and label rows, positive where ``is_pos(label)``.
        Sample weights ride the payload and multiply after it (the grower
        applies them). None when there is nothing to train, so the learner
        keeps the v1 grower.

        The JAX package does this math in f32. torch's f32 ``exp`` is not
        the same function on the card and on the CPU (they differ in the
        last bit), and the card must grow the CPU's trees, so the port does
        it in f64 and rounds once to f32, as its v1 path does; the two
        differ from the JAX package's f32 gradients by about an f32 ulp."""
        if not self.need_train:
            return None
        sig = self.sigmoid
        w_neg, w_pos = self.label_weights
        is_pos = self.is_pos

        def fn(score, label):
            pos = is_pos(label)
            g, h = self._logloss_grad(score.double(), pos, sig, w_neg, w_pos)
            return g.float(), h.float()
        return fn

    @staticmethod
    def _logloss_grad(score, pos, sig, w_neg, w_pos):
        y = torch.where(pos, 1.0, -1.0).to(score.dtype)
        lw = torch.where(pos, w_pos, w_neg).to(score.dtype)
        response = -y * sig / (1.0 + torch.exp(y * sig * score))
        abs_resp = torch.abs(response)
        return response * lw, abs_resp * (sig - abs_resp) * lw

    def boost_from_score(self, class_id):
        pos = self._pos_mask.astype(np.float64)
        if self.weight is not None:
            pavg = float(np.sum(pos * self.weight) / np.sum(self.weight))
        else:
            pavg = float(np.mean(pos))
        pavg = min(pavg, 1.0 - K_EPSILON)
        pavg = max(pavg, K_EPSILON)
        initscore = float(np.log(pavg / (1.0 - pavg)) / self.sigmoid)
        Log.info("[%s:BoostFromScore]: pavg=%f -> initscore=%f"
                 % (self.name, pavg, initscore))
        return initscore

    def class_need_train(self, class_id):
        return self.need_train

    def convert_output(self, raw):
        return 1.0 / (1.0 + exp(-self.sigmoid * raw))

    def to_string(self):
        return "%s sigmoid:%g" % (self.name, self.sigmoid)
