"""Pointwise metrics: regression, binary and cross-entropy families.

The port of lightgbm_tpu/metrics/pointwise.py (reference
src/metric/regression_metric.hpp, binary_metric.hpp, xentropy_metric.hpp):
each LossOnPoint is an f64 torch expression over the whole score tensor on
its device, with the JAX package's formulas, weighted averages and
AverageLoss overrides (rmse's sqrt, gamma_deviance's x2). The regression
metrics take the scores through the objective's ConvertOutput
(regression_metric.hpp:74-92); the binary and cross-entropy metrics too,
as probabilities (binary_metric.hpp:57-76).

AUC follows the JAX package's tie rule exactly: a stable descending sort,
groups of equal scores, each group's negatives counted against the
positives above it plus half of its own, and 1.0 in the two degenerate
cases. The groups are runs of equal values of the sorted scores, so any
stable sort gives the same groups; with unit weights every sum is an
integer or a half-integer, exact in f64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import K_EPSILON, Metric, register


class _PointwiseMetric(Metric):
    """Common Eval loop (regression_metric.hpp:58-95)."""

    metric_name = ""
    check_label = None         # optional callable of the host labels
    convert_via_objective = True

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        if self.check_label is not None:
            if not bool(self.check_label(self.label)):
                Log.fatal("Metric %s with invalid label" % self.metric_name)

    @property
    def names(self):
        return [self.metric_name]

    def loss(self, label, score):
        raise NotImplementedError

    def average(self, sum_loss, sum_weights):
        return sum_loss / sum_weights

    def eval(self, score, objective):
        if objective is not None and self.convert_via_objective:
            score = objective.convert_output(score)
        pt = self.loss(self.label_t, score)
        return [self.average(self._weighted_sum(pt), self.sum_weights)]


@register
class L2Metric(_PointwiseMetric):
    metric_name = "l2"

    def loss(self, label, score):
        d = score - label
        return d * d


@register
class RMSEMetric(L2Metric):
    metric_name = "rmse"

    def average(self, sum_loss, sum_weights):
        return torch.sqrt(sum_loss / sum_weights)


@register
class L1Metric(_PointwiseMetric):
    metric_name = "l1"

    def loss(self, label, score):
        return torch.abs(score - label)


@register
class QuantileMetric(_PointwiseMetric):
    metric_name = "quantile"

    def loss(self, label, score):
        delta = label - score
        a = self.config.alpha
        return torch.where(delta < 0, (a - 1.0) * delta, a * delta)


@register
class HuberLossMetric(_PointwiseMetric):
    metric_name = "huber"

    def loss(self, label, score):
        diff = score - label
        a = self.config.alpha
        return torch.where(torch.abs(diff) <= a, 0.5 * diff * diff,
                           a * (torch.abs(diff) - 0.5 * a))


@register
class FairLossMetric(_PointwiseMetric):
    metric_name = "fair"

    def loss(self, label, score):
        x = torch.abs(score - label)
        c = self.config.fair_c
        return c * x - c * c * torch.log(1.0 + x / c)


@register
class PoissonMetric(_PointwiseMetric):
    metric_name = "poisson"

    def loss(self, label, score):
        score = torch.clamp_min(score, 1e-10)
        return score - label * torch.log(score)


@register
class MAPEMetric(_PointwiseMetric):
    metric_name = "mape"

    def loss(self, label, score):
        return torch.abs(label - score) / torch.clamp_min(torch.abs(label),
                                                          1.0)


@register
class GammaMetric(_PointwiseMetric):
    metric_name = "gamma"
    check_label = staticmethod(lambda y: np.all(y > 0))

    def loss(self, label, score):
        # regression_metric.hpp:261-272 (psi = 1)
        theta = -1.0 / score
        b = -torch.log(torch.clamp_min(-theta, 1e-300))
        lg = torch.log(torch.clamp_min(label, 1e-300))
        c = lg - lg
        return -((label * theta - b) + c)


@register
class GammaDevianceMetric(_PointwiseMetric):
    metric_name = "gamma_deviance"
    check_label = staticmethod(lambda y: np.all(y > 0))

    def loss(self, label, score):
        tmp = label / (score + 1e-9)
        return tmp - torch.log(torch.clamp_min(tmp, 1e-300)) - 1.0

    def average(self, sum_loss, sum_weights):
        return sum_loss * 2.0


@register
class TweedieMetric(_PointwiseMetric):
    metric_name = "tweedie"

    def loss(self, label, score):
        rho = self.config.tweedie_variance_power
        ls = torch.log(torch.clamp_min(score, 1e-10))
        a = label * torch.exp((1 - rho) * ls) / (1 - rho)
        b = torch.exp((2 - rho) * ls) / (2 - rho)
        return -a + b


# ---------------------------------------------------------------------------
# binary family (binary_metric.hpp): score -> prob via the objective
# ---------------------------------------------------------------------------

def _neg_log_clamped(p):
    """-log(p) where p > eps, else -log(eps) (binary_metric.hpp:117-130)."""
    return torch.where(p > K_EPSILON, -torch.log(torch.clamp_min(p, K_EPSILON)),
                       -np.log(K_EPSILON))


def _xent_loss(label, prob):
    """XentLoss (xentropy_metric.hpp:35-44): full CE for soft labels."""
    return (1.0 - label) * _neg_log_clamped(1.0 - prob) \
        + label * _neg_log_clamped(prob)


class _BinaryMetric(_PointwiseMetric):
    """binary_metric.hpp:24-98: prob = ConvertOutput(score) when an
    objective is given, else the score is already a probability."""

    def eval(self, score, objective):
        prob = objective.convert_output(score) if objective is not None \
            else score
        pt = self.loss(self.label_t, prob)
        return [self.average(self._weighted_sum(pt), self.sum_weights)]


@register
class BinaryLoglossMetric(_BinaryMetric):
    metric_name = "binary_logloss"

    def loss(self, label, prob):
        # hard 0/1 by label sign
        return torch.where(label > 0, _neg_log_clamped(prob),
                           _neg_log_clamped(1.0 - prob))


@register
class BinaryErrorMetric(_BinaryMetric):
    metric_name = "binary_error"

    def loss(self, label, prob):
        return torch.where(prob <= 0.5, (label > 0).double(),
                           (label <= 0).double())


_PW_PLANS = {}
# numpy reduces a contiguous array in buffers of this many elements, each
# summed pairwise, the buffer sums added in order
_NP_BUFSIZE = 8192


def _pairwise_plan(m: int, device):
    """numpy's pairwise_sum of m <= 8192 elements (blocks of at most 128
    summed by 8 accumulators and then the rest in order; above 128, halves
    at a multiple of 8) as tensors: the leaf blocks' element indices
    [B, 16, 8] and remainders [B, 7] (index m: padding), and per level of
    the recursion, bottom-up, the (left, right, out) node ids it adds.
    Leaves are nodes 0..B-1."""
    key = (m, str(device))
    if key in _PW_PLANS:
        return _PW_PLANS[key]
    leaves, inner = [], []          # inner: (left, right, height)

    def walk(a, b):
        if b - a <= 128:
            leaves.append((a, b))
            return ("leaf", len(leaves) - 1), 0
        h = (b - a) // 2
        h -= h % 8
        left, hl = walk(a, a + h)
        right, hr = walk(a + h, b)
        inner.append((left, right, 1 + max(hl, hr)))
        return ("inner", len(inner) - 1), 1 + max(hl, hr)

    root, _ = walk(0, m)
    B = len(leaves)

    def nid(node):
        return node[1] if node[0] == "leaf" else B + node[1]

    main = np.full((B, 128), m, np.int64)
    rem = np.full((B, 7), m, np.int64)
    for i, (a, b) in enumerate(leaves):
        k = (b - a) - (b - a) % 8
        main[i, :k] = np.arange(a, a + k)
        rem[i, :(b - a) % 8] = np.arange(a + k, b)
    levels = []
    for height in range(1, max((h for _, _, h in inner), default=0) + 1):
        sel = [(nid(l_), nid(r_), B + i)
               for i, (l_, r_, h) in enumerate(inner) if h == height]
        levels.append(tuple(torch.as_tensor([x[c] for x in sel],
                                            device=device)
                            for c in range(3)))
    plan = (torch.as_tensor(main.reshape(B, 16, 8), device=device),
            torch.as_tensor(rem, device=device), levels, nid(root),
            B + len(inner))
    _PW_PLANS[key] = plan
    return plan


def _pairwise_rows(X: torch.Tensor) -> torch.Tensor:
    """numpy's pairwise_sum of each row of an f32 [C, m] tensor, [C]."""
    C, m = X.shape
    main, rem, levels, root, total = _pairwise_plan(m, X.device)
    xp = torch.cat([X, X.new_zeros(C, 1)], 1)
    blocks = xp[:, main]                                # [C, B, 16, 8]
    r = blocks[:, :, 0]
    for c in range(1, 16):
        r = r + blocks[:, :, c]
    res = ((r[..., 0] + r[..., 1]) + (r[..., 2] + r[..., 3])) \
        + ((r[..., 4] + r[..., 5]) + (r[..., 6] + r[..., 7]))
    tail = xp[:, rem]
    for c in range(7):
        res = res + tail[..., c]
    vals = X.new_zeros(C, total)
    vals[:, :res.shape[1]] = res
    for left, right, out in levels:
        vals[:, out] = vals[:, left] + vals[:, right]
    return vals[:, root]


def pairwise_sum_f32(x: torch.Tensor) -> torch.Tensor:
    """The f32 sum of a 1-D f32 tensor in numpy's order (np.sum of an f32
    array: buffers of 8192 summed pairwise, then added in order), as a 0-d
    f64 tensor. Padding adds 0.0f, which changes no sum."""
    n = x.numel()
    if n == 0:
        return torch.zeros((), dtype=torch.float64, device=x.device)
    full = n - n % _NP_BUFSIZE
    parts = []
    if full:
        parts.append(_pairwise_rows(x[:full].reshape(-1, _NP_BUFSIZE)))
    if n > full:
        parts.append(_pairwise_rows(x[full:].reshape(1, -1)))
    sums = torch.cat(parts)
    total = sums[0]
    for i in range(1, sums.numel()):
        total = total + sums[i]
    return total.double()


def auc(score, label, weight=None, sum_ones=None):
    """AUC with the JAX package's tie rule (binary_metric.hpp:159-253), a
    0-d f64 tensor: rows sorted by descending score (stable), each run of
    equal scores contributing its negatives x (half its positives + the
    positives above it). The weights are f32 (1.0 without weights); their
    total is summed in f32 in numpy's order over the sorted rows, as the
    JAX package's np.sum does (without weights: `sum_ones`, that sum of n
    ones, which no order changes)."""
    n = score.numel()
    if n == 0:
        return torch.ones((), dtype=torch.float64, device=score.device)
    keys, order = torch.sort(-score, stable=True)
    lab = label[order]
    w32 = (weight[order].float() if weight is not None
           else torch.ones(n, dtype=torch.float32, device=score.device))
    w = w32.double()
    pos = torch.where(lab > 0, w, 0.0)
    neg = torch.where(lab <= 0, w, 0.0)
    # each row's run of equal scores: [start, end) in the sorted order (a
    # binary search of the sorted keys; torch's cummax over the rows is
    # ~20x slower on the card)
    start = torch.searchsorted(keys, keys)
    end = torch.searchsorted(keys, keys, right=True)
    cpos = torch.zeros(n + 1, dtype=torch.float64, device=score.device)
    cpos[1:] = torch.cumsum(pos, 0)
    before = cpos[start]
    in_run = cpos[end] - before
    accum = (neg * (in_run * 0.5 + before)).sum()
    sum_pos = pos.sum()
    if weight is not None:
        sum_weights = pairwise_sum_f32(w32)
    else:
        if sum_ones is None:
            sum_ones = float(np.sum(np.ones(n, np.float32)))
        sum_weights = torch.full((), sum_ones, dtype=torch.float64,
                                 device=score.device)
    ok = (sum_pos > 0.0) & (sum_pos != sum_weights)
    denom = torch.where(ok, sum_pos * (sum_weights - sum_pos), 1.0)
    return torch.where(ok, accum / denom, 1.0)


@register
class AUCMetric(Metric):
    metric_name = "auc"

    @property
    def names(self):
        return ["auc"]

    @property
    def factor_to_bigger_better(self):
        return 1.0

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        self._sum_ones = float(np.sum(np.ones(num_data, np.float32)))

    def eval(self, score, objective):
        return [auc(score, self.label_t, self.weight_t, self._sum_ones)]


# ---------------------------------------------------------------------------
# xentropy family (xentropy_metric.hpp)
# ---------------------------------------------------------------------------

@register
class CrossEntropyMetric(_BinaryMetric):
    """xentropy_metric.hpp:71-160: soft-label CE on probabilities."""

    metric_name = "cross_entropy"

    def loss(self, label, prob):
        return _xent_loss(label, prob)


@register
class CrossEntropyLambdaMetric(Metric):
    """xentropy_metric.hpp:166-243: CE in the lambda parameterization;
    hhat = log1p(exp(score)) when an objective is given. The weights enter
    only through the link; the sum is unweighted over num_data."""

    metric_name = "cross_entropy_lambda"

    @property
    def names(self):
        return ["cross_entropy_lambda"]

    def eval(self, score, objective):
        hhat = torch.log1p(torch.exp(score)) if objective is not None \
            else score
        w = self.weight_t if self.weight_t is not None else 1.0
        prob = 1.0 - torch.exp(-w * hhat)
        return [_xent_loss(self.label_t, prob).sum() / self.num_data]


@register
class KLDivMetric(Metric):
    """xentropy_metric.hpp:249-330: KL divergence = CE - entropy(label)."""

    metric_name = "kldiv"

    @property
    def names(self):
        return ["kldiv"]

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        lab = self.label.astype(np.float64)
        # YentLoss: the label's own entropy (xentropy_metric.hpp:60-68),
        # a constant of the dataset, on the host as the JAX package has it
        ent = np.zeros_like(lab)
        m = (lab > 0) & (lab < 1)
        ent[m] = lab[m] * np.log(lab[m]) + (1 - lab[m]) * np.log(1 - lab[m])
        if self.weight is not None:
            self._sum_ent = float(np.sum(ent * self.weight))
        else:
            self._sum_ent = float(np.sum(ent))

    def eval(self, score, objective):
        prob = objective.convert_output(score) if objective is not None \
            else score
        pt = _xent_loss(self.label_t, prob)
        return [(self._weighted_sum(pt) + self._sum_ent) / self.sum_weights]
