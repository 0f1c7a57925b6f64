"""Multiclass metrics: multi_error, multi_logloss and auc_mu.

The port of lightgbm_tpu/metrics/multiclass.py (reference
src/metric/multiclass_metric.hpp). The scores are the [K, n] class-major
tensor; the per-row ConvertOutput is one [n, K] tensor operation.

auc_mu keeps the reference's pairwise-hyperplane algorithm
(multiclass_metric.hpp:183-294) with its exact tie rule. The JAX package
runs that rule as a Python loop over the sorted rows of each class pair;
here it is vectorized with the same result: a class-j row starts a new run
of near-equal distances (an "anchor") when its distance differs from the
current anchor's by K_EPSILON or more, which a binary search finds for
every j row and pointer doubling follows from the first anchor; every
class-i row then reads the count of j rows before it and the size of the
current run. The sums are of integers and half-integers, exact in f64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import K_EPSILON, Metric, register


class _MulticlassMetric(Metric):
    metric_name = ""

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)

    @property
    def names(self):
        return [self.metric_name]

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        li = self.label.astype(np.int64)
        if li.min() < 0 or li.max() >= self.num_class:
            Log.fatal("Label must be in [0, %d) for metric %s"
                      % (self.num_class, self.metric_name))
        self._label_int = torch.as_tensor(li, device=device)

    def _scores_nk(self, score, objective):
        """class-major [K, n] -> per-row [n, K], converted."""
        nk = score.reshape(self.num_class, self.num_data).T
        if objective is not None:
            nk = objective.convert_output(nk)
        return nk

    def loss(self, label_int, probs_nk):
        raise NotImplementedError

    def eval(self, score, objective):
        pt = self.loss(self._label_int, self._scores_nk(score, objective))
        return [self._weighted_sum(pt) / self.sum_weights]


def _true_class(label_int, probs_nk):
    return probs_nk.gather(1, label_int[:, None])[:, 0]


@register
class MultiErrorMetric(_MulticlassMetric):
    metric_name = "multi_error"

    @property
    def names(self):
        k = self.config.multi_error_top_k
        return ["multi_error" if k == 1 else "multi_error@%d" % k]

    def loss(self, label_int, probs_nk):
        # multiclass_metric.hpp:123-132: an error unless #(score >=
        # score[label]) stays within top_k
        true_score = _true_class(label_int, probs_nk)
        num_larger = (probs_nk >= true_score[:, None]).sum(1)
        return (num_larger > self.config.multi_error_top_k).double()


@register
class MultiSoftmaxLoglossMetric(_MulticlassMetric):
    metric_name = "multi_logloss"

    def loss(self, label_int, probs_nk):
        p = _true_class(label_int, probs_nk)
        return -torch.log(torch.clamp_min(p, K_EPSILON))


def _first_at_least(dj, base, lo):
    """For every r: the first index q in [lo[r], m) with |dj[q] - base[r]|
    >= K_EPSILON (m when none), by a vectorized binary search; the
    predicate is monotone in q because dj is sorted and dj[q] >= base[r] -
    K_EPSILON for every q >= lo[r]."""
    m = dj.numel()
    lo = lo.clone()
    hi = torch.full_like(lo, m)
    while True:
        active = lo < hi
        # bounded by log2(m) + 1 rounds; the loop test reads the card
        # once per round, which auc_mu (off every training path) can pay
        if not bool(active.any()):
            return lo
        mid = (lo + hi) // 2
        far = torch.abs(dj[mid.clamp(max=m - 1)] - base) >= K_EPSILON
        hi = torch.where(active & far, mid, hi)
        lo = torch.where(active & ~far, mid + 1, lo)


def _pair_sum(dist, is_i):
    """S_ij of one class pair (multiclass_metric.hpp:240-275): rows sorted
    by distance, class j first among equal distances."""
    dev = dist.device
    n = dist.numel()
    by_class = torch.sort((~is_i).to(torch.int8), descending=True,
                          stable=True).indices      # class j first
    order = by_class[torch.sort(dist[by_class], stable=True).indices]
    d = dist[order]
    row_i = is_i[order]
    jpos = torch.nonzero(~row_i)[:, 0]
    dj = d[jpos]
    m = dj.numel()
    if m == 0:
        return torch.zeros((), dtype=torch.float64, device=dev)
    # the first real anchor: j row 0, unless it lies within K_EPSILON of the
    # initial anchor 0.0 (then the first j row that does not)
    zero = torch.zeros(1, dtype=torch.float64, device=dev)
    first = torch.where(torch.abs(dj[:1]) < K_EPSILON,
                        _first_at_least(dj, zero,
                                        torch.zeros(1, dtype=torch.long,
                                                    device=dev)),
                        torch.zeros(1, dtype=torch.long, device=dev))
    nxt = _first_at_least(dj, dj, torch.arange(1, m + 1, device=dev))
    # the anchors: the orbit of `first` under nxt (m: none), by doubling
    anchor = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    anchor.scatter_(0, first, 1)
    jump = torch.cat([nxt, torch.full((1,), m, device=dev)])
    for _ in range(max(1, int(m).bit_length()) + 1):
        anchor = torch.maximum(anchor, torch.zeros_like(anchor).scatter_reduce(
            0, jump, anchor, "amax"))
        jump = jump[jump]
    is_anchor = anchor[:m].bool()
    # per sorted row: j rows before it, the latest anchor before it (its
    # j index and distance; 0.0 and -1 when none yet)
    nj_incl = torch.cumsum((~row_i).to(torch.float64), 0)
    nj_before = nj_incl - (~row_i).to(torch.float64)
    jidx = torch.arange(m, device=dev)
    anchor_j = torch.cummax(torch.where(is_anchor, jidx, -1), 0).values
    # map each sorted row to the latest anchor among the j rows before it
    jcount = nj_before.long()                     # j rows before the row
    latest = torch.where(jcount > 0,
                         anchor_j[(jcount - 1).clamp(min=0)],
                         torch.full_like(jcount, -1))
    last = torch.where(latest >= 0, dj[latest.clamp(min=0)], 0.0)
    cur = torch.where(latest >= 0, (jcount - latest).double(), nj_before)
    near = torch.abs(d - last) < K_EPSILON
    contrib = torch.where(near, nj_before - 0.5 * cur, nj_before)
    return torch.where(row_i, contrib, 0.0).sum()


@register
class AucMuMetric(Metric):
    """AUC-mu (multiclass_metric.hpp:183-294; Kleiman & Page, ICML'19)."""

    metric_name = "auc_mu"

    def __init__(self, config):
        super().__init__(config)
        self.num_class = int(config.num_class)
        w = list(config.auc_mu_weights)
        K = self.num_class
        if w:
            if len(w) != K * K:
                Log.fatal("auc_mu_weights must have %d elements" % (K * K))
            self.class_weights = np.asarray(w, dtype=np.float64).reshape(K, K)
        else:
            # default: 1 everywhere except a 0 diagonal (config.cpp:310-325)
            self.class_weights = 1.0 - np.eye(K)

    @property
    def names(self):
        return ["auc_mu"]

    @property
    def factor_to_bigger_better(self):
        return 1.0

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        self._lab = self.label.astype(np.int64)
        self._class_sizes = np.bincount(self._lab, minlength=self.num_class)
        self._sel = {}
        for i in range(self.num_class):
            for j in range(i + 1, self.num_class):
                idx = np.nonzero((self._lab == i) | (self._lab == j))[0]
                self._sel[i, j] = (
                    torch.as_tensor(idx, device=device),
                    torch.as_tensor(self._lab[idx] == i, device=device))

    def eval(self, score, objective):
        K = self.num_class
        scores_kn = score.reshape(K, self.num_data)
        ans = torch.zeros((), dtype=torch.float64, device=score.device)
        for i in range(K):
            for j in range(i + 1, K):
                curr_v = self.class_weights[i] - self.class_weights[j]
                t1 = curr_v[i] - curr_v[j]
                idx, is_i = self._sel[i, j]
                v_a = curr_v[0] * scores_kn[0, idx]
                for k in range(1, K):
                    v_a = v_a + curr_v[k] * scores_kn[k, idx]
                s_ij = _pair_sum(t1 * v_a, is_i)
                denom = int(self._class_sizes[i]) * int(self._class_sizes[j])
                if denom > 0:
                    ans = ans + s_ij / denom
        return [2.0 * ans / (K * (K - 1))]
