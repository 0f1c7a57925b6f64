"""Ranking metrics: NDCG@k and MAP@k.

The port of lightgbm_tpu/metrics/rank.py (reference
src/metric/rank_metric.hpp:19-150, map_metric.hpp:20-140) over the DCG
helpers of metrics/dcg.py. The JAX package evaluates query by query in
numpy; here one evaluation is a few f64 torch operations on the scores'
device, with no per-query host loop:

  * the rows in (query, descending score, row) order: two stable sorts,
    by descending score (-0.0 made +0.0 first: a radix sort on the card
    orders -0.0 before +0.0, numpy's stable sort keeps them in row order),
    then by query id. After them the row at position p holds rank
    p - start(query of p) in its query, a constant of the dataset;
  * the first W ranks of every query (W = min(max(eval_at), the longest
    query)) laid into a [Q, W] matrix, summed along the ranks (cumsum), and
    read at min(k, query length) - 1 for each k.

Per-query constants (inverse max DCGs, positives per query, the sum of the
query weights) are computed once on the host in numpy as the JAX package
computes them. Results are 0-d f64 tensors on the scores' device.
"""
from __future__ import annotations

import numpy as np
import torch

from ..utils.log import Log
from .base import Metric, register
from .dcg import (cal_max_dcg_at_ks, check_label, default_label_gain,
                  discounts)


def _default_eval_at(eval_at):
    # DCGCalculator::DefaultEvalAt
    return list(eval_at) if eval_at else [1, 2, 3, 4, 5]


class _RankMetric(Metric):
    """Query layout and the ranked [Q, W] view shared by NDCG and MAP."""

    missing_query_message = ""

    def __init__(self, config):
        super().__init__(config)
        self.eval_at = _default_eval_at(config.eval_at)

    @property
    def factor_to_bigger_better(self):
        return 1.0

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        if metadata.query_boundaries is None:
            Log.fatal(self.missing_query_message)
        qb = self.query_boundaries = metadata.query_boundaries
        self.num_queries = Q = metadata.num_queries
        self.query_weights = metadata.query_weights
        if self.query_weights is None:
            self.sum_query_weights = float(self.num_queries)
        else:
            self.sum_query_weights = float(np.sum(self.query_weights))
        counts = np.diff(qb).astype(np.int64)
        qid = np.repeat(np.arange(Q, dtype=np.int64), counts)
        rank = np.arange(num_data, dtype=np.int64) - qb[qid]
        W = max(1, min(max(self.eval_at), int(counts.max()) if Q else 1))
        sel = np.nonzero(rank < W)[0]
        dev = torch.device(device)
        self.W = W
        self.qid_t = torch.as_tensor(qid, device=dev)
        self.sel_t = torch.as_tensor(sel, device=dev)
        self.cell_t = torch.as_tensor(qid[sel] * W + rank[sel], device=dev)
        self.rank_t = torch.as_tensor(rank[sel], device=dev)
        # the column of each (query, k) read: min(k, length) - 1 (-1: an
        # empty query, read as 0)
        kk = np.minimum(np.asarray(self.eval_at, np.int64)[None, :],
                        counts[:, None])
        self.kk = kk
        self.col_t = torch.as_tensor(np.maximum(kk - 1, 0), device=dev)
        self.has_k_t = torch.as_tensor(kk > 0, device=dev)
        self.qw_t = (None if self.query_weights is None else torch.as_tensor(
            self.query_weights.astype(np.float64), device=dev))

    def _ranked(self, score: torch.Tensor) -> torch.Tensor:
        """The rows at the positions of the first W ranks of each query
        (``sel_t``), from the (query, descending score, row) order."""
        key = -score + 0.0
        _, by_score = torch.sort(key, stable=True)
        _, by_q = torch.sort(self.qid_t.index_select(0, by_score),
                             stable=True)
        return by_score.index_select(0, by_q.index_select(0, self.sel_t))

    def _lay(self, values: torch.Tensor) -> torch.Tensor:
        """[Q, W] f64 with the selected positions' values at their (query,
        rank), 0 elsewhere."""
        out = torch.zeros(self.num_queries * self.W, dtype=values.dtype,
                          device=values.device)
        out[self.cell_t] = values
        return out.reshape(self.num_queries, self.W)

    def _average(self, per_query: torch.Tensor):
        """[Q, len(eval_at)] -> one 0-d tensor per k: the query-weighted
        mean."""
        if self.qw_t is not None:
            per_query = per_query * self.qw_t[:, None]
        tot = per_query.sum(0) / self.sum_query_weights
        return [tot[j] for j in range(len(self.eval_at))]


@register
class NDCGMetric(_RankMetric):
    metric_name = "ndcg"
    missing_query_message = "The NDCG metric requires query information"

    def __init__(self, config):
        super().__init__(config)
        lg = list(config.label_gain)
        self.label_gain = (np.asarray(lg, dtype=np.float64) if lg
                           else default_label_gain())

    @property
    def names(self):
        return ["ndcg@%d" % k for k in self.eval_at]

    def init(self, metadata, num_data, device="cpu"):
        check_label(metadata.label, len(self.label_gain))
        super().init(metadata, num_data, device)
        # cache inverse max DCG per query (rank_metric.hpp:57-75)
        qb = self.query_boundaries
        inv = np.zeros((self.num_queries, len(self.eval_at)))
        for q in range(self.num_queries):
            m = cal_max_dcg_at_ks(self.eval_at, self.label[qb[q]:qb[q + 1]],
                                  self.label_gain)
            for j, v in enumerate(m):
                inv[q, j] = 1.0 / v if v > 0.0 else -1.0
        self.inverse_max_dcgs = inv
        dev = self.label_t.device
        self.inv_t = torch.as_tensor(inv, device=dev)
        self.gain_t = torch.as_tensor(
            self.label_gain[self.label.astype(np.int64)], device=dev)
        self.disc_t = discounts(self.W, dev)

    def eval(self, score, objective):
        rows = self._ranked(score)
        dcg = torch.cumsum(self._lay(self.gain_t.index_select(0, rows)
                                     * self.disc_t[self.rank_t]), 1)
        dcg = torch.where(self.has_k_t, dcg.gather(1, self.col_t), 0.0)
        # an all-negative query counts as NDCG = 1 (rank_metric.hpp:98)
        per_query = torch.where(self.inv_t[:, :1] <= 0.0, 1.0,
                                dcg * self.inv_t)
        return self._average(per_query)


@register
class MapMetric(_RankMetric):
    metric_name = "map"
    missing_query_message = \
        "For MAP metric, there should be query information"

    @property
    def names(self):
        return ["map@%d" % k for k in self.eval_at]

    def init(self, metadata, num_data, device="cpu"):
        super().init(metadata, num_data, device)
        qb = self.query_boundaries
        npos = np.array([int(np.sum(self.label[qb[q]:qb[q + 1]] > 0.5))
                         for q in range(self.num_queries)], dtype=np.int64)
        self.npos_per_query = npos
        dev = self.label_t.device
        self.hit_t = torch.as_tensor(self.label > 0.5, device=dev)
        self.npos_t = torch.as_tensor(npos, device=dev)[:, None]
        self.div_t = torch.as_tensor(
            np.minimum(npos[:, None], self.kk).astype(np.float64),
            device=dev)

    def eval(self, score, objective):
        # map_metric.hpp:74-105
        hits = self._lay(self.hit_t.index_select(0, self._ranked(score))
                         .to(torch.int64))
        num_hit_cum = torch.cumsum(hits, 1)
        ranks = torch.arange(1, self.W + 1, dtype=torch.float64,
                             device=score.device)
        ap = torch.where(hits > 0, num_hit_cum / ranks, 0.0)
        sum_ap = torch.cumsum(ap, 1).gather(1, self.col_t)
        per_query = torch.where(self.npos_t > 0,
                                torch.where(self.has_k_t,
                                            sum_ap / self.div_t, 0.0), 1.0)
        return self._average(per_query)
