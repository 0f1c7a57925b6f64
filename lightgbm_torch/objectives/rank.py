"""Learning-to-rank objectives: LambdaRank-NDCG and XE-NDCG.

The port of lightgbm_tpu/objectives/rank.py (reference
src/objective/rank_objective.hpp). Queries are contiguous row ranges of the
dataset (its query boundaries); each objective's per-query pass is one CUDA
kernel over the row-ordered f64 scores (ops/rank.py, csrc/rank_grad.cu),
with the JAX package's semantics:

  * lambdarank: the pairwise lambdas of every pair of unequal labels in a
    query, with the JAX package's exact sigmoid (not the reference's 1M-
    entry table), the lambdarank_norm branch, and each query's inverse
    max DCG at ``lambdarank_truncation_level`` computed on the host in f64
    at ``init``. The persistent grower runs it in its "row" mode: the
    scores go to row order (one scatter), the kernel runs there, the
    gradients come back (one gather). The JAX package's "pos" mode
    (payload-order scores planted into a padded [Q, P] layout) exists to
    avoid [NP]-sized gathers, which serialize on a TPU; on the card the
    row mode's scatter and gather are cheap, queries are already the
    contiguous row ranges the kernel wants, and both modes compute the
    same function;
  * rank_xendcg: per-query softmax chains with one uniform draw per row
    from the reference's per-query LCG (``_next_floats``, bit-exact with
    the JAX package's), advanced once per ``get_gradients`` call. The draws
    change every iteration on the host, so it has no device gradient and
    trains on the v1 grower, as in the JAX package.

The host constants (labels as int32, per-row label gains, inverse max
DCGs, the discount table from numpy, the query plan) go to the device once
in :meth:`RankingObjective.upload`, before the persistent grower's first
iteration.
"""
from __future__ import annotations

import numpy as np
import torch

from ..metrics.dcg import (_DISCOUNT_CACHE, cal_max_dcg_at_k, check_label,
                           default_label_gain)
from ..ops.rank import QueryPlan, lambdarank_grad, xendcg_grad
from ..utils.log import Log
from .base import ObjectiveFunction, register


class RankingObjective(ObjectiveFunction):
    """Base: per-query gradient computation (rank_objective.hpp:25-94)."""

    def __init__(self, config):
        super().__init__(config)
        self.seed = int(config.objective_seed)
        self.query_boundaries = None
        self.num_queries = 0
        self._plans = {}

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        if metadata.query_boundaries is None:
            Log.fatal("Ranking tasks require query information")
        self.query_boundaries = metadata.query_boundaries
        self.num_queries = metadata.num_queries
        self._plans = {}

    def plan(self, device) -> QueryPlan:
        """The query boundaries on `device`, uploaded once."""
        key = str(device)
        if key not in self._plans:
            self._plans[key] = QueryPlan(self.query_boundaries, device)
        return self._plans[key]

    def upload(self, device) -> None:
        super().upload(device)
        self.plan(device)


@register
class LambdarankNDCG(RankingObjective):
    name = "lambdarank"
    _DEVICE = ("weight", "_lab", "_gain", "inverse_max_dcgs", "_disc")

    def __init__(self, config):
        super().__init__(config)
        self.sigmoid = float(config.sigmoid)
        self.norm = bool(config.lambdarank_norm)
        self.truncation_level = int(config.lambdarank_truncation_level)
        lg = list(config.label_gain)
        self.label_gain = (np.asarray(lg, dtype=np.float64) if lg
                           else default_label_gain())
        if self.sigmoid <= 0.0:
            Log.fatal("Sigmoid param %f should be greater than zero"
                      % self.sigmoid)

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        check_label(self.label, len(self.label_gain))
        inv = np.zeros(self.num_queries)
        qb = self.query_boundaries
        for q in range(self.num_queries):
            m = cal_max_dcg_at_k(self.truncation_level,
                                 self.label[qb[q]:qb[q + 1]], self.label_gain)
            inv[q] = 1.0 / m if m > 0.0 else 0.0
        self.inverse_max_dcgs = inv
        self._lab = self.label.astype(np.int32)
        self._gain = self.label_gain[self._lab.astype(np.int64)]
        longest = int(np.diff(qb).max()) if self.num_queries else 1
        self._disc = _DISCOUNT_CACHE[:max(longest, 1)]

    def get_gradients(self, score):
        dev = score.device
        return lambdarank_grad(
            score, self._on(dev, "_lab"), self._on(dev, "_gain"),
            self._on(dev, "inverse_max_dcgs"), self._on(dev, "_disc"),
            self._on(dev, "weight"), self.plan(dev), self.sigmoid, self.norm)

    def device_gradients(self):
        """("row", get_gradients): the persistent grower's row mode (the
        module docstring; the JAX package's "pos" mode computes the same
        function)."""
        return ("row", self.get_gradients)


@register
class RankXENDCG(RankingObjective):
    name = "rank_xendcg"
    _DEVICE = ("label", "weight")

    # the reference's LCG (include/LightGBM/utils/random.h:101-110):
    # x = 214013 x + 2531011 (mod 2^32); NextFloat = ((x>>16) & 0x7fff)/2^15
    _LCG_A = np.uint32(214013)
    _LCG_B = np.uint32(2531011)

    def device_gradients(self):
        # fresh host draws every iteration: the v1 grower only, as the
        # JAX package (rank.py:333-340)
        return None

    def init(self, metadata, num_data):
        super().init(metadata, num_data)
        qb = self.query_boundaries
        # flat row -> query id
        qid = np.zeros(self.num_data, dtype=np.int32)
        for q in range(self.num_queries):
            qid[qb[q]:qb[q + 1]] = q
        self._qid = qid
        self._counts = np.diff(qb).astype(np.int32)
        # reference-exact per-query Random streams (rands_[i] = Random(seed+i),
        # rank_objective.hpp:300): vectorized k-step LCG jump tables so draw
        # j of a query reads the state after j+1 advances
        self._lcg_x = (np.uint32(self.seed)
                       + np.arange(self.num_queries, dtype=np.uint32))
        kmax = int(self._counts.max()) if len(self._counts) else 1
        A = np.empty(kmax + 1, dtype=np.uint32)
        C = np.empty(kmax + 1, dtype=np.uint32)
        A[0], C[0] = np.uint32(1), np.uint32(0)
        with np.errstate(over="ignore"):
            for k in range(kmax):
                A[k + 1] = self._LCG_A * A[k]
                C[k + 1] = self._LCG_A * C[k] + self._LCG_B
        self._lcg_A, self._lcg_C = A, C
        self._pos_in_query = (np.arange(self.num_data, dtype=np.int64)
                              - qb[qid]).astype(np.int64)

    def _next_floats(self) -> np.ndarray:
        """One iteration's [num_data] NextFloat() draws, bit-identical to
        the reference's sequential per-query stream."""
        j1 = self._pos_in_query + 1
        with np.errstate(over="ignore"):
            v = (self._lcg_A[j1] * self._lcg_x[self._qid]
                 + self._lcg_C[j1])
            cnt = self._counts.astype(np.int64)
            self._lcg_x = (self._lcg_A[cnt] * self._lcg_x
                           + self._lcg_C[cnt])
        return (((v >> np.uint32(16)) & np.uint32(0x7FFF))
                .astype(np.float32) / np.float32(32768.0)).astype(np.float64)

    def get_gradients(self, score):
        """The gradients of one iteration: the streams advance once per
        call (the reference draws from its per-query Random streams each
        GetGradients call, rank_objective.hpp:305-312), and the draws go
        to the device with one upload."""
        dev = score.device
        label, weight = self._device_inputs(dev)
        rnd = torch.as_tensor(self._next_floats(), device=dev)
        return xendcg_grad(score, label, rnd, weight, self.plan(dev))
