"""DCG / NDCG calculation utilities.

The port's own copy of lightgbm_tpu/metrics/dcg.py (reference
src/metric/dcg_calculator.cpp, include/LightGBM/metric.h:90-150), which the
lambdarank objective and the ndcg metric share: the position discounts
1/log2(2+i), the label gains 2^l - 1 (DefaultLabelGain), the label check
and max-DCG at k over the descending labels, all numpy f64 on the host.

The discount table is built here in numpy exactly as the JAX package builds
it, and the device code uploads it (``discounts``): recomputing it with
``torch.log2`` on the card could round its last bit otherwise.
"""
from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..utils.log import Log

# reference dcg_calculator.cpp: kMaxPosition = 10000 precomputed discounts;
# the JAX package keeps 65536
_DISCOUNT_CACHE = 1.0 / np.log2(2.0 + np.arange(65536, dtype=np.float64))


def discounts(n: int, device) -> torch.Tensor:
    """The first `n` discounts as an f64 tensor on `device`."""
    return torch.as_tensor(_DISCOUNT_CACHE[:n], device=device)


def default_label_gain(max_label: int = 31) -> np.ndarray:
    """2^i - 1 (DCGCalculator::DefaultLabelGain)."""
    return (np.power(2.0, np.arange(max_label + 1, dtype=np.float64)) - 1.0)


def check_label(label: np.ndarray, num_label_gain: int) -> None:
    """DCGCalculator::CheckLabel: integer labels within label_gain range."""
    li = label.astype(np.int64)
    if np.any(np.abs(label - li) > 1e-6):
        Log.fatal("label should be int type (met %f) for ranking task"
                  % float(label[np.argmax(np.abs(label - li) > 1e-6)]))
    if li.min() < 0:
        Log.fatal("Label should be non-negative (met %d) for ranking task"
                  % int(li.min()))
    if li.max() >= num_label_gain:
        Log.fatal("Label %d is not less than the number of label mappings (%d)"
                  % (int(li.max()), num_label_gain))


def cal_max_dcg_at_k(k: int, label: np.ndarray, label_gain: np.ndarray) -> float:
    """Max DCG@k: labels sorted descending (DCGCalculator::CalMaxDCGAtK)."""
    n = len(label)
    k = min(k, n)
    if k <= 0:
        return 0.0
    s = np.sort(label.astype(np.int64))[::-1][:k]
    return float(np.sum(label_gain[s] * _DISCOUNT_CACHE[:k]))


def cal_dcg_at_ks(ks: Sequence[int], label: np.ndarray, score: np.ndarray,
                  label_gain: np.ndarray) -> List[float]:
    """DCG@k of the score-induced ranking for each k
    (DCGCalculator::CalDCG); ties broken by a stable sort on descending
    score (the reference's std::stable_sort with operator>)."""
    order = np.argsort(-score, kind="stable")
    lab = label.astype(np.int64)[order]
    gains = label_gain[lab] * _DISCOUNT_CACHE[:len(lab)]
    csum = np.cumsum(gains)
    out = []
    for k in ks:
        kk = min(k, len(lab))
        out.append(float(csum[kk - 1]) if kk > 0 else 0.0)
    return out


def cal_max_dcg_at_ks(ks: Sequence[int], label: np.ndarray,
                      label_gain: np.ndarray) -> List[float]:
    s = np.sort(label.astype(np.int64))[::-1]
    gains = label_gain[s] * _DISCOUNT_CACHE[:len(s)]
    csum = np.cumsum(gains)
    out = []
    for k in ks:
        kk = min(k, len(s))
        out.append(float(csum[kk - 1]) if kk > 0 else 0.0)
    return out
