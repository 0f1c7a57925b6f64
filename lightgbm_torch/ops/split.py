"""Split records and the fast-path leaf math.

The port's subset of lightgbm_tpu/ops/split.py that the partitioned grower
needs on the fast path: the feature layout, the split parameters, the
per-leaf best-split record, the unconstrained leaf output and leaf gain
(feature_histogram.hpp:664-755 without L1 and max_delta_step, which the
tree learner refuses), and ``fix_histogram`` (Dataset::FixHistogram,
src/io/dataset.cpp:1410) — a no-op on unbundled data, kept so the grower
calls it where the JAX grower does.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

# reference include/LightGBM/meta.h:51-55
K_EPSILON = 1e-15
K_MIN_SCORE = float("-inf")

MISSING_ZERO = 1
MISSING_NAN = 2


class FeatureMeta(NamedTuple):
    """Host copy of the per-feature layout (FeatureMetainfo,
    feature_histogram.hpp:25-42, plus the group layout), numpy arrays."""
    group_of: np.ndarray
    group_offset: np.ndarray
    bin_start: np.ndarray
    bin_end: np.ndarray
    missing_type: np.ndarray
    default_bin: np.ndarray
    most_freq_bin: np.ndarray
    penalty: np.ndarray
    fix: tuple          # (mf_global, start, end) of bundled features


@dataclass(frozen=True)
class SplitParams:
    """Per-config split scalars of the fast path."""
    lambda_l2: float
    min_gain_to_split: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float

    @classmethod
    def from_config(cls, cfg) -> "SplitParams":
        return cls(lambda_l2=float(cfg.lambda_l2),
                   min_gain_to_split=float(cfg.min_gain_to_split),
                   min_data_in_leaf=int(cfg.min_data_in_leaf),
                   min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf))


@dataclass
class SplitCandidate:
    """Best split of one leaf (analog of SplitInfo, split_info.hpp); the
    float fields hold numpy float32 scalars, as in the JAX fast path."""
    gain: np.float32
    feature: int                # inner feature id; -1 when none
    threshold: int              # local bin threshold
    default_left: bool
    left_output: np.float32
    right_output: np.float32
    left_sum_grad: np.float32
    left_sum_hess: np.float32
    right_sum_grad: np.float32
    right_sum_hess: np.float32
    left_count: int             # hessian-recovered (reference semantics)
    right_count: int

    @classmethod
    def none(cls) -> "SplitCandidate":
        z = np.float32(0.0)
        return cls(np.float32(K_MIN_SCORE), -1, 0, True, z, z, z, z, z, z,
                   0, 0)


def leaf_output_unconstrained(g, h, lambda_l2):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:664-685) with
    lambda_l1 = 0 and max_delta_step = 0."""
    return -g / (h + lambda_l2)


def leaf_gain(g, h, lambda_l2):
    """GetLeafGain (feature_histogram.hpp:739-755) with lambda_l1 = 0 and
    max_delta_step = 0."""
    return g * g / (h + lambda_l2)


def fix_histogram(hist: torch.Tensor, sum_grad, sum_hess, fix_mf_global,
                  fix_start, fix_end) -> torch.Tensor:
    """Reconstruct bundled features' most_freq bins from leaf totals:
    hist[most_freq] = leaf_total - sum(feature's other bins). fix_* index
    only the features in multi-feature bundles; with none (every dataset
    the tree learner accepts today) the histogram is returned as is."""
    if len(fix_mf_global) == 0:
        return hist
    out = hist.clone()
    leaf_tot = torch.tensor([float(sum_grad), float(sum_hess)],
                            dtype=hist.dtype, device=hist.device)
    for mf, s, e in zip(fix_mf_global, fix_start, fix_end):
        tot = hist[int(s):int(e)].sum(dim=0)
        out[int(mf)] = leaf_tot - (tot - hist[int(mf)])
    return out
