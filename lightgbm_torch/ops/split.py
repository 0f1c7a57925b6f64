"""Split records and the leaf math of the split scan.

The port's subset of lightgbm_tpu/ops/split.py that the growers need: the
feature layout, the split parameters, the per-leaf best-split record, the
leaf output and gain with their numerical knobs (feature_histogram.hpp:
656-768: L1 thresholding, the max_delta_step clamp, the monotone clamp and
the "bad split" rule; lightgbm_tpu/ops/split.py:145-208, in the same
operations in the same order, so that float32 inputs give the JAX f32
functions' bits), and ``fix_histogram`` (Dataset::FixHistogram,
src/io/dataset.cpp:1410) — a no-op on unbundled data, kept so the grower
calls it where the JAX grower does.

The helpers take numpy float32 scalars or arrays (the host assembly) or
torch tensors (the scan's plain version) alike. ``use_l1``/``use_mds``/
``use_mc`` are the JAX package's static switches (its USE_L1/
USE_MAX_OUTPUT/USE_MC template arms): off, a knob's operations are left
out, which is how the fast path keeps its bits.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple, Optional

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
    """Per-config split scalars."""
    lambda_l2: float
    min_gain_to_split: float
    min_data_in_leaf: int
    min_sum_hessian_in_leaf: float
    lambda_l1: float = 0.0
    max_delta_step: float = 0.0

    @classmethod
    def from_config(cls, cfg) -> "SplitParams":
        return cls(lambda_l2=float(cfg.lambda_l2),
                   min_gain_to_split=float(cfg.min_gain_to_split),
                   min_data_in_leaf=int(cfg.min_data_in_leaf),
                   min_sum_hessian_in_leaf=float(cfg.min_sum_hessian_in_leaf),
                   lambda_l1=float(cfg.lambda_l1),
                   max_delta_step=float(cfg.max_delta_step))

    @property
    def use_l1(self) -> bool:
        return self.lambda_l1 > 0.0

    @property
    def use_mds(self) -> bool:
        return self.max_delta_step > 0.0


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
    is_cat: bool = False        # a categorical split: cat_words go left
    cat_words: Optional[np.ndarray] = None    # [8] uint32 left-bin mask

    @classmethod
    def none(cls) -> "SplitCandidate":
        z = np.float32(0.0)
        return cls(np.float32(K_MIN_SCORE), -1, 0, True, z, z, z, z, z, z,
                   0, 0)


def _torch(x) -> bool:
    return isinstance(x, torch.Tensor)


def _ns(x):
    """The array namespace of x: torch for tensors, numpy otherwise (both
    have sign, abs and where)."""
    return torch if _torch(x) else np


def _maximum(a, b):
    """jnp.maximum (NaN propagates) of an array and an array or scalar."""
    if _torch(a):
        return torch.maximum(a, torch.as_tensor(b, dtype=a.dtype,
                                                device=a.device))
    return np.maximum(a, b)


def _minimum(a, b):
    if _torch(a):
        return torch.minimum(a, torch.as_tensor(b, dtype=a.dtype,
                                                device=a.device))
    return np.minimum(a, b)


def threshold_l1(s, l1, use_l1: bool = True):
    """ThresholdL1 (feature_histogram.hpp:659): sign(s) * max(0, |s| - l1);
    the identity without L1."""
    if not use_l1:
        return s
    ns = _ns(s)
    return ns.sign(s) * _maximum(ns.abs(s) - l1, 0.0)


def leaf_output_unconstrained(g, h, lambda_l2, lambda_l1=0.0,
                              max_delta_step=0.0, use_l1: bool = False,
                              use_mds: bool = False):
    """CalculateSplittedLeafOutput (feature_histogram.hpp:664-685):
    -ThresholdL1(g) / (h + l2), clamped to +-max_delta_step when it is
    positive. With both switches off: -g / (h + l2)."""
    ret = -threshold_l1(g, lambda_l1, use_l1) / (h + lambda_l2)
    if not use_mds:
        return ret
    ns = _ns(ret)
    clipped = ns.sign(ret) * _minimum(ns.abs(ret), max_delta_step)
    return ns.where(max_delta_step > 0, clipped, ret)


def leaf_output(g, h, lambda_l2, lambda_l1, max_delta_step, cmin, cmax,
                use_l1: bool, use_mds: bool, use_mc: bool):
    """The leaf output clipped into the leaf's monotone bounds [cmin, cmax]
    (jnp.clip: max with cmin, then min with cmax) when use_mc."""
    ret = leaf_output_unconstrained(g, h, lambda_l2, lambda_l1,
                                    max_delta_step, use_l1, use_mds)
    if use_mc:
        ret = _minimum(_maximum(ret, cmin), cmax)
    return ret


def leaf_gain_given_output(g, h, lambda_l2, lambda_l1, out,
                           use_l1: bool = True):
    """GetLeafGainGivenOutput (feature_histogram.hpp:757-768):
    -(2 * ThresholdL1(g) * out + (h + l2) * out * out)."""
    sg = threshold_l1(g, lambda_l1, use_l1)
    return -(2.0 * sg * out + (h + lambda_l2) * out * out)


def leaf_gain(g, h, lambda_l2, lambda_l1=0.0, max_delta_step=0.0,
              use_l1: bool = False, use_mds: bool = False):
    """GetLeafGain (feature_histogram.hpp:739-755): ThresholdL1(g)^2 /
    (h + l2), or, with a positive max_delta_step, the gain of the clamped
    output. With both switches off: g * g / (h + l2)."""
    sg = threshold_l1(g, lambda_l1, use_l1)
    plain = sg * sg / (h + lambda_l2)
    if not use_mds:
        return plain
    out = leaf_output_unconstrained(g, h, lambda_l2, lambda_l1,
                                    max_delta_step, use_l1, True)
    with_mds = leaf_gain_given_output(g, h, lambda_l2, lambda_l1, out,
                                      use_l1)
    return _ns(with_mds).where(max_delta_step > 0, with_mds, plain)


def split_gains(gl, hl, gr, hr, lambda_l2, lambda_l1, max_delta_step, cmin,
                cmax, mono, use_l1: bool, use_mds: bool, use_mc: bool):
    """GetSplitGains (feature_histogram.hpp:704-737): the two leaf gains;
    under monotone constraints the gains of the clamped outputs, and 0 for
    a split whose outputs go against the feature's constraint."""
    if not use_mc:
        return (leaf_gain(gl, hl, lambda_l2, lambda_l1, max_delta_step,
                          use_l1, use_mds)
                + leaf_gain(gr, hr, lambda_l2, lambda_l1, max_delta_step,
                            use_l1, use_mds))
    lo = leaf_output(gl, hl, lambda_l2, lambda_l1, max_delta_step, cmin,
                     cmax, use_l1, use_mds, True)
    ro = leaf_output(gr, hr, lambda_l2, lambda_l1, max_delta_step, cmin,
                     cmax, use_l1, use_mds, True)
    bad = ((mono > 0) & (lo > ro)) | ((mono < 0) & (lo < ro))
    gain = (leaf_gain_given_output(gl, hl, lambda_l2, lambda_l1, lo, use_l1)
            + leaf_gain_given_output(gr, hr, lambda_l2, lambda_l1, ro,
                                     use_l1))
    return _ns(gain).where(bad, 0.0, gain)


def mono_bounds(cmin, cmax, mono: int, left_out, right_out):
    """Monotone bound propagation (monotone_constraints.hpp:15-64; the JAX
    package's _mono_bounds, ops/grow.py:856-863) in float32: the children
    of a split on a feature constrained +1 (-1) meet at the midpoint of
    their outputs, the left child's upper (lower) bound and the right
    child's lower (upper) bound. Returns (l_cmin, l_cmax, r_cmin, r_cmax)."""
    f32 = np.float32
    mid = f32((f32(left_out) + f32(right_out)) / f32(2.0))
    cmin, cmax = f32(cmin), f32(cmax)
    l_cmax = min(cmax, mid) if mono > 0 else cmax
    r_cmin = max(cmin, mid) if mono > 0 else cmin
    l_cmin = max(cmin, mid) if mono < 0 else cmin
    r_cmax = min(cmax, mid) if mono < 0 else cmax
    return f32(l_cmin), f32(l_cmax), f32(r_cmin), f32(r_cmax)


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
