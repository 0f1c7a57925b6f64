"""Leaf renewal: each leaf's output re-fit to a percentile of its rows'
residuals, on the device.

No Pallas counterpart: the JAX package renews on the host, in numpy, one
leaf at a time (lightgbm_tpu/boosting/gbdt.py:747-766 ``_renew_tree_output``
-> objectives/regression.py ``renew_tree_output`` -> the percentile helpers
of objectives/base.py:214-256; reference serial_tree_learner.cpp:628-666
and regression_objective.hpp:18-90). L1, Quantile and MAPE take it.

Two steps, neither with a host synchronization, so the persistent grower's
iteration stays one CUDA graph:

  * :func:`segment_order` orders the rows: grouped by segment (the order of
    a per-row key), ascending residual within a segment, ties in row order.
    Two stable ``torch.sort`` calls: by residual, then by key. Ties must
    keep row order because the weighted percentile's cdf depends on it
    whenever residuals repeat (integer labels); the JAX package's leaf rows
    are in row order and its ``np.argsort(kind="stable")`` keeps it;
  * :func:`renew_leaf` computes each segment's percentile from the ordered
    rows: the ``renew_leaf`` CUDA kernel (``csrc/renew_leaf.cu``) for
    tensors on the card, :func:`renew_leaf_plain` for tensors on the CPU.

A residual is f64 ``label - score`` (the persistent grower's f32 scores
widened, the v1 grower's f64 scores) plus 0.0, which turns -0.0 into +0.0:
a radix sort orders -0.0 before +0.0 where numpy's stable sort keeps them
in row order, and the weighted cdf would see the two in another order.
The weighted percentile assumes weights >= 0 (the cdf is then monotone, so
the kernel's walk finds what numpy's binary search finds).
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError
from . import counters


def segment_order(residual: torch.Tensor, key: torch.Tensor) -> torch.Tensor:
    """[n] int64 row indices: the rows by ascending `key`, within a key by
    ascending `residual`, ties in row order (two stable sorts)."""
    _, by_res = torch.sort(residual, stable=True)
    _, by_key = torch.sort(key.index_select(0, by_res), stable=True)
    return by_res.index_select(0, by_key)


def _percentile(a, alpha: float) -> float:
    """PercentileFun of the ascending values `a` (a CPU f64 tensor, n >= 2):
    the descending order's s[i] is a[n - 1 - i]."""
    n = a.numel()
    float_pos = (1.0 - alpha) * n
    pos = int(float_pos)
    if pos < 1:
        return float(a[n - 1])
    if pos >= n:
        return float(a[0])
    bias = float_pos - pos
    v1 = float(a[n - pos])
    v2 = float(a[n - 1 - pos])
    return v1 - (v1 - v2) * bias


def _weighted_percentile(a, w, alpha: float) -> float:
    """WeightedPercentileFun of the ascending values `a` with weights `w`
    in that order (CPU f64 tensors, n >= 2): the cdf is torch's CPU
    cumsum, a sequential f64 sum as numpy's."""
    n = a.numel()
    cdf = torch.cumsum(w, 0)
    threshold = float(cdf[-1]) * alpha
    pos = int(torch.searchsorted(cdf, cdf.new_full((1,), threshold),
                                 right=True))
    pos = min(pos, n - 1)
    if pos == 0 or pos == n - 1:
        return float(a[pos])
    v1, v2 = float(a[pos - 1]), float(a[pos])
    c0, c1 = float(cdf[pos]), float(cdf[pos + 1])
    if c1 - c0 >= 1.0:
        return (threshold - c0) / (c1 - c0) * (v2 - v1) + v1
    return v2


def renew_leaf_plain(order, residual, weight, seg, out, alpha: float,
                     nseg=None) -> None:
    """The kernel's function in plain PyTorch (a loop over segments; its
    weighted cdf is sequential on the CPU only)."""
    S = seg.shape[0]
    if nseg is not None:
        S = min(S, int(nseg.reshape(-1)[0]))
        if S <= 1:
            return
    for i in range(S):
        start, n = int(seg[i, 0]), int(seg[i, 1])
        if n <= 0:
            continue
        rows = order[start:start + n]
        a = residual.index_select(0, rows)
        if n == 1:
            v = float(a[0])
        elif weight is None:
            v = _percentile(a, alpha)
        else:
            v = _weighted_percentile(a, weight.index_select(0, rows)
                                     .double(), alpha)
        out[i] = v
    counters.bump(residual.device, "renew_leaf")


def _launch(order, residual, weight, seg, out, alpha, nseg) -> None:
    from .build import load
    fn = load("renew_leaf").renew_leaf_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, P, ctypes.c_double, P, P, I, P, P]
    fn.restype = I

    def ptr(t):
        return P(None if t is None else t.data_ptr())
    f32 = out.dtype == torch.float32
    err = fn(ptr(order), ptr(residual), ptr(weight), ptr(seg),
             seg.stride(0), seg.shape[0], ptr(nseg), float(alpha),
             ptr(out if f32 else None), ptr(None if f32 else out),
             out.stride(0), counters.ptr(out.device, "renew_leaf"),
             P(torch.cuda.current_stream(out.device).cuda_stream))
    if err != 0:
        raise LightGBMError("renew_leaf launch failed: CUDA error %d" % err)


def renew_leaf(order, residual, weight, seg, out, alpha: float,
               nseg=None) -> None:
    """out[i] = the percentile at `alpha` of the residuals of segment i
    (unweighted: PercentileFun; with `weight`: WeightedPercentileFun), for
    every segment with rows; a segment without rows keeps out[i].

    order [n] int64: the rows grouped by segment, ascending residual within
    (:func:`segment_order`); residual [n] f64 and weight [n] f32 (or None)
    by row; seg [S, 2] int64 (a view with unit column stride): segment i
    is order[start:start + count]; out [S] f32 or f64 (any stride), in
    place; nseg: None, or a one-element int64 tensor on the device, the
    number of leading segments to renew (none when it is at most 1, a tree
    without a split). One launch for tensors on the card; the plain
    version for tensors on the CPU."""
    if order.dtype != torch.int64 or order.dim() != 1 \
            or not order.is_contiguous():
        raise LightGBMError("renew_leaf: order must be a contiguous [n] "
                            "int64 tensor")
    if residual.dtype != torch.float64 or not residual.is_contiguous() \
            or residual.shape != order.shape:
        raise LightGBMError("renew_leaf: residual must be a contiguous [n] "
                            "f64 tensor")
    if weight is not None and (weight.dtype != torch.float32 or
                               not weight.is_contiguous() or
                               weight.shape != order.shape):
        raise LightGBMError("renew_leaf: weight must be a contiguous [n] "
                            "f32 tensor")
    if seg.dtype != torch.int64 or seg.dim() != 2 or seg.shape[1] != 2 \
            or seg.stride(1) != 1:
        raise LightGBMError("renew_leaf: seg must be an [S, 2] int64 view "
                            "with unit column stride")
    if out.dim() != 1 or out.shape[0] != seg.shape[0] \
            or out.dtype not in (torch.float32, torch.float64):
        raise LightGBMError("renew_leaf: out must be an [S] f32 or f64 "
                            "tensor")
    if nseg is not None and (nseg.dtype != torch.int64 or nseg.numel() != 1):
        raise LightGBMError("renew_leaf: nseg must be a one-element int64 "
                            "tensor")
    dev = order.device
    if any(t is not None and t.device != dev
           for t in (residual, weight, seg, out, nseg)):
        raise LightGBMError("renew_leaf: operands on different devices")
    if dev.type == "cpu":
        return renew_leaf_plain(order, residual, weight, seg, out, alpha,
                                nseg)
    if dev.type != "cuda":
        raise LightGBMError("renew_leaf: no kernel for device %s" % dev)
    if seg.shape[0] == 0:
        return
    _launch(order, residual, weight, seg, out, alpha, nseg)
    renew_leaf.launches += 1


renew_leaf.launches = 0


def renew_segments(residual, key, weight, seg, out, alpha: float,
                   nseg=None) -> None:
    """Renew the segments' outputs from row-ordered inputs: residual [n]
    f64, key [n] (a row's segment: the segments in key order are ``seg``'s
    rows, each occupying [start, start + count) of that order), weight [n]
    f32 or None; the rest as :func:`renew_leaf`."""
    residual = residual + 0.0            # -0.0 -> +0.0 (module docstring)
    renew_leaf(segment_order(residual, key), residual, weight, seg, out,
               alpha, nseg)
