"""The tree walk of prediction on the device.

No Pallas counterpart: the JAX package walks its compiled ensemble in XLA
(lightgbm_tpu/predict/runtime.py:_traverse_bucket:85-129, then a
sequential ``lax.scan`` over iterations, :186-210). :func:`predict_walk`
walks every tree of a :class:`DeviceEnsemble` over raw feature rows: one
launch of the CUDA kernel (``csrc/predict.cu``) for tensors on the card,
:func:`predict_walk_plain` for tensors on the CPU. Nothing else: a tensor
elsewhere raises, and a failed build or launch raises.

Two modes. raw: ``[n, K]`` scores, class k the sum from +0.0 of the leaf
values of trees k, k + K, ... in model order (GBDT.predict_raw's order),
divided by the number of iterations for an averaged model (RF). leaf:
``[n, T]`` int32 leaf indices (``pred_leaf``).

:func:`upload` puts a :func:`predict.compile.flatten` result on a device
in the kernel's layout: one 32-byte int32 record per node slot with the
threshold's bits inside (f64, or rounded to f32 in the f32 mode).
"""
from __future__ import annotations

import ctypes
import threading
from typing import NamedTuple

import numpy as np
import torch

from ..models.tree import kZeroThreshold
from ..utils.log import LightGBMError

# columns of a node record (csrc/predict.cu): the threshold's bits sit in
# the last two (f64: low word, high word; f32: the float's bits in PW_THR,
# 0 in PW_THR + 1), so one record is 32 bytes
(PW_FEAT, PW_DT, PW_LEFT, PW_RIGHT, PW_COFF, PW_CNW, PW_THR) = range(7)
PW_COLS = 8

# a value at or past 2^34 goes right at a categorical node (csrc/predict.cu)
_CAT_LIMIT = 17179869184.0
# rows per step of the plain walk: [T, rows] temporaries of at most 2^25
_PLAIN_CELLS = 1 << 25


class DeviceEnsemble(NamedTuple):
    records: torch.Tensor     # [Nn, PW_COLS] int32, threshold bits inside
    tree_node: torch.Tensor   # [T] int32
    tree_leaf: torch.Tensor   # [T] int32
    leaves: torch.Tensor      # [Nl] f64 or f32
    words: torch.Tensor       # [W] int32 (the u32 bitset words' bits)
    depth: int                # steps of the plain walk

    @property
    def num_trees(self) -> int:
        return self.tree_node.shape[0]


def upload(flat, dtype: torch.dtype, device) -> DeviceEnsemble:
    """The walk operands of `flat` (a predict.compile.FlatEnsemble) on
    `device`, thresholds and leaf values in `dtype` (f64, or f32 rounded
    to nearest)."""
    if dtype not in (torch.float64, torch.float32):
        raise LightGBMError("predict_walk: dtype must be f64 or f32")
    rec = np.zeros((flat.nodes.shape[0], PW_COLS), np.int32)
    rec[:, :PW_THR] = flat.nodes
    if dtype == torch.float64:
        rec[:, PW_THR:].view(np.float64)[:, 0] = flat.threshold
    else:
        rec[:, PW_THR].view(np.float32)[:] = flat.threshold.astype(
            np.float32)
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    return DeviceEnsemble(
        records=torch.as_tensor(rec, device=device),
        tree_node=torch.as_tensor(flat.tree_node, device=device),
        tree_leaf=torch.as_tensor(flat.tree_leaf, device=device),
        leaves=torch.as_tensor(flat.leaf_value.astype(np_dt), device=device),
        words=torch.as_tensor(flat.cat_words.view(np.int32), device=device),
        depth=int(flat.depth))


def _thresholds(ens: DeviceEnsemble) -> torch.Tensor:
    rec = ens.records
    if ens.leaves.dtype == torch.float64:
        return rec[:, PW_THR:].contiguous().view(torch.float64).reshape(-1)
    return rec[:, PW_THR].contiguous().view(torch.float32)


def _leaves_plain(X: torch.Tensor, ens: DeviceEnsemble) -> torch.Tensor:
    """[T, n] int64 leaf indices by a per-level gather walk over all
    trees at once, `ens.depth` steps (frozen at a leaf), as the JAX
    package's _traverse_bucket."""
    rec = ens.records
    feat = rec[:, PW_FEAT].long()
    dt = rec[:, PW_DT]
    left, right = rec[:, PW_LEFT].long(), rec[:, PW_RIGHT].long()
    coff, cnw = rec[:, PW_COFF].long(), rec[:, PW_CNW].long()
    thr = _thresholds(ens)
    words = ens.words.long() & 0xFFFFFFFF
    zero = torch.tensor(kZeroThreshold, dtype=X.dtype, device=X.device)
    T, n = ens.num_trees, X.shape[0]
    base = ens.tree_node.long()[:, None]
    rows = torch.arange(n, device=X.device)[None, :]
    node = torch.zeros((T, n), dtype=torch.int64, device=X.device)
    for _ in range(ens.depth):
        g = base + node.clamp(min=0)
        v = X[rows, feat[g]]
        d = dt[g]
        mt = (d >> 2) & 3
        isnan = torch.isnan(v)
        fvn = torch.where(isnan & (mt != 2), torch.zeros_like(v), v)
        dflt = ((mt == 1) & (fvn.abs() <= zero)) | ((mt == 2) & isnan)
        num_left = torch.where(dflt, (d & 2) != 0, fvn <= thr[g])
        fv0 = torch.where(isnan, torch.zeros_like(v), v)
        catable = ~(isnan & (mt == 2)) & (fv0 >= 0) & (fv0 < _CAT_LIMIT)
        iv = torch.where(catable, fv0, torch.zeros_like(v)).long()
        w = iv >> 5
        at = coff[g] + w
        ok = catable & (w < cnw[g]) & (at < words.shape[0])
        bits = words[at.clamp(max=words.shape[0] - 1)]
        hit = ok & (((bits >> (iv & 31)) & 1) != 0)
        go_left = torch.where((d & 1) != 0, hit, num_left)
        nxt = torch.where(go_left, left[g], right[g])
        node = torch.where(node >= 0, nxt, node)
    return ~node


def predict_walk_plain(X: torch.Tensor, ens: DeviceEnsemble, K: int,
                       average: bool = False,
                       leaf: bool = False) -> torch.Tensor:
    """The walk in plain PyTorch, on the rows in steps of at most 2^25
    (tree, row) cells: the per-level gather walk, then (raw mode) the
    leaf values of each iteration's K trees added to the [n, K] sums from
    +0.0, one iteration after the other, and the division by the number
    of iterations for an averaged model."""
    T, n = ens.num_trees, X.shape[0]
    step = max(_PLAIN_CELLS // max(T, 1), 1)
    if leaf:
        out = torch.empty((n, T), dtype=torch.int32, device=X.device)
    else:
        out = torch.empty((n, K), dtype=ens.leaves.dtype, device=X.device)
    base = ens.tree_leaf.long()[:, None]
    for r0 in range(0, n, step):
        lf = _leaves_plain(X[r0:r0 + step], ens)
        if leaf:
            out[r0:r0 + step] = lf.T.to(torch.int32)
            continue
        contrib = ens.leaves[base + lf]                    # [T, rows]
        acc = torch.zeros((lf.shape[1], K), dtype=contrib.dtype,
                          device=X.device)
        for it in range(T // K):
            acc = acc + contrib[it * K:(it + 1) * K].T
        if average:
            # a device tensor divisor: torch on the card multiplies by the
            # reciprocal of a host scalar, which is not IEEE division
            acc = acc / torch.tensor(float(max(T // K, 1)), dtype=acc.dtype,
                                     device=acc.device)
        out[r0:r0 + step] = acc
    return out


_COUNT_LOCK = threading.Lock()


def _check(X: torch.Tensor, ens: DeviceEnsemble, K: int) -> bool:
    """True to launch (operands on the card), False for the plain version
    (on the CPU); raises for malformed operands or mixed devices."""
    if X.dim() != 2 or X.dtype != ens.leaves.dtype or not X.is_contiguous():
        raise LightGBMError("predict_walk: X must be a contiguous [n, F] "
                            "tensor of the ensemble's dtype (%s)"
                            % ens.leaves.dtype)
    T = ens.num_trees
    if T == 0 or K < 1 or T % K:
        raise LightGBMError("predict_walk: %d trees for %d classes" % (T, K))
    if ens.records.dtype != torch.int32 or ens.records.dim() != 2 \
            or ens.records.shape[1] != PW_COLS \
            or not ens.records.is_contiguous():
        raise LightGBMError("predict_walk: records must be a contiguous "
                            "[Nn, %d] int32 tensor" % PW_COLS)
    if any(t.dtype != torch.int32 or t.dim() != 1 or not t.is_contiguous()
           for t in (ens.tree_node, ens.tree_leaf, ens.words)) \
            or ens.tree_leaf.shape[0] != T:
        raise LightGBMError("predict_walk: tree_node, tree_leaf and words "
                            "must be contiguous 1-D int32 tensors, one "
                            "entry per tree in the first two")
    dev = X.device
    if any(t.device != dev for t in ens[:5]):
        raise LightGBMError("predict_walk: operands on different devices")
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("predict_walk: no kernel for device %s" % dev)
    return dev.type == "cuda"


def predict_walk(X: torch.Tensor, ens: DeviceEnsemble, K: int,
                 average: bool = False, leaf: bool = False) -> torch.Tensor:
    """Walk every tree of `ens` over the rows of `X` ([n, F], F past the
    largest split feature, in the ensemble's dtype): raw [n, K] scores, or
    with `leaf` [n, T] int32 leaf indices. The kernel is queued on the
    current stream; nothing waits."""
    if not _check(X, ens, K):
        return predict_walk_plain(X, ens, K, average, leaf)
    n = X.shape[0]
    out = torch.empty((n, ens.num_trees) if leaf else (n, K),
                      dtype=torch.int32 if leaf else ens.leaves.dtype,
                      device=X.device)
    if out.numel() == 0:
        return out
    if ens.records.data_ptr() % 16:
        raise LightGBMError("predict_walk: records must be 16-byte aligned")
    from .build import load
    fn = load("predict").predict_walk_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, ctypes.c_longlong, I, I, P, P, P, I, P, P, I, I, I, I,
                   P, P]
    fn.restype = I
    err = fn(P(X.data_ptr()), n, X.shape[1],
             int(X.dtype == torch.float32), P(ens.records.data_ptr()),
             P(ens.tree_node.data_ptr()), P(ens.tree_leaf.data_ptr()),
             ens.num_trees, P(ens.leaves.data_ptr()),
             P(ens.words.data_ptr()), ens.words.numel(), K, int(average),
             int(leaf), P(out.data_ptr()),
             P(torch.cuda.current_stream(X.device).cuda_stream))
    if err != 0:
        raise LightGBMError("predict_walk launch failed: CUDA error %d"
                            % err)
    with _COUNT_LOCK:
        predict_walk.launches += 1
    return out


predict_walk.launches = 0
