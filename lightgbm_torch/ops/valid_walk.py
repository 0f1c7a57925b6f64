"""The binned tree walk of the validation scores on the device.

No Pallas counterpart: the JAX package walks each new tree over the binned
validation rows on the host, in numpy
(lightgbm_tpu/boosting/score_updater.py:114-144 -> models/tree.py:420-481).
Here :func:`valid_walk` adds one tree's leaf values to a validation set's
f64 score row, ``score[r] += leaf_value[leaf(r)]``: one launch of the CUDA
kernel (``csrc/valid_walk.cu``) per tree and validation set for tensors on
the card, :func:`valid_walk_plain` (the vectorized per-level walk of
models/tree.py) for tensors on the CPU. Nothing else: a tensor elsewhere
raises, and a failed build or launch raises.

:func:`valid_walk_payload` is the same walk onto the persistent grower's
payload (DART's drop and normalize, the JAX package's add_score_delta,
lightgbm_tpu/ops/grow_persist.py:1816-1826): for each live lane l of the
payload, the row ``rid[l]`` of the training bins is walked and
``score[l] += f32(leaf_value)``, the f64 leaf value rounded to the
payload's f32 scores first (JAX: ``delta_row.astype(sc.dtype)``), one f32
add per lane.

:func:`pack` lays an iteration's trees out in one int32 host buffer (their
f64 leaf values first, then their node records, models/tree.py:
Tree.node_records, then one word array of all their categorical nodes'
inner bitsets, which the records index) and uploads it with one copy; each
tree's operands are views of it.
"""
from __future__ import annotations

import ctypes
from typing import List, NamedTuple, Sequence

import numpy as np
import torch

from ..models.tree import VW_COLS, walk_leaves_plain
from ..utils.log import LightGBMError


class PackedTree(NamedTuple):
    nodes: torch.Tensor     # [num_leaves - 1, VW_COLS] int32
    leaves: torch.Tensor    # [num_leaves] f64
    words: torch.Tensor     # int32: the pack's categorical bitset words


def pack(trees: Sequence, leaf_values: Sequence[np.ndarray], dataset,
         device) -> List[PackedTree]:
    """The walk operands of `trees` (models.tree.Tree) with the leaf values
    `leaf_values[i]` (f64, one per leaf of tree i), for rows binned like
    `dataset`, in one buffer on `device` (one host-to-device copy)."""
    wbase = np.cumsum([0] + [len(t.cat_threshold_inner) for t in trees])
    recs = [t.node_records(dataset, int(b)) for t, b in zip(trees, wbase)]
    words = (np.concatenate([t.cat_words_inner() for t in trees])
             if len(trees) else np.zeros(0, np.uint32)).view(np.int32)
    lvs = [np.ascontiguousarray(v, np.float64).reshape(-1)
           for v in leaf_values]
    for r, v in zip(recs, lvs):
        if len(v) != r.shape[0] + 1:
            raise LightGBMError("valid_walk.pack: %d leaf values for %d "
                                "nodes" % (len(v), r.shape[0]))
    n_leaf = sum(len(v) for v in lvs)
    n_rec = sum(r.size for r in recs)
    buf = np.empty(2 * n_leaf + n_rec + len(words), np.int32)
    if n_leaf:
        buf[:2 * n_leaf].view(np.float64)[:] = np.concatenate(lvs)
    if recs:
        buf[2 * n_leaf:2 * n_leaf + n_rec] = np.concatenate(
            [r.reshape(-1) for r in recs])
    buf[2 * n_leaf + n_rec:] = words
    dev = torch.as_tensor(buf, device=device)
    leaves = dev[:2 * n_leaf].view(torch.float64)
    wdev = dev[2 * n_leaf + n_rec:]
    out, lo, no = [], 0, 2 * n_leaf
    for r, v in zip(recs, lvs):
        out.append(PackedTree(dev[no:no + r.size].view(-1, VW_COLS),
                              leaves[lo:lo + len(v)], wdev))
        lo += len(v)
        no += r.size
    return out


def valid_walk_plain(bins: torch.Tensor, nodes: torch.Tensor,
                     leaves: torch.Tensor, score: torch.Tensor,
                     words: torch.Tensor = None) -> None:
    """score += leaves[leaf(row)] in plain PyTorch (one f64 add per row)."""
    score.add_(leaves[walk_leaves_plain(bins, nodes, words)])


def _launch(bins, nodes, leaves, score, words) -> None:
    from .build import load
    fn = load("valid_walk").valid_walk_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_longlong, ctypes.c_int, P, P, ctypes.c_int,
                   P, ctypes.c_int, P, P]
    fn.restype = ctypes.c_int
    nw = 0 if words is None else words.numel()
    err = fn(P(bins.data_ptr()), bins.shape[0], bins.shape[1],
             P(nodes.data_ptr()), P(leaves.data_ptr()), nodes.shape[0],
             P(words.data_ptr() if nw else None), nw, P(score.data_ptr()),
             P(torch.cuda.current_stream(bins.device).cuda_stream))
    if err != 0:
        raise LightGBMError("valid_walk launch failed: CUDA error %d" % err)


def valid_walk(bins: torch.Tensor, nodes: torch.Tensor,
               leaves: torch.Tensor, score: torch.Tensor,
               words: torch.Tensor = None) -> None:
    """score[r] += leaves[leaf(r)] for every row r of `bins` ([n, G]
    uint8, binned like the training set), walking the tree of node records
    `nodes` ([num_nodes, VW_COLS] int32) with leaf values `leaves`
    ([num_nodes + 1] f64); `score` is an f64 [n] row, in place. `words`
    (int32 [W]) holds the categorical nodes' inner bitsets; without it a
    categorical node sends every row right."""
    n = bins.shape[0]
    if score.dtype != torch.float64 or score.shape != (n,) \
            or not score.is_contiguous():
        raise LightGBMError("valid_walk: score must be a contiguous [n] "
                            "f64 tensor")
    if not _check_walk("valid_walk", bins, nodes, leaves, words, (score,)):
        return valid_walk_plain(bins, nodes, leaves, score, words)
    _launch(bins, nodes, leaves, score, words)
    valid_walk.launches += 1


def _check_walk(name, bins, nodes, leaves, words, rows) -> bool:
    """True to launch (operands on the card), False for the plain version
    (on the CPU); raises for malformed bins, node records, leaf values or
    words, or for operands (`rows`: the caller's own) on different
    devices or on another device."""
    if bins.dtype != torch.uint8 or bins.dim() != 2 \
            or not bins.is_contiguous():
        raise LightGBMError("%s: bins must be a contiguous [n, G] uint8 "
                            "tensor" % name)
    if nodes.dtype != torch.int32 or nodes.dim() != 2 \
            or nodes.shape[1] != VW_COLS or not nodes.is_contiguous():
        raise LightGBMError("%s: nodes must be a contiguous [num_nodes, %d] "
                            "int32 tensor" % (name, VW_COLS))
    if leaves.dtype != torch.float64 or leaves.numel() != nodes.shape[0] + 1:
        raise LightGBMError("%s: leaves must hold num_nodes + 1 f64 values"
                            % name)
    if words is not None and (words.dtype != torch.int32 or words.dim() != 1
                              or not words.is_contiguous()):
        raise LightGBMError("%s: words must be a contiguous 1-D int32 "
                            "tensor" % name)
    dev = bins.device
    if any(t.device != dev for t in (nodes, leaves) + tuple(rows)) or \
            (words is not None and words.device != dev):
        raise LightGBMError("%s: operands on different devices" % name)
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("%s: no kernel for device %s" % (name, dev))
    return dev.type == "cuda"


valid_walk.launches = 0


def valid_walk_payload_plain(bins: torch.Tensor, rid: torch.Tensor,
                             nodes: torch.Tensor, leaves: torch.Tensor,
                             score: torch.Tensor, n: int,
                             words: torch.Tensor = None) -> None:
    """score[:n] += f32(leaves[leaf(bins[rid[l]])]) in plain PyTorch: the
    row-ordered walk, its f64 values rounded to f32 and gathered through
    the row ids, one f32 add per lane."""
    delta = leaves[walk_leaves_plain(bins, nodes, words)].to(torch.float32)
    score[:n] += delta.index_select(0, rid[:n].to(torch.int64))


def valid_walk_payload(bins: torch.Tensor, rid: torch.Tensor,
                       nodes: torch.Tensor, leaves: torch.Tensor,
                       score: torch.Tensor, n: int,
                       words: torch.Tensor = None) -> None:
    """score[l] += f32(leaves[leaf(bins[rid[l]])]) for the n live lanes of
    a payload: `rid` its int32 row-id row, `score` its f32 score row (a
    view of at least n lanes, in place), `bins` the training rows' [N, G]
    uint8 bins; the tree as in :func:`valid_walk`. Lanes past n are left
    alone."""
    if rid.dtype != torch.int32 or rid.dim() != 1 or rid.shape[0] < n \
            or not rid.is_contiguous():
        raise LightGBMError("valid_walk_payload: rid must be a contiguous "
                            "int32 row of at least n lanes")
    if score.dtype != torch.float32 or score.dim() != 1 \
            or score.shape[0] < n or not score.is_contiguous():
        raise LightGBMError("valid_walk_payload: score must be a contiguous "
                            "f32 row of at least n lanes")
    if not _check_walk("valid_walk_payload", bins, nodes, leaves, words,
                       (rid, score)):
        return valid_walk_payload_plain(bins, rid, nodes, leaves, score, n,
                                        words)
    from .build import load
    fn = load("valid_walk").valid_walk_payload_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, ctypes.c_int, P, ctypes.c_longlong, P, P,
                   ctypes.c_int, P, ctypes.c_int, P, P]
    fn.restype = ctypes.c_int
    nw = 0 if words is None else words.numel()
    err = fn(P(bins.data_ptr()), bins.shape[1], P(rid.data_ptr()), int(n),
             P(nodes.data_ptr()), P(leaves.data_ptr()), nodes.shape[0],
             P(words.data_ptr() if nw else None), nw, P(score.data_ptr()),
             P(torch.cuda.current_stream(bins.device).cuda_stream))
    if err != 0:
        raise LightGBMError("valid_walk_payload launch failed: CUDA error %d"
                            % err)
    valid_walk_payload.launches += 1


valid_walk_payload.launches = 0
