"""Compile a trained ensemble into device-friendly tensors (host, numpy).

The port's copy of lightgbm_tpu/predict/compile.py. The host walk
(models/tree.py) walks each tree over all rows with numpy gathers; serving
wants the ensemble packed once into dense arrays that stay on the card.

:func:`compile_ensemble` packs the per-tree SoA arrays (`split_feature`,
`threshold`, `decision_type`, children, leaf values, categorical bitsets)
into padded ``[T, N]`` tensors, with trees bucketed by next-power-of-two
depth, exactly as the JAX package does: its buckets are the contract the
tests hold field by field. Categorical thresholds keep the reference bitset
representation: all bitset words of a bucket flatten into one uint32 array
with per-node (offset, nwords).

:func:`flatten` lays the buckets out again for the CUDA walk
(``csrc/predict.cu``): one record per node slot of every tree, the trees in
model order, because a CUDA thread walks a tree until it reaches a leaf and
needs no fixed depth, and sums the trees of its class in model order.

Node encoding matches models/tree.py: child >= 0 is an internal node index,
child < 0 encodes leaf ~child. A tree of one leaf is a stub node whose two
children are both leaf 0.
"""
from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np

from ..ops.predict import (PW_CNW, PW_COFF, PW_DT, PW_FEAT, PW_LEFT,
                           PW_RIGHT, PW_THR)
from ..utils.log import LightGBMError

# refuse to ship absurd categorical blobs to the card
MAX_CAT_WORDS = 1 << 26


class EnsembleCompileError(LightGBMError):
    """Raised when the model geometry cannot be packed for the device
    walk (an empty model, oversized categorical bitsets)."""


class TreeBucket(NamedTuple):
    """One depth bucket of the ensemble, padded to common geometry.

    T trees, N internal-node slots, L leaf slots, W categorical words.
    """

    depth: int                 # traversal steps (max leaf depth in bucket)
    tree_pos: np.ndarray       # [T] int32 — position in the model list
    split_feature: np.ndarray  # [T, N] int32
    threshold: np.ndarray      # [T, N] f64 (cat nodes: unused)
    decision_type: np.ndarray  # [T, N] int32 (widened from the int8 field)
    left: np.ndarray           # [T, N] int32
    right: np.ndarray          # [T, N] int32
    leaf_value: np.ndarray     # [T, L] f64
    cat_offset: np.ndarray     # [T, N] int32 into cat_words
    cat_nwords: np.ndarray     # [T, N] int32 (0 = not categorical)
    cat_words: np.ndarray      # [W] uint32 (>= 1 word, zero-padded)


class CompiledEnsemble(NamedTuple):
    buckets: Tuple[TreeBucket, ...]
    num_trees: int
    num_tree_per_iteration: int
    average_output: bool
    max_feature_idx: int


class FlatEnsemble(NamedTuple):
    """The node slots of every tree in model order (see :func:`flatten`)."""

    tree_node: np.ndarray      # [T] int32: first node slot of tree t
    tree_leaf: np.ndarray      # [T] int32: first leaf slot of tree t
    nodes: np.ndarray          # [Nn, PW_THR] int32: feature, decision
    #                          # type, left, right, cat word offset, count
    threshold: np.ndarray      # [Nn] f64
    leaf_value: np.ndarray     # [Nl] f64
    cat_words: np.ndarray      # [W] uint32 (>= 1 word)
    depth: int                 # the deepest bucket's steps (>= 1)


def _next_pow2(x: int) -> int:
    return 1 << max(int(x) - 1, 0).bit_length()


def tree_depth(tree) -> int:
    """The deepest leaf of a tree (0 for one leaf), as the JAX package's
    Tree.max_depth over its _fill_leaf_depth (models/tree.py:173-183,
    545-548): node k's children are later nodes or leaves."""
    n = tree.num_leaves
    if n <= 1:
        return 0
    depth = np.zeros(n - 1, dtype=np.int32)
    deepest = 0
    for k in range(n - 1):
        for child in (int(tree.left_child[k]), int(tree.right_child[k])):
            if child >= 0:
                depth[child] = depth[k] + 1
            else:
                deepest = max(deepest, int(depth[k]) + 1)
    return deepest


def _pack_bucket(models: List, positions: List[int], depth: int) -> TreeBucket:
    T = len(positions)
    ni = max(max(models[p].num_leaves - 1 for p in positions), 1)
    nl = max(max(models[p].num_leaves for p in positions), 1)
    split_feature = np.zeros((T, ni), dtype=np.int32)
    threshold = np.zeros((T, ni), dtype=np.float64)
    decision_type = np.zeros((T, ni), dtype=np.int32)
    left = np.full((T, ni), -1, dtype=np.int32)
    right = np.full((T, ni), -1, dtype=np.int32)
    leaf_value = np.zeros((T, nl), dtype=np.float64)
    cat_offset = np.zeros((T, ni), dtype=np.int32)
    cat_nwords = np.zeros((T, ni), dtype=np.int32)
    words: List[int] = []
    for t, pos in enumerate(positions):
        tree = models[pos]
        n = tree.num_leaves
        leaf_value[t, :n] = tree.leaf_value[:n]
        if n <= 1:
            # stub: one synthetic numeric node routing everything to leaf 0
            continue
        k = n - 1
        split_feature[t, :k] = tree.split_feature[:k]
        threshold[t, :k] = tree.threshold[:k]
        decision_type[t, :k] = tree.decision_type[:k].astype(np.int32)
        left[t, :k] = tree.left_child[:k]
        right[t, :k] = tree.right_child[:k]
        for node in range(k):
            if not (int(tree.decision_type[node]) & 1):   # kCategoricalMask
                continue
            ci = int(tree.threshold[node])
            b0, b1 = tree.cat_boundaries[ci], tree.cat_boundaries[ci + 1]
            cat_offset[t, node] = len(words)
            cat_nwords[t, node] = b1 - b0
            words.extend(int(w) & 0xFFFFFFFF
                         for w in tree.cat_threshold[b0:b1])
    if len(words) > MAX_CAT_WORDS:
        raise EnsembleCompileError(
            "categorical bitsets too large for the device predictor "
            "(%d words > %d)" % (len(words), MAX_CAT_WORDS))
    cat_words = np.asarray(words or [0], dtype=np.uint32)
    return TreeBucket(
        depth=depth, tree_pos=np.asarray(positions, dtype=np.int32),
        split_feature=split_feature, threshold=threshold,
        decision_type=decision_type, left=left, right=right,
        leaf_value=leaf_value, cat_offset=cat_offset,
        cat_nwords=cat_nwords, cat_words=cat_words)


def quant_spec(ensemble: Optional[CompiledEnsemble] = None,
               target: str = "float16", num_trees: int = 500) -> dict:
    """Declarative quantization spec for f16 leaf/threshold serving
    tensors: the caps of the packed tensors (or the contract defaults:
    per-tree |leaf| <= 1 after shrinkage, thresholds within the binned
    feature span). The port serves no quantized ensemble yet (ROADMAP
    queue A, item 8, step 3); the spec is kept for that step."""
    leaf_cap, thr_cap, n_trees = 1.0, 256.0, int(num_trees)
    if ensemble is not None:
        leaf_cap = max((float(np.abs(b.leaf_value).max())
                        for b in ensemble.buckets), default=1.0)
        thr_cap = max((float(np.abs(b.threshold).max())
                       for b in ensemble.buckets), default=1.0)
        n_trees = ensemble.num_trees
    return {
        "name": "leaf_%s" % target,
        "kind": "leaf",
        "target": target,
        "leaf_abs_max": leaf_cap,
        "threshold_abs_max": thr_cap,
        "num_trees": max(n_trees, 1),
    }


QUANT_TARGETS = ("float16", "f16")


def quantize_ensemble(ensemble: CompiledEnsemble,
                      target: str = "float16"
                      ) -> Tuple[CompiledEnsemble, dict]:
    """Snap an ensemble's leaf and threshold tensors onto the float16
    value grid (each value rounds through ``np.float16`` and widens back,
    so the walk keeps its dtype). Returns (quantized ensemble, its
    :func:`quant_spec`). Only float16 is buildable."""
    if target not in QUANT_TARGETS:
        raise EnsembleCompileError(
            "unsupported quantization target %r (buildable: %s)"
            % (target, "/".join(QUANT_TARGETS)))
    spec = quant_spec(ensemble, target="float16")

    def _snap(a: np.ndarray) -> np.ndarray:
        return a.astype(np.float16).astype(np.float64)

    buckets = tuple(
        b._replace(threshold=_snap(b.threshold),
                   leaf_value=_snap(b.leaf_value))
        for b in ensemble.buckets)
    return ensemble._replace(buckets=buckets), spec


def compile_ensemble(models: List, num_tree_per_iteration: int = 1,
                     average_output: bool = False,
                     max_feature_idx: int = 0) -> CompiledEnsemble:
    """Pack host Trees into depth-bucketed tensors.

    Raises EnsembleCompileError for geometry the device walk cannot serve
    (an empty model, oversized categorical bitsets).
    """
    if not models:
        raise EnsembleCompileError("cannot compile an empty model")
    if any(m is None for m in models):
        raise EnsembleCompileError("model has unmaterialized trees")
    by_depth = {}
    for pos, tree in enumerate(models):
        d = _next_pow2(max(tree_depth(tree), 1))
        by_depth.setdefault(d, []).append(pos)
    buckets = tuple(_pack_bucket(models, by_depth[d], d)
                    for d in sorted(by_depth))
    return CompiledEnsemble(
        buckets=buckets, num_trees=len(models),
        num_tree_per_iteration=max(int(num_tree_per_iteration), 1),
        average_output=bool(average_output),
        max_feature_idx=int(max_feature_idx))


def flatten(ensemble: CompiledEnsemble) -> FlatEnsemble:
    """The buckets' node and leaf slots, tree by tree in model order: tree
    t's N node slots (its bucket's padded width; padding slots are never
    reached) from ``tree_node[t]``, its leaf slots from ``tree_leaf[t]``,
    and one word array of all buckets' bitsets (each node's word offset
    moved by its bucket's base)."""
    T = ensemble.num_trees
    bucket_of = np.zeros(T, dtype=np.int64)
    row_of = np.zeros(T, dtype=np.int64)
    for b, bk in enumerate(ensemble.buckets):
        bucket_of[bk.tree_pos] = b
        row_of[bk.tree_pos] = np.arange(len(bk.tree_pos))
    node_w = np.array([bk.split_feature.shape[1]
                       for bk in ensemble.buckets])[bucket_of]
    leaf_w = np.array([bk.leaf_value.shape[1]
                       for bk in ensemble.buckets])[bucket_of]
    word_base = np.cumsum([0] + [len(bk.cat_words)
                                 for bk in ensemble.buckets])
    tree_node = np.concatenate([[0], np.cumsum(node_w)])
    tree_leaf = np.concatenate([[0], np.cumsum(leaf_w)])
    nodes = np.zeros((int(tree_node[-1]), PW_THR), dtype=np.int32)
    threshold = np.zeros(int(tree_node[-1]), dtype=np.float64)
    leaf_value = np.zeros(int(tree_leaf[-1]), dtype=np.float64)
    for t in range(T):
        bk = ensemble.buckets[bucket_of[t]]
        r = row_of[t]
        sl = slice(int(tree_node[t]), int(tree_node[t + 1]))
        nodes[sl, PW_FEAT] = bk.split_feature[r]
        nodes[sl, PW_DT] = bk.decision_type[r]
        nodes[sl, PW_LEFT] = bk.left[r]
        nodes[sl, PW_RIGHT] = bk.right[r]
        nodes[sl, PW_COFF] = bk.cat_offset[r] + word_base[bucket_of[t]]
        nodes[sl, PW_CNW] = bk.cat_nwords[r]
        threshold[sl] = bk.threshold[r]
        leaf_value[int(tree_leaf[t]):int(tree_leaf[t + 1])] = \
            bk.leaf_value[r]
    if int(word_base[-1]) > MAX_CAT_WORDS:
        raise EnsembleCompileError(
            "categorical bitsets too large for the device predictor "
            "(%d words > %d)" % (int(word_base[-1]), MAX_CAT_WORDS))
    return FlatEnsemble(
        tree_node=tree_node[:T].astype(np.int32),
        tree_leaf=tree_leaf[:T].astype(np.int32), nodes=nodes,
        threshold=threshold, leaf_value=leaf_value,
        cat_words=np.concatenate([bk.cat_words
                                  for bk in ensemble.buckets]),
        depth=max(bk.depth for bk in ensemble.buckets))
