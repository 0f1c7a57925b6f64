"""Learned decision tree: SoA arrays, numpy prediction, LightGBM model text.

The port's copy of lightgbm_tpu/models/tree.py's training and prediction
parts (reference include/LightGBM/tree.h:25, src/io/tree.cpp). ``from_grower``
replays the grower's split records through Tree::Split's node numbering
(tree.h:430-468: internal node k is created by split k, the left child
keeps the split leaf's id, the right child is new leaf k+1, leaves encoded
as ~leaf). Prediction is a vectorized numpy walk over all rows; the model
text matches Tree::ToString field for field, so the two packages read each
other's models.

decision_type byte (tree.h:19-23): bit0 categorical, bit1 default_left,
bits 2-3 missing type (0 none / 1 zero / 2 nan). A categorical node's
threshold is the index of its bitset: ``cat_threshold`` words (bit v: the
category v goes left) between ``cat_boundaries``, and beside them the
inner bitset of left bins (``cat_*_inner``, not in the model text; a
loaded tree gets it from :meth:`Tree.bind_to_dataset`). As the JAX
package's from_grower, a categorical node carries no missing type, so at
prediction a NaN is category 0; a negative value goes right.

The binned walk (the JAX package's predict_leaf_binned, tree.py:420-481,
the reference's AddPredictionToScore over a Dataset) walks the rows of a
BinnedDataset aligned with the training set: :meth:`Tree.node_records`
folds each internal node's feature metadata (its group, its group-local
bin range, most frequent, default and NaN bins) into one int32 record,
and :func:`walk_leaves_plain` walks those records over the [n, G] uint8
bins level by level in plain PyTorch. A categorical node's record points
at its inner bitset's words in a word array that goes beside the records
(:meth:`Tree.cat_words_inner`). The CUDA kernel of ops/valid_walk.py walks
the same records.
"""
from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch


kCategoricalMask = 1
kDefaultLeftMask = 2
kZeroThreshold = 1e-35
# a categorical node's record: VW_THR its first inner word, VW_NB1 their
# count (columns of the numerical decision, unused by the categorical one)

# columns of a node record of the binned walk (csrc/valid_walk.cu)
(VW_G, VW_LO, VW_HI, VW_MFB, VW_DB, VW_NB1, VW_THR, VW_DT, VW_LEFT,
 VW_RIGHT) = range(10)
VW_COLS = 10


def _fmt(x: float) -> str:
    """Double -> shortest round-trip string."""
    return repr(float(x))


def _fmt_g(x) -> str:
    """%g-style float formatting used for gains/weights."""
    return "%g" % float(x)


def _fmt_arr(a, fmt=str) -> str:
    return " ".join(fmt(x) for x in a)


def _to_bitset(values) -> np.ndarray:
    """Common::ConstructBitset: uint32 words, bit v set for each value v
    (one zero word for none)."""
    values = np.asarray(values, dtype=np.int64)
    if len(values) == 0:
        return np.zeros(1, dtype=np.uint32)
    out = np.zeros(int(values.max()) // 32 + 1, dtype=np.uint32)
    np.bitwise_or.at(out, values // 32,
                     np.uint32(1) << (values % 32).astype(np.uint32))
    return out


def _in_bitset(bits: np.ndarray, vals: np.ndarray) -> np.ndarray:
    """Vectorized Common::FindInBitset over an int array."""
    word = vals // 32
    ok = (vals >= 0) & (word < len(bits))
    word_safe = np.clip(word, 0, len(bits) - 1)
    return ok & ((bits[word_safe] >> (vals % 32).astype(np.uint32))
                 & 1).astype(bool)


def words_to_bins(words) -> np.ndarray:
    """The set bits of uint32 mask words, ascending."""
    w = np.asarray(words, np.uint32)
    bits = (w[:, None] >> np.arange(32, dtype=np.uint32)) & 1
    return np.nonzero(bits.reshape(-1))[0]


class Tree:
    """One boosted tree in reference-compatible SoA form."""

    def __init__(self, max_leaves: int):
        L = max(int(max_leaves), 1)
        self.num_leaves = 1
        self.shrinkage = 1.0
        ni = max(L - 1, 1)
        self.split_feature_inner = np.zeros(ni, dtype=np.int32)
        self.split_feature = np.zeros(ni, dtype=np.int32)
        self.split_gain = np.zeros(ni, dtype=np.float64)
        self.threshold_in_bin = np.zeros(ni, dtype=np.int32)
        self.threshold = np.zeros(ni, dtype=np.float64)
        self.decision_type = np.zeros(ni, dtype=np.int8)
        self.left_child = np.zeros(ni, dtype=np.int32)
        self.right_child = np.zeros(ni, dtype=np.int32)
        self.internal_value = np.zeros(ni, dtype=np.float64)
        self.internal_weight = np.zeros(ni, dtype=np.float64)
        self.internal_count = np.zeros(ni, dtype=np.int32)
        self.leaf_value = np.zeros(L, dtype=np.float64)
        self.leaf_weight = np.zeros(L, dtype=np.float64)
        self.leaf_count = np.zeros(L, dtype=np.int32)
        self.leaf_parent = np.full(L, -1, dtype=np.int32)
        self.num_cat = 0
        self.cat_boundaries = [0]
        self.cat_threshold: List[int] = []         # uint32 words (values)
        self.cat_boundaries_inner = [0]
        self.cat_threshold_inner: List[int] = []   # uint32 words (bins)

    def _add_cat(self, k: int, cats, bins) -> None:
        """Node k splits categorically: `cats` (categories) and `bins`
        (inner bins) go left."""
        real_bits, inner_bits = _to_bitset(cats), _to_bitset(bins)
        self.decision_type[k] = kCategoricalMask
        self.threshold_in_bin[k] = len(self.cat_boundaries_inner) - 1
        self.threshold[k] = float(self.num_cat)
        self.num_cat += 1
        self.cat_boundaries.append(self.cat_boundaries[-1] + len(real_bits))
        self.cat_threshold.extend(int(x) for x in real_bits)
        self.cat_boundaries_inner.append(
            self.cat_boundaries_inner[-1] + len(inner_bits))
        self.cat_threshold_inner.extend(int(x) for x in inner_bits)

    def _real_bits(self, k: int) -> np.ndarray:
        ci = int(self.threshold[k])
        return np.asarray(self.cat_threshold[self.cat_boundaries[ci]:
                                             self.cat_boundaries[ci + 1]],
                          dtype=np.uint32)

    # ------------------------------------------------------------------
    @classmethod
    def from_grower(cls, arrays, dataset) -> "Tree":
        """Build from the grower's TreeArrays + the BinnedDataset that maps
        inner features/bins to real ones (a categorical split: its left
        bins' categories, the JAX package's tree.py:115-140)."""
        n_leaves = int(arrays.num_leaves)
        t = cls(max(n_leaves, 1))
        t.num_leaves = n_leaves
        is_cat = getattr(arrays, "is_cat", None)
        for k in range(n_leaves - 1):
            leaf = int(arrays.split_leaf[k])
            parent = t.leaf_parent[leaf]
            if parent >= 0:
                if t.left_child[parent] == ~leaf:
                    t.left_child[parent] = k
                else:
                    t.right_child[parent] = k
            inner_f = int(arrays.split_feature[k])
            real_f = dataset.used_features[inner_f]
            mapper = dataset.bin_mappers[real_f]
            t.split_feature_inner[k] = inner_f
            t.split_feature[k] = real_f
            t.split_gain[k] = float(arrays.gain[k])
            t.left_child[k] = ~leaf
            t.right_child[k] = ~(k + 1)
            t.leaf_parent[leaf] = k
            t.leaf_parent[k + 1] = k
            t.internal_value[k] = float(arrays.internal_value[k])
            t.internal_count[k] = int(arrays.internal_count[k])
            if is_cat is not None and bool(is_cat[k]):
                bins = words_to_bins(arrays.cat_words[k])
                bins = bins[bins < mapper.num_bin]
                cats = np.array([mapper.bin_2_categorical[b] for b in bins],
                                dtype=np.int64)
                t._add_cat(k, cats[cats >= 0], bins)
                continue
            dt = np.int8(0)
            if bool(arrays.default_left[k]):
                dt |= kDefaultLeftMask
            dt |= np.int8(int(mapper.missing_type) << 2)
            bin_thr = int(arrays.threshold[k])
            t.threshold_in_bin[k] = bin_thr
            t.threshold[k] = mapper.bin_to_value(bin_thr)
            t.decision_type[k] = dt
        lv = np.asarray(arrays.leaf_value, dtype=np.float64)[:max(n_leaves, 1)]
        t.leaf_value[:len(lv)] = np.where(np.isnan(lv), 0.0, lv)
        t.leaf_count[:n_leaves] = np.asarray(arrays.leaf_count)[:n_leaves]
        t.leaf_weight[:n_leaves] = np.asarray(arrays.leaf_weight)[:n_leaves]
        t._fill_internal_weight()
        return t

    def _fill_internal_weight(self) -> None:
        """internal_weight = subtree sum of hessians, bottom-up: node k's
        children have index > k or are leaves."""
        for k in range(self.num_leaves - 2, -1, -1):
            lw = (self.leaf_weight[~self.left_child[k]]
                  if self.left_child[k] < 0
                  else self.internal_weight[self.left_child[k]])
            rw = (self.leaf_weight[~self.right_child[k]]
                  if self.right_child[k] < 0
                  else self.internal_weight[self.right_child[k]])
            self.internal_weight[k] = lw + rw

    # ------------------------------------------------------------------
    def shrink(self, rate: float) -> None:
        """Tree::Shrinkage (tree.h:158-170)."""
        self.leaf_value[:self.num_leaves] *= rate
        self.internal_value[:max(self.num_leaves - 1, 0)] *= rate
        self.shrinkage *= rate

    def add_bias(self, val: float) -> None:
        """Tree::AddBias (tree.h:172-183)."""
        self.leaf_value[:self.num_leaves] += val
        self.internal_value[:max(self.num_leaves - 1, 0)] += val

    def set_leaf_output(self, leaf: int, value: float) -> None:
        """Tree::SetLeafOutput (tree.h:118): a NaN output is stored as 0."""
        self.leaf_value[leaf] = 0.0 if np.isnan(value) else value

    def leaf_depths(self) -> np.ndarray:
        """[num_leaves] int32 depth of each leaf (the root's children at 1;
        a one-leaf tree's leaf at 0): node k's children have index > k, so
        one pass in node order sets every depth."""
        n = self.num_leaves
        out = np.zeros(max(n, 1), dtype=np.int32)
        if n <= 1:
            return out
        depth = np.zeros(n - 1, dtype=np.int32)
        for k in range(n - 1):
            for child in (self.left_child[k], self.right_child[k]):
                if child >= 0:
                    depth[child] = depth[k] + 1
                else:
                    out[~child] = depth[k] + 1
        return out

    def max_depth(self) -> int:
        """The depth of the deepest leaf (0 for a one-leaf tree)."""
        return int(self.leaf_depths().max())

    # ------------------------------------------------------------------
    def predict_leaf(self, X: np.ndarray) -> np.ndarray:
        """Vectorized GetLeaf over raw feature rows [N, F] -> leaf idx [N]."""
        n = X.shape[0]
        if self.num_leaves <= 1:
            return np.zeros(n, dtype=np.int32)
        node = np.zeros(n, dtype=np.int32)
        active = np.arange(n)
        while len(active):
            nd = node[active]
            go_left = self._decision(X[active, self.split_feature[nd]], nd)
            nxt = np.where(go_left, self.left_child[nd], self.right_child[nd])
            node[active] = nxt
            active = active[nxt >= 0]
        return (~node).astype(np.int32)

    def _decision(self, fval: np.ndarray, node: np.ndarray) -> np.ndarray:
        """Vectorized Tree::Decision (tree.h:244-332): numerical nodes
        compare with the threshold, categorical ones look the category up
        in their bitset (NaN is category 0 unless the missing type is NaN;
        a negative value goes right)."""
        dt = self.decision_type[node]
        mt = (dt >> 2) & 3
        is_cat = (dt & kCategoricalMask) != 0
        default_left = (dt & kDefaultLeftMask) != 0
        fv = fval.astype(np.float64)
        isnan = np.isnan(fv)
        fv0 = np.where(isnan & (mt != 2), 0.0, fv)
        is_zero = np.abs(fv0) <= kZeroThreshold
        go_default = ((mt == 1) & is_zero) | ((mt == 2) & isnan)
        out = np.where(go_default, default_left, fv0 <= self.threshold[node])
        if is_cat.any():
            cat_node = node[is_cat]
            int_fval = np.where(isnan[is_cat], 0, fv[is_cat]).astype(np.int64)
            res = np.zeros(len(cat_node), dtype=bool)
            ci = self.threshold[cat_node].astype(np.int32)
            for c in np.unique(ci):
                m = ci == c
                res[m] = _in_bitset(self._real_bits(cat_node[m][0]),
                                    int_fval[m])
            res &= ~(isnan[is_cat] & (mt[is_cat] == 2))
            res &= ~(fv[is_cat] < 0)
            out[is_cat] = res
        return out

    def predict(self, X: np.ndarray) -> np.ndarray:
        if self.num_leaves <= 1:
            return np.full(X.shape[0], self.leaf_value[0])
        return self.leaf_value[self.predict_leaf(X)]

    # -- binned (inner) prediction: the validation scores ---------------
    def node_records(self, dataset, word_base: int = 0) -> np.ndarray:
        """[num_leaves - 1, VW_COLS] int32 records of the internal nodes
        for the binned walk over rows of `dataset` (a BinnedDataset with
        this tree's inner features): per node its feature's group, the
        feature's group-local bin range [lo, hi), most frequent bin (the
        bin of a row outside the range), default bin and last bin, then
        the threshold bin, the decision type and the children. A
        categorical node holds instead of its last bin and threshold the
        count and the first index of its inner bitset's words in
        :meth:`cat_words_inner`, offset by `word_base` (the tree's place in
        a word array of several trees)."""
        ni = max(self.num_leaves - 1, 0)
        rec = np.zeros((ni, VW_COLS), np.int32)
        if ni == 0:
            return rec
        dt = self.decision_type[:ni].astype(np.int32)
        f = self.split_feature_inner[:ni]
        g = np.asarray(dataset.group_of)[f]
        goff = np.asarray(dataset.group_offset)[g]
        start = np.asarray(dataset.bin_start)[f]
        end = np.asarray(dataset.bin_end)[f]
        rec[:, VW_G] = g
        rec[:, VW_LO] = start - goff
        rec[:, VW_HI] = end - goff
        rec[:, VW_MFB] = np.asarray(dataset.most_freq_bin)[f]
        rec[:, VW_DB] = np.asarray(dataset.default_bin)[f]
        rec[:, VW_NB1] = end - start - 1
        rec[:, VW_THR] = self.threshold_in_bin[:ni]
        rec[:, VW_DT] = dt
        rec[:, VW_LEFT] = self.left_child[:ni]
        rec[:, VW_RIGHT] = self.right_child[:ni]
        cat = np.nonzero(dt & kCategoricalMask)[0]
        if len(cat):
            cb = np.asarray(self.cat_boundaries_inner, np.int64)
            ci = self.threshold_in_bin[cat]
            rec[cat, VW_THR] = word_base + cb[ci]
            rec[cat, VW_NB1] = cb[ci + 1] - cb[ci]
        return rec

    def cat_words_inner(self) -> np.ndarray:
        """The inner bitsets' words of the categorical nodes (uint32), the
        word array their node records index."""
        return np.asarray(self.cat_threshold_inner, np.uint32)

    def predict_leaf_binned(self, dataset) -> np.ndarray:
        """Leaf index [n] of each row of a BinnedDataset aligned with this
        tree's inner features (the plain walk on the host)."""
        words = torch.from_numpy(self.cat_words_inner().view(np.int32))
        leaves = walk_leaves_plain(torch.from_numpy(dataset.binned),
                                   torch.from_numpy(
                                       self.node_records(dataset)), words)
        return leaves.numpy().astype(np.int32)

    def predict_binned(self, dataset) -> np.ndarray:
        if self.num_leaves <= 1:
            return np.full(dataset.num_data, self.leaf_value[0])
        return self.leaf_value[self.predict_leaf_binned(dataset)]

    def bind_to_dataset(self, dataset) -> "Tree":
        """The inner decision fields of a tree read from model text, from a
        BinnedDataset's mappers (the JAX package's tree.py:489-530): the
        threshold bins, and the categories of each categorical node as
        inner bins. A feature that is trivial in the dataset routes every
        row by its constant value."""
        self.cat_boundaries_inner = [0]
        self.cat_threshold_inner = []
        for k in range(self.num_leaves - 1):
            real_f = int(self.split_feature[k])
            inner = dataset.inner_of.get(real_f, -1)
            mapper = dataset.bin_mappers[real_f]
            is_cat = bool(self.decision_type[k] & kCategoricalMask)
            if inner < 0:
                self.split_feature_inner[k] = 0
                go_left = (not is_cat
                           and mapper.min_val <= self.threshold[k])
                self.threshold_in_bin[k] = (1 << 30) if go_left else -1
                self.decision_type[k] &= ~np.int8(3 << 2)
                self.decision_type[k] &= ~np.int8(kCategoricalMask)
                continue
            self.split_feature_inner[k] = inner
            if is_cat:
                bits = self._real_bits(k)
                cats = words_to_bins(bits)
                bins = [mapper.categorical_2_bin[int(c)] for c in cats
                        if int(c) in mapper.categorical_2_bin]
                inner_bits = _to_bitset(np.asarray(bins, dtype=np.int64))
                self.threshold_in_bin[k] = len(self.cat_boundaries_inner) - 1
                self.cat_boundaries_inner.append(
                    self.cat_boundaries_inner[-1] + len(inner_bits))
                self.cat_threshold_inner.extend(int(x) for x in inner_bits)
            else:
                self.threshold_in_bin[k] = int(
                    mapper.value_to_bin(np.array([self.threshold[k]]))[0])
        return self

    # ------------------------------------------------------------------
    def to_string(self) -> str:
        """Tree::ToString (src/io/tree.cpp) — byte-compatible field list."""
        n = self.num_leaves
        ni = max(n - 1, 0)
        buf = [
            "num_leaves=%d" % n,
            "num_cat=%d" % self.num_cat,
            "split_feature=" + _fmt_arr(self.split_feature[:ni]),
            "split_gain=" + _fmt_arr(self.split_gain[:ni], _fmt_g),
            "threshold=" + _fmt_arr(self.threshold[:ni], _fmt),
            "decision_type=" + _fmt_arr(self.decision_type[:ni]),
            "left_child=" + _fmt_arr(self.left_child[:ni]),
            "right_child=" + _fmt_arr(self.right_child[:ni]),
            "leaf_value=" + _fmt_arr(self.leaf_value[:n], _fmt),
            "leaf_weight=" + _fmt_arr(self.leaf_weight[:n], _fmt),
            "leaf_count=" + _fmt_arr(self.leaf_count[:n]),
            "internal_value=" + _fmt_arr(self.internal_value[:ni], _fmt_g),
            "internal_weight=" + _fmt_arr(self.internal_weight[:ni], _fmt_g),
            "internal_count=" + _fmt_arr(self.internal_count[:ni]),
        ]
        if self.num_cat > 0:
            buf.append("cat_boundaries=" + _fmt_arr(self.cat_boundaries))
            buf.append("cat_threshold=" + _fmt_arr(self.cat_threshold))
        buf += ["shrinkage=%s" % _fmt_g(self.shrinkage), ""]
        return "\n".join(buf) + "\n"

    def to_json(self) -> dict:
        """Tree::ToJSON (src/io/tree.cpp): the nested node dict, key for
        key the JAX package's (tree.py:626-679)."""
        out = {"num_leaves": self.num_leaves, "num_cat": self.num_cat,
               "shrinkage": self.shrinkage}
        if self.num_leaves == 1:
            out["tree_structure"] = {"leaf_value": float(self.leaf_value[0])}
        else:
            out["tree_structure"] = self._node_json(0)
        return out

    def _node_json(self, index: int) -> dict:
        if index < 0:
            leaf = ~index
            return {"leaf_index": leaf,
                    "leaf_value": float(self.leaf_value[leaf]),
                    "leaf_weight": float(self.leaf_weight[leaf]),
                    "leaf_count": int(self.leaf_count[leaf])}
        dt = int(self.decision_type[index])
        node = {"split_index": index,
                "split_feature": int(self.split_feature[index]),
                "split_gain": float(self.split_gain[index]),
                "missing_type": ["None", "Zero", "NaN"][(dt >> 2) & 3],
                "internal_value": float(self.internal_value[index]),
                "internal_weight": float(self.internal_weight[index]),
                "internal_count": int(self.internal_count[index])}
        if dt & kCategoricalMask:
            cats = words_to_bins(self._real_bits(index))
            node["decision_type"] = "=="
            node["threshold"] = "||".join(str(int(c)) for c in cats)
            node["default_left"] = False
        else:
            node["decision_type"] = "<="
            node["threshold"] = float(self.threshold[index])
            node["default_left"] = bool(dt & kDefaultLeftMask)
        node["left_child"] = self._node_json(int(self.left_child[index]))
        node["right_child"] = self._node_json(int(self.right_child[index]))
        return node

    @classmethod
    def from_string(cls, text: str) -> "Tree":
        """Parse a tree block (reference Tree::Tree(const char*, size_t*))."""
        kv: Dict[str, str] = {}
        for line in text.splitlines():
            line = line.strip()
            if not line or "=" not in line:
                continue
            k, v = line.split("=", 1)
            kv[k] = v
        n = int(kv["num_leaves"])
        t = cls(max(n, 1))
        t.num_leaves = n
        t.num_cat = int(kv.get("num_cat", 0))
        if t.num_cat > 0:
            t.cat_boundaries = [int(x) for x in kv["cat_boundaries"].split()]
            t.cat_threshold = [int(x) for x in kv["cat_threshold"].split()]
        t.shrinkage = float(kv.get("shrinkage", 1.0))

        def parse(key, dtype, size):
            if size <= 0 or key not in kv or not kv[key].strip():
                return np.zeros(max(size, 1), dtype=dtype)
            return np.array(kv[key].split(), dtype=np.float64).astype(dtype)

        ni = n - 1
        if ni > 0:
            t.split_feature = parse("split_feature", np.int32, ni)
            t.split_feature_inner = t.split_feature.copy()
            t.split_gain = parse("split_gain", np.float64, ni)
            t.threshold = parse("threshold", np.float64, ni)
            t.threshold_in_bin = np.zeros(ni, dtype=np.int32)
            t.decision_type = parse("decision_type", np.int8, ni)
            t.left_child = parse("left_child", np.int32, ni)
            t.right_child = parse("right_child", np.int32, ni)
            t.internal_value = parse("internal_value", np.float64, ni)
            t.internal_weight = parse("internal_weight", np.float64, ni)
            t.internal_count = parse("internal_count", np.int32, ni)
        t.leaf_value = parse("leaf_value", np.float64, n)[:max(n, 1)]
        if "leaf_weight" in kv:
            t.leaf_weight = parse("leaf_weight", np.float64, n)[:max(n, 1)]
        if "leaf_count" in kv:
            t.leaf_count = parse("leaf_count", np.int32, n)[:max(n, 1)]
        return t


def walk_leaves_plain(bins: torch.Tensor, nodes: torch.Tensor,
                      words: torch.Tensor = None) -> torch.Tensor:
    """The leaf index (int64 [n]) of each row of the [n, G] uint8 bins
    under the node records `nodes` [num_nodes, VW_COLS] int32 (leaf 0 when
    there is no node), by a vectorized walk, one level per step over the
    rows still at an internal node: the JAX package's
    predict_leaf_binned / _decision_inner. A categorical node sends a row
    left when its bin's bit is set in the node's inner words (`words`, the
    int32 word array the records index; bin b is bit b % 32 of word
    b // 32, a word past the node's count is 0)."""
    n = bins.shape[0]
    node = torch.zeros(n, dtype=torch.int64, device=bins.device)
    if nodes.shape[0] == 0:
        return node
    active = torch.arange(n, device=bins.device)
    while active.numel():
        rec = nodes[node[active]]
        col = bins[active, rec[:, VW_G].long()].to(torch.int32)
        lo = rec[:, VW_LO]
        inr = (col >= lo) & (col < rec[:, VW_HI])
        b = torch.where(inr, col - lo, rec[:, VW_MFB])
        dt = rec[:, VW_DT]
        mt = (dt >> 2) & 3
        dflt = ((mt == 1) & (b == rec[:, VW_DB])) | \
            ((mt == 2) & (b == rec[:, VW_NB1]))
        left = torch.where(dflt, (dt & kDefaultLeftMask) != 0,
                           b <= rec[:, VW_THR])
        is_cat = (dt & kCategoricalMask) != 0
        if bool(is_cat.any()):
            wi = b >> 5
            idx = rec[:, VW_THR] + wi
            nw = 0 if words is None else words.numel()
            has = is_cat & (wi < rec[:, VW_NB1]) & (idx < nw)
            word = (words[torch.clamp(idx, 0, max(nw - 1, 0)).long()]
                    .to(torch.int64) & 0xFFFFFFFF if nw
                    else torch.zeros_like(b, dtype=torch.int64))
            bit = ((word >> (b & 31).to(torch.int64)) & 1) > 0
            left = torch.where(is_cat, has & bit, left)
        nxt = torch.where(left, rec[:, VW_LEFT], rec[:, VW_RIGHT]).long()
        node[active] = nxt
        active = active[nxt >= 0]
    return ~node
