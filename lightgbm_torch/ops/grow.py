"""Leaf-wise (best-first) tree growth on a leaf-sorted row payload.

The port of the JAX package's partitioned grower
(lightgbm_tpu/ops/grow.py:_grow_tree_partitioned_jit:1352-1740), the
reference's SerialTreeLearner::Train (src/treelearner/
serial_tree_learner.cpp:149-196): repeat {pick the leaf with the best
cached split -> partition its rows -> histogram the smaller child -> larger
child = parent - smaller -> scan both children} until num_leaves - 1
splits or no positive gain.

The JAX grower is one jitted ``lax.while_loop``; here the loop is Python on
the host, driving the device:

  * the row payload (bins ``[N, G]`` uint8, grad, hess, original row id)
    is kept leaf-sorted, so every leaf is a contiguous segment (the
    OrderedBin/DataPartition analog). A split stably partitions its
    segment (left rows first, each side in its old order) with
    ``torch.nonzero`` + gathers;
  * the smaller child's histogram comes from the ``hist_window`` kernel
    over its segment, and the larger child is the parent minus it
    (``smaller_is_left = left_count <= right_count`` from the candidate's
    hessian-recovered counts, as grow.py:1518 decides before the
    partition);
  * both children are scanned by one ``scan_pair`` launch (B = 2), which
    reads their rows of the [L, TB] grad and hess planes through the
    layout's index map itself; the root by one launch at B = 1 (the JAX
    grower scans the root with the general XLA scan, which gives the same
    split on the fast path);
  * the cross-feature argmax and the candidate assembly
    (grow.py:541-702) run on the host in numpy float32 on the kernel's
    small ``[B, 8, Fp]`` output, so leaf selection needs no device work.

The JAX package routes data below 65536 rows to its masked grower; the port
routes every size here. Both give the same trees up to f32 summation order
(grow.py:1363). f32 sums, no forced splits (the tree learner refuses
them).

Bagging and GOSS: the caller multiplies the gradients by the bag's weights
and hands the bag mask over; the out-of-bag rows stay in the payload with
zero gradients, and the counts are of rows in the bag, as the JAX grower
carries the bag bit with the row id (grow.py:1386-1436, 1578-1599): the
root's count is the bag's, a split's left count the in-bag rows that go
left, its right count the parent's less that.

Categorical features (:class:`CatScan`) are kept out of scan_pair's feature
mask (pallas_scan.py:646) and scanned by one ``cat_scan`` launch per
evaluation beside it (ops/cat_scan.py: the JAX package's
find_best_split_categorical); the host merges the two candidates of each
node in numpy f32 as merge_candidates does (the higher gain; on equal gain
the smaller feature id), and a categorical split partitions by its left-bin
mask (grow.py:_go_left_decision).

The split scan's numerical knobs (:class:`Knobs`: ``lambda_l1``,
``max_delta_step``, monotone constraints, ``extra_trees``,
``feature_fraction_bynode``) run here, where the JAX package runs them (its
general XLA scan on this grower, grow.py:1352): the scans take scan_pair's
knob form, the leaf outputs take L1, the clamp and the leaf's monotone
bounds, which each split hands down to its children (grow.py:1666-1689),
and each scanned node draws its extra_trees thresholds and by-node feature
sample on the host from its own key, as the JAX grower derives them from
the tree's key (grow.py:842-853: the root folds in 0, split s's children
2s and 2s + 1; utils/random.py draws jax.random's bits).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..data.dataset import DeviceData
from ..utils import random as tf
from .cat_scan import CatLayout, cat_candidates, cat_scalars, cat_scan
from .histogram import hist_window
from .scan import ScanLayout, knob_scalars, pair_scalars, scan_pair
from .split import (K_EPSILON, K_MIN_SCORE, MISSING_NAN, MISSING_ZERO,
                    FeatureMeta, SplitCandidate, SplitParams, fix_histogram,
                    leaf_output, leaf_output_unconstrained, mono_bounds)

F32 = np.float32


class GrowConfig(NamedTuple):
    """Static shape of a grower run."""
    num_leaves: int
    total_bins: int
    num_features: int
    scan_width: int     # widest feature: the scan's W
    hist_width: int     # widest group: the histogram kernel's W
    max_depth: int      # <= 0: unlimited


class Knobs(NamedTuple):
    """The numerical knobs of one tree's scans (the JAX package's
    GrowConfig use_mc/extra_trees/bynode_k and the tree's key; lambda_l1
    and max_delta_step ride in SplitParams). The grower takes the fast
    form without them."""
    monotone: np.ndarray        # [F] int constraint of each feature
    use_mc: bool                # any feature constrained
    extra_trees: bool
    bynode_k: int               # > 0: features per node's sample
    key: np.ndarray             # [2] uint32: the tree's key


class CatScan(NamedTuple):
    """The categorical features of a run: their layout and the cat_scan
    parameter block on the grower's device (ops/cat_scan.py)."""
    layout: CatLayout
    par: torch.Tensor


class TreeArrays(NamedTuple):
    """Split records + leaf state of one tree (numpy), as the JAX grower's
    TreeArrays: everything the host needs to build a Tree."""
    num_leaves: int
    split_leaf: np.ndarray      # [L-1] i32 leaf index that was split
    split_feature: np.ndarray   # [L-1] i32 inner feature index
    threshold: np.ndarray       # [L-1] i32 local bin threshold
    default_left: np.ndarray    # [L-1] bool
    gain: np.ndarray            # [L-1] f32
    internal_value: np.ndarray  # [L-1] f32 parent leaf output at split time
    internal_count: np.ndarray  # [L-1] i32
    leaf_value: np.ndarray      # [L] f32
    leaf_count: np.ndarray      # [L] i32
    leaf_weight: np.ndarray     # [L] f32 (sum of hessians)
    is_cat: np.ndarray = None   # [L-1] bool categorical split
    cat_words: np.ndarray = None  # [L-1, 8] uint32 its left-bin mask


def tb_source_index(group_offset, total_bins: int, hist_width: int, device):
    """[TB] index into a flattened [G * W] histogram: global bin -> (group,
    group-local bin), the inverse of the JAX grower's gw_global map."""
    offs = np.asarray(group_offset, np.int64)
    widths = np.diff(np.append(offs, total_bins))
    src = np.concatenate([g * hist_width + np.arange(widths[g])
                          for g in range(len(offs))]) if len(offs) else \
        np.zeros(0, np.int64)
    return torch.as_tensor(src, device=device)


def _empty_arrays(L: int) -> dict:
    return dict(
        split_leaf=np.zeros(L - 1, np.int32),
        split_feature=np.full(L - 1, -1, np.int32),
        threshold=np.zeros(L - 1, np.int32),
        default_left=np.zeros(L - 1, bool),
        gain=np.zeros(L - 1, F32),
        internal_value=np.zeros(L - 1, F32),
        internal_count=np.zeros(L - 1, np.int32),
        leaf_value=np.zeros(L, F32),
        leaf_count=np.zeros(L, np.int32),
        leaf_weight=np.zeros(L, F32))


def assemble(gain, feature, threshold, use_f, lg, lh, lc, forced_right,
             scal: np.ndarray, lambda_l2, depths, max_depth: int,
             knobs=None):
    """SplitCandidates of B children from each child's best split (per-child
    arrays: penalized gain, feature, local threshold, direction, the left
    side's grad/hess/count, forced_right of the feature): the scalar
    assembly of grow.py:650-683 (grow_persist.py:1087-1106), in numpy
    float32. A child at max_depth gets no split. ``knobs`` = (SplitParams,
    cmins, cmaxs, use_mc): the leaf outputs with L1, max_delta_step and
    each child's monotone clamp (lightgbm_tpu/ops/split.py:386-391)."""
    l2 = F32(lambda_l2)
    depths = np.broadcast_to(np.asarray(depths), (len(gain),))
    cands = []
    for b in range(len(gain)):
        gain_b = gain[b]
        valid = bool(np.isfinite(gain_b))
        if max_depth > 0:
            valid &= int(depths[b]) < max_depth
        sg, sh, cnt = scal[b, 0], scal[b, 1], scal[b, 2]
        rg, rh, rc = sg - lg[b], sh - lh[b], cnt - lc[b]
        # an unsplittable child's outputs may divide by zero; they are
        # never used (its gain is -inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            if knobs is None:
                lo = leaf_output_unconstrained(lg[b], lh[b], l2)
                ro = leaf_output_unconstrained(rg, rh, l2)
            else:
                p, cmins, cmaxs, use_mc = knobs
                lo, ro = (F32(leaf_output(
                    g_, h_, l2, F32(p.lambda_l1), F32(p.max_delta_step),
                    cmins[b], cmaxs[b], p.use_l1, p.use_mds, use_mc))
                    for g_, h_ in ((lg[b], lh[b]), (rg, rh)))
        cands.append(SplitCandidate(
            gain=gain_b if valid else F32(K_MIN_SCORE),
            feature=int(feature[b]) if valid else -1,
            threshold=int(threshold[b]) if valid else 0,
            default_left=(not use_f[b] and not bool(forced_right[b]))
            if valid else True,
            left_output=lo, right_output=ro,
            left_sum_grad=lg[b], left_sum_hess=lh[b],
            right_sum_grad=rg, right_sum_hess=rh,
            left_count=int(np.floor(lc[b] + F32(0.5))),
            right_count=int(np.floor(rc + F32(0.5)))))
    return cands


def node_draws(knobs: Knobs, tags, feature_mask: np.ndarray, feat_nb,
               Fp: int) -> np.ndarray:
    """scan_pair's ``node`` input [B, 2, Fp] f32 of B nodes, node b's draws
    from the key ``fold_in(tree key, tags[b])`` (the JAX eval_leaf's,
    grow.py:455-469): row 0 each feature's extra_trees threshold (-1: any),
    row 1 the by-node sample (1: in)."""
    F = len(feature_mask)
    node = np.zeros((len(tags), 2, Fp), np.float32)
    node[:, 0] = -1.0
    node[:, 1, :F] = 1.0
    if not knobs.extra_trees and knobs.bynode_k <= 0:
        return node
    for b, tag in enumerate(tags):
        key = tf.fold_in(knobs.key, tag)
        if knobs.bynode_k > 0:
            node[b, 1, :F] = tf.bynode_mask(key, feature_mask,
                                            knobs.bynode_k)
        if knobs.extra_trees:
            node[b, 0, :F] = tf.extra_trees_bins(key, feat_nb)
    return node


def scan_children(gh: torch.Tensor, hh: torch.Tensor, rows,
                  layout: ScanLayout, params: SplitParams, sgs, shs, cnts,
                  depths, max_depth: int, knobs: Knobs = None, cmins=None,
                  cmaxs=None, node=None, cat: CatScan = None,
                  cat_fmask=None, pair: bool = False):
    """SplitCandidates of B children from their rows of the [R, TB]
    grad/hess histogram planes: one scan_pair launch, which reads the
    children's planes through ``rows`` and ``layout.gidx`` itself, then the
    cross-feature argmax (first maximum = smallest feature id) and the host
    assembly. `depths` is each child's depth, or one depth for all. With
    ``knobs``, the knob form with each child's monotone bounds (cmins,
    cmaxs) and its ``node`` draws (:func:`node_draws`). With ``cat``, one
    cat_scan launch over the categorical features that ``cat_fmask``
    ([B, C] bool) leaves each node, merged into the candidates; ``pair``
    marks the fast form's children, whose categorical scan sees the hessian
    sums with kEpsilon added twice, as the JAX pair path hands them over
    (grow.py:607, split.py:583)."""
    dev = gh.device
    if knobs is None:
        scal = pair_scalars(sgs, shs, cnts, params.lambda_l2,
                            params.min_gain_to_split, params.min_data_in_leaf,
                            params.min_sum_hessian_in_leaf)
        extra = {}
    else:
        scal = knob_scalars(sgs, shs, cnts, params, cmins, cmaxs,
                            knobs.use_mc)
        extra = {"node": torch.as_tensor(node, device=dev)}
    rows_d = torch.as_tensor(np.asarray(rows, np.int64), device=dev)
    out = scan_pair(torch.as_tensor(scal, device=dev), gh, hh,
                    layout.keep_r, layout.keep_f, layout.valid_r,
                    layout.valid_f, layout.aux, rows=rows_d,
                    gidx=layout.gidx, **extra)
    if cat is not None:
        # queued behind scan_pair, so the two outputs come back with one
        # wait
        use_mc = knobs is not None and knobs.use_mc
        sh_adj = scal[:, 1] + F32(2 * K_EPSILON) if pair else scal[:, 1]
        B = len(scal)
        cs = cat_scalars(scal[:, 0], sh_adj, cnts, params,
                         cmins if use_mc else np.full(B, -np.inf, F32),
                         cmaxs if use_mc else np.full(B, np.inf, F32))
        rec = cat_scan(torch.as_tensor(cs, device=dev), gh, hh, rows_d,
                       cat.layout,
                       torch.as_tensor(np.ascontiguousarray(cat_fmask, F32),
                                       device=dev), cat.par)
    out = out.cpu().numpy()
    bf = np.argmax(out[:, 0], axis=1)
    best = out[np.arange(len(bf)), :, bf]                        # [B, 8]
    cands = assemble(best[:, 0], bf, best[:, 1], best[:, 2] > 0.5,
                     best[:, 3], best[:, 4], best[:, 5],
                     layout.forced_right[bf], scal, params.lambda_l2, depths,
                     max_depth, None if knobs is None
                     else (params, cmins, cmaxs, knobs.use_mc))
    if cat is None:
        return cands
    rec = rec.cpu().numpy()
    depths = np.broadcast_to(np.asarray(depths), (B,))
    for b, cc in enumerate(cat_candidates(rec, cat.layout, cs, params,
                                          use_mc)):
        if max_depth > 0 and int(depths[b]) >= max_depth:
            continue                    # no split at max_depth
        a = cands[b]
        if cc["gain"] > a.gain or (cc["gain"] == a.gain and cc["feature"] >= 0
                                   and (a.feature < 0
                                        or cc["feature"] < a.feature)):
            cands[b] = SplitCandidate(threshold=0, default_left=False,
                                      is_cat=True, **cc)
    return cands


def grow_tree_partitioned(data: DeviceData, grad: torch.Tensor,
                          hess: torch.Tensor, meta: FeatureMeta,
                          params: SplitParams, feature_mask: np.ndarray,
                          gc: GrowConfig, tb_src: torch.Tensor,
                          knobs: Knobs = None, cat: CatScan = None,
                          bag: torch.Tensor = None):
    """Grow one tree. grad/hess: [N] tensors on the data's device, zero
    outside the bag; `bag`: the [N] bool bag mask (None: every row is in
    the bag). With ``knobs``, the scans' knob form; with ``cat``, the
    categorical scan beside the numerical one. Returns (TreeArrays,
    row_leaf [N] int32 tensor in original row order)."""
    device = data.bins.device
    n, G = data.bins.shape
    L, TB, F, W = gc.num_leaves, gc.total_bins, gc.num_features, gc.hist_width
    l2 = F32(params.lambda_l2)
    arr = _empty_arrays(L)
    arr["is_cat"] = np.zeros(L - 1, bool)
    arr["cat_words"] = np.zeros((L - 1, 8), np.uint32)
    grad = grad.to(torch.float32).contiguous()
    hess = hess.to(torch.float32).contiguous()
    # f64 sums rounded to f32: the same value on every device
    sum_grad = F32(grad.double().sum().item())
    sum_hess = F32(hess.double().sum().item())
    n_root = n if bag is None else int(bag.sum())
    if knobs is None:
        root_out = leaf_output_unconstrained(sum_grad, sum_hess, l2)
    else:       # grow.py:1461-1463: L1 and the clamp, no monotone bounds
        root_out = F32(leaf_output_unconstrained(
            sum_grad, sum_hess, l2, F32(params.lambda_l1),
            F32(params.max_delta_step), True, True))
    if F == 0 or TB == 0:
        arr["leaf_value"][0] = root_out
        arr["leaf_count"][0] = n_root
        arr["leaf_weight"][0] = sum_hess
        return (TreeArrays(num_leaves=1, **arr),
                torch.zeros(n, dtype=torch.int32, device=device))

    # ---- leaf-sorted payload (a fresh copy per tree) ----------------------
    binsP = data.bins.clone()
    gradP = grad.clone()
    hessP = hess.clone()
    ridP = torch.arange(n, device=device)
    bagP = None if bag is None else bag.to(torch.int64).clone()

    def hist_tb(start: int, length: int) -> torch.Tensor:
        h = hist_window(binsP, gradP, hessP, start, length, W)   # [G, W, 2]
        return h.reshape(G * W, 2)[tb_src]                        # [TB, 2]

    def partition(s0: int, n_l: int, cand: SplitCandidate) -> int:
        """Stable in-place partition of segment [s0, s0 + n_l) by the
        DenseBin::Split decision (dense_bin.hpp:112, _go_left_decision):
        the missing NaN bin / zero bin go the default direction, every
        other bin compares local_bin <= threshold; a categorical split
        sends the bins of its mask left. Returns n_left."""
        f = cand.feature
        g = int(meta.group_of[f])
        start, end = int(meta.bin_start[f]), int(meta.bin_end[f])
        seg = slice(s0, s0 + n_l)
        col = binsP[seg, g].to(torch.int32) + int(meta.group_offset[g])
        in_range = (col >= start) & (col < end)
        b = torch.where(in_range, col - start, int(meta.most_freq_bin[f]))
        mt = int(meta.missing_type[f])
        if cand.is_cat:
            # the left-bin mask: bit b of word b // 32 (b < 256 always)
            words = torch.as_tensor(cand.cat_words.astype(np.int64),
                                    device=device)
            go_left = ((words[b >> 5] >> (b & 31)) & 1) > 0
        else:
            go_left = b <= cand.threshold
            if mt == MISSING_NAN:
                go_left = torch.where(b == end - start - 1,
                                      cand.default_left, go_left)
            elif mt == MISSING_ZERO:
                go_left = torch.where(b == int(meta.default_bin[f]),
                                      cand.default_left, go_left)
        left = torch.nonzero(go_left).squeeze(1)
        order = torch.cat([left, torch.nonzero(~go_left).squeeze(1)])
        binsP[seg] = binsP[seg][order]
        gradP[seg] = gradP[seg][order]
        hessP[seg] = hessP[seg][order]
        ridP[seg] = ridP[seg][order]
        if bagP is not None:
            bagP[seg] = bagP[seg][order]
        return int(left.numel())

    # ---- root ---------------------------------------------------------------
    root_hist = fix_histogram(hist_tb(0, n), sum_grad, sum_hess, *meta.fix)
    num_mask = np.asarray(feature_mask, bool)
    if cat is not None:         # categoricals scan in cat_scan only
        num_mask = num_mask.copy()
        num_mask[cat.layout.feature] = False
    layout = ScanLayout(meta.bin_start, meta.bin_end, meta.missing_type,
                        meta.default_bin, meta.penalty, num_mask,
                        gc.scan_width, TB, device,
                        None if knobs is None else knobs.monotone)
    feat_nb = np.asarray(meta.bin_end) - np.asarray(meta.bin_start)
    # each leaf's monotone bounds (the knob form's; grow.py:1487)
    leaf_cmin = np.full(L, -np.inf, F32)
    leaf_cmax = np.full(L, np.inf, F32)
    # grad and hess planes [2, L, TB]: each is an [L, TB] matrix that the
    # scan reads through the leaves' rows
    leaf_hist = torch.zeros((2, L, TB), dtype=torch.float32, device=device)
    leaf_hist[:, 0] = root_hist.t()

    def evaluate(leaves, sgs, shs, cnts, depth_child, tags, pair):
        """Candidates of the leaves; `tags` fold each node's key out of
        the tree's (knob form only); `pair`: a split's two children."""
        node = None if knobs is None else node_draws(
            knobs, tags, feature_mask, feat_nb, layout.Fp)
        cat_fmask = None
        if cat is not None:     # the tree's mask and each node's sample
            cf = cat.layout.feature
            cat_fmask = np.broadcast_to(np.asarray(feature_mask, bool)[cf],
                                        (len(leaves), len(cf)))
            if node is not None:
                cat_fmask = cat_fmask & (node[:, 1, cf] > 0)
        return scan_children(leaf_hist[0], leaf_hist[1], leaves, layout,
                             params, sgs, shs, cnts, depth_child,
                             gc.max_depth, knobs, leaf_cmin[leaves],
                             leaf_cmax[leaves], node, cat, cat_fmask,
                             pair and knobs is None)

    best = [SplitCandidate.none() for _ in range(L)]
    best_gain = np.full(L, K_MIN_SCORE, F32)
    best[0] = evaluate([0], [sum_grad], [sum_hess], [n_root], 0, [0],
                       False)[0]
    best_gain[0] = best[0].gain
    leaf_start = np.zeros(L, np.int64)
    leaf_nrows = np.zeros(L, np.int64)
    leaf_nrows[0] = n
    leaf_depth = np.zeros(L, np.int32)
    arr["leaf_count"][0] = n_root
    arr["leaf_value"][0] = root_out
    arr["leaf_weight"][0] = sum_hess

    s = 1
    while s < L:
        l = int(np.argmax(best_gain))
        cand = best[l]
        if not cand.gain > 0.0:
            break
        s0, n_l = int(leaf_start[l]), int(leaf_nrows[l])
        smaller_is_left = cand.left_count <= cand.right_count
        n_left = partition(s0, n_l, cand)
        n_right = n_l - n_left
        left_cnt = (n_left if bagP is None      # the in-bag rows going left
                    else int(bagP[s0:s0 + n_left].sum()))
        right_cnt = int(arr["leaf_count"][l]) - left_cnt

        if smaller_is_left:
            small = hist_tb(s0, n_left)
            sm_g, sm_h = cand.left_sum_grad, cand.left_sum_hess
        else:
            small = hist_tb(s0 + n_left, n_right)
            sm_g, sm_h = cand.right_sum_grad, cand.right_sum_hess
        small = fix_histogram(small, sm_g, sm_h, *meta.fix).t()  # [2, TB]
        larger = leaf_hist[:, l] - small
        leaf_hist[:, l] = small if smaller_is_left else larger
        leaf_hist[:, s] = larger if smaller_is_left else small

        k = s - 1
        arr["split_leaf"][k] = l
        arr["split_feature"][k] = cand.feature
        arr["threshold"][k] = cand.threshold
        arr["default_left"][k] = cand.default_left
        arr["gain"][k] = cand.gain
        if cand.is_cat:
            arr["is_cat"][k] = True
            arr["cat_words"][k] = cand.cat_words
        arr["internal_value"][k] = arr["leaf_value"][l]
        arr["internal_count"][k] = arr["leaf_count"][l]

        depth_child = int(leaf_depth[l]) + 1
        if knobs is not None:
            leaf_cmin[l], leaf_cmax[l], leaf_cmin[s], leaf_cmax[s] = \
                mono_bounds(leaf_cmin[l], leaf_cmax[l],
                            int(knobs.monotone[cand.feature]),
                            cand.left_output, cand.right_output)
        for leaf, sh_, cnt_, val_, st_, nr_ in (
                (l, cand.left_sum_hess, left_cnt, cand.left_output, s0,
                 n_left),
                (s, cand.right_sum_hess, right_cnt, cand.right_output,
                 s0 + n_left, n_right)):
            arr["leaf_weight"][leaf] = sh_
            arr["leaf_count"][leaf] = cnt_
            arr["leaf_value"][leaf] = val_
            leaf_depth[leaf] = depth_child
            leaf_start[leaf], leaf_nrows[leaf] = st_, nr_

        cand_l, cand_r = evaluate(
            [l, s], [cand.left_sum_grad, cand.right_sum_grad],
            [cand.left_sum_hess, cand.right_sum_hess],
            [left_cnt, right_cnt], depth_child, [2 * s, 2 * s + 1], True)
        best[l], best[s] = cand_l, cand_r
        best_gain[l], best_gain[s] = cand_l.gain, cand_r.gain
        s += 1

    # per-row leaf ids in original row order, through the carried row ids
    order = np.argsort(leaf_start[:s], kind="stable")
    pos_leaf = torch.repeat_interleave(
        torch.as_tensor(order.astype(np.int32), device=device),
        torch.as_tensor(leaf_nrows[:s][order], device=device))
    row_leaf = torch.empty(n, dtype=torch.int32, device=device)
    row_leaf[ridP] = pos_leaf
    return TreeArrays(num_leaves=s, **arr), row_leaf
