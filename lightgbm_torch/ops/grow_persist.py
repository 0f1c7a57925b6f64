"""The persistent-payload tree grower: the port's fast path for boosting.

The port of the per-split part of lightgbm_tpu/ops/grow_persist.py:
make_persist_grower (:647-2060): the binned rows, label, row id, gradient,
hessian and score of every training row live in ONE int32 payload matrix
(ops/payload.py) that stays leaf-partitioned from tree to tree, so no
per-row gather or scatter runs between iterations:

  * the root: one ``root_hist`` launch (histogram + grad/hess totals) and
    one ``scan_pair`` launch (the root's best split);
  * per split: one ``split_pass`` launch partitions the leaf's segment
    into the other payload buffer (below) and returns the exact n_left; the
    smaller child's histogram comes from ``seg_hist`` over its segment
    (G > SEG_HIST_MIN_GROUPS) or from ``split_pass`` itself
    (G <= SEG_HIST_MIN_GROUPS); the larger child is the parent minus it; one
    ``scan_pair`` launch scans both children;
  * histograms stay in the padded [G * 256] group-plane layout end to end;
    feature f's window sits at group_of[f] * 256 + ls[f] (``pad_meta`` at
    grow_persist.py:873-882);
  * scores are a payload row: gradients are computed in payload order from
    the label and score rows (:func:`PersistGrower.fill_grad`), a tree's
    outputs are added to its leaves' segments (:meth:`apply_scores`), and
    scores return to row order only when read (:meth:`finalize_scores`).

Two payload buffers. The TPU kernels partition a segment in place; the
port's partition kernels read a segment from one buffer and write both
children to the other at the same lanes, with no scratch and no copy back.
Buffer 0 is the payload itself (the carry); buffer 1 is a second int32
matrix of the payload's ``wp_live`` moving rows and its lane stride,
allocated once per grower (``wp_live * NP * 4`` bytes; rows past
``wp_live`` never move). A leaf at depth d has been partitioned d times,
so its segment lives in buffer d % 2: a split reads buffer depth % 2 and
writes buffer 1 - depth % 2, and the histograms of the children read the
buffer they were written to. At the end of :meth:`PersistGrower.grow` one
``consolidate`` launch copies every odd-depth leaf's segment back into
buffer 0, so the payload is leaf-partitioned exactly as an in-place stable
partition would leave it, and ``apply_scores``, ``fill_grad``,
``finalize_scores`` and the next tree's ``root_hist`` see one payload.

The level phase (make_persist_grower's level program, :1295-1527) runs
first where :func:`can_level_grow` holds (``max_depth`` in [1, 16]): while
the no-bind certificate holds, every positive-gain leaf of the frontier
splits at once, in gain order, with one ``level_pass`` launch (partition,
n_left and, when G <= 20, the smaller children's histograms), one read-back
of the level's n_left, one ``level_seg_hist`` launch when G > 20, one
parent-minus-smaller subtraction for all slots, and one scan of all 2S
children. Slot j's right child is leaf s + j and its split record is
s - 1 + j, so leaves are numbered level by level. Where the certificate
fails (a leaf budget below the depth-limited capacity of the frontier), the
per-split loop above takes the rest of the tree; it grows the same trees by
make_persist_grower's contract (:661-673), and since each partition is
stable and the slots' segments are disjoint, every leaf's payload segment,
histogram and value are the per-split path's, bit for bit.

EFB-bundled data (several features in one group) are scanned with the
bundle-native ``scan_blocks`` over the group planes, FixHistogram inside
the kernel (:1108-1139); the group argmax, the owner map and the window
offset give the feature and its threshold. Unbundled data are scanned with
``scan_pair``, which reads each feature's window of the planes through the
layout's ``gidx``. Both scans read the children's rows of the [L, G * 256]
planes themselves: no gather or pad runs before a scan.

The host loop is Python over numpy leaf state, as in ops/grow.py; leaf
counts are the kernel's exact n_left (``stat_from_scan=False``) and stay
integers on the host. Not ported here: sharding, voting, quantization,
bagging and the health vector.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .block_scan import BlockScanLayout, scan_blocks
from .grow import TreeArrays, _empty_arrays, assemble, scan_children
from .payload import PersistAssets, payload_weight_row
from .payload_kernels import (HIST_W, N_SCALARS, S_DB, S_DL, S_LE, S_LS,
                              S_MASK, S_MF, S_MT, S_NB, S_NCH, S_NL, S_S0,
                              S_SH, S_SMALL_L, S_THR, S_WG, consolidate,
                              level_children, level_pass, level_seg_hist,
                              plan_tensor, root_hist, seg_hist, split_pass)
from .scan import ScanLayout, pair_scalars
from .split import K_MIN_SCORE, SplitCandidate, leaf_output_unconstrained
from ..utils.log import LightGBMError

F32 = np.float32

# group count at or below which the smaller child's histogram comes out of
# split_pass instead of a separate seg_hist launch (grow_persist.py:123)
SEG_HIST_MIN_GROUPS = 20

# deepest max_depth the level phase takes on (grow_persist.py:94)
LEVEL_MAX_DEPTH = 16


def can_level_grow(gc) -> bool:
    """The static gate of the level phase (grow_persist.py:97-113) for the
    port's configurations (no voting, no forced splits): a finite
    max_depth to size the level's slots, and trees of at least 4 leaves."""
    return 1 <= int(gc.max_depth) <= LEVEL_MAX_DEPTH \
        and int(gc.num_leaves) >= 4


def level_buffers(bufs, depths):
    """(src, dst) of a level program whose slots are at `depths`: the
    buffer of their depth's parity and the other one. Every slot of a level
    program has one depth (the no-bind certificate admits every
    positive-gain leaf of the frontier, and a leaf that is not split never
    gains again); a mixed table raises rather than choosing a buffer per
    slot."""
    depths = np.asarray(depths)
    if len(depths) == 0 or np.any(depths != depths[0]):
        raise LightGBMError("level program: slots at depths %s; all slots "
                            "of a level must share one depth (one source "
                            "buffer)" % sorted(set(depths.tolist())))
    p = int(depths[0]) % 2
    return bufs[p], bufs[1 - p]


class LeafState(NamedTuple):
    """Per-leaf state of one grown tree (numpy): the leaves' statistics and
    their payload segments [start, start + nrows)."""
    sum_hess: np.ndarray    # [L] f32 (the leaf weight)
    count: np.ndarray       # [L] i64 exact row counts
    value: np.ndarray       # [L] f32 leaf output
    depth: np.ndarray       # [L] i32
    start: np.ndarray       # [L] i64 payload lane of the segment
    nrows: np.ndarray       # [L] i64


class PersistGrower:
    """grow / apply_scores / fill_grad / init_carry / finalize_scores over
    one dataset's payload, for one grow configuration, on one device.
    ``level_mode`` "auto" runs the level phase where :func:`can_level_grow`
    holds, "off" never. ``grow_stats`` holds (level programs, splits of the
    per-split loop after them) of every tree grown, as the JAX stats vector
    does (:77-89)."""

    def __init__(self, assets: PersistAssets, meta, gc, params, device,
                 level_mode: str = "auto"):
        G, plan, nbw, n, C = assets.geometry[2:7]
        K, has_w = assets.geometry[8], bool(assets.geometry[9])
        self.assets = assets
        self.meta = meta
        self.gc = gc
        self.params = params
        self.device = torch.device(device)
        self.n, self.nbw, self.G, self.C = n, nbw, G, C
        self.wp_live = payload_weight_row(nbw, K) + (1 if has_w else 0)
        self.weight_row = payload_weight_row(nbw, K) if has_w else None
        self.score_row = nbw + 4
        self.inpass_hist = G <= SEG_HIST_MIN_GROUPS
        self.plan = plan_tensor(plan, self.device)
        group_of, ls, nb = assets.efb[0], assets.efb[1], assets.efb[2]
        self.win_start = (group_of.astype(np.int64) * HIST_W + ls)
        self.win_end = self.win_start + nb
        self.blocks = (BlockScanLayout(assets.efb, meta.penalty, G,
                                       self.device)
                       if assets.efb[5] else None)
        self.use_level = level_mode != "off" and can_level_grow(gc)
        # the widest frontier a depth-bounded tree presents (:789-791)
        self.s_maxl = min(1 << max(int(gc.max_depth) - 1, 0),
                          gc.num_leaves - 1)
        self.grow_stats = []
        # buffer 1 of the depth-parity partition: the wp_live moving rows
        # at the payload's lane stride
        self.second = torch.zeros((self.wp_live, assets.geometry[1]),
                                  dtype=torch.int32, device=self.device)

    # ---- payload <-> row order ---------------------------------------------
    def _f32_row(self, pay, r):
        return pay[r].view(torch.float32)

    def init_carry(self, score0_row) -> torch.Tensor:
        """A fresh payload on the device from the pristine ``pay0`` and a
        row-ordered score vector ([n], any float dtype; stored as f32)."""
        pay = torch.as_tensor(self.assets.pay0.view(np.int32),
                              device=self.device).clone()
        sc = torch.as_tensor(score0_row, device=self.device) \
            .to(torch.float32).reshape(-1)
        self._f32_row(pay, self.score_row)[:self.n] = sc
        return pay

    def finalize_scores(self, pay) -> torch.Tensor:
        """[n] f64 scores in row order, scattered through the row-id row
        (the f32 payload scores, widened)."""
        rid = pay[self.nbw + 1, :self.n].to(torch.int64)
        out = torch.empty(self.n, dtype=torch.float64, device=pay.device)
        out[rid] = self._f32_row(pay, self.score_row)[:self.n].double()
        return out

    def fill_grad(self, pay, payload_grad_fn) -> None:
        """Write the objective's gradients, computed in payload order from
        the f32 label and score rows, into the grad/hess rows (in place;
        grow_persist.py:1917-1925). Sample weights multiply after the
        objective, as in the reference's weighted objectives; padding
        lanes get zeros."""
        n = self.n
        label = self._f32_row(pay, self.nbw)[:n]
        score = self._f32_row(pay, self.score_row)[:n]
        g, h = payload_grad_fn(score, label)
        if self.weight_row is not None:
            w = self._f32_row(pay, self.weight_row)[:n]
            g, h = g * w, h * w
        gh = pay[self.nbw + 2:self.nbw + 4].view(torch.float32)
        gh.zero_()
        gh[0, :n] = g
        gh[1, :n] = h

    def apply_scores(self, pay, lstate: LeafState, num_leaves: int,
                     shrink: float) -> None:
        """score += f32(leaf_value * shrink) on every leaf's segment, one
        direct f32 add per row (in place). The JAX f32 path adds segment
        deltas through a cumsum (grow_persist.py:1761-1773), which rounds
        differently; the direct add is what the update means, and what
        the JAX widened mode does (:1743-1760)."""
        if num_leaves <= 1:
            return
        order = np.argsort(lstate.start[:num_leaves], kind="stable")
        vals = (lstate.value[:num_leaves] * F32(shrink)).astype(F32)[order]
        lane_val = torch.repeat_interleave(
            torch.as_tensor(vals, device=pay.device),
            torch.as_tensor(lstate.nrows[:num_leaves][order],
                            device=pay.device))
        score = self._f32_row(pay, self.score_row)[:self.n]
        score += lane_val

    # ---- one tree ------------------------------------------------------------
    def _scalars(self, cand: SplitCandidate, s0: int, n_l: int,
                 smaller_is_left: bool):
        """The N_SCALARS slots of one split (grow_persist.py:1546-1562)."""
        a, f = self.assets, cand.feature
        scal = [0] * N_SCALARS
        scal[S_NCH] = (n_l + self.C - 1) // self.C
        scal[S_S0], scal[S_NL] = s0, n_l
        scal[S_WG] = int(a.dec_word[f])
        scal[S_SH] = int(a.dec_shift[f])
        scal[S_MASK] = int(a.dec_mask[f])
        scal[S_NB], scal[S_MT], scal[S_DB] = (int(a.nb[f]), int(a.mt[f]),
                                              int(a.db[f]))
        scal[S_THR] = cand.threshold
        scal[S_DL] = int(cand.default_left)
        scal[S_SMALL_L] = int(smaller_is_left)
        scal[S_LS], scal[S_LE], scal[S_MF] = (int(a.ls[f]), int(a.le[f]),
                                              int(a.mf[f]))
        return scal

    def _scan_blocks(self, gh, hh, rows, masks, sgs, shs, cnts, depths):
        """SplitCandidates of B children from their rows of the [L, G * 256]
        planes through scan_blocks, which reads them in place
        (grow_persist.py:1108-1139): the group argmax (first maximum), the
        feature from the owner map, the threshold t_abs - ls[f]."""
        params, blk = self.params, self.blocks
        B = len(rows)
        scal = pair_scalars(sgs, shs, cnts, params.lambda_l2,
                            params.min_gain_to_split,
                            params.min_data_in_leaf,
                            params.min_sum_hessian_in_leaf)
        scal9 = np.concatenate([scal, np.asarray(shs, F32)[:, None]], axis=1)
        dev = gh.device
        out = scan_blocks(torch.as_tensor(scal9, device=dev), gh, hh, masks,
                          blk.do_fix,
                          torch.as_tensor(np.asarray(rows, np.int64),
                                          device=dev), self.G).cpu().numpy()
        bg = np.argmax(out[:, 0], axis=1)
        best = out[np.arange(B), :, bg]                          # [B, 8]
        t_abs = best[:, 1]
        f = blk.owner[bg, np.clip(t_abs, 0, blk.Wp - 1).astype(np.int64)]
        return assemble(best[:, 0], f, t_abs - blk.ls[f], best[:, 2] > 0.5,
                        best[:, 3], best[:, 4], best[:, 5],
                        blk.forced_right[f], scal, params.lambda_l2, depths,
                        self.gc.max_depth)

    def grow(self, pay, feature_mask):
        """Grow one tree on the payload. The splits move segments between
        the payload and the second buffer by depth parity; the last step
        brings the odd-depth leaves back, so the payload ends partitioned
        by leaf. Returns (LeafState, split records as a dict of [L-1]
        arrays, num_leaves)."""
        gc, params, meta = self.gc, self.params, self.meta
        L, n, G, nbw = gc.num_leaves, self.n, self.G, self.nbw
        md = int(gc.max_depth)
        dev = pay.device
        bufs = (pay, self.second)
        l2 = F32(params.lambda_l2)
        tree = {k: v for k, v in _empty_arrays(L).items()
                if not k.startswith("leaf_")}             # split records
        gh0, hh0, sums = root_hist(pay, self.plan, nbw, n)
        sum_grad, sum_hess = (F32(v) for v in sums.cpu().numpy())
        root_out = leaf_output_unconstrained(sum_grad, sum_hess, l2)
        TBp = G * HIST_W
        gh = torch.zeros((L, TBp), dtype=torch.float32, device=dev)
        hh = torch.zeros((L, TBp), dtype=torch.float32, device=dev)
        gh[0], hh[0] = gh0, hh0
        if self.blocks is not None:
            masks = self.blocks.tree_masks(feature_mask)

            def evaluate(leaves, sgs, shs, cnts, depths):
                return self._scan_blocks(gh, hh, leaves, masks, sgs, shs,
                                         cnts, depths)
        else:
            layout = ScanLayout(self.win_start, self.win_end,
                                meta.missing_type, meta.default_bin,
                                meta.penalty, feature_mask, gc.scan_width,
                                TBp, dev)

            def evaluate(leaves, sgs, shs, cnts, depths):
                return scan_children(gh, hh, leaves, layout, params, sgs,
                                     shs, cnts, depths, md)

        st = LeafState(sum_hess=np.zeros(L, F32),
                       count=np.zeros(L, np.int64), value=np.zeros(L, F32),
                       depth=np.zeros(L, np.int32),
                       start=np.zeros(L, np.int64),
                       nrows=np.zeros(L, np.int64))
        st.sum_hess[0] = sum_hess
        st.count[0], st.value[0], st.nrows[0] = n, root_out, n
        best = [SplitCandidate.none() for _ in range(L)]
        best_gain = np.full(L, K_MIN_SCORE, F32)
        best[0] = evaluate([0], [sum_grad], [sum_hess], [n], 0)[0]
        best_gain[0] = best[0].gain

        def split(l, r, cand, n_left):
            """Record the split of leaf l into l (left) and r (right) and
            the children's state; returns (left count, right count, the
            children's depth)."""
            s0, n_l = int(st.start[l]), int(st.nrows[l])
            k = r - 1
            tree["split_leaf"][k] = l
            tree["split_feature"][k] = cand.feature
            tree["threshold"][k] = cand.threshold
            tree["default_left"][k] = cand.default_left
            tree["gain"][k] = cand.gain
            tree["internal_value"][k] = st.value[l]
            tree["internal_count"][k] = st.count[l]
            left_cnt = n_left
            right_cnt = int(st.count[l]) - left_cnt
            depth = int(st.depth[l]) + 1
            for leaf, sh_, cnt_, val_, st_, nr_ in (
                    (l, cand.left_sum_hess, left_cnt, cand.left_output, s0,
                     n_left),
                    (r, cand.right_sum_hess, right_cnt, cand.right_output,
                     s0 + n_left, n_l - n_left)):
                st.sum_hess[leaf] = sh_
                st.count[leaf], st.value[leaf] = cnt_, val_
                st.depth[leaf] = depth
                st.start[leaf], st.nrows[leaf] = st_, nr_
            return left_cnt, right_cnt, depth

        # ---- the level phase (grow_persist.py:1295-1527) -----------------
        s, levels = 1, 0
        while self.use_level and s < L:
            # the no-bind certificate: the leaf budget covers the
            # depth-limited completion of every positive-gain frontier leaf
            pos = (np.arange(L) < s) & (best_gain > 0)
            cntp = int(pos.sum())
            cap = int(np.sum((1 << np.clip(md - st.depth[pos], 0,
                                           LEVEL_MAX_DEPTH)) - 1))
            if not (0 < cntp <= self.s_maxl and L - s >= cap):
                break
            # gain-ordered admission; exact ties keep the smaller leaf id
            key = np.where(pos, best_gain, F32(K_MIN_SCORE))
            slots = np.argsort(-key, kind="stable")[:cntp]
            cands = [best[l] for l in slots]
            small_l = [c.left_count <= c.right_count for c in cands]
            scal = np.array([self._scalars(c, int(st.start[l]),
                                           int(st.nrows[l]), sl) + [0]
                             for l, c, sl in zip(slots, cands, small_l)],
                            np.int64)
            src, dst = level_buffers(bufs, st.depth[slots])
            n_lefts, small = level_pass(src, dst, scal, self.plan, nbw,
                                        self.wp_live, self.inpass_hist)
            if small is None:
                small = level_seg_hist(dst, self.plan, nbw,
                                       level_children(scal, n_lefts))
            rows = torch.as_tensor(slots, device=dev)
            new = torch.arange(s, s + cntp, device=dev)
            sl_t = torch.as_tensor(small_l, device=dev)[:, None]
            for planes, sm in ((gh, small[0]), (hh, small[1])):
                big = planes[rows] - sm
                planes[new] = torch.where(sl_t, big, sm)
                planes[rows] = torch.where(sl_t, sm, big)
            kids = [split(int(l), s + j, c, int(n_lefts[j]))
                    for j, (l, c) in enumerate(zip(slots, cands))]
            res = evaluate(
                np.concatenate([slots, np.arange(s, s + cntp)]),
                [c.left_sum_grad for c in cands]
                + [c.right_sum_grad for c in cands],
                [c.left_sum_hess for c in cands]
                + [c.right_sum_hess for c in cands],
                [k[0] for k in kids] + [k[1] for k in kids],
                [k[2] for k in kids] * 2)
            for j, l in enumerate(slots):
                best[l], best[s + j] = res[j], res[cntp + j]
                best_gain[l], best_gain[s + j] = res[j].gain, \
                    res[cntp + j].gain
            s += cntp
            levels += 1

        # ---- the per-split loop ------------------------------------------
        s_level = s
        while s < L:
            l = int(np.argmax(best_gain))
            cand = best[l]
            if not cand.gain > 0.0:
                break
            s0, n_l = int(st.start[l]), int(st.nrows[l])
            smaller_is_left = cand.left_count <= cand.right_count
            scal = self._scalars(cand, s0, n_l, smaller_is_left)
            p = int(st.depth[l]) % 2
            dst = bufs[1 - p]
            n_left, small = split_pass(bufs[p], dst, scal, self.plan, nbw,
                                       self.wp_live, self.inpass_hist)
            if small is None:
                small = seg_hist(dst, self.plan, nbw,
                                 s0 if smaller_is_left else s0 + n_left,
                                 n_left if smaller_is_left else n_l - n_left)
            big_g, big_h = gh[l] - small[0], hh[l] - small[1]
            if smaller_is_left:
                gh[s], hh[s] = big_g, big_h
                gh[l], hh[l] = small
            else:
                gh[s], hh[s] = small
                gh[l], hh[l] = big_g, big_h
            left_cnt, right_cnt, depth = split(l, s, cand, n_left)
            cand_l, cand_r = evaluate(
                [l, s], [cand.left_sum_grad, cand.right_sum_grad],
                [cand.left_sum_hess, cand.right_sum_hess],
                [left_cnt, right_cnt], depth)
            best[l], best[s] = cand_l, cand_r
            best_gain[l], best_gain[s] = cand_l.gain, cand_r.gain
            s += 1
        odd = [(int(st.start[k]), int(st.nrows[k])) for k in range(s)
               if st.depth[k] % 2 and st.nrows[k] > 0]
        if odd:
            consolidate(self.second, pay, odd, self.wp_live)
        self.grow_stats.append((levels, s - s_level))
        return st, tree, s

    @staticmethod
    def to_tree_arrays(lstate: LeafState, tree: dict,
                       num_leaves: int) -> TreeArrays:
        """The host TreeArrays (models.tree.Tree input) of one grown tree
        (grow_persist.py:1709-1731)."""
        return TreeArrays(
            num_leaves=num_leaves, leaf_value=lstate.value.copy(),
            leaf_count=lstate.count.astype(np.int32),
            leaf_weight=lstate.sum_hess.copy(), **tree)
