"""The persistent-payload tree grower: the port's fast path for boosting.

The port of the per-split part of lightgbm_tpu/ops/grow_persist.py:
make_persist_grower (:647-2060): the binned rows, label, row id, gradient,
hessian and score of every training row live in ONE int32 payload matrix
(ops/payload.py) that stays leaf-partitioned from tree to tree, so no
per-row gather or scatter runs between iterations:

  * the root: one ``root_hist`` launch (histogram + grad/hess totals) and
    one ``scan_pair`` launch (the root's best split);
  * per split (ops/grow_step.py picks the leaf and keeps the leaf table):
    one ``split_pass`` launch partitions the leaf's segment into the other
    payload buffer (below) and writes the exact n_left to device memory;
    the smaller child's histogram comes from ``seg_hist`` over its segment
    (G > SEG_HIST_MIN_GROUPS) or from ``split_pass`` itself
    (G <= SEG_HIST_MIN_GROUPS); the larger child is the parent minus it;
    one ``scan_pair`` launch scans both children;
  * histograms stay in the padded [G * 256] group-plane layout end to end;
    feature f's window sits at group_of[f] * 256 + ls[f] (``pad_meta`` at
    grow_persist.py:873-882);
  * scores are a payload row: gradients are computed in payload order from
    the label and score rows (:func:`PersistGrower.fill_grad`), a tree's
    outputs are added to its leaves' segments (:meth:`apply_scores`), and
    scores return to row order only when read (:meth:`finalize_scores`);
  * objectives whose gradients need more than the label (reg_sqrt's
    transformed label, MAPE's label weights, cross-entropy's weights) fill
    in row order (:meth:`PersistGrower.fill_grad_row`): the scores go to
    row order through the row-id row, the objective's own gradient runs
    there, and the results come back to the payload's lanes; such a
    payload has no weight row;
  * objectives with leaf renewal (L1, quantile, MAPE) re-fit each leaf's
    output after its tree and before the score update
    (:meth:`PersistGrower.renew`, the ``renew_leaf`` kernel over the
    device leaf table's segments), so the renewed values are both added
    to the scores and read back with the tree;
  * K trees per iteration (multiclass, make_scan_driver's class loop,
    :2150-2166): K score rows and K snapshot rows; one iteration copies the
    score rows into the snapshot (:meth:`snapshot_scores`), then for each
    class computes its gradients from the snapshot
    (:meth:`fill_grad_multi`), grows its tree and adds the tree's outputs
    to its own score row. The snapshot rows move with every partition
    (they are below ``wp_live``), so each class tree reads the scores of
    the iteration's start in the payload's current order.

Two payload buffers. The TPU kernels partition a segment in place; the
port's partition kernels read a segment from one buffer and write both
children to the other at the same lanes, with no scratch and no copy back.
Buffer 0 is the payload itself (the carry); buffer 1 is a second int32
matrix of the payload's ``wp_live`` moving rows and its lane stride,
allocated once per grower (``wp_live * NP * 4`` bytes; rows past
``wp_live`` never move). A leaf at depth d has been partitioned d times,
so its segment lives in buffer d % 2: a split reads buffer depth % 2 and
writes buffer 1 - depth % 2, and the histograms of the children read the
buffer they were written to. At the end of every tree one
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

The per-split loop runs on the device (:meth:`PersistGrower._step`): the
leaf state, the candidates and the split records live in a device table
(ops/grow_step.py), the kernels read the split's scalars, the segment and a
"done" flag from device memory, and a tree is a fixed trip count of L - 1
steps, each a no-op once no leaf has a positive gain (the JAX
while_loop's cond, :1530). Nothing is read back until the tree is done;
then the table is read once. On the card one boosting iteration (gradients,
tree, score update) is captured as one CUDA graph and replayed
(:meth:`PersistGrower.iteration`); on the CPU the same loop runs eagerly
with the plain versions. Leaf counts are the kernel's exact n_left
(``stat_from_scan=False``). The level phase keeps its host loop (one
read-back per level) and hands its leaves to the device loop. With K class
trees per iteration each tree's state is copied into its row of a stash at
the tree's end, and the K trees are read back with one copy.

Bagging and GOSS (make_scan_driver's bag_fn, :2150-2190): after each
class's gradient fill the bag step (ops/bag.py: ``goss_select`` for GOSS,
then ``bag_apply``) weighs every live lane's grad and hess in place from a
hash of its row id and the iteration's window key (device scalars written
before the iteration) and counts the lanes in the bag. Out-of-bag lanes
still ride the payload with zero gradients, so the segments keep their
geometry, but the statistics follow the JAX grower's ``stat_from_scan``
(:706-712): the root's count is the bag step's count, and a split's
children take the candidate's hessian-derived counts instead of n_left
(grow_step's ``bagged`` flag; the level phase likewise on the host). With
K classes every class tree uses the same key, one bag per iteration.

DART (boosting/dart.py) moves the scores between iterations:
:meth:`PersistGrower.add_tree` walks a dropped or renormalized tree over
the training rows of the live lanes onto the score row (ops/valid_walk.py:
valid_walk_payload, the JAX package's add_score_delta, :1816-1826), in
place, so the next replay's gradient fill reads the new scores; the graph
does not change.

RF (boosting/rf.py; make_scan_driver's "rf" mode, the JAX package's
serial.py:610): with ``rf`` set an iteration fills the gradients from the
constant init score instead of the score row (:meth:`fill_grad_const`,
:1941-1955), bags with the host's mask (ops/bag.py's MODE_ROWS,
apply_row_weights :1828-1843) and ends the tree with the running average
(grow_step.apply_scores_avg, apply_scores_avg :1775-1805); t, 1 / (t + 1),
the bias and the mask are written before the body or the replay. Not
ported here: sharding, voting, quantization and the health vector.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from . import counters
from . import grow_step as gs
from .bag import MODE_GOSS, BagIteration, BagState, bag_apply, goss_select
from .block_scan import BlockScanLayout, scan_blocks
from .grow import TreeArrays, _empty_arrays, assemble, scan_children
from .payload import PersistAssets, payload_weight_row
from .valid_walk import valid_walk_payload
from .payload_kernels import (HIST_W, N_SCALARS, S_DB, S_DL, S_LE, S_LS,
                              S_MASK, S_MF, S_MT, S_NB, S_NCH, S_NL, S_S0,
                              S_SH, S_SMALL_L, S_THR, S_WG,
                              consolidate_device, hist_scratch,
                              level_children, level_pass, level_seg_hist,
                              plan_tensor, root_hist, root_scratch,
                              seg_hist_device,
                              split_pass_device)
from .scan import ScanLayout, pair_scalars, scan_pair
from .split import K_MIN_SCORE, SplitCandidate, leaf_output_unconstrained
from ..utils.log import LightGBMError

_range = torch.profiler.record_function

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
    """grow / iteration / apply_scores / fill_grad / init_carry /
    finalize_scores over one dataset's payload, for one grow
    configuration, on one device. ``level_mode`` "auto" runs the level
    phase where :func:`can_level_grow` holds, "off" never. ``grow_stats``
    holds (level programs, splits of the per-split loop after them) of
    every tree this grower grew and the model still holds (the model's
    last ``len(grow_stats)`` trees; a rollback pops them), as the JAX stats
    vector does (:77-89).

    Everything a tree's per-split loop touches is allocated here, once, at
    fixed addresses (the planes, the leaf table, the scan's layout and
    output, the partition's and histograms' scratch, the device counters),
    so that an iteration can be captured as one CUDA graph."""

    def __init__(self, assets: PersistAssets, meta, gc, params, device,
                 level_mode: str = "auto"):
        G, plan, nbw, n, C = assets.geometry[2:7]
        K, has_w = assets.geometry[8], bool(assets.geometry[9])
        self.assets = assets
        self.meta = meta
        self.gc = gc
        self.params = params
        self.device = dev = torch.device(device)
        self.n, self.nbw, self.G, self.C = n, nbw, G, C
        self.K = K
        self.wp_live = payload_weight_row(nbw, K) + (1 if has_w else 0)
        self.weight_row = payload_weight_row(nbw, K) if has_w else None
        # class k's score row, and its snapshot row when K > 1
        # (grow_persist.py:836-837)
        self.score_row = nbw + 4
        self.snap_row = nbw + 4 + K
        self.inpass_hist = G <= SEG_HIST_MIN_GROUPS
        self.plan = plan_tensor(plan, dev)
        group_of, ls, nb = assets.efb[0], assets.efb[1], assets.efb[2]
        self.win_start = (group_of.astype(np.int64) * HIST_W + ls)
        self.win_end = self.win_start + nb
        self.blocks = (BlockScanLayout(assets.efb, meta.penalty, G, dev)
                       if assets.efb[5] else None)
        self._level_mode = level_mode
        self.use_level = level_mode != "off" and can_level_grow(gc)
        # the widest frontier a depth-bounded tree presents (:789-791)
        self.s_maxl = min(1 << max(int(gc.max_depth) - 1, 0),
                          gc.num_leaves - 1)
        self.grow_stats = []
        # buffer 1 of the depth-parity partition: the wp_live moving rows
        # at the payload's lane stride
        NP = assets.geometry[1]
        self.second = torch.zeros((self.wp_live, NP), dtype=torch.int32,
                                  device=dev)
        self.device = dev = self.second.device          # with its index
        # ---- the per-split loop's device state ------------------------
        L, TBp = gc.num_leaves, G * HIST_W
        self.TBp = TBp
        self.gh = torch.zeros((L, TBp), dtype=torch.float32, device=dev)
        self.hh = torch.zeros((L, TBp), dtype=torch.float32, device=dev)
        self.root_buf = root_scratch(self.second, G, n)
        self.small = hist_scratch(self.second, G, n)
        self.work = torch.empty((2, max(1, -(-NP // 1024))),
                                dtype=torch.int32, device=dev)
        self.state = gs.GrowState(L, dev)
        self.k = gs.StepConst.of(params, gc.max_depth, C)
        # the bag step (ops/bag.py): its device scalars, allocated with the
        # first bagged iteration, and the mode of the iteration in hand
        # (None: no bag step; the kernels' mode otherwise)
        self.bag = None
        self._bag_mode = None
        if self.blocks is not None:
            self.masks = self.blocks.masks.clone()
            self.mode, self.Wp = gs.SCAN_BLOCKS, self.blocks.Wp
            self.owner = torch.as_tensor(
                self.blocks.owner.reshape(-1).astype(np.int32), device=dev)
            self.scan_out = torch.empty((2, 8, self.blocks.Gp),
                                        dtype=torch.float32, device=dev)
            fr, rows = self.blocks.forced_right, 0
        else:
            self.layout = ScanLayout(self.win_start, self.win_end,
                                     meta.missing_type, meta.default_bin,
                                     meta.penalty,
                                     np.ones(len(nb), bool), gc.scan_width,
                                     TBp, dev)
            self.mode, self.Wp = gs.SCAN_PAIR, self.layout.Wp
            self.owner = torch.zeros(1, dtype=torch.int32, device=dev)
            self.scan_out = torch.empty((2, 8, self.layout.Fp),
                                        dtype=torch.float32, device=dev)
            fr, rows = self.layout.forced_right, self.layout.Fp
        self.feat = gs.feature_table(assets, fr, rows, dev)
        self._mask_key = np.ones(len(nb), bool).tobytes()
        # K > 1: each class tree's feature mask, staged on the device
        # before the iteration and copied into the scan's layout before its
        # tree (inside the graph)
        if K > 1:
            self._stage = [tuple(t.clone() for t in self._layout_masks())
                           for _ in range(K)]
            self._stage_keys = [self._mask_key] * K
        # every class tree's state at its end, read back with one copy
        self.stash = torch.zeros((K, self.state.blob.numel()),
                                 dtype=torch.uint8, device=dev)
        counters.counts(dev)
        self._levels = (0, 1)         # (level programs, s after them)
        self._body_levels = []        # _levels of each tree of _body
        self._graph = None            # (CUDAGraph, its key)
        self._checked = None          # key of the sync-checked iteration
        self.graph_stats = {}
        self.replays = 0
        # False: every iteration on the card runs eagerly (a probe that
        # must see each launch, as the smoke test's per-call timing does)
        self.capture = True
        # the row-order buffers of fill_grad_row and renew ([n] f64 scores,
        # [n + 1] int32 segment marks, [n] int32 segment keys), allocated
        # at their first use (an eager iteration), then at fixed addresses
        self._rows = None
        # RF: the [n] f32 constant score of its gradient fill (None: not
        # an RF iteration), allocated with the first one
        self._rf_bias = None
        self._const = None

    def set_params(self, params) -> None:
        """New split parameters between iterations (a reset): the level
        phase reads them on the host; the step constants, which the
        per-split loop's launches carry as arguments, are rebuilt, and
        when they change the captured graph is dropped, so the next
        iteration runs checked and captures anew."""
        self.params = params
        k = gs.StepConst.of(params, self.gc.max_depth, self.C,
                            bool(self.k.bagged))
        if k != self.k:
            self.k = k
            self._graph = None
            self._checked = None

    def rebuilt(self, gc, params) -> "PersistGrower":
        """A grower for a new grow configuration (``num_leaves`` or
        ``max_depth``) over the same payload assets, device and level mode,
        with statistics of its own trees. This grower's own buffers are
        released first (it is not used again)."""
        for name in ("second", "gh", "hh", "root_buf", "small", "stash",
                     "_rows", "_graph"):
            setattr(self, name, None)
        gr = PersistGrower(self.assets, self.meta, gc, params, self.device,
                           "auto" if self._level_mode != "off" else "off")
        gr.capture = self.capture
        return gr

    # ---- payload <-> row order ---------------------------------------------
    def _f32_row(self, pay, r):
        return pay[r].view(torch.float32)

    def _scores(self, pay, row0: int) -> torch.Tensor:
        """The [K, n] f32 view of the K rows from `row0` (the scores or
        their snapshot)."""
        return pay[row0:row0 + self.K, :self.n].view(torch.float32)

    def init_carry(self, score0_row) -> torch.Tensor:
        """A fresh payload on the device from the pristine ``pay0`` and the
        row-ordered scores ([n] or [K, n], any float dtype; stored as
        f32)."""
        pay = torch.as_tensor(self.assets.pay0.view(np.int32),
                              device=self.device).clone()
        sc = torch.as_tensor(score0_row, device=self.device) \
            .to(torch.float32).reshape(self.K, self.n)
        self._scores(pay, self.score_row).copy_(sc)
        return pay

    def finalize_scores(self, pay) -> torch.Tensor:
        """The f64 scores in row order, [n] (K = 1) or [K, n], scattered
        through the row-id row (the f32 payload scores, widened)."""
        rid = pay[self.nbw + 1, :self.n].to(torch.int64)
        out = torch.empty((self.K, self.n), dtype=torch.float64,
                          device=pay.device)
        out[:, rid] = self._scores(pay, self.score_row).double()
        return out[0] if self.K == 1 else out

    def add_const(self, pay, val: float, cls: int = 0) -> None:
        """score row `cls` += val on the live lanes (f32), in place: the
        constant tree of a class with nothing to train."""
        self._f32_row(pay, self.score_row + cls)[:self.n] += val

    def add_tree(self, pay, bins, packed, cls: int = 0) -> None:
        """score row `cls` += f32(the leaf value of each live lane's row)
        under a packed tree (ops/valid_walk.py:pack), walked over `bins`
        (the training rows' [n, G] uint8 bins) through the row-id row, in
        place: DART's drop and normalize (the JAX package's
        add_score_delta)."""
        valid_walk_payload(bins, pay[self.nbw + 1], packed.nodes,
                           packed.leaves,
                           self._f32_row(pay, self.score_row + cls), self.n,
                           packed.words)

    def snapshot_scores(self, pay) -> None:
        """The K score rows into the snapshot rows (in place; grow_persist.
        py:1927): every class tree of an iteration reads the scores as
        they were at its start."""
        pay[self.snap_row:self.snap_row + self.K].copy_(
            pay[self.score_row:self.score_row + self.K])

    def fill_grad(self, pay, payload_grad_fn) -> None:
        """Write the objective's gradients, computed in payload order from
        the f32 label and score rows, into the grad/hess rows (in place;
        grow_persist.py:1917-1925). Sample weights multiply after the
        objective, as in the reference's weighted objectives; padding
        lanes get zeros."""
        n = self.n
        label = self._f32_row(pay, self.nbw)[:n]
        score = self._f32_row(pay, self.score_row)[:n]
        self._write_grads(pay, *payload_grad_fn(score, label))

    def fill_grad_multi(self, pay, payload_grad_fn_multi, cls: int) -> None:
        """Class `cls`'s gradients from the snapshot rows and the label row
        (the class index as f32) into the grad/hess rows (in place;
        grow_persist.py:1934-1940)."""
        label = self._f32_row(pay, self.nbw)[:self.n]
        self._write_grads(pay, *payload_grad_fn_multi(
            self._scores(pay, self.snap_row), label, cls))

    def fill_grad_const(self, pay, payload_grad_fn) -> None:
        """RF's gradient fill (grow_persist.py:1941-1955): the objective's
        payload gradient of the constant init score (an [n] f32 vector
        :meth:`iteration` filled) and the label row, never of the average
        the score row holds; weighted and written as :meth:`fill_grad`."""
        label = self._f32_row(pay, self.nbw)[:self.n]
        self._write_grads(pay, *payload_grad_fn(self._const, label))

    def _set_rf(self, rf) -> None:
        """RF's scalars of the iteration (`rf` = (t, bias), None when not
        an RF iteration): t, 1 / (t + 1) and the bias into the state's
        device scalars, the constant score vector refilled when the bias
        changes."""
        if rf is None:
            self._rf_bias = None
            return
        t, bias = float(rf[0]), float(rf[1])
        gs.set_avg(self.state, t, bias)
        if self._const is None:
            self._const = torch.empty(self.n, dtype=torch.float32,
                                      device=self.device)
        if self._rf_bias != bias:
            self._const.fill_(float(F32(bias)))
        self._rf_bias = bias

    def _row_buffers(self, dev):
        if self._rows is None:
            n = self.n
            self._rows = (
                torch.empty(n, dtype=torch.float64, device=dev),
                torch.empty(n + 1, dtype=torch.int32, device=dev),
                torch.empty(n, dtype=torch.int32, device=dev),
                torch.arange(self.gc.num_leaves, device=dev))
        return self._rows

    def _row_scores(self, pay):
        """(the [n] f64 row-ordered scores, the row-id row as int64): the
        f32 payload scores scattered through the row-id row into a buffer
        at a fixed address."""
        rid = pay[self.nbw + 1, :self.n].to(torch.int64)
        rs = self._row_buffers(pay.device)[0]
        rs.index_copy_(0, rid, self._f32_row(pay, self.score_row)[:self.n]
                       .double())
        return rs, rid

    def fill_grad_row(self, pay, row_grad_fn) -> None:
        """The "row" gradient mode (grow_persist.py:1988-2006): the scores
        to row order (f64), the objective's gradient ``row_grad_fn(score)``
        there (its own row-ordered label and weights), the f32 results
        gathered back onto the live lanes through the row-id row. The
        payload has no weight row in this mode: the objective weights its
        gradients itself."""
        rs, rid = self._row_scores(pay)
        g, h = row_grad_fn(rs)
        self._write_grads(pay, g.to(torch.float32).index_select(0, rid),
                          h.to(torch.float32).index_select(0, rid))

    def renew(self, pay, renew_fn) -> None:
        """Re-fit the leaves of the tree in the device state: each leaf's
        LF_VALUE becomes ``renew_fn``'s value for its payload segment
        (an objective's renew_tree_output), from the row-ordered scores
        before the tree's update. A row's segment key is the rank of its
        lane's segment in lane order (a cumulative count of the segment
        starts), scattered to row order, so that the renewal's order by
        (key, residual, row) lays each leaf's rows over its segment's
        lanes [start, start + nrows). Leaves past the tree's s (and a
        tree of one leaf) keep their values; nothing is read back."""
        S = self.state
        rs, rid = self._row_scores(pay)
        _, mark, key, leaf_ids = self._row_buffers(pay.device)
        li = S.li
        live = (leaf_ids < S.st[gs.ST_S]) & (li[:, gs.LI_NROWS] > 0)
        mark.zero_()
        mark.scatter_add_(0, li[:, gs.LI_START], live.to(torch.int32))
        key.index_copy_(0, rid, torch.cumsum(mark[:self.n], 0,
                                             dtype=torch.int32))
        renew_fn(rs, key, li[:, gs.LI_START:gs.LI_NROWS + 1],
                 S.lf[:, gs.LF_VALUE], S.st[gs.ST_S:gs.ST_S + 1])

    def bag_step(self, pay) -> None:
        """The iteration's bag step on the grad/hess rows (in place): for
        GOSS the threshold (goss_select), then each live lane's weight, its
        grad and hess times it, and the in-bag count in ``self.bag.count``
        (bag_apply), from the device scalars :meth:`iteration` wrote."""
        n, nbw = self.n, self.nbw
        g = self._f32_row(pay, nbw + 2)
        h = self._f32_row(pay, nbw + 3)
        if self._bag_mode == MODE_GOSS:
            goss_select(g, h, n, self.bag)
        bag_apply(pay[nbw + 1], self._f32_row(pay, nbw), g, h, n,
                  self._bag_mode, self.bag)

    def _set_bag(self, bag: BagIteration) -> None:
        """The iteration's bag step: its mode, the grow_step constants'
        bag flag, and its device scalars (written before the body or the
        replay, as the learning rate)."""
        mode = None if bag is None else bag.mode
        if (mode is None) != (self._bag_mode is None):
            self.k = self.k._replace(bagged=int(mode is not None))
        self._bag_mode = mode
        if bag is not None:
            if self.bag is None:
                self.bag = BagState(self.device)
            self.bag.set(bag)

    def _write_grads(self, pay, g, h) -> None:
        """g, h ([n] f32) into the grad/hess rows, times the weight row
        when there is one; zeros on the padding lanes."""
        n = self.n
        if self.weight_row is not None:
            w = self._f32_row(pay, self.weight_row)[:n]
            g, h = g * w, h * w
        gh = pay[self.nbw + 2:self.nbw + 4].view(torch.float32)
        gh.zero_()
        gh[0, :n] = g
        gh[1, :n] = h

    def apply_scores(self, pay, lstate: LeafState, num_leaves: int,
                     shrink: float, cls: int = 0) -> None:
        """score += f32(leaf_value * shrink) on every leaf's segment of a
        host LeafState, one direct f32 add per row (in place): the leaves
        are uploaded into a leaf table and :func:`grow_step.apply_scores`
        runs on it, as :meth:`iteration` runs it on the device table. The
        JAX f32 path adds segment deltas through a cumsum
        (grow_persist.py:1761-1773), which rounds differently; the direct
        add is what the update means, and what the JAX widened mode does
        (:1743-1760)."""
        S = gs.GrowState(len(lstate.value), pay.device)
        host = torch.zeros_like(S.blob, device="cpu")
        h = S.views(host)
        h["li"][:, gs.LI_START] = torch.as_tensor(lstate.start)
        h["li"][:, gs.LI_NROWS] = torch.as_tensor(lstate.nrows)
        h["lf"][:, gs.LF_VALUE] = torch.as_tensor(lstate.value)
        h["st"][0, gs.ST_S] = int(num_leaves)
        S.blob.copy_(host)
        gs.apply_scores(S, self._f32_row(pay, self.score_row + cls)[:self.n],
                        shrink)

    # ---- per tree: the host side --------------------------------------------
    def _mask_tensors(self, feature_mask):
        """The scan layout's mask tensors for a feature mask, on the
        host."""
        if self.blocks is not None:
            return (self.blocks.tree_masks(feature_mask),)
        meta, gc = self.meta, self.gc
        lay = ScanLayout(self.win_start, self.win_end, meta.missing_type,
                         meta.default_bin, meta.penalty, feature_mask,
                         gc.scan_width, self.TBp, "cpu")
        return lay.valid_r, lay.valid_f

    def _layout_masks(self):
        """The scan's mask tensors the kernels read."""
        return (self.masks,) if self.blocks is not None else \
            (self.layout.valid_r, self.layout.valid_f)

    def _prepare(self, feature_mask) -> None:
        """The tree's feature mask into the scan's static layout (host work
        and one copy, outside any captured region; nothing when the mask
        is the last one's)."""
        key = np.asarray(feature_mask, bool).tobytes()
        if key == self._mask_key:
            return
        for dst, src in zip(self._layout_masks(),
                            self._mask_tensors(feature_mask)):
            dst.copy_(src)
        self._mask_key = key

    def _stage_masks(self, feature_masks) -> None:
        """K > 1: each class tree's feature mask into its staging buffers
        (host work and copies outside any captured region; nothing for a
        class whose mask is its last one's). :meth:`_body` copies class
        j's into the layout before its tree, on the device."""
        for j, fm in enumerate(feature_masks):
            key = np.asarray(fm, bool).tobytes()
            if key != self._stage_keys[j]:
                for dst, src in zip(self._stage[j], self._mask_tensors(fm)):
                    dst.copy_(src)
                self._stage_keys[j] = key

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

    def _scan_blocks(self, rows, sgs, shs, cnts, depths):
        """SplitCandidates of B children on the host (the level phase) from
        their rows of the planes through scan_blocks, which reads them in
        place (grow_persist.py:1108-1139): the group argmax (first
        maximum), the feature from the owner map, the threshold t_abs -
        ls[f]."""
        params, blk = self.params, self.blocks
        B = len(rows)
        scal = pair_scalars(sgs, shs, cnts, params.lambda_l2,
                            params.min_gain_to_split,
                            params.min_data_in_leaf,
                            params.min_sum_hessian_in_leaf)
        scal9 = np.concatenate([scal, np.asarray(shs, F32)[:, None]], axis=1)
        dev = self.device
        out = scan_blocks(torch.as_tensor(scal9, device=dev), self.gh,
                          self.hh, self.masks, blk.do_fix,
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

    def _evaluate(self, leaves, sgs, shs, cnts, depths):
        """Host SplitCandidates of B children (the level phase's scans)."""
        if self.blocks is not None:
            return self._scan_blocks(leaves, sgs, shs, cnts, depths)
        return scan_children(self.gh, self.hh, leaves, self.layout,
                             self.params, sgs, shs, cnts, depths,
                             int(self.gc.max_depth))

    # ---- per tree: the device loop ------------------------------------------
    def _scan(self, B: int) -> None:
        """The scan of the state's B children and their candidates'
        assembly, on the device."""
        S = self.state
        with _range("grow::scan"):
            if self.blocks is not None:
                scan_blocks(S.ps[:B], self.gh, self.hh, self.masks,
                            self.blocks.do_fix, S.rows[:B], self.G,
                            out=self.scan_out[:B], done=S.done)
            else:
                lay = self.layout
                scan_pair(S.ps8[:B], self.gh, self.hh, lay.keep_r,
                          lay.keep_f, lay.valid_r, lay.valid_f, lay.aux,
                          rows=S.rows[:B], gidx=lay.gidx,
                          out=self.scan_out[:B], done=S.done)
        with _range("grow::assembly"):
            gs.assemble(S, self.scan_out[:B], self.mode, self.owner,
                        self.Wp, self.feat, self.k, advance=B == 2)

    def _root(self, pay) -> None:
        """root_hist, the root's state and its scan, on the device."""
        with _range("grow::root"):
            planes, sums = self.root_buf[:2]
            root_hist(pay, self.plan, self.nbw, self.n, out=self.root_buf)
            self.gh[0].copy_(planes[0])
            self.hh[0].copy_(planes[1])
            gs.root(self.state, sums, self.n, self.k,
                    None if self._bag_mode is None else self.bag.count)
        self._scan(1)

    def _step(self, pay) -> None:
        """One split on the device: pick -> split_pass -> seg_hist (G > 20)
        -> the children's state -> planes -> scan -> assembly; a no-op
        once the done flag is set."""
        S = self.state
        with _range("grow::pick"):
            gs.pick(S, self.feat, self.k)
        with _range("grow::split_pass"):
            split_pass_device(pay, self.second, S.scal, S.res, self.plan,
                              self.nbw, self.wp_live,
                              self.small if self.inpass_hist else None,
                              done=S.done, work=self.work, swap=S.parity)
        if not self.inpass_hist:
            with _range("grow::seg_hist"):
                seg_hist_device(self.second, self.plan, self.nbw, S.child,
                                self.small[0], self.small[1], done=S.done,
                                alt=pay, swap=S.parity)
        with _range("grow::assembly"):
            gs.commit(S, self.k)
        with _range("grow::planes"):
            gs.planes(S, self.gh, self.hh, self.small[0])
        self._scan(2)

    def _finish(self, pay) -> None:
        """The odd-depth leaves back into the payload (their table built on
        the device)."""
        with _range("grow::consolidation"):
            gs.cons_table(self.state)
            consolidate_device(self.second, pay, self.state.tab,
                               self.wp_live)

    def _device_tree(self, pay) -> None:
        """A whole tree on the device, queued without a read-back: the
        root, L - 1 steps (the fixed trip count), the consolidation."""
        self._root(pay)
        for _ in range(self.gc.num_leaves - 1):
            self._step(pay)
        self._finish(pay)
        self._levels = (0, 1)

    # ---- per tree: the level phase, then the device loop --------------------
    def _level_tree(self, pay) -> None:
        """The level phase on the host (grow_persist.py:1295-1527), its
        leaf state and candidates uploaded once, then the rest of the tree
        by L - s device steps and the consolidation."""
        gc, params = self.gc, self.params
        L, n, nbw = gc.num_leaves, self.n, self.nbw
        md = int(gc.max_depth)
        bufs = (pay, self.second)
        gh, hh = self.gh, self.hh
        tree = {k: v for k, v in _empty_arrays(L).items()
                if not k.startswith("leaf_")}             # split records
        planes, sums = self.root_buf[:2]
        root_hist(pay, self.plan, nbw, n, out=self.root_buf)
        gh[0].copy_(planes[0])
        hh[0].copy_(planes[1])
        sum_grad, sum_hess = (F32(v) for v in sums.cpu().numpy())
        bagged = self._bag_mode is not None
        n_root = int(self.bag.count[0]) if bagged else n
        st = LeafState(sum_hess=np.zeros(L, F32),
                       count=np.zeros(L, np.int64), value=np.zeros(L, F32),
                       depth=np.zeros(L, np.int32),
                       start=np.zeros(L, np.int64),
                       nrows=np.zeros(L, np.int64))
        st.sum_hess[0] = sum_hess
        st.count[0], st.nrows[0] = n_root, n
        st.value[0] = leaf_output_unconstrained(sum_grad, sum_hess,
                                                F32(params.lambda_l2))
        best = [SplitCandidate.none() for _ in range(L)]
        best_gain = np.full(L, K_MIN_SCORE, F32)
        best[0] = self._evaluate([0], [sum_grad], [sum_hess], [n_root],
                                 0)[0]
        best_gain[0] = best[0].gain

        s, levels = 1, 0
        while s < L:
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
            rows = torch.as_tensor(slots, device=self.device)
            new = torch.arange(s, s + cntp, device=self.device)
            sl_t = torch.as_tensor(small_l, device=self.device)[:, None]
            for P, sm in ((gh, small[0]), (hh, small[1])):
                big = P[rows] - sm
                P[new] = torch.where(sl_t, big, sm)
                P[rows] = torch.where(sl_t, sm, big)
            kids = []
            for j, (l, c) in enumerate(zip(slots, cands)):
                l, r, n_left = int(l), s + j, int(n_lefts[j])
                s0, n_l = int(st.start[l]), int(st.nrows[l])
                k = r - 1
                tree["split_leaf"][k] = l
                tree["split_feature"][k] = c.feature
                tree["threshold"][k] = c.threshold
                tree["default_left"][k] = c.default_left
                tree["gain"][k] = c.gain
                tree["internal_value"][k] = st.value[l]
                tree["internal_count"][k] = st.count[l]
                if bagged:      # stat_from_scan: the candidate's counts
                    left_cnt, right_cnt = c.left_count, c.right_count
                else:
                    left_cnt, right_cnt = n_left, int(st.count[l]) - n_left
                depth = int(st.depth[l]) + 1
                for leaf, sh_, cnt_, val_, st_, nr_ in (
                        (l, c.left_sum_hess, left_cnt, c.left_output, s0,
                         n_left),
                        (r, c.right_sum_hess, right_cnt, c.right_output,
                         s0 + n_left, n_l - n_left)):
                    st.sum_hess[leaf] = sh_
                    st.count[leaf], st.value[leaf] = cnt_, val_
                    st.depth[leaf] = depth
                    st.start[leaf], st.nrows[leaf] = st_, nr_
                kids.append((left_cnt, right_cnt, depth))
            res = self._evaluate(
                np.concatenate([slots, np.arange(s, s + cntp)]),
                [c.left_sum_grad for c in cands]
                + [c.right_sum_grad for c in cands],
                [c.left_sum_hess for c in cands]
                + [c.right_sum_hess for c in cands],
                [k_[0] for k_ in kids] + [k_[1] for k_ in kids],
                [k_[2] for k_ in kids] * 2)
            for j, l in enumerate(slots):
                best[l], best[s + j] = res[j], res[cntp + j]
                best_gain[l], best_gain[s + j] = res[j].gain, \
                    res[cntp + j].gain
            s += cntp
            levels += 1
        self._upload(st, best, best_gain, tree, s)
        # the candidates are on the host here: with no positive gain left
        # the device loop would stop at its first pick, so none is queued
        for _ in range(L - s if bool(np.any(best_gain > 0)) else 0):
            self._step(pay)
        self._finish(pay)
        self._levels = (levels, s)

    def _upload(self, st: LeafState, best, best_gain, tree, s: int) -> None:
        """The host tree (leaf state, candidates, split records, s) into the
        device state, with one copy."""
        S = self.state
        host = torch.zeros_like(S.blob, device="cpu")
        h = {k: v.numpy() for k, v in S.views(host).items()}
        lf, li, rf, ri = h["lf"], h["li"], h["rf"], h["ri"]
        lf[:, gs.LF_SUM_HESS], lf[:, gs.LF_VALUE] = st.sum_hess, st.value
        li[:, gs.LI_COUNT], li[:, gs.LI_DEPTH] = st.count, st.depth
        li[:, gs.LI_START], li[:, gs.LI_NROWS] = st.start, st.nrows
        lf[:, gs.LF_GAIN] = best_gain
        for l, c in enumerate(best):
            lf[l, [gs.LF_LOUT, gs.LF_ROUT, gs.LF_LSG, gs.LF_LSH, gs.LF_RSG,
                   gs.LF_RSH]] = (c.left_output, c.right_output,
                                  c.left_sum_grad, c.left_sum_hess,
                                  c.right_sum_grad, c.right_sum_hess)
            li[l, [gs.LI_FEAT, gs.LI_THR, gs.LI_DL, gs.LI_LCNT,
                   gs.LI_RCNT]] = (c.feature, c.threshold,
                                   int(c.default_left), c.left_count,
                                   c.right_count)
        R = len(tree["gain"])
        rf[:R, gs.RF_GAIN], rf[:R, gs.RF_IVAL] = (tree["gain"],
                                                  tree["internal_value"])
        for col, key in ((gs.RI_LEAF, "split_leaf"),
                         (gs.RI_FEAT, "split_feature"),
                         (gs.RI_THR, "threshold"),
                         (gs.RI_DL, "default_left"),
                         (gs.RI_ICNT, "internal_count")):
            ri[:R, col] = tree[key]
        h["st"][0, gs.ST_S] = s
        S.blob.copy_(host)

    def read_tree(self):
        """(LeafState, split records as a dict of [L-1] arrays, num_leaves)
        of the tree in the device state: one device-to-host copy."""
        return self._parse(self.state.read(), self._levels)

    def _parse(self, h: dict, levels):
        """The tree of a host copy of the state (numpy views by field),
        its (level programs, s after them) recorded in grow_stats."""
        L = self.gc.num_leaves
        lf, li, rf, ri = h["lf"], h["li"], h["rf"][:L - 1], h["ri"][:L - 1]
        s = int(h["st"][0, gs.ST_S])
        self.device_counts = dict(zip(counters.SLOTS, h["cnt"][0].tolist()))
        st = LeafState(sum_hess=lf[:, gs.LF_SUM_HESS].copy(),
                       count=li[:, gs.LI_COUNT].copy(),
                       value=lf[:, gs.LF_VALUE].copy(),
                       depth=li[:, gs.LI_DEPTH].astype(np.int32),
                       start=li[:, gs.LI_START].copy(),
                       nrows=li[:, gs.LI_NROWS].copy())
        tree = dict(split_leaf=ri[:, gs.RI_LEAF].astype(np.int32),
                    split_feature=ri[:, gs.RI_FEAT].astype(np.int32),
                    threshold=ri[:, gs.RI_THR].astype(np.int32),
                    default_left=ri[:, gs.RI_DL].astype(bool),
                    gain=rf[:, gs.RF_GAIN].copy(),
                    internal_value=rf[:, gs.RF_IVAL].copy(),
                    internal_count=ri[:, gs.RI_ICNT].astype(np.int32))
        n_levels, s_level = levels
        self.grow_stats.append((n_levels, s - s_level))
        return st, tree, s

    def _tree(self, pay) -> None:
        if self.use_level:
            self._level_tree(pay)
        else:
            self._device_tree(pay)

    def grow(self, pay, feature_mask):
        """Grow one tree on the payload. The splits move segments between
        the payload and the second buffer by depth parity; the last step
        brings the odd-depth leaves back, so the payload ends partitioned
        by leaf. Returns (LeafState, split records as a dict of [L-1]
        arrays, num_leaves), read back once."""
        self._prepare(feature_mask)
        self._tree(pay)
        return self.read_tree()

    # ---- one boosting iteration -------------------------------------------
    def _body(self, pay, grad_fn, classes, mode="payload",
              renew=None, rf=False) -> None:
        """The iteration queued with no read-back (on the card: everything
        one CUDA graph captures): K = 1: fill_grad (fill_grad_row in the
        "row" `mode`) -> the tree -> the renewal (with a `renew` function)
        -> apply_scores; K > 1: the score snapshot, then for each class in
        `classes` its feature mask into the layout, fill_grad_multi -> its
        tree -> apply_scores on its score row (make_scan_driver's class
        loop, grow_persist.py:2150-2166). With a bag step, it runs after
        each gradient fill (:meth:`bag_step`). With `rf` (K = 1) the fill
        is :meth:`fill_grad_const` and the score update the running
        average (grow_step.apply_scores_avg). Each tree's state is copied
        into its row of the stash. The learning rate, the bag step's and
        RF's scalars are read from device scalars, which :meth:`iteration`
        writes before the body."""
        if self.K > 1:
            with _range("grow::snapshot"):
                self.snapshot_scores(pay)
        levels = []
        for j, cls in enumerate(classes):
            if self.K > 1:
                for dst, src in zip(self._layout_masks(), self._stage[j]):
                    dst.copy_(src)
            with _range("grow::fill_grad"):
                if self.K > 1:
                    self.fill_grad_multi(pay, grad_fn, cls)
                elif rf:
                    self.fill_grad_const(pay, grad_fn)
                elif mode == "row":
                    self.fill_grad_row(pay, grad_fn)
                else:
                    self.fill_grad(pay, grad_fn)
            if self._bag_mode is not None:
                with _range("grow::bag"):
                    self.bag_step(pay)
            self._tree(pay)
            levels.append(self._levels)
            if renew is not None:
                with _range("grow::renew"):
                    self.renew(pay, renew)
            with _range("grow::apply_scores"):
                score = self._f32_row(pay, self.score_row + cls)[:self.n]
                if rf:
                    gs.apply_scores_avg(self.state, score)
                else:
                    gs.apply_scores(self.state, score)
            self.state.cnt.copy_(counters.counts(self.device))
            self.stash[j].copy_(self.state.blob)
        self._body_levels = levels

    def iteration(self, pay, grad_fn, feature_masks, shrink: float,
                  classes=(0,), mode="payload", renew=None,
                  bag: BagIteration = None, rf=None):
        """One boosting iteration on the payload: for each class in
        `classes` (every class with something to train), its gradients
        (``grad_fn``: a payload_grad_fn when K = 1, a payload_grad_fn_multi
        otherwise; in the "row" `mode` a function of the row-ordered
        scores), with `bag` (ops/bag.py's BagIteration) the bag step on
        them, one tree on its feature mask (``feature_masks[j]`` for
        ``classes[j]``), with `renew` (an objective's renew_tree_output)
        its leaves re-fit, its score update. `rf` = (t, bias) makes it an
        RF iteration (K = 1, the "payload" `mode`; `bag` its MODE_ROWS
        mask): the gradients of the constant bias, the running average
        over t earlier iterations. Returns one (LeafState, split records,
        num_leaves) per class, as :meth:`grow` does, all read back with one
        copy.

        On the CPU, and after a level phase, it runs eagerly. On the card
        without a level phase the first iteration runs eagerly under
        ``torch.cuda.set_sync_debug_mode("error")`` (any torch operation
        that waits for the card raises); the next one is captured as one
        CUDA graph, and every later iteration on the same payload and
        classes replays it: the learning rate is written into the state's
        device scalar before the body or the replay (gs.set_shrink), so a
        rate that changes between iterations (``learning_rates=``) replays
        the same graph; so are the bag step's window key, iteration and
        fractions, while a change of its mode (none, fraction, balanced,
        GOSS, rows) takes a new graph, and so does RF. A failure raises:
        there is no fallback to an eager loop."""
        classes = tuple(int(c) for c in classes)
        if rf is not None and (self.K > 1 or mode != "payload"):
            raise LightGBMError("PersistGrower: an RF iteration needs one "
                                "tree per iteration and the payload "
                                "gradient mode")
        if self.K > 1:
            self._stage_masks(feature_masks)
        else:
            self._prepare(feature_masks[0])
        gs.set_shrink(self.state, shrink)
        self._set_bag(bag)
        self._set_rf(rf)
        is_rf = rf is not None
        if self.use_level or self.device.type != "cuda" or not self.capture:
            self._body(pay, grad_fn, classes, mode, renew, is_rf)
            return self._read_stash(len(classes))
        key = (pay.data_ptr(), classes, self._bag_mode, is_rf)
        if self._graph is not None and self._graph[1] == key:
            self._graph[0].replay()
            self.replays += 1
        elif self._checked != key:
            sync = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._body(pay, grad_fn, classes, mode, renew, is_rf)
            finally:
                torch.cuda.set_sync_debug_mode(sync)
            self._checked = key
        else:
            self._capture(pay, key, grad_fn, mode, renew)
        return self._read_stash(len(classes))

    def _read_stash(self, m: int):
        """The first m trees of the stash, with one device-to-host copy."""
        host = self.stash[:m].cpu()
        return [self._parse({k: v.numpy() for k, v in
                             self.state.views(host[j]).items()}, lv)
                for j, lv in enumerate(self._body_levels[:m])]

    def _capture(self, pay, key, grad_fn, mode, renew) -> None:
        """Capture one iteration (its classes: key[1]) as a CUDA graph,
        then replay it."""
        import time
        try:
            g = torch.cuda.CUDAGraph(keep_graph=True)
        except TypeError:                 # a torch without keep_graph
            g = torch.cuda.CUDAGraph()
        torch.cuda.synchronize(self.device)
        t0 = time.perf_counter()
        with torch.cuda.graph(g):
            self._body(pay, grad_fn, key[1], mode, renew, key[3])
        t1 = time.perf_counter()
        nodes = None
        if hasattr(g, "raw_cuda_graph"):
            try:
                nodes = gs.graph_nodes(g)
            except RuntimeError:          # the graph was not kept
                nodes = None
        if hasattr(g, "instantiate"):
            g.instantiate()
        torch.cuda.synchronize(self.device)
        t2 = time.perf_counter()
        self._graph = (g, key)
        self.graph_stats = {"nodes": nodes, "capture_ms": (t1 - t0) * 1e3,
                            "instantiate_ms": (t2 - t1) * 1e3}
        g.replay()

    @staticmethod
    def to_tree_arrays(lstate: LeafState, tree: dict,
                       num_leaves: int) -> TreeArrays:
        """The host TreeArrays (models.tree.Tree input) of one grown tree
        (grow_persist.py:1709-1731)."""
        return TreeArrays(
            num_leaves=num_leaves, leaf_value=lstate.value.copy(),
            leaf_count=lstate.count.astype(np.int32),
            leaf_weight=lstate.sum_hess.copy(), **tree)
