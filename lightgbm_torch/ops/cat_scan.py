"""The categorical split scan of a batch of nodes.

No Pallas counterpart: the JAX package scans categorical features with XLA
ops, ``find_best_split_categorical`` (lightgbm_tpu/ops/split.py:572, with
``_cat_onehot_scan:456`` and ``_cat_sorted_scan:480``), the reference's
FindBestThresholdCategoricalInner (feature_histogram.hpp:263-474), on every
node whose Dataset has a categorical column. Here :func:`cat_scan` computes
it for B nodes by C categorical features in one launch of the CUDA kernel
``csrc/cat_scan.cu`` for tensors on the card, and :func:`cat_scan_plain`,
the same function in plain PyTorch, for tensors on the CPU. Both compute
in float32, the JAX package's precision off the CPU (``resolve_use_dp``),
in the same operations in the same order, so the card and the CPU grow the
same trees.

Per (node, feature), as the JAX function does per feature:

  * the feature's used bins (``used_bin = num_bin - 1 + (missing_type ==
    None)``: the trailing other/NaN bin never goes left alone), each bin's
    count recovered from its hessian as ``floor(hess * cnt_factor + 0.5)``;
  * one-hot (``num_bin <= max_cat_to_onehot``): each used bin alone
    against the rest, the first best bin;
  * else the sorted many-vs-many scan: the bins whose count reaches
    ``cat_smooth``, stably sorted by ``grad / (hess + cat_smooth)`` (the
    others last), a prefix walk from each end of at most
    ``min(max_cat_threshold, (used + 1) // 2)`` steps with the
    ``min_data_per_group`` group counter and the stop rule, ``cat_l2``
    added to ``lambda_l2``; the reverse walk wins only on a greater gain;
  * the gain is reported after the shift and the feature penalty when it
    beats ``min_gain_shift`` and the node scans the feature.

Output ``[B, C, 16]`` f32 per (node, feature): the reported gain (-inf: no
split), the left side's grad, hess (kEpsilon included) and count, the l2 of
its outputs, three zeros, then the left bins as 8 uint32 words (bit w of
word w // 32: local bin w goes left), stored bit for bit in the f32 lanes.
The host picks the first best feature (:func:`cat_candidates`).
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import counters
from .split import K_EPSILON, leaf_gain, leaf_output, split_gains

CAT_MAX_W = 256     # one byte per bin: the widest categorical feature
CAT_WORDS = CAT_MAX_W // 32
CAT_COLS = 16
# columns of the [16] parameter block (cat_params)
(CP_L1, CP_L2, CP_MDS, CP_CAT_L2, CP_CAT_SMOOTH, CP_MIN_HESS, CP_MIN_DATA,
 CP_MIN_GROUP, CP_MAX_CAT, CP_MAX_ONEHOT, CP_USE_MC) = range(11)
PAR_COLS = 16
# columns of a node's [8] scalar row (cat_scalars)
(CS_SG, CS_SH, CS_ND, CS_CF, CS_MGS, CS_CMIN, CS_CMAX) = range(7)
SCAL_COLS = 8

F32 = np.float32
NEG_INF = float("-inf")


class CatLayout:
    """The categorical features of a dataset (the JAX package's
    build_cat_layout, treelearner/serial.py:195): their inner ids, and on
    the device their global bin start, bin count and used bins ([3, C]
    int32), penalties ([C] f32) and the gather index of the plain version
    ([C, W] int64). ``W`` is the widest one (the JAX cat_width)."""

    def __init__(self, is_categorical, bin_start, bin_end, missing_type,
                 penalty, tb: int, device):
        self.feature = np.nonzero(np.asarray(is_categorical, bool))[0]
        f = self.feature
        self.C = C = len(f)
        nb = (np.asarray(bin_end) - np.asarray(bin_start))[f].astype(np.int64)
        self.W = W = int(nb.max()) if C else 1
        if W > CAT_MAX_W:
            raise LightGBMError("cat_scan: a categorical feature has %d bins "
                                "(at most %d)" % (W, CAT_MAX_W))
        start = np.asarray(bin_start, np.int64)[f]
        used = nb - 1 + (np.asarray(missing_type)[f] == 0)
        self.meta = torch.as_tensor(np.stack([start, nb, used]).astype(
            np.int32).reshape(3, C), device=device)
        self.penalty = torch.as_tensor(
            np.asarray(penalty, F32)[f], device=device)
        self.gidx = torch.as_tensor(
            np.clip(start[:, None] + np.arange(W)[None, :], 0,
                    max(tb - 1, 0)), device=device)


def cat_params(params, cat_cfg, use_mc: bool) -> torch.Tensor:
    """The [16] f32 parameter block (CPU) of a run: SplitParams' lambda_l1,
    lambda_l2, max_delta_step, min_sum_hessian_in_leaf and min_data_in_leaf,
    the config's cat_l2, cat_smooth, min_data_per_group, max_cat_threshold,
    max_cat_to_onehot (``cat_cfg``, a mapping), and the use_mc switch."""
    p = np.zeros(PAR_COLS, F32)
    p[CP_L1] = params.lambda_l1
    p[CP_L2] = params.lambda_l2
    p[CP_MDS] = params.max_delta_step
    p[CP_CAT_L2] = cat_cfg["cat_l2"]
    p[CP_CAT_SMOOTH] = cat_cfg["cat_smooth"]
    p[CP_MIN_HESS] = params.min_sum_hessian_in_leaf
    p[CP_MIN_DATA] = params.min_data_in_leaf
    p[CP_MIN_GROUP] = cat_cfg["min_data_per_group"]
    p[CP_MAX_CAT] = cat_cfg["max_cat_threshold"]
    p[CP_MAX_ONEHOT] = cat_cfg["max_cat_to_onehot"]
    p[CP_USE_MC] = 1.0 if use_mc else 0.0
    return torch.as_tensor(p)


def cat_scalars(sum_grad, sum_hess_adj, count, params, cmin, cmax
                ) -> np.ndarray:
    """[B, 8] f32 node rows in the JAX function's f32 operations
    (split.py:581-590): the sums, the count, ``cnt_factor = count /
    sum_hess_adj``, ``min_gain_shift`` (the parent's leaf gain under L1 and
    max_delta_step, plus min_gain_to_split) and the monotone bounds.
    ``sum_hess_adj`` already holds the scan's ``+ 2 * kEpsilon``."""
    sg = np.atleast_1d(np.asarray(sum_grad, F32))
    sh = np.atleast_1d(np.asarray(sum_hess_adj, F32))
    nd = np.atleast_1d(np.asarray(count, F32))
    out = np.zeros((len(sg), SCAL_COLS), F32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        out[:, CS_CF] = nd / sh
        out[:, CS_MGS] = leaf_gain(sg, sh, F32(params.lambda_l2),
                                   F32(params.lambda_l1),
                                   F32(params.max_delta_step), True,
                                   True) + F32(params.min_gain_to_split)
    out[:, CS_SG] = sg
    out[:, CS_SH] = sh
    out[:, CS_ND] = nd
    out[:, CS_CMIN] = np.broadcast_to(np.asarray(cmin, F32), len(sg))
    out[:, CS_CMAX] = np.broadcast_to(np.asarray(cmax, F32), len(sg))
    return out


def sort_keys(ratio: torch.Tensor) -> torch.Tensor:
    """int64 keys whose order is a stable float argsort's (jnp.argsort and
    torch.argsort alike): -0.0 equals +0.0 and every NaN sorts last."""
    r = torch.where(ratio == 0, torch.zeros_like(ratio), ratio)
    bits = r.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(bits >= 0x80000000, bits ^ 0xFFFFFFFF,
                      bits | 0x80000000)
    return torch.where(torch.isnan(ratio), torch.full_like(key, 0xFFFFFFFF),
                       key)


def _gains(gl, hl, gr, hr, l2, par, cmin, cmax, use_mc: bool):
    """The JAX categorical scan's split gains: GetSplitGains with L1 and the
    max_delta_step switch on, a zero monotone sign."""
    return split_gains(gl, hl, gr, hr, l2, par[CP_L1], par[CP_MDS], cmin,
                       cmax, 0.0, True, True, use_mc)


def cat_scan_plain(scal, gb, hb, meta, pen, fmask, par) -> torch.Tensor:
    """[B, C, 16] f32: the kernel's function in plain PyTorch, over the
    nodes' gathered planes gb/hb [B, C, W] (lane w of feature c: global bin
    start[c] + w, masked beyond its bins)."""
    B, C, W = gb.shape
    dev = gb.device
    par = par.to(dev)
    use_mc = bool(par[CP_USE_MC] > 0)
    min_data = int(par[CP_MIN_DATA])
    mdpg = int(par[CP_MIN_GROUP])
    max_cat = int(par[CP_MAX_CAT])
    min_hess = par[CP_MIN_HESS]
    l2 = par[CP_L2]
    s = scal[:, None, :]                                       # [B, 1, 8]
    sg, sh, cf, mgs = s[..., CS_SG], s[..., CS_SH], s[..., CS_CF], \
        s[..., CS_MGS]
    cmin, cmax = s[..., CS_CMIN], s[..., CS_CMAX]
    nd = s[..., CS_ND].to(torch.int64)
    nb = meta[1].long()[None, :]                               # [1, C]
    used_bin = meta[2].long()[None, :]
    w = torch.arange(W, device=dev)
    used = (w < nb[..., None]) & (w < used_bin[..., None])     # [1, C, W]
    zero = torch.zeros((), dtype=gb.dtype, device=dev)
    g = torch.where(used, gb, zero)
    h = torch.where(used, hb, zero)
    cnt = torch.floor(h * cf[..., None] + 0.5).to(torch.int64)
    neg = torch.full((), NEG_INF, dtype=gb.dtype, device=dev)
    eps = torch.tensor(K_EPSILON, dtype=gb.dtype, device=dev)

    # ---- one-hot: each used bin alone (left) against the rest -------------
    hess_adj = h + eps
    oc = nd[..., None] - cnt
    oh = (sh[..., None] - h) - eps
    ok = (used & (cnt >= min_data) & (h >= min_hess) & (oc >= min_data)
          & (oh >= min_hess))
    gains = _gains(sg[..., None] - g, oh, g, hess_adj, l2, par,
                   cmin[..., None], cmax[..., None], use_mc)
    gains = torch.where(ok, gains, neg)
    t = torch.argmax(gains, dim=2, keepdim=True)               # [B, C, 1]
    oh_gain = gains.gather(2, t)[..., 0]
    oh_lg = g.gather(2, t)[..., 0]
    oh_lh = hess_adj.gather(2, t)[..., 0]
    oh_lc = cnt.gather(2, t)[..., 0]
    oh_mask = w == t

    # ---- sorted many-vs-many ------------------------------------------------
    l2c = l2 + par[CP_CAT_L2]
    smooth = par[CP_CAT_SMOOTH]
    part = used & (cnt.to(gb.dtype) >= smooth)
    inf = torch.full((), float("inf"), dtype=gb.dtype, device=dev)
    ratio = torch.where(part, g / (h + smooth), inf)
    order = torch.argsort(sort_keys(ratio), dim=2, stable=True)  # [B, C, W]
    u = part.sum(dim=2)                                        # [B, C]
    max_num = torch.clamp((u + 1) // 2, max=max_cat)
    g_s, h_s, c_s = (x.gather(2, order) for x in (g, h, cnt))
    v_s = part.gather(2, order)

    T = min(W, max_cat)       # steps past max_cat_threshold never split
    steps = torch.arange(T, device=dev)
    col = (slice(None), slice(None), None)       # [B, C] -> [B, C, 1]

    def walk(reverse: bool):
        """One direction: the prefix sums in step order (sequential f32
        adds, the kernel's), every step's gain at once, then the stateful
        stop flag and group counter step by step; the first best step."""
        if reverse:
            p = torch.where(steps < u[col], u[col] - 1 - steps,
                            W - 1 - (steps - u[col]))
        else:
            p = steps.expand(B, C, T)
        v = v_s.gather(2, p)
        gq = torch.where(v, g_s.gather(2, p), zero)
        hq = torch.where(v, h_s.gather(2, p), zero)
        cq = torch.where(v, c_s.gather(2, p), torch.zeros_like(p))
        slg = torch.empty_like(gq)
        slh = torch.empty_like(hq)
        acc_g = torch.zeros((B, C), dtype=gb.dtype, device=dev)
        acc_h = torch.full((B, C), K_EPSILON, dtype=gb.dtype, device=dev)
        for j in range(T):
            acc_g = acc_g + gq[..., j]
            acc_h = acc_h + hq[..., j]
            slg[..., j] = acc_g
            slh[..., j] = acc_h
        lcnt = torch.cumsum(cq, dim=2)
        rc = nd[..., None] - lcnt
        rh = sh[..., None] - slh
        brk = (rc < min_data) | (rc < mdpg) | (rh < min_hess)
        pre = ~brk & (lcnt >= min_data) & (slh >= min_hess)
        gains = _gains(slg, slh, sg[..., None] - slg, sh[..., None] - slh,
                       l2c, par, cmin[..., None], cmax[..., None], use_mc)
        ok = torch.zeros_like(brk)
        stopped = torch.zeros((B, C), dtype=torch.bool, device=dev)
        grp = torch.zeros((B, C), dtype=torch.int64, device=dev)
        for j in range(T):
            grp = grp + cq[..., j]
            in_range = v[..., j] & (j < max_num) & ~stopped
            stopped = stopped | (in_range & brk[..., j])
            okj = in_range & pre[..., j] & (grp >= mdpg)
            grp = torch.where(okj, torch.zeros_like(grp), grp)
            ok[..., j] = okj
        gains = torch.where(ok, gains, neg)
        i = torch.argmax(gains, dim=2, keepdim=True)     # first maximum
        return (gains.gather(2, i)[..., 0], slg.gather(2, i)[..., 0],
                slh.gather(2, i)[..., 0], lcnt.gather(2, i)[..., 0],
                i[..., 0])

    gf, lgf, lhf, lcf, if_ = walk(False)
    gr, lgr, lhr, lcr, ir = walk(True)
    use_r = gr > gf
    so_gain = torch.where(use_r, gr, gf)
    i_best = torch.where(use_r, ir, if_)[..., None]
    pos_of = torch.argsort(order, dim=2)        # local bin -> sorted place
    so_mask = torch.where(use_r[..., None],
                          pos_of >= (u[..., None] - 1 - i_best),
                          pos_of <= i_best) & part

    onehot = (nb <= int(par[CP_MAX_ONEHOT])).expand(B, C)
    gain = torch.where(onehot, oh_gain, so_gain)
    lg = torch.where(onehot, oh_lg, torch.where(use_r, lgr, lgf))
    lh = torch.where(onehot, oh_lh, torch.where(use_r, lhr, lhf))
    lc = torch.where(onehot, oh_lc, torch.where(use_r, lcr, lcf))
    mask = torch.where(onehot[..., None], oh_mask, so_mask)
    l2_out = torch.where(onehot, l2, l2c)
    ok = (gain > mgs) & (fmask > 0)
    gain_out = torch.where(ok, (gain - mgs) * pen[None, :], neg)

    out = torch.zeros((B, C, CAT_COLS), dtype=torch.float32, device=dev)
    out[..., 0] = gain_out
    out[..., 1] = lg
    out[..., 2] = lh
    out[..., 3] = lc.to(torch.float32)
    out[..., 4] = l2_out
    bits = torch.zeros((B, C, CAT_MAX_W), dtype=torch.int64, device=dev)
    bits[..., :W] = mask.long()
    words = (bits.view(B, C, CAT_WORDS, 32)
             << torch.arange(32, device=dev)).sum(dim=3)
    out.view(torch.int32)[..., 8:] = torch.where(
        words < 2 ** 31, words, words - 2 ** 32).to(torch.int32)
    return out


def cat_scan_rows_plain(scal, gh, hh, rows, layout: CatLayout, fmask, par):
    """:func:`cat_scan_plain` of the nodes' rows of the [R, TB] planes, read
    through the layout's gather index: the function of the kernel."""
    return cat_scan_plain(scal, gh[rows][:, layout.gidx],
                          hh[rows][:, layout.gidx], layout.meta,
                          layout.penalty, fmask, par)


def _launch(scal, gh, hh, rows, layout, fmask, par, out):
    from .build import load
    fn = load("cat_scan").cat_scan_launch
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, LL, P, P, P, P, I, I, I, P, P, P]
    fn.restype = I
    B, C = fmask.shape
    err = fn(scal.data_ptr(), gh.data_ptr(), hh.data_ptr(), rows.data_ptr(),
             gh.shape[1], layout.meta.data_ptr(), layout.penalty.data_ptr(),
             fmask.data_ptr(), par.data_ptr(), B, C, layout.W,
             out.data_ptr(), counters.ptr(gh.device, "cat_scan"),
             torch.cuda.current_stream(gh.device).cuda_stream)
    if err != 0:
        raise LightGBMError("cat_scan kernel launch failed: CUDA error %d"
                            % err)


def cat_scan(scal, gh, hh, rows, layout: CatLayout, fmask, par
             ) -> torch.Tensor:
    """Best categorical split per (node, feature) of B nodes: the CUDA
    kernel for tensors on the card, the plain version for tensors on the
    CPU. scal [B, 8] f32 (:func:`cat_scalars`), gh/hh [R, TB] f32 grad and
    hess planes, rows [B] int64 the nodes' plane rows, fmask [B, C] f32 (1:
    the node scans the feature), par [16] f32 (:func:`cat_params`).
    Returns [B, C, 16] f32."""
    dev = gh.device
    B = rows.shape[0]
    C = layout.C
    for name, v, shape, dt in (
            ("scal", scal, (B, SCAL_COLS), torch.float32),
            ("gh", gh, tuple(gh.shape), torch.float32),
            ("hh", hh, tuple(gh.shape), torch.float32),
            ("rows", rows, (B,), torch.int64),
            ("fmask", fmask, (B, C), torch.float32),
            ("par", par, (PAR_COLS,), torch.float32),
            ("meta", layout.meta, (3, C), torch.int32),
            ("penalty", layout.penalty, (C,), torch.float32)):
        if tuple(v.shape) != shape or v.dtype != dt or v.device != dev \
                or not v.is_contiguous():
            raise LightGBMError(
                "cat_scan: %s is %s %s on %s; expected contiguous %s %s on "
                "%s" % (name, tuple(v.shape), v.dtype, v.device, dt, shape,
                        dev))
    if gh.dim() != 2 or B < 1 or C < 1:
        raise LightGBMError("cat_scan: needs [R, TB] planes, B >= 1 nodes "
                            "and C >= 1 features (B=%d, C=%d)" % (B, C))
    if dev.type == "cpu":
        res = cat_scan_rows_plain(scal, gh, hh, rows, layout, fmask, par)
        counters.bump(dev, "cat_scan")
        return res
    if dev.type != "cuda":
        raise LightGBMError("cat_scan: no kernel for device %s" % dev)
    out = torch.empty((B, C, CAT_COLS), dtype=torch.float32, device=dev)
    _launch(scal, gh, hh, rows, layout, fmask, par, out)
    cat_scan.launches += 1
    return out


cat_scan.launches = 0


def cat_candidates(rec: np.ndarray, layout: CatLayout, scal: np.ndarray,
                   params, use_mc: bool):
    """The best categorical candidate of each node from the kernel's
    [B, C, 16] output, in numpy float32 as the JAX function assembles it
    (split.py:640-665): the first feature of the best gain, the right
    side as the node's sums minus the left, the outputs with that feature's
    l2. Returns dicts of SplitCandidate fields (gain -inf, feature -1: no
    categorical split)."""
    out = []
    gains = rec[:, :, 0]
    words = rec.view(np.uint32)[:, :, 8:]
    eps = F32(K_EPSILON)
    for b in range(rec.shape[0]):
        c = int(np.argmax(gains[b]))
        valid = bool(gains[b, c] > NEG_INF)
        lg, lh = rec[b, c, 1], rec[b, c, 2]
        lc = int(rec[b, c, 3])
        l2b = rec[b, c, 4]
        sg, sh, nd = scal[b, CS_SG], scal[b, CS_SH], int(scal[b, CS_ND])
        cmin, cmax = ((scal[b, CS_CMIN], scal[b, CS_CMAX]) if use_mc
                      else (F32(-np.inf), F32(np.inf)))
        rg, rh = F32(sg - lg), F32(sh - lh)
        with np.errstate(divide="ignore", invalid="ignore"):
            lo, ro = (F32(leaf_output(g_, h_, l2b, F32(params.lambda_l1),
                                      F32(params.max_delta_step), cmin,
                                      cmax, True, True, use_mc))
                      for g_, h_ in ((lg, lh), (rg, rh)))
        out.append(dict(
            gain=gains[b, c] if valid else F32(NEG_INF),
            feature=int(layout.feature[c]) if valid else -1,
            left_output=lo, right_output=ro, left_sum_grad=lg,
            left_sum_hess=F32(lh - eps), right_sum_grad=rg,
            right_sum_hess=F32(rh - eps), left_count=lc,
            right_count=nd - lc, cat_words=words[b, c].copy()))
    return out
