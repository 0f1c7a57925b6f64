"""Bundle-native best-split scan over the [G, 256] group planes.

The port of lightgbm_tpu/ops/pallas_scan.py: the ``BM_*`` mask rows
(:367-369), ``build_block_scan_meta`` (:560-620) and ``scan_blocks``
(:525, kernel ``_scan_blocks_kernel``:372), which the persistent grower
uses for EFB-bundled data: several features share one group plane, each
owning a window of lanes [ls, ls + nb), and the scan runs on the planes as
they are, without gathering a per-feature copy of each window.

:func:`scan_blocks` launches the CUDA kernel (``csrc/scan_blocks.cu``) for
tensors on the card and takes :func:`scan_blocks_plain`, the same function
in plain PyTorch, for tensors on the CPU. The kernel reads the grower's
[G * 256] plane rows in place through the children's rows
(:func:`scan_blocks_rows_plain` is that form's function), so the grower
pads and gathers nothing before a scan.

Per (child, group) the function computes, lane by lane:

  * FixHistogram (``do_fix``; src/io/dataset.cpp:1410): a needs-fix
    feature's histogram misses its most frequent bin (EFB stores those rows
    in the group's bin 0). Its most_freq lane receives ``x[mf] + (total -
    wsum)``, where wsum is the f32 window sum below and total is the child's
    sum (grad: scalar column 0; hess: the raw sum in column 8, without the
    2e-15 the scan adds); both operations round to f32. This runs before
    any prefix sum reads the lane.
  * Windowed prefix sums: a sequential f64 sum over the lanes, restarted at
    each window's first lane and rounded to f32 at every lane (the order of
    ``scan_pair``); a window's total is its prefix at its last lane.
    The TPU kernel takes whole-block f32 matmul prefix sums and recovers the
    windows with segmented nearest-seed fills, so against it the sums agree
    to f32 rounding.
  * The reverse and forward gains of ``scan_pair`` at every lane, each
    penalized ((gain - min_gain_shift) * penalty). REVERSE keeps the highest
    lane of the best penalized gain, forward the lowest, and forward wins
    only on a strictly greater gain. An exact tie across two features of a
    group therefore resolves by lane position (pallas_scan.py:321-327).

Outputs per (child, group), ``[B, 8, Gp]`` f32: the penalized gain (-inf
where nothing splits), the ABSOLUTE lane of the threshold, use_forward,
the left side's (grad, hess, count) there, has-split, 0. The caller takes
the first group of the maximum and recovers the feature from the owner map.
On a group holding a single feature the gains and the threshold equal
``scan_pair``'s for that feature.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.log import LightGBMError
from . import counters
from .scan import _round_up, check_done, check_out

# rows of the static mask stack (pallas_scan.py:367-369)
(BM_KEEP_R, BM_KEEP_F, BM_VALID_R, BM_VALID_F,
 BM_SEED_S, BM_SEED_E, BM_FIX, BM_PEN) = range(8)
BM_ROWS = 8
N_BLOCK_SCALARS = 9


def build_block_scan_meta(group_of, ls, nb, mt, db, mf, needs_fix,
                          penalty, G: int, W: int = 256):
    """The static per-lane mask stack of :func:`scan_blocks` (host numpy),
    derived once per payload geometry. Inputs are in feature order;
    feature f's bins sit at lanes [ls[f], ls[f] + nb[f]) of group
    group_of[f].

    Returns a dict: ``masks`` [BM_ROWS, Gp, Wp] f32, ``owner`` [Gp, Wp]
    i32 (the feature owning each lane, -1 for none), ``has_owner``
    [Gp, Wp] bool."""
    group_of, ls, nb, mt, db, mf = (np.asarray(a, np.int64) for a in
                                    (group_of, ls, nb, mt, db, mf))
    needs_fix = np.asarray(needs_fix, bool)
    penalty = np.asarray(penalty, np.float64)
    Gp = _round_up(max(G, 8), 8)
    Wp = _round_up(max(W, 128), 128)
    owner = np.full((Gp, Wp), -1, dtype=np.int32)
    for f in range(len(group_of)):
        owner[group_of[f], ls[f]:ls[f] + nb[f]] = f
    has_owner = owner >= 0
    o = np.where(has_owner, owner, 0)
    lane = np.arange(Wp, dtype=np.int64)[None, :]
    w_loc = lane - ls[o]
    nb_l, mt_l, db_l = nb[o], mt[o], db[o]

    two_scan = (nb_l > 2) & (mt_l != 0)
    skip_default = two_scan & (mt_l == 1)
    na_as_missing = two_scan & (mt_l == 2)
    is_na_bin = w_loc == nb_l - 1
    is_default_bin = w_loc == db_l

    excl_r = (na_as_missing & is_na_bin) | (skip_default & is_default_bin)
    excl_f = skip_default & is_default_bin
    valid_r = has_owner & (w_loc <= nb_l - 2 - na_as_missing.astype(np.int64))
    valid_r &= ~(skip_default & (w_loc == db_l - 1))
    valid_f = two_scan & has_owner & (w_loc <= nb_l - 2)
    valid_f &= ~(skip_default & is_default_bin)

    masks = np.zeros((BM_ROWS, Gp, Wp), np.float32)
    masks[BM_KEEP_R] = has_owner & ~excl_r
    masks[BM_KEEP_F] = has_owner & ~excl_f
    masks[BM_VALID_R] = valid_r
    masks[BM_VALID_F] = valid_f
    masks[BM_SEED_S] = has_owner & (w_loc == 0)
    masks[BM_SEED_E] = has_owner & is_na_bin        # the window's last lane
    masks[BM_FIX] = has_owner & needs_fix[o] & (w_loc == mf[o])
    masks[BM_PEN] = np.where(has_owner, penalty[o], 0.0)
    return {"masks": masks, "owner": owner, "has_owner": has_owner}


class BlockScanLayout:
    """The block scan's static layout of one payload geometry, on the
    device: the mask stack, the owner map, and what the grower needs to
    turn a (group, lane) back into a split of a feature."""

    def __init__(self, efb, penalty, G: int, device):
        group_of, ls, nb, mf, needs_fix, _, mt, db = efb
        meta = build_block_scan_meta(group_of, ls, nb, mt, db, mf, needs_fix,
                                     penalty, G)
        self.G = G
        self.Gp, self.Wp = meta["masks"].shape[1:]
        self.masks = torch.as_tensor(meta["masks"], device=device)
        self.owner = np.where(meta["has_owner"], meta["owner"], 0)
        self._owner_flat = torch.as_tensor(self.owner.reshape(-1).astype(
            np.int64), device=device)
        self._has_owner = torch.as_tensor(
            meta["has_owner"].astype(np.float32), device=device)
        self.ls = np.asarray(ls, np.int64)
        self.forced_right = (np.asarray(mt) == 2) & (np.asarray(nb) <= 2)
        self.do_fix = bool(np.asarray(needs_fix).any())

    def tree_masks(self, feature_mask) -> torch.Tensor:
        """The mask stack of one tree: the feature mask folded into the two
        valid rows (grow_persist.py:951-958), the rest shared."""
        fm = torch.as_tensor(np.asarray(feature_mask, np.float32),
                             device=self.masks.device)
        fm_lane = fm[self._owner_flat].reshape(self.Gp, self.Wp) \
            * self._has_owner
        out = self.masks.clone()
        out[BM_VALID_R:BM_VALID_F + 1] *= fm_lane
        return out


NEG_INF = float("-inf")


def _windowed_prefix(x, start):
    """[..., Gp, Wp] f32: inclusive prefix sums of x along the lanes, each
    a sequential f64 sum restarted at the lanes where ``start`` [Gp, Wp] is
    set and rounded to f32 at every lane (the kernel's arithmetic)."""
    out = torch.empty_like(x)
    acc = torch.zeros(x.shape[:-1], dtype=torch.float64, device=x.device)
    for w in range(x.shape[-1]):
        acc = torch.where(start[:, w], 0.0, acc) + x[..., w].double()
        out[..., w] = acc.float()
    return out


def _window_end(seed_e):
    """[Gp, Wp] i64: the last lane of the window holding each lane (the
    first window end at or after it; Wp - 1 past a group's last window)."""
    Wp = seed_e.shape[-1]
    lane = torch.arange(Wp, device=seed_e.device).expand_as(seed_e)
    idx = torch.where(seed_e > 0, lane, Wp - 1)
    return torch.flip(torch.cummin(torch.flip(idx, [-1]), dim=-1).values,
                      [-1])


def scan_blocks_plain(scal, gb, hb, masks, do_fix: bool):
    """[B, 8, Gp] f32: the kernel's function in plain PyTorch."""
    B, Gp, Wp = gb.shape
    s = scal[:, :, None, None]                               # [B, 9, 1, 1]
    sg, sh, nd, cf = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    min_data, min_hess, mgs, l2 = s[:, 4], s[:, 5], s[:, 6], s[:, 7]
    sh_raw = s[:, 8]
    keep_r, keep_f = masks[BM_KEEP_R], masks[BM_KEEP_F]
    valid_r, valid_f = masks[BM_VALID_R], masks[BM_VALID_F]
    start = masks[BM_SEED_S] > 0
    pen = masks[BM_PEN]
    wend = _window_end(masks[BM_SEED_E]).expand(B, Gp, Wp)

    def at_end(p):
        return torch.gather(p, 2, wend)

    if do_fix:
        fix = masks[BM_FIX] > 0
        pre = _windowed_prefix(torch.stack([gb, hb], 1), start)
        gb = torch.where(fix, gb + (sg - at_end(pre[:, 0])), gb)
        hb = torch.where(fix, hb + (sh_raw - at_end(pre[:, 1])), hb)

    cnt_b = torch.floor(hb * cf + 0.5)
    pre = _windowed_prefix(torch.stack(
        [gb * keep_r, hb * keep_r, cnt_b * keep_r,
         gb * keep_f, hb * keep_f, cnt_b * keep_f], 1), start)
    neg = torch.tensor(NEG_INF, dtype=gb.dtype, device=gb.device)
    wrow = torch.arange(Wp, device=gb.device, dtype=gb.dtype)

    r_grad = at_end(pre[:, 0]) - pre[:, 0]
    r_hess = at_end(pre[:, 1]) - pre[:, 1]
    r_cnt = at_end(pre[:, 2]) - pre[:, 2]
    l_cnt = nd - r_cnt
    l_grad = sg - r_grad
    l_hess = sh - r_hess
    ok_r = ((valid_r > 0) & (r_cnt >= min_data) & (r_hess >= min_hess)
            & (l_cnt >= min_data) & (l_hess >= min_hess))
    gains_r = (l_grad * l_grad) / (l_hess + l2) \
        + (r_grad * r_grad) / (r_hess + l2)
    ok_r &= gains_r > mgs
    pg_r = torch.where(ok_r, (gains_r - mgs) * pen, neg)
    best_gain_r = pg_r.amax(dim=2)
    at_max_r = ok_r & (pg_r == best_gain_r[..., None])
    best_t_r = torch.where(at_max_r, wrow, -1.0).amax(dim=2)

    f_l_grad, f_l_hess, f_l_cnt = pre[:, 3], pre[:, 4], pre[:, 5]
    f_r_cnt = nd - f_l_cnt
    f_r_grad = sg - f_l_grad
    f_r_hess = sh - f_l_hess
    ok_f = ((valid_f > 0) & (f_l_cnt >= min_data) & (f_l_hess >= min_hess)
            & (f_r_cnt >= min_data) & (f_r_hess >= min_hess))
    gains_f = (f_l_grad * f_l_grad) / (f_l_hess + l2) \
        + (f_r_grad * f_r_grad) / (f_r_hess + l2)
    ok_f &= gains_f > mgs
    pg_f = torch.where(ok_f, (gains_f - mgs) * pen, neg)
    big = 2.0 ** 30
    best_gain_f = pg_f.amax(dim=2)
    at_max_f = ok_f & (pg_f == best_gain_f[..., None])
    best_t_f = torch.where(at_max_f, wrow, big).amin(dim=2)

    has_r = best_t_r >= 0
    has_f = best_t_f < big
    bg_r = torch.where(has_r, best_gain_r, neg)
    bg_f = torch.where(has_f, best_gain_f, neg)
    use_f = bg_f > bg_r
    group_t = torch.where(use_f, best_t_f, best_t_r)
    has_any = has_r | has_f

    # the left side at the chosen lane (0 where no lane is chosen)
    t_idx = group_t.clamp(0, Wp - 1).long()[..., None]
    chosen = (group_t >= 0)

    def pick(f_val, r_val):
        v = torch.where(use_f, torch.gather(f_val, 2, t_idx)[..., 0],
                        torch.gather(r_val, 2, t_idx)[..., 0])
        return torch.where(chosen, v, torch.zeros_like(v))
    return torch.stack([
        torch.where(has_any, torch.where(use_f, bg_f, bg_r), neg), group_t,
        use_f.to(gb.dtype), pick(f_l_grad, l_grad), pick(f_l_hess, l_hess),
        pick(f_l_cnt, l_cnt), has_any.to(gb.dtype),
        torch.zeros_like(bg_r)], dim=1)


def scan_blocks_rows_plain(scal, gh, hh, rows, groups: int, masks,
                           do_fix: bool):
    """[B, 8, Gp] f32: :func:`scan_blocks_plain` of the children's [G * W]
    plane rows ``gh[rows]`` / ``hh[rows]``, each group's W lanes padded with
    zeros to Wp and the groups to Gp. The function of the kernel's rows
    form."""
    B = rows.shape[0]
    Gp, Wp = masks.shape[1:]
    W = gh.shape[1] // groups
    pad = (0, Wp - W, 0, Gp - groups)
    return scan_blocks_plain(
        scal, F.pad(gh[rows].reshape(B, groups, W), pad),
        F.pad(hh[rows].reshape(B, groups, W), pad), masks, do_fix)


def _bad(name, v, shape, dtype, device):
    raise LightGBMError(
        "scan_blocks: %s is %s %s on %s; expected contiguous %s %s on %s"
        % (name, tuple(v.shape), v.dtype, v.device, dtype, shape, device))


def _check(scal, g, h, masks, rows, groups):
    """(B, Gp, Wp, G, W) of a call, or raise on what the kernel does not
    take."""
    if (rows is None) != (groups is None):
        raise LightGBMError("scan_blocks: rows and groups go together")
    if masks.dim() != 3:
        raise LightGBMError("scan_blocks: masks must be [BM_ROWS, Gp, Wp]")
    Gp, Wp = masks.shape[1:]
    if rows is None:
        if g.dim() != 3:
            raise LightGBMError("scan_blocks: gb must be [B, Gp, Wp]")
        B, G, W = g.shape[0], Gp, Wp
        planes = (B, Gp, Wp)
    else:
        if g.dim() != 2 or rows.dim() != 1:
            raise LightGBMError("scan_blocks: the rows form takes gh/hh "
                                "[R, G * W] and rows [B]")
        B, G = rows.shape[0], int(groups)
        W = g.shape[1] // G if G > 0 else 0
        planes = tuple(g.shape)
        if not 0 < G <= Gp or G * W != g.shape[1] or not 0 < W <= Wp:
            raise LightGBMError(
                "scan_blocks: planes of %d lanes are not %d groups of at most "
                "Wp=%d lanes (Gp=%d)" % (g.shape[1], G, Wp, Gp))
        if rows.dtype != torch.int64 or not rows.is_contiguous() \
                or rows.device != g.device:
            _bad("rows", rows, (B,), torch.int64, g.device)
    want = {"scal": (B, N_BLOCK_SCALARS), "gb": planes, "hb": planes,
            "masks": (BM_ROWS, Gp, Wp)}
    for name, v in (("scal", scal), ("gb", g), ("hb", h), ("masks", masks)):
        if tuple(v.shape) != want[name] or v.dtype != torch.float32 \
                or not v.is_contiguous() or v.device != g.device:
            _bad(name, v, want[name], torch.float32, g.device)
    if Wp % 32 or not 32 <= Wp <= 1024:
        raise LightGBMError("scan_blocks: Wp=%d must be a multiple of 32 in "
                            "[32, 1024]" % Wp)
    if B < 1 or Gp < 1:
        raise LightGBMError("scan_blocks: empty batch (B=%d, Gp=%d)"
                            % (B, Gp))
    return B, Gp, Wp, G, W


def _launch(scal, g, h, masks, do_fix, rows, B, Gp, Wp, G, W, out, done):
    from .build import load
    fn = load("scan_blocks").scan_blocks_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, I, P, I, I, I, I, P, P, P, P]
    fn.restype = I
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(scal.data_ptr(), g.data_ptr(), h.data_ptr(),
             None if rows is None else rows.data_ptr(), G, W,
             masks.data_ptr(), int(do_fix), B, Gp, Wp, out.data_ptr(),
             None if done is None else done.data_ptr(),
             counters.ptr(g.device, "scan_blocks"), stream)
    if err != 0:
        raise LightGBMError("scan_blocks kernel launch failed: CUDA error %d"
                            % err)
    return out


def scan_blocks(scal, g, h, masks, do_fix: bool, rows=None, groups=None,
                out=None, done=None):
    """Best split per group for B children: the CUDA kernel for tensors on
    the card, the plain version for tensors on the CPU.

    Two forms of one contract. With ``rows`` and ``groups``, g/h are the
    grower's [R, G * W] histogram planes (G = groups, W <= Wp), rows [B]
    int64 the children's plane rows; the kernel reads them in place, groups
    past G and lanes past W as zeros, and the function is
    :func:`scan_blocks_rows_plain`. Without, g/h are [B, Gp, Wp] planes
    already gathered and padded, and the function is
    :func:`scan_blocks_plain`. scal [B, 9] f32 (``pair_scalars``' 8
    columns and the raw hessian sum); masks [BM_ROWS, Gp, Wp] (a
    :meth:`BlockScanLayout.tree_masks` stack). Returns [B, 8, Gp] f32,
    written to ``out`` where given. The scalars and rows are read on the
    device, and with ``done`` (int64 [1]) set nothing is written. The
    caller keeps rows inside the planes (the kernel does not check them)."""
    B, Gp, Wp, G, W = _check(scal, g, h, masks, rows, groups)
    if out is not None:
        check_out("scan_blocks", out, (B, 8, Gp), g.device)
    check_done("scan_blocks", done, g.device)
    if g.device.type == "cpu":
        if done is not None and int(done[0]):
            return out
        if rows is None:
            res = scan_blocks_plain(scal, g, h, masks, do_fix)
        else:
            res = scan_blocks_rows_plain(scal, g, h, rows, G, masks, do_fix)
        counters.bump(g.device, "scan_blocks")
        return res if out is None else out.copy_(res)
    if g.device.type != "cuda":
        raise LightGBMError("scan_blocks: no kernel for device %s" % g.device)
    if out is None:
        out = torch.empty((B, 8, Gp), dtype=torch.float32, device=g.device)
    _launch(scal, g, h, masks, do_fix, rows, B, Gp, Wp, G, W, out, done)
    scan_blocks.launches += 1
    return out


scan_blocks.launches = 0
