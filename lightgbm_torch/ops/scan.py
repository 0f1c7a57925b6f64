"""Fused best-split scan for a batch of children.

The port of lightgbm_tpu/ops/pallas_scan.py: :class:`ScanLayout` (the
per-tree masks, pallas_scan.py:623-690) and ``scan_pair``
(pallas_scan.py:262, kernel ``_scan_kernel:128``), in two forms of f32
arithmetic:

  * the fast form, the Pallas kernel's: L2 regularization only;
  * the knob form, the JAX package's general scan for the same f32 sums
    (``find_best_split_numerical``, lightgbm_tpu/ops/split.py:241):
    ``lambda_l1``, ``max_delta_step`` and monotone constraints in the gains
    (ops/split.py:split_gains), each child's monotone bounds, and two
    per-(child, feature) inputs ``node`` [B, 2, Fp]: the extra_trees
    threshold (row 0; only that lane may split, -1 = any lane) and the
    feature_fraction_bynode mask (row 1). It takes a [B, 16] scalar block
    (:func:`knob_scalars`) and the features' monotone signs in ``aux``
    row 1. Like the fast form, and unlike the JAX general scan, it adds no
    kEpsilon to the sides' hessian sums (a no-op in f32 but for a side
    whose hessians are all zero, which min_sum_hessian_in_leaf refuses).

:func:`scan_pair` launches the CUDA kernel (``csrc/scan_pair.cu``) for
tensors on the card and takes :func:`scan_pair_plain`, the same function in
plain PyTorch, for tensors on the CPU. The kernel reads the grower's
histogram planes through the children's rows and the layout's ``gidx``
itself (:func:`scan_pair_rows_plain` is that form's function), so the
grower gathers nothing before a scan.

Outputs per (child, feature), ``[B, 8, Fp]``: penalized gain (-inf when the
feature cannot split), local threshold, direction (1 = forward), the left
side's (grad, hess, count) at that threshold, and a has-split flag.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import counters
from .split import K_EPSILON, leaf_gain, split_gains

NEG_INF = float("-inf")


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class ScanLayout:
    """Per-tree dense layout + masks for the fused scan, built on the host
    from the feature metadata and the tree's feature mask, then held on
    the device. Mirrors the mask derivations of ops/split.py's
    find_best_split_numerical in the JAX package."""

    def __init__(self, bin_start, bin_end, missing_type, default_bin,
                 penalty, feature_mask, W: int, tb: int, device,
                 monotone=None):
        F = len(bin_start)
        self.F = F
        self.W = W
        self.Fp = Fp = _round_up(max(F, 8), 8)
        self.Wp = Wp = _round_up(max(W, 128), 128)
        pad = Fp - F

        def col(a, dt=np.int64):
            return np.pad(np.asarray(a, dt), (0, pad))[:, None]
        start = col(bin_start)
        nb = col(np.asarray(bin_end) - np.asarray(bin_start))
        mt = col(missing_type)
        d_local = col(default_bin)
        fmask = np.pad(np.asarray(feature_mask, bool), (0, pad))
        w = np.arange(Wp, dtype=np.int64)[None, :]
        in_feat = (w >= 0) & (w < nb)

        two_scan = (nb > 2) & (mt != 0)
        skip_default = two_scan & (mt == 1)
        na_as_missing = two_scan & (mt == 2)
        is_na_bin = w == (nb - 1)
        is_default_bin = w == d_local

        excl_r = (na_as_missing & is_na_bin) | (skip_default & is_default_bin)
        excl_f = skip_default & is_default_bin
        keep_r = in_feat & ~excl_r
        keep_f = in_feat & ~excl_f
        valid_r = in_feat & (w <= nb - 2 - na_as_missing.astype(np.int64))
        valid_r &= ~(skip_default & (w == d_local - 1))
        valid_r &= fmask[:, None]
        valid_f = two_scan & in_feat & (w <= nb - 2)
        valid_f &= ~(skip_default & is_default_bin)
        valid_f &= fmask[:, None]

        def f32(a):
            return torch.as_tensor(np.ascontiguousarray(a, np.float32),
                                   device=device)
        self.gidx = torch.as_tensor(np.clip(start + w, 0, tb - 1),
                                    device=device)              # [Fp, Wp]
        self.keep_r = f32(keep_r)
        self.keep_f = f32(keep_f)
        self.valid_r = f32(valid_r)
        self.valid_f = f32(valid_f)
        aux = np.zeros((8, Fp), np.float32)
        aux[0, :F] = np.asarray(penalty, np.float32)
        if monotone is not None:            # the knob form's signs
            aux[1, :F] = np.sign(np.asarray(monotone, np.float32))
        self.aux = f32(aux)
        # NaN-missing features of <= 2 bins never default left
        # (feature_histogram.hpp:205)
        nb1 = np.asarray(bin_end) - np.asarray(bin_start)
        self.forced_right = np.pad(
            (np.asarray(missing_type) == 2) & (nb1 <= 2), (0, pad))


def pair_scalars(sum_grad, sum_hess, count, lambda_l2: float,
                 min_gain_to_split: float, min_data_in_leaf: int,
                 min_sum_hessian_in_leaf: float) -> np.ndarray:
    """The [B, 8] f32 scalar block of a batch of children, in f32 exactly
    as the JAX grower builds it (ops/grow.py:590-608). This is where the
    general scan's sum_hess + 2*kEpsilon goes: not a no-op when a child's
    hessians are all zero (it keeps cnt_factor finite)."""
    f32 = np.float32
    sg = np.asarray(sum_grad, f32)
    sh = np.asarray(sum_hess, f32) + f32(2 * K_EPSILON)
    cnt = np.asarray(count, f32)
    l2 = f32(lambda_l2)
    with np.errstate(divide="ignore", invalid="ignore"):
        cf = cnt / sh
        mgs = leaf_gain(sg, sh, l2) + f32(min_gain_to_split)
    B = sg.shape[0]
    return np.stack([sg, sh, cnt, cf,
                     np.full(B, f32(min_data_in_leaf)),
                     np.full(B, f32(min_sum_hessian_in_leaf)),
                     mgs, np.full(B, l2)], axis=1).astype(f32)


KNOB_COLS = 16


def knob_scalars(sum_grad, sum_hess, count, params, cmin, cmax,
                 use_mc: bool) -> np.ndarray:
    """The knob form's [B, 16] f32 scalar block: :func:`pair_scalars`'s
    eight columns, with the gain shift the general scan's (the parent's
    leaf_gain under L1 and max_delta_step, lightgbm_tpu/ops/split.py:
    275-277), then lambda_l1, max_delta_step, each child's monotone bounds
    cmin and cmax, and the use_mc switch (1: the gains of the clamped
    outputs and the bad-split rule)."""
    f32 = np.float32
    out = np.zeros((len(np.atleast_1d(sum_grad)), KNOB_COLS), f32)
    out[:, :8] = pair_scalars(sum_grad, sum_hess, count, params.lambda_l2,
                              params.min_gain_to_split,
                              params.min_data_in_leaf,
                              params.min_sum_hessian_in_leaf)
    sg, sh = out[:, 0], out[:, 1]
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        out[:, 6] = leaf_gain(sg, sh, f32(params.lambda_l2),
                              f32(params.lambda_l1),
                              f32(params.max_delta_step), params.use_l1,
                              params.use_mds) + f32(params.min_gain_to_split)
    out[:, 8] = f32(params.lambda_l1)
    out[:, 9] = f32(params.max_delta_step)
    out[:, 10] = np.asarray(cmin, f32)
    out[:, 11] = np.asarray(cmax, f32)
    out[:, 12] = f32(1.0 if use_mc else 0.0)
    return out


def _knob_gains(lg, lh, rg, rh, s, mono):
    """The knob form's split gains of every lane: ops/split.py:split_gains
    with L1 and the max_delta_step switch on (both are exact identities at
    lambda_l1 = 0 and max_delta_step = 0), with or without the monotone
    clamp by the child's use_mc column."""
    l2, l1, mds, cmin, cmax = s[:, 7], s[:, 8], s[:, 9], s[:, 10], s[:, 11]
    plain = split_gains(lg, lh, rg, rh, l2, l1, mds, cmin, cmax, mono,
                        True, True, False)
    clamped = split_gains(lg, lh, rg, rh, l2, l1, mds, cmin, cmax, mono,
                          True, True, True)
    return torch.where(s[:, 12] > 0, clamped, plain)


def _prefix(x):
    """Inclusive prefix sums along the lanes, accumulated in f64 and
    rounded to f32 at every lane: on the CPU a sequential f64 sum, the
    CUDA kernel's arithmetic bit for bit."""
    return torch.cumsum(x.double(), dim=2).float()


def scan_pair_plain(scal, gb, hb, keep_r, keep_f, valid_r, valid_f, aux,
                    node=None):
    """[B, 8, Fp] f32: the kernel's function in plain PyTorch (the math of
    the JAX package's _scan_kernel; with ``node``, the knob form's)."""
    B, Fp, Wp = gb.shape
    s = scal[:, :, None, None]                               # [B, S, 1, 1]
    sg, sh, nd, cf = s[:, 0], s[:, 1], s[:, 2], s[:, 3]
    min_data, min_hess, mgs, l2 = s[:, 4], s[:, 5], s[:, 6], s[:, 7]
    cnt_b = torch.floor(hb * cf + 0.5)
    gr_c = _prefix(gb * keep_r)
    hr_c = _prefix(hb * keep_r)
    cr_c = _prefix(cnt_b * keep_r)
    gl_c = _prefix(gb * keep_f)
    hl_c = _prefix(hb * keep_f)
    cl_c = _prefix(cnt_b * keep_f)
    neg = torch.tensor(NEG_INF, dtype=gb.dtype, device=gb.device)

    gr_tot, hr_tot, cr_tot = gr_c[..., -1:], hr_c[..., -1:], cr_c[..., -1:]
    r_grad = gr_tot - gr_c
    r_hess = hr_tot - hr_c
    r_cnt = cr_tot - cr_c
    l_cnt = nd - r_cnt
    l_grad = sg - r_grad
    l_hess = sh - r_hess
    wrow = torch.arange(Wp, device=gb.device, dtype=gb.dtype)
    vr, vf = valid_r > 0, valid_f > 0
    if node is not None:
        # extra_trees: only the drawn lane; by-node: the node's features
        rb = node[:, 0, :, None]
        at = ((rb < 0) | (wrow == rb)) & (node[:, 1, :, None] > 0)
        vr, vf = vr & at, vf & at
        mono = aux[1][None, :, None]

    ok_r = (vr & (r_cnt >= min_data) & (r_hess >= min_hess)
            & (l_cnt >= min_data) & (l_hess >= min_hess))
    if node is None:
        gains_r = (l_grad * l_grad) / (l_hess + l2) \
            + (r_grad * r_grad) / (r_hess + l2)
    else:
        gains_r = _knob_gains(l_grad, l_hess, r_grad, r_hess, s, mono)
    ok_r &= gains_r > mgs
    gains_r = torch.where(ok_r, gains_r, neg)

    best_gain_r = gains_r.amax(dim=2)                        # [B, Fp]
    at_max_r = ok_r & (gains_r == best_gain_r[..., None])
    best_t_r = torch.where(at_max_r, wrow, -1.0).amax(dim=2)

    f_r_cnt = nd - cl_c
    f_r_grad = sg - gl_c
    f_r_hess = sh - hl_c
    ok_f = (vf & (cl_c >= min_data) & (hl_c >= min_hess)
            & (f_r_cnt >= min_data) & (f_r_hess >= min_hess))
    if node is None:
        gains_f = (gl_c * gl_c) / (hl_c + l2) \
            + (f_r_grad * f_r_grad) / (f_r_hess + l2)
    else:
        gains_f = _knob_gains(gl_c, hl_c, f_r_grad, f_r_hess, s, mono)
    ok_f &= gains_f > mgs
    gains_f = torch.where(ok_f, gains_f, neg)

    big = 2.0 ** 30
    best_gain_f = gains_f.amax(dim=2)
    at_max_f = ok_f & (gains_f == best_gain_f[..., None])
    best_t_f = torch.where(at_max_f, wrow, big).amin(dim=2)

    has_r = best_t_r >= 0
    has_f = best_t_f < big
    best_gain_r = torch.where(has_r, best_gain_r, neg)
    best_gain_f = torch.where(has_f, best_gain_f, neg)
    use_f = best_gain_f > best_gain_r
    feat_gain = torch.where(use_f, best_gain_f, best_gain_r)
    feat_t = torch.where(use_f, best_t_f, best_t_r)
    has_any = has_r | has_f

    sel = (wrow == feat_t[..., None]).to(gb.dtype)
    sg2, sh2, nd2, mgs2 = sg[..., 0], sh[..., 0], nd[..., 0], mgs[..., 0]
    lg = torch.where(use_f, (gl_c * sel).sum(2),
                     sg2 - (gr_tot[..., 0] - (gr_c * sel).sum(2)))
    lh = torch.where(use_f, (hl_c * sel).sum(2),
                     sh2 - (hr_tot[..., 0] - (hr_c * sel).sum(2)))
    lc = torch.where(use_f, (cl_c * sel).sum(2),
                     nd2 - (cr_tot[..., 0] - (cr_c * sel).sum(2)))
    gain_out = torch.where(has_any, (feat_gain - mgs2) * aux[0][None, :], neg)
    return torch.stack([gain_out, feat_t, use_f.to(gb.dtype), lg, lh, lc,
                        has_any.to(gb.dtype), torch.zeros_like(lg)], dim=1)


def scan_pair_rows_plain(scal, gh, hh, rows, gidx, keep_r, keep_f, valid_r,
                         valid_f, aux, node=None):
    """[B, 8, Fp] f32: :func:`scan_pair_plain` of the children's planes read
    through the index maps: child c's lane w of feature f is
    gh[rows[c], gidx[f, w]]. The function of the kernel's rows/gidx form."""
    return scan_pair_plain(scal, gh[rows][:, gidx], hh[rows][:, gidx],
                           keep_r, keep_f, valid_r, valid_f, aux, node)


def _fail(name, v, shape, dtype, device):
    raise LightGBMError(
        "scan_pair: %s is %s %s on %s; expected contiguous %s %s on %s"
        % (name, tuple(v.shape), v.dtype, v.device, dtype, shape, device))


def _check(scal, g, h, keep_r, keep_f, valid_r, valid_f, aux, rows, gidx,
           node=None):
    """(B, Fp, Wp) of a call, or raise on what the kernel does not take."""
    if (rows is None) != (gidx is None):
        raise LightGBMError("scan_pair: rows and gidx go together")
    if rows is None:
        if g.dim() != 3:
            raise LightGBMError("scan_pair: gb must be [B, Fp, Wp]")
        B, Fp, Wp = g.shape
        planes = (B, Fp, Wp)
    else:
        if g.dim() != 2 or rows.dim() != 1 or gidx.dim() != 2:
            raise LightGBMError("scan_pair: the rows form takes gh/hh "
                                "[R, TBp], rows [B] and gidx [Fp, Wp]")
        B, (Fp, Wp) = rows.shape[0], gidx.shape
        planes = tuple(g.shape)
        for name, v, shape in (("rows", rows, (B,)),
                               ("gidx", gidx, (Fp, Wp))):
            if tuple(v.shape) != shape or v.dtype != torch.int64 \
                    or not v.is_contiguous() or v.device != g.device:
                _fail(name, v, shape, torch.int64, g.device)
    want = {"scal": (B, 8 if node is None else KNOB_COLS), "gb": planes,
            "hb": planes, "keep_r": (Fp, Wp), "keep_f": (Fp, Wp),
            "aux": (8, Fp), "node": (B, 2, Fp)}
    got = {"scal": scal, "gb": g, "hb": h, "keep_r": keep_r,
           "keep_f": keep_f, "aux": aux, "valid_r": valid_r,
           "valid_f": valid_f}
    if node is not None:
        got["node"] = node
    for name, v in got.items():
        shape = want.get(name)
        if shape is None:
            ok = tuple(v.shape) in ((Fp, Wp), (B, Fp, Wp))
        else:
            ok = tuple(v.shape) == shape
        if not ok or v.dtype != torch.float32 or not v.is_contiguous() \
                or v.device != g.device:
            _fail(name, v, shape or "(Fp, Wp) or (B, Fp, Wp)", torch.float32,
                  g.device)
    if tuple(valid_r.shape) != tuple(valid_f.shape):
        raise LightGBMError("scan_pair: valid_r and valid_f differ in shape")
    if Wp % 32 or not 32 <= Wp <= 1024:
        raise LightGBMError("scan_pair: Wp=%d must be a multiple of 32 in "
                            "[32, 1024]" % Wp)
    if B < 1 or Fp < 1:
        raise LightGBMError("scan_pair: empty batch (B=%d, Fp=%d)" % (B, Fp))
    return B, Fp, Wp


def _launch(scal, g, h, keep_r, keep_f, valid_r, valid_f, aux, rows, gidx,
            B, Fp, Wp, out, done, node=None):
    from .build import load
    fn = load("scan_pair").scan_pair_launch
    P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    fn.argtypes = [P, P, P, P, P, L, P, P, P, P, I, P, P, I, I, I, P, P, P,
                   P]
    fn.restype = I
    stream = torch.cuda.current_stream(g.device).cuda_stream
    err = fn(scal.data_ptr(), g.data_ptr(), h.data_ptr(),
             None if rows is None else rows.data_ptr(),
             None if gidx is None else gidx.data_ptr(),
             Fp * Wp if rows is None else g.shape[1],
             keep_r.data_ptr(), keep_f.data_ptr(), valid_r.data_ptr(),
             valid_f.data_ptr(), int(valid_r.dim() == 3), aux.data_ptr(),
             None if node is None else node.data_ptr(),
             B, Fp, Wp, out.data_ptr(),
             None if done is None else done.data_ptr(),
             counters.ptr(g.device, "scan_pair" if node is None
                          else "scan_pair_knob"), stream)
    if err != 0:
        raise LightGBMError("scan_pair kernel launch failed: CUDA error %d"
                            % err)
    return out


def check_out(name, out, shape, dev):
    """The preallocated output (float32 `shape` on `dev`) and done flag
    (int64 [1]) of a scan's device form."""
    if tuple(out.shape) != tuple(shape) or out.dtype != torch.float32 \
            or out.device != dev or not out.is_contiguous():
        raise LightGBMError("%s: out is %s %s on %s; expected contiguous "
                            "float32 %s on %s" % (name, tuple(out.shape),
                                                   out.dtype, out.device,
                                                   tuple(shape), dev))


def check_done(name, done, dev):
    if done is not None and (tuple(done.shape) != (1,)
                             or done.dtype != torch.int64
                             or done.device != dev):
        raise LightGBMError("%s: done must be an int64 [1] tensor on %s"
                            % (name, dev))


def scan_pair(scal, g, h, keep_r, keep_f, valid_r, valid_f, aux, rows=None,
              gidx=None, out=None, done=None, node=None):
    """Best split per feature for B children: the CUDA kernel for tensors
    on the card, the plain version for tensors on the CPU.

    Two forms of one contract. With ``rows`` and ``gidx``, g/h are the
    grower's [R, TBp] histogram planes, rows [B] int64 the children's plane
    rows and gidx [Fp, Wp] int64 each feature's lanes (``ScanLayout.gidx``);
    the kernel reads the planes through them, and the function is
    :func:`scan_pair_rows_plain`. Without, g/h are [B, Fp, Wp] planes
    already gathered (rows = arange(B), gidx the identity), and the function
    is :func:`scan_pair_plain`. scal [B, 8] (see :func:`pair_scalars`);
    keep masks [Fp, Wp]; valid masks [Fp, Wp] shared or [B, Fp, Wp]; aux
    [8, Fp] with the penalty in row 0. With ``node`` [B, 2, Fp] f32 the
    knob form runs instead (its own kernel instantiation and launch count,
    ``scan_pair_knob``): scal [B, 16] (:func:`knob_scalars`), the monotone
    signs in aux row 1. Returns [B, 8, Fp] f32, written to
    ``out`` where given. The scalars and rows are read on the device (the
    persistent grower's step kernels write them there), and with ``done``
    (int64 [1]) set nothing is written. The caller keeps rows inside the
    planes (the kernel does not check them).
    """
    B, Fp, Wp = _check(scal, g, h, keep_r, keep_f, valid_r, valid_f, aux,
                       rows, gidx, node)
    if out is not None:
        check_out("scan_pair", out, (B, 8, Fp), g.device)
    check_done("scan_pair", done, g.device)
    slot = "scan_pair" if node is None else "scan_pair_knob"
    if g.device.type == "cpu":
        if done is not None and int(done[0]):
            return out
        if rows is None:
            res = scan_pair_plain(scal, g, h, keep_r, keep_f, valid_r,
                                  valid_f, aux, node)
        else:
            res = scan_pair_rows_plain(scal, g, h, rows, gidx, keep_r, keep_f,
                                       valid_r, valid_f, aux, node)
        counters.bump(g.device, slot)
        return res if out is None else out.copy_(res)
    if g.device.type != "cuda":
        raise LightGBMError("scan_pair: no kernel for device %s" % g.device)
    if out is None:
        out = torch.empty((B, 8, Fp), dtype=torch.float32, device=g.device)
    _launch(scal, g, h, keep_r, keep_f, valid_r, valid_f, aux, rows, gidx,
            B, Fp, Wp, out, done, node)
    scan_pair.launches += 1
    return out


scan_pair.launches = 0
