"""The ranking objectives' per-query gradient passes, on the device.

No Pallas counterpart: the JAX package computes both in jnp outside any
Pallas kernel (lightgbm_tpu/objectives/rank.py:120-216, LambdaRank-NDCG's
pairwise core ``one_query``; :383-415, XE-NDCG's ``grad_fn``). Here each is
one hand-written CUDA kernel (``csrc/rank_grad.cu``) over queries that are
contiguous row ranges (a :class:`QueryPlan`), with a plain PyTorch version
beside it that computes the same function in the same order:

  * :func:`lambdarank_grad`: for each row, the pair terms against every
    other row of its query summed in increasing row order, in f64; the
    rows' ranks from comparisons (no sort); rounded once to f32;
  * :func:`xendcg_grad`: for each query, sequential f64 sums in row order.

The plain versions pad the queries of each length class (lengths in
(2^(b-1), 2^b]) to that class's longest and loop over the padded positions
with vector operations over the class's queries; a padded position adds
nothing (an f64 sum that starts at +0.0 never holds -0.0, so adding 0.0
leaves it unchanged). The wrappers take the plain versions only for
tensors on the CPU; on the card they launch the kernel, and a build or
launch failure raises.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Tuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import counters

# csrc/rank_grad.cu: rows of a query staged in shared memory
LR_SMEM_ROWS = 1024
K_EPSILON = 1e-15


class QueryPlan:
    """Query boundaries on one device: ``qb`` [Q + 1] int32, the longest
    query (``max_len``) and, built on first use by the plain versions, the
    queries bucketed by length (:meth:`buckets`)."""

    def __init__(self, query_boundaries, device):
        qb = np.asarray(query_boundaries, dtype=np.int64)
        self.num_queries = len(qb) - 1
        self.num_data = int(qb[-1]) if len(qb) else 0
        counts = np.diff(qb)
        self.max_len = int(counts.max()) if self.num_queries else 0
        self.qb = torch.as_tensor(qb.astype(np.int32), device=device)
        self.device = self.qb.device
        self._host = qb
        self._buckets = None

    def buckets(self) -> List[Tuple[torch.Tensor, torch.Tensor,
                                    torch.Tensor]]:
        """[(query ids [Qb] int64, row index [Qb, P] int64 (0 where
        padded), valid [Qb, P] bool)], one per length class."""
        if self._buckets is None:
            qb = self._host
            counts = np.diff(qb)
            cls = np.zeros(len(counts), dtype=np.int64)
            pos = counts > 0
            cls[pos] = np.ceil(np.log2(counts[pos])).astype(np.int64)
            out = []
            for b in np.unique(cls[pos]):
                qids = np.nonzero(pos & (cls == b))[0]
                P = int(counts[qids].max())
                ar = np.arange(P)
                valid = ar[None, :] < counts[qids][:, None]
                idx = np.where(valid, qb[qids][:, None] + ar[None, :], 0)
                out.append(tuple(torch.as_tensor(a, device=self.device)
                                 for a in (qids, idx, valid)))
            self._buckets = out
        return self._buckets


def _pair_terms(d, gap, pd, inv, use_norm, sigmoid: float):
    """The pair terms of csrc/rank_grad.cu:pair_terms, elementwise."""
    delta = gap * pd
    delta = delta * inv
    delta = torch.where(use_norm, delta / (0.01 + torch.abs(d)), delta)
    p = 1.0 / (1.0 + torch.exp(d * sigmoid))
    hp = p * (1.0 - p)
    pl = (-sigmoid) * delta
    pl = pl * p
    ph = (sigmoid * sigmoid) * delta
    ph = ph * hp
    return pl, ph


def lambdarank_grad_plain(score, label, gain, inv_max_dcg, disc, weight,
                          plan: QueryPlan, sigmoid: float, norm: bool, g, h):
    """The kernel's function in plain PyTorch (the module docstring)."""
    zero = torch.zeros((), dtype=torch.float64, device=score.device)
    for qids, idx, valid in plan.buckets():
        P = idx.shape[1]
        s = score[idx]
        lab = label[idx]
        gn = gain[idx]
        ar = torch.arange(P, device=score.device)
        rank = torch.zeros(idx.shape, dtype=torch.int64, device=score.device)
        for j in range(P):
            sj = s[:, j:j + 1]
            before = (sj > s) | ((sj == s) & (j < ar))
            rank += (before & valid[:, j:j + 1]).to(torch.int64)
        dsc = disc[torch.where(valid, rank, 0)]
        best = torch.where(valid, s, -torch.inf).amax(1, keepdim=True)
        worst = torch.where(valid, s, torch.inf).amin(1, keepdim=True)
        use_norm = (best != worst) & bool(norm)
        inv = inv_max_dcg[qids][:, None]
        A = torch.zeros(idx.shape, dtype=torch.float64, device=score.device)
        B, C, D = A.clone(), A.clone(), A.clone()
        for j in range(P):
            sj, gj, dj = s[:, j:j + 1], gn[:, j:j + 1], dsc[:, j:j + 1]
            lj, vj = lab[:, j:j + 1], valid[:, j:j + 1] & valid
            hi = vj & (lab > lj)
            pl, ph = _pair_terms(s - sj, gn - gj, torch.abs(dsc - dj), inv,
                                 use_norm, sigmoid)
            A += torch.where(hi, pl, zero)
            C += torch.where(hi, ph, zero)
            lo = vj & (lj > lab)
            pl, ph = _pair_terms(sj - s, gj - gn, torch.abs(dj - dsc), inv,
                                 use_norm, sigmoid)
            B += torch.where(lo, pl, zero)
            D += torch.where(lo, ph, zero)
        lam = A - B
        hs = C + D
        if norm:
            tot = torch.zeros(len(qids), dtype=torch.float64,
                              device=score.device)
            for i in range(P):
                tot = tot + A[:, i]
            sl = (-2.0 * tot)[:, None]
            factor = torch.where(sl > 0.0, torch.log2(1.0 + sl) / sl,
                                 torch.ones_like(sl))
            lam = lam * factor
            hs = hs * factor
        if weight is not None:
            w = weight[idx].double()
            lam = lam * w
            hs = hs * w
        rows = idx[valid]
        g[rows] = lam[valid].float()
        h[rows] = hs[valid].float()
    counters.bump(score.device, "lambdarank_grad")


def xendcg_grad_plain(score, label, rnd, weight, plan: QueryPlan, g, h):
    """The kernel's function in plain PyTorch (the module docstring)."""
    zero = torch.zeros((), dtype=torch.float64, device=score.device)
    for qids, idx, valid in plan.buckets():
        P = idx.shape[1]
        s = score[idx]
        mx = torch.where(valid, s, -torch.inf).amax(1, keepdim=True)
        e = torch.exp(s - mx)
        # 2^floor(label), exact: the exponent's bits (ldexp in the kernel)
        k = torch.floor(label[idx].double()).to(torch.int64)
        phi = ((k + 1023) << 52).view(torch.float64) - rnd[idx]
        se = torch.zeros(len(qids), dtype=torch.float64, device=score.device)
        sp = se.clone()
        for r in range(P):
            se = se + torch.where(valid[:, r], e[:, r], zero)
            sp = sp + torch.where(valid[:, r], phi[:, r], zero)
        sum_labels = torch.clamp_min(sp, K_EPSILON)[:, None]
        rho = e / se[:, None]
        l1 = -phi / sum_labels + rho
        s1 = torch.zeros_like(se)
        for r in range(P):
            s1 = s1 + torch.where(valid[:, r], l1[:, r], zero)
        l2 = (s1[:, None] - l1) / (1.0 - rho)
        s2 = torch.zeros_like(se)
        for r in range(P):
            s2 = s2 + torch.where(valid[:, r], l2[:, r], zero)
        l3 = (s2[:, None] - l2) / (1.0 - rho)
        lam = torch.where(valid.sum(1, keepdim=True) <= 1, l1,
                          (l1 + rho * l2) + (rho * rho) * l3)
        hs = rho * (1.0 - rho)
        if weight is not None:
            w = weight[idx].double()
            lam = lam * w
            hs = hs * w
        rows = idx[valid]
        g[rows] = lam[valid].float()
        h[rows] = hs[valid].float()
    counters.bump(score.device, "xendcg_grad")


def _ptr(t: Optional[torch.Tensor]) -> ctypes.c_void_p:
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(name, t, dtype, n, what):
    if t.dtype != dtype or t.dim() != 1 or not t.is_contiguous() \
            or (n is not None and t.shape[0] != n):
        raise LightGBMError("%s: %s must be a contiguous [%s] %s tensor"
                            % (name, what, "n" if n is not None else "m",
                               str(dtype).replace("torch.", "")))


def _outputs(name, score, plan):
    """The (g, h) f32 outputs of a pass over `plan`'s queries."""
    dev = score.device
    if plan.device != dev:
        raise LightGBMError("%s: the query plan is on %s, the scores on %s"
                            % (name, plan.device, dev))
    n = score.shape[0]
    if plan.num_data != n:
        raise LightGBMError("%s: the queries cover %d rows, the scores %d"
                            % (name, plan.num_data, n))
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("%s: no kernel for device %s" % (name, dev))
    return (torch.empty(n, dtype=torch.float32, device=dev),
            torch.empty(n, dtype=torch.float32, device=dev))


def lambdarank_grad(score, label, gain, inv_max_dcg, disc, weight,
                    plan: QueryPlan, sigmoid: float, norm: bool):
    """LambdaRank-NDCG's (grad, hess), f32 [n] in row order, from the f64
    [n] row-ordered scores: label [n] int32, gain [n] f64 (the label gain
    of each row), inv_max_dcg [Q] f64, disc [>= plan.max_len] f64 (the
    discount of each rank), weight [n] f32 or None, the queries of `plan`.
    One launch for tensors on the card; the plain version for tensors on
    the CPU."""
    name = "lambdarank_grad"
    n = score.shape[0]
    _check(name, score, torch.float64, n, "score")
    _check(name, label, torch.int32, n, "label")
    _check(name, gain, torch.float64, n, "gain")
    _check(name, inv_max_dcg, torch.float64, plan.num_queries,
           "inv_max_dcg")
    _check(name, disc, torch.float64, None, "disc")
    if disc.shape[0] < plan.max_len:
        raise LightGBMError("%s: %d discounts for a query of %d rows"
                            % (name, disc.shape[0], plan.max_len))
    if weight is not None:
        _check(name, weight, torch.float32, n, "weight")
    g, h = _outputs(name, score, plan)
    dev = score.device
    if any(t is not None and t.device != dev
           for t in (label, gain, inv_max_dcg, disc, weight)):
        raise LightGBMError("%s: operands on different devices" % name)
    if dev.type == "cpu":
        lambdarank_grad_plain(score, label, gain, inv_max_dcg, disc, weight,
                              plan, float(sigmoid), bool(norm), g, h)
        return g, h
    cap = max(1, min(plan.max_len, LR_SMEM_ROWS))
    scratch = (torch.empty(4 * n, dtype=torch.float64, device=dev)
               if plan.max_len > LR_SMEM_ROWS else None)
    from .build import load
    fn = load("rank_grad").lambdarank_grad_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, P, P, I, ctypes.c_longlong, I, P,
                   ctypes.c_double, I, P, P, P, P]
    fn.restype = I
    err = fn(_ptr(score), _ptr(label), _ptr(gain), _ptr(inv_max_dcg),
             _ptr(disc), _ptr(weight), _ptr(plan.qb), plan.num_queries, n,
             cap, _ptr(scratch), float(sigmoid), int(bool(norm)), _ptr(g),
             _ptr(h), counters.ptr(dev, "lambdarank_grad"),
             P(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise LightGBMError("lambdarank_grad launch failed: CUDA error %d"
                            % err)
    lambdarank_grad.launches += 1
    return g, h


lambdarank_grad.launches = 0


def xendcg_grad(score, label, rnd, weight, plan: QueryPlan):
    """XE-NDCG's (grad, hess), f32 [n] in row order, from the f64 [n]
    row-ordered scores: label [n] f32, rnd [n] f64 (one uniform draw per
    row), weight [n] f32 or None, the queries of `plan`. One launch for
    tensors on the card; the plain version for tensors on the CPU."""
    name = "xendcg_grad"
    n = score.shape[0]
    _check(name, score, torch.float64, n, "score")
    _check(name, label, torch.float32, n, "label")
    _check(name, rnd, torch.float64, n, "rnd")
    if weight is not None:
        _check(name, weight, torch.float32, n, "weight")
    g, h = _outputs(name, score, plan)
    dev = score.device
    if any(t is not None and t.device != dev for t in (label, rnd, weight)):
        raise LightGBMError("%s: operands on different devices" % name)
    if dev.type == "cpu":
        xendcg_grad_plain(score, label, rnd, weight, plan, g, h)
        return g, h
    from .build import load
    fn = load("rank_grad").xendcg_grad_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, P, I, P, P, P, P]
    fn.restype = I
    err = fn(_ptr(score), _ptr(label), _ptr(rnd), _ptr(weight),
             _ptr(plan.qb), plan.num_queries, _ptr(g), _ptr(h),
             counters.ptr(dev, "xendcg_grad"),
             P(torch.cuda.current_stream(dev).cuda_stream))
    if err != 0:
        raise LightGBMError("xendcg_grad launch failed: CUDA error %d" % err)
    xendcg_grad.launches += 1
    return g, h


xendcg_grad.launches = 0
