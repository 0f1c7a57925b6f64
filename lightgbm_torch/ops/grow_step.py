"""The persistent grower's per-split steps on the device.

No Pallas counterpart: on the TPU these are the jnp statements of the
grower's while_loop body (lightgbm_tpu/ops/grow_persist.py:1533-1678).
Here they are kernels (``csrc/grow_step.cu``) over a device-resident leaf
table, so a tree grows with no read-back between splits and its per-split
loop can be captured in a CUDA graph:

  * :func:`root` starts a tree from root_hist's totals;
  * :func:`pick` takes the leaf with the first maximum of the best gains
    (``np.argmax``), sets the done flag unless its gain is positive and
    ``s < L``, and writes the split's S_* scalars, the leaf's buffer parity,
    split record ``s - 1`` and the children's plane rows;
  * :func:`commit`, after split_pass wrote n_left, writes the children's
    leaf state and their scan scalars (ops/scan.py:pair_scalars);
  * :func:`planes` makes the larger child's histogram planes the parent's
    minus the smaller child's;
  * :func:`assemble` takes each child's best split from the scan output
    and writes its candidate (ops/grow.py:assemble), then ``s += 1``;
  * :func:`cons_table` and :func:`apply_scores` end the tree: the
    consolidation's segment table and the score update, from the table;
    RF's trees end with :func:`apply_scores_avg` instead, the running
    average of the JAX package's ``apply_scores_avg`` (grow_persist.py:
    1775-1805): ``score = (score * t + (value + bias)) * inv`` in f32, one
    rounding per operation, no fused multiply-add, with t, 1 / (t + 1) and
    the bias in device scalars the host writes before each iteration.

Every step but the root's does nothing once the done flag is set, so a
fixed trip count grows the tree a loop that stops at the first pick
without a positive gain grows. Each kernel computes its plain PyTorch
version beside it, bit for bit: the f32 operations of the numpy code the
level phase and the v1 grower run (``np.argmax``, ``_scalars``,
``pair_scalars``, ``assemble``), one rounding per operation, in its
order. The
wrappers launch the kernel for a state on the card and run the plain
version for a state on the CPU; each adds one to its Python counter per
launch, and the kernel (or the plain version) to its device counter
(ops/counters.py) when it does its work.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import counters
from .payload_kernels import (N_SCALARS, S_DB, S_DL, S_LE, S_LS, S_MASK,
                              S_MF, S_MT, S_NB, S_NCH, S_NL, S_S0, S_SH,
                              S_SMALL_L, S_THR, S_WG)
from .split import K_EPSILON

# columns of the leaf table and the split records (csrc/grow_step.cu)
(LF_SUM_HESS, LF_VALUE, LF_GAIN, LF_LOUT, LF_ROUT, LF_LSG, LF_LSH, LF_RSG,
 LF_RSH) = range(9)
GS_LF = 10
(LI_COUNT, LI_DEPTH, LI_START, LI_NROWS, LI_FEAT, LI_THR, LI_DL, LI_LCNT,
 LI_RCNT) = range(9)
GS_LI = 10
RF_GAIN, RF_IVAL = 0, 1
GS_RF = 2
RI_LEAF, RI_FEAT, RI_THR, RI_DL, RI_ICNT = range(5)
GS_RI = 5
ST_S, ST_DONE, ST_LEAF, ST_PARITY, ST_NLEFT, ST_CH_START, ST_CH_LEN = \
    range(7)
GS_ST = 8
(FT_WORD, FT_SHIFT, FT_MASK, FT_NB, FT_MT, FT_DB, FT_LS, FT_LE, FT_MF,
 FT_FR) = range(10)
GS_FT = 10
PS_COLS = 9
SCAN_PAIR, SCAN_BLOCKS = 0, 1

F32 = np.float32
NEG_INF = float("-inf")


class StepConst(NamedTuple):
    """The f32 constants of the split parameters, rounded as the numpy
    code rounds them (pair_scalars, assemble), and the bag flag: with
    ``bagged`` the payload carries out-of-bag lanes, so commit takes the
    children's counts from the candidate (its hessian-derived counts, the
    JAX grower's stat_from_scan) instead of the partition's n_left."""
    l2: np.float32
    eps2: np.float32
    min_data: np.float32
    min_hess: np.float32
    mgts: np.float32
    max_depth: int
    C: int
    bagged: int = 0

    @classmethod
    def of(cls, params, max_depth: int, C: int,
           bagged: bool = False) -> "StepConst":
        return cls(F32(params.lambda_l2), F32(2 * K_EPSILON),
                   F32(params.min_data_in_leaf),
                   F32(params.min_sum_hessian_in_leaf),
                   F32(params.min_gain_to_split), int(max_depth), int(C),
                   int(bool(bagged)))

    def args(self):
        f = ctypes.c_float
        return (f(self.l2), f(self.eps2), f(self.min_data),
                f(self.min_hess), f(self.mgts), int(self.max_depth),
                int(self.C), int(self.bagged))


class GrowState:
    """The device-resident state of one grower's tree, in one byte buffer
    (``blob``) so that the host reads it back with one copy: the leaf table
    ``lf`` [L, GS_LF] f32 / ``li`` [L, GS_LI] i64, the split records ``rf``
    [L-1, GS_RF] f32 / ``ri`` [L-1, GS_RI] i64, the step scalars ``st``
    [GS_ST] i64 (``done`` and ``parity`` are 1-element views of it, ``res``
    split_pass's three results, ``child`` the smaller child's segment),
    the split scalars ``scal`` [16] i32, the scan scalars ``ps`` [2, 9] and
    ``ps8`` [2, 8] f32, the plane rows ``rows`` [2] i64, the consolidation
    table ``tab`` [L, 2] i64 and a copy of the device counters ``cnt``."""

    FIELDS = (("lf", torch.float32, "L", GS_LF),
              ("li", torch.int64, "L", GS_LI),
              ("rf", torch.float32, "R", GS_RF),
              ("ri", torch.int64, "R", GS_RI),
              ("st", torch.int64, 1, GS_ST),
              ("scal", torch.int32, 1, 16),
              ("ps", torch.float32, 2, PS_COLS),
              ("ps8", torch.float32, 2, 8),
              ("rows", torch.int64, 1, 2),
              ("tab", torch.int64, "L", 2),
              ("cnt", torch.int64, 1, len(counters.SLOTS)))

    def __init__(self, L: int, device):
        self.L = int(L)
        self.device = torch.device(device)
        self.layout, off = {}, 0
        for name, dt, rows, cols in self.FIELDS:
            r = {"L": self.L, "R": max(self.L - 1, 1)}.get(rows, rows)
            size = r * cols * torch.empty((), dtype=dt).element_size()
            self.layout[name] = (off, dt, r, cols)
            off += -(-size // 16) * 16
        self.blob = torch.zeros(off, dtype=torch.uint8, device=self.device)
        self.device = self.blob.device        # with its index
        for name, view in self.views(self.blob).items():
            setattr(self, name, view)
        self.st = self.st.reshape(GS_ST)
        self.scal = self.scal.reshape(16)
        self.rows = self.rows.reshape(2)
        self.cnt = self.cnt.reshape(-1)
        # the learning rate apply_scores multiplies by, an f32 the host
        # writes before each iteration (so a captured graph serves every
        # rate)
        self.shrink = torch.zeros(1, dtype=torch.float32, device=self.device)
        # RF's running average: t, 1 / (t + 1), the bias and its flag
        # (f32), written by the host before each iteration (set_avg)
        self.avg = torch.zeros(4, dtype=torch.float32, device=self.device)
        self._avg_host = None
        self.done = self.st[ST_DONE:ST_DONE + 1]
        self.parity = self.st[ST_PARITY:ST_PARITY + 1]
        self.res = self.st[ST_NLEFT:ST_NLEFT + 3]
        self.child = self.st[ST_CH_START:ST_CH_START + 2]

    def views(self, blob: torch.Tensor) -> dict:
        """Each field as a view of `blob` (this state's or a host copy)."""
        out = {}
        for name, (off, dt, r, cols) in self.layout.items():
            size = r * cols * torch.empty((), dtype=dt).element_size()
            out[name] = blob[off:off + size].view(dt).view(r, cols)
        return out

    def read(self) -> dict:
        """The whole state on the host, numpy, with one device-to-host
        copy."""
        host = self.blob.cpu()
        return {k: v.numpy() for k, v in self.views(host).items()}

    def args(self):
        return tuple(ctypes.c_void_p(t.data_ptr()) for t in (
            self.lf, self.li, self.rf, self.ri, self.st, self.scal, self.ps,
            self.ps8, self.rows)) + (self.L,)


def feature_table(assets, forced_right, rows: int, device) -> torch.Tensor:
    """The [rows, GS_FT] int32 per-feature table of the step kernels: the
    payload decode and split scalars of each feature (assets: a
    PersistAssets) and forced_right, zero past the features."""
    F = len(assets.nb)
    t = np.zeros((max(rows, F, 1), GS_FT), np.int32)
    for col, a in ((FT_WORD, assets.dec_word), (FT_SHIFT, assets.dec_shift),
                   (FT_MASK, assets.dec_mask), (FT_NB, assets.nb),
                   (FT_MT, assets.mt), (FT_DB, assets.db), (FT_LS, assets.ls),
                   (FT_LE, assets.le), (FT_MF, assets.mf),
                   (FT_FR, np.asarray(forced_right[:F], np.int32))):
        t[:F, col] = a
    return torch.as_tensor(t, device=device)


# ---- plain versions ---------------------------------------------------------

def _f32(x) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32)


def first_max(x: torch.Tensor) -> int:
    """np.argmax of a 1-D tensor: the first NaN if there is one, else the
    first maximum."""
    nan = torch.isnan(x)
    if bool(nan.any()):
        return int(torch.nonzero(nan)[0, 0])
    return int(torch.argmax(x))


def pair_rows(sg, sh_raw, cnt, k: StepConst) -> torch.Tensor:
    """[B, 9] f32: pair_scalars of B children (sum_grad [B] f32, sum_hess
    [B] f32, count [B] int) and the raw hessian sum, in torch f32."""
    dev = sg.device
    sg = sg.to(torch.float32)
    sh_raw = sh_raw.to(torch.float32)
    sh = sh_raw + _f32(k.eps2)
    c = torch.as_tensor(cnt, device=dev).to(torch.int64).to(torch.float32)
    l2 = _f32(k.l2)
    B = sg.shape[0]

    def full(v):
        return _f32(v).to(dev).expand(B)
    return torch.stack([sg, sh, c, c / sh, full(k.min_data),
                        full(k.min_hess), (sg * sg) / (sh + l2)
                        + _f32(k.mgts), full(k.l2), sh_raw], dim=1)


def _set_pairs(S: GrowState, b0: int, rows9: torch.Tensor) -> None:
    S.ps[b0:b0 + len(rows9)] = rows9
    S.ps8[b0:b0 + len(rows9)] = rows9[:, :8]


def root_plain(S: GrowState, sums: torch.Tensor, n: int,
               k: StepConst, count=None) -> None:
    S.lf.zero_()
    S.lf[:, LF_GAIN] = NEG_INF
    S.li.zero_()
    S.li[:, LI_FEAT] = -1
    S.rf.zero_()
    S.ri.zero_()
    S.ri[:, RI_FEAT] = -1
    sg, sh = sums[0].to(torch.float32), sums[1].to(torch.float32)
    cnt = n if count is None else int(count[0])
    S.lf[0, LF_SUM_HESS] = sh
    S.lf[0, LF_VALUE] = -sg / (sh + _f32(k.l2))
    S.li[0, LI_COUNT] = cnt
    S.li[0, LI_NROWS] = n
    _set_pairs(S, 0, pair_rows(sg[None], sh[None], [cnt], k))
    S.rows[0] = 0
    S.st.zero_()
    S.st[ST_S] = 1
    counters.bump(S.device, "grow_root")


def pick_plain(S: GrowState, feat: torch.Tensor, k: StepConst) -> None:
    st = S.st
    if int(st[ST_DONE]):
        return
    l = first_max(S.lf[:, LF_GAIN])
    s = int(st[ST_S])
    gain = S.lf[l, LF_GAIN]
    if not bool(gain > 0) or s >= S.L:
        st[ST_DONE] = 1
        return
    row = [int(v) for v in S.li[l].tolist()]
    f = row[LI_FEAT]
    ft = [int(v) for v in feat[f].tolist()]
    n_l = row[LI_NROWS]
    sc = [0] * N_SCALARS
    sc[S_NCH] = (n_l + k.C - 1) // k.C
    sc[S_S0], sc[S_NL] = row[LI_START], n_l
    sc[S_WG], sc[S_SH], sc[S_MASK] = ft[FT_WORD], ft[FT_SHIFT], ft[FT_MASK]
    sc[S_NB], sc[S_MT], sc[S_DB] = ft[FT_NB], ft[FT_MT], ft[FT_DB]
    sc[S_THR], sc[S_DL] = row[LI_THR], row[LI_DL]
    sc[S_SMALL_L] = int(row[LI_LCNT] <= row[LI_RCNT])
    sc[S_LS], sc[S_LE], sc[S_MF] = ft[FT_LS], ft[FT_LE], ft[FT_MF]
    S.scal[:N_SCALARS] = torch.tensor(sc, dtype=torch.int32,
                                      device=S.device)
    st[ST_LEAF] = l
    st[ST_PARITY] = row[LI_DEPTH] % 2
    S.ri[s - 1] = torch.tensor([l, f, row[LI_THR], row[LI_DL],
                                row[LI_COUNT]], device=S.device)
    S.rf[s - 1, RF_GAIN] = gain
    S.rf[s - 1, RF_IVAL] = S.lf[l, LF_VALUE]
    S.rows[0], S.rows[1] = l, s
    counters.bump(S.device, "grow_pick")


def commit_plain(S: GrowState, k: StepConst) -> None:
    st = S.st
    if int(st[ST_DONE]):
        return
    l, s, n_left = int(st[ST_LEAF]), int(st[ST_S]), int(st[ST_NLEFT])
    pi = [int(v) for v in S.li[l].tolist()]
    cand = S.lf[l].clone()
    if k.bagged:
        left_cnt, right_cnt = pi[LI_LCNT], pi[LI_RCNT]
    else:
        left_cnt, right_cnt = n_left, pi[LI_COUNT] - n_left
    depth = pi[LI_DEPTH] + 1
    S.lf[l, LF_SUM_HESS], S.lf[l, LF_VALUE] = cand[LF_LSH], cand[LF_LOUT]
    S.lf[s, LF_SUM_HESS], S.lf[s, LF_VALUE] = cand[LF_RSH], cand[LF_ROUT]
    cols = [LI_COUNT, LI_DEPTH, LI_START, LI_NROWS]
    S.li[l, cols] = torch.tensor([left_cnt, depth, pi[LI_START], n_left],
                                 device=S.device)
    S.li[s, cols] = torch.tensor([right_cnt, depth, pi[LI_START] + n_left,
                                  pi[LI_NROWS] - n_left], device=S.device)
    _set_pairs(S, 0, pair_rows(cand[[LF_LSG, LF_RSG]],
                               cand[[LF_LSH, LF_RSH]],
                               [left_cnt, right_cnt], k))
    counters.bump(S.device, "grow_commit")


def planes_plain(S: GrowState, gh: torch.Tensor, hh: torch.Tensor,
                 small: torch.Tensor) -> None:
    if int(S.st[ST_DONE]):
        return
    l, s = int(S.st[ST_LEAF]), int(S.st[ST_S])
    sil = int(S.scal[S_SMALL_L]) > 0
    for P, sm in ((gh, small[0]), (hh, small[1])):
        big = P[l] - sm
        P[s], P[l] = (big, sm) if sil else (sm, big.clone())
    counters.bump(S.device, "grow_planes")


def assemble_plain(S: GrowState, out: torch.Tensor, mode: int,
                   owner: torch.Tensor, Wp: int, feat: torch.Tensor,
                   k: StepConst, advance: bool) -> None:
    if int(S.st[ST_DONE]):
        return
    l2, half = _f32(k.l2), _f32(0.5)
    for b in range(out.shape[0]):
        j = first_max(out[b, 0])
        best = out[b, :, j]
        row = int(S.rows[b])
        if mode == SCAN_PAIR:
            f, thr = j, int(best[1])
        else:
            lane = min(max(int(best[1]), 0), Wp - 1)
            f = int(owner[j * Wp + lane])
            thr = int(best[1]) - int(feat[f, FT_LS])
        forced_right = int(feat[f, FT_FR]) != 0
        gain = best[0]
        valid = bool(torch.isfinite(gain))
        if k.max_depth > 0:
            valid &= int(S.li[row, LI_DEPTH]) < k.max_depth
        sg, sh, cnt = S.ps[b, 0], S.ps[b, 1], S.ps[b, 2]
        lg, lh, lc = best[3], best[4], best[5]
        rg, rh, rc = sg - lg, sh - lh, cnt - lc
        S.lf[row, LF_GAIN] = gain if valid else NEG_INF
        S.lf[row, LF_LOUT] = -lg / (lh + l2)
        S.lf[row, LF_ROUT] = -rg / (rh + l2)
        S.lf[row, LF_LSG], S.lf[row, LF_LSH] = lg, lh
        S.lf[row, LF_RSG], S.lf[row, LF_RSH] = rg, rh
        S.li[row, [LI_FEAT, LI_THR, LI_DL, LI_LCNT, LI_RCNT]] = torch.tensor(
            [f if valid else -1, thr if valid else 0,
             int(not bool(best[2] > half) and not forced_right)
             if valid else 1,
             int(torch.floor(lc + half)), int(torch.floor(rc + half))],
            device=S.device)
    if advance:
        S.st[ST_S] += 1
    counters.bump(S.device, "grow_assemble")


def cons_table_plain(S: GrowState) -> None:
    s = int(S.st[ST_S])
    li = S.li
    k = torch.arange(S.L, device=S.device)
    odd = (k < s) & (li[:, LI_DEPTH] % 2 == 1) & (li[:, LI_NROWS] > 0)
    S.tab[:, 0] = li[:, LI_START]
    S.tab[:, 1] = torch.where(odd, li[:, LI_NROWS], 0)


def apply_plain(S: GrowState, score: torch.Tensor) -> None:
    s = int(S.st[ST_S])
    if s <= 1:
        return
    sh = S.shrink[0]
    for q in range(s):
        st, nr = int(S.li[q, LI_START]), int(S.li[q, LI_NROWS])
        score[st:st + nr] += S.lf[q, LF_VALUE] * sh
    counters.bump(S.device, "apply_scores")


def apply_avg_plain(S: GrowState, score: torch.Tensor) -> None:
    s = int(S.st[ST_S])
    if s <= 1:
        return
    t, inv, bias, use_bias = S.avg
    for q in range(s):
        st, nr = int(S.li[q, LI_START]), int(S.li[q, LI_NROWS])
        v = S.lf[q, LF_VALUE]
        if bool(use_bias != 0):
            v = v + bias
        seg = score[st:st + nr]
        seg.copy_((seg * t + v) * inv)
    counters.bump(S.device, "apply_scores_avg")


# ---- wrappers ---------------------------------------------------------------

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, \
    ctypes.c_float
_STATE = [_P] * 9 + [_I]
_CONST = [_F] * 5 + [_I, _I, _I]


def _launch(name, argtypes, S: GrowState, *args):
    from .build import load
    fn = getattr(load("grow_step"), name)
    fn.argtypes = _STATE + argtypes + [_P]
    fn.restype = _I
    err = fn(*S.args(), *args,
             ctypes.c_void_p(torch.cuda.current_stream(
                 S.device).cuda_stream))
    if err != 0:
        raise LightGBMError("grow_step %s launch failed: CUDA error %d"
                            % (name, err))


def _on(S: GrowState, *tensors) -> bool:
    """True for a state on the card (launch), False on the CPU (plain);
    raises for another device or an operand elsewhere."""
    for t in tensors:
        if t.device != S.device:
            raise LightGBMError("grow_step: an operand is on %s, the state "
                                "on %s" % (t.device, S.device))
    if S.device.type not in ("cpu", "cuda"):
        raise LightGBMError("grow_step: no kernel for device %s" % S.device)
    return S.device.type == "cuda"


def _cnt(S, name):
    return counters.ptr(S.device, name)


def root(S: GrowState, sums: torch.Tensor, n: int, k: StepConst,
         count: torch.Tensor = None) -> None:
    """Start a tree: the table's initial values and the root's state from
    root_hist's totals `sums` [2] f32; the root's count is `count` (a [1]
    int64 device tensor: the bag step's in-bag count) or n."""
    extra = () if count is None else (count,)
    if count is not None and count.dtype != torch.int64:
        raise LightGBMError("grow_step root: count must be int64")
    if not _on(S, sums, *extra):
        return root_plain(S, sums, n, k, count)
    _launch("gs_root_launch", [_P, _LL, _P] + _CONST + [_P], S,
            ctypes.c_void_p(sums.data_ptr()), int(n),
            ctypes.c_void_p(None if count is None else count.data_ptr()),
            *k.args(), _cnt(S, "grow_root"))
    root.launches += 1


def pick(S: GrowState, feat: torch.Tensor, k: StepConst) -> None:
    """Pick the leaf to split (or set done)."""
    if not _on(S, feat):
        return pick_plain(S, feat, k)
    _launch("gs_pick_launch", [_P] + _CONST + [_P], S,
            ctypes.c_void_p(feat.data_ptr()), *k.args(),
            _cnt(S, "grow_pick"))
    pick.launches += 1


def commit(S: GrowState, k: StepConst) -> None:
    """The children's state and scan scalars after split_pass."""
    if not _on(S):
        return commit_plain(S, k)
    _launch("gs_commit_launch", _CONST + [_P], S, *k.args(),
            _cnt(S, "grow_commit"))
    commit.launches += 1


def planes(S: GrowState, gh: torch.Tensor, hh: torch.Tensor,
           small: torch.Tensor) -> None:
    """The children's histogram planes from the parent's and the smaller
    child's ``small`` [2, TBp]."""
    if tuple(small.shape) != (2, gh.shape[1]) or gh.shape != hh.shape:
        raise LightGBMError("grow_step planes: small %s for planes %s"
                            % (tuple(small.shape), tuple(gh.shape)))
    if not _on(S, gh, hh, small):
        return planes_plain(S, gh, hh, small)
    _launch("gs_planes_launch", [_P, _P, _P, _LL, _P], S,
            ctypes.c_void_p(gh.data_ptr()), ctypes.c_void_p(hh.data_ptr()),
            ctypes.c_void_p(small.data_ptr()), gh.shape[1],
            _cnt(S, "grow_planes"))
    planes.launches += 1


def assemble(S: GrowState, out: torch.Tensor, mode: int,
             owner: torch.Tensor, Wp: int, feat: torch.Tensor,
             k: StepConst, advance: bool) -> None:
    """The B children's candidates from the scan output ``out`` [B, 8, Fp]
    (``mode`` SCAN_PAIR) or [B, 8, Gp] (SCAN_BLOCKS, with the owner map
    [Gp * Wp] int32), then s += 1 when ``advance``."""
    if out.dim() != 3 or out.shape[1] != 8 or not 1 <= out.shape[0] <= 2 \
            or out.dtype != torch.float32 or not out.is_contiguous():
        raise LightGBMError("grow_step assemble: out must be a contiguous "
                            "[B <= 2, 8, F] float32 tensor")
    if not _on(S, out, owner, feat):
        return assemble_plain(S, out, mode, owner, Wp, feat, k, advance)
    _launch("gs_assemble_launch", [_P, _I, _I, _I, _P, _I, _P] + _CONST
            + [_I, _P], S, ctypes.c_void_p(out.data_ptr()), out.shape[0],
            out.shape[2], int(mode), ctypes.c_void_p(owner.data_ptr()),
            int(Wp), ctypes.c_void_p(feat.data_ptr()), *k.args(),
            int(bool(advance)), _cnt(S, "grow_assemble"))
    assemble.launches += 1


def cons_table(S: GrowState) -> None:
    """The consolidation's segment table ``S.tab`` of the tree's odd-depth
    leaves with lanes."""
    if not _on(S):
        return cons_table_plain(S)
    _launch("gs_cons_table_launch", [_P], S,
            ctypes.c_void_p(S.tab.data_ptr()))
    cons_table.launches += 1


def set_shrink(S: GrowState, shrink: float) -> None:
    """The learning rate of the next apply_scores, f32(shrink), into the
    state's device scalar (a fill, queued on the card; no copy)."""
    S.shrink.fill_(float(F32(shrink)))


def apply_scores(S: GrowState, score: torch.Tensor, shrink=None) -> None:
    """score += f32(value * shrink) on every lane of the tree's leaves,
    `score` the payload's f32 score row (a view). The kernel reads the
    learning rate from the state's device scalar ``S.shrink``; a float
    `shrink` is written there first (:func:`set_shrink`)."""
    if shrink is not None:
        set_shrink(S, shrink)
    if not _on(S, score):
        return apply_plain(S, score)
    _launch("gs_apply_launch", [_P, _P, _LL, _P], S,
            ctypes.c_void_p(score.data_ptr()),
            ctypes.c_void_p(S.shrink.data_ptr()),
            score.shape[0], _cnt(S, "apply_scores"))
    apply_scores.launches += 1


def set_avg(S: GrowState, t: float, bias: float) -> None:
    """RF's scalars of the next apply_scores_avg into the state's device
    memory (one small copy, queued on the card): f32(t), f32(1 / (t + 1))
    (the f64 quotient rounded), f32(bias) and whether the f64 bias is
    nonzero (the JAX package adds it only then, so a -0.0 leaf keeps its
    sign)."""
    t = float(t)
    vals = (F32(t), F32(1.0 / (t + 1.0)), F32(bias),
            F32(1.0 if bias != 0.0 else 0.0))
    if S._avg_host != vals:
        S.avg.copy_(torch.tensor(vals, dtype=torch.float32))
        S._avg_host = vals


def apply_scores_avg(S: GrowState, score: torch.Tensor) -> None:
    """RF's running average on every lane of the tree's leaves (none for
    a tree of one leaf): score = (score * t + (value + bias)) * inv in
    f32, `score` the payload's f32 score row, t / inv / bias from
    ``S.avg`` (:func:`set_avg`)."""
    if not _on(S, score):
        return apply_avg_plain(S, score)
    _launch("gs_apply_avg_launch", [_P, _P, _LL, _P], S,
            ctypes.c_void_p(score.data_ptr()),
            ctypes.c_void_p(S.avg.data_ptr()),
            score.shape[0], _cnt(S, "apply_scores_avg"))
    apply_scores_avg.launches += 1


for _fn in (root, pick, commit, planes, assemble, cons_table, apply_scores,
            apply_scores_avg):
    _fn.launches = 0


def graph_nodes(graph) -> int:
    """The node count of a captured torch.cuda.CUDAGraph kept with
    ``keep_graph=True``."""
    from .build import load
    fn = load("grow_step").gs_graph_nodes
    fn.argtypes = [_P, ctypes.POINTER(ctypes.c_longlong)]
    fn.restype = _I
    n = ctypes.c_longlong(0)
    err = fn(ctypes.c_void_p(graph.raw_cuda_graph()), ctypes.byref(n))
    if err != 0:
        raise LightGBMError("cudaGraphGetNodes failed: CUDA error %d" % err)
    return int(n.value)
