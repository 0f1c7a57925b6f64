"""Row sampling on the persistent grower: bagging and GOSS as payload steps.

No Pallas counterpart: the JAX package's fused driver samples rows with jnp
statements between the gradient fill and the tree (lightgbm_tpu/ops/
grow_persist.py: ``make_bag_transform:569-644``, run by ``make_scan_driver``
at :2150-2190). The port runs them as two CUDA kernels (``csrc/bag.cu``)
inside the per-iteration graph:

  * :func:`bag_apply` draws each live lane's uniform from a hash of its row
    id and the window key (``_hash_uniform:498-518``), weighs the lane
    (bagging: kept with the fraction, balanced by the label row's sign;
    GOSS: kept where |g * h| reaches the threshold, else kept with
    probability ``p_rest`` and amplified by ``amp``), multiplies the lane's
    grad and hess by the weight in place and counts the lanes in the bag;
  * :func:`goss_select` finds the threshold: the exact ``top_k``-th largest
    |g * h| over the live lanes (``_kth_largest:521-537``), or marks
    "keep every row" while the iteration is below ``int(1 /
    learning_rate)`` (``make_goss_weight_fn:540-566``).

RF's bag (``MODE_ROWS``, the JAX package's ``apply_row_weights``,
grow_persist.py:1828-1843) is the host's numpy draw (boosting/gbdt.py:
GBDT.bagging), uploaded as an [n] uint8 mask into a buffer of the
:class:`BagState` at a fixed address before the iteration: bag_apply
weighs each live lane by its row's mask, ``w = mask[rid]``, and counts the
lanes with ``w > 0`` (device counter slot ``bag_rows``).

Their inputs that change between iterations (the window key, the
iteration, the skip count, the fractions) are device scalars of a
:class:`BagState`, written by the host before each iteration, so one
captured graph serves them all. A bag window's key is the JAX package's
``fold_in(PRNGKey(bagging_seed), window)`` (gbdt.py:_persist_bag_keys:
449-466): the window is ``it // bagging_freq`` for bagging and ``it``
itself for GOSS; utils/random.py computes it as jax.random does.

Each kernel has its plain version here, in torch ops that compute the same
bits: the hash in int64 masked to 32 bits after every step (the low 32
bits of an int64 product are exact even when it wraps), the select by
``torch.kthvalue`` on the bit patterns. The wrappers run the plain version
for tensors on the CPU and launch the kernel for tensors on the card; each
adds one to its Python counter per launch, and the kernel (or the plain
version) to its device counter (ops/counters.py) when it does its work.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np
import torch

from ..utils import random as tf
from ..utils.log import LightGBMError, Log
from . import counters

# the device scalars (csrc/bag.cu)
BI_KEY0, BI_KEY1, BI_IT, BI_SKIP, BI_TOPK = range(5)
BAG_NI = 5
BF_FRAC, BF_POS, BF_NEG, BF_PREST, BF_AMP = range(5)
BAG_NF = 5
SEL_THR, SEL_KEEP, SEL_PREFIX, SEL_KREM, SEL_HIST = range(5)
SEL_LEN = SEL_HIST + 256
MODE_FRACTION, MODE_BALANCED, MODE_GOSS, MODE_ROWS = 0, 1, 2, 3

F32 = np.float32
_M32 = 0xFFFFFFFF


class BagIteration(NamedTuple):
    """One iteration's bag step on the persistent grower: the kernel mode
    and the values of its device scalars."""
    mode: int
    key: tuple          # the window key's two u32 words
    it: int             # the boosting iteration
    skip: int           # GOSS: no sampling below it (int(1 / lr))
    top_k: int          # GOSS: the rank of the threshold
    fraction: float
    pos: float
    neg: float
    p_rest: float       # GOSS: keep probability of the rest
    amp: float          # GOSS: their weight
    rows: np.ndarray = None     # MODE_ROWS: a new [n] bool mask, or None
                                # to keep the one uploaded last

    def ints(self):
        return (int(self.key[0]), int(self.key[1]), int(self.it),
                int(self.skip), int(self.top_k))

    def flts(self):
        return tuple(float(F32(v)) for v in (self.fraction, self.pos,
                                             self.neg, self.p_rest,
                                             self.amp))


def goss_constants(n: int, top_rate: float, other_rate: float):
    """(top_k, p_rest, amp) of make_goss_weight_fn (grow_persist.py:
    540-566), p_rest and amp rounded to f32 as the JAX package rounds them
    where it compares and multiplies."""
    if top_rate + other_rate >= 1.0:
        Log.fatal("The sum of top_rate and other_rate cannot be 1.0")
    top_k = max(1, int(n * top_rate))
    p_rest = min(1.0, (n * other_rate) / max(n - top_k, 1))
    amp = (n - top_k) / max(n * other_rate, 1.0)
    return top_k, F32(p_rest), F32(amp)


def window_key(seed: int, window: int) -> tuple:
    """jax.random.key_data(fold_in(PRNGKey(seed), window)) as two ints."""
    k = tf.fold_in(tf.prng_key(int(seed)), int(window))
    return int(k[0]), int(k[1])


def rows_iteration(it: int, mask) -> BagIteration:
    """RF's bag step of iteration `it`: the host's [n] bool mask (None:
    the last one uploaded stays)."""
    return BagIteration(MODE_ROWS, (0, 0), it, 0, 0, 1.0, 1.0, 1.0, 1.0,
                        1.0, mask)


def bag_iteration(spec, seed: int, freq: int, it: int, n: int,
                  skip: int = 0) -> BagIteration:
    """The bag step of iteration `it` for a bag spec of the boosting driver
    (the JAX package's bag_spec: ("bagging", fraction, pos_fraction,
    neg_fraction) or ("goss", top_rate, other_rate)) over n rows; `skip` =
    GOSS's int(1 / learning_rate)."""
    if spec[0] == "goss":
        top_k, p_rest, amp = goss_constants(n, spec[1], spec[2])
        return BagIteration(MODE_GOSS, window_key(seed, it), it, skip,
                            top_k, 1.0, 1.0, 1.0, p_rest, amp)
    _, fraction, pos, neg = spec
    balanced = pos < 1.0 or neg < 1.0
    return BagIteration(MODE_BALANCED if balanced else MODE_FRACTION,
                        window_key(seed, it // max(int(freq), 1)), it, 0, 0,
                        fraction, pos, neg, 1.0, 1.0)


class BagState:
    """The bag step's device scalars and outputs on one device: ``ints``
    [BAG_NI] int64, ``flts`` [BAG_NF] f32 (written before an iteration by
    :meth:`set`), ``sel`` [SEL_LEN] int64 (goss_select's threshold bits,
    keep flag and scratch), ``count`` [1] int64 (bag_apply's in-bag
    count) and, from the first MODE_ROWS iteration, ``rows`` [n] uint8
    (the host's mask, at a fixed address)."""

    def __init__(self, device):
        self.ints = torch.zeros(BAG_NI, dtype=torch.int64, device=device)
        self.flts = torch.zeros(BAG_NF, dtype=torch.float32, device=device)
        self.sel = torch.zeros(SEL_LEN, dtype=torch.int64, device=device)
        self.count = torch.zeros(1, dtype=torch.int64, device=device)
        self.rows = None
        self._host = None

    def set(self, b: BagIteration) -> None:
        """The iteration's scalars into device memory: a fill per value
        that changed since the last call (queued on the card, no copy);
        a new MODE_ROWS mask is copied into ``rows`` (one host-to-device
        copy)."""
        if b.rows is not None:
            mask = torch.from_numpy(np.ascontiguousarray(b.rows, np.bool_)
                                    .view(np.uint8))
            if self.rows is None:
                self.rows = torch.empty(mask.shape[0], dtype=torch.uint8,
                                        device=self.ints.device)
            if self.rows.shape != mask.shape:
                raise LightGBMError("bag: a mask of %d rows for a bag of %d"
                                    % (mask.shape[0], self.rows.shape[0]))
            self.rows.copy_(mask)
        vals = b.ints() + b.flts()
        old = self._host or (None,) * len(vals)
        for j, (v, o) in enumerate(zip(vals, old)):
            if v != o:
                t = self.ints[j] if j < BAG_NI else self.flts[j - BAG_NI]
                t.fill_(v)
        self._host = vals


# ---- plain versions ---------------------------------------------------------

def hash_uniform_plain(rid: torch.Tensor, k0: int, k1: int) -> torch.Tensor:
    """_hash_uniform of the row ids `rid` (any integer dtype, values in
    [0, 2^32)) under the key (k0, k1): f32 uniforms in [0, 1]."""
    x = (rid.to(torch.int64) & _M32) ^ (int(k0) & _M32)
    x = (x * 0x85EBCA6B) & _M32
    x = x ^ (x >> 13)
    x = ((x + (int(k1) & _M32)) * 0xC2B2AE35) & _M32
    x = x ^ (x >> 16)
    # int64 -> f32 rounds to nearest, as __uint2float_rn and XLA's convert
    return x.to(torch.float32) * F32(1.0 / 4294967296.0)


def _u32_bits(x: torch.Tensor) -> torch.Tensor:
    """The bit patterns of f32 `x` as int64 values in [0, 2^32)."""
    return x.contiguous().view(torch.int32).to(torch.int64) & _M32


def kth_largest_bits(bits: torch.Tensor, k: int) -> int:
    """The largest t with count(bits >= t) >= k over the [m] u32 values
    `bits` (int64): the k-th largest, 0 when k > m, 2^32 - 1 when k <= 0
    (the JAX package's bitwise select)."""
    m = bits.numel()
    if k <= 0:
        return _M32
    if k > m:
        return 0
    return int(torch.kthvalue(bits, m - k + 1).values)


def goss_select_plain(g, h, n: int, state: BagState) -> None:
    ints = [int(v) for v in state.ints.tolist()]
    sel = state.sel
    sel.zero_()                 # the rest of sel is the kernel's scratch
    if ints[BI_IT] < ints[BI_SKIP]:
        sel[SEL_KEEP] = 1
        return
    bits = _u32_bits((g[:n] * h[:n]).abs())
    sel[SEL_THR] = kth_largest_bits(bits, ints[BI_TOPK])
    counters.bump(g.device, "goss_select")


def bag_apply_plain(rid, label, g, h, n: int, mode: int,
                    state: BagState) -> None:
    if mode == MODE_ROWS:
        counters.bump(g.device, "bag_rows")
        w = state.rows.index_select(0, rid[:n].to(torch.int64)) \
            .to(torch.float32)
        g[:n].mul_(w)
        h[:n].mul_(w)
        state.count[0] = int((w > 0).sum())
        return
    counters.bump(g.device, "bag_apply")
    if mode == MODE_GOSS and int(state.sel[SEL_KEEP]):
        state.count[0] = n
        return
    ints = [int(v) for v in state.ints.tolist()]
    fl = state.flts
    u = hash_uniform_plain(rid[:n], ints[BI_KEY0], ints[BI_KEY1])
    gi, hi = g[:n], h[:n]
    one, zero = torch.ones((), dtype=torch.float32), \
        torch.zeros((), dtype=torch.float32)
    if mode == MODE_GOSS:
        thr = torch.tensor([int(state.sel[SEL_THR])], dtype=torch.int64) \
            .to(torch.int32).view(torch.float32)[0]
        rest = torch.where(u < fl[BF_PREST], fl[BF_AMP], zero)
        w = torch.where((gi * hi).abs() >= thr, one, rest)
    elif mode == MODE_BALANCED:
        keep = torch.where(label[:n] > 0, u < fl[BF_POS], u < fl[BF_NEG])
        w = keep.to(torch.float32)
    else:
        w = (u < fl[BF_FRAC]).to(torch.float32)
    gi.mul_(w)
    hi.mul_(w)
    state.count[0] = int((w > 0).sum())


# ---- wrappers ---------------------------------------------------------------

def _ptr(t):
    return ctypes.c_void_p(None if t is None else t.data_ptr())


def _check(name, rows, n, state: BagState):
    """True to launch (rows on the card), False for the plain version (on
    the CPU); raises for rows that are not 1-D, contiguous and at least n
    lanes long, or for operands on different devices."""
    dev = rows[0].device
    for t in rows:
        if t.dim() != 1 or not t.is_contiguous() or t.shape[0] < n:
            raise LightGBMError("%s: every row must be a contiguous 1-D "
                                "tensor of at least %d lanes" % (name, n))
    own = (state.ints, state.flts, state.sel, state.count) + (
        () if state.rows is None else (state.rows,))
    if any(t.device != dev for t in rows + own):
        raise LightGBMError("%s: operands on different devices" % name)
    if dev.type not in ("cpu", "cuda"):
        raise LightGBMError("%s: no kernel for device %s" % (name, dev))
    return dev.type == "cuda"


def goss_select(g: torch.Tensor, h: torch.Tensor, n: int,
                state: BagState) -> None:
    """The GOSS threshold of the n live lanes of the payload's f32 grad and
    hess rows `g`, `h` into ``state.sel`` (threshold bits at SEL_THR, the
    keep-every-row flag at SEL_KEEP), from ``state.ints`` (the iteration,
    the skip count, top_k). Nothing is read back."""
    if g.dtype != torch.float32 or h.dtype != torch.float32:
        raise LightGBMError("goss_select: g and h must be f32 rows")
    if not _check("goss_select", (g, h), n, state):
        return goss_select_plain(g, h, n, state)
    from .build import load
    fn = load("bag").goss_select_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, ctypes.c_longlong, P, P, P, P]
    fn.restype = ctypes.c_int
    err = fn(_ptr(g), _ptr(h), int(n), _ptr(state.ints), _ptr(state.sel),
             counters.ptr(g.device, "goss_select"),
             P(torch.cuda.current_stream(g.device).cuda_stream))
    if err != 0:
        raise LightGBMError("goss_select launch failed: CUDA error %d" % err)
    goss_select.launches += 1


def bag_apply(rid: torch.Tensor, label: torch.Tensor, g: torch.Tensor,
              h: torch.Tensor, n: int, mode: int, state: BagState) -> None:
    """Weigh the n live lanes: `rid` the payload's int32 row-id row,
    `label` its f32 label row (read in the balanced mode), `g`/`h` its f32
    grad and hess rows, multiplied in place; the in-bag count into
    ``state.count``. GOSS reads the threshold goss_select wrote, MODE_ROWS
    the mask ``state.rows`` (a lane's weight is its row's mask)."""
    if rid.dtype != torch.int32 or any(t.dtype != torch.float32
                                       for t in (label, g, h)):
        raise LightGBMError("bag_apply: rid must be int32, label/g/h f32")
    if mode not in (MODE_FRACTION, MODE_BALANCED, MODE_GOSS, MODE_ROWS):
        raise LightGBMError("bag_apply: unknown mode %r" % (mode,))
    if mode == MODE_ROWS and state.rows is None:
        raise LightGBMError("bag_apply: MODE_ROWS without a mask")
    if not _check("bag_apply", (rid, label, g, h), n, state):
        return bag_apply_plain(rid, label, g, h, n, mode, state)
    from .build import load
    fn = load("bag").bag_apply_launch
    P = ctypes.c_void_p
    fn.argtypes = [P, P, P, P, ctypes.c_longlong, ctypes.c_int, P, P, P, P,
                   P, P, P]
    fn.restype = ctypes.c_int
    slot = "bag_rows" if mode == MODE_ROWS else "bag_apply"
    err = fn(_ptr(rid), _ptr(label), _ptr(g), _ptr(h), int(n), int(mode),
             _ptr(state.ints), _ptr(state.flts), _ptr(state.sel),
             _ptr(state.rows), _ptr(state.count),
             counters.ptr(g.device, slot),
             P(torch.cuda.current_stream(g.device).cuda_stream))
    if err != 0:
        raise LightGBMError("bag_apply launch failed: CUDA error %d" % err)
    bag_apply.launches += 1


goss_select.launches = 0
bag_apply.launches = 0
