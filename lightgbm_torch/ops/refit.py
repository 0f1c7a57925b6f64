"""Refit's per-leaf statistics on the device.

No Pallas counterpart: the JAX package refits on the host, in numpy
(lightgbm_tpu/boosting/gbdt.py:775-813 ``refit``): for each tree, the
leaf of every row, then ``np.bincount`` of the leaves weighted by the f64
gradients and hessians, and the row counts. The port keeps the gradients
and the leaves on the device:

  * :func:`leaf_segments` groups the rows by leaf, in row order inside a
    leaf: one stable ``torch.sort`` of the leaf index (the sort the
    renewal shares, ops/renew.py), and each leaf's (start, count) from the
    integer counts;
  * :func:`leaf_sums` adds each leaf's grad and hess and counts its rows:
    the ``leaf_sums`` CUDA kernel (``csrc/leaf_sums.cu``) for tensors on
    the card, :func:`leaf_sums_plain` for tensors on the CPU.

Each sum adds the leaf's values one after another from +0.0 in row order:
the order of np.bincount, so on equal gradients the sums equal the JAX
package's bit for bit, and the order the plain version's CPU cumsum keeps
(a sequential f64 loop). No float atomics, no order that depends on the
launch.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError
from . import counters


def leaf_segments(leaf: torch.Tensor, num_leaves: int):
    """(order, seg) of a tree's [n] leaf index per row (any integer
    dtype, values in [0, num_leaves)): order [n] int64, the rows by
    ascending leaf, row order inside a leaf (a stable sort); seg
    [num_leaves, 2] int64, leaf i's (start, count) in order."""
    _, order = torch.sort(leaf, stable=True)
    count = torch.bincount(leaf.to(torch.int64), minlength=num_leaves)
    if count.numel() != num_leaves:
        raise LightGBMError("leaf_segments: a leaf index past %d"
                            % (num_leaves - 1))
    seg = torch.stack([torch.cumsum(count, 0) - count, count], 1)
    return order, seg.contiguous()


def leaf_sums_plain(order, grad, hess, seg, out) -> None:
    """The kernel's function in plain PyTorch: a loop over the leaves,
    each leaf's values added in order by a cumsum, which the CPU runs as
    one sequential f64 loop from 0 (on the card torch's cumsum is a
    parallel scan, so this order holds on the CPU only). The f32 values
    are widened to f64 first, as the kernel widens them."""
    for i, (start, n) in enumerate(seg.tolist()):
        rows = order[start:start + n]
        for c, v in enumerate((grad, hess)):
            out[i, c] = (torch.cumsum(v.index_select(0, rows)
                                      .to(torch.float64), 0)[-1]
                         if n else 0.0)
        out[i, 2] = float(n)
    counters.bump(order.device, "leaf_sums")


def _launch(order, grad, hess, seg, out) -> None:
    from .build import load
    fn = load("leaf_sums").leaf_sums_launch
    P, I = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [P, P, P, P, I, P, P, P]
    fn.restype = I
    err = fn(P(order.data_ptr()), P(grad.data_ptr()), P(hess.data_ptr()),
             P(seg.data_ptr()), seg.shape[0], P(out.data_ptr()),
             counters.ptr(out.device, "leaf_sums"),
             P(torch.cuda.current_stream(out.device).cuda_stream))
    if err != 0:
        raise LightGBMError("leaf_sums launch failed: CUDA error %d" % err)


def leaf_sums(order, grad, hess, seg, out) -> None:
    """out[i] = (sum of grad, sum of hess, row count) of leaf i's rows
    order[start:start + count] (seg[i] = (start, count)), each sum in row
    order from +0.0 (the module docstring).

    order [n] int64 and seg [L, 2] int64 (:func:`leaf_segments`); grad,
    hess [n] f32 by row, added in f64; out [L, 3] f64, written for every leaf (an empty
    leaf: zeros). All contiguous, on one device. One launch for tensors on
    the card; the plain version for tensors on the CPU."""
    if order.dtype != torch.int64 or order.dim() != 1 \
            or not order.is_contiguous():
        raise LightGBMError("leaf_sums: order must be a contiguous [n] "
                            "int64 tensor")
    for name, v in (("grad", grad), ("hess", hess)):
        if v.dtype != torch.float32 or v.dim() != 1 \
                or not v.is_contiguous() or v.shape[0] != order.shape[0]:
            raise LightGBMError("leaf_sums: %s must be a contiguous [n] f32 "
                                "tensor" % name)
    if seg.dtype != torch.int64 or seg.dim() != 2 or seg.shape[1] != 2 \
            or not seg.is_contiguous():
        raise LightGBMError("leaf_sums: seg must be a contiguous [L, 2] "
                            "int64 tensor")
    if out.dtype != torch.float64 or out.shape != (seg.shape[0], 3) \
            or not out.is_contiguous():
        raise LightGBMError("leaf_sums: out must be a contiguous [L, 3] f64 "
                            "tensor")
    dev = order.device
    if any(t.device != dev for t in (grad, hess, seg, out)):
        raise LightGBMError("leaf_sums: operands on different devices")
    if dev.type == "cpu":
        return leaf_sums_plain(order, grad, hess, seg, out)
    if dev.type != "cuda":
        raise LightGBMError("leaf_sums: no kernel for device %s" % dev)
    if seg.shape[0] == 0:
        return
    _launch(order, grad, hess, seg, out)
    leaf_sums.launches += 1


leaf_sums.launches = 0


def per_leaf_sums(leaf, grad, hess, num_leaves: int) -> torch.Tensor:
    """[num_leaves, 3] f64 (sum grad, sum hess, count) of a tree's rows
    from row-ordered inputs: leaf [n] integer, grad and hess [n] f32."""
    order, seg = leaf_segments(leaf, num_leaves)
    out = torch.empty((num_leaves, 3), dtype=torch.float64,
                      device=leaf.device)
    leaf_sums(order, grad.contiguous(), hess.contiguous(), seg, out)
    return out
