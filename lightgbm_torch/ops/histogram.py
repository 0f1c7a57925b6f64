"""Per-group (grad, hess) histogram of one contiguous row segment.

The port of lightgbm_tpu/ops/pallas_histogram.py:hist_window. The TPU
kernel takes a transposed ``[G, C]`` int32 window and values already masked
to the window; the port takes the grower's natural layout instead: the
row-major ``[N, G]`` uint8 payload and the segment ``[start, start +
length)`` of the leaf, so no window is transposed or masked per split.

:func:`hist_window` launches the CUDA kernel (``csrc/hist_window.cu``) for
tensors on the card and takes :func:`hist_window_plain`, the same function
in plain PyTorch, for tensors on the CPU. Nothing else: a tensor elsewhere
raises, and a failed build or launch raises.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils.log import LightGBMError

# how a segment is cut into row blocks (csrc/hist_window.cu): about four
# blocks per SM of an H100 over all groups, and no block under 16384 rows,
# so short segments stay one block
_TARGET_BLOCKS = 528
_MIN_BLOCK_ROWS = 16384


def row_blocks(length: int, G: int):
    """(nblocks, rows_per_block) of a segment: a function of its length and
    group count only, shared by the kernel and the plain version so both
    add in the same order."""
    per_group = max(1, -(-_TARGET_BLOCKS // max(G, 1)))
    rows = max(_MIN_BLOCK_ROWS, -(-length // per_group))
    return max(1, -(-length // rows)), rows


def _chain(bins, grad, hess, start, length, w):
    """[G * w, 2] sums of one row block: each bin one f32 chain in row order
    (index_add_ on the CPU adds the rows one by one, in order)."""
    G = bins.shape[1]
    seg = bins[start:start + length].to(torch.int64)               # [R, G]
    vals = torch.stack([grad[start:start + length],
                        hess[start:start + length]], dim=-1)       # [R, 2]
    idx = seg + torch.arange(G, device=bins.device)[None, :] * w   # [R, G]
    keep = seg < w
    out = torch.zeros((G * w, 2), dtype=torch.float32, device=bins.device)
    return out.index_add_(0, idx[keep],
                          vals[:, None, :].expand(-1, G, -1)[keep])


def hist_window_plain(bins: torch.Tensor, grad: torch.Tensor,
                      hess: torch.Tensor, start: int, length: int,
                      w: int) -> torch.Tensor:
    """[G, w, 2] f32 histogram of rows [start, start + length) in plain
    PyTorch: out[g, b] sums (grad, hess) over the rows whose bin in group
    g is b; bins >= w are ignored.

    The segment is cut into :func:`row_blocks`; within a block each bin is
    one f32 chain in row order, and the blocks' sums are added in block
    order. On the CPU that is the CUDA kernel's arithmetic, bit for bit.
    (On the card index_add_ uses atomics, and agrees within f32 rounding.)
    """
    nblocks, rows = row_blocks(length, bins.shape[1])
    out = None
    for b in range(nblocks):
        part = _chain(bins, grad, hess, start + b * rows,
                      min(rows, length - b * rows), w)
        out = part if out is None else out + part
    return out.reshape(bins.shape[1], w, 2)


def _check(bins, grad, hess, start, length, w):
    if bins.dtype != torch.uint8 or bins.dim() != 2:
        raise LightGBMError("hist_window: bins must be [N, G] uint8, got %s %s"
                            % (tuple(bins.shape), bins.dtype))
    for name, v in (("grad", grad), ("hess", hess)):
        if v.dtype != torch.float32 or v.dim() != 1 \
                or v.shape[0] != bins.shape[0]:
            raise LightGBMError("hist_window: %s must be [N] float32" % name)
        if v.device != bins.device:
            raise LightGBMError("hist_window: %s is on %s, bins on %s"
                                % (name, v.device, bins.device))
    if not (bins.is_contiguous() and grad.is_contiguous()
            and hess.is_contiguous()):
        raise LightGBMError("hist_window: inputs must be contiguous")
    if not (0 <= start and 0 <= length and start + length <= bins.shape[0]):
        raise LightGBMError("hist_window: segment [%d, %d) outside %d rows"
                            % (start, start + length, bins.shape[0]))
    if not 1 <= w <= 256 or bins.shape[1] < 1:
        raise LightGBMError("hist_window: width %d outside [1, 256] or no "
                            "groups" % w)


def _launch(bins, grad, hess, start, length, w):
    from .build import load
    lib = load("hist_window")
    fn = lib.hist_window_launch
    P, LL, I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [P, P, P, LL, LL, I, I, I, LL, P, P, P]
    fn.restype = I
    G = bins.shape[1]
    nblocks, rows = row_blocks(length, G)
    out = torch.empty((G, w, 2), dtype=torch.float32, device=bins.device)
    partial = out if nblocks == 1 else torch.empty(
        (nblocks, G, w, 2), dtype=torch.float32, device=bins.device)
    stream = torch.cuda.current_stream(bins.device).cuda_stream
    err = fn(bins.data_ptr(), grad.data_ptr(), hess.data_ptr(), start,
             length, G, w, nblocks, rows, partial.data_ptr(), out.data_ptr(),
             stream)
    if err != 0:
        raise LightGBMError("hist_window kernel launch failed: CUDA error %d"
                            % err)
    return out


def hist_window(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
                start: int, length: int, w: int) -> torch.Tensor:
    """[G, w, 2] f32 histogram of rows [start, start + length) of the
    [N, G] uint8 payload: the CUDA kernel for tensors on the card, the
    plain version for tensors on the CPU. Deterministic on both."""
    start, length, w = int(start), int(length), int(w)
    _check(bins, grad, hess, start, length, w)
    if bins.device.type == "cpu":
        return hist_window_plain(bins, grad, hess, start, length, w)
    if bins.device.type != "cuda":
        raise LightGBMError("hist_window: no kernel for device %s"
                            % bins.device)
    out = _launch(bins, grad, hess, start, length, w)
    hist_window.launches += 1
    return out


hist_window.launches = 0
