"""The persistent grower's payload kernels: root_hist, split_pass, seg_hist,
level_pass and level_seg_hist.

The port of lightgbm_tpu/ops/pallas_grow.py: the scalar slots of a split
(``S_*``, pallas_grow.py:83-98), the group-bin decode
(``_unpack_group_bins``:209) and the wrappers of five kernels, each beside
its plain PyTorch version:

  * :func:`root_hist` (``make_root_hist``:944 -> ``csrc/root_hist.cu``):
    the histogram of lanes [0, n) and the grad/hess totals;
  * :func:`split_pass` (``make_split_pass``:292 -> ``csrc/split_pass.cu``):
    the stable partition of one leaf's segment from one payload buffer into
    the other, its n_left and, where the grower asks for it, the smaller
    child's histogram;
  * :func:`seg_hist` (``make_seg_hist``:866 -> ``csrc/seg_hist.cu``): the
    histogram of one contiguous segment;
  * :func:`level_pass` (``make_level_pass``:543 -> ``csrc/level_pass.cu``):
    split_pass for every splitting leaf of a tree level at once, each slot's
    scalars one row of an [S, 16] matrix;
  * :func:`level_seg_hist` (``make_level_seg_hist``:785 ->
    ``csrc/level_seg_hist.cu``): seg_hist of S segments at once;
  * :func:`consolidate` (in ``csrc/split_pass.cu``; no TPU counterpart, the
    TPU kernels partition in place): the copy of the segments that a tree
    left in the second buffer back into the payload.

The persistent grower's per-split loop runs these kernels in their device
form (:func:`split_pass_device`, :func:`seg_hist_device`,
:func:`consolidate_device`): the split's scalars, the segment and the
grower's "done" flag are read from device memory, n_left is written there,
and the grids are fixed, so nothing waits for the card between splits and
the loop can be captured in a CUDA graph. The host forms
(:func:`split_pass`, :func:`seg_hist`, :func:`consolidate`) upload their
arguments and launch the same kernels: one contract.

The payload is the [WPA, NP] int32 matrix of ops/payload.py. Histograms are
two f32 planes of [G * 256]: group g's bin b at g * 256 + b, the layout of
the TPU kernels' ``_unpack_hist`` output, without the bf16 hi/lo
accumulator that exists only for the MXU. They are summed in the order of
``ops/histogram.py:hist_window``: the segment is cut into ``row_blocks``,
each bin is one f32 chain in lane order inside a block, and the blocks are
added in order. On the CPU a payload histogram therefore equals the v1
grower's ``hist_window`` histogram of the same rows.

Each wrapper launches its CUDA kernel for a payload on the card and takes
the plain version for a payload on the CPU; nothing else. A tensor
elsewhere raises, and a failed build or launch raises. ``split_pass`` and
``level_pass`` read their segments from one buffer (``src``) and write the
partitioned segments to the other (``dst``) at the same lanes; ``src`` is
not written. The grower keeps the two buffers (ops/grow_persist.py: a leaf
at depth d lives in buffer d % 2). The TPU kernels partition in place
instead, aliasing their payload input to their output.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..utils.log import LightGBMError
from . import counters
from .histogram import _chain, row_blocks

# scalar slots of one split (pallas_grow.py:83-98)
S_NCH = 0         # number of payload chunks of the segment (TPU only)
S_S0 = 1          # segment start lane
S_NL = 2          # segment length
S_WG = 3          # payload word row of the split feature's slot
S_SH = 4          # shift of the feature's bits inside the word
S_MASK = 5        # value mask after the shift (15 nibble / 255 byte)
S_NB = 6          # feature bin count
S_MT = 7          # missing type (0 none / 1 zero / 2 nan)
S_DB = 8          # default (zero) bin
S_THR = 9         # threshold (local bin)
S_DL = 10         # default_left flag
S_SMALL_L = 11    # the smaller child is the left one
S_LS = 12         # feature's group-local bin range start (EFB bundles)
S_LE = 13         # range end; bins outside [LS, LE) read as most_freq
S_MF = 14         # most_freq (feature-local) bin
N_SCALARS = 15
LEVEL_COLS = 16   # a level slot's row: the S_* slots and one unused column

HIST_W = 256      # bins per group plane


def unpack_group_bins(pay: torch.Tensor, plan, start: int,
                      length: int) -> torch.Tensor:
    """[length, G] int64 group-local bins of lanes [start, start + length),
    decoded through plan[g] = (word_row, shift, mask). The mask after the
    shift also clears what an arithmetic shift of int32 brings in."""
    cols = [(pay[w, start:start + length] >> sh) & mk for w, sh, mk in plan]
    return torch.stack(cols, dim=1).to(torch.int64)


def _plan_list(plan: torch.Tensor):
    return [tuple(int(v) for v in row) for row in plan.tolist()]


def seg_hist_plain(pay: torch.Tensor, plan: torch.Tensor, nbw: int,
                   start: int, length: int):
    """(grad plane, hess plane), [G * 256] f32 each: the histogram of lanes
    [start, start + length) in plain PyTorch, in the kernel's order."""
    G = plan.shape[0]
    bins = unpack_group_bins(pay, _plan_list(plan), start, length)
    grad = pay[nbw + 2, start:start + length].view(torch.float32)
    hess = pay[nbw + 3, start:start + length].view(torch.float32)
    nblocks, rows = row_blocks(length, G)
    out = None
    for b in range(nblocks):
        part = _chain(bins, grad, hess, b * rows,
                      min(rows, length - b * rows), HIST_W)
        out = part if out is None else out + part
    return out[:, 0].contiguous(), out[:, 1].contiguous()


def root_hist_plain(pay: torch.Tensor, plan: torch.Tensor, nbw: int, n: int):
    """(grad plane, hess plane, sums [2] f32): seg_hist over lanes [0, n),
    and the f64 sums of the grad and hess rows rounded to f32."""
    gh, hh = seg_hist_plain(pay, plan, nbw, 0, n)
    gh_h = pay[nbw + 2:nbw + 4, :n].view(torch.float32)
    sums = gh_h.double().sum(dim=1).float()
    return gh, hh, sums


def go_left_plain(word: torch.Tensor, scal) -> torch.Tensor:
    """DenseBin::Split (dense_bin.hpp:112) at the bin level, per lane of the
    split feature's payload word (make_xla_split_pass:417-426)."""
    b_raw = (word >> scal[S_SH]) & scal[S_MASK]
    in_r = (b_raw >= scal[S_LS]) & (b_raw < scal[S_LE])
    b = torch.where(in_r, b_raw - scal[S_LS], scal[S_MF])
    go_left = b <= scal[S_THR]
    if scal[S_MT] == 2:
        go_left = torch.where(b == scal[S_NB] - 1, scal[S_DL] > 0, go_left)
    elif scal[S_MT] == 1:
        go_left = torch.where(b == scal[S_DB], scal[S_DL] > 0, go_left)
    return go_left


def _child(scal, n_left: int):
    """(start, length) of the smaller child after the partition."""
    s0, n_l = scal[S_S0], scal[S_NL]
    if scal[S_SMALL_L] > 0:
        return s0, n_left
    return s0 + n_left, n_l - n_left


def split_pass_plain(src: torch.Tensor, dst: torch.Tensor, scal,
                     plan: torch.Tensor, nbw: int, wp_live: int,
                     with_hist: bool):
    """Partition the segment of `scal` from `src` into `dst` at the same
    lanes (rows < wp_live, left lanes first, each side in its old order) in
    plain PyTorch; `src` is not written. Returns (n_left, the smaller
    child's (grad, hess) planes in `dst` or None)."""
    s0, n_l = scal[S_S0], scal[S_NL]
    n_left = 0
    if n_l > 0:
        go_left = go_left_plain(src[scal[S_WG], s0:s0 + n_l], scal)
        left = torch.nonzero(go_left).squeeze(1)
        order = torch.cat([left, torch.nonzero(~go_left).squeeze(1)])
        dst[:wp_live, s0:s0 + n_l] = src[:wp_live, s0:s0 + n_l][:, order]
        n_left = int(left.numel())
    hist = None
    if with_hist:
        hist = seg_hist_plain(dst, plan, nbw, *_child(scal, n_left))
    return n_left, hist


def consolidate_plain(src: torch.Tensor, dst: torch.Tensor, segs,
                      wp_live: int) -> None:
    """Copy rows < wp_live of every (start, length) segment of `segs` from
    `src` to `dst`, in plain PyTorch."""
    for st, ln in segs:
        dst[:wp_live, st:st + ln] = src[:wp_live, st:st + ln]


# ---- wrappers -------------------------------------------------------------

def _check(name, pay, plan, nbw, lanes):
    if pay.dtype != torch.int32 or pay.dim() != 2 or not pay.is_contiguous():
        raise LightGBMError("%s: the payload must be a contiguous [WPA, NP] "
                            "int32 tensor, got %s %s"
                            % (name, tuple(pay.shape), pay.dtype))
    if plan.dtype != torch.int32 or plan.dim() != 2 or plan.shape[1] != 3 \
            or plan.shape[0] < 1 or not plan.is_contiguous():
        raise LightGBMError("%s: the plan must be a contiguous [G, 3] int32 "
                            "tensor" % name)
    if plan.device != pay.device:
        raise LightGBMError("%s: the plan is on %s, the payload on %s"
                            % (name, plan.device, pay.device))
    if not 0 <= nbw or nbw + 4 > pay.shape[0]:
        raise LightGBMError("%s: nbw=%d leaves no grad/hess rows in %d"
                            % (name, nbw, pay.shape[0]))
    start, length = lanes
    if not (0 <= start and 0 <= length and start + length <= pay.shape[1]):
        raise LightGBMError("%s: lanes [%d, %d) outside %d"
                            % (name, start, start + length, pay.shape[1]))
    if pay.device.type not in ("cpu", "cuda"):
        raise LightGBMError("%s: no kernel for device %s" % (name, pay.device))


def _check_pair(name, src, dst, wp_live):
    """The two buffers of a partition: contiguous 2-D int32, the same
    device and lane stride, at least wp_live rows each, and not the same
    memory."""
    for what, t in (("src", src), ("dst", dst)):
        if t.dtype != torch.int32 or t.dim() != 2 or not t.is_contiguous():
            raise LightGBMError("%s: %s must be a contiguous 2-D int32 "
                                "tensor, got %s %s" % (name, what,
                                                       tuple(t.shape),
                                                       t.dtype))
    if dst.device != src.device or dst.shape[1] != src.shape[1]:
        raise LightGBMError("%s: src %s on %s and dst %s on %s differ in "
                            "device or lanes" % (name, tuple(src.shape),
                                                 src.device, tuple(dst.shape),
                                                 dst.device))
    if not wp_live <= min(src.shape[0], dst.shape[0]):
        raise LightGBMError("%s: wp_live=%d rows, src has %d and dst %d"
                            % (name, wp_live, src.shape[0], dst.shape[0]))
    if src.device.type != "meta" and \
            src.untyped_storage().data_ptr() == \
            dst.untyped_storage().data_ptr():
        raise LightGBMError("%s: src and dst share their memory; the "
                            "partition writes the other buffer" % name)


def _void(t):
    return ctypes.c_void_p(t.data_ptr())


def _stream(t):
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def _hist_buffers(pay, G, length, sums):
    """(nblocks, rows, partial, out) of a payload histogram launch."""
    nblocks, rows = row_blocks(length, G)
    out = torch.empty((2, G * HIST_W), dtype=torch.float32, device=pay.device)
    partial = out if nblocks == 1 and not sums else torch.empty(
        (nblocks, 2, G * HIST_W), dtype=torch.float32, device=pay.device)
    return nblocks, rows, partial, out


_P, _LL, _I = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
_HIST_ARGS = [_P, _LL, _P, _I, _I, _LL, _LL, _I, _LL, _P, _P, _P]
_DEV_HIST_ARGS = [_P, _P, _P, _LL, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P]


def _launch_hist(lib_name, fn_name, pay, plan, nbw, start, length):
    """A host-segment histogram launcher (the ownership witness,
    ``ownership_hist_launch``): (grad plane, hess plane) of lanes [start,
    start + length)."""
    from .build import load
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = _HIST_ARGS
    fn.restype = _I
    G = plan.shape[0]
    nblocks, rows, partial, out = _hist_buffers(pay, G, length, False)
    err = fn(_void(pay), pay.shape[1], _void(plan), G, nbw + 2, start,
             length, nblocks, rows, _void(partial), _void(out), _stream(pay))
    if err != 0:
        raise LightGBMError("%s kernel launch failed: CUDA error %d"
                            % (lib_name, err))
    return out[0], out[1]


def _opt(t):
    return None if t is None else _void(t)


def _launch_hist_dev(fn_name, pay, plan, nbw, seg, out, partial, done,
                     counter=None, alt=None, swap=None):
    """Queue a device-segment histogram launcher (seg_hist's, or
    split_pass's in-pass one) into `out` [2, G * 256], of `pay` (of `alt`
    when the device flag `swap` is set)."""
    from .build import load
    lib = "seg_hist" if fn_name == "seg_hist_launch" else "split_pass"
    fn = getattr(load(lib), fn_name)
    G = plan.shape[0]
    if fn_name == "seg_hist_launch":
        fn.argtypes = _DEV_HIST_ARGS
        extra = (counter,)
    else:
        fn.argtypes = _DEV_HIST_ARGS[:-2] + [_P]
        extra = ()
    fn.restype = _I
    err = fn(_void(pay), _opt(alt), _opt(swap), pay.shape[1], _void(plan),
             G, nbw + 2, _void(seg), _opt(done), partial.shape[0],
             _void(partial), _void(out), *extra, _stream(pay))
    if err != 0:
        raise LightGBMError("%s kernel launch failed: CUDA error %d"
                            % (lib, err))


def _check_dev(name, t, shape, dtype, device):
    if tuple(t.shape) != tuple(shape) or t.dtype != dtype \
            or t.device != device or not t.is_contiguous():
        raise LightGBMError("%s is %s %s on %s; expected contiguous %s %s "
                            "on %s" % (name, tuple(t.shape), t.dtype,
                                       t.device, dtype, tuple(shape),
                                       device))


def hist_scratch(pay, G: int, max_length: int):
    """(out [2, G * 256], partial [row blocks of max_length, 2, G * 256])
    f32 buffers of a device-segment histogram of at most max_length
    lanes."""
    nb = row_blocks(int(max_length), G)[0]
    return (torch.empty((2, G * HIST_W), dtype=torch.float32,
                        device=pay.device),
            torch.empty((nb, 2, G * HIST_W), dtype=torch.float32,
                        device=pay.device))


def seg_hist_device(pay: torch.Tensor, plan: torch.Tensor, nbw: int,
                    seg: torch.Tensor, out: torch.Tensor,
                    partial: torch.Tensor, done=None, alt=None,
                    swap=None) -> None:
    """The histogram of the device segment ``seg`` (int64 [2]: start,
    length) into ``out`` [2, G * 256] f32: the CUDA kernel for a payload
    on the card, the plain version on the CPU; nothing when ``done``
    (int64 [1]) is set. With ``swap`` (int64 [1]) set, the lanes are read
    from ``alt`` (the other payload buffer, same lanes) instead of
    ``pay``. ``partial`` is the [n, 2, G * 256] scratch of
    :func:`hist_scratch`, n the row blocks of the longest segment the call
    may name (the kernel does not check). Nothing is read back."""
    nbw = int(nbw)
    _check("seg_hist", pay, plan, nbw, (0, 0))
    G, dev = plan.shape[0], pay.device
    _check_dev("seg_hist: seg", seg, (2,), torch.int64, dev)
    _check_dev("seg_hist: out", out, (2, G * HIST_W), torch.float32, dev)
    if partial.dim() != 3 or tuple(partial.shape[1:]) != (2, G * HIST_W):
        raise LightGBMError("seg_hist: partial must be [n, 2, %d]"
                            % (G * HIST_W))
    if done is not None:
        _check_dev("seg_hist: done", done, (1,), torch.int64, dev)
    if (alt is None) != (swap is None):
        raise LightGBMError("seg_hist: alt and swap go together")
    if alt is not None:
        _check_pair("seg_hist", alt, pay, nbw + 4)
        _check_dev("seg_hist: swap", swap, (1,), torch.int64, dev)
    if dev.type == "cpu":
        if done is not None and int(done[0]):
            return
        st, ln = (int(v) for v in seg.tolist())
        src = alt if swap is not None and int(swap[0]) else pay
        gh, hh = seg_hist_plain(src, plan, nbw, st, ln)
        out[0].copy_(gh)
        out[1].copy_(hh)
        counters.bump(dev, "seg_hist")
        return
    _launch_hist_dev("seg_hist_launch", pay, plan, nbw, seg, out, partial,
                     done, counters.ptr(dev, "seg_hist"), alt, swap)
    seg_hist_device.launches += 1


seg_hist_device.launches = 0


def seg_hist(pay: torch.Tensor, plan: torch.Tensor, nbw: int, start: int,
             length: int):
    """(grad plane, hess plane) of lanes [start, start + length): the CUDA
    kernel for a payload on the card (the segment uploaded, then
    :func:`seg_hist_device`'s launch), the plain version on the CPU."""
    start, length, nbw = int(start), int(length), int(nbw)
    _check("seg_hist", pay, plan, nbw, (start, length))
    if pay.device.type == "cpu":
        return seg_hist_plain(pay, plan, nbw, start, length)
    out, partial = hist_scratch(pay, plan.shape[0], length)
    seg = torch.tensor([start, length], dtype=torch.int64, device=pay.device)
    _launch_hist_dev("seg_hist_launch", pay, plan, nbw, seg, out, partial,
                     None, counters.ptr(pay.device, "seg_hist"))
    seg_hist.launches += 1
    return out[0], out[1]


seg_hist.launches = 0


def root_scratch(pay: torch.Tensor, G: int, n: int):
    """The buffers of a root_hist launch over n lanes: (planes [2, G * 256]
    f32, sums [2] f32, partial [row blocks, 2, G * 256] f32, sums partial
    [row blocks, 2] f64), allocated once by a caller that launches it
    again at fixed addresses (the grower's CUDA graph)."""
    nblocks = row_blocks(int(n), G)[0]
    dev = pay.device
    return (torch.empty((2, G * HIST_W), dtype=torch.float32, device=dev),
            torch.empty(2, dtype=torch.float32, device=dev),
            torch.empty((nblocks, 2, G * HIST_W), dtype=torch.float32,
                        device=dev),
            torch.empty((nblocks, 2), dtype=torch.float64, device=dev))


def root_hist(pay: torch.Tensor, plan: torch.Tensor, nbw: int, n: int,
              out=None):
    """(grad plane, hess plane, sums [2] f32) over lanes [0, n): the CUDA
    kernel for a payload on the card, the plain version on the CPU.

    The totals are f64 sums rounded to f32, the same value on any device
    (ops/grow.py's convention). The TPU kernel sums them in f32 chunk
    partials instead; the two differ by f32 rounding (the tests hold
    it). ``out``, where given, is :func:`root_scratch`'s buffers: the
    results are written to its planes and sums."""
    n, nbw = int(n), int(nbw)
    _check("root_hist", pay, plan, nbw, (0, n))
    G = plan.shape[0]
    if out is None:
        out = root_scratch(pay, G, n)
    planes, sums, partial, sums_partial = out
    _check_dev("root_hist: planes", planes, (2, G * HIST_W), torch.float32,
               pay.device)
    _check_dev("root_hist: sums", sums, (2,), torch.float32, pay.device)
    nblocks, rows = row_blocks(n, G)
    if partial.shape[0] != nblocks:
        raise LightGBMError("root_hist: scratch for %d row blocks, %d lanes "
                            "need %d" % (partial.shape[0], n, nblocks))
    if pay.device.type == "cpu":
        gh, hh, s_ = root_hist_plain(pay, plan, nbw, n)
        planes[0].copy_(gh)
        planes[1].copy_(hh)
        sums.copy_(s_)
        counters.bump(pay.device, "root_hist")
        return planes[0], planes[1], sums
    from .build import load
    fn = load("root_hist").root_hist_launch
    fn.argtypes = [_P, _LL, _P, _I, _I, _LL, _I, _LL, _P, _P, _P, _P, _P, _P]
    fn.restype = _I
    err = fn(_void(pay), pay.shape[1], _void(plan), G, nbw + 2, n, nblocks,
             rows, _void(partial), _void(planes), _void(sums_partial),
             _void(sums), counters.ptr(pay.device, "root_hist"),
             _stream(pay))
    if err != 0:
        raise LightGBMError("root_hist kernel launch failed: CUDA error %d"
                            % err)
    root_hist.launches += 1
    return planes[0], planes[1], sums


root_hist.launches = 0


def split_scratch(src: torch.Tensor) -> torch.Tensor:
    """The int32 [2, tiles] tile counts and offsets of a partition of any
    segment of `src`'s lanes (one tile per 1024 lanes)."""
    return torch.empty((2, max(1, -(-src.shape[1] // 1024))),
                       dtype=torch.int32, device=src.device)


def _launch_split(src, dst, scal, res, wp_live, work, done=None, swap=None):
    """Queue the partition kernels of the device scalars `scal` from `src`
    into `dst` (the other way when `swap` is set) on the card; n_left and
    the smaller child go to `res`."""
    from .build import load
    fn = load("split_pass").split_pass_launch
    fn.argtypes = [_P, _P, _LL, _I, _P, _P, _P, _LL, _P, _P, _P, _P, _P]
    fn.restype = _I
    err = fn(_void(src), _void(dst), src.shape[1], wp_live, _void(scal),
             _opt(done), _opt(swap), work.shape[1], _void(work[0]),
             _void(work[1]),
             _void(res), counters.ptr(src.device, "split_pass"),
             _stream(src))
    if err != 0:
        raise LightGBMError("split_pass kernel launch failed: CUDA error %d"
                            % err)


def _split_args(src, dst, plan, nbw, wp_live):
    nbw, wp_live = int(nbw), int(wp_live)
    _check("split_pass", src, plan, nbw, (0, 0))
    if wp_live < nbw + 4:
        raise LightGBMError("split_pass: wp_live=%d leaves the grad/hess "
                            "rows behind (nbw + 4 = %d)" % (wp_live, nbw + 4))
    _check_pair("split_pass", src, dst, wp_live)
    return nbw, wp_live


def split_pass_device(src: torch.Tensor, dst: torch.Tensor,
                      scal: torch.Tensor, res: torch.Tensor,
                      plan: torch.Tensor, nbw: int, wp_live: int, hist=None,
                      done=None, work=None, swap=None) -> None:
    """The device form of :func:`split_pass`: the scalars are the int32
    [N_SCALARS] (or longer) tensor ``scal`` on the payload's device, and
    ``res`` (int64 [3]) receives n_left and the smaller child's (start,
    length); nothing is read back. ``hist``, where given, is the (out,
    partial) pair of :func:`hist_scratch` that receives the smaller
    child's planes from `dst`. With ``done`` (int64 [1]) set, nothing is
    written. With ``swap`` (int64 [1]) set, the partition runs from `dst`
    into `src` (the grower's buffer parity: the leaf's buffer is picked on
    the device). ``work`` is :func:`split_scratch` (allocated when None). The
    CUDA kernels for buffers on the card, the plain version on the CPU; the
    kernels do not check the scalars (the caller keeps the segment inside
    the buffers and the word row a bin word)."""
    nbw, wp_live = _split_args(src, dst, plan, nbw, wp_live)
    dev = src.device
    if scal.dtype != torch.int32 or scal.dim() != 1 \
            or scal.numel() < N_SCALARS or scal.device != dev:
        raise LightGBMError("split_pass: scal must be an int32 [>= %d] "
                            "tensor on %s" % (N_SCALARS, dev))
    _check_dev("split_pass: res", res, (3,), torch.int64, dev)
    for name, flag in (("done", done), ("swap", swap)):
        if flag is not None:
            _check_dev("split_pass: " + name, flag, (1,), torch.int64, dev)
    if dev.type == "cpu":
        if done is not None and int(done[0]):
            return
        if swap is not None and int(swap[0]):
            src, dst = dst, src
        sc = [int(v) for v in scal[:N_SCALARS].tolist()]
        n_left, h = split_pass_plain(src, dst, sc, plan, nbw, wp_live,
                                     hist is not None)
        res.copy_(torch.tensor([n_left, *_child(sc, n_left)]))
        if hist is not None:
            hist[0][0].copy_(h[0])
            hist[0][1].copy_(h[1])
        counters.bump(dev, "split_pass")
        return
    _launch_split(src, dst, scal, res, wp_live,
                  split_scratch(src) if work is None else work, done, swap)
    if hist is not None:
        _launch_hist_dev("split_pass_hist_launch", dst, plan, nbw, res[1:],
                         hist[0], hist[1], done,
                         alt=None if swap is None else src, swap=swap)
    split_pass_device.launches += 1


split_pass_device.launches = 0


def split_pass(src: torch.Tensor, dst: torch.Tensor, scal,
               plan: torch.Tensor, nbw: int, wp_live: int, with_hist: bool):
    """Partition one leaf's segment from `src` into `dst` (the same lanes,
    rows < wp_live; `src` is not written): the CUDA kernel for a payload on
    the card, the plain version on the CPU. `scal` is the host sequence of
    the N_SCALARS slots; on the card it is uploaded and the kernels of
    :func:`split_pass_device` run on it. Returns (n_left, the smaller
    child's (grad, hess) planes, from `dst`, when `with_hist`, else None).
    Reading n_left back waits for the card."""
    scal = [int(v) for v in scal]
    if len(scal) != N_SCALARS:
        raise LightGBMError("split_pass: %d scalars, expected %d"
                            % (len(scal), N_SCALARS))
    nbw, wp_live = _split_args(src, dst, plan, nbw, wp_live)
    _check("split_pass", src, plan, nbw, (scal[S_S0], scal[S_NL]))
    if not 0 <= scal[S_WG] < nbw:
        raise LightGBMError("split_pass: word row %d is not a bin word"
                            % scal[S_WG])
    if src.device.type == "cpu":
        return split_pass_plain(src, dst, scal, plan, nbw, wp_live,
                                with_hist)
    dev = src.device
    scal_d = torch.tensor(scal, dtype=torch.int32, device=dev)
    res = torch.empty(3, dtype=torch.int64, device=dev)
    hist = hist_scratch(dst, plan.shape[0], scal[S_NL]) if with_hist \
        else None
    _launch_split(src, dst, scal_d, res, wp_live, split_scratch(src))
    if hist is not None:
        _launch_hist_dev("split_pass_hist_launch", dst, plan, nbw, res[1:],
                         hist[0], hist[1], None)
    split_pass.launches += 1
    return int(res[0].item()), \
        None if hist is None else (hist[0][0], hist[0][1])


split_pass.launches = 0


def _launch_consolidate(src, dst, wp_live, tab, max_tiles, counter=True):
    """Queue the copy of the segments of the device table `tab` (int64
    [K, 2]: start, length) from `src` to `dst` on the card."""
    from .build import load
    fn = load("split_pass").consolidate_launch
    fn.argtypes = [_P, _P, _LL, _I, _P, _I, _LL, _P, _P]
    fn.restype = _I
    err = fn(_void(src), _void(dst), src.shape[1], wp_live, _void(tab),
             tab.shape[0], max_tiles,
             counters.ptr(src.device, "consolidate") if counter else None,
             _stream(src))
    if err != 0:
        raise LightGBMError("consolidate kernel launch failed: CUDA error %d"
                            % err)


def consolidate_device(src: torch.Tensor, dst: torch.Tensor,
                       tab: torch.Tensor, wp_live: int) -> None:
    """Copy rows < wp_live of the segments of the device table `tab`
    (int64 [K, 2]: start, length; length 0 is no segment; disjoint) from
    `src` to `dst`: one launch of the CUDA kernel over a fixed grid for
    buffers on the card, the plain version on the CPU. Nothing is read
    back; the kernel does not check the table."""
    wp_live = int(wp_live)
    _check_pair("consolidate", src, dst, wp_live)
    if tab.dtype != torch.int64 or tab.dim() != 2 or tab.shape[1] != 2 \
            or tab.device != src.device or not tab.is_contiguous():
        raise LightGBMError("consolidate: the table must be a contiguous "
                            "int64 [K, 2] tensor on %s" % src.device)
    if src.device.type == "cpu":
        segs = [(st, ln) for st, ln in tab.tolist() if ln > 0]
        consolidate_plain(src, dst, segs, wp_live)
        if segs:
            counters.bump(src.device, "consolidate")
        return
    if src.device.type != "cuda":
        raise LightGBMError("consolidate: no kernel for device %s"
                            % src.device)
    _launch_consolidate(src, dst, wp_live, tab, -(-src.shape[1] // 1024))
    consolidate_device.launches += 1


consolidate_device.launches = 0


def consolidate(src: torch.Tensor, dst: torch.Tensor, segs,
                wp_live: int) -> None:
    """Copy rows < wp_live of the disjoint (start, length) segments `segs`
    from `src` to `dst`: one launch of the CUDA kernel (the segments
    uploaded as :func:`consolidate_device`'s table) for buffers on the
    card, the plain version on the CPU. The grower's end-of-tree step: the
    odd-depth leaves' segments from the second buffer into the payload."""
    segs = [(int(st), int(ln)) for st, ln in segs]
    wp_live = int(wp_live)
    _check_pair("consolidate", src, dst, wp_live)
    if src.device.type not in ("cpu", "cuda"):
        raise LightGBMError("consolidate: no kernel for device %s"
                            % src.device)
    ends = sorted(segs)
    for (st, ln), nxt in zip(ends, ends[1:] + [(src.shape[1], 0)]):
        if st < 0 or ln < 0 or st + ln > nxt[0]:
            raise LightGBMError("consolidate: segment (%d, %d) overlaps "
                                "another or leaves the %d lanes"
                                % (st, ln, src.shape[1]))
    if src.device.type == "cpu":
        consolidate_plain(src, dst, segs, wp_live)
        return
    tiles = sum(-(-ln // 1024) for _, ln in segs)
    if tiles == 0:
        return                            # no lanes: nothing to launch
    tab = torch.tensor(segs, dtype=torch.int64, device=src.device)
    _launch_consolidate(src, dst, wp_live, tab, tiles)
    consolidate.launches += 1


consolidate.launches = 0


def level_seg_hist_plain(pay: torch.Tensor, plan: torch.Tensor, nbw: int,
                         segs):
    """(grad planes, hess planes), [S, G * 256] f32 each: seg_hist_plain of
    each (start, length) segment."""
    planes = [seg_hist_plain(pay, plan, nbw, st, ln) for st, ln in segs]
    return (torch.stack([p[0] for p in planes]),
            torch.stack([p[1] for p in planes]))


def level_pass_plain(src: torch.Tensor, dst: torch.Tensor, scal_mat,
                     plan: torch.Tensor, nbw: int, wp_live: int,
                     with_hist: bool):
    """split_pass_plain from `src` into `dst` over the rows of `scal_mat`
    ([S, LEVEL_COLS], one slot each, disjoint segments). Returns (n_left [S]
    int64 numpy, the smaller children's (grad, hess) planes [S, G * 256]
    or None)."""
    n_left = np.zeros(len(scal_mat), np.int64)
    hists = []
    for j, row in enumerate(np.asarray(scal_mat).tolist()):
        n_left[j], h = split_pass_plain(src, dst, row[:N_SCALARS], plan, nbw,
                                        wp_live, with_hist)
        hists.append(h)
    if not with_hist:
        return n_left, None
    return n_left, (torch.stack([h[0] for h in hists]),
                    torch.stack([h[1] for h in hists]))


def _segments(name, pay, plan, nbw, segs):
    segs = [(int(st), int(ln)) for st, ln in segs]
    if not segs:
        raise LightGBMError("%s: no segments" % name)
    for lanes in segs:
        _check(name, pay, plan, nbw, lanes)
    return segs


def _multi_hist_tables(segs, G, device):
    """The device tables of a many-segment histogram launch: the [S, 5]
    int64 segment table of payload_hist.cuh (start, length, rows per
    block, block count, first block; each segment cut by row_blocks as
    seg_hist cuts it) and the segment of every row block. The kernels'
    blocks are (row block, group); the row blocks of a segment are
    consecutive, in lane order."""
    cut = [row_blocks(ln, G) for _, ln in segs]
    nblk = np.array([nb for nb, _ in cut], np.int64)
    tab = np.stack([[st for st, _ in segs], [ln for _, ln in segs],
                    [rows for _, rows in cut], nblk,
                    np.cumsum(nblk) - nblk], axis=1).astype(np.int64)
    slot_of_block = np.repeat(np.arange(len(segs), dtype=np.int32), nblk)
    return (torch.as_tensor(tab, device=device),
            torch.as_tensor(slot_of_block, device=device))


def _launch_multi_hist(lib_name, fn_name, pay, plan, nbw, tables):
    """Queue the histograms of the segments of `tables`
    (:func:`_multi_hist_tables`) on the card: (grad planes, hess planes)
    [S, G * 256]."""
    from .build import load
    fn = getattr(load(lib_name), fn_name)
    fn.argtypes = [_P, _LL, _P, _I, _I, _P, _I, _P, _I, _P, _P, _P]
    fn.restype = _I
    tab_d, sob_d = tables
    G, S, nblocks = plan.shape[0], len(tab_d), len(sob_d)
    partial = torch.empty((nblocks, 2, G * HIST_W), dtype=torch.float32,
                          device=pay.device)
    out = torch.empty((2, S, G * HIST_W), dtype=torch.float32,
                      device=pay.device)
    err = fn(_void(pay), pay.shape[1], _void(plan), G, nbw + 2, _void(tab_d),
             S, _void(sob_d), nblocks, _void(partial), _void(out),
             _stream(pay))
    if err != 0:
        raise LightGBMError("%s kernel launch failed: CUDA error %d"
                            % (lib_name, err))
    return out[0], out[1]


def level_seg_hist(pay: torch.Tensor, plan: torch.Tensor, nbw: int, segs):
    """(grad planes, hess planes), [S, G * 256] f32 each, of S (start,
    length) payload segments: the CUDA kernel for a payload on the card,
    the plain version on the CPU. A zero-length segment gives zeros."""
    nbw = int(nbw)
    segs = _segments("level_seg_hist", pay, plan, nbw, segs)
    if pay.device.type == "cpu":
        return level_seg_hist_plain(pay, plan, nbw, segs)
    out = _launch_multi_hist("level_seg_hist", "level_seg_hist_launch", pay,
                             plan, nbw, _multi_hist_tables(
                                 segs, plan.shape[0], pay.device))
    level_seg_hist.launches += 1
    return out


level_seg_hist.launches = 0


def _check_level(src, dst, scal, plan, nbw, wp_live):
    if scal.ndim != 2 or scal.shape[1] != LEVEL_COLS or len(scal) < 1:
        raise LightGBMError("level_pass: the scalars must be an [S, %d] "
                            "matrix with S >= 1, got %s"
                            % (LEVEL_COLS, scal.shape))
    if wp_live < nbw + 4:
        raise LightGBMError("level_pass: wp_live=%d leaves the grad/hess "
                            "rows behind (nbw + 4 = %d)" % (wp_live, nbw + 4))
    for row in scal:
        _check("level_pass", src, plan, nbw, (int(row[S_S0]),
                                              int(row[S_NL])))
        if not 0 <= row[S_WG] < nbw:
            raise LightGBMError("level_pass: word row %d is not a bin word"
                                % row[S_WG])
    _check_pair("level_pass", src, dst, wp_live)
    order = np.argsort(scal[:, S_S0], kind="stable")
    s0, nl = scal[order, S_S0], scal[order, S_NL]
    if np.any(s0[1:] < s0[:-1] + nl[:-1]):
        raise LightGBMError("level_pass: the slots' segments overlap")


def _level_tables(scal, device):
    """The device tables of a level_pass launch from the host [S,
    LEVEL_COLS] matrix `scal`: the int32 scalars, the int64 [S, 2] slot
    table of level_pass.cu (first tile, tile count) and the slot of every
    1024-lane tile."""
    ntiles = -(-scal[:, S_NL] // 1024)
    tab = np.stack([np.cumsum(ntiles) - ntiles, ntiles],
                   axis=1).astype(np.int64)
    slot_of_tile = np.repeat(np.arange(len(scal), dtype=np.int32), ntiles)
    return (torch.as_tensor(scal.astype(np.int32), device=device),
            torch.as_tensor(tab, device=device),
            torch.as_tensor(slot_of_tile, device=device))


def _launch_level(src, dst, wp_live, tables):
    """Queue the partition kernels of the slots of `tables`
    (:func:`_level_tables`) from `src` into `dst` on the card; returns
    n_left as an [S] int32 tensor on the card, without waiting."""
    from .build import load
    fn = load("level_pass").level_pass_launch
    fn.argtypes = [_P, _P, _LL, _I, _P, _P, _I, _P, _I, _P, _P, _P, _P]
    fn.restype = _I
    scal_d, tab_d, sot_d = tables
    S, T, dev = len(scal_d), len(sot_d), src.device
    tiles = torch.empty((2, max(T, 1)), dtype=torch.int32, device=dev)
    n_left_d = torch.empty(S, dtype=torch.int32, device=dev)
    err = fn(_void(src), _void(dst), src.shape[1], wp_live, _void(scal_d),
             _void(tab_d), S, _void(sot_d), T, _void(tiles[0]),
             _void(tiles[1]), _void(n_left_d), _stream(src))
    if err != 0:
        raise LightGBMError("level_pass kernel launch failed: CUDA error %d"
                            % err)
    return n_left_d


def level_pass(src: torch.Tensor, dst: torch.Tensor, scal_mat,
               plan: torch.Tensor, nbw: int, wp_live: int, with_hist: bool):
    """Partition the segments of every slot of a tree level from `src` into
    `dst` (the same lanes, rows < wp_live; `src` is not written): the CUDA
    kernel for a payload on the card, the plain version on the CPU.
    `scal_mat` is the host [S, LEVEL_COLS] matrix of the slots' S_* slots;
    their segments must be disjoint. Returns (n_left [S] int64 numpy, the
    smaller children's (grad, hess) planes [S, G * 256], from `dst`, when
    `with_hist`, else None). The whole sequence is one launch of
    level_pass; reading n_left back is its one host sync."""
    scal = np.asarray(scal_mat, np.int64)
    nbw, wp_live = int(nbw), int(wp_live)
    _check_level(src, dst, scal, plan, nbw, wp_live)
    if src.device.type == "cpu":
        return level_pass_plain(src, dst, scal, plan, nbw, wp_live,
                                with_hist)
    n_left = _launch_level(src, dst, wp_live,
                           _level_tables(scal, src.device)) \
        .cpu().numpy().astype(np.int64)
    hist = None
    if with_hist:
        hist = _launch_multi_hist(
            "level_pass", "level_pass_hist_launch", dst, plan, nbw,
            _multi_hist_tables(level_children(scal, n_left), plan.shape[0],
                               dst.device))
    level_pass.launches += 1
    return n_left, hist


level_pass.launches = 0


def level_children(scal_mat, n_left):
    """[(start, length)] of each slot's smaller child after the partition."""
    return [_child(row, int(nl)) for row, nl in
            zip(np.asarray(scal_mat).tolist(), n_left)]


def plan_tensor(plan, device) -> torch.Tensor:
    """The [G, 3] int32 plan (word_row, shift, mask) on `device`."""
    return torch.as_tensor(np.asarray(plan, np.int32).reshape(-1, 3),
                           device=device).contiguous()
