"""The chain contract of the port's histograms, on skewed inputs.

hist_window (v1 grower) and the payload histograms (seg_hist, root_hist)
sum in one order, which their CUDA kernels reproduce bit for bit: the
segment is cut by ``ops/histogram.py:row_blocks``, within a block every
(group, bin) is one f32 chain 0 + v[i1] + v[i2] + ... in lane order, and
the blocks are added in block order. The reference here is that order
written with numpy: ``np.add.at`` (an unbuffered loop over the lanes, in
order) per row block, then the blocks added in order. The inputs are the
ones that stress a counting-sort kernel: every lane in one bin, one heavy
bin over a uniform tail, bins >= W (hist_window ignores them), nibble and
byte groups of a payload packed by ``ops/payload.py``, a ragged start and
lengths that span several row blocks. Equality is exact.
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops.histogram import hist_window_plain, row_blocks
from lightgbm_torch.ops.payload import (_pack_payload, _payload_geometry,
                                        _payload_plan)
from lightgbm_torch.ops.payload_kernels import (plan_tensor, root_hist_plain,
                                                seg_hist_plain)

# payload group widths: byte groups (> 16 bins) and nibble groups (pairs
# and one left over)
WIDTHS = [255, 12, 40, 16, 3, 200, 9, 5]


def skewed_bins(kind, rows, widths, rng):
    """[rows, G] uint8 bins of one skew `kind`; group g's bins lie below
    widths[g] except for kind "over_w"."""
    G = len(widths)
    w = np.asarray(widths)
    if kind == "one_bin":
        return np.tile(np.minimum(7, w - 1), (rows, 1)).astype(np.uint8)
    uni = (rng.random((rows, G)) * w).astype(np.int64)
    if kind == "heavy":
        uni[rng.random((rows, G)) < 0.9] = 0
    elif kind == "over_w":
        uni = rng.integers(0, 256, size=(rows, G))
    return uni.astype(np.uint8)


def values(rows, rng):
    return (rng.normal(size=rows).astype(np.float32),
            rng.uniform(0.01, 0.25, size=rows).astype(np.float32))


def reference(bins, grad, hess, start, length, w):
    """[G, w, 2] f32: np.add.at per row block in lane order, blocks added
    in order; bins >= w are left out."""
    G = bins.shape[1]
    nblocks, per = row_blocks(length, G)
    out = None
    for b in range(nblocks):
        lo = start + b * per
        hi = min(start + length, lo + per)
        part = np.zeros((G, w, 2), np.float32)
        for g in range(G):
            col = bins[lo:hi, g].astype(np.int64)
            keep = col < w
            np.add.at(part[g, :, 0], col[keep], grad[lo:hi][keep])
            np.add.at(part[g, :, 1], col[keep], hess[lo:hi][keep])
        out = part if out is None else out + part
    return out


def payload(bins, grad, hess, widths):
    """(pay [WPA, NP] int32 tensor, plan [G, 3] int32 tensor, nbw): the
    persistent grower's payload of `bins`, packed by ops/payload.py, with
    grad/hess in rows nbw + 2 and nbw + 3."""
    n = bins.shape[0]
    plan, nbw = _payload_plan(widths)
    WPA, _, NP = _payload_geometry(n, nbw, 0, 16384)
    pay = _pack_payload(bins, np.zeros(n, np.float32), n, WPA, NP, nbw, 0, n,
                        plan).view(np.int32)
    pay[nbw + 2, :n] = grad.view(np.int32)
    pay[nbw + 3, :n] = hess.view(np.int32)
    return torch.from_numpy(pay), plan_tensor(plan, "cpu"), nbw


# (kind, rows, start, length): lengths of one and of several row blocks,
# ragged starts and lengths (not multiples of 4 or of a 1024-lane tile)
CASES = [("one_bin", 3000, 0, 3000), ("one_bin", 50_001, 13, 49_987),
         ("heavy", 4099, 5, 4093), ("heavy", 40_000, 1, 39_998),
         ("uniform", 36_867, 3, 36_861), ("over_w", 2050, 7, 2041)]


@pytest.mark.parametrize("kind,rows,start,length", CASES)
@pytest.mark.parametrize("w", [256, 40])
def test_hist_window_plain_chain_order(kind, rows, start, length, w):
    rng = np.random.default_rng(rows + w)
    widths = [256, 200, 17] if kind == "over_w" else [w, min(w, 33), 5]
    bins = skewed_bins(kind, rows, widths, rng)
    grad, hess = values(rows, rng)
    assert (row_blocks(length, 3)[0] > 1) == (length > 16_384)
    got = hist_window_plain(torch.from_numpy(bins), torch.from_numpy(grad),
                            torch.from_numpy(hess), start, length, w)
    np.testing.assert_array_equal(got.numpy(),
                                  reference(bins, grad, hess, start, length, w))


@pytest.mark.parametrize("kind,rows,start,length",
                         [c for c in CASES if c[0] != "over_w"])
def test_payload_plain_chain_order(kind, rows, start, length):
    """seg_hist_plain over [start, start + length) and root_hist_plain over
    [0, rows) of a payload with nibble and byte groups; root_hist's totals
    are the f64 sums of grad and hess rounded to f32."""
    rng = np.random.default_rng(rows)
    bins = skewed_bins(kind, rows, WIDTHS, rng)
    grad, hess = values(rows, rng)
    pay, plan, nbw = payload(bins, grad, hess, WIDTHS)
    assert int((plan[:, 2] == 15).sum()) == 5     # nibble groups
    G = len(WIDTHS)
    gh, hh = seg_hist_plain(pay, plan, nbw, start, length)
    ref = reference(bins, grad, hess, start, length, 256)
    np.testing.assert_array_equal(gh.numpy(), ref[:, :, 0].reshape(G * 256))
    np.testing.assert_array_equal(hh.numpy(), ref[:, :, 1].reshape(G * 256))
    rg, rh, sums = root_hist_plain(pay, plan, nbw, rows)
    ref = reference(bins, grad, hess, 0, rows, 256)
    np.testing.assert_array_equal(rg.numpy(), ref[:, :, 0].reshape(G * 256))
    np.testing.assert_array_equal(rh.numpy(), ref[:, :, 1].reshape(G * 256))
    np.testing.assert_array_equal(
        sums.numpy(), np.array([grad.astype(np.float64).sum(),
                                hess.astype(np.float64).sum()], np.float32))
