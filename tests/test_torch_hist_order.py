"""The chain contract of the port's histograms, on skewed inputs.

hist_window (v1 grower) and the payload histograms (seg_hist, root_hist,
level_seg_hist) sum in one order, which their CUDA kernels reproduce bit for bit: the
segment is cut by ``ops/histogram.py:row_blocks``, within a block every
(group, bin) is one f32 chain 0 + v[i1] + v[i2] + ... in lane order, and
the blocks are added in block order. The reference here is that order
written with numpy: ``np.add.at`` (an unbuffered loop over the lanes, in
order) per row block, then the blocks added in order. The inputs are the
ones that stress a counting-sort kernel: every lane in one bin, one heavy
bin over a uniform tail, bins >= W (hist_window ignores them), nibble and
byte groups of a payload packed by ``ops/payload.py``, a ragged start and
lengths that span several row blocks, zero-length and one-lane segments.
Equality is exact. The segment table of the many-segment launches is
checked to cover every row block once, in order.
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops.histogram import hist_window_plain, row_blocks
from lightgbm_torch.ops.payload import (_pack_payload, _payload_geometry,
                                        _payload_plan)
from lightgbm_torch.ops.payload_kernels import (_multi_hist_tables,
                                                level_seg_hist_plain,
                                                plan_tensor, root_hist_plain,
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


# level_seg_hist's segments: zero lanes at both ends of the payload, one
# lane, a tile less and more one lane, a row block and one lane, and 3 row
# blocks less 7 lanes, from unaligned starts
LEVEL_SEGS = [(0, 0), (5, 1), (13, 1023), (1029, 1025), (3, 16_385),
              (99, 3 * 16_384 - 7), (50_002, 1), (50_003, 0)]


@pytest.mark.parametrize("kind", ["one_bin", "heavy", "uniform"])
def test_level_seg_hist_plain_chain_order(kind):
    """level_seg_hist_plain over zero-length, one-lane and row-block
    spanning segments of a payload with nibble and byte groups: each
    segment's planes are the chain reference of its lanes."""
    rows = 50_003
    rng = np.random.default_rng(len(kind))
    bins = skewed_bins(kind, rows, WIDTHS, rng)
    grad, hess = values(rows, rng)
    pay, plan, nbw = payload(bins, grad, hess, WIDTHS)
    G = len(WIDTHS)
    assert row_blocks(3 * 16_384 - 7, G)[0] == 3
    gh, hh = level_seg_hist_plain(pay, plan, nbw, LEVEL_SEGS)
    assert gh.shape == hh.shape == (len(LEVEL_SEGS), G * 256)
    for j, (start, length) in enumerate(LEVEL_SEGS):
        ref = reference(bins, grad, hess, start, length, 256)
        np.testing.assert_array_equal(gh[j].numpy(),
                                      ref[:, :, 0].reshape(G * 256))
        np.testing.assert_array_equal(hh[j].numpy(),
                                      ref[:, :, 1].reshape(G * 256))
        if length == 0:
            assert not gh[j].any() and not hh[j].any()


@pytest.mark.parametrize("G", [28, 8, 1])
def test_multi_hist_tables_cover_each_row_block_once(G):
    """The segment table and slot_of_block of a many-segment launch: the
    row blocks of each segment are consecutive and cut as row_blocks cuts
    it, so walking the kernels' flat grid (row block, then group fastest)
    visits every (segment, row block, group) once, each segment's lanes in
    order."""
    segs = [(0, 0), (7, 1), (100, 16_384), (20_000, 16_385),
            (40_000, 400_001), (500_000, 0), (500_001, 3 * 16_384 - 7)]
    tab, sob = _multi_hist_tables(segs, G, "cpu")
    tab, sob = tab.numpy(), sob.numpy()
    for j, (start, length) in enumerate(segs):
        nb, per = row_blocks(length, G)
        assert list(tab[j]) == [start, length, per, nb,
                                int(tab[:j, 3].sum())]
    assert len(sob) == int(tab[:, 3].sum())
    seen, lanes = [], {j: [] for j in range(len(segs))}
    for x in range(len(sob) * G):
        rb, g = divmod(x, G)
        st, ln, per, nb, base = tab[sob[rb]]
        b = rb - base
        assert 0 <= b < nb
        seen.append((int(sob[rb]), int(b), g))
        if g == 0:
            lanes[int(sob[rb])] += range(st + b * per,
                                         st + min(ln, (b + 1) * per))
    assert seen == sorted(set(seen))
    assert len(seen) == int(tab[:, 3].sum()) * G
    for j, (start, length) in enumerate(segs):
        assert lanes[j] == list(range(start, start + length))
