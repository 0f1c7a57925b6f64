"""The counting-sort histogram kernels on the card against their plain
versions: hist_window, root_hist, seg_hist and level_seg_hist.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_hist_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
tests). Without a card each test skips. Each kernel is held bit for bit
against its plain version on the CPU, on the skewed inputs of
tests/test_torch_hist_order.py (every lane in one bin, one heavy bin, bins
>= W, nibble and byte payload groups), ragged and unaligned segments,
lengths of one lane, a tile and a row block either side, 3 and 19 row
blocks, zero-length segments, and at 300k rows; two launches must agree.
root_hist, seg_hist and level_seg_hist share one routine
(csrc/payload_ordered.cuh), so each is also held equal to a witness that
does not: payload_hist.cuh's ownership routine (the witness launchers
``ownership_hist_launch`` of split_pass.cu and ``ownership_multi_launch``
of level_pass.cu), an independent implementation of the same contract.
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops.histogram import hist_window, hist_window_plain
from lightgbm_torch.ops.payload_kernels import (_launch_hist,
                                                _launch_multi_hist,
                                                _multi_hist_tables,
                                                level_seg_hist,
                                                level_seg_hist_plain,
                                                root_hist, root_hist_plain,
                                                seg_hist, seg_hist_plain)
from test_torch_hist_order import WIDTHS, payload, skewed_bins, values

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


# (kind, rows, G, W, start, length): HIGGS's 28 groups at 300k rows (19
# row blocks), a group count that leaves the last block of groups short,
# rows staged in several slab pieces per tile (G = 100) and rows wider than
# the slab (G > 1024), bins >= W, ragged segments
HW_CASES = [("uniform", 300_017, 28, 255, 17, 300_000),
            ("one_bin", 300_000, 28, 255, 0, 300_000),
            ("heavy", 300_000, 28, 255, 3, 299_990),
            ("heavy", 70_001, 5, 256, 13, 69_987),
            ("over_w", 50_000, 6, 40, 1, 49_997),
            ("uniform", 20_000, 100, 255, 5, 19_990),
            ("uniform", 5_003, 1100, 64, 2, 5_001),
            ("uniform", 1_000, 28, 255, 999, 1)]


@pytest.mark.parametrize("kind,rows,G,W,start,length", HW_CASES)
def test_hist_window_kernel_matches_plain(kind, rows, G, W, start, length):
    _card()
    rng = np.random.default_rng(rows + G)
    bins = skewed_bins(kind, rows, [W] * G, rng)
    grad, hess = values(rows, rng)
    cpu = [torch.from_numpy(a) for a in (bins, grad, hess)]
    dev = [t.cuda() for t in cpu]
    k1 = hist_window(*dev, start, length, W)
    k2 = hist_window(*dev, start, length, W)
    torch.cuda.synchronize()
    assert torch.equal(k1, k2)
    assert torch.equal(k1.cpu(), hist_window_plain(*cpu, start, length, W))


# (kind, rows, widths): HIGGS's 28 byte groups at 300k rows, and nibble
# plus byte groups (one left-over nibble) under each skew, ragged lengths
RH_CASES = [("uniform", 300_000, [255] * 28),
            ("one_bin", 300_000, [255] * 28),
            ("heavy", 300_003, [255] * 28),
            ("uniform", 70_001, WIDTHS),
            ("one_bin", 40_961, WIDTHS),
            ("heavy", 100_003, WIDTHS),
            ("heavy", 3, WIDTHS)]


@pytest.mark.parametrize("kind,rows,widths", RH_CASES)
def test_root_hist_kernel_matches_plain(kind, rows, widths):
    _card()
    rng = np.random.default_rng(rows + len(widths))
    bins = skewed_bins(kind, rows, widths, rng)
    grad, hess = values(rows, rng)
    pay, plan, nbw = payload(bins, grad, hess, widths)
    pay_d, plan_d = pay.cuda(), plan.cuda()
    k1 = root_hist(pay_d, plan_d, nbw, rows)
    k2 = root_hist(pay_d, plan_d, nbw, rows)
    seg = seg_hist(pay_d, plan_d, nbw, 0, rows)
    own = _ownership(pay_d, plan_d, nbw, 0, rows)
    torch.cuda.synchronize()
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    for a, b in zip(k1, root_hist_plain(pay, plan, nbw, rows)):
        assert torch.equal(a.cpu(), b)
    for a, b, c in zip(k1[:2], seg, own):
        assert torch.equal(a, b)
        assert torch.equal(a, c)


def _ownership(pay, plan, nbw, start, length):
    """The ownership routine's histogram of the lanes (split_pass.cu's
    witness launcher), the witness of the counting-sort kernels."""
    return _launch_hist("split_pass", "ownership_hist_launch", pay, plan,
                        nbw, start, length)


# (kind, rows, widths, start, length): HIGGS's 28 byte groups and the
# nibble/byte widths; one lane, a tile less and more one lane, a row block
# and one lane, 3, 7 and 13 row blocks (four, two and one team per group
# at 28 groups), 19 row blocks (longer than 19 * 16384 lanes), zero lanes,
# each from an unaligned lane
SEG_CASES = [("uniform", 300_000, [255] * 28, 777, 1),
             ("uniform", 300_000, [255] * 28, 13, 1023),
             ("heavy", 300_000, [255] * 28, 1029, 1025),
             ("one_bin", 300_000, [255] * 28, 3, 16_385),
             ("heavy", 300_000, [255] * 28, 99, 3 * 16_384 - 7),
             ("heavy", 300_000, [255] * 28, 11, 100_003),
             ("uniform", 300_000, [255] * 28, 7, 200_000),
             ("uniform", 320_000, [255] * 28, 4097, 315_000),
             ("heavy", 70_001, WIDTHS, 5, 69_990),
             ("one_bin", 40_961, WIDTHS, 1, 40_959),
             ("uniform", 1_000, WIDTHS, 999, 0)]


@pytest.mark.parametrize("kind,rows,widths,start,length", SEG_CASES)
def test_seg_hist_kernel_matches_plain(kind, rows, widths, start, length):
    _card()
    rng = np.random.default_rng(rows + start)
    bins = skewed_bins(kind, rows, widths, rng)
    grad, hess = values(rows, rng)
    pay, plan, nbw = payload(bins, grad, hess, widths)
    pay_d, plan_d = pay.cuda(), plan.cuda()
    k1 = seg_hist(pay_d, plan_d, nbw, start, length)
    k2 = seg_hist(pay_d, plan_d, nbw, start, length)
    own = _ownership(pay_d, plan_d, nbw, start, length)
    torch.cuda.synchronize()
    for a, b, c, p in zip(k1, k2, own,
                          seg_hist_plain(pay, plan, nbw, start, length)):
        assert torch.equal(a, b)
        assert torch.equal(a, c)
        assert torch.equal(a.cpu(), p)


# level_seg_hist's segment tables at 300k rows, one for each number of
# teams the kernel picks at 28 groups on an H100: 4 row blocks (four teams
# per group), 8 (two) and 33 (one). Zero-length segments at both ends, one
# lane, unaligned ones of a tile and of 1 to 19 row blocks.
LEVEL_SEGS = {
    "4 row blocks": [(0, 0), (777, 1), (13, 1023), (1029, 1025)],
    "8 row blocks": [(0, 0), (777, 1), (3, 16_385), (99, 3 * 16_384 - 7),
                     (299_999, 1)],
    "33 row blocks": [(0, 0), (777, 1), (13, 1023), (1029, 1025),
                      (3, 16_385), (99, 3 * 16_384 - 7), (60_000, 40_000),
                      (17, 299_980), (299_999, 1), (300_000, 0)]}


@pytest.mark.parametrize("table", list(LEVEL_SEGS))
@pytest.mark.parametrize("kind,widths", [("uniform", [255] * 28),
                                         ("one_bin", [255] * 28),
                                         ("heavy", [255] * 28),
                                         ("heavy", WIDTHS)])
def test_level_seg_hist_kernel_matches_plain(kind, widths, table):
    """Every segment of the table bit for bit against the plain version on
    the CPU and the ownership witness (level_pass.cu's witness launcher); two
    launches agree."""
    _card()
    rows = 300_000
    segs = LEVEL_SEGS[table]
    rng = np.random.default_rng(len(widths) + len(kind))
    bins = skewed_bins(kind, rows, widths, rng)
    grad, hess = values(rows, rng)
    pay, plan, nbw = payload(bins, grad, hess, widths)
    pay_d, plan_d = pay.cuda(), plan.cuda()
    k1 = level_seg_hist(pay_d, plan_d, nbw, segs)
    k2 = level_seg_hist(pay_d, plan_d, nbw, segs)
    own = _launch_multi_hist("level_pass", "ownership_multi_launch", pay_d,
                             plan_d, nbw, _multi_hist_tables(
                                 segs, len(widths), pay_d.device))
    torch.cuda.synchronize()
    for i, p in enumerate(level_seg_hist_plain(pay, plan, nbw, segs)):
        assert torch.equal(k1[i], k2[i])
        assert torch.equal(k1[i], own[i])
        assert torch.equal(k1[i].cpu(), p)
