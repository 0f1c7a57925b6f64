"""hist_window and root_hist on the card against their plain versions.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_hist_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
tests). Without a card each test skips. Each kernel is held bit for bit
against its plain version on the CPU, on the skewed inputs of
tests/test_torch_hist_order.py (every lane in one bin, one heavy bin, bins
>= W, a ragged start and length, nibble and byte payload groups) and at
300k rows; two launches must agree, and root_hist's planes must equal
seg_hist's over the same lanes (seg_hist runs the other histogram routine,
payload_hist.cuh, so the two are independent implementations of one
contract).
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops.histogram import hist_window, hist_window_plain
from lightgbm_torch.ops.payload_kernels import (root_hist, root_hist_plain,
                                                seg_hist)
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
    torch.cuda.synchronize()
    for a, b in zip(k1, k2):
        assert torch.equal(a, b)
    for a, b in zip(k1, root_hist_plain(pay, plan, nbw, rows)):
        assert torch.equal(a.cpu(), b)
    for a, b in zip(k1[:2], seg):
        assert torch.equal(a, b)
