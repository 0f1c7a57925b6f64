"""The split scans on the card against their plain versions: scan_pair and
scan_blocks.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_scan_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
tests). Without a card each test skips. The inputs are
tests/test_torch_scan_rows.py's: random children's histogram planes with
empty bins (exact ties in both directions), missing types None, Zero and
NaN, a one-bin feature and a feature masked out of the tree (no valid
lane), and for the block scan one-hot bundles with FixHistogram at every
window's first lane, one-lane windows, dense groups as wide as the plane
and G < Gp. Each kernel reads the planes in place through a random choice
of rows (and scan_pair's layout gidx) and is held bit for bit against its
plain version on the CPU, at B = 1, 2 and 256 and Wp = 32, 256 and 1024,
in both forms of its contract; two launches must agree, and each call
counts one launch.
"""
import pytest
import torch

from lightgbm_torch.ops import block_scan as bs
from lightgbm_torch.ops.scan import scan_pair
from test_torch_scan_rows import (block_case, block_gathered, pair_args,
                                  pair_case, pair_gathered)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def _cuda(args):
    return [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]


def _pair(c, on_card):
    kw = {"rows": c["rows"], "gidx": c["gidx"]}
    if on_card:
        kw = {k: v.cuda() for k, v in kw.items()}
        return scan_pair(*_cuda(pair_args(c)), **kw)
    return scan_pair(*pair_args(c), **kw)


@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("Wp", [32, 256, 1024])
def test_scan_pair_matches_plain(B, Wp):
    _card()
    c = pair_case(100 + B, B, Wp)
    want = _pair(c, False)
    before = scan_pair.launches
    k1, k2 = _pair(c, True), _pair(c, True)
    torch.cuda.synchronize()
    assert scan_pair.launches == before + 2
    assert torch.equal(k1, k2)
    assert torch.equal(k1.cpu(), want)
    assert torch.equal(scan_pair(*_cuda(pair_gathered(c))).cpu(), want)
    assert (want[:, 6] > 0).sum() >= B


@pytest.mark.parametrize("case", ["inf_gains", "batched_valid"])
def test_scan_pair_edges(case):
    """+inf gains (l2 = 0, zero-hessian sides, ties among them) and
    per-child valid masks."""
    _card()
    kw = ({"l2": 0.0, "min_data": 0, "min_hess": 0.0, "zero_hess": 0.3}
          if case == "inf_gains" else {"batched": True})
    c = pair_case(7, 64, 256, **kw)
    want = _pair(c, False)
    assert torch.equal(_pair(c, True).cpu(), want)
    if case == "inf_gains":
        assert (want[:, 0] == float("inf")).any()


def _blocks(c, on_card, do_fix=None):
    do_fix = c["do_fix"] if do_fix is None else do_fix
    args = (c["scal"], c["gh"], c["hh"], c["masks"])
    rows = c["rows"]
    if on_card:
        args, rows = _cuda(args), rows.cuda()
    return bs.scan_blocks(*args, do_fix, rows=rows, groups=c["G"])


@pytest.mark.parametrize("do_fix", [True, False], ids=["fix", "no_fix"])
@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("Wp", [32, 256, 1024])
def test_scan_blocks_matches_plain(Wp, B, do_fix):
    _card()
    c = block_case(200 + B, B, Wp)
    want = _blocks(c, False, do_fix)
    before = bs.scan_blocks.launches
    k1, k2 = _blocks(c, True, do_fix), _blocks(c, True, do_fix)
    torch.cuda.synchronize()
    assert bs.scan_blocks.launches == before + 2
    assert torch.equal(k1, k2)
    assert torch.equal(k1.cpu(), want)
    gb, hb = block_gathered(c)
    assert torch.equal(bs.scan_blocks(*_cuda([c["scal"], gb, hb,
                                              c["masks"]]), do_fix).cpu(),
                       want)
    assert (want[:, 6, :c["G"]] > 0).sum() >= B


@pytest.mark.parametrize("zero_pen", [False, True], ids=["inf", "inf_x_0"])
def test_scan_blocks_infinite_gains(zero_pen):
    """+inf gains, and inf times a zero penalty (NaN: no split in that
    direction)."""
    _card()
    c = block_case(9, 64, 256, l2=0.0, min_data=0, min_hess=0.0,
                   zero_hess=0.3, zero_pen=zero_pen)
    want = _blocks(c, False)
    assert torch.equal(_blocks(c, True).cpu(), want)
