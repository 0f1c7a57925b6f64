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
counts one launch. scan_pair's knob form (tests/test_torch_scan_rows.py:
knob_case: lambda_l1, max_delta_step, finite monotone bounds, mixed
constraint signs, extra_trees lanes and by-node masks) is held the same
way, with its own device launch count.
"""
import pytest
import torch

from lightgbm_torch.ops import block_scan as bs
from lightgbm_torch.ops.scan import scan_pair
from test_torch_scan_rows import (block_case, block_gathered, knob_case,
                                  pair_args, pair_case, pair_gathered)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def _cuda(args):
    return [a.cuda() if isinstance(a, torch.Tensor) else a for a in args]


def _pair(c, on_card):
    kw = {"rows": c["rows"], "gidx": c["gidx"]}
    if "node" in c:
        kw["node"] = c["node"]
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


@pytest.mark.parametrize("use_mc", [True, False], ids=["mc", "no_mc"])
@pytest.mark.parametrize("B", [1, 2, 256])
@pytest.mark.parametrize("Wp", [32, 256])
def test_scan_pair_knob_form_matches_plain(Wp, B, use_mc):
    _card()
    from lightgbm_torch.ops import counters
    c = knob_case(300 + B, B, Wp, use_mc=use_mc)
    want = _pair(c, False)
    counters.reset("cuda")
    k1, k2 = _pair(c, True), _pair(c, True)
    torch.cuda.synchronize()
    got = counters.read("cuda")
    assert got["scan_pair_knob"] == 2 and got["scan_pair"] == 0
    assert torch.equal(k1, k2)
    assert torch.equal(k1.cpu(), want)
    gathered = _cuda(pair_gathered(c))
    assert torch.equal(scan_pair(*gathered, node=c["node"].cuda()).cpu(),
                       want)
    assert (want[:, 6] > 0).sum() >= 1


def test_scan_pair_knob_form_edges():
    """+inf gains (l2 = 0, zero-hessian sides, no clamp, no constraint)
    under the knob form, and an L1 large enough to zero most gradient
    sums."""
    _card()
    for kw in ({"l2": 0.0, "min_data": 0, "min_hess": 0.0, "zero_hess": 0.3,
                "mds": 0.0, "use_mc": False}, {"l1": 4.0, "mds": 0.01}):
        c = knob_case(11, 64, 256, **kw)
        want = _pair(c, False)
        assert torch.equal(_pair(c, True).cpu(), want)
        if kw["mds"] == 0.0:
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
