"""The partition kernels on the card against their plain versions:
split_pass, level_pass and the consolidation.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_partition_cuda.py

(``--noconftest`` because tests/conftest.py sets up JAX for the other
tests). Without a card each test skips. The payload is packed by
ops/payload.py from skewed bins (tests/test_torch_hist_order.py's): HIGGS's
28 byte groups and a mix of nibble and byte groups. Each partition runs in
both directions of the grower's two buffers, from the payload into a
second buffer of wp_live rows and back, and is held bit for bit against
its plain version on the CPU from the same buffers: the destination,
n_left, the source untouched, every lane of the destination outside the
segments and every row from wp_live on untouched, and the in-pass
histograms of the smaller children; the in-pass histograms are also held
equal to seg_hist / level_seg_hist over the same children and to
payload_hist.cuh's ownership routine (the witness). Segments start at
unaligned lanes and have zero, one, a tile less and more one lane and many
tiles; two launches must agree. The consolidation is held against its
plain version and against one copy_ per segment.
"""
import numpy as np
import pytest
import torch

from lightgbm_torch.ops import payload_kernels as pk
from test_torch_hist_order import WIDTHS, payload, skewed_bins, values

pytestmark = pytest.mark.cuda

ROWS = 300_000


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def _sentinel(shape, seed):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=shape,
                                         dtype=np.int64).astype(np.int32))


def _scalars(plan, widths, g, s0, n_l, mt, dl, small_l, rng):
    """The S_* slots of a split of lanes [s0, s0 + n_l) on group g's bins
    (one feature per group): a threshold inside the group's bins, the
    missing type `mt` with its bin, and every third split reading only a
    narrow range of the group's bins (others read as most_freq)."""
    w, sh, mk = (int(v) for v in plan[g])
    nb = int(widths[g])
    s = [0] * pk.N_SCALARS
    s[pk.S_S0], s[pk.S_NL] = s0, n_l
    s[pk.S_WG], s[pk.S_SH], s[pk.S_MASK] = w, sh, mk
    s[pk.S_NB], s[pk.S_MT], s[pk.S_DB] = nb, mt, int(rng.integers(0, nb))
    s[pk.S_THR] = int(rng.integers(0, nb))
    s[pk.S_DL], s[pk.S_SMALL_L] = dl, small_l
    s[pk.S_LS], s[pk.S_LE], s[pk.S_MF] = 0, nb, 0
    if g % 3 == 2 and nb > 4:
        s[pk.S_LS], s[pk.S_LE] = 1, nb - 1
        s[pk.S_MF] = int(rng.integers(0, nb - 2))
    return s


def _buffers(kind, widths, direction, seed):
    """(src, dst, plan, nbw, wp_live) on the CPU: the packed payload and a
    second buffer of wp_live random words, in the given direction."""
    rng = np.random.default_rng(seed)
    bins = skewed_bins(kind, ROWS, widths, rng)
    pay, plan, nbw = payload(bins, *values(ROWS, rng), widths)
    wp_live = nbw + 5
    second = _sentinel((wp_live, pay.shape[1]), seed)
    if direction == "payload_to_second":
        return pay, second, plan, nbw, wp_live
    src = pay[:wp_live].clone()
    return src, _sentinel(tuple(pay.shape), seed + 1), plan, nbw, wp_live


def _untouched(dst, dst0, segs, wp_live):
    keep = torch.ones(dst.shape[1], dtype=torch.bool)
    for s0, n_l in segs:
        keep[s0:s0 + n_l] = False
    assert torch.equal(dst[:, keep], dst0[:, keep])
    assert torch.equal(dst[wp_live:], dst0[wp_live:])


def _ownership(pay, plan, nbw, start, length):
    return pk._launch_hist("split_pass", "ownership_hist_launch", pay, plan,
                           nbw, start, length)


# (kind, widths, group, s0, n_l, missing type, default_left, small_l)
SPLIT_CASES = [("uniform", [255] * 28, 3, 777, 250_001, 2, 1, 1),
               ("heavy", [255] * 28, 0, 13, 299_980, 1, 0, 0),
               ("one_bin", [255] * 28, 5, 1029, 1025, 0, 1, 0),
               ("uniform", [255] * 28, 2, 5, 1023, 0, 0, 1),
               ("heavy", WIDTHS, 1, 3, 16_385, 2, 1, 0),
               ("uniform", WIDTHS, 4, 999, 1, 1, 1, 1),
               ("uniform", WIDTHS, 6, 640, 0, 0, 1, 1)]


@pytest.mark.parametrize("direction", ["payload_to_second",
                                       "second_to_payload"])
@pytest.mark.parametrize("kind,widths,g,s0,n_l,mt,dl,small_l", SPLIT_CASES)
def test_split_pass_kernel_matches_plain(kind, widths, g, s0, n_l, mt, dl,
                                         small_l, direction):
    _card()
    src, dst0, plan, nbw, wp_live = _buffers(kind, widths, direction,
                                             s0 + n_l)
    scal = _scalars(plan.numpy(), widths, g, s0, n_l, mt, dl, small_l,
                    np.random.default_rng(g))
    dst_c = dst0.clone()
    n_c, h_c = pk.split_pass(src, dst_c, scal, plan, nbw, wp_live, True)
    src_d, plan_d = src.cuda(), plan.cuda()
    outs = []
    for _ in range(2):
        dst_d = dst0.cuda()
        before = pk.split_pass.launches
        n_d, h_d = pk.split_pass(src_d, dst_d, scal, plan_d, nbw, wp_live,
                                 True)
        assert pk.split_pass.launches == before + 1
        outs.append((n_d, dst_d, h_d))
    torch.cuda.synchronize()
    (n1, d1, h1), (n2, d2, h2) = outs
    assert n1 == n2 == n_c
    assert torch.equal(d1, d2) and torch.equal(d1.cpu(), dst_c)
    assert torch.equal(src_d.cpu(), src)
    _untouched(d1.cpu(), dst0, [(s0, n_l)], wp_live)
    child = pk._child(scal, n_c)
    seg = pk.seg_hist(d1, plan_d, nbw, *child)
    own = _ownership(d1, plan_d, nbw, *child)
    for a, b, c, o, p in zip(h1, h2, seg, own, h_c):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, o)
        assert torch.equal(a.cpu(), p)


def _level_scal(plan, widths, segs, rng):
    G = len(widths)
    return np.array([_scalars(plan, widths, j % G, s0, n_l, j % 3, j % 2,
                              (j // 2) % 2, rng) + [0]
                     for j, (s0, n_l) in enumerate(segs)], np.int64)


def _cut(rng, n, S):
    """S disjoint segments of [0, n) with a lane left out between
    neighbours, one zero-length and one one-lane segment among them."""
    cuts = np.sort(rng.choice(np.arange(1, n), S - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    segs = [(int(a) + 1, max(int(b - a) - 2, 0))
            for a, b in zip(bounds[:-1], bounds[1:])]
    segs[len(segs) // 2] = (segs[len(segs) // 2][0], 0)
    if S > 2:
        segs[-1] = (segs[-1][0], 1)
    return segs


@pytest.mark.parametrize("direction", ["payload_to_second",
                                       "second_to_payload"])
@pytest.mark.parametrize("kind,widths,S", [("uniform", [255] * 28, 1),
                                           ("heavy", [255] * 28, 64),
                                           ("one_bin", [255] * 28, 7),
                                           ("heavy", WIDTHS, 33)])
def test_level_pass_kernel_matches_plain(kind, widths, S, direction):
    _card()
    rng = np.random.default_rng(S)
    src, dst0, plan, nbw, wp_live = _buffers(kind, widths, direction, S)
    segs = _cut(rng, ROWS, S) if S > 1 else [(3, ROWS - 7)]
    scal = _level_scal(plan.numpy(), widths, segs, rng)
    dst_c = dst0.clone()
    n_c, h_c = pk.level_pass(src, dst_c, scal, plan, nbw, wp_live, True)
    src_d, plan_d = src.cuda(), plan.cuda()
    outs = []
    for _ in range(2):
        dst_d = dst0.cuda()
        before = pk.level_pass.launches
        n_d, h_d = pk.level_pass(src_d, dst_d, scal, plan_d, nbw, wp_live,
                                 True)
        assert pk.level_pass.launches == before + 1
        outs.append((n_d, dst_d, h_d))
    torch.cuda.synchronize()
    (n1, d1, h1), (n2, d2, h2) = outs
    np.testing.assert_array_equal(n1, n2)
    np.testing.assert_array_equal(n1, n_c)
    assert torch.equal(d1, d2) and torch.equal(d1.cpu(), dst_c)
    assert torch.equal(src_d.cpu(), src)
    _untouched(d1.cpu(), dst0, segs, wp_live)
    kids = pk.level_children(scal, n_c)
    seg = pk.level_seg_hist(d1, plan_d, nbw, kids)
    own = pk._launch_multi_hist("level_pass", "ownership_multi_launch", d1,
                                plan_d, nbw, pk._multi_hist_tables(
                                    kids, len(widths), d1.device))
    for a, b, c, o, p in zip(h1, h2, seg, own, h_c):
        assert torch.equal(a, b) and torch.equal(a, c) and torch.equal(a, o)
        assert torch.equal(a.cpu(), p)


@pytest.mark.parametrize("S", [1, 9, 200])
def test_consolidate_kernel_matches_plain(S):
    _card()
    rng = np.random.default_rng(S)
    wp_live, NP = 12, ROWS + 4096
    src, dst0 = _sentinel((wp_live, NP), S), _sentinel((16, NP), S + 1)
    segs = _cut(rng, ROWS, S) if S > 1 else [(5, ROWS)]
    dst_c = dst0.clone()
    pk.consolidate(src, dst_c, segs, wp_live)
    src_d = src.cuda()
    ref = dst0.cuda()
    for st, ln in segs:
        ref[:wp_live, st:st + ln].copy_(src_d[:, st:st + ln])
    outs = []
    for _ in range(2):
        dst_d = dst0.cuda()
        before = pk.consolidate.launches
        pk.consolidate(src_d, dst_d, segs, wp_live)
        assert pk.consolidate.launches == before + 1
        outs.append(dst_d)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], ref)
    assert torch.equal(outs[0].cpu(), dst_c)
    assert torch.equal(src_d.cpu(), src)
    # no lanes: nothing is launched or counted
    before = pk.consolidate.launches
    pk.consolidate(src_d, outs[0], [(7, 0)], wp_live)
    assert pk.consolidate.launches == before
