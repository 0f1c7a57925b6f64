"""The level kernels' plain versions: level_pass and level_seg_hist.

The payload is tests/test_torch_payload_kernels.py's (3000 rows, built by
the JAX package with C = CR = 512, so the TPU kernels run several chunks),
with up to 8 slots whose segments start off a multiple of 128.

  * ``level_pass_plain`` is a loop of ``split_pass_plain`` over the slots,
    each from ``src`` into ``dst``: destination, n_left and the smaller
    children's histograms equal bit for bit, ``src`` untouched. Against the
    Pallas kernel (``make_level_pass``, interpret mode), which writes each
    child back in place through a two-ended FIFO: n_left equal, each child
    the same multiset of columns, every lane outside the segments untouched,
    and histograms within that file's bound (2 * count * eps32 + 2^-17 for
    the MXU's bf16 hi/lo split, times sum|v|).
  * ``level_seg_hist_plain`` is a loop of ``seg_hist_plain`` (bit for bit)
    and matches ``make_level_seg_hist`` in interpret mode within the same
    bound; a zero-length segment gives zeros (the TPU kernel leaves it
    undefined).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lightgbm_tpu.ops import pallas_grow as jpg
from lightgbm_torch.ops import payload_kernels as pk
from lightgbm_torch.utils.log import LightGBMError
from test_torch_payload_kernels import (_feature_of_group, _geom,
                                        _hist_bound, _port, _scalars,
                                        _sorted_by_rid, setup)  # noqa: F401

# slots per case: (group, s0, n_l, threshold, default_left, small_l)
SLOTS = {
    1: [(0, 77, 2600, 10, 1, 1)],
    3: [(1, 5, 700, 40, 0, 0), (3, 900, 1100, 2, 1, 1),
        (5, 2001, 999, 40, 0, 1)],
    8: [(k % 6, 3 + 370 * k, 360, (10, 40, 20, 2, 1, 40)[k % 6], k % 2,
         (k // 2) % 2) for k in range(8)],
}


def _scal_mat(ds, pa, slots):
    return np.array([_scalars(pa, _feature_of_group(ds, g), s0, n_l, thr,
                              dl, sl) + [0]
                     for g, s0, n_l, thr, dl, sl in slots], np.int64)


@pytest.mark.parametrize("with_hist", [True, False], ids=["hist", "no_hist"])
@pytest.mark.parametrize("S", sorted(SLOTS))
def test_level_pass_plain_is_a_split_pass_loop(setup, S, with_hist):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    plan_t = pk.plan_tensor(plan, "cpu")
    scal = _scal_mat(ds, pa, SLOTS[S])
    src, mine = _port(pay), _port(pay)
    n_left, hist = pk.level_pass(src, mine, scal, plan_t, nbw, nbw + 5,
                                 with_hist)
    ref = _port(pay)
    for j, row in enumerate(scal.tolist()):
        nl, h = pk.split_pass_plain(src, ref, row[:pk.N_SCALARS], plan_t,
                                    nbw, nbw + 5, with_hist)
        assert n_left[j] == nl and 0 < nl < row[pk.S_NL]
        if with_hist:
            assert torch.equal(hist[0][j], h[0])
            assert torch.equal(hist[1][j], h[1])
    assert torch.equal(mine, ref)
    assert torch.equal(src, _port(pay))
    assert (hist is None) != with_hist


def _step_tables(n_steps, S_max, T_max):
    """The JAX level program's (slot_of_step, base_of_slot, grid)
    (grow_persist.py:1366-1371)."""
    ends = np.cumsum(n_steps).astype(np.int32)
    base = ends - n_steps
    so = np.minimum(np.searchsorted(ends, np.arange(T_max), side="right"),
                    S_max - 1).astype(np.int32)
    return jnp.asarray(so), jnp.asarray(base.astype(np.int32)), \
        jnp.int32(ends[-1])


@pytest.mark.parametrize("S", sorted(SLOTS))
def test_level_pass_plain_matches_pallas_kernel(setup, S):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    scal = _scal_mat(ds, pa, SLOTS[S])
    T_max = NP // C + 3 * S + 4
    kern = jpg.make_level_pass(WPA, NP, G, plan, nbw, S, T_max, C=C,
                               interpret=True, wp_live=nbw + 5)
    n_l = scal[:, pk.S_NL]
    so, base, grid = _step_tables(np.where(n_l > 0, scal[:, pk.S_NCH] + 2, 0),
                                  S, T_max)
    kpay, khist, knl = kern(jnp.asarray(pay), jnp.asarray(scal, jnp.int32),
                            so, base, grid)
    kpay = np.asarray(kpay)
    kg, kh = (np.asarray(a) for a in jax.vmap(jpg._unpack_hist)(khist))
    tp, dst = _port(pay), _port(pay)
    n_left, (gh, hh) = pk.level_pass(tp, dst, scal,
                                     pk.plan_tensor(plan, "cpu"), nbw,
                                     nbw + 5, True)
    np.testing.assert_array_equal(n_left, np.asarray(knl))
    assert torch.equal(tp, _port(pay))
    mine = dst.numpy().view(np.uint32)
    outside = np.ones(NP, bool)
    for s0, nl in scal[:, [pk.S_S0, pk.S_NL]]:
        outside[s0:s0 + nl] = False
    np.testing.assert_array_equal(kpay[:, outside], mine[:, outside])
    np.testing.assert_array_equal(kpay[nbw + 5:], mine[nbw + 5:])
    for j, (row, nl) in enumerate(zip(scal.tolist(), n_left)):
        s0, end = row[pk.S_S0], row[pk.S_S0] + row[pk.S_NL]
        for a, b in ((s0, s0 + nl), (s0 + nl, end)):
            np.testing.assert_array_equal(_sorted_by_rid(kpay[:, a:b], nbw),
                                          _sorted_by_rid(mine[:, a:b], nbw))
        bg, bh = _hist_bound(mine, nbw, plan, *pk._child(row, int(nl)),
                             mxu=True)
        assert np.all(np.abs(gh[j].numpy() - kg[j]) <= bg)
        assert np.all(np.abs(hh[j].numpy() - kh[j]) <= bh)


SEGS = [(0, 3000), (77, 1500), (1201, 513), (2999, 1), (640, 0),
        (1800, 1024)]


def test_level_seg_hist_plain_is_a_seg_hist_loop(setup):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    tp, plan_t = _port(pay), pk.plan_tensor(plan, "cpu")
    gh, hh = pk.level_seg_hist(tp, plan_t, nbw, SEGS)
    assert gh.shape == hh.shape == (len(SEGS), G * 256)
    for j, (start, length) in enumerate(SEGS):
        rg, rh = pk.seg_hist_plain(tp, plan_t, nbw, start, length)
        assert torch.equal(gh[j], rg) and torch.equal(hh[j], rh)
    assert not gh[4].any() and not hh[4].any()       # the empty segment


def test_level_seg_hist_plain_matches_pallas_kernel(setup):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    S = len(SEGS)
    T_max = NP // C + 3 * S + 4
    kern = jpg.make_level_seg_hist(WPA, NP, G, plan, nbw, S, T_max, C=C,
                                   interpret=True)
    length = np.array([ln for _, ln in SEGS])
    nch = (length + C - 1) // C
    scal = np.stack([nch, [st for st, _ in SEGS], length,
                     np.zeros(S, np.int64)], axis=1).astype(np.int32)
    so, base, grid = _step_tables(np.where(length > 0, nch, 0), S, T_max)
    kg, kh = (np.asarray(a) for a in jax.vmap(jpg._unpack_hist)(
        kern(jnp.asarray(pay), jnp.asarray(scal), so, base, grid)))
    gh, hh = pk.level_seg_hist(_port(pay), pk.plan_tensor(plan, "cpu"), nbw,
                               SEGS)
    for j, (start, ln) in enumerate(SEGS):
        if ln == 0:
            continue                  # undefined in the TPU kernel
        bg, bh = _hist_bound(pay, nbw, plan, start, ln, mxu=True)
        assert np.all(np.abs(gh[j].numpy() - kg[j]) <= bg)
        assert np.all(np.abs(hh[j].numpy() - kh[j]) <= bh)


def test_level_wrappers_refuse_bad_input(setup):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    tp, plan_t = _port(pay), pk.plan_tensor(plan, "cpu")
    dst = tp.clone()
    scal = _scal_mat(ds, pa, SLOTS[3])
    with pytest.raises(LightGBMError, match=r"\[S, 16\]"):
        pk.level_pass(tp, dst, scal[:, :15], plan_t, nbw, nbw + 5, False)
    overlap = scal.copy()
    overlap[1, pk.S_S0] = overlap[0, pk.S_S0] + 10
    with pytest.raises(LightGBMError, match="overlap"):
        pk.level_pass(tp, dst, overlap, plan_t, nbw, nbw + 5, False)
    bad = scal.copy()
    bad[2, pk.S_WG] = nbw
    with pytest.raises(LightGBMError, match="bin word"):
        pk.level_pass(tp, dst, bad, plan_t, nbw, nbw + 5, False)
    with pytest.raises(LightGBMError, match="wp_live"):
        pk.level_pass(tp, dst, scal, plan_t, nbw, WPA + 1, False)
    with pytest.raises(LightGBMError, match="outside"):
        pk.level_seg_hist(tp, plan_t, nbw, [(0, 10), (NP - 5, 10)])
    with pytest.raises(LightGBMError, match="no segments"):
        pk.level_seg_hist(tp, plan_t, nbw, [])
    with pytest.raises(LightGBMError, match="no kernel for device meta"):
        pk.level_seg_hist(tp.to("meta"), plan_t.to("meta"), nbw, SEGS)
    with pytest.raises(LightGBMError, match="no kernel for device meta"):
        pk.level_pass(tp.to("meta"), dst.to("meta"), scal, plan_t.to("meta"),
                      nbw, nbw + 5, False)


@pytest.mark.cuda
def test_cuda_level_kernels_match_plain_versions(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    plan_c, plan_d = pk.plan_tensor(plan, "cpu"), pk.plan_tensor(plan, "cuda")
    cpu, dev = _port(pay), _port(pay).cuda()
    for a, b in zip(pk.level_seg_hist(cpu, plan_c, nbw, SEGS),
                    pk.level_seg_hist(dev, plan_d, nbw, SEGS)):
        assert torch.equal(a, b.cpu())
    for S in sorted(SLOTS):
        scal = _scal_mat(ds, pa, SLOTS[S])
        cpu_dst, dev_dst = cpu.clone(), dev.clone()
        na, ha = pk.level_pass(cpu, cpu_dst, scal, plan_c, nbw, nbw + 5, True)
        nb_, hb = pk.level_pass(dev, dev_dst, scal, plan_d, nbw, nbw + 5,
                                True)
        np.testing.assert_array_equal(na, nb_)
        assert torch.equal(cpu_dst, dev_dst.cpu())
        assert torch.equal(cpu, dev.cpu())
        assert torch.equal(ha[0], hb[0].cpu())
        assert torch.equal(ha[1], hb[1].cpu())
