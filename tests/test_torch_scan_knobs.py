"""The split scan's numerical knobs: the port against the JAX package.

``lambda_l1``, ``max_delta_step``, monotone constraints, ``extra_trees`` and
``feature_fraction_bynode`` reach the JAX package's general scan,
``find_best_split_numerical`` (lightgbm_tpu/ops/split.py:241), and its
leaf helpers (:145-208). The port computes them in ``ops/split.py`` (the
helpers) and in the knob form of ``ops/scan.py:scan_pair_plain``.

  * The helpers, on float32 inputs (L1 that kills a gradient, clamps that
    bind, finite and infinite monotone bounds, both constraint signs), give
    the JAX f32 helpers' values bit for bit.
  * The knob scan of two children of a real layout (missing types None,
    Zero and NaN) picks, per child, the same best (feature, threshold,
    direction) as ``find_best_split_numerical(..., use_dp=False)`` with the
    same knobs, extra_trees bins and by-node mask; the per-feature gains
    agree within rtol 1e-5 plus 1e-6 of the child's largest gain (the JAX
    scan sums its f32 prefix sums in f32, the port in f64 rounded to f32,
    and the knob gains subtract terms), and the left sums within rtol 1e-5.
  * With neutral knobs (no L1, no clamp, no constraint, no draws) the knob
    form equals the fast form bit for bit, and its rows form equals its
    gathered form.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import split as js
from lightgbm_tpu.ops.grow import _mono_bounds
from lightgbm_torch.ops import split as ps
from lightgbm_torch.ops.scan import (knob_scalars, pair_scalars,
                                     scan_pair_plain, scan_pair_rows_plain)
from lightgbm_torch.ops.split import SplitParams
from test_torch_scan import _children, _dataset, _layouts
from test_torch_scan_rows import knob_case, pair_gathered

F32 = np.float32
RTOL = 1e-5


def _inputs(seed, n=4000):
    rng = np.random.default_rng(seed)
    g = (rng.normal(size=n) * rng.choice([0.01, 1.0, 30.0], n)).astype(F32)
    g[rng.random(n) < 0.05] = 0.0
    h = rng.uniform(0.01, 20.0, n).astype(F32)
    return g, h, rng


@pytest.mark.parametrize("seed,l1,mds", [(0, 0.0, 0.0), (1, 0.7, 0.0),
                                         (2, 0.0, 0.5), (3, 2.5, 0.05)])
def test_helpers_match_jax_f32(seed, l1, mds):
    g, h, rng = _inputs(seed)
    l2 = F32(0.3)
    use_l1, use_mds = l1 > 0, mds > 0
    l1, mds = F32(l1), F32(mds)
    cmin = np.where(rng.random(len(g)) < 0.3, -np.inf,
                    -rng.uniform(0, 0.5, len(g))).astype(F32)
    cmax = np.where(rng.random(len(g)) < 0.3, np.inf,
                    rng.uniform(0, 0.5, len(g))).astype(F32)
    mono = rng.choice([-1.0, 0.0, 1.0], len(g)).astype(F32)
    j = [jnp.asarray(a) for a in (g, h, cmin, cmax, mono)]
    jl1, jl2, jmds = jnp.float32(l1), jnp.float32(l2), jnp.float32(mds)
    t = [torch.as_tensor(a) for a in (g, h, cmin, cmax, mono)]
    tl1, tl2, tmds = (torch.tensor(v, dtype=torch.float32)
                      for v in (l1, l2, mds))

    def same(port_np, port_t, ref):
        ref = np.asarray(ref)
        np.testing.assert_array_equal(np.asarray(port_np, F32), ref)
        np.testing.assert_array_equal(port_t.numpy(), ref)

    same(ps.threshold_l1(g, l1, use_l1), ps.threshold_l1(t[0], tl1, use_l1),
         js._threshold_l1(j[0], jl1, use_l1))
    same(ps.leaf_output_unconstrained(g, h, l2, l1, mds, use_l1, use_mds),
         ps.leaf_output_unconstrained(t[0], t[1], tl2, tl1, tmds, use_l1,
                                      use_mds),
         js._leaf_output_unconstrained(j[0], j[1], jl1, jl2, jmds, use_l1,
                                       use_mds))
    same(ps.leaf_output(g, h, l2, l1, mds, cmin, cmax, use_l1, use_mds,
                        True),
         ps.leaf_output(t[0], t[1], tl2, tl1, tmds, t[2], t[3], use_l1,
                        use_mds, True),
         js._leaf_output(j[0], j[1], jl1, jl2, jmds, j[2], j[3], True,
                         use_l1, use_mds))
    same(ps.leaf_gain(g, h, l2, l1, mds, use_l1, use_mds),
         ps.leaf_gain(t[0], t[1], tl2, tl1, tmds, use_l1, use_mds),
         js._leaf_gain(j[0], j[1], jl1, jl2, jmds, use_l1, use_mds))
    half = len(g) // 2
    args_np = (g[:half], h[:half], g[half:], h[half:])
    args_t = tuple(torch.as_tensor(a) for a in args_np)
    args_j = tuple(jnp.asarray(a) for a in args_np)
    for use_mc in (False, True):
        same(ps.split_gains(*args_np, l2, l1, mds, cmin[:half], cmax[:half],
                            mono[:half], use_l1, use_mds, use_mc),
             ps.split_gains(*args_t, tl2, tl1, tmds, t[2][:half],
                            t[3][:half], t[4][:half], use_l1, use_mds,
                            use_mc),
             js._split_gains(*args_j, jl1, jl2, jmds, j[2][:half],
                             j[3][:half], j[4][:half], use_mc, use_l1,
                             use_mds))


def test_mono_bounds_match_jax():
    rng = np.random.default_rng(4)
    for _ in range(200):
        cmin = F32(-np.inf if rng.random() < 0.3 else -rng.uniform(0, 1))
        cmax = F32(np.inf if rng.random() < 0.3 else rng.uniform(0, 1))
        lo, ro = rng.normal(size=2).astype(F32)
        mono = int(rng.choice([-1, 0, 1]))
        got = ps.mono_bounds(cmin, cmax, mono, lo, ro)
        want = _mono_bounds(jnp.float32(cmin), jnp.float32(cmax),
                               jnp.int32(mono), jnp.float32(lo),
                               jnp.float32(ro), jnp.float32)
        np.testing.assert_array_equal(np.array(got, F32),
                                      np.array([np.asarray(w) for w in want],
                                               F32))


def _knob_run(zero_as_missing, seed, l1, mds, mono_on, rand_on, bynode_on):
    """Both packages' knob scans of two children; returns the port's
    [2, 8, Fp] output, the JAX candidates, the JAX per-feature gains and
    F."""
    cfg, ds, grad, hess = _dataset(zero_as_missing, seed=seed)
    F = ds.num_features
    rng = np.random.default_rng(seed + 10)
    fmask = np.ones(F, bool)
    fmask[rng.integers(F)] = False                       # a per-tree mask
    jl, pl = _layouts(cfg, ds, fmask)
    mono = (rng.choice([-1, 1], F) * (rng.random(F) < 0.7)).astype(np.int32) \
        if mono_on else np.zeros(F, np.int32)
    pl.aux[1, :F] = torch.as_tensor(mono, dtype=torch.float32)
    hists, sums = _children(ds, grad, hess, seed)
    p = SplitParams(lambda_l2=0.5, min_gain_to_split=0.0, min_data_in_leaf=20,
                    min_sum_hessian_in_leaf=1e-3, lambda_l1=l1,
                    max_delta_step=mds)
    cmin = np.array([-0.2, -np.inf], F32) if mono_on else \
        np.full(2, -np.inf, F32)
    cmax = np.array([np.inf, 0.15], F32) if mono_on else \
        np.full(2, np.inf, F32)
    scal = knob_scalars([s[0] for s in sums], [s[1] for s in sums],
                        [s[2] for s in sums], p, cmin, cmax, mono_on)
    nb = (ds.bin_end - ds.bin_start).astype(np.int64)
    rbins = [rng.integers(0, np.maximum(nb - 1, 1)) if rand_on else None
             for _ in range(2)]
    nmask = [rng.random(F) < 0.7 if bynode_on else np.ones(F, bool)
             for _ in range(2)]
    Fp = pl.Fp
    node = np.zeros((2, 2, Fp), F32)
    node[:, 0] = -1
    for c in range(2):
        if rand_on:
            node[c, 0, :F] = rbins[c]
        node[c, 1, :F] = nmask[c]
    gidx = pl.gidx.numpy()
    gb = torch.as_tensor(np.ascontiguousarray(hists[:, :, 0][:, gidx]))
    hb = torch.as_tensor(np.ascontiguousarray(hists[:, :, 1][:, gidx]))
    got = scan_pair_plain(torch.as_tensor(scal), gb, hb, pl.keep_r,
                          pl.keep_f, pl.valid_r, pl.valid_f, pl.aux,
                          torch.as_tensor(node)).numpy()
    _, meta = ds.to_device(cfg)
    meta = meta._replace(monotone=jnp.asarray(mono))
    jp = js.SplitParams.from_config(cfg)._replace(
        lambda_l1=jnp.asarray(l1, jnp.float64),
        lambda_l2=jnp.asarray(0.5, jnp.float64),
        max_delta_step=jnp.asarray(mds, jnp.float64))
    W = int(nb.max())
    cands, gains = [], []
    for c in range(2):
        kw = dict(num_features=F, use_mc=mono_on, max_w=W, use_dp=False,
                  use_l1=l1 > 0, use_mds=mds > 0,
                  rand_bins=(jnp.asarray(rbins[c]) if rand_on else None))
        args = (jnp.asarray(hists[c]), jnp.float32(sums[c][0]),
                jnp.float32(sums[c][1]), jnp.int32(sums[c][2]), meta, jp,
                jnp.float32(cmin[c]), jnp.float32(cmax[c]),
                jnp.asarray(fmask & nmask[c]))
        cands.append(js.find_best_split_numerical(*args, **kw))
        gains.append(np.asarray(js.find_best_split_numerical(
            *args, feat_gains_only=True, **kw)))
    return got, cands, gains, F, pl


@pytest.mark.parametrize("zero_as_missing,seed,l1,mds,mono,rand,bynode", [
    (False, 1, 0.8, 0.0, False, False, False),
    (True, 2, 0.0, 0.05, False, False, False),
    (False, 3, 0.0, 0.0, True, False, False),
    (True, 4, 0.0, 0.0, False, True, False),
    (False, 5, 0.0, 0.0, False, False, True),
    (True, 6, 1.5, 0.02, True, True, True),
    (False, 7, 0.3, 0.1, True, False, True)])
def test_knob_scan_matches_find_best_split_numerical(
        zero_as_missing, seed, l1, mds, mono, rand, bynode):
    got, cands, gains, F, pl = _knob_run(zero_as_missing, seed, l1, mds,
                                         mono, rand, bynode)
    for c in range(2):
        g_port, g_jax = got[c, 0, :F], gains[c]
        fin = np.isfinite(g_jax)
        np.testing.assert_array_equal(np.isfinite(g_port), fin)
        scale = float(np.abs(g_jax[fin]).max()) if fin.any() else 0.0
        np.testing.assert_allclose(g_port[fin], g_jax[fin], rtol=RTOL,
                                   atol=1e-6 * scale)
        cand = cands[c]
        bf = int(np.argmax(got[c, 0]))
        valid = bool(np.isfinite(got[c, 0, bf]))
        assert valid == (int(cand.feature) >= 0)
        if not valid:
            continue
        assert bf == int(cand.feature)
        assert int(got[c, 1, bf]) == int(cand.threshold)
        use_f = got[c, 2, bf] > 0.5
        assert (not use_f and not pl.forced_right[bf]) \
            == bool(cand.default_left)
        np.testing.assert_allclose(got[c, 3, bf], float(cand.left_sum_grad),
                                   rtol=RTOL, atol=1e-6)
        np.testing.assert_allclose(got[c, 4, bf], float(cand.left_sum_hess),
                                   rtol=RTOL)
        assert got[c, 5, bf] == int(cand.left_count)
    # the run exercised its knobs: some child found a split
    assert any(int(c.feature) >= 0 for c in cands)


@pytest.mark.parametrize("B,Wp", [(2, 256), (9, 32)])
def test_neutral_knobs_equal_the_fast_form(B, Wp):
    """lambda_l1 = 0, max_delta_step = 0, no constraint and no node draws:
    the knob form's operations reduce to the fast form's, bit for bit; the
    rows form equals the gathered form."""
    c = knob_case(40 + B, B, Wp, l1=0.0, mds=0.0, use_mc=False, rand=0.0,
                  drop=0.0)
    fast = dict(c, scal=c["scal"][:, :8].contiguous())
    want = scan_pair_plain(*pair_gathered(fast))
    args = pair_gathered(c)
    got = scan_pair_plain(*args, node=c["node"])
    assert torch.equal(got, want)
    rows = scan_pair_rows_plain(c["scal"], c["gh"], c["hh"], c["rows"],
                                c["gidx"], *args[3:], node=c["node"])
    assert torch.equal(rows, got)
    assert (want[:, 6] > 0).sum() >= B


def test_knob_case_draws_bind():
    """The card tests' knob inputs exercise every knob: the extra_trees
    lane is the only threshold a drawn pair may take, a masked feature has
    no split, and the constrained gains differ from the unconstrained."""
    c = knob_case(5, 64, 256)
    args = pair_gathered(c)
    out = scan_pair_plain(*args, node=c["node"])
    node = c["node"]
    has = out[:, 6] > 0
    drawn = (node[:, 0] >= 0) & has
    assert drawn.any()
    assert torch.equal(out[:, 1][drawn], node[:, 0][drawn])
    assert not (has & (node[:, 1] == 0)).any()
    off = dict(c, scal=c["scal"].clone())
    off["scal"][:, 12] = 0.0
    assert not torch.equal(scan_pair_plain(*pair_gathered(off),
                                           node=node)[:, 0], out[:, 0])


def test_knob_scalars_shift_is_the_general_scans():
    """knob_scalars' gain shift is the JAX scan's min_gain_shift: the
    parent's leaf_gain under L1 and max_delta_step, plus
    min_gain_to_split."""
    p = SplitParams(lambda_l2=0.25, min_gain_to_split=0.125,
                    min_data_in_leaf=5, min_sum_hessian_in_leaf=1e-3,
                    lambda_l1=0.5, max_delta_step=0.2)
    sg = np.array([3.5, -0.25, 80.0], F32)
    sh = np.array([2.0, 0.5, 1.5], F32)
    s = knob_scalars(sg, sh, [10, 20, 30], p, [-1.0, -np.inf, 0.0],
                     [1.0, np.inf, 0.5], True)
    np.testing.assert_array_equal(s[:, :6],
                                  pair_scalars(sg, sh, [10, 20, 30], 0.25,
                                               0.125, 5, 1e-3)[:, :6])
    want = np.asarray(js._leaf_gain(
        jnp.asarray(sg), jnp.asarray(sh) + jnp.float32(2e-15),
        jnp.float32(0.5), jnp.float32(0.25), jnp.float32(0.2))) \
        + F32(0.125)
    np.testing.assert_array_equal(s[:, 6], want.astype(F32))
    np.testing.assert_array_equal(s[:, 8:13], np.array(
        [[0.5, 0.2, -1.0, 1.0, 1.0], [0.5, 0.2, -np.inf, np.inf, 1.0],
         [0.5, 0.2, 0.0, 0.5, 1.0]], F32))
