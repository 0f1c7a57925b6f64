"""The two-buffer partition of the persistent grower, on the CPU.

``split_pass`` and ``level_pass`` read a leaf's segment from one payload
buffer (``src``) and write it partitioned into the other (``dst``) at the
same lanes; the grower keeps a leaf at depth d in buffer d % 2 and, at the
end of a tree, ``consolidate`` copies the odd-depth leaves back into the
payload. The payload is tests/test_torch_payload_kernels.py's (3000 rows,
built by the JAX package with C = CR = 512). Every equality here is exact:

  * the plain versions leave ``src`` untouched, and in ``dst`` every lane
    outside the segments and every row from wp_live on; ``dst``'s segments
    equal the in-place result of ``make_xla_split_pass`` (one call per slot)
    bit for bit; against ``make_level_pass`` in interpret mode (a two-ended
    FIFO) n_left is equal and each child the same multiset of columns;
  * the plain consolidation is a segment-by-segment copy;
  * after every tree of a training run, the consolidated payload equals a
    single-buffer stable partition (``torch.cat`` of the left and right
    lanes) of the same splits, replayed here in the grower's order, on the
    per-split path, the level path and both histogram branches;
  * a level program whose slots are at mixed depths raises.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import grow_persist as jgp
from lightgbm_tpu.ops import pallas_grow as jpg
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.ops import grow_persist
from lightgbm_torch.ops import payload_kernels as pk
from lightgbm_torch.utils.log import LightGBMError
from test_torch_level_kernels import SLOTS, _scal_mat, _step_tables
from test_torch_payload_kernels import (CASES, _feature_of_group, _geom,
                                        _port, _scalars, _sorted_by_rid,
                                        setup)  # noqa: F401


def _sentinel(shape, seed):
    """A buffer of random words, so that a lane left untouched is seen."""
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.integers(-2 ** 31, 2 ** 31, size=shape,
                                         dtype=np.int64).astype(np.int32))


def _outside(NP, segs):
    keep = np.ones(NP, bool)
    for s0, n_l in segs:
        keep[s0:s0 + n_l] = False
    return keep


def _xla_in_place(pay, rows, geom):
    """The JAX oracle's in-place stable partition of each slot's segment,
    one make_xla_split_pass call per slot, in order."""
    WPA, NP, G, plan, nbw = geom[:5]
    ref = jgp.make_xla_split_pass(WPA, NP, G, plan, nbw)
    out, n_lefts = jnp.asarray(pay), []
    for row in rows:
        out, _, nl = ref(out, jnp.asarray(row[:pk.N_SCALARS], jnp.int32))
        n_lefts.append(int(nl))
    return np.asarray(out).view(np.int32), n_lefts


@pytest.mark.parametrize("direction", ["payload_to_second",
                                       "second_to_payload"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_pass_plain_writes_dst_only(setup, case, direction):
    """Both directions of the grower: from the payload into a second buffer
    of wp_live rows, and from such a buffer into a payload, whose rows from
    wp_live on must stay as they were."""
    ds, ja, pa, pay = setup
    geom = _geom(pa)
    WPA, NP, G, plan, nbw = geom[:5]
    wp_live = nbw + 5
    f, s0, n_l, thr, dl, small_l, over = CASES[case]
    scal = _scalars(pa, _feature_of_group(ds, f), s0, n_l, thr, dl, small_l,
                    **over)
    full = _port(pay)
    if direction == "payload_to_second":
        src, dst = full, _sentinel((wp_live, NP), 1)
    else:
        src, dst = full[:wp_live].clone(), _sentinel((WPA, NP), 2)
    src0, dst0 = src.clone(), dst.clone()
    n_left, hist = pk.split_pass(src, dst, scal, pk.plan_tensor(plan, "cpu"),
                                 nbw, wp_live, True)
    assert torch.equal(src, src0)
    out = _outside(NP, [(s0, n_l)])
    assert torch.equal(dst[:, out], dst0[:, out])
    assert torch.equal(dst[wp_live:], dst0[wp_live:])
    ref, (rnl,) = _xla_in_place(pay, [scal], geom)
    assert n_left == rnl
    np.testing.assert_array_equal(dst[:wp_live, s0:s0 + n_l].numpy(),
                                  ref[:wp_live, s0:s0 + n_l])
    assert torch.equal(torch.stack(hist), torch.stack(pk.seg_hist_plain(
        dst, pk.plan_tensor(plan, "cpu"), nbw, *pk._child(scal, n_left))))


@pytest.mark.parametrize("S", sorted(SLOTS))
def test_level_pass_plain_writes_dst_only(setup, S):
    ds, ja, pa, pay = setup
    geom = _geom(pa)
    WPA, NP, G, plan, nbw, n, C = geom[:7]
    wp_live = nbw + 5
    scal = _scal_mat(ds, pa, SLOTS[S])
    segs = scal[:, [pk.S_S0, pk.S_NL]].tolist()
    src, dst = _port(pay), _sentinel((wp_live, NP), 3)
    dst0 = dst.clone()
    n_left, _ = pk.level_pass(src, dst, scal, pk.plan_tensor(plan, "cpu"),
                              nbw, wp_live, False)
    assert torch.equal(src, _port(pay))
    out = _outside(NP, segs)
    assert torch.equal(dst[:, out], dst0[:, out])
    ref, rnl = _xla_in_place(pay, scal.tolist(), geom)
    np.testing.assert_array_equal(n_left, rnl)
    for s0, n_l in segs:
        np.testing.assert_array_equal(dst[:, s0:s0 + n_l].numpy(),
                                      ref[:wp_live, s0:s0 + n_l])
    # the Pallas kernel, in place through its FIFO: the same children
    T_max = NP // C + 3 * S + 4
    kern = jpg.make_level_pass(WPA, NP, G, plan, nbw, S, T_max, C=C,
                               interpret=True, wp_live=wp_live)
    n_l = scal[:, pk.S_NL]
    so, base, grid = _step_tables(np.where(n_l > 0, scal[:, pk.S_NCH] + 2, 0),
                                  S, T_max)
    kpay, _, knl = kern(jnp.asarray(pay), jnp.asarray(scal, jnp.int32), so,
                        base, grid)
    kpay = np.asarray(kpay).view(np.int32)[:wp_live]
    np.testing.assert_array_equal(n_left, np.asarray(knl))
    mine = dst.numpy()
    for (s0, ln), nl in zip(segs, n_left):
        for a, b in ((s0, s0 + nl), (s0 + nl, s0 + ln)):
            np.testing.assert_array_equal(_sorted_by_rid(kpay[:, a:b], nbw),
                                          _sorted_by_rid(mine[:, a:b], nbw))


def test_consolidate_plain_is_a_segment_copy():
    wp_live, rows, NP = 6, 9, 5000
    src, dst = _sentinel((wp_live, NP), 4), _sentinel((rows, NP), 5)
    segs = [(3, 1000), (1003, 0), (1500, 1), (2048, 2000), (4999, 1)]
    ref = dst.clone()
    for st, ln in segs:
        ref[:wp_live, st:st + ln].copy_(src[:, st:st + ln])
    src0 = src.clone()
    pk.consolidate(src, dst, segs, wp_live)
    assert torch.equal(dst, ref)
    assert torch.equal(src, src0)
    with pytest.raises(LightGBMError, match="overlaps"):
        pk.consolidate(src, dst, [(0, 10), (5, 10)], wp_live)
    with pytest.raises(LightGBMError, match="overlaps"):
        pk.consolidate(src, dst, [(NP - 5, 10)], wp_live)
    with pytest.raises(LightGBMError, match="share their memory"):
        pk.consolidate(dst, dst, segs, wp_live)
    with pytest.raises(LightGBMError, match="wp_live"):
        pk.consolidate(src, dst, segs, wp_live + 1)


def _go_left(word, s):
    """DenseBin::Split at the bin level, written here again: the split
    rule the grower's scalars encode."""
    b = (word >> s[pk.S_SH]) & s[pk.S_MASK]
    b = torch.where((b >= s[pk.S_LS]) & (b < s[pk.S_LE]), b - s[pk.S_LS],
                    torch.full_like(b, s[pk.S_MF]))
    miss = ((b == s[pk.S_NB] - 1) if s[pk.S_MT] == 2 else
            (b == s[pk.S_DB]) if s[pk.S_MT] == 1 else torch.zeros_like(
                b, dtype=torch.bool))
    return torch.where(miss, torch.full_like(miss, bool(s[pk.S_DL])),
                       b <= s[pk.S_THR])


def _replay(pay, splits, wp_live):
    """A single-buffer stable partition of each recorded split, in place,
    in the order the grower made them."""
    for s in splits:
        s0, n_l = s[pk.S_S0], s[pk.S_NL]
        seg = pay[:wp_live, s0:s0 + n_l]
        gl = _go_left(seg[s[pk.S_WG]], s)
        pay[:wp_live, s0:s0 + n_l] = torch.cat([seg[:, gl], seg[:, ~gl]], 1)


BASE = {"objective": "binary", "max_bin": 63, "min_data_in_leaf": 20,
        "learning_rate": 0.2, "verbosity": -1, "tpu_persist_scan": "force",
        "device_type": "cpu"}
GROW = {  # features, parameters beyond BASE; whether a level program runs
    "per_split": (6, {"num_leaves": 15}, False),
    "per_split_seg_hist": (24, {"num_leaves": 11}, False),
    "level": (6, {"num_leaves": 16, "max_depth": 4}, True),
    "level_seg_hist": (24, {"num_leaves": 8, "max_depth": 3}, True),
    "per_split_depth_bound": (6, {"num_leaves": 12, "max_depth": 4}, False),
}


@pytest.mark.parametrize("name", sorted(GROW))
def test_grow_payload_equals_single_buffer_partition(name, monkeypatch):
    f, extra, level = GROW[name]
    X, y = make_higgs_like(3000, seed=13)
    X = X[:, :f].copy()
    X[np.random.default_rng(13).random(X.shape) < 0.05] = np.nan
    p = dict(BASE, **extra)
    bst = lp.Booster(p, lp.Dataset(X, y, params=p))
    learner = bst._booster.tree_learner
    gr = learner._persist_grower()
    assert gr.second.shape == (gr.wp_live, gr.assets.geometry[1])
    assert gr.second.dtype == torch.int32
    splits, merged = [], []

    def spy_split(src, dst, scal, *args, **kw):
        # the device form: scalars in a tensor; a step with the done flag
        # set is a no-op
        if int(kw["done"][0]) == 0:
            splits.append([int(v) for v in scal[:pk.N_SCALARS]])
        return pk.split_pass_device(src, dst, scal, *args, **kw)

    def spy_level(src, dst, scal, *args):
        splits.extend([int(v) for v in row[:pk.N_SCALARS]]
                      for row in np.asarray(scal))
        return pk.level_pass(src, dst, scal, *args)

    def spy_consolidate(src, dst, tab, wp_live):
        # the device form: a table of the tree's leaves, length 0 for the
        # even-depth ones
        odd_segs = int((tab[:, 1] > 0).sum())
        if odd_segs:
            merged.append(odd_segs)
        return pk.consolidate_device(src, dst, tab, wp_live)

    monkeypatch.setattr(grow_persist, "split_pass_device", spy_split)
    monkeypatch.setattr(grow_persist, "level_pass", spy_level)
    monkeypatch.setattr(grow_persist, "consolidate_device", spy_consolidate)
    pay = gr.init_carry(torch.zeros(3000, dtype=torch.float64))
    grad_fn = bst._booster.objective.payload_grad_fn()
    mask = np.ones(f, bool)
    for _ in range(3):
        gr.fill_grad(pay, grad_fn)
        ref = pay.clone()
        splits.clear()
        lstate, tree, num_leaves = gr.grow(pay, mask)
        assert len(splits) == num_leaves - 1 > 2
        _replay(ref, splits, gr.wp_live)
        assert torch.equal(pay, ref)
        # one consolidation, of every odd-depth leaf, where there is one
        odd = int(np.sum(lstate.depth[:num_leaves] % 2))
        assert merged == ([odd] if odd else [])
        merged.clear()
        gr.apply_scores(pay, lstate, num_leaves, 0.2)
    assert (sum(a for a, _ in gr.grow_stats) > 0) == level


def test_level_program_refuses_mixed_depths():
    a, b = torch.zeros(1), torch.ones(1)
    src, dst = grow_persist.level_buffers((a, b), np.array([2, 2, 2]))
    assert src is a and dst is b
    src, dst = grow_persist.level_buffers((a, b), np.array([3]))
    assert src is b and dst is a
    with pytest.raises(LightGBMError, match="share one depth"):
        grow_persist.level_buffers((a, b), np.array([3, 3, 4]))
