"""The persistent grower's device steps (lightgbm_torch/ops/grow_step.py)
against the host code they replace, bit for bit, on the CPU.

The steps' plain versions run here; each is held equal to the numpy code
that the host loop ran before the loop moved to the device, which stays in
use by the v1 grower and the level phase: ``np.argmax`` over the leaves'
gains and ``PersistGrower._scalars`` (pick), the host loop's ``split()``
bookkeeping and ``ops/scan.py:pair_scalars`` (commit), the parent-minus-
smaller subtraction (planes), ``ops/grow.py:assemble`` after the scan's
first maximum (assemble, both scans), the odd-depth segment list
(cons_table) and the argsort/repeat_interleave score update
(apply_scores). Inputs are random states with the edges: -inf gains,
exact gain ties across leaves and across features, +inf and NaN scan
gains, a child at max_depth, zero hessians, forced_right features, and the
done flag.

This module imports numpy, torch and lightgbm_torch only; its builders
(:func:`random_case`, :func:`on`) also serve the card tests
(tests/test_torch_grow_step_cuda.py) and chip_smoke.py.
"""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lightgbm_torch.ops import counters
from lightgbm_torch.ops import grow_step as gs
from lightgbm_torch.ops.grow import assemble
from lightgbm_torch.ops.grow_persist import PersistGrower
from lightgbm_torch.ops.scan import pair_scalars
from lightgbm_torch.ops.split import SplitCandidate, SplitParams

F32 = np.float32


def random_assets(rng, F):
    """A PersistAssets-like namespace of F features' decode scalars."""
    nb = rng.integers(2, 256, F).astype(np.int32)
    ls = rng.integers(0, 4, F).astype(np.int32)
    return SimpleNamespace(
        dec_word=rng.integers(0, 7, F).astype(np.int32),
        dec_shift=(rng.integers(0, 4, F) * 8).astype(np.int32),
        dec_mask=np.where(rng.random(F) < 0.3, 15, 255).astype(np.int32),
        nb=nb, mt=rng.integers(0, 3, F).astype(np.int32),
        db=rng.integers(0, 4, F).astype(np.int32), ls=ls,
        le=(ls + nb).astype(np.int32),
        mf=rng.integers(0, 3, F).astype(np.int32))


def random_case(seed, L=31, F=12, n=100_000, Fp=16, G=6, Gp=8, Wp=128,
                max_depth=6, l2=0.7, ties=True):
    """A random mid-tree state on the CPU and the operands of every step:
    returns a dict with the GrowState ``S``, the feature table ``feat``,
    ``assets``, ``forced_right``, the StepConst ``k``, the planes ``gh``,
    ``hh`` [L, G * 256] and ``small`` [2, G * 256], a scan_pair output
    ``out_pair`` [2, 8, Fp], a scan_blocks output ``out_blocks`` [2, 8, Gp]
    with its owner map [Gp * Wp], and the payload score row ``score``."""
    rng = np.random.default_rng(seed)
    params = SplitParams(lambda_l2=l2, min_gain_to_split=0.05,
                         min_data_in_leaf=20, min_sum_hessian_in_leaf=1e-3)
    k = gs.StepConst.of(params, max_depth, 16384)
    S = gs.GrowState(L, "cpu")
    s = int(rng.integers(2, L - 1))
    cuts = np.sort(rng.choice(np.arange(1, n), s - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    perm = rng.permutation(s)
    gains = np.full(L, -np.inf, F32)
    gains[:s] = (rng.normal(size=s) * 5).astype(F32)
    gains[rng.random(L) < 0.2] = -np.inf
    if ties:                             # an exact tie for the maximum
        j = rng.choice(s, 2, replace=False)
        gains[j] = F32(abs(gains[:s][np.isfinite(gains[:s])]).max() + 1)
    lf, li = S.lf.numpy(), S.li.numpy()
    lf[:] = rng.normal(size=lf.shape).astype(F32)
    lf[:, gs.LF_GAIN] = gains
    lf[:, [gs.LF_SUM_HESS, gs.LF_LSH, gs.LF_RSH]] = np.abs(
        lf[:, [gs.LF_SUM_HESS, gs.LF_LSH, gs.LF_RSH]])
    lf[rng.random(L) < 0.1, gs.LF_LSH] = 0.0          # zero hessians
    li[:, gs.LI_START] = bounds[:-1][np.resize(perm, L)]
    li[:s, gs.LI_START] = bounds[:-1][perm]
    li[:s, gs.LI_NROWS] = np.diff(bounds)[perm]
    li[:, gs.LI_COUNT] = li[:, gs.LI_NROWS] + rng.integers(0, 3, L)
    li[:, gs.LI_DEPTH] = rng.integers(0, max_depth + 1, L)
    li[:, gs.LI_FEAT] = rng.integers(0, F, L)
    li[:, gs.LI_THR] = rng.integers(0, 255, L)
    li[:, gs.LI_DL] = rng.integers(0, 2, L)
    li[:, gs.LI_LCNT] = rng.integers(0, n, L)
    li[:, gs.LI_RCNT] = rng.integers(0, n, L)
    S.rf.numpy()[:] = rng.normal(size=S.rf.shape).astype(F32)
    S.ri.numpy()[:] = rng.integers(0, L, S.ri.shape)
    S.st.numpy()[gs.ST_S] = s
    assets = random_assets(rng, F)
    forced_right = rng.random(Fp) < 0.3
    feat = gs.feature_table(assets, forced_right, Fp, "cpu")
    TBp = G * 256
    gh = torch.as_tensor(rng.normal(size=(L, TBp)).astype(F32))
    hh = torch.as_tensor(np.abs(rng.normal(size=(L, TBp))).astype(F32))
    small = torch.as_tensor(rng.normal(size=(2, TBp)).astype(F32))

    def scan_out(B, W, lanes):
        o = rng.normal(size=(B, 8, W)).astype(F32)
        o[:, 0] = np.abs(o[:, 0]) * 3
        o[:, 0][rng.random((B, W)) < 0.3] = -np.inf
        if ties:                         # an exact tie across features
            o[:, 0, 1] = o[:, 0, 3] = o[:, 0].max() + 1
        o[:, 1] = rng.integers(-1, lanes, (B, W))
        o[:, 2] = rng.integers(0, 2, (B, W))
        o[:, 4] = np.abs(o[:, 4])
        o[:, 5] = rng.integers(0, 5000, (B, W))
        o[:, 6] = rng.integers(0, 2, (B, W))
        o[:, 7] = 0
        return torch.as_tensor(o)
    owner = torch.as_tensor(rng.integers(0, F, Gp * Wp).astype(np.int32))
    score = torch.as_tensor(rng.normal(size=n).astype(F32))
    return dict(S=S, feat=feat, assets=assets, forced_right=forced_right,
                k=k, params=params, gh=gh, hh=hh, small=small,
                out_pair=scan_out(2, Fp, 255), out_blocks=scan_out(2, Gp, Wp),
                owner=owner, Wp=Wp, score=score, n=n, rng=rng)


def on(case, device):
    """A copy of the case's tensors (and its state) on `device`."""
    out = dict(case)
    S = gs.GrowState(case["S"].L, device)
    S.blob.copy_(case["S"].blob)
    out["S"] = S
    for key in ("feat", "gh", "hh", "small", "out_pair", "out_blocks",
                "owner", "score"):
        out[key] = case[key].to(device).clone()
    return out


def state_arrays(S):
    return {k: v.cpu().numpy().copy() for k, v in S.views(S.blob).items()}


def assert_same_state(a, b):
    for k in a:
        assert np.array_equal(a[k].view(np.uint8), b[k].view(np.uint8)), k


# ---- pick ----------------------------------------------------------------

def _host_candidates(S, L):
    """The leaf table's candidates as the host loop's SplitCandidates."""
    lf, li = S.lf.numpy(), S.li.numpy()
    return [SplitCandidate(
        gain=lf[l, gs.LF_GAIN], feature=int(li[l, gs.LI_FEAT]),
        threshold=int(li[l, gs.LI_THR]),
        default_left=bool(li[l, gs.LI_DL]), left_output=lf[l, gs.LF_LOUT],
        right_output=lf[l, gs.LF_ROUT], left_sum_grad=lf[l, gs.LF_LSG],
        left_sum_hess=lf[l, gs.LF_LSH], right_sum_grad=lf[l, gs.LF_RSG],
        right_sum_hess=lf[l, gs.LF_RSH],
        left_count=int(li[l, gs.LI_LCNT]),
        right_count=int(li[l, gs.LI_RCNT])) for l in range(L)]


@pytest.mark.parametrize("seed", range(6))
def test_pick_matches_host_loop(seed):
    c = random_case(seed)
    S, L = c["S"], c["S"].L
    gains = S.lf[:, gs.LF_GAIN].numpy().copy()
    s = int(S.st[gs.ST_S])
    before = state_arrays(S)
    gs.pick(S, c["feat"], c["k"])
    l = int(np.argmax(gains))
    assert int(S.st[gs.ST_LEAF]) == l and int(S.st[gs.ST_DONE]) == 0
    cand = _host_candidates(SimpleNamespace(lf=torch.as_tensor(before["lf"]),
                                            li=torch.as_tensor(before["li"])),
                            L)[l]
    li = before["li"][l]
    grower = SimpleNamespace(assets=c["assets"], C=c["k"].C)
    want = PersistGrower._scalars(grower, cand, int(li[gs.LI_START]),
                                  int(li[gs.LI_NROWS]),
                                  cand.left_count <= cand.right_count)
    assert S.scal[:15].tolist() == want
    assert int(S.st[gs.ST_PARITY]) == int(li[gs.LI_DEPTH]) % 2
    assert S.rows.tolist() == [l, s]
    assert S.ri[s - 1].tolist() == [l, cand.feature, cand.threshold,
                                    int(cand.default_left),
                                    int(li[gs.LI_COUNT])]
    assert S.rf[s - 1, gs.RF_GAIN].numpy() == cand.gain
    assert S.rf[s - 1, gs.RF_IVAL].numpy() == before["lf"][l, gs.LF_VALUE]


def test_pick_ties_and_done():
    c = random_case(3, ties=False)
    S, L = c["S"], c["S"].L
    s = int(S.st[gs.ST_S])
    lf = S.lf.numpy()
    lf[:, gs.LF_GAIN] = -np.inf
    lf[[s - 1, 0, 1], gs.LF_GAIN] = F32(2.5)       # ties: the smaller id
    gs.pick(S, c["feat"], c["k"])
    assert int(S.st[gs.ST_LEAF]) == 0
    for gains, s_ in ((np.full(L, -np.inf, F32), s),    # nothing splits
                      (np.zeros(L, F32), s),             # no positive gain
                      (np.ones(L, F32), L)):             # the tree is full
        c = random_case(4)
        S = c["S"]
        S.lf.numpy()[:, gs.LF_GAIN] = gains
        S.st[gs.ST_S] = s_
        before = state_arrays(S)
        gs.pick(S, c["feat"], c["k"])
        after = state_arrays(S)
        assert after["st"][0, gs.ST_DONE] == 1
        after["st"][0, gs.ST_DONE] = 0
        assert_same_state(before, after)
    # once done, every step leaves the state as it is
    before = state_arrays(S)
    gs.pick(S, c["feat"], c["k"])
    gs.commit(S, c["k"])
    gs.planes(S, c["gh"], c["hh"], c["small"])
    gs.assemble(S, c["out_pair"], gs.SCAN_PAIR, c["owner"], c["Wp"],
                c["feat"], c["k"], True)
    assert_same_state(before, state_arrays(S))


def test_first_max_is_numpy_argmax():
    rng = np.random.default_rng(0)
    for _ in range(50):
        x = rng.normal(size=9).astype(F32)
        x[rng.random(9) < 0.3] = -np.inf
        x[rng.random(9) < 0.2] = x.max()
        if rng.random() < 0.3:
            x[rng.integers(9)] = np.nan
        if rng.random() < 0.2:
            x[rng.integers(9)] = np.inf
        assert gs.first_max(torch.as_tensor(x)) == int(np.argmax(x))


# ---- commit --------------------------------------------------------------

@pytest.mark.parametrize("seed", range(6))
def test_commit_matches_split_and_pair_scalars(seed):
    c = random_case(10 + seed)
    S, k, p = c["S"], c["k"], c["params"]
    gs.pick(S, c["feat"], k)
    l, s = int(S.st[gs.ST_LEAF]), int(S.st[gs.ST_S])
    lf, li = S.lf.numpy().copy(), S.li.numpy().copy()
    n_l = int(li[l, gs.LI_NROWS])
    n_left = int(c["rng"].integers(0, n_l + 1))
    S.st[gs.ST_NLEFT] = n_left
    gs.commit(S, k)
    # the host loop's split() (ops/grow_persist.py before the device loop)
    left_cnt, right_cnt = n_left, int(li[l, gs.LI_COUNT]) - n_left
    depth = int(li[l, gs.LI_DEPTH]) + 1
    for leaf, sh_, cnt_, val_, st_, nr_ in (
            (l, lf[l, gs.LF_LSH], left_cnt, lf[l, gs.LF_LOUT],
             li[l, gs.LI_START], n_left),
            (s, lf[l, gs.LF_RSH], right_cnt, lf[l, gs.LF_ROUT],
             li[l, gs.LI_START] + n_left, n_l - n_left)):
        assert S.lf[leaf, gs.LF_SUM_HESS].numpy() == sh_
        assert S.lf[leaf, gs.LF_VALUE].numpy() == val_
        assert S.li[leaf, [gs.LI_COUNT, gs.LI_DEPTH, gs.LI_START,
                           gs.LI_NROWS]].tolist() == [cnt_, depth, st_, nr_]
    shs = [lf[l, gs.LF_LSH], lf[l, gs.LF_RSH]]
    want = pair_scalars([lf[l, gs.LF_LSG], lf[l, gs.LF_RSG]], shs,
                        [left_cnt, right_cnt], p.lambda_l2,
                        p.min_gain_to_split, p.min_data_in_leaf,
                        p.min_sum_hessian_in_leaf)
    assert np.array_equal(S.ps8.numpy().view(np.uint32),
                          want.view(np.uint32))
    assert np.array_equal(S.ps.numpy()[:, :8].view(np.uint32),
                          want.view(np.uint32))
    assert np.array_equal(S.ps.numpy()[:, 8], np.asarray(shs, F32))


def test_root_matches_host_root():
    c = random_case(20)
    S, k, p = c["S"], c["k"], c["params"]
    sums = torch.tensor([-3.25, 0.0], dtype=torch.float32)  # zero hessian
    gs.root(S, sums, 777, k)
    sg, sh = F32(-3.25), F32(0.0)
    assert S.lf[0, gs.LF_VALUE].numpy() == -sg / (sh + F32(p.lambda_l2))
    want = pair_scalars([sg], [sh], [777], p.lambda_l2, p.min_gain_to_split,
                        p.min_data_in_leaf, p.min_sum_hessian_in_leaf)
    assert np.array_equal(S.ps8[:1].numpy().view(np.uint32),
                          want.view(np.uint32))
    assert S.st.tolist()[:2] == [1, 0] and S.rows[0] == 0
    assert torch.all(torch.isneginf(S.lf[:, gs.LF_GAIN]))
    assert torch.all(S.ri[:, gs.RI_FEAT] == -1)
    assert S.li[0, gs.LI_NROWS] == 777 and S.li[1:].sum() == -(S.L - 1)


# ---- planes ----------------------------------------------------------------

@pytest.mark.parametrize("small_l", [0, 1])
def test_planes_match_host_subtraction(small_l):
    c = random_case(30 + small_l)
    S = c["S"]
    gs.pick(S, c["feat"], c["k"])
    S.scal[gs.S_SMALL_L] = small_l
    l, s = int(S.st[gs.ST_LEAF]), int(S.st[gs.ST_S])
    gh, hh, small = c["gh"], c["hh"], c["small"]
    want_g, want_h = gh.clone(), hh.clone()
    big_g, big_h = want_g[l] - small[0], want_h[l] - small[1]
    if small_l:
        want_g[s], want_h[s] = big_g, big_h
        want_g[l], want_h[l] = small
    else:
        want_g[s], want_h[s] = small
        want_g[l], want_h[l] = big_g, big_h
    gs.planes(S, gh, hh, small)
    assert torch.equal(gh, want_g) and torch.equal(hh, want_h)


# ---- assemble --------------------------------------------------------------

def _host_assemble(c, out, mode, depths, max_depth):
    """scan_children's / _scan_blocks' post-processing of a scan output, on
    the host: the first maximum, then ops/grow.py:assemble."""
    o = out.numpy()
    B = o.shape[0]
    scal = c["S"].ps.numpy()[:B, :8]
    b = np.argmax(o[:, 0], axis=1)
    best = o[np.arange(B), :, b]
    if mode == gs.SCAN_PAIR:
        f, thr, fr = b, best[:, 1], c["forced_right"][b]
    else:
        Wp = c["Wp"]
        own = c["owner"].numpy().reshape(-1, Wp)
        t_abs = best[:, 1]
        f = own[b, np.clip(t_abs, 0, Wp - 1).astype(np.int64)]
        thr = t_abs - c["assets"].ls[f]
        fr = c["forced_right"][f]
    return assemble(best[:, 0], f, thr, best[:, 2] > 0.5, best[:, 3],
                    best[:, 4], best[:, 5], fr, scal,
                    c["params"].lambda_l2, depths, max_depth)


@pytest.mark.parametrize("mode", [gs.SCAN_PAIR, gs.SCAN_BLOCKS])
@pytest.mark.parametrize("seed", range(4))
def test_assemble_matches_host_assemble(mode, seed):
    c = random_case(40 + seed)
    S, k = c["S"], c["k"]
    gs.pick(S, c["feat"], k)
    S.st[gs.ST_NLEFT] = int(S.li[int(S.st[gs.ST_LEAF]), gs.LI_NROWS]) // 3
    gs.commit(S, k)
    out = c["out_pair"] if mode == gs.SCAN_PAIR else c["out_blocks"]
    if seed == 1:
        out[0, 0, 2] = np.inf                 # +inf: not a valid gain
    if seed == 2:                              # the children at max_depth
        S.li[S.rows, gs.LI_DEPTH] = k.max_depth
    if seed == 3:
        out[1, 0, 0] = np.nan                  # np.argmax takes a NaN
    rows = S.rows.tolist()
    depths = [int(S.li[r, gs.LI_DEPTH]) for r in rows]
    want = _host_assemble(c, out, mode, depths, k.max_depth)
    s = int(S.st[gs.ST_S])
    gs.assemble(S, out, mode, c["owner"], c["Wp"], c["feat"], k, True)
    assert int(S.st[gs.ST_S]) == s + 1
    got = _host_candidates(S, S.L)
    for r, w in zip(rows, want):
        g = got[r]
        for f in ("gain", "left_output", "right_output", "left_sum_grad",
                  "left_sum_hess", "right_sum_grad", "right_sum_hess"):
            a, b = F32(getattr(g, f)), F32(getattr(w, f))
            assert a.view(np.uint32) == b.view(np.uint32), f
        for f in ("feature", "threshold", "default_left", "left_count",
                  "right_count"):
            assert getattr(g, f) == getattr(w, f), f


# ---- the end of a tree -----------------------------------------------------

def test_cons_table_and_apply_scores_match_host():
    c = random_case(50)
    S = c["S"]
    s = int(S.st[gs.ST_S])
    li = S.li.numpy()
    gs.cons_table(S)
    odd = [(int(li[q, gs.LI_START]), int(li[q, gs.LI_NROWS]))
           for q in range(s) if li[q, gs.LI_DEPTH] % 2
           and li[q, gs.LI_NROWS] > 0]
    tab = S.tab.numpy()
    assert [tuple(r) for r in tab if r[1] > 0] == odd
    # the score update: the host loop's argsort and repeat_interleave
    score = c["score"].clone()
    order = np.argsort(li[:s, gs.LI_START], kind="stable")
    vals = (S.lf.numpy()[:s, gs.LF_VALUE] * F32(0.1)).astype(F32)[order]
    lane_val = torch.repeat_interleave(
        torch.as_tensor(vals), torch.as_tensor(li[:s, gs.LI_NROWS][order]))
    want = c["score"].clone()
    want[:len(lane_val)] += lane_val
    gs.apply_scores(S, score, 0.1)
    assert torch.equal(score, want)
    S.st[gs.ST_S] = 1                          # one leaf: nothing to add
    gs.apply_scores(S, score, 0.1)
    assert torch.equal(score, want)


def test_plain_steps_count_on_the_cpu():
    counters.reset("cpu")
    c = random_case(60)
    S = c["S"]
    gs.pick(S, c["feat"], c["k"])
    gs.commit(S, c["k"])
    S.st[gs.ST_DONE] = 1
    gs.planes(S, c["gh"], c["hh"], c["small"])     # done: not counted
    got = counters.read("cpu")
    assert got["grow_pick"] == got["grow_commit"] == 1
    assert got["grow_planes"] == 0


def test_state_reads_back_in_one_copy():
    S = gs.GrowState(15, "cpu")
    S.lf[3, gs.LF_VALUE] = 1.5
    S.ri[2, gs.RI_FEAT] = 7
    S.st[gs.ST_S] = 9
    h = S.read()
    assert h["lf"][3, gs.LF_VALUE] == F32(1.5)
    assert h["ri"][2, gs.RI_FEAT] == 7 and h["st"][0, gs.ST_S] == 9
    assert S.done.data_ptr() == S.st.data_ptr() + 8 * gs.ST_DONE
    assert S.child.data_ptr() == S.st.data_ptr() + 8 * gs.ST_CH_START
