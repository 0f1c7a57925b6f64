"""The persistent grower's device loop on the card: the grow_step kernels,
the device forms of split_pass, seg_hist, scan_pair and scan_blocks, and
one tree replayed from a CUDA graph, each against its plain or eager
counterpart, bit for bit.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_grow_step_cuda.py

Without a card each test skips. The step inputs are
tests/test_torch_step_cases.py's random mid-tree states (-inf gains, ties
across leaves and features, +inf and NaN scan gains, children at
max_depth, zero hessians, forced_right features); the device forms run at
the grower's shapes (28 groups, a payload and its second buffer) and the
edge shapes: a zero-length segment, one lane, the done flag set (nothing
written), and the buffer parity flag (the partition from the second
buffer into the payload).
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.ops import counters
from lightgbm_torch.ops import grow_step as gs
from lightgbm_torch.ops import payload_kernels as pk
from test_torch_step_cases import (assert_same_state, on, random_case,
                                   state_arrays)

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def _steps(c, mode):
    """One whole step sequence on the case's state: pick, commit (n_left a
    third of the leaf), planes, assemble."""
    S, k = c["S"], c["k"]
    gs.pick(S, c["feat"], k)
    l = S.st[gs.ST_LEAF:gs.ST_LEAF + 1]
    S.st[gs.ST_NLEFT:gs.ST_NLEFT + 1] = S.li[l, gs.LI_NROWS] // 3
    gs.commit(S, k)
    gs.planes(S, c["gh"], c["hh"], c["small"])
    out = c["out_pair"] if mode == gs.SCAN_PAIR else c["out_blocks"]
    gs.assemble(S, out, mode, c["owner"], c["Wp"], c["feat"], k, True)


@pytest.mark.parametrize("mode", [gs.SCAN_PAIR, gs.SCAN_BLOCKS])
@pytest.mark.parametrize("seed", range(5))
def test_grow_steps_match_plain(mode, seed):
    _card()
    c = random_case(seed, L=255, F=28, n=1_000_000, Fp=32, G=28, Gp=32,
                    Wp=256)
    if seed == 3:
        c["out_pair"][0, 0, 5] = float("inf")
        c["out_blocks"][1, 0, 2] = float("nan")
    d = on(c, "cuda")
    _steps(c, mode)
    _steps(d, mode)
    torch.cuda.synchronize()
    assert_same_state(state_arrays(c["S"]), state_arrays(d["S"]))
    assert torch.equal(c["gh"], d["gh"].cpu())
    assert torch.equal(c["hh"], d["hh"].cpu())
    for S in (c["S"], d["S"]):
        gs.cons_table(S)
    score_c, score_d = c["score"], d["score"]
    gs.apply_scores(c["S"], score_c, 0.1)
    gs.apply_scores(d["S"], score_d, 0.1)
    assert torch.equal(c["S"].tab, d["S"].tab.cpu())
    assert torch.equal(score_c, score_d.cpu())


def test_grow_steps_do_nothing_when_done():
    _card()
    c = on(random_case(7, L=63), "cuda")
    S = c["S"]
    S.st[gs.ST_DONE] = 1
    before = state_arrays(S)
    gh0, hh0 = c["gh"].clone(), c["hh"].clone()
    counters.reset("cuda")
    _steps(c, gs.SCAN_PAIR)
    torch.cuda.synchronize()
    after = state_arrays(S)
    # _steps wrote n_left itself; the kernels wrote nothing
    after["st"][0, gs.ST_NLEFT] = before["st"][0, gs.ST_NLEFT]
    assert_same_state(before, after)
    assert torch.equal(gh0, c["gh"]) and torch.equal(hh0, c["hh"])
    got = counters.read("cuda")
    assert all(got[k] == 0 for k in ("grow_pick", "grow_commit",
                                     "grow_planes", "grow_assemble"))


# ---- the device forms at the grower's shapes ------------------------------

WIDTHS = [255] * 28


def _payload(n, seed):
    """A random [16, NP] payload of 28 byte groups (7 bin words), grad and
    hess rows, and a [12, NP] second buffer of random words."""
    rng = np.random.default_rng(seed)
    NP = n + 4096
    pay = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, (16, NP),
                                       dtype=np.int64).astype(np.int32))
    pay[9] = torch.as_tensor(rng.normal(size=NP).astype(np.float32)) \
        .view(torch.int32)
    pay[10] = torch.as_tensor(rng.uniform(0.05, 0.25, NP).astype(
        np.float32)).view(torch.int32)
    second = torch.as_tensor(rng.integers(0, 2 ** 31 - 1, (12, NP),
                                          dtype=np.int64).astype(np.int32))
    second[9:11] = torch.as_tensor(rng.uniform(-1, 1, (2, NP)).astype(
        np.float32)).view(torch.int32)
    plan = pk.plan_tensor([(g // 4, (g % 4) * 8, 255) for g in range(28)],
                          "cpu")
    return pay, second, plan, 7, 12


def _scal(s0, n_l, g, seed):
    rng = np.random.default_rng(seed)
    sc = [0] * pk.N_SCALARS
    sc[pk.S_S0], sc[pk.S_NL] = s0, n_l
    sc[pk.S_WG], sc[pk.S_SH], sc[pk.S_MASK] = g // 4, (g % 4) * 8, 255
    sc[pk.S_NB], sc[pk.S_MT], sc[pk.S_DB] = 255, int(rng.integers(0, 3)), 3
    sc[pk.S_THR], sc[pk.S_DL] = int(rng.integers(0, 255)), int(seed % 2)
    sc[pk.S_SMALL_L] = int((seed // 2) % 2)
    sc[pk.S_LS], sc[pk.S_LE], sc[pk.S_MF] = 0, 255, 2
    return sc


SEGMENTS = [(777, 250_001), (5, 0), (13, 1), (1029, 1025), (3, 16_385)]


@pytest.mark.parametrize("swap", [0, 1])
@pytest.mark.parametrize("s0,n_l", SEGMENTS)
def test_split_pass_and_seg_hist_device_forms(s0, n_l, swap):
    _card()
    pay, second, plan, nbw, wp_live = _payload(300_000, s0 + n_l)
    sc = _scal(s0, n_l, (s0 + n_l) % 28, s0)
    # the host form on the CPU, from the leaf's buffer into the other one
    src_c, dst_c = (second, pay) if swap else (pay, second)
    dst_ref = dst_c.clone()
    n_ref, h_ref = pk.split_pass(src_c, dst_ref, sc, plan, nbw, wp_live,
                                 True)
    child = pk._child(sc, n_ref)
    seg_ref = pk.seg_hist(dst_ref, plan, nbw, *child)
    # the device form on the card, the buffers picked by the parity flag
    p_d, s_d, plan_d = pay.cuda(), second.cuda(), plan.cuda()
    scal = torch.tensor(sc + [0], dtype=torch.int32, device="cuda")
    res = torch.full((3,), -7, dtype=torch.int64, device="cuda")
    flag = torch.tensor([swap], dtype=torch.int64, device="cuda")
    done = torch.zeros(1, dtype=torch.int64, device="cuda")
    hist = pk.hist_scratch(s_d, 28, n_l)
    counters.reset("cuda")
    pk.split_pass_device(p_d, s_d, scal, res, plan_d, nbw, wp_live, hist,
                         done=done, swap=flag)
    seg_out = pk.hist_scratch(s_d, 28, n_l)
    pk.seg_hist_device(s_d, plan_d, nbw, res[1:], *seg_out, done=done,
                       alt=p_d, swap=flag)
    torch.cuda.synchronize()
    assert res.tolist() == [n_ref, *child]
    dst_d = p_d if swap else s_d
    assert torch.equal(dst_d.cpu(), dst_ref)
    assert torch.equal((s_d if swap else p_d).cpu(), src_c)
    assert torch.equal(hist[0].cpu(), torch.stack(h_ref))
    assert torch.equal(seg_out[0].cpu(), torch.stack(seg_ref))
    got = counters.read("cuda")
    assert got["split_pass"] == 1 and got["seg_hist"] == 1
    # the done flag set: nothing is written, nothing counted
    done.fill_(1)
    before = (p_d.clone(), s_d.clone(), res.clone(), hist[0].clone(),
              seg_out[0].clone())
    pk.split_pass_device(p_d, s_d, scal, res, plan_d, nbw, wp_live, hist,
                         done=done, swap=flag)
    pk.seg_hist_device(s_d, plan_d, nbw, res[1:], *seg_out, done=done,
                       alt=p_d, swap=flag)
    torch.cuda.synchronize()
    for a, b in zip(before, (p_d, s_d, res, hist[0], seg_out[0])):
        assert torch.equal(a, b)
    assert counters.read("cuda") == got


def test_scans_and_consolidation_device_forms():
    _card()
    from test_torch_scan_rows import block_case, pair_args, pair_case
    from lightgbm_torch.ops.block_scan import scan_blocks
    from lightgbm_torch.ops.scan import scan_pair
    c = pair_case(102, 2, 256)
    args = [a.cuda() if torch.is_tensor(a) else a for a in pair_args(c)]
    rows, gidx = c["rows"].cuda(), c["gidx"].cuda()
    want = scan_pair(*pair_args(c), rows=c["rows"], gidx=c["gidx"])
    out = torch.full((2, 8, want.shape[2]), 5.0, device="cuda")
    done = torch.zeros(1, dtype=torch.int64, device="cuda")
    scan_pair(*args, rows=rows, gidx=gidx, out=out, done=done)
    assert torch.equal(out.cpu(), want)
    done.fill_(1)
    out.fill_(5.0)
    scan_pair(*args, rows=rows, gidx=gidx, out=out, done=done)
    assert torch.all(out == 5.0)
    b = block_case(202, 2, 256)
    keys = ("scal", "gh", "hh", "masks")
    want = scan_blocks(*[b[k] for k in keys], b["do_fix"], b["rows"], b["G"])
    out = torch.full(tuple(want.shape), 5.0, device="cuda")
    for flag in (0, 1):
        done.fill_(flag)
        scan_blocks(*[b[k].cuda() for k in keys], b["do_fix"],
                    b["rows"].cuda(), b["G"], out=out, done=done)
        assert torch.equal(out.cpu(), want if flag == 0
                           else torch.full_like(want, 5.0))
        out.fill_(5.0)
    # consolidation from a device table, zero-length entries skipped
    pay, second, _, _, wp_live = _payload(100_000, 3)
    tab = torch.tensor([[5, 1000], [2000, 0], [3000, 70_001], [90_000, 1]])
    dst_c = pay.clone()
    pk.consolidate_device(second, dst_c, tab, wp_live)
    dst_d = pay.cuda()
    counters.reset("cuda")
    pk.consolidate_device(second.cuda(), dst_d, tab.cuda(), wp_live)
    assert torch.equal(dst_d.cpu(), dst_c)
    assert counters.read("cuda")["consolidate"] == 1
    pk.consolidate_device(second.cuda(), dst_d, torch.zeros(
        (5, 2), dtype=torch.int64, device="cuda"), wp_live)
    assert counters.read("cuda")["consolidate"] == 1


# ---- one tree from a CUDA graph ------------------------------------------

@pytest.mark.parametrize("leaves,feats,fraction",
                         [(63, 6, 1.0), (31, 24, 1.0), (63, 12, 0.5)])
def test_graph_replay_matches_eager_training(leaves, feats, fraction):
    """Iteration 1 runs eagerly under set_sync_debug_mode("error"), 2 is
    captured and replayed, 3-4 are replays: the same trees, bit for bit, as
    every iteration run eagerly on the card and as the CPU's. With
    feature_fraction < 1 each tree's mask reaches the replayed graph
    through the scan layout's static buffers."""
    _card()
    X, y = make_higgs_like(70_000, seed=8)
    X = X[:, :feats].copy()
    p = {"objective": "binary", "num_leaves": leaves, "max_bin": 63,
         "verbosity": -1, "tpu_persist_scan": "force",
         "feature_fraction": fraction}
    text = {}
    for how in ("graph", "eager", "cpu"):
        q = dict(p, device_type="cpu" if how == "cpu" else "cuda")
        bst = lp.Booster(q, lp.Dataset(X, y, params=q))
        gr = bst._booster.tree_learner._persist_grower()
        gr.capture = how != "eager"
        counters.reset(gr.device)
        for _ in range(4):
            bst.update()
        text[how] = bst.model_to_string().split("parameters:")[0]
        if how == "graph":
            assert gr._graph is not None and gr.graph_stats["nodes"] > 0
        splits = sum(t.num_leaves - 1 for t in bst._booster.models)
        got = gr.device_counts
        assert got["grow_commit"] == got["split_pass"] == splits
        assert got["grow_root"] == 4 and got["apply_scores"] == 4
    assert text["graph"] == text["eager"] == text["cpu"]
