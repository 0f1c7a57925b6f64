"""Random forest: the port against the JAX package on the CPU, on both
growers, and the model text of every boosting mode.

  * v1 grower (``tpu_persist_scan=false``, 8 rounds) against the JAX
    package's RF host path: binary at bagging_fraction 0.7 and
    bagging_freq 1, K = 3 softmax and L1 (its leaves renewed from the
    in-bag rows against the constant init score), and with a validation
    set, whose f64 averages are held after every iteration. The host path
    grows with the JAX v1 learner, which is not deterministic on the CPU
    (ROADMAP.md section C), so every v1 comparison takes
    tests/test_torch_dart.py's retry rule (:func:`against_jax`);
  * persistent grower (``force``) against the JAX package's fused RF
    driver with its Pallas kernels in interpret mode (its carry asserted
    live): the bags are the host's numpy draws on both, so the trees are
    the same, the counts within the slack of tests/test_torch_bag_train.py
    (the hessian-derived counts of both persistent growers, ROADMAP.md
    C10); the f32 training averages differ by the running average's
    rounding (below). With a validation set the port stays on the
    persistent grower and the JAX package takes its host path: the same
    bags, the counts within the hessian-derived counts' slack (ROADMAP.md
    C10);
  * the rows bag step (ops/bag.py's MODE_ROWS) against the JAX package's
    ``apply_row_weights`` and the running average
    (ops/grow_step.py:apply_avg_plain) against its ``apply_scores_avg``.
    The port computes ``(score * t + value) * inv`` with one rounding per
    operation (the kernel's contract, __fmul_rn / __fadd_rn); XLA on the
    CPU contracts ``score * t + value`` into one fused multiply-add. So the
    test holds each side to its own formula bit for bit, the two bit for
    bit where the product is exact in f32 (t = 0, 1, 2, 4), and within the
    product's rounding otherwise (ROADMAP.md C11);
  * trees compare as tests/test_torch_bag_train.py's bagged trees do
    (out-of-bag rows may reach other leaves where only they hold a bin,
    ROADMAP.md C5), each tree on its own;
  * the model text: the first line of every mode (``tree``, ``goss``,
    ``dart``, and ``tree`` for RF) as the JAX package writes it; RF's
    ``average_output`` read and predicted the same by both packages, each
    way;
  * the routes beyond the JAX fused RF gate (ROADMAP.md queue A, item 25):
    ``auto`` takes v1, ``force`` raises.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import lightgbm_tpu as lt
from lightgbm_tpu.treelearner.serial import SerialTreeLearner as JaxLearner
import lightgbm_torch as lp
from lightgbm_torch.ops import bag
from lightgbm_torch.ops import grow_step as gs
from lightgbm_torch.treelearner import serial
from lightgbm_torch.utils.log import LightGBMError
from test_torch_bag_train import COUNT_SLACK, record_bags
from test_torch_multiclass import BASE as MC_BASE, class_data, leaf_bounds
from test_torch_dart import against_jax
from test_torch_objectives_renew import reg_data

ROUNDS = 8
BASE = dict(MC_BASE, objective="binary", num_leaves=15, boosting="rf",
            bagging_fraction=0.7, bagging_freq=1)
F32 = np.float32


def train_jax(params, X, y, rounds=ROUNDS, pallas=False, monkeypatch=None,
              valid=None, fresh=False):
    if fresh:
        jax.clear_caches()
    if pallas:
        monkeypatch.setattr(JaxLearner, "_persist_kernel_mode",
                            staticmethod(lambda: ("pallas", True)))
    ds = lt.Dataset(X, y)
    sets = [] if valid is None else [lt.Dataset(*valid, reference=ds)]
    bj = lt.train(dict(params), ds, rounds, valid_sets=sets)
    persist = getattr(bj._booster.tree_learner, "_persist_carry", None)
    assert (persist is not None) == (params["tpu_persist_scan"] == "force"
                                     and valid is None)
    return bj


def train_port(params, X, y, rounds=ROUNDS, valid=None):
    p = dict(params, device_type="cpu")
    ds = lp.Dataset(X, y, params=p)
    sets = [] if valid is None else [lp.Dataset(*valid, reference=ds)]
    bp = lp.train(p, ds, rounds, valid_sets=sets)
    assert bp._booster.use_persist == (params["tpu_persist_scan"] == "force")
    return bp


def assert_same_rf(bj, bp, X, bags, K=1, mxu=False, slack=0):
    """Same trees (tests/test_torch_bag_train.py's rules at RF's learning
    rate of 1, each tree on its own: an RF tree does not depend on the
    trees before it): split features, children, counts (within `slack`),
    the leaf of every in-bag row (`bags`: record_bags), leaf values within
    the bounds; the raw predictions of the rows that reach the same leaf
    in every tree within the sum of the bounds over the iterations; the
    averaged model text."""
    ref, mine = bj._booster._used_models(), bp._booster.models
    assert len(ref) == len(mine) == len(bags)
    n = X.shape[0]
    bound = np.zeros((n, K))
    agree = np.ones(n, bool)
    for i, (a, b) in enumerate(zip(ref, mine)):
        assert a.num_leaves == b.num_leaves > 1, i
        k = a.num_leaves - 1
        for f in ("split_feature", "left_child", "right_child"):
            np.testing.assert_array_equal(getattr(a, f)[:k],
                                          getattr(b, f)[:k], "%s %d" % (f, i))
        for f, m in (("internal_count", k), ("leaf_count", k + 1)):
            d = np.abs(getattr(a, f)[:m].astype(np.int64) - getattr(b, f)[:m])
            assert d.max(initial=0) <= slack, (f, i, d)
        la, lb = a.predict_leaf(X), b.predict_leaf(X)
        np.testing.assert_array_equal(la[bags[i]], lb[bags[i]], i)
        agree &= la == lb
        lim = leaf_bounds(a, n, 1.0, mxu)
        assert np.all(np.abs(b.leaf_value[:k + 1] - a.leaf_value[:k + 1])
                      <= lim), i
        bound[:, i % K] += lim[la]
    assert agree.mean() > 0.99
    niter = len(ref) // K
    rj = bj.predict(X, raw_score=True).reshape(n, K)
    rp = bp.predict(X, raw_score=True).reshape(n, K)
    assert np.all(np.abs(rp - rj)[agree] <= bound[agree] / niter + 1e-12)
    for b in (bj, bp):
        lines = b.model_to_string().splitlines()
        assert lines[0] == "tree"
        obj = next(i for i, s in enumerate(lines)
                   if s.startswith("objective="))
        assert lines[obj + 1] == "average_output"


V1 = {"binary": ({}, 1, None), "multiclass": (
    {"objective": "multiclass", "num_class": 3}, 3, None),
    "l1": ({"objective": "regression_l1"}, 1, "regression_l1")}


@pytest.mark.parametrize("name", sorted(V1))
def test_v1_matches_jax_host_path(name, monkeypatch):
    extra, K, reg = V1[name]
    params = dict(BASE, tpu_persist_scan="false", **extra)
    if reg:
        X, y = reg_data(reg, n=3000)
    else:
        X, y = class_data(n=3000, K=max(K, 2), seed=4)
    n = len(y)
    bags = record_bags(monkeypatch, False, n)
    bp = train_port(params, X, y)
    assert len(bp._booster.models) == ROUNDS * K
    roots = [t.internal_count[0] for t in bp._booster.models]
    assert roots == [int(m.sum()) for m in bags]
    assert max(roots) < n and len(set(roots)) > 1

    def check(bj):
        assert_same_rf(bj, bp, X, bags, K)
        if reg:
            # renewed against the constant: the in-bag residual medians
            for a, b in zip(bj._booster._used_models(), bp._booster.models):
                np.testing.assert_array_equal(a.leaf_value[:a.num_leaves],
                                              b.leaf_value[:b.num_leaves])
    against_jax(check, lambda: train_jax(params, X, y, fresh=True), X)


def _valid_split(n=3500, m=500, seed=6):
    X, y = class_data(n=n, K=2, seed=seed)
    return X[:n - m], y[:n - m], X[n - m:], y[n - m:]


def _valid_run(lib, params, Xt, yt, Xv, yv):
    """A Booster of `lib` with the held-out set, trained ROUNDS updates;
    ``b.steps`` holds each iteration's validation scores."""
    if lib is lt:
        jax.clear_caches()
        ds = lt.Dataset(Xt, yt)
        b = lt.Booster(dict(params), ds)
        b.add_valid(lt.Dataset(Xv, yv, reference=ds), "v")
    else:
        p = dict(params, device_type="cpu")
        ds = lp.Dataset(Xt, yt, params=p)
        b = lp.Booster(p, ds)
        b.add_valid(lp.Dataset(Xv, yv, reference=ds), "v")
    b.steps = []
    for _ in range(ROUNDS):
        b.update()
        vs = b._booster.valid_score[0]
        b.steps.append(np.array(vs.score_host()).reshape(-1) if lib is lt
                       else vs.score.numpy().copy())
    return b


def test_v1_valid_scores_match_jax(monkeypatch):
    """The f64 validation averages after every iteration: the port's equal
    to its own prediction, and to the JAX package's within 1e-6 (the
    trees' leaf values within their bounds, averaged)."""
    bags = record_bags(monkeypatch, False, 3000)
    params = dict(BASE, tpu_persist_scan="false", metric="binary_logloss")
    Xt, yt, Xv, yv = _valid_split()
    bp = _valid_run(lp, params, Xt, yt, Xv, yv)
    np.testing.assert_allclose(bp.steps[-1], bp.predict(Xv, raw_score=True),
                               rtol=0, atol=1e-12)

    def check(bj):
        for it, (sj, sp) in enumerate(zip(bj.steps, bp.steps)):
            np.testing.assert_allclose(sp, sj, rtol=0, atol=1e-6,
                                       err_msg=str(it))
        assert_same_rf(bj, bp, Xt, bags)
    against_jax(check, lambda: _valid_run(lt, params, Xt, yt, Xv, yv), Xt)


def test_persist_matches_jax_fused_rf(monkeypatch):
    params = dict(BASE, tpu_persist_scan="force")
    X, y = class_data(n=3000, K=2, seed=7)
    bj = train_jax(params, X, y, pallas=True, monkeypatch=monkeypatch)
    bags = record_bags(monkeypatch, True, len(y))
    bp = train_port(params, X, y)
    gr = bp._booster.tree_learner._persist_gr
    assert gr.k.bagged == 1 and gr._bag_mode == bag.MODE_ROWS
    assert_same_rf(bj, bp, X, bags, mxu=True, slack=COUNT_SLACK)
    # the f32 averages: each iteration's two roundings (JAX: one FMA and
    # one multiply) on values below max|raw|
    sj = np.asarray(bj._booster.tree_learner.persist_finalize_scores())
    sp = bp._booster.train_score.score.numpy()
    raw = bp.predict(X, raw_score=True)
    tol = 3 * ROUNDS * np.finfo(F32).eps * np.abs(raw).max()
    assert np.abs(sp - sj).max() <= tol
    assert np.abs(sp - raw).max() <= tol


def test_persist_with_valid_set_matches_jax_host_path(monkeypatch):
    """The port keeps RF on the persistent grower with a validation set;
    the JAX package takes its host path (ROADMAP.md C9): the same bags, so
    the same trees up to the hessian-derived counts (C10)."""
    params = dict(BASE, tpu_persist_scan="force", metric="binary_logloss")
    Xt, yt, Xv, yv = _valid_split(3500, 500, 8)
    bj = train_jax(params, Xt, yt, valid=(Xv, yv))
    bags = record_bags(monkeypatch, True, len(yt))
    bp = train_port(params, Xt, yt, valid=(Xv, yv))
    assert len(bags) == ROUNDS
    for i, m in enumerate(bags):
        assert bp._booster.models[i].internal_count[0] == int(m.sum())
    assert_same_rf(bj, bp, Xt, bags, slack=COUNT_SLACK)
    sp = bp._booster.valid_score[0].score.numpy()
    np.testing.assert_allclose(sp, bp.predict(Xv, raw_score=True), rtol=0,
                               atol=1e-12)


# ---- the plain forms against the JAX package's functions -------------------

@pytest.fixture(scope="module")
def jax_rf_grower():
    """A JAX fused-RF grower, its payload after one iteration, n, nbw."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(JaxLearner, "_persist_kernel_mode",
                   staticmethod(lambda: ("pallas", True)))
        params = dict(BASE, num_leaves=7, tpu_persist_scan="force")
        X, y = class_data(n=2000, K=2, seed=9)
        bj = lt.train(dict(params), lt.Dataset(X, y), 1)
    learner = bj._booster.tree_learner
    gr = learner._persist_gr
    return gr, np.asarray(learner._persist_carry).copy(), gr.n, gr.nbw


def test_rows_bag_matches_apply_row_weights(jax_rf_grower):
    """MODE_ROWS on the payload's lanes (permuted row ids as a grown tree
    leaves them): grad and hess times the row's mask, -0.0 where a
    negative value meets 0, and the in-bag count, bit for bit."""
    gr, pay, n, nbw = jax_rf_grower
    rng = np.random.default_rng(3)
    pay = pay.copy()
    g = rng.normal(size=n).astype(F32)
    h = rng.uniform(0.01, 0.25, n).astype(F32)
    g[:4] = [-0.0, 0.0, -1.5, 2.0]
    pay[nbw + 2, :n] = g.view(np.uint32)
    pay[nbw + 3, :n] = h.view(np.uint32)
    mask = rng.random(n) < 0.7
    rid = pay[nbw + 1, :n].astype(np.int64)
    mask[rid[:3]] = False              # lane 2: -1.5 * 0 = -0.0
    want, cnt = gr.apply_row_weights(jnp.asarray(pay),
                                     jnp.asarray(mask.astype(F32)))
    want = np.asarray(want)
    st = bag.BagState("cpu")
    st.set(bag.rows_iteration(0, mask))
    t = torch.as_tensor(pay.view(np.int32)).clone()
    gv, hv = t[nbw + 2].view(torch.float32), t[nbw + 3].view(torch.float32)
    bag.bag_apply(t[nbw + 1], t[nbw].view(torch.float32), gv, hv, n,
                  bag.MODE_ROWS, st)
    got = t.numpy().view(np.uint32)
    np.testing.assert_array_equal(got[nbw + 2:nbw + 4, :n],
                                  want[nbw + 2:nbw + 4, :n])
    assert np.signbit(gv[2].item()) and gv[2].item() == 0.0
    assert int(st.count[0]) == int(cnt) == int(mask.sum())


def _avg_case(gr, pay, n, nbw, L=7, seed=5):
    """A score row and a leaf table of L segments over the n lanes, with a
    -0.0 leaf value."""
    from lightgbm_tpu.ops import grow_persist as jgp
    rng = np.random.default_rng(seed)
    pay = pay.copy()
    sc = rng.normal(size=pay.shape[1]).astype(F32)
    pay[nbw + 4] = sc.view(np.uint32)
    cuts = np.sort(rng.choice(np.arange(1, n), L - 1, replace=False))
    starts = np.concatenate([[0], cuts])
    nrows = np.concatenate([cuts, [n]]) - starts
    vals = rng.normal(size=L).astype(F32)
    vals[2] = -0.0
    ls = np.zeros((L, 8), F32)
    ls[:, jgp.LS_START], ls[:, jgp.LS_NROWS] = starts, nrows
    ls[:, jgp.LS_VAL] = vals
    S = gs.GrowState(L, "cpu")
    S.li[:, gs.LI_START] = torch.as_tensor(starts)
    S.li[:, gs.LI_NROWS] = torch.as_tensor(nrows)
    S.lf[:, gs.LF_VALUE] = torch.as_tensor(vals)
    S.st[gs.ST_S] = L
    leaf = np.searchsorted(starts, np.arange(n), side="right") - 1
    return pay, sc[:n], ls, S, vals[leaf]


@pytest.mark.parametrize("t,bias", [(0.0, -0.3708601), (1.0, 0.25),
                                    (2.0, 0.0), (4.0, -1.25), (3.0, 0.5),
                                    (5.0, 0.0), (6.0, -0.3708601)])
def test_average_matches_apply_scores_avg(jax_rf_grower, t, bias):
    gr, pay, n, nbw = jax_rf_grower
    pay, sc, ls, S, v = _avg_case(gr, pay, n, nbw)
    ft, inv = F32(t), F32(1.0 / (t + 1.0))
    if bias != 0.0:
        v = v + F32(bias)
    two = (sc * ft + v) * inv                   # one rounding per operation
    fma = (sc.astype(np.float64) * ft + v).astype(F32) * inv
    got = torch.as_tensor(sc.copy())
    gs.set_avg(S, t, bias)
    gs.apply_scores_avg(S, got)
    got = got.numpy()
    np.testing.assert_array_equal(got.view(np.uint32), two.view(np.uint32))
    out = jax.jit(gr.apply_scores_avg)(
        jnp.asarray(pay), jnp.asarray(ls), jnp.int32(len(ls)),
        jnp.float64(t), jnp.float64(1.0 / (t + 1.0)), jnp.float64(bias))
    ref = np.asarray(out)[nbw + 4, :n].view(F32)
    np.testing.assert_array_equal(ref.view(np.uint32), fma.view(np.uint32))
    if t in (0.0, 1.0, 2.0, 4.0):
        np.testing.assert_array_equal(got.view(np.uint32),
                                      ref.view(np.uint32))
    else:
        # |two - fma| <= (the product's rounding + the sum's) * inv + the
        # last rounding
        prod = np.spacing(np.abs(sc * ft)).astype(np.float64)
        tot = np.spacing(np.abs(sc * ft + v)).astype(np.float64)
        assert np.all(np.abs(got.astype(np.float64) - ref)
                      <= (0.5 * prod + tot) * inv + np.spacing(np.abs(ref)))


def test_average_leaves_one_leaf_tree_alone(jax_rf_grower):
    gr, pay, n, nbw = jax_rf_grower
    pay, sc, ls, S, v = _avg_case(gr, pay, n, nbw)
    S.st[gs.ST_S] = 1
    got = torch.as_tensor(sc.copy())
    gs.set_avg(S, 3.0, 0.5)
    gs.apply_scores_avg(S, got)
    np.testing.assert_array_equal(got.numpy(), sc)
    out = gr.apply_scores_avg(jnp.asarray(pay), jnp.asarray(ls),
                              jnp.int32(1), jnp.float64(3.0),
                              jnp.float64(0.25), jnp.float64(0.5))
    np.testing.assert_array_equal(np.asarray(out)[nbw + 4, :n].view(F32), sc)


# ---- model text -------------------------------------------------------------

MODES = {"gbdt": {}, "goss": {"boosting": "goss"},
         "dart": {"boosting": "dart"},
         "rf": {"boosting": "rf", "bagging_fraction": 0.7,
                "bagging_freq": 1}}


@pytest.mark.parametrize("mode", sorted(MODES))
def test_model_text_first_line_matches_jax(mode):
    params = dict(MC_BASE, objective="binary", num_leaves=7,
                  tpu_persist_scan="false", **MODES[mode])
    X, y = class_data(n=1000, K=2, seed=2)
    first = [b.model_to_string().splitlines()[0] for b in (
        lt.train(dict(params), lt.Dataset(X, y), 2),
        lp.train(dict(params, device_type="cpu"),
                 lp.Dataset(X, y, params=params), 2))]
    assert first[0] == first[1] == {"goss": "goss", "dart": "dart"}.get(
        mode, "tree")


def test_average_output_text_both_ways():
    """A JAX RF model read by the port, and a port RF model read by the
    JAX package: the same raw and converted predictions."""
    params = dict(BASE, tpu_persist_scan="false")
    X, y = class_data(n=2000, K=2, seed=3)
    bj = lt.train(dict(params), lt.Dataset(X, y), 5)
    bp = train_port(params, X, y, 5)
    for src, reader in ((bj, lp.Booster), (bp, lt.Booster)):
        text = src.model_to_string()
        assert "\naverage_output\n" in text
        other = reader(model_str=text, params={"device_type": "cpu"})
        for raw in (True, False):
            np.testing.assert_array_equal(other.predict(X, raw_score=raw),
                                          src.predict(X, raw_score=raw))
    # the average: the trees' sum over the iterations
    trees = lp.Booster(model_str=bp.model_to_string())._booster.models
    np.testing.assert_array_equal(
        bp.predict(X, raw_score=True),
        sum(t.predict(X) for t in trees) / len(trees))


# ---- routing (ROADMAP.md queue A, item 25) ---------------------------------

BEYOND = {
    "multiclass": ({"objective": "multiclass", "num_class": 3}, None),
    "init score": ({}, "init"),
    "row gradient mode": ({"objective": "cross_entropy"}, None),
}


def _booster(extra, init, opt):
    X, y = class_data(n=800, K=extra.get("num_class", 2), seed=2)
    p = dict(BASE, device_type="cpu", tpu_persist_scan=opt, **extra)
    ds = lp.Dataset(X, y, params=p,
                    init_score=np.full(len(y), 0.1) if init else None)
    return lp.Booster(p, ds)


@pytest.mark.parametrize("name", sorted(BEYOND))
def test_beyond_the_fused_rf_gate(name, monkeypatch):
    """``auto`` on the card takes v1; ``force`` raises naming item 25."""
    extra, init = BEYOND[name]
    gb = _booster(extra, init, "false")._booster
    learner = gb.tree_learner
    learner.config.tpu_persist_scan = "auto"
    monkeypatch.setattr(serial, "PARTITION_MIN_ROWS", 0)
    monkeypatch.setattr(learner, "device", torch.device("cuda"))
    assert not learner.can_persist_scan(gb.objective)
    with pytest.raises(LightGBMError, match="ROADMAP.md queue A, item 25"):
        _booster(extra, init, "force")


def test_binary_rf_takes_the_persistent_grower_under_auto(monkeypatch):
    gb = _booster({}, None, "false")._booster
    learner = gb.tree_learner
    learner.config.tpu_persist_scan = "auto"
    monkeypatch.setattr(serial, "PARTITION_MIN_ROWS", 0)
    monkeypatch.setattr(learner, "device", torch.device("cuda"))
    assert learner.can_persist_scan(gb.objective)
