"""Learning to rank in the port against the JAX package, on the CPU.

Inputs are drawn with numpy from a seed: variable-length queries (one-
document queries, queries whose labels are all 0), tied scores and -0.0
scores.

  * Query groups: ``Metadata.set_query`` (sizes or boundaries), its error,
    ``num_queries`` and ``query_weights``: equal to the JAX package's.
  * The DCG helpers (metrics/dcg.py) and each query's max DCG: equal.
  * LambdaRank's (grad, hess): the port's plain version against the JAX
    ``grad_fn`` (f64 on the CPU, then f32): equal or at most 1 f32 ulp
    apart, with at most 1 in 1000 values unequal (both compute the same
    f64 operations; XLA's and torch's exp and log2 may round the last f64
    bit differently), with norm on and off, sigmoid 1 and 2, a custom
    label_gain, truncation level 3, weights.
  * The persistent grower's gradients (its "row" mode on a shuffled lane
    order) against the JAX package's "pos" mode (``payload_pos_fn``) on
    the same f32 lane scores, by the same bound.
  * XE-NDCG: the LCG draws bit-equal to the JAX package's over three
    iterations; (grad, hess) within 1 f32 ulp of the JAX ``grad_fn`` given
    the same draws.
  * ndcg@k and map@k: within 1e-12 relative of the JAX metrics' ``eval``.
  * Training against the JAX ``train()``: lambdarank on v1 and on the
    persistent grower (``force``; the JAX persistent path in Pallas
    interpret mode, 16 rounds), rank_xendcg on v1: equal tree structure and
    row partition, leaves and raw scores within the multiclass parity
    file's bounds (tests/test_torch_multiclass.py:assert_same_models).
    A run with a validation set takes the JAX per-class path, which is not
    deterministic on the CPU: compared with ``against_jax``
    (tests/test_torch_objectives_renew.py).
  * Validation and early stopping on ndcg: every record within 1e-12 of
    the JAX metric of the port's own predictions, and the JAX run's
    best_iteration.
  * Model text round trips between the packages with equal predictions.
  * Refusals: rank_xendcg with ``tpu_persist_scan=force``, ranking without
    groups, group sizes that do not add up.
"""
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
import lightgbm_torch as lp
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMeta
from lightgbm_tpu.metrics import create_metric as jmetric
from lightgbm_tpu.metrics import dcg as jdcg
from lightgbm_tpu.objectives import create_objective as jobjective
from lightgbm_torch.config import Config as PConfig
from lightgbm_torch.data.dataset import Metadata as PMeta
from lightgbm_torch.data.synth import make_ltr_like
from lightgbm_torch.metrics import create_metric as pmetric
from lightgbm_torch.metrics import dcg as pdcg
from lightgbm_torch.objectives import create_objective as pobjective
from lightgbm_torch.utils.log import LightGBMError
from test_torch_multiclass import JaxLearner, assert_same_models
from test_torch_objectives_renew import against_jax

BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 20,
        "learning_rate": 0.1, "min_gain_to_split": 1e-3, "verbosity": -1}


def query_sizes(n, seed, longest=80):
    """Seeded query sizes in [1, longest) adding up to n, with a few
    one-document queries first."""
    rng = np.random.default_rng(seed)
    sizes = [1, 1, 2]
    while sum(sizes) < n:
        sizes.append(min(int(rng.integers(1, longest)), n - sum(sizes)))
    return np.asarray(sizes)


def rank_data(n=3000, seed=3, f=24, noise=0.0):
    """make_ltr_like rows cut into variable-length queries, two of them
    with all labels 0; with `noise`, that share of the labels redrawn."""
    X, y, _ = make_ltr_like(n, n_feat=f, docs_per_query=50, seed=seed)
    g = query_sizes(len(y), seed)
    qb = np.concatenate([[0], np.cumsum(g)])
    y = y.copy()
    y[qb[4]:qb[5]] = 0.0
    y[qb[9]:qb[10]] = 0.0
    if noise:
        rng = np.random.default_rng(seed + 1)
        flip = rng.random(len(y)) < noise
        y[flip] = rng.integers(0, 5, int(flip.sum()))
    return X, y, g


def grad_inputs(seed=0):
    """Labels, weights, f64 scores with ties and -0.0, and boundaries."""
    rng = np.random.default_rng(seed)
    sizes = np.concatenate([[1, 1, 2, 3], rng.integers(1, 60, 60), [200]])
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)
    n = int(qb[-1])
    label = rng.integers(0, 5, n).astype(np.float32)
    label[qb[5]:qb[6]] = 0.0
    label[qb[7]:qb[8]] = 0.0
    score = np.round(rng.normal(size=n) * 2, 1)
    score[:50] = 0.0
    score[10:20] = -0.0
    weight = rng.uniform(0.5, 2.0, n).astype(np.float32)
    return label, weight, score, qb


def _pair(name, label, weight, qb, extra=None):
    params = dict({"objective": name}, **(extra or {}))
    md = SimpleNamespace(label=label, weight=weight, init_score=None,
                         query_boundaries=qb, num_queries=len(qb) - 1)
    jc, pc = lt.Config(params), lp.Config(params)
    jo = jobjective(jc.objective, jc)
    po = pobjective(pc.objective, pc)
    jo.init(md, len(label))
    po.init(md, len(label))
    return jo, po


def assert_f32_close(a, b, what):
    """Equal, or 1 f32 ulp apart in at most 1 of 1000 values."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    ne = a != b
    assert ne.sum() <= max(1, a.size // 1000), (what, int(ne.sum()))
    ulp = np.spacing(np.maximum(np.abs(a), np.abs(b)))
    assert np.all(np.abs(a - b) <= ulp), what


# ---- query groups and DCG helpers ------------------------------------------

@pytest.mark.parametrize("weighted", [False, True])
def test_query_metadata_matches_jax(weighted):
    sizes = query_sizes(500, 1)
    w = np.random.default_rng(2).uniform(0.5, 2, 500).astype(np.float32)
    for group in (sizes, np.concatenate([[0], np.cumsum(sizes)])):
        mj, mp = JMeta(500), PMeta(500)
        for m in (mj, mp):
            m.set_weight(w if weighted else None)
            m.set_query(group)
        np.testing.assert_array_equal(mp.query_boundaries,
                                      mj.query_boundaries)
        assert mp.query_boundaries.dtype == np.int32
        assert mp.num_queries == mj.num_queries == len(sizes)
        if weighted:
            np.testing.assert_array_equal(mp.query_weights, mj.query_weights)
        else:
            assert mp.query_weights is None and mj.query_weights is None
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        PMeta(500).set_query(sizes[:-1])


def test_dataset_groups():
    X, y, g = rank_data(600, 5)
    p = {"device_type": "cpu", "verbosity": -1}
    ds = lp.Dataset(X, y, group=g, params=p)
    assert ds.get_group() is g
    ds.construct()
    np.testing.assert_array_equal(ds.get_group(), g)
    gv = query_sizes(300, 6)
    dv = lp.Dataset(X[:300], y[:300], group=gv, reference=ds).construct()
    np.testing.assert_array_equal(dv.get_group(), gv)
    ds.set_group(np.concatenate([[0], np.cumsum(g[::-1])]))
    np.testing.assert_array_equal(ds.get_group(), g[::-1])
    with pytest.raises(LightGBMError, match="Sum of query counts"):
        lp.Dataset(X, y, group=g[1:], params=p).construct()


def test_dcg_helpers_match_jax():
    np.testing.assert_array_equal(pdcg._DISCOUNT_CACHE, jdcg._DISCOUNT_CACHE)
    np.testing.assert_array_equal(pdcg.default_label_gain(),
                                  jdcg.default_label_gain())
    np.testing.assert_array_equal(pdcg.default_label_gain(7),
                                  jdcg.default_label_gain(7))
    rng = np.random.default_rng(4)
    gain = pdcg.default_label_gain()
    custom = np.array([0.0, 1.5, 2.0, 9.0, 30.0])
    ks = [1, 2, 3, 5, 10, 40]
    for n in (1, 2, 7, 33, 120):
        lab = rng.integers(0, 5, n).astype(np.float32)
        sc = np.round(rng.normal(size=n), 1)
        sc[: n // 3] = 0.0
        sc[: n // 6] = -0.0
        for lg in (gain, custom):
            for k in (0, 1, 3, 20, 200):
                assert pdcg.cal_max_dcg_at_k(k, lab, lg) == \
                    jdcg.cal_max_dcg_at_k(k, lab, lg)
            assert pdcg.cal_max_dcg_at_ks(ks, lab, lg) == \
                jdcg.cal_max_dcg_at_ks(ks, lab, lg)
            assert pdcg.cal_dcg_at_ks(ks, lab, sc, lg) == \
                jdcg.cal_dcg_at_ks(ks, lab, sc, lg)
    for bad, match in (([0.5, 1.0], "int type"), ([-1.0, 1.0], "negative"),
                       ([40.0, 1.0], "not less than")):
        lab = np.asarray(bad, np.float32)
        for mod in (pdcg, jdcg):
            with pytest.raises(Exception, match=match):
                mod.check_label(lab, 32)


# ---- gradients -------------------------------------------------------------

LAMBDARANK_CASES = [
    ({}, False), ({}, True), ({"lambdarank_norm": False}, False),
    ({"lambdarank_norm": False}, True), ({"sigmoid": 2.0}, False),
    ({"sigmoid": 2.0, "lambdarank_norm": False}, True),
    ({"label_gain": [0, 1, 3, 7, 15, 40]}, False),
    ({"lambdarank_truncation_level": 3}, True)]


@pytest.mark.parametrize("extra,weighted", LAMBDARANK_CASES, ids=[
    "-".join(["%s%s" % kv for kv in e.items()] + ["w" if w else "u"])
    for e, w in LAMBDARANK_CASES])
def test_lambdarank_gradients_match_jax(extra, weighted):
    label, weight, score, qb = grad_inputs()
    jo, po = _pair("lambdarank", label, weight if weighted else None, qb,
                   extra)
    np.testing.assert_array_equal(po.inverse_max_dcgs, jo.inverse_max_dcgs)
    gj, hj = (np.asarray(a) for a in jo.get_gradients(jnp.asarray(score)))
    gp, hp = po.get_gradients(torch.as_tensor(score))
    assert gp.dtype == hp.dtype == torch.float32
    assert_f32_close(gp.numpy(), gj, "grad")
    assert_f32_close(hp.numpy(), hj, "hess")
    assert po.device_gradients()[0] == "row"
    assert jo.device_gradients()[0] == "pos"


def test_persist_row_mode_matches_jax_pos_mode():
    """The persistent grower's row mode on a shuffled lane order against
    the JAX package's pos mode on the same f32 lane scores."""
    X, y, g = rank_data(2000, 7)
    w = np.random.default_rng(8).uniform(0.5, 2, len(y)).astype(np.float32)
    p = dict(BASE, objective="lambdarank", tpu_persist_scan="force",
             device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, weight=w, group=g, params=p), 1)
    gr = bp._booster.tree_learner._persist_gr
    obj = bp._booster.objective
    n = gr.n
    rng = np.random.default_rng(9)
    pay = gr.init_carry(torch.as_tensor(rng.normal(size=n) * 2))
    perm = torch.as_tensor(rng.permutation(n))
    pay[:, :n] = pay[:, perm]
    gr.fill_grad_row(pay, obj.device_gradients()[1])
    gp, hp = pay[gr.nbw + 2:gr.nbw + 4, :n].view(torch.float32).numpy()
    jo, _ = _pair("lambdarank", y.astype(np.float32), w,
                  np.concatenate([[0], np.cumsum(g)]).astype(np.int32))
    lane_score = pay[gr.score_row, :n].view(torch.float32).numpy()
    rid = pay[gr.nbw + 1, :n].numpy()
    gj, hj = jo.payload_pos_fn()(jnp.asarray(lane_score), jnp.asarray(rid),
                                 jnp.ones(n, bool), *jo._pos_grad_args())
    assert_f32_close(gp, np.asarray(gj), "grad")
    assert_f32_close(hp, np.asarray(hj), "hess")


@pytest.mark.parametrize("weighted", [False, True])
def test_xendcg_draws_and_gradients_match_jax(weighted):
    label, weight, score, qb = grad_inputs(1)
    weight = weight if weighted else None
    jo, po = _pair("rank_xendcg", label, weight, qb)
    assert po.device_gradients() is None and jo.device_gradients() is None
    fn = jax.jit(jo.grad_fn())
    for _ in range(3):
        rp = po._next_floats()
        rj = jo._next_floats()
        np.testing.assert_array_equal(rp, rj)
        gj, hj = fn(jnp.asarray(score), jnp.asarray(label),
                    None if weight is None else jnp.asarray(weight),
                    jnp.asarray(jo._qid), jnp.asarray(jo._counts),
                    jnp.asarray(rj))
        from lightgbm_torch.ops.rank import xendcg_grad
        gp, hp = xendcg_grad(torch.as_tensor(score), torch.as_tensor(label),
                             torch.as_tensor(rp),
                             None if weight is None
                             else torch.as_tensor(weight),
                             po.plan("cpu"))
        assert_f32_close(gp.numpy(), np.asarray(gj), "grad")
        assert_f32_close(hp.numpy(), np.asarray(hj), "hess")
    # get_gradients advances the streams once per call
    x0 = po._lcg_x.copy()
    po.get_gradients(torch.as_tensor(score))
    jo._next_floats()
    np.testing.assert_array_equal(po._lcg_x, jo._lcg_x)
    assert not np.array_equal(po._lcg_x, x0)


# ---- metrics ---------------------------------------------------------------

def _metric_pair(name, label, weight, qb, params):
    md = SimpleNamespace(label=label, weight=weight,
                         query_boundaries=qb, num_queries=len(qb) - 1,
                         query_weights=None)
    jm_md = JMeta(len(label))
    jm_md.set_label(label)
    jm_md.set_weight(weight)
    jm_md.set_query(qb)
    md.query_weights = jm_md.query_weights
    jm = jmetric(name, JConfig(dict(params)))
    pm = pmetric(name, PConfig(dict(params)))
    jm.init(jm_md, len(label))
    pm.init(md, len(label))
    return jm, pm


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", ["ndcg", "map"])
def test_rank_metrics_match_jax(name, weighted):
    label, weight, score, qb = grad_inputs(2)
    params = {"eval_at": [1, 3, 5, 10, 100]}
    jm, pm = _metric_pair(name, label, weight if weighted else None, qb,
                          params)
    assert pm.names == jm.names
    assert pm.factor_to_bigger_better == jm.factor_to_bigger_better == 1.0
    for s in (score, np.zeros_like(score), -score):
        want = jm.eval(s, None)
        got = [float(v) for v in pm.eval(torch.as_tensor(s), None)]
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)
    if name == "ndcg":
        jm, pm = _metric_pair(name, label, None, qb,
                              {"label_gain": [0, 2, 3, 9, 11]})
        np.testing.assert_allclose(
            [float(v) for v in pm.eval(torch.as_tensor(score), None)],
            jm.eval(score, None), rtol=1e-12, atol=0)


# ---- training --------------------------------------------------------------

def _train_pair(params, X, y, g, rounds, pallas=False, weight=None):
    def train_jax():
        jax.clear_caches()
        mp = pytest.MonkeyPatch()
        if pallas:
            mp.setattr(JaxLearner, "_persist_kernel_mode",
                       staticmethod(lambda: ("pallas", True)))
        try:
            return lt.train(dict(params),
                            lt.Dataset(X, y, weight=weight, group=g), rounds)
        finally:
            mp.undo()
    p = dict(params, device_type="cpu")
    bp = lp.train(p, lp.Dataset(X, y, weight=weight, group=g, params=p),
                  rounds)
    return train_jax, bp


TRAIN_CASES = [("lambdarank", "off", 8, False),
               ("lambdarank", "off", 8, True),
               ("lambdarank", "force", 16, False),
               ("rank_xendcg", "off", 8, False),
               ("rank_xendcg", "off", 8, True)]


@pytest.mark.parametrize("objective,route,rounds,weighted", TRAIN_CASES,
                         ids=["%s-%s-%s" % (o, r, "w" if w else "u")
                              for o, r, _, w in TRAIN_CASES])
def test_training_matches_jax(objective, route, rounds, weighted):
    X, y, g = rank_data(2400 if route == "force" else 3000)
    w = (np.random.default_rng(5).uniform(0.5, 2, len(y)) if weighted
         else None)
    params = dict(BASE, objective=objective, tpu_persist_scan=route)
    pallas = route == "force"
    train_jax, bp = _train_pair(params, X, y, g, rounds, pallas, w)
    assert bp._booster.use_persist == pallas
    assert len(bp._booster.models) == rounds

    def check(bj):
        assert (getattr(bj._booster.tree_learner, "_persist_carry", None)
                is not None) == pallas
        assert_same_models(bj, bp, X, params["learning_rate"], 1,
                           mxu=pallas)
    against_jax(check, train_jax, X)


def _ndcg_of(label, qb, score, params):
    md = JMeta(len(label))
    md.set_label(label)
    md.set_query(qb)
    m = jmetric("ndcg", JConfig(dict(params)))
    m.init(md, len(label))
    return m.eval(score, None)


def test_early_stopping_on_ndcg_matches_jax():
    # one make_ltr_like draw cut by queries (another seed draws another
    # relevance function)
    Xa, ya, ga = rank_data(4500, 11, noise=0.5)
    q = int(np.searchsorted(np.cumsum(ga), 3000))
    m = int(ga[:q].sum())
    X, y, g, Xv, yv, gv = Xa[:m], ya[:m], ga[:q], Xa[m:], ya[m:], ga[q:]
    params = dict(BASE, objective="lambdarank", learning_rate=0.5,
                  eval_at=[3, 5], tpu_persist_scan="off")
    train_scores = []

    def keep(env):
        train_scores.append(
            env.model._booster.train_score.score.numpy().copy())

    def run(pkg, extra=None, callbacks=None):
        p = dict(params, **(extra or {}))
        ds = pkg.Dataset(X, y, group=g, params=p)
        dv = pkg.Dataset(Xv, yv, group=gv, reference=ds)
        rec = {}
        b = pkg.train(p, ds, 30, valid_sets=[ds, dv], evals_result=rec,
                      early_stopping_rounds=3, verbose_eval=False,
                      callbacks=callbacks)
        return b, rec

    bp, rec = run(lp, {"device_type": "cpu"}, [keep])
    n = len(rec["valid_1"]["ndcg@3"])
    assert 0 < bp.best_iteration < n < 30
    qb = np.concatenate([[0], np.cumsum(g)])
    qbv = np.concatenate([[0], np.cumsum(gv)])
    for i in range(1, n + 1):
        raw = bp.predict(Xv, raw_score=True, num_iteration=i)
        for name, lab, q, sc in (("valid_1", yv, qbv, raw),
                                 ("training", y, qb, train_scores[i - 1])):
            want = _ndcg_of(lab, q, sc, params)
            got = [rec[name]["ndcg@3"][i - 1], rec[name]["ndcg@5"][i - 1]]
            np.testing.assert_allclose(got, want, rtol=1e-12, atol=0)

    def check(bj):
        assert bj.best_iteration == bp.best_iteration
        assert_same_models(bj, bp, X, params["learning_rate"], 1)

    def train_jax():
        jax.clear_caches()
        return run(lt)[0]
    against_jax(check, train_jax, X)


def test_model_text_round_trips():
    X, y, g = rank_data(2000, 13)
    params = dict(BASE, objective="lambdarank", tpu_persist_scan="off")
    train_jax, bp = _train_pair(params, X, y, g, 4)
    bj = train_jax()
    for src, dst in ((bp, lt), (bj, lp)):
        b = dst.Booster(model_str=src.model_to_string(),
                        params={"device_type": "cpu"})
        np.testing.assert_array_equal(b.predict(X), src.predict(X))
    assert "objective=lambdarank" in bp.model_to_string()


# ---- refusals --------------------------------------------------------------

def test_xendcg_refuses_the_persistent_grower():
    X, y, g = rank_data(600, 14)
    p = dict(BASE, objective="rank_xendcg", tpu_persist_scan="force",
             device_type="cpu")
    with pytest.raises(LightGBMError, match="has no device gradient"):
        lp.train(p, lp.Dataset(X, y, group=g, params=p), 1)
