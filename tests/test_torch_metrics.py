"""The port's metrics against the JAX package's, on the same inputs.

Every metric that lightgbm_tpu/metrics/pointwise.py and multiclass.py
register is evaluated by both packages on the same seeded numpy scores,
labels and weights, with the objective's ConvertOutput and without it:
equal within 1e-12 relative. The scores are also rounded to one decimal,
so that AUC and auc_mu meet many ties. AUC's degenerate cases (no
positive, no negative, an empty set) give the same value in both: 1.0
without weights. Multiclass runs at
K = 3 with multi_error_top_k 1 and 2, and auc_mu with and without
auc_mu_weights. The JAX package sums AUC's weights in f32 in numpy's
order; the port reproduces that order (metrics/pointwise.py:
pairwise_sum_f32), held here against np.sum directly.
"""
import zlib

import numpy as np
import pytest
import torch

import lightgbm_tpu.metrics as jm
from lightgbm_tpu.config import Config as JConfig
from lightgbm_tpu.data.dataset import Metadata as JMeta
from lightgbm_tpu.objectives import create_objective as jobjective
import lightgbm_torch.metrics as pm
from lightgbm_torch.config import Config as PConfig
from lightgbm_torch.data.dataset import Metadata as PMeta
from lightgbm_torch.metrics.pointwise import pairwise_sum_f32
from lightgbm_torch.objectives import create_objective as pobjective
from lightgbm_torch.utils.log import LightGBMError

N = 3000
RTOL = 1e-12

# metric: (objective, label kind)
POINTWISE = {
    "l2": ("regression", "normal"), "rmse": ("regression", "normal"),
    "l1": ("regression", "normal"), "quantile": ("regression", "normal"),
    "huber": ("regression", "normal"), "fair": ("regression", "normal"),
    "poisson": ("poisson", "count"), "mape": ("regression", "normal"),
    "gamma": ("gamma", "positive"), "gamma_deviance": ("gamma", "positive"),
    "tweedie": ("tweedie", "count"), "binary_logloss": ("binary", "01"),
    "binary_error": ("binary", "01"), "auc": ("binary", "01"),
    "cross_entropy": ("binary", "01"),
    "cross_entropy_lambda": ("binary", "01"), "kldiv": ("binary", "soft"),
}
MULTICLASS = ("multi_logloss", "multi_error", "auc_mu")


def _label(kind, rng, n=N):
    return {"normal": lambda: rng.normal(size=n),
            "count": lambda: rng.poisson(2.0, n).astype(np.float64),
            "positive": lambda: rng.gamma(2.0, 1.0, n),
            "01": lambda: (rng.random(n) < 0.4).astype(np.float64),
            "soft": lambda: rng.random(n)}[kind]()


def _seed(*key):
    return zlib.crc32(repr(key).encode())


def _meta(cls, label, weight):
    md = cls(len(label))
    md.set_label(label)
    md.set_weight(weight)
    return md


def _both(name, params, label, weight, score, with_objective):
    """(JAX value, port value) of metric `name` on the same inputs."""
    n = len(label)
    out = []
    for cfg_cls, meta_cls, mk_metric, mk_obj, to_score in (
            (JConfig, JMeta, jm.create_metric, jobjective, lambda s: s),
            (PConfig, PMeta, pm.create_metric, pobjective,
             lambda s: torch.as_tensor(s))):
        cfg = cfg_cls(dict(params))
        md = _meta(meta_cls, label, weight)
        m = mk_metric(name, cfg)
        m.init(md, n)
        obj = None
        if with_objective:
            obj = mk_obj(cfg.objective, cfg)
            obj.init(md, n)
        (v,) = m.eval(to_score(score), obj)
        out.append(float(v))
    return out


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("name", sorted(POINTWISE))
def test_pointwise_metric_matches_jax(name, weighted, ties):
    objective, kind = POINTWISE[name]
    rng = np.random.default_rng(_seed(name, weighted, ties))
    label = _label(kind, rng)
    weight = rng.random(N) + 0.5 if weighted else None
    raw = rng.normal(size=N)
    if ties:
        raw = np.round(raw, 1)
    # without the objective the metric reads the score as the prediction:
    # a probability for the binary family, a positive mean for the log-link
    # families
    pred = (1.0 / (1.0 + np.exp(-raw)) if objective == "binary"
            else np.abs(raw) + 0.1 if objective in ("poisson", "gamma",
                                                    "tweedie") else raw)
    for with_obj, score in ((True, raw), (False, pred)):
        a, b = _both(name, {"objective": objective, "alpha": 0.7},
                     label, weight, score, with_obj)
        assert np.isfinite(a)
        assert abs(a - b) <= RTOL * abs(a), (with_obj, a, b)


@pytest.mark.parametrize("case", ["no positive", "no negative", "empty",
                                  "all tied"])
def test_auc_degenerate_cases(case):
    rng = np.random.default_rng(1)
    n = 0 if case == "empty" else 500
    label = {"no positive": np.zeros(n), "no negative": np.ones(n),
             "empty": np.zeros(0),
             "all tied": (rng.random(n) < 0.5).astype(np.float64)}[case]
    score = np.zeros(n) if case == "all tied" else rng.normal(size=n)
    for weight in (None, rng.random(n) + 0.5):
        a, b = _both("auc", {"objective": "binary"}, label, weight, score,
                     False)
        assert a == b
        # with weights the JAX package compares its f64 positive sum with
        # its f32 weight sum, so "no negative" need not read as degenerate
        # there; the port follows it
        if weight is None:
            assert a == (0.5 if case == "all tied" else 1.0)


@pytest.mark.parametrize("ties", [False, True])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("variant", ["default", "top_k 2 / weights"])
@pytest.mark.parametrize("name", MULTICLASS)
def test_multiclass_metric_matches_jax(name, variant, weighted, ties):
    K = 3
    rng = np.random.default_rng(_seed(name, variant, weighted, ties))
    label = rng.integers(0, K, N).astype(np.float64)
    weight = rng.random(N) + 0.5 if weighted else None
    score = rng.normal(size=K * N)
    if ties:
        score = np.round(score, 1)
    params = {"objective": "multiclass", "num_class": K}
    if variant != "default":
        params.update(multi_error_top_k=2,
                      auc_mu_weights=list(rng.random(K * K) * (
                          1 - np.eye(K)).reshape(-1)))
    for with_obj in (True, False):
        a, b = _both(name, params, label, weight, score, with_obj)
        assert np.isfinite(a)
        assert abs(a - b) <= RTOL * abs(a), (with_obj, a, b)


def test_metric_names_and_directions_match_jax():
    for name in sorted(POINTWISE) + list(MULTICLASS):
        params = ({"objective": "multiclass", "num_class": 3,
                   "multi_error_top_k": 2} if name in MULTICLASS
                  else {"objective": POINTWISE[name][0]})
        a = jm.create_metric(name, JConfig(dict(params)))
        b = pm.create_metric(name, PConfig(dict(params)))
        assert a.names == b.names
        assert a.factor_to_bigger_better == b.factor_to_bigger_better


def test_ranking_metrics_are_refused():
    """ndcg and map are ported (tests/test_torch_rank.py); without query
    information they refuse with the JAX package's messages."""
    md = PMeta(10)
    md.set_label(np.zeros(10))
    for name, match in (("ndcg", "The NDCG metric requires query"),
                        ("map", "MAP metric, there should be query")):
        m = pm.create_metric(name, PConfig({}))
        with pytest.raises(LightGBMError, match=match):
            m.init(md, 10)


@pytest.mark.parametrize("n", [1, 7, 8, 129, 8192, 8193, 20_000, 100_003])
def test_f32_weight_sum_in_numpy_order(n):
    w = (np.random.default_rng(n).random(n) + 0.5).astype(np.float32)
    assert float(pairwise_sum_f32(torch.as_tensor(w))) == float(np.sum(w))
