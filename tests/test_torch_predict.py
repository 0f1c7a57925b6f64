"""Prediction on the device (lightgbm_torch/predict/): the port against the
JAX package on the CPU.

- ``compile_ensemble`` gives the JAX package's depth buckets field for
  field on the same model text (binary, multiclass K = 3, categorical,
  DART, RF, and one-leaf trees: K = 4 whose fourth class has no row).
- The port's CPU predictor (``device_predictor(device="cpu")``: the walk
  kernel's plain version, ops/predict.py) gives raw f64 scores and leaf
  indices bit-equal to the JAX ``TPUPredictor`` (f64, on JAX's CPU
  backend) and to the port's numpy walk: gbdt, goss, dart and rf,
  multiclass, NaN, zero_as_missing, categorical bitsets with NaN,
  negative, unseen and huge categories, start_iteration/num_iteration.
- The reference LightGBM's model text (tests/fixtures/interop_model.txt):
  leaves equal to the numpy walk.
- The f32 mode within 1e-6 of f64 (the JAX package's pinned tolerance);
  the objectives' ``convert_output`` on torch tensors (the predictor's
  conversion on its device) within rtol 1e-14 of the JAX package's
  ``make_device_transform``; fair and quantile with reg_sqrt square their
  predictions as the numpy route does.
- Routing: without a card the default ``predict`` raises naming
  ``device_type=cpu``/``predict_device=cpu`` (no fallback);
  ``predict_device=cpu`` is the numpy walk; ``tpu`` is refused;
  ``pred_contrib`` raises naming ROADMAP queue A, item 8, step 2.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lightgbm_tpu as lt
from lightgbm_tpu.predict import compile_ensemble as jcompile
from lightgbm_tpu.predict import make_device_transform as jtransform
import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_higgs_like
from lightgbm_torch.ops.predict import predict_walk, predict_walk_plain
from lightgbm_torch.config import Config
from lightgbm_torch.objectives import create_objective
from lightgbm_torch.predict import CudaPredictor, compile_ensemble
from lightgbm_torch.utils.log import LightGBMError

FIXDIR = os.path.join(os.path.dirname(__file__), "fixtures")
BASE = {"num_leaves": 15, "max_bin": 63, "min_data_in_leaf": 10,
        "learning_rate": 0.3, "verbosity": -1, "device_type": "cpu"}
CPU = {"device_type": "cpu"}


def _data(n=1500, seed=3, nan=0.1, n_features=24):
    X, y = make_higgs_like(n, n_features, seed)
    X = X.astype(np.float64)
    rng = np.random.default_rng(seed)
    X[rng.random(X.shape) < nan] = np.nan
    X[rng.random(X.shape) < 0.05] = 0.0
    return X, y


def _cat_data(n=2000, seed=5):
    """Two categorical columns (0: 12 categories, 1: 40) and three
    numerical ones; the label depends on both kinds."""
    rng = np.random.default_rng(seed)
    X = np.empty((n, 5))
    X[:, 0] = rng.integers(0, 12, n)
    X[:, 1] = rng.integers(0, 40, n)
    X[:, 2:] = rng.normal(size=(n, 3))
    y = ((np.isin(X[:, 0], [1, 4, 7, 9]) ^ (X[:, 1] % 3 == 0))
         | (X[:, 2] > 1.0)).astype(np.float64)
    return X, y


def _cat_rows(X, seed=6):
    """Held-out rows with NaN, negative, unseen, fractional and huge
    categories."""
    Xt = X[:1000].copy()
    rng = np.random.default_rng(seed)
    for v in (np.nan, -3.0, 999.0, 40.0, 2.0 ** 40, 1e20, -0.0):
        Xt[:, :2][rng.random((1000, 2)) < 0.04] = v
    Xt[:, :2][rng.random((1000, 2)) < 0.04] += 0.5
    return Xt


def _train(params, X, y, rounds, **ds):
    p = dict(BASE, **params)
    return lp.train(p, lp.Dataset(X, y, params=p, **ds), rounds)


def _port_walk(bst, X, start=0, num=-1, leaf=False):
    pr = bst._booster.device_predictor(start, num, device="cpu")
    return pr.predict_leaf(X) if leaf else pr.predict(X, raw_score=True)


def _jax_walk(jb, X, start=0, num=-1, leaf=False):
    return jb.predict(X, raw_score=True, pred_leaf=leaf,
                      start_iteration=start, num_iteration=num,
                      predict_device="tpu")


def _assert_same_walks(bst, X, ranges=((0, -1),)):
    jb = lt.Booster(model_str=bst.model_to_string())
    for start, num in ranges:
        numpy_raw = bst.predict(X, raw_score=True, start_iteration=start,
                                num_iteration=num)
        numpy_leaf = bst.predict(X, pred_leaf=True, start_iteration=start,
                                 num_iteration=num)
        port_raw = _port_walk(bst, X, start, num)
        port_leaf = _port_walk(bst, X, start, num, leaf=True)
        np.testing.assert_array_equal(port_raw, numpy_raw)
        np.testing.assert_array_equal(port_leaf, numpy_leaf)
        np.testing.assert_array_equal(port_raw,
                                      _jax_walk(jb, X, start, num))
        np.testing.assert_array_equal(
            port_leaf, _jax_walk(jb, X, start, num, leaf=True))
    jax.clear_caches()


def _models():
    """Model texts of the compile comparison (trained by the port)."""
    X, y = _data(800, 11)
    out = {"binary": _train({"objective": "binary"}, X, y, 4)}
    Xc, yc = _cat_data(1000, 12)
    out["categorical"] = _train({"objective": "binary"}, Xc, yc, 4,
                                categorical_feature=[0, 1])
    y3 = np.digitize(np.nan_to_num(X[:, 0]), [-0.5, 0.5]).astype(float)
    out["multiclass"] = _train({"objective": "multiclass", "num_class": 3},
                               X, y3, 3)
    # class 3 has no row: its trees have one leaf
    out["one-leaf"] = _train({"objective": "multiclass", "num_class": 4},
                             X, y3, 2)
    out["dart"] = _train({"objective": "binary", "boosting": "dart",
                          "drop_rate": 0.5}, X, y, 5)
    out["rf"] = _train({"objective": "binary", "boosting": "rf",
                        "bagging_fraction": 0.7, "bagging_freq": 1}, X, y, 4)
    return out


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.mark.parametrize("name", ["binary", "categorical", "multiclass",
                                  "one-leaf", "dart", "rf"])
def test_compiled_ensemble_equals_jax(models, name):
    text = models[name].model_to_string()
    pb = lp.Booster(model_str=text, params=CPU)._booster
    jb = lt.Booster(model_str=text)._booster
    ours = compile_ensemble(pb.models, pb.num_tree_per_iteration,
                            pb.average_output, pb.max_feature_idx)
    want = jcompile(jb.models, jb.num_tree_per_iteration,
                    jb.average_output, jb.max_feature_idx)
    for f in ("num_trees", "num_tree_per_iteration", "average_output",
              "max_feature_idx"):
        assert getattr(ours, f) == getattr(want, f), f
    assert len(ours.buckets) == len(want.buckets)
    for a, b in zip(ours.buckets, want.buckets):
        assert a.depth == b.depth
        for f in a._fields[1:]:
            x, w = getattr(a, f), getattr(b, f)
            assert x.dtype == w.dtype and x.shape == w.shape, f
            np.testing.assert_array_equal(x, w, err_msg=f)
    if name == "one-leaf":
        assert any(t.num_leaves == 1 for t in pb.models)
    if name == "categorical":
        assert any(b.cat_nwords.any() for b in ours.buckets)


@pytest.mark.parametrize("boosting", ["gbdt", "goss", "dart", "rf"])
def test_walk_equals_jax_and_numpy(boosting):
    X, y = _data(1000, 3)
    params = {"objective": "binary", "boosting": boosting}
    if boosting == "rf":
        params.update(bagging_fraction=0.7, bagging_freq=1)
    if boosting == "goss":
        params.update(learning_rate=0.5)
    if boosting == "dart":
        params.update(drop_rate=0.5)
    bst = _train(params, X, y, 6)
    _assert_same_walks(bst, X, ((0, -1), (2, 3)))


def test_walk_multiclass_and_zero_as_missing():
    X, y = _data(1500, 4, nan=0.0)
    X[np.random.default_rng(4).random(X.shape) < 0.15] = 0.0
    y3 = np.digitize(X[:, 0], [-0.4, 0.4]).astype(float)
    bst = _train({"objective": "multiclass", "num_class": 3,
                  "zero_as_missing": True}, X, y3, 4)
    dts = np.concatenate([t.decision_type[:t.num_leaves - 1]
                          for t in bst._booster.models])
    assert ((dts >> 2) & 3 == 1).any()          # zero missing type nodes
    _assert_same_walks(bst, X, ((0, -1), (1, 2)))


def test_walk_nan_missing_type():
    X, y = _data(1500, 7, nan=0.25)
    bst = _train({"objective": "binary"}, X, y, 5)
    dts = np.concatenate([t.decision_type[:t.num_leaves - 1]
                          for t in bst._booster.models])
    assert ((dts >> 2) & 3 == 2).any()          # NaN missing type nodes
    _assert_same_walks(bst, X)


def test_walk_categorical_edges():
    X, y = _cat_data()
    bst = _train({"objective": "binary"}, X, y, 5,
                 categorical_feature=[0, 1])
    assert sum(t.num_cat for t in bst._booster.models)
    _assert_same_walks(bst, _cat_rows(X), ((0, -1), (1, 3)))


def test_reference_model_text_leaves():
    """The reference LightGBM binary's model text: the walk's leaves and
    raw scores equal the numpy walk's on HIGGS-shaped rows (28 features,
    as the fixture's)."""
    bst = lp.Booster(model_file=os.path.join(FIXDIR, "interop_model.txt"),
                     params=CPU)
    X, _ = make_higgs_like(3000, 28, 9)
    X = X.astype(np.float64)
    X[np.random.default_rng(9).random(X.shape) < 0.05] = np.nan
    np.testing.assert_array_equal(_port_walk(bst, X, leaf=True),
                                  bst.predict(X, pred_leaf=True))
    np.testing.assert_array_equal(_port_walk(bst, X),
                                  bst.predict(X, raw_score=True))


def test_reference_model_text_predictions():
    """Converted predictions within 1e-14 of the reference CLI's own
    (tests/test_golden_parity.py:117's rows and tolerance)."""
    from test_golden_parity import EXAMPLES
    examples = os.path.join(EXAMPLES, "binary_classification")
    if not os.path.isdir(examples):
        pytest.skip("reference examples not available (as "
                    "tests/test_golden_parity.py)")
    bst = lp.Booster(model_file=os.path.join(FIXDIR, "interop_model.txt"),
                     params=CPU)
    X = np.loadtxt(os.path.join(examples, "binary.test"))[:, 1:]
    pred = bst._booster.device_predictor(device="cpu").predict(X)
    np.testing.assert_allclose(
        pred, np.loadtxt(os.path.join(FIXDIR, "interop_preds.txt")),
        rtol=0, atol=1e-14)


def test_f32_mode_within_1e6(models):
    X, _ = _data(800, 11)
    for name in ("binary", "multiclass", "rf"):
        gb = models[name]._booster
        f64 = _port_walk(models[name], X)
        ens = compile_ensemble(gb.models, gb.num_tree_per_iteration,
                               gb.average_output, gb.max_feature_idx)
        f32 = CudaPredictor(ens, dtype="f32", device="cpu").predict(
            X, raw_score=True)
        assert f32.dtype == np.float32
        np.testing.assert_allclose(f32, f64, rtol=0, atol=1e-6)


def test_plain_walk_modes_agree():
    """The raw mode's sums are the leaf mode's leaves' values, summed per
    class in model order; an averaged model divides by the iterations."""
    X, y = _data(800, 13)
    y3 = np.digitize(np.nan_to_num(X[:, 0]), [-0.4, 0.4]).astype(float)
    bst = _train({"objective": "multiclass", "num_class": 3}, X, y3, 3)
    pr = bst._booster.device_predictor(device="cpu")
    Xt = torch.as_tensor(X)
    leaf = predict_walk(Xt, pr.walk, 3, leaf=True).numpy()
    trees = bst._booster.models
    want = np.zeros((len(X), 3))
    for i, t in enumerate(trees):
        want[:, i % 3] += t.leaf_value[leaf[:, i]]
    np.testing.assert_array_equal(predict_walk(Xt, pr.walk, 3).numpy(),
                                  want)
    avg = predict_walk_plain(Xt, pr.walk, 3, average=True).numpy()
    np.testing.assert_array_equal(avg, want / 3)


NAMES = [("binary", {"sigmoid": 1.0}), ("binary", {"sigmoid": 0.7}),
         ("multiclassova", {"sigmoid": 1.3}), ("multiclass", {}),
         ("regression", {"sqrt": True}), ("regression", {"sqrt": False}),
         ("cross_entropy", {}), ("cross_entropy_lambda", {}),
         ("poisson", {}), ("gamma", {}), ("tweedie", {}), ("huber", {}),
         ("lambdarank", {})]


@pytest.mark.parametrize("name,attrs", NAMES)
def test_transform_equals_jax(name, attrs):
    """The registry's objective converts a torch tensor (as
    CudaPredictor.dispatch_padded does on its device) as the JAX
    package's device transform does."""
    params = {"objective": name, "num_class": 3 if "multiclass" in name
              else 1, "reg_sqrt": attrs.get("sqrt", False)}
    if "sigmoid" in attrs:
        params["sigmoid"] = attrs["sigmoid"]
    obj = create_objective(name, Config(params))
    assert obj.name == name
    raw = np.random.default_rng(1).normal(scale=3.0, size=(300, 3))
    if name != "multiclass":
        raw = raw[:, 0]
    ours = obj.convert_output(torch.as_tensor(raw))
    assert isinstance(ours, torch.Tensor)
    want = np.asarray(jtransform(obj)(jnp.asarray(raw)))
    np.testing.assert_allclose(ours.numpy(), want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("objective", ["fair", "quantile"])
def test_reg_sqrt_predictions_match_the_numpy_route(objective):
    """Fair and quantile keep reg_sqrt (they train on the sqrt label): the
    predictor squares back as the numpy route does, bit for bit."""
    X, y = _data(900, 16, nan=0.0)
    y = 4.0 * y - 1.0 + X[:, 0]
    p = dict(BASE, objective=objective, reg_sqrt=True)
    bst = lp.train(p, lp.Dataset(X, y, params=p), 3)
    assert bst._booster.objective.sqrt
    want = bst.predict(X, predict_device="cpu")
    raw = bst.predict(X, raw_score=True, predict_device="cpu")
    np.testing.assert_array_equal(want, np.sign(raw) * raw * raw)
    pr = bst._booster.device_predictor(device="cpu")
    np.testing.assert_array_equal(pr.predict(X), want)
    np.testing.assert_array_equal(pr.predict(X, raw_score=True), raw)


def test_predictor_refuses_bad_rows(models):
    pr = models["binary"]._booster.device_predictor(device="cpu")
    with pytest.raises(LightGBMError, match="rows must be"):
        pr.dispatch_padded(torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(LightGBMError, match="dtype"):
        predict_walk(torch.zeros((4, 24), dtype=torch.float32), pr.walk, 1)
    with pytest.raises(LightGBMError, match="unknown predict dtype"):
        CudaPredictor(pr.ensemble, dtype="f16", device="cpu")


def test_predictor_is_cached_until_the_model_changes():
    X, y = _data(800, 14)
    p = dict(BASE, objective="binary")
    bst = lp.train(p, lp.Dataset(X, y, params=p), 2)
    gb = bst._booster
    a = gb.device_predictor(device="cpu")
    assert gb.device_predictor(device="cpu") is a
    bst.update()
    b = gb.device_predictor(device="cpu")
    assert b is not a and b.ensemble.num_trees == 3
    np.testing.assert_array_equal(b.predict(X, raw_score=True),
                                  bst.predict(X, raw_score=True))


def test_default_predict_needs_a_card(monkeypatch, models):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _ = _data(300, 11)
    text = models["binary"].model_to_string()
    bst = lp.Booster(model_str=text)
    for kw in ({}, {"raw_score": True}, {"pred_leaf": True}):
        with pytest.raises(LightGBMError, match="device_type=cpu") as ei:
            bst.predict(X, **kw)
        assert "predict_device=cpu" in str(ei.value)
    with pytest.raises(LightGBMError, match="device_type=cpu"):
        lp.Booster(model_str=text, params={"predict_device": "cuda",
                                            "device_type": "cpu"}).predict(X)
    # the empty model raises on the card route too
    empty = lp.Booster(model_str=text)
    empty._booster.models = []
    with pytest.raises(LightGBMError, match="device_type=cpu"):
        empty.predict(X)


def test_cpu_routes_are_the_numpy_walk(models):
    X, _ = _data(300, 11)
    bst = models["binary"]
    text = bst.model_to_string()
    want = bst._booster.predict_raw(X)
    for b, kw in ((lp.Booster(model_str=text), {"predict_device": "cpu"}),
                  (lp.Booster(model_str=text, params=CPU), {}),
                  (lp.Booster(model_str=text,
                              params={"predict_device": "cpu"}), {})):
        np.testing.assert_array_equal(b.predict(X, raw_score=True, **kw),
                                      want)
        np.testing.assert_array_equal(
            b.predict(X, **kw), bst._booster.objective.convert_output(want))
    empty = lp.Booster(model_str=text, params=CPU)
    empty._booster.models = []
    np.testing.assert_array_equal(empty.predict(X), np.full(300, 0.5))
    np.testing.assert_array_equal(empty.predict(X, pred_leaf=True),
                                  np.zeros((300, 0), np.int32))
    # an iteration range past the model selects no tree on the walk's
    # route either
    past = bst._booster.predict(X, raw_score=True, start_iteration=50,
                                device=torch.device("cpu"))
    np.testing.assert_array_equal(past, np.zeros(300))


def test_refusals(models):
    X, _ = _data(300, 11)
    bst = models["binary"]
    with pytest.raises(LightGBMError, match="cuda"):
        bst.predict(X, predict_device="tpu")
    with pytest.raises(LightGBMError, match="cuda"):
        lp.Config({"predict_device": "tpu"})
    with pytest.raises(LightGBMError, match="item 8, step 2"):
        bst.predict(X, pred_contrib=True)
    with pytest.raises(LightGBMError, match="number of features"):
        bst.predict(X[:, :5])
    with pytest.raises(TypeError, match="pred_early_stop"):
        bst.predict(X, pred_early_stop=True)
    wide = np.concatenate([X, X[:, :2]], axis=1)
    np.testing.assert_array_equal(
        bst.predict(wide, raw_score=True, predict_disable_shape_check=True),
        bst.predict(X, raw_score=True))


def test_config_routing():
    assert lp.Config({}).predict_device == "cuda"
    assert lp.Config(CPU).predict_device == "cpu"
    assert lp.Config({"predict_device": "gpu",
                      "device_type": "cpu"}).predict_device == "cuda"
    assert lp.Config({"predict_backend": "cpu"}).predict_device == "cpu"
    assert lp.Config({"tpu_serve_async": True,
                      "device_type": "cpu"}).predict_device == "cuda"
