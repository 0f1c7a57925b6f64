"""Serving on the port (lightgbm_torch/predict/serve.py and
lightgbm_torch/serving/), on the CPU: the JAX package's serving cases
(tests/test_serving.py, tests/test_predict_tpu.py) that need no JAX-only
module, with the predictors on the CPU (the walk's plain version).

- ``BatchServer``: the bucket ladder's bound and hits, chunking of large
  requests, admission-time queue depth, one device only (several name
  ROADMAP queue A, item 11);
- ``AsyncBatchServer``: a single request equal to the direct walk bit for
  bit (raw) and to the converted scores within 1e-12, coalescing of
  queued requests into one batch, a chunked oversized request, the
  deadline flush of a lone sub-bucket request, ``stop`` draining the
  queue;
- ``ModelRegistry``: swap and rollback bit-exact, a hot swap under load
  with no mixed outputs and no drops, loads from a booster, model text and
  a model file, drop; quantized loads refused (ROADMAP queue A, item 8,
  step 3).

Every wait has a timeout and every server is stopped in a ``finally``, so
no test can hang the suite.
"""
import sys
import threading
import time

import numpy as np
import pytest

import lightgbm_torch as lp
from lightgbm_torch.predict import BatchServer
from lightgbm_torch.serving import (AsyncBatchServer, ModelRegistry,
                                    QuantRefusedError, ServingError)
from lightgbm_torch.utils.log import LightGBMError

WAIT = 60.0          # seconds any single wait may take


def _data(seed=3, n=1500, nf=8):
    rng = np.random.default_rng(seed)
    X = (rng.integers(0, 16, size=(n, nf)) / 4.0).astype(np.float64)
    X[rng.random(X.shape) < 0.05] = np.nan
    y = (np.nan_to_num(X[:, 0]) - np.nan_to_num(X[:, 2])
         + 0.25 * np.nan_to_num(X[:, 5]) > 0.5).astype(float)
    return X, y


def _train(X, y, n_trees=8, seed=0, leaves=15):
    p = {"objective": "binary", "num_leaves": leaves, "verbosity": -1,
         "min_data_in_leaf": 5, "feature_fraction": 0.9, "seed": seed,
         "device_type": "cpu"}
    return lp.train(p, lp.Dataset(X, y, params=p), n_trees)


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def model(data):
    """An 8-tree model, its CPU predictor and its raw reference scores
    (the numpy walk)."""
    X, y = data
    b = _train(X, y)
    return b, b._booster.device_predictor(device="cpu"), \
        b.predict(X, raw_score=True)


@pytest.fixture(scope="module")
def model_pair(data):
    X, y = data
    ba = _train(X, y, seed=1)
    bb = _train(X, y, n_trees=12, seed=9)
    ref_a = ba.predict(X, raw_score=True)
    ref_b = bb.predict(X, raw_score=True)
    assert not np.array_equal(ref_a, ref_b)
    return (ba, ref_a), (bb, ref_b)


def _registry():
    return ModelRegistry(device="cpu")


# ---------------------------------------------------------------------
# sync server

def test_ladder_bound_and_hits(data, model):
    X, _ = data
    b, pred, _ = model
    server = BatchServer(pred, min_batch=64, max_batch=1024)
    bound = server.max_compiles()
    assert bound == int(np.ceil(np.log2(1024 / 64))) + 1
    rng = np.random.default_rng(0)
    sizes = [65, 100, 128, 1, 300, 511, 700, 1000, 64, 77, 950, 513, 256,
             129, 2, 333]
    for n in sizes:
        idx = rng.integers(0, len(X), size=n)
        np.testing.assert_array_equal(server.predict(X[idx], raw_score=True),
                                      b.predict(X[idx], raw_score=True))
        np.testing.assert_allclose(server.predict(X[idx]), b.predict(X[idx]),
                                   rtol=0, atol=1e-12)
    st = server.stats()
    assert st["compiles"] <= bound
    assert set(st["buckets_compiled"]) <= {64 << i for i in range(bound)}
    assert st["bucket_hits"] == 2 * len(sizes) - st["compiles"]
    assert st["requests"] == 2 * len(sizes)
    # a second pass of other sizes adds no bucket
    for n in (2, 70, 90, 128, 257, 333, 480, 512):
        server.predict(X[:n])
    assert server.stats()["compiles"] == st["compiles"]


def test_chunks_large_requests(data, model):
    X, _ = data
    _, pred, ref = model
    server = BatchServer(pred, min_batch=64, max_batch=256)
    np.testing.assert_array_equal(server.predict(X, raw_score=True), ref)
    assert server.stats()["buckets_compiled"] == [256]


def test_qdepth_sampled_at_admission(data, model):
    X, _ = data
    _, pred, _ = model
    server = BatchServer(pred, min_batch=64, max_batch=512)
    barrier = threading.Barrier(3)
    hold = threading.Event()
    walk = pred.predict_padded

    def slow(*a, **k):
        hold.wait(WAIT)
        return walk(*a, **k)

    def one():
        barrier.wait(WAIT)
        server.predict(X[:64])

    pred.predict_padded = slow
    threads = [threading.Thread(target=one) for _ in range(3)]
    try:
        for t in threads:
            t.start()
        deadline = time.time() + WAIT
        while server.stats()["qdepth_max"] < 3 and time.time() < deadline:
            time.sleep(0.01)
    finally:
        hold.set()
        for t in threads:
            t.join(WAIT)
        del pred.predict_padded
    assert not any(t.is_alive() for t in threads)
    st = server.stats()
    assert st["qdepth_max"] == 3, st["qdepth_max"]
    assert st["queue_depth"]["count"] == 3
    server.predict(X[:64])
    assert server.stats()["qdepth_max"] == 3          # the max is sticky


def test_one_device_only(model):
    _, pred, _ = model
    with pytest.raises(LightGBMError, match="item 11"):
        BatchServer(pred, devices=["cpu", "cpu"])
    with pytest.raises(LightGBMError, match="item 11"):
        AsyncBatchServer(pred, devices=["cpu", "cpu"])
    BatchServer(pred, devices=["cpu"])


# ---------------------------------------------------------------------
# continuous batching

def test_async_parity_single_request(data, model):
    X, _ = data
    b, pred, ref = model
    server = AsyncBatchServer(pred, min_batch=256, max_batch=1024).start()
    try:
        np.testing.assert_array_equal(
            server.predict(X[:300], raw_score=True, timeout=WAIT), ref[:300])
        np.testing.assert_allclose(server.predict(X[:300], timeout=WAIT),
                                   b.predict(X[:300]), rtol=0, atol=1e-12)
    finally:
        server.stop(timeout=WAIT)


def test_coalesces_queued_requests_into_one_batch(data, model):
    X, _ = data
    _, pred, ref = model
    server = AsyncBatchServer(pred, min_batch=256, max_batch=1024)
    # all 8 requests are queued BEFORE the loop starts, so the first
    # admission wave takes the whole prefix
    futs = [(i, server.submit(X[i * 40:(i + 1) * 40], raw_score=True))
            for i in range(8)]
    server.start()
    try:
        for i, f in futs:
            np.testing.assert_array_equal(f.result(timeout=WAIT),
                                          ref[i * 40:(i + 1) * 40])
    finally:
        server.stop(timeout=WAIT)
    st = server.stats()
    assert st["batches"] == 1, st
    assert st["requests"] == 8
    assert st["coalesce_ratio"] == 8.0
    assert st["errors"] == 0 and st["depth"] == 0


def test_oversized_request_chunked_multi_part(data, model):
    X, _ = data
    _, pred, ref = model
    server = AsyncBatchServer(pred, min_batch=64, max_batch=256).start()
    try:
        out = server.predict(X, raw_score=True, timeout=WAIT)   # 6 parts
    finally:
        server.stop(timeout=WAIT)
    np.testing.assert_array_equal(out, ref)
    assert server.stats()["batches"] == 6


def test_deadline_flush_lone_subbucket_request(data, model):
    """A lone 32-row request (min bucket 256) is held for coalescing, then
    flushed within max_wait (the queue-wait histogram shows both)."""
    X, _ = data
    _, pred, ref = model
    max_wait_ms = 50.0
    server = AsyncBatchServer(pred, min_batch=256, max_batch=1024,
                              max_wait_ms=max_wait_ms).start()
    try:
        t0 = time.perf_counter()
        out = server.predict(X[:32], raw_score=True, timeout=WAIT)
        e2e = time.perf_counter() - t0
    finally:
        server.stop(timeout=WAIT)
    np.testing.assert_array_equal(out, ref[:32])
    st = server.stats()
    assert st["flushes"]["deadline"] >= 1, st["flushes"]
    assert st["queue_wait_max"] >= 0.5 * max_wait_ms / 1e3, st
    assert st["queue_wait_max"] <= max_wait_ms / 1e3 + 0.3, st
    assert e2e < 5.0


def test_stop_drains_queue(data, model):
    X, _ = data
    b, pred, _ = model
    server = AsyncBatchServer(pred, min_batch=256, max_batch=1024)
    futs = [server.submit(X[i * 30:(i + 1) * 30]) for i in range(6)]
    server.start()
    server.stop(timeout=WAIT)        # drain: every queued request answered
    assert all(f.done() for f in futs)
    ref = b.predict(X[:180])
    for i, f in enumerate(futs):
        np.testing.assert_allclose(f.result(timeout=WAIT),
                                   ref[i * 30:(i + 1) * 30], rtol=0,
                                   atol=1e-12)
    with pytest.raises(ServingError):
        server.submit(X[:8])


def test_stop_without_drain_fails_queued(data, model):
    X, _ = data
    _, pred, _ = model
    server = AsyncBatchServer(pred)
    fut = server.submit(X[:8])
    server.stop(drain=False, timeout=WAIT)
    with pytest.raises(ServingError, match="without drain"):
        fut.result(timeout=WAIT)


# ---------------------------------------------------------------------
# hot-swap registry

def test_registry_swap_rollback_bit_exact(data, model_pair):
    X, _ = data
    (ba, ref_a), (bb, ref_b) = model_pair
    reg = _registry()
    reg.load("a", booster=ba)          # first load auto-activates
    reg.load("b", booster=bb)          # loaded, NOT active
    assert reg.active().name == "a"
    pred_a = reg.resolve()
    server = AsyncBatchServer(reg, min_batch=64, max_batch=512).start()
    try:
        np.testing.assert_array_equal(
            server.predict(X[:100], raw_score=True, timeout=WAIT),
            ref_a[:100])
        reg.swap("b")
        np.testing.assert_array_equal(
            server.predict(X[:100], raw_score=True, timeout=WAIT),
            ref_b[:100])
        reg.rollback()
        assert reg.resolve() is pred_a     # the SAME predictor object
        np.testing.assert_array_equal(
            server.predict(X[:100], raw_score=True, timeout=WAIT),
            ref_a[:100])
    finally:
        server.stop(timeout=WAIT)
    st = reg.stats()
    assert st["active"] == "a" and st["previous"] == "b"
    assert st["swaps"] == 3            # load-a activate, swap-b, rollback
    assert server.stats()["registry"]["swaps"] == 3


def test_hot_swap_under_load_no_mixed_outputs_no_drops(data, model_pair):
    """Concurrent clients and repeated swaps: every answer equals EXACTLY
    one model's raw output over its rows, and every request is answered."""
    X, _ = data
    (ba, ref_a), (bb, ref_b) = model_pair
    reg = _registry()
    reg.load("a", booster=ba)
    reg.load("b", booster=bb)
    n_clients, per_client = 6, 15
    results = [[] for _ in range(n_clients)]
    errors = []
    stop_swapping = threading.Event()

    def client(ci, server, rng):
        for _ in range(per_client):
            k = int(rng.integers(5, 120))
            i0 = int(rng.integers(0, len(X) - k))
            try:
                out = server.predict(X[i0:i0 + k], raw_score=True,
                                     timeout=WAIT)
                results[ci].append((i0, k, out))
            except Exception as exc:   # noqa: BLE001 — recorded, failed
                errors.append(exc)     # below with full context

    def swapper():
        flip = True
        while not stop_swapping.is_set():
            reg.swap("b" if flip else "a")
            flip = not flip
            time.sleep(0.002)

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)        # interleave the threads finely
    server = AsyncBatchServer(reg, min_batch=64, max_batch=1024,
                              max_wait_ms=2.0).start()
    threads = [threading.Thread(
        target=client, args=(ci, server, np.random.default_rng(100 + ci)))
        for ci in range(n_clients)]
    sw = threading.Thread(target=swapper)
    try:
        for t in threads:
            t.start()
        sw.start()
        for t in threads:
            t.join(WAIT)
    finally:
        stop_swapping.set()
        sw.join(WAIT)
        server.stop(timeout=WAIT)
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads + [sw])
    st = server.stats()
    assert errors == [], errors
    assert sum(len(r) for r in results) == n_clients * per_client
    assert st["requests"] == n_clients * per_client
    assert st["errors"] == 0 and st["depth"] == 0
    for ci in range(n_clients):
        for i0, k, out in results[ci]:
            from_a = np.array_equal(out, ref_a[i0:i0 + k])
            from_b = np.array_equal(out, ref_b[i0:i0 + k])
            assert from_a or from_b, (
                "request rows [%d:%d] match NEITHER model bit for bit: a "
                "mixed-model batch" % (i0, i0 + k))


def test_registry_load_sources_and_drop(tmp_path, data, model):
    X, _ = data
    b, _, ref = model
    txt = b.model_to_string()
    reg = _registry()
    reg.load("from_booster", booster=b)
    reg.load("from_str", model_str=txt)
    mf = tmp_path / "m.txt"
    mf.write_text(txt)
    reg.load("from_file", model_file=str(mf))
    assert reg.names() == ["from_booster", "from_file", "from_str"]
    for name in reg.names():
        server = AsyncBatchServer(reg.resolve(name), min_batch=64,
                                  max_batch=512).start()
        try:
            np.testing.assert_array_equal(
                server.predict(X[:64], raw_score=True, timeout=WAIT),
                ref[:64])
        finally:
            server.stop(timeout=WAIT)
    assert reg.stats()["slots"]["from_file"]["source"] == "file:%s" % mf
    with pytest.raises(ValueError):
        reg.load("two", booster=b, model_str=txt)
    with pytest.raises(RuntimeError):
        reg.drop(reg.active().name)
    reg.swap("from_file")
    reg.drop("from_str")
    assert "from_str" not in reg.names()
    with pytest.raises(KeyError):
        reg.swap("from_str")


@pytest.mark.parametrize("quant", ["f16", "int8"])
def test_quantized_loads_refused(data, model, quant):
    X, _ = data
    b, _, ref = model
    reg = _registry()
    reg.load("a", booster=b)
    with pytest.raises(QuantRefusedError, match="item 8, step 3"):
        reg.load("q", booster=b, quant=quant, activate=True)
    assert reg.active().name == "a" and reg.names() == ["a"]
    np.testing.assert_array_equal(
        reg.resolve().predict(X[:50], raw_score=True), ref[:50])
