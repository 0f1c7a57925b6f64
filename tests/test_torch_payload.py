"""The port's persistent payload against the JAX package's.

Both packages bin the same matrix (their BinnedDatasets are equal, which
tests/test_torch_data.py holds) and build the payload with their own
``build_assets``. The payload ``pay0`` must be equal bit for bit, and the
pack plan, the geometry and the per-feature decode arrays equal.
"""
import numpy as np
import pytest

import lightgbm_tpu as lt
from lightgbm_tpu.data.dataset import BinnedDataset as JaxDataset
from lightgbm_tpu.data.dataset import nibble_slot_partition as jax_nibble
from lightgbm_tpu.ops import grow_persist as jgp
import lightgbm_torch as lp
from lightgbm_torch.convert import assets_from_reference
from lightgbm_torch.data.dataset import BinnedDataset as PortDataset
from lightgbm_torch.data.dataset import nibble_slot_partition
from lightgbm_torch.ops import payload
from lightgbm_torch.utils.log import LightGBMError

DECODE = ("dec_word", "dec_shift", "dec_mask", "nb", "mt", "db", "ls", "le",
          "mf")


def _matrix(kind, n=2500, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    X[rng.random((n, 6)) < 0.03] = np.nan
    if kind in ("nibble", "weighted"):
        X[:, 1] = rng.integers(0, 5, n)      # three narrow groups: one
        X[:, 3] = rng.integers(0, 12, n)     # nibble pair and a leftover
        X[:, 5] = rng.integers(0, 3, n)
    y = (np.nan_to_num(X[:, 0]) > 0).astype(float)
    w = rng.uniform(0.5, 2.0, n) if kind == "weighted" else None
    return X, y, w


def _both(kind, **kw):
    X, y, w = _matrix(kind)
    params = {"max_bin": 63}
    jd = JaxDataset.from_matrix(X, lt.Config(params), label=y, weight=w)
    pd = PortDataset.from_matrix(X, lp.Config(params), label=y, weight=w)
    return (jgp.build_assets(jd, jd.metadata.label, **kw),
            payload.build_assets(pd, pd.metadata.label, **kw))


@pytest.mark.parametrize("kind,kw", [
    ("bytes", {}), ("nibble", {}), ("weighted", {}),
    ("nibble", {"C": 512, "CR": 512})])
def test_build_assets_matches_jax(kind, kw):
    ja, pa = _both(kind, **kw)
    assert pa.pay0.dtype == np.uint32
    np.testing.assert_array_equal(pa.pay0, ja.pay0)
    assert pa.geometry == tuple(ja.geometry)
    for name in DECODE:
        np.testing.assert_array_equal(getattr(pa, name),
                                      np.asarray(getattr(ja, name)), name)
    for a, b in zip(pa.efb, ja.efb):
        np.testing.assert_array_equal(a, b)
    plan = pa.geometry[3]
    masks = [mk for _, _, mk in plan]
    if kind == "bytes":
        assert set(masks) == {255}
    else:
        assert masks.count(15) == 3          # a nibble pair and a leftover
    assert pa.geometry[9] == (kind == "weighted")


def test_assets_from_reference_keeps_everything():
    ja, pa = _both("nibble")
    ca = assets_from_reference(ja)
    np.testing.assert_array_equal(ca.pay0, pa.pay0)
    assert ca.geometry == pa.geometry
    for name in DECODE:
        np.testing.assert_array_equal(getattr(ca, name), getattr(pa, name))
        assert getattr(ca, name).dtype == np.int32


@pytest.mark.parametrize("widths", [[63, 7, 255, 16, 17, 3, 2],
                                    [5, 5, 5], [], [200, 9]])
def test_nibble_slot_partition_matches_jax(widths):
    assert nibble_slot_partition(widths) == jax_nibble(widths)
    assert payload._payload_plan(np.asarray(widths, np.int64)) \
        == jgp._payload_plan(np.asarray(widths, np.int64))


@pytest.mark.parametrize("n,nbw,kw", [(10_500_000, 7, {}), (3000, 2, {}),
                                      (70_000, 3, {"has_weight": True})])
def test_payload_geometry_matches_jax(n, nbw, kw):
    for C, CR in ((0, 16384), (512, 512)):
        assert payload._payload_geometry(n, nbw, C, CR, **kw) \
            == jgp._payload_geometry(n, nbw, C, CR, **kw)


def test_higgs_geometry():
    """The HIGGS payload: 28 byte groups in 7 words, 12 live rows, 16
    padded rows, about 0.67 GB."""
    WPA, C, NP = payload._payload_geometry(10_500_000, 7, 0, 16384)
    assert payload.payload_weight_row(7, 1) == 12
    assert (WPA, C) == (16, 16384)
    assert 0.6e9 < WPA * NP * 4 < 0.7e9


def test_build_assets_refuses_what_is_not_ported():
    X, y, _ = _matrix("bytes")
    pd = PortDataset.from_matrix(X, lp.Config({"max_bin": 63}), label=y)
    with pytest.raises(LightGBMError, match="item 11"):
        payload.build_assets(pd, y, num_shards=2)
    with pytest.raises(LightGBMError, match="score64"):
        payload.build_assets(pd, y, score64=True)
    with pytest.raises(LightGBMError, match="num_scores=0"):
        payload.build_assets(pd, y, num_scores=0)
    pd.binned = None
    assert not payload.persist_pack_ok(pd)[0]
    with pytest.raises(payload.PersistPackError):
        payload.build_assets(pd, y)
