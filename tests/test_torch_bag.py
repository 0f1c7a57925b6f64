"""The bag step's plain versions (lightgbm_torch/ops/bag.py) and the host
draws of the port's bagging and GOSS, held bit for bit against the JAX
package's functions on the CPU.

  * ``hash_uniform_plain`` against ``grow_persist._hash_uniform``, also on
    row ids built to hash within 128 of 2^32 (the u32 -> f32 rounding up to
    u = 1.0 that the JAX package keeps, grow_persist.py:505-512);
  * the whole bag step (``bag_apply_plain``, ``goss_select_plain`` for
    GOSS) against ``make_bag_transform`` on a small payload: the grad and
    hess rows (-0.0 included) and the in-bag count, for fraction, balanced
    and GOSS, GOSS below and past its skip count, the payload's lanes
    permuted as a grown tree leaves them;
  * the threshold against ``_kth_largest`` on values with many ties;
  * the window keys against the JAX booster's ``_persist_bag_keys``;
  * the v1 grower's host draws against ``GBDT.bagging`` and
    ``GOSS.bagging`` of a JAX booster with the same configuration.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp
import lightgbm_tpu as lt
from lightgbm_tpu.ops import grow_persist as jgp
import lightgbm_torch as lp
from lightgbm_torch.ops import bag
from lightgbm_torch.ops import counters

U32 = np.uint32
M32 = 0xFFFFFFFF


def _inv_mul(a: int) -> int:
    """The inverse of an odd `a` modulo 2^32."""
    return pow(a, -1, 1 << 32)


def _unhash(x: int, k0: int, k1: int) -> int:
    """The row id whose _hash_uniform word under (k0, k1) is x (each step
    of the hash is a bijection of u32)."""
    x ^= x >> 16
    x = (x * _inv_mul(0xC2B2AE35)) & M32
    x = (x - k1) & M32
    x ^= (x >> 13) ^ (x >> 26)
    x = (x * _inv_mul(0x85EBCA6B)) & M32
    return x ^ k0


def test_hash_uniform_matches_jax():
    rng = np.random.default_rng(0)
    for seed, window in ((0, 0), (3, 1), (123456789, 77)):
        k0, k1 = bag.window_key(seed, window)
        rid = rng.integers(0, 2 ** 31, 50_000).astype(np.int64)
        # words at the top of u32: they round to 1.0 as f32
        top = [_unhash(M32 - d, k0, k1) for d in range(0, 300, 7)]
        rid = np.concatenate([rid, top, [0, 1, M32]])
        want = np.asarray(jgp._hash_uniform(jnp.asarray(rid.astype(U32)),
                                            jnp.asarray([k0, k1], U32)))
        got = bag.hash_uniform_plain(torch.as_tensor(rid), k0, k1).numpy()
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
        assert np.any(got == 1.0)        # the kept rounding quirk


def _payload(n=3000, pad=117, seed=1, ties=False):
    """A [nbw + 5, n + pad] u32 payload with the rows the bag step reads:
    label (f32 0/1) at nbw, a permutation of the row ids at nbw + 1, f32
    grad/hess at nbw + 2/3 (negative, -0.0 and +0.0 gradients among them;
    `ties`: values on a coarse grid, so |g * h| ties); zeros past n."""
    nbw = 3
    rng = np.random.default_rng(seed)
    pay = np.zeros((nbw + 5, n + pad), U32)
    pay[:nbw, :n] = rng.integers(0, 2 ** 32, (nbw, n), dtype=np.uint64)
    lab = (rng.random(n) < 0.3).astype(np.float32)
    g = rng.normal(size=n).astype(np.float32)
    h = rng.uniform(0.01, 0.25, n).astype(np.float32)
    if ties:
        g = np.round(g * 4) / 4
        h = np.round(h * 16) / 16
    g[:7] = [-0.0, 0.0, -1.5, 0.0, -0.0, 2.0, -3.0]
    pay[nbw, :n] = lab.view(U32)
    pay[nbw + 1, :n] = rng.permutation(n).astype(U32)
    pay[nbw + 2, :n] = g.astype(np.float32).view(U32)
    pay[nbw + 3, :n] = h.astype(np.float32).view(U32)
    return pay, nbw, n


def _port_step(pay, nbw, n, b: bag.BagIteration):
    """The port's bag step (plain versions) on a copy of `pay`: the rows
    and the count."""
    p = torch.as_tensor(pay.view(np.int32).copy())
    st = bag.BagState("cpu")
    st.set(b)
    g = p[nbw + 2].view(torch.float32)
    h = p[nbw + 3].view(torch.float32)
    if b.mode == bag.MODE_GOSS:
        bag.goss_select(g, h, n, st)
    bag.bag_apply(p[nbw + 1], p[nbw].view(torch.float32), g, h, n, b.mode,
                  st)
    return p.numpy().view(U32), int(st.count[0]), st


SPECS = {
    "fraction": (("bagging", 0.7, 1.0, 1.0), 0, 0),
    "balanced": (("bagging", 1.0, 0.8, 0.35), 0, 0),
    "goss-skip": (("goss", 0.2, 0.1), 1, 2),
    "goss": (("goss", 0.2, 0.1), 2, 2),
    "goss-ties": (("goss", 0.3, 0.25), 5, 2),
}


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bag_step_matches_make_bag_transform(name):
    spec, it, skip = SPECS[name]
    pay, nbw, n = _payload(ties=name == "goss-ties", seed=len(name))
    seed, freq = 11, 3
    b = bag.bag_iteration(spec, seed, freq, it, n, skip)
    jspec = spec + (skip,) if spec[0] == "goss" else spec
    geometry = (pay.shape[0], pay.shape[1], 1, None, nbw, n, 0, 0)
    fn = jgp.make_bag_transform(jspec, geometry)
    window = it if spec[0] == "goss" else it // freq
    assert b.key == bag.window_key(seed, window)
    want, cnt = fn(jnp.asarray(pay), jnp.asarray(b.key, U32),
                   jnp.asarray(it, jnp.int32))
    want = np.asarray(want)
    before = counters.read("cpu")
    got, count, st = _port_step(pay, nbw, n, b)
    np.testing.assert_array_equal(got, want)
    assert count == int(cnt)
    after = counters.read("cpu")
    assert after["bag_apply"] - before["bag_apply"] == 1
    selected = spec[0] == "goss" and it >= skip
    assert after["goss_select"] - before["goss_select"] == int(selected)
    gw = want[nbw + 2, :n].view(np.float32)
    if name == "goss-skip":
        assert count == n and int(st.sel[bag.SEL_KEEP]) == 1
        np.testing.assert_array_equal(want, pay)
    else:
        assert 0 < count < n
        # zeroed negative gradients are -0.0: a multiply, not a select
        g_in = pay[nbw + 2, :n].view(np.float32)
        assert np.any((gw == 0) & np.signbit(gw) & (g_in < 0))


@pytest.mark.parametrize("k", [1, 2, 17, 300, 2999, 3000, 3001])
def test_goss_threshold_matches_kth_largest(k):
    """Ties everywhere (values on a grid), -0.0 * h = -0.0 made +0.0 by
    the absolute value, and ranks at both ends."""
    pay, nbw, n = _payload(ties=True, seed=k)
    g = pay[nbw + 2].view(np.float32)
    h = pay[nbw + 3].view(np.float32)
    s = np.abs(g * h)
    live = np.arange(len(s)) < n
    want = np.asarray(jgp._kth_largest(jnp.asarray(np.where(live, s, 0)),
                                       jnp.asarray(live), k))
    st = bag.BagState("cpu")
    st.set(bag.BagIteration(bag.MODE_GOSS, (0, 0), 5, 0, k, 1, 1, 1, 1, 1))
    bag.goss_select(torch.as_tensor(g), torch.as_tensor(h), n, st)
    assert int(st.sel[bag.SEL_THR]) == int(want.view(U32))
    assert int(st.sel[bag.SEL_KEEP]) == 0
    if k <= n:
        assert np.sum(s[:n] >= want) >= k > np.sum(s[:n] > want)


def test_goss_constants_match_jax():
    for n, top, other in ((3000, 0.2, 0.1), (10_516_992, 0.2, 0.1),
                          (1000, 0.05, 0.9), (7, 0.5, 0.4)):
        top_k, p_rest, amp = bag.goss_constants(n, top, other)
        want_k = max(1, int(n * top))
        assert top_k == want_k
        assert p_rest == np.float32(min(1.0, n * other / max(n - want_k, 1)))
        assert amp == np.float32((n - want_k) / max(n * other, 1.0))
    with pytest.raises(Exception, match="top_rate and other_rate"):
        bag.goss_constants(100, 0.6, 0.4)


BASE = {"objective": "binary", "num_leaves": 7, "max_bin": 63,
        "verbosity": -1, "bagging_seed": 5}


def _data(n=3000, seed=2):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, 6))
    y = (X[:, 0] + 0.5 * rng.normal(size=n) > 0.3).astype(np.float64)
    return X, y


def _boosters(params, X, y):
    pj = dict(params, tpu_persist_scan="false")
    pp = dict(pj, device_type="cpu")
    bj = lt.Booster(pj, lt.Dataset(X, y))
    bp = lp.Booster(pp, lp.Dataset(X, y, params=pp))
    return bj._booster, bp._booster


@pytest.mark.parametrize("freq,spec", [(2, ("bagging", 0.6, 1.0, 1.0)),
                                       (5, ("goss", 0.2, 0.1))])
def test_window_keys_match_persist_bag_keys(freq, spec):
    params = dict(BASE, bagging_freq=freq, bagging_fraction=0.6)
    if spec[0] == "goss":
        params = dict(BASE, boosting="goss")
    X, y = _data()
    gj, gp = _boosters(params, X, y)
    jspec = gj._persist_bag_spec()
    assert jspec[0] == spec[0] and tuple(jspec[1:3]) == spec[1:3]
    for start in (0, 7, 16):
        gj.iter = start
        wkeys, iters = gj._persist_bag_keys(jspec, 16)
        for key, it in zip(wkeys, iters):
            b = bag.bag_iteration(spec, 5, freq, int(it), len(y))
            assert b.key == (int(key[0]), int(key[1]))


@pytest.mark.parametrize("name,extra", [
    ("fraction", {"bagging_fraction": 0.7, "bagging_freq": 2}),
    ("balanced", {"pos_bagging_fraction": 0.6, "neg_bagging_fraction": 0.3,
                  "bagging_freq": 1}),
    ("tiny", {"bagging_fraction": 1e-5, "bagging_freq": 3}),
])
def test_host_bagging_matches_jax(name, extra):
    """GBDT.bagging's masks, iteration by iteration, with a reset of the
    bagging keys half way (a fresh Generator and a redraw)."""
    X, y = _data()
    gj, gp = _boosters(dict(BASE, **extra), X, y)
    for it in range(8):
        if it == 4:
            gj.reset_config({"bagging_seed": 9})
            gp.reset_config({"bagging_seed": 9})
        gj.bagging(it)
        gp.bagging(it)
        np.testing.assert_array_equal(gp._bag_mask.numpy(),
                                      np.asarray(gj._bag_mask_dev))
        assert gp.bag_data_cnt == gj.bag_data_cnt
        assert gp._bag_weight is None
    if name == "tiny":
        assert gp.bag_data_cnt == 1


@pytest.mark.parametrize("K", [1, 3])
def test_host_goss_matches_jax(K):
    """GOSS.bagging's weights from the same [K, n] f64 gradients: none
    below int(1 / learning_rate), then the threshold, the drawn rest and
    its amplification."""
    X, y = _data(seed=K)
    params = dict(BASE, boosting="goss", learning_rate=0.4, top_rate=0.15,
                  other_rate=0.2)
    if K > 1:
        y = np.digitize(X[:, 1], [-0.4, 0.4]).astype(np.float64)
        params.update(objective="multiclass", num_class=K)
    gj, gp = _boosters(params, X, y)
    rng = np.random.default_rng(K)
    for it in range(5):
        g = np.round(rng.normal(size=(K, len(y))), 2)
        h = rng.uniform(0.05, 0.25, (K, len(y)))
        gj._cur_grad_hess = (jnp.asarray(g), jnp.asarray(h))
        gj.bagging(it)
        gp.bagging(it, torch.as_tensor(g), torch.as_tensor(h))
        if it < 2:
            assert gp._bag_weight is None and gp._bag_mask is None
            assert gj._bag_weight_dev is None
            continue
        np.testing.assert_array_equal(gp._bag_weight.numpy(),
                                      np.asarray(gj._bag_weight_dev))
        np.testing.assert_array_equal(gp._bag_mask.numpy(),
                                      np.asarray(gj._bag_mask_dev))
        assert gp.bag_data_cnt == gj.bag_data_cnt
