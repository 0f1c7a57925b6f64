"""The payload kernels' plain versions against the JAX package's kernels.

Both packages get the same payload: the JAX ``build_assets`` of one
BinnedDataset, carried over with ``convert.assets_from_reference``, with
the same f32 gradients and hessians written into rows nbw + 2 and nbw + 3.
The payload has 3000 rows and is built with C = CR = 512, so the TPU
kernels run several chunks; segments start off a multiple of 128.

  * ``split_pass_plain`` reads the segment from one buffer (``src``) and
    writes it partitioned into another (``dst``, here a copy of the
    payload), keeping both children in their old order, as
    ``make_xla_split_pass`` does in place: ``dst`` is equal to the oracle's
    payload bit for bit, n_left is equal and ``src`` is untouched. The
    Pallas kernel (``make_split_pass``, interpret mode) writes each child
    back through a two-ended FIFO, so against it n_left is equal, each
    child is the same multiset of columns (compared after sorting by the
    row-id row) and every lane outside the segment is untouched.
  * Histograms are f32 sums in another order than the references': the XLA
    oracles sum in f64, so a bin of c rows is held to 2 * c * eps32 *
    sum|v| of them (the recursive-summation bound of an f32 sum against the
    exact one, doubled). The Pallas kernels split every value into a bf16
    hi/lo pair for the MXU, which keeps it to 2^-17 of its magnitude, so
    against them the bound grows by 2^-17 * sum|v|.
  * Root totals: the port's are f64 sums rounded to f32 (the XLA oracle's
    convention), held exactly against ``make_xla_root_hist``'s and within
    n * eps32 * sum|v| of the TPU kernel's f32 chunk partials.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lightgbm_tpu as lt
from lightgbm_tpu.data.dataset import BinnedDataset
from lightgbm_tpu.ops import grow_persist as jgp
from lightgbm_tpu.ops import pallas_grow as jpg
from lightgbm_torch.convert import assets_from_reference
from lightgbm_torch.ops import payload_kernels as pk
from lightgbm_torch.ops.histogram import hist_window_plain

EPS32 = float(np.finfo(np.float32).eps)
N = 3000


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(11)
    X = rng.normal(size=(N, 6))
    X[rng.random((N, 6)) < 0.05] = np.nan
    X[:, 2] = np.where(rng.random(N) < 0.4, 0.0, X[:, 2])
    X[:, 4] = rng.integers(0, 7, N)            # a nibble group
    X[:, 5] = rng.integers(0, 4, N)            # its nibble partner
    y = (np.nan_to_num(X[:, 0]) > 0).astype(float)
    ds = BinnedDataset.from_matrix(X, lt.Config({"max_bin": 63}), label=y)
    ja = jgp.build_assets(ds, ds.metadata.label, C=512, CR=512)
    pa = assets_from_reference(ja)
    pay = np.array(pa.pay0)
    nbw = pa.geometry[4]
    pay[nbw + 2, :N] = rng.normal(size=N).astype(np.float32).view(np.uint32)
    pay[nbw + 3, :N] = rng.uniform(0.05, 0.25, N).astype(np.float32) \
        .view(np.uint32)
    return ds, ja, pa, pay


def _port(pay):
    return torch.from_numpy(pay.view(np.int32).copy())


def _geom(pa):
    WPA, NP, G, plan, nbw, n, C, CR = pa.geometry[:8]
    return WPA, NP, G, plan, nbw, n, C, CR


def _hist_bound(pay, nbw, plan, start, length, mxu=False):
    """Per-bin (2 * count * eps32 [+ 2^-17 for the MXU's hi/lo split]) *
    sum|v| over lanes [start, start + length), as [G*256] planes."""
    G = len(plan)
    lanes = np.arange(start, start + length)
    g = np.abs(pay[nbw + 2, lanes].view(np.float32)).astype(np.float64)
    h = np.abs(pay[nbw + 3, lanes].view(np.float32)).astype(np.float64)
    cnt = np.zeros(G * 256)
    sg = np.zeros(G * 256)
    sh = np.zeros(G * 256)
    for gi, (w, sh_, mk) in enumerate(plan):
        b = ((pay[w, lanes] >> np.uint32(sh_)) & np.uint32(mk)).astype(
            np.int64) + gi * 256
        np.add.at(cnt, b, 1)
        np.add.at(sg, b, g)
        np.add.at(sh, b, h)
    rel = 2 * cnt * EPS32 + (2.0 ** -17 if mxu else 0.0)
    return rel * sg + 1e-30, rel * sh + 1e-30


def _scalars(pa, f, s0, n_l, thr, dl, small_l, mt=None, db=None, ls=None,
             le=None, mf=None):
    C = pa.geometry[6]
    s = [0] * pk.N_SCALARS
    s[pk.S_NCH] = (n_l + C - 1) // C
    s[pk.S_S0], s[pk.S_NL] = s0, n_l
    s[pk.S_WG], s[pk.S_SH] = int(pa.dec_word[f]), int(pa.dec_shift[f])
    s[pk.S_MASK], s[pk.S_NB] = int(pa.dec_mask[f]), int(pa.nb[f])
    s[pk.S_MT] = int(pa.mt[f]) if mt is None else mt
    s[pk.S_DB] = int(pa.db[f]) if db is None else db
    s[pk.S_THR], s[pk.S_DL], s[pk.S_SMALL_L] = thr, dl, small_l
    s[pk.S_LS] = int(pa.ls[f]) if ls is None else ls
    s[pk.S_LE] = int(pa.le[f]) if le is None else le
    s[pk.S_MF] = int(pa.mf[f]) if mf is None else mf
    return s


# (group, s0, n_l, threshold, default_left, small_l, overrides): groups
# 0-2 hold 63-bin features with NaNs (the NaN bin is 62), group 3 a 7-bin
# and group 4 a 4-bin feature (nibble slots), group 5 a feature that is
# 0.0 on 40% of the rows (its zero bin is 29)
CASES = {
    "left_smaller": (0, 77, 2600, 10, 1, 1, {}),
    "right_smaller": (1, 300, 2411, 40, 0, 0, {}),
    "empty": (0, 645, 0, 10, 1, 1, {}),
    "nan_missing": (2, 129, 1900, 20, 1, 0, {"mt": 2}),
    "zero_missing": (5, 5, 2990, 40, 0, 1, {"mt": 1}),
    "narrow_range_reads_mf": (1, 1000, 1500, 3, 1, 1,
                              {"ls": 20, "le": 30, "mf": 2}),
    "nibble_feature": (3, 33, 2700, 2, 0, 0, {}),
}


def _feature_of_group(ds, group):
    return int(np.nonzero(ds.group_of == group)[0][0])


@pytest.mark.parametrize("with_hist", [True, False])
@pytest.mark.parametrize("case", sorted(CASES))
def test_split_pass_plain_matches_xla_oracle(setup, case, with_hist):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    f, s0, n_l, thr, dl, small_l, over = CASES[case]
    f = _feature_of_group(ds, f)
    scal = _scalars(pa, f, s0, n_l, thr, dl, small_l, **over)
    ref = jgp.make_xla_split_pass(WPA, NP, G, plan, nbw)
    rpay, (rg, rh), rnl = ref(jnp.asarray(pay), jnp.asarray(scal, jnp.int32))
    tp, dst = _port(pay), _port(pay)
    n_left, hist = pk.split_pass(tp, dst, scal, pk.plan_tensor(plan, "cpu"),
                                 nbw, nbw + 5, with_hist)
    assert n_left == int(rnl)
    assert 0 < n_left < n_l or n_l == 0
    np.testing.assert_array_equal(dst.numpy().view(np.uint32),
                                  np.asarray(rpay))
    assert torch.equal(tp, _port(pay))
    if not with_hist:
        assert hist is None
        return
    # the oracle histograms the smaller child before the partition
    start = s0 if small_l else s0 + n_left
    length = n_left if small_l else n_l - n_left
    bg, bh = _hist_bound(dst.numpy().view(np.uint32), nbw, plan, start,
                         length)
    assert np.all(np.abs(hist[0].numpy() - np.asarray(rg)) <= bg)
    assert np.all(np.abs(hist[1].numpy() - np.asarray(rh)) <= bh)


def _sorted_by_rid(block, nbw):
    return block[:, np.argsort(block[nbw + 1], kind="stable")]


@pytest.mark.parametrize("case", sorted(CASES) + ["left_smaller/no_hist"])
def test_split_pass_plain_matches_pallas_kernel(setup, case):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    case, _, no_hist = case.partition("/")
    f, s0, n_l, thr, dl, small_l, over = CASES[case]
    f = _feature_of_group(ds, f)
    scal = _scalars(pa, f, s0, n_l, thr, dl, small_l, **over)
    kern = jpg.make_split_pass(WPA, NP, G, plan, nbw, C=C, interpret=True,
                               wp_live=nbw + 5, _skip_hist=bool(no_hist))
    kpay, (kg, kh), knl = kern(jnp.asarray(pay), jnp.asarray(scal, jnp.int32))
    kpay = np.asarray(kpay)
    tp, dst = _port(pay), _port(pay)
    n_left, hist = pk.split_pass(tp, dst, scal, pk.plan_tensor(plan, "cpu"),
                                 nbw, nbw + 5, not no_hist)
    assert n_left == (int(knl) if n_l else 0)
    assert torch.equal(tp, _port(pay))
    mine = dst.numpy().view(np.uint32)
    outside = np.ones(NP, bool)
    outside[s0:s0 + n_l] = False
    np.testing.assert_array_equal(kpay[:, outside], mine[:, outside])
    np.testing.assert_array_equal(kpay[:, s0:s0 + n_l][nbw + 5:],
                                  mine[:, s0:s0 + n_l][nbw + 5:])
    for a, b in ((s0, s0 + n_left), (s0 + n_left, s0 + n_l)):
        np.testing.assert_array_equal(_sorted_by_rid(kpay[:, a:b], nbw),
                                      _sorted_by_rid(mine[:, a:b], nbw))
    if n_l == 0 or no_hist:
        assert hist is None or n_l == 0
        return
    start = s0 if small_l else s0 + n_left
    length = n_left if small_l else n_l - n_left
    bg, bh = _hist_bound(mine, nbw, plan, start, length, mxu=True)
    assert np.all(np.abs(hist[0].numpy() - np.asarray(kg)) <= bg)
    assert np.all(np.abs(hist[1].numpy() - np.asarray(kh)) <= bh)


@pytest.mark.parametrize("start,length", [(0, N), (77, 1500), (1201, 513),
                                          (2999, 1)])
def test_seg_hist_plain_matches_pallas_kernel(setup, start, length):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    kern = jpg.make_seg_hist(WPA, NP, G, plan, nbw, C=C, interpret=True)
    kg, kh = kern(jnp.asarray(pay), jnp.int32(start), jnp.int32(length))
    gh, hh = pk.seg_hist(_port(pay), pk.plan_tensor(plan, "cpu"), nbw, start,
                         length)
    bg, bh = _hist_bound(pay, nbw, plan, start, length, mxu=True)
    assert np.all(np.abs(gh.numpy() - np.asarray(kg)) <= bg)
    assert np.all(np.abs(hh.numpy() - np.asarray(kh)) <= bh)


def test_seg_hist_plain_is_hist_window_on_the_same_rows(setup):
    """The payload histogram sums in hist_window's order: on the CPU the
    two are equal bit for bit over the same rows and bins."""
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    tp = _port(pay)
    bins = pk.unpack_group_bins(tp, plan, 0, N).to(torch.uint8).contiguous()
    grad = tp[nbw + 2, :N].view(torch.float32).contiguous()
    hess = tp[nbw + 3, :N].view(torch.float32).contiguous()
    for start, length in ((0, N), (123, 2000)):
        ref = hist_window_plain(bins, grad, hess, start, length, 256)
        gh, hh = pk.seg_hist_plain(tp, pk.plan_tensor(plan, "cpu"), nbw,
                                   start, length)
        assert torch.equal(gh, ref[:, :, 0].reshape(-1))
        assert torch.equal(hh, ref[:, :, 1].reshape(-1))


def test_root_hist_plain_matches_oracles(setup):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    gh, hh, sums = pk.root_hist(_port(pay), pk.plan_tensor(plan, "cpu"), nbw,
                                n)
    bg, bh = _hist_bound(pay, nbw, plan, 0, n)
    (xg, xh), xs = jgp.make_xla_root_hist(WPA, NP, G, plan, nbw, n)(
        jnp.asarray(pay))
    assert np.all(np.abs(gh.numpy() - np.asarray(xg)) <= bg)
    assert np.all(np.abs(hh.numpy() - np.asarray(xh)) <= bh)
    np.testing.assert_array_equal(sums.numpy(), np.asarray(xs))
    (kg, kh), ks = jpg.make_root_hist(WPA, NP, G, plan, nbw, n, C=CR,
                                      interpret=True)(jnp.asarray(pay))
    bg, bh = _hist_bound(pay, nbw, plan, 0, n, mxu=True)
    assert np.all(np.abs(gh.numpy() - np.asarray(kg)) <= bg)
    assert np.all(np.abs(hh.numpy() - np.asarray(kh)) <= bh)
    g = np.abs(pay[nbw + 2, :n].view(np.float32)).sum()
    h = np.abs(pay[nbw + 3, :n].view(np.float32)).sum()
    np.testing.assert_allclose(sums.numpy(), np.asarray(ks), rtol=0,
                               atol=n * EPS32 * max(g, h))


def test_wrappers_refuse_bad_input(setup):
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    tp = _port(pay)
    plan_t = pk.plan_tensor(plan, "cpu")
    from lightgbm_torch.utils.log import LightGBMError
    with pytest.raises(LightGBMError, match="int32"):
        pk.seg_hist(tp.float(), plan_t, nbw, 0, 10)
    with pytest.raises(LightGBMError, match="outside"):
        pk.seg_hist(tp, plan_t, nbw, NP - 5, 10)
    with pytest.raises(LightGBMError, match="scalars"):
        pk.split_pass(tp, tp.clone(), [0] * 3, plan_t, nbw, nbw + 5, False)
    with pytest.raises(LightGBMError, match="bin word"):
        pk.split_pass(tp, tp.clone(), [0, 0, 10, nbw] + [0] * 11, plan_t,
                      nbw, nbw + 5, False)
    meta = tp.to("meta")
    with pytest.raises(LightGBMError, match="no kernel for device meta"):
        pk.seg_hist(meta, plan_t.to("meta"), nbw, 0, 10)
    with pytest.raises(LightGBMError, match="no kernel for device meta"):
        pk.root_hist(meta, plan_t.to("meta"), nbw, n)
    with pytest.raises(LightGBMError, match="no kernel for device meta"):
        pk.split_pass(meta, meta.clone(), [0, 0, 10] + [0] * 12,
                      plan_t.to("meta"), nbw, nbw + 5, False)


@pytest.mark.cuda
def test_cuda_kernels_match_plain_versions(setup):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    ds, ja, pa, pay = setup
    WPA, NP, G, plan, nbw, n, C, CR = _geom(pa)
    cpu, dev = _port(pay), _port(pay).cuda()
    plan_c, plan_d = pk.plan_tensor(plan, "cpu"), pk.plan_tensor(plan, "cuda")
    for a, b in zip(pk.root_hist(cpu, plan_c, nbw, n),
                    pk.root_hist(dev, plan_d, nbw, n)):
        assert torch.equal(a, b.cpu())
    for a, b in zip(pk.seg_hist(cpu, plan_c, nbw, 77, 1500),
                    pk.seg_hist(dev, plan_d, nbw, 77, 1500)):
        assert torch.equal(a, b.cpu())
    for case in sorted(CASES):
        f, s0, n_l, thr, dl, small_l, over = CASES[case]
        scal = _scalars(pa, _feature_of_group(ds, f), s0, n_l, thr, dl,
                        small_l, **over)
        cpu_dst, dev_dst = cpu.clone(), dev.clone()
        na, ha = pk.split_pass(cpu, cpu_dst, scal, plan_c, nbw, nbw + 5, True)
        nb_, hb = pk.split_pass(dev, dev_dst, scal, plan_d, nbw, nbw + 5,
                                True)
        assert na == nb_
        assert torch.equal(cpu_dst, dev_dst.cpu())
        assert torch.equal(cpu, dev.cpu())
        assert torch.equal(ha[0], hb[0].cpu())
        assert torch.equal(ha[1], hb[1].cpu())
