"""The port's bundle-native block scan against the JAX package's.

  * ``build_block_scan_meta`` is the JAX one, exactly: masks, owner and
    has_owner, on a hand-made layout with two bundles and a singleton and
    every missing type.
  * ``scan_blocks_plain`` against JAX ``scan_blocks`` in interpret mode,
    with and without FixHistogram: the same group and lane chosen per child,
    the same direction, and gains and left sums within rtol 1e-4 (atol 1e-5
    for gains, 1e-4 for the sums), the bound of tests/test_block_scan.py.
    The TPU kernel takes its prefix sums as f32 matmuls, the port as
    sequential f64 sums rounded per lane, so the two differ by f32 rounding.
    The data are random normals: no two candidate gains are near-tied.
  * On singleton groups the plain block scan is ``scan_pair_plain`` bit for
    bit: gain, threshold, direction and left sums per feature.
  * The feature-mask fold of :class:`BlockScanLayout`.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops import pallas_scan as jps
from lightgbm_torch.ops import block_scan as bs
from lightgbm_torch.ops.scan import ScanLayout, pair_scalars, scan_pair_plain
from lightgbm_torch.utils.log import LightGBMError

W = 256


def _geometry():
    """3 groups: two EFB bundles (lane 0 is the bundle's sentinel) and one
    singleton; zero / NaN / none / NaN missing types."""
    group_of = np.array([0, 0, 1, 1, 2], np.int32)
    ls = np.array([1, 9, 1, 40, 0], np.int32)
    nb = np.array([8, 23, 39, 2, 63], np.int32)
    mt = np.array([1, 2, 0, 2, 2], np.int32)
    db = np.array([2, 0, 0, 0, 5], np.int32)
    mf = np.array([0, 0, 0, 1, 5], np.int32)
    needs_fix = np.array([True, True, True, True, False])
    penalty = np.array([1.0, 0.8, 1.0, 1.0, 1.2])
    return group_of, ls, nb, mt, db, mf, needs_fix, penalty


def _inputs(seed, meta, G, B=4):
    """Random planes on the owned lanes and the [B, 9] scalars."""
    rng = np.random.default_rng(seed)
    Gp = meta["masks"].shape[1]
    has = meta["has_owner"]
    gb = rng.normal(size=(B, Gp, W)).astype(np.float32) * has
    hb = (rng.random((B, Gp, W)).astype(np.float32) + 0.01) * has
    gb[:, G:] = 0
    hb[:, G:] = 0
    shr = rng.uniform(80, 160, B).astype(np.float32)
    sg = rng.normal(size=B).astype(np.float32)
    cnt = np.round(shr * 4).astype(np.float32)
    scal = pair_scalars(sg, shr, cnt, 0.5, 0.0, 5, 1e-3)
    return np.concatenate([scal, shr[:, None]], axis=1), gb, hb


def test_block_scan_meta_matches_jax():
    group_of, ls, nb, mt, db, mf, needs_fix, penalty = _geometry()
    mine = bs.build_block_scan_meta(group_of, ls, nb, mt, db, mf, needs_fix,
                                    penalty, 3)
    ref = jps.build_block_scan_meta(group_of, ls, nb, mt, db, mf, needs_fix,
                                    penalty, 3, W)
    for key in ("masks", "owner", "has_owner"):
        assert mine[key].dtype == ref[key].dtype
        np.testing.assert_array_equal(mine[key], ref[key], key)
    assert mine["masks"].shape == (bs.BM_ROWS, 8, W)
    assert (bs.BM_KEEP_R, bs.BM_VALID_F, bs.BM_PEN) == (
        jps.BM_KEEP_R, jps.BM_VALID_F, jps.BM_PEN)


@pytest.mark.parametrize("do_fix", [True, False], ids=["fix", "no_fix"])
@pytest.mark.parametrize("seed", [0, 5])
def test_scan_blocks_plain_matches_pallas_kernel(seed, do_fix):
    meta = bs.build_block_scan_meta(*_geometry(), 3)
    scal, gb, hb = _inputs(seed, meta, 3)
    ref = np.asarray(jps.scan_blocks(
        jnp.asarray(scal), jnp.asarray(gb), jnp.asarray(hb),
        jnp.asarray(meta["masks"]), do_fix=do_fix, interpret=True))
    out = bs.scan_blocks(torch.from_numpy(scal), torch.from_numpy(gb),
                         torch.from_numpy(hb),
                         torch.from_numpy(meta["masks"]), do_fix).numpy()
    assert out.shape == ref.shape == (4, 8, 8)
    np.testing.assert_array_equal(np.argmax(out[:, 0], 1),
                                  np.argmax(ref[:, 0], 1))
    fin = np.isfinite(ref[:, 0])
    np.testing.assert_array_equal(np.isfinite(out[:, 0]), fin)
    assert fin[:, :3].sum() >= 10
    for row in (1, 2, 6):             # lane, direction, has
        np.testing.assert_array_equal(out[:, row], ref[:, row])
    np.testing.assert_allclose(out[:, 0][fin], ref[:, 0][fin], rtol=1e-4,
                               atol=1e-5)
    for row in (3, 4, 5):
        np.testing.assert_allclose(out[:, row][fin], ref[:, row][fin],
                                   rtol=1e-4, atol=1e-4)


def test_scan_blocks_fix_moves_the_choice():
    """FixHistogram changes what a bundled feature's most_freq lane holds,
    and with it the scan: the fix and no-fix results differ."""
    meta = bs.build_block_scan_meta(*_geometry(), 3)
    scal, gb, hb = _inputs(1, meta, 3)
    args = (torch.from_numpy(scal), torch.from_numpy(gb),
            torch.from_numpy(hb), torch.from_numpy(meta["masks"]))
    a = bs.scan_blocks_plain(*args, True)
    b = bs.scan_blocks_plain(*args, False)
    assert not torch.equal(a, b)


@pytest.mark.parametrize("seed", [2, 3])
def test_singleton_groups_equal_scan_pair(seed):
    """One feature per group (ls = 0): the block scan's gain, threshold,
    direction and has-split per group are scan_pair_plain's per feature,
    bit for bit, and so are the left sums wherever a split exists (with no
    split the block scan writes zeros there, scan_pair the unused sums)."""
    F = 6
    nb = np.array([63, 30, 2, 255, 17, 40], np.int32)
    mt = np.array([2, 1, 0, 2, 0, 1], np.int32)
    db = np.array([0, 4, 0, 0, 0, 39], np.int32)
    penalty = np.array([1.0, 1.0, 0.5, 1.0, 1.0, 1.0])
    zeros = np.zeros(F, np.int32)
    meta = bs.build_block_scan_meta(np.arange(F), zeros, nb, mt, db, zeros,
                                    np.zeros(F, bool), penalty, F)
    scal, gb, hb = _inputs(seed, meta, F)
    blk = bs.scan_blocks_plain(torch.from_numpy(scal), torch.from_numpy(gb),
                               torch.from_numpy(hb),
                               torch.from_numpy(meta["masks"]), False)
    start = np.arange(F) * W
    layout = ScanLayout(start, start + nb, mt, db, penalty, np.ones(F, bool),
                        W, F * W, "cpu")
    flat_g = torch.from_numpy(gb[:, :F].reshape(len(gb), -1))
    flat_h = torch.from_numpy(hb[:, :F].reshape(len(hb), -1))
    pair = scan_pair_plain(torch.from_numpy(scal[:, :8]),
                           flat_g[:, layout.gidx], flat_h[:, layout.gidx],
                           layout.keep_r, layout.keep_f, layout.valid_r,
                           layout.valid_f, layout.aux)
    assert torch.isfinite(pair[:, 0, :F]).sum() >= 12
    for row in (0, 1, 2, 6):
        assert torch.equal(blk[:, row, :F], pair[:, row, :F]), row
    has = pair[:, 6, :F] > 0
    assert torch.equal(blk[:, 3:6, :F].transpose(1, 2)[has],
                       pair[:, 3:6, :F].transpose(1, 2)[has])


def test_feature_mask_fold():
    """tree_masks multiplies the two valid rows by the owning feature's
    mask bit (grow_persist.py:951-958) and leaves the other rows; a masked
    feature's lanes are never chosen."""
    geo = _geometry()
    group_of, ls, nb, mt, db, mf, needs_fix, penalty = geo
    efb = (group_of, ls, nb, mf, needs_fix, True, mt, db)
    lay = bs.BlockScanLayout(efb, penalty, 3, "cpu")
    meta = bs.build_block_scan_meta(*geo, 3)
    fmask = np.array([True, False, True, True, False])
    masks = lay.tree_masks(fmask).numpy()
    own = np.where(meta["has_owner"], meta["owner"], 0)
    fm_lane = np.where(meta["has_owner"], fmask[own], False)
    want = meta["masks"].copy()
    want[bs.BM_VALID_R:bs.BM_VALID_F + 1] *= fm_lane
    np.testing.assert_array_equal(masks, want)
    np.testing.assert_array_equal(lay.masks.numpy(), meta["masks"])
    scal, gb, hb = _inputs(4, meta, 3)
    out = bs.scan_blocks_plain(torch.from_numpy(scal), torch.from_numpy(gb),
                               torch.from_numpy(hb), torch.from_numpy(masks),
                               True).numpy()
    for b in range(len(out)):
        for g in range(3):
            if out[b, 6, g] > 0:
                assert fmask[own[g, int(out[b, 1, g])]]


def test_wrapper_refuses_bad_input():
    meta = bs.build_block_scan_meta(*_geometry(), 3)
    scal, gb, hb = (torch.from_numpy(a) for a in
                    _inputs(0, meta, 3))
    masks = torch.from_numpy(meta["masks"])
    with pytest.raises(LightGBMError, match="scal"):
        bs.scan_blocks(scal[:, :8].contiguous(), gb, hb, masks, True)
    with pytest.raises(LightGBMError, match="masks"):
        bs.scan_blocks(scal, gb, hb, masks[:7].contiguous(), True)
    with pytest.raises(LightGBMError, match="float32"):
        bs.scan_blocks(scal, gb.double(), hb, masks, True)
    with pytest.raises(LightGBMError, match="no kernel for device meta"):
        bs.scan_blocks(*(t.to("meta") for t in (scal, gb, hb, masks)), True)


@pytest.mark.cuda
def test_cuda_scan_blocks_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    meta = bs.build_block_scan_meta(*_geometry(), 3)
    for do_fix in (True, False):
        args = [torch.from_numpy(a) for a in _inputs(0, meta, 3)]
        args.append(torch.from_numpy(meta["masks"]))
        cpu = bs.scan_blocks(*args, do_fix)
        dev = bs.scan_blocks(*(a.cuda() for a in args), do_fix)
        assert torch.equal(cpu, dev.cpu())
