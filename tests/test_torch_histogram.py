"""hist_window: the port's plain version against the JAX package's kernel.

The same bins and values, made with numpy from a seed, go through
``lightgbm_torch.ops.histogram.hist_window_plain`` (plain PyTorch, f32
index_add_) and the JAX package's ``hist_window``: run as its own tests run
it on the CPU, the Pallas kernel in interpret mode (bf16 hi/lo split on the
one-hot contraction), and the XLA einsum ``hist_window_xla`` (f32).

Tolerances are per bin, relative to the sum of |values| that land in it:
  * 1e-6 against the f32 einsum: both sum f32 values in some order, so
    each differs from the exact sum by a few f32 ulps of that magnitude;
  * 3e-5 against the hi/lo kernel: x - bf16(x) is exact, but rounding the
    low part to bf16 again leaves up to 2^-16 relative of each value.

The CUDA kernel sums every bin as one f32 chain in row order within fixed
row blocks, then adds the blocks in order: what the plain version computes
on the CPU. It is held to the plain version bit for bit on the card (the
``cuda``-marked test below, and chip_smoke.py).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lightgbm_tpu.ops.pallas_histogram import hist_window as jax_hist_window
from lightgbm_tpu.ops.pallas_histogram import hist_window_xla
from lightgbm_torch.ops.histogram import (hist_window, hist_window_plain,
                                          row_blocks)
from lightgbm_torch.utils.log import LightGBMError


def _inputs(rows, G, w, seed):
    rng = np.random.default_rng(seed)
    bins = rng.integers(0, w, size=(rows, G)).astype(np.uint8)
    # a few hot bins, as real features have
    bins[rng.random((rows, G)) < 0.3] = 0
    grad = rng.normal(size=rows).astype(np.float32)
    hess = rng.uniform(0.01, 0.25, size=rows).astype(np.float32)
    return bins, grad, hess


def _abs_scale(bins, grad, hess, w):
    """[G, w, 2] float64 sum of |values| per bin."""
    G = bins.shape[1]
    out = np.zeros((G, w, 2))
    for g in range(G):
        out[g, :, 0] = np.bincount(bins[:, g], np.abs(grad), minlength=w)[:w]
        out[g, :, 1] = np.bincount(bins[:, g], np.abs(hess), minlength=w)[:w]
    return out


def _port(bins, grad, hess, start, length, w):
    return hist_window_plain(torch.as_tensor(bins), torch.as_tensor(grad),
                             torch.as_tensor(hess), start, length, w).numpy()


# (rows, groups, width): direct one-hot geometry (w <= 64), radix-16
# geometry (64 < w <= 256), and ragged row counts for both
GEOMS = [(3000, 5, 40), (2048, 8, 63), (1037, 3, 17),
         (2500, 6, 200), (1999, 4, 255), (777, 2, 96)]


@pytest.mark.parametrize("rows,G,w", GEOMS)
def test_plain_matches_jax_xla_einsum(rows, G, w):
    bins, grad, hess = _inputs(rows, G, w, seed=rows)
    ref = np.asarray(hist_window_xla(jnp.asarray(bins.astype(np.int32)),
                                     jnp.asarray(grad), jnp.asarray(hess), w))
    got = _port(bins, grad, hess, 0, rows, w)
    scale = _abs_scale(bins, grad, hess, w)
    assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-30)


@pytest.mark.parametrize("rows,G,w", GEOMS)
def test_plain_matches_jax_pallas_interpret(rows, G, w):
    bins, grad, hess = _inputs(rows, G, w, seed=rows + 1)
    ref = np.asarray(jax_hist_window(
        jnp.asarray(bins.T.astype(np.int32)), jnp.asarray(grad),
        jnp.asarray(hess), w, interpret=True))
    got = _port(bins, grad, hess, 0, rows, w)
    scale = _abs_scale(bins, grad, hess, w)
    assert np.all(np.abs(got - ref) <= 3e-5 * scale + 1e-30)


def test_segment_is_the_window_of_the_payload():
    """[start, start + length) of a larger payload equals the JAX kernel on
    that window alone (the grower's calling convention)."""
    bins, grad, hess = _inputs(5000, 6, 63, seed=9)
    start, length = 1234, 2021
    sl = slice(start, start + length)
    ref = np.asarray(hist_window_xla(
        jnp.asarray(bins[sl].astype(np.int32)), jnp.asarray(grad[sl]),
        jnp.asarray(hess[sl]), 63))
    got = _port(bins, grad, hess, start, length, 63)
    scale = _abs_scale(bins[sl], grad[sl], hess[sl], 63)
    assert np.all(np.abs(got - ref) <= 1e-6 * scale + 1e-30)
    empty = _port(bins, grad, hess, start, 0, 63)
    assert empty.shape == (6, 63, 2) and not empty.any()


def test_wrapper_takes_plain_version_on_cpu():
    bins, grad, hess = _inputs(1500, 4, 50, seed=5)
    t = [torch.as_tensor(a) for a in (bins, grad, hess)]
    before = hist_window.launches
    got = hist_window(*t, 100, 1300, 50)
    assert hist_window.launches == before      # no kernel launch on the CPU
    np.testing.assert_array_equal(got.numpy(),
                                  _port(bins, grad, hess, 100, 1300, 50))


@pytest.mark.parametrize("bad", ["dtype", "shape", "device", "range"])
def test_wrapper_refuses_bad_inputs(bad):
    bins, grad, hess = (torch.as_tensor(a) for a in _inputs(100, 3, 20, 1))
    args = [bins, grad, hess, 0, 100, 20]
    if bad == "dtype":
        args[0] = bins.to(torch.int32)
    elif bad == "shape":
        args[1] = grad[:50]
    elif bad == "device":
        args = [a.to("meta") if isinstance(a, torch.Tensor) else a
                for a in args]
    else:
        args[4] = 101
    with pytest.raises(LightGBMError):
        hist_window(*args)


@pytest.mark.parametrize("rows,G,w,start", [(2000, 5, 63, 0),
                                             (3001, 3, 255, 17),
                                             (500, 7, 2, 499),
                                             (40_000, 2, 31, 5)])
def test_plain_sums_row_blocks_in_order(rows, G, w, start):
    """The arithmetic the CUDA kernel reproduces bit for bit: within each
    row block every bin is 0 + v[r1] + v[r2] + ... in f32, rows in order
    (np.add.at is that unbuffered sequential loop), and the blocks' sums
    are added in block order."""
    bins, grad, hess = _inputs(rows, G, w, seed=G)
    length = rows - start
    nblocks, per = row_blocks(length, G)
    assert (nblocks > 1) == (rows == 40_000)
    ref = None
    for b in range(nblocks):
        lo = start + b * per
        hi = min(start + length, lo + per)
        part = np.zeros((G, w, 2), np.float32)
        for g in range(G):
            col = bins[lo:hi, g].astype(np.int64)
            np.add.at(part[g, :, 0], col, grad[lo:hi])
            np.add.at(part[g, :, 1], col, hess[lo:hi])
        ref = part if ref is None else ref + part
    got = _port(bins, grad, hess, start, length, w)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("G,length", [(28, 10_500_000), (28, 16_384),
                                      (28, 0), (7, 4000), (1, 3_000_000)])
def test_row_blocks_cover_the_segment(G, length):
    """Row blocks tile the segment exactly, depend on its length only, and
    give the card about four blocks per SM at the HIGGS root."""
    nblocks, per = row_blocks(length, G)
    assert nblocks >= 1 and per >= 16_384
    assert (nblocks - 1) * per < max(length, 1) <= nblocks * per or length == 0
    if length == 10_500_000:
        assert 500 <= nblocks * G <= 560


@pytest.mark.cuda
def test_cuda_kernel_matches_plain_and_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernel has no CPU mode)")
    bins, grad, hess = _inputs(300_001, 28, 255, seed=2)
    t = [torch.as_tensor(a, device="cuda") for a in (bins, grad, hess)]
    k1 = hist_window(*t, 17, 300_000, 255)
    k2 = hist_window(*t, 17, 300_000, 255)
    assert torch.equal(k1, k2)
    np.testing.assert_array_equal(k1.cpu().numpy(),
                                  _port(bins, grad, hess, 17, 300_000, 255))
