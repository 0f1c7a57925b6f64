#!/usr/bin/env python3
"""Smoke test of lightgbm_torch on one NVIDIA card (an H100 for the numbers
kept in PERF.md).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. card    the card's name and power limit (nvidia-smi);
  2. build   nvcc builds both CUDA kernels from csrc/, in parallel;
  3. kernels each kernel against its plain PyTorch version on the card at
             the main path's shapes (HIGGS bins: 28 groups x 255 bins), with
             times for the kernel, the plain version, one PyTorch library
             call where one computes the same function, and the bound;
  4. train   lightgbm_torch.train on HIGGS-shaped data (10.5M rows x 28
             features, max_bin=255, num_leaves=255, binary, 10 iterations)
             on cuda, with launch counts checked against the trees grown,
             falling training logloss, the device scores against the numpy
             walk, and a model-text round trip;
  5. parity  200k rows x 5 iterations on cuda and on the CPU (the plain
             versions): equal tree structure, leaf values within rtol 2e-4.

The last lines are a JSON object of per-kernel numbers, the list of
kernels, and the result line {"ok": true, "device": {...}}. Options scale
the run down for a quick check (--rows, --iters, --parity-rows,
--skip-train, --skip-parity); the defaults are the full run. --profile adds
a torch.profiler breakdown of one more iteration (PERF.md's "where the time
goes").
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_OPS_PER_S = 67e12      # f32 outside the tensor cores
T0 = time.time()


def log(msg: str) -> None:
    print("[%7.1fs] %s" % (time.time() - T0, msg), flush=True)


def _device_events(prof):
    """(device ms, calls, name) of every kernel and copy the card ran."""
    out = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            out.append((us / 1e3, ev.count, ev.key))
    return sorted(out, reverse=True)


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median time of one call of fn on the card's clock: CUDA events
    recorded between `reps` back-to-back calls, all queued behind a sleep
    kernel so that the host's launch time opens no gap between them
    (except where fn itself waits for the card, as the plain versions'
    boolean masks do)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(200_000_000)      # ~0.1 s of cycles: the queue fills
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(reps)]))


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / H100_F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(out, flush=True)
    return out


def phase_build() -> None:
    from lightgbm_torch.ops import build
    t = time.time()
    build.build()
    log("build: both kernels built in %.1f s (nvcc, sm_90a)"
        % (time.time() - t))
    for name in build.KERNELS:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "bytes stack" in line:
                log("ptxas %s: %s" % (name, line.strip()))


def check_hist(bins, grad, hess, start, length, w, label):
    """Kernel vs plain version: bit for bit against the plain version on
    the CPU (the same f32 chain per bin), and against the plain version on
    the card (index_add_ with atomics, so another order) within the
    recursive-summation bound: a bin summed from n rows in any order is
    within (n - 1) * eps32 * sum|v| of the exact sum, so two orders differ
    by at most twice that. Returns the max abs error vs the CPU."""
    import torch
    from lightgbm_torch.ops.histogram import hist_window, hist_window_plain
    k1 = hist_window(bins, grad, hess, start, length, w)
    k2 = hist_window(bins, grad, hess, start, length, w)
    torch.cuda.synchronize()
    if not torch.equal(k1, k2):
        raise AssertionError("hist_window %s: two launches differ" % label)
    cpu = [t.cpu() for t in (bins, grad, hess)]
    p_cpu = hist_window_plain(*cpu, start, length, w)
    err_cpu = float((k1.cpu() - p_cpu).abs().max())
    if not torch.equal(k1.cpu(), p_cpu):
        raise AssertionError("hist_window %s: differs from the plain version "
                             "on the CPU by up to %.3g" % (label, err_cpu))
    p = hist_window_plain(bins, grad, hess, start, length, w)
    scale = hist_window_plain(bins, grad.abs(), hess.abs(), start, length, w)
    ones = torch.ones_like(grad)
    n = hist_window_plain(bins, ones, ones, start, length, w)
    err = (k1 - p).abs()
    bad = err > 2 * (n - 1).clamp_min(0) * 1.1920929e-07 * scale
    if bool(bad.any()):
        raise AssertionError("hist_window %s: %d cells off the plain version "
                             "on the card, worst %.3g" % (label, int(bad.sum()),
                                                          float(err.max())))
    log("hist_window %s: rows=%d G=%d W=%d; two launches bit-identical; "
        "bit-identical to the plain version on the CPU; vs the plain version "
        "on the card max abs err %.3g (within the summation bound)"
        % (label, length, bins.shape[1], w, float(err.max())))
    return err_cpu


def phase_kernels(binned: np.ndarray, meta, gc, params):
    """Both kernels against their plain versions at the main path's
    shapes; returns the kernel records for the JSON line (launches filled
    in by the train phase)."""
    import torch
    from lightgbm_torch.ops.histogram import hist_window, hist_window_plain
    from lightgbm_torch.ops.scan import (ScanLayout, pair_scalars, scan_pair,
                                         scan_pair_plain)
    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    R = min(1_000_000, binned.shape[0])
    bins = torch.as_tensor(np.ascontiguousarray(binned[:R]), device=dev)
    grad = torch.as_tensor(rng.normal(size=R).astype(np.float32), device=dev)
    hess = torch.as_tensor(rng.uniform(0.05, 0.25, size=R).astype(np.float32),
                           device=dev)
    G, W = bins.shape[1], gc.hist_width
    err_h = check_hist(bins, grad, hess, 0, R, W, "%d rows" % R)
    err_r = check_hist(bins, grad, hess, 12345, 8191, W, "ragged")

    ms = device_ms(lambda: hist_window(bins, grad, hess, 0, R, W))
    plain_ms = device_ms(lambda: hist_window_plain(bins, grad, hess, 0, R,
                                                   W), reps=5)
    # the library yardstick: one index_add_ over the flattened (group, bin)
    # index, built outside the timed call
    idx = (bins.long() + torch.arange(G, device=dev)[None, :] * W).reshape(-1)
    vals = torch.stack([grad, hess], 1)[:, None, :].expand(-1, G, -1) \
        .reshape(-1, 2).contiguous()
    lib_out = torch.zeros((G * W, 2), device=dev)
    library_ms = device_ms(lambda: lib_out.index_add_(0, idx, vals))
    b_ms, b_by = bound_ms(R * (G + 8) + G * W * 8, 2.0 * R * G)
    log("hist_window %d rows, median time per call: kernel %.4f ms, "
        "plain %.4f ms, index_add_ %.4f ms; bound %.4f ms (%s)"
        % (R, ms, plain_ms, library_ms, b_ms, b_by))
    del idx, vals, lib_out
    N = binned.shape[0]
    if N > R:
        # the main path's largest call: the root histogram over every row
        full = torch.as_tensor(binned, device=dev)
        gf = torch.as_tensor(rng.normal(size=N).astype(np.float32),
                             device=dev)
        root_ms = device_ms(lambda: hist_window(full, gf, gf, 0, N, W),
                            reps=5, warmup=1)
        log("hist_window root, %d rows: kernel %.3f ms (median per call), "
            "bound %.3f ms"
            % (N, root_ms, bound_ms(N * (G + 8) + G * W * 8, 2.0 * N * G)[0]))
        del full, gf

    # ---- scan_pair at B=2 on real child histograms --------------------
    layout = ScanLayout(meta.bin_start, meta.bin_end, meta.missing_type,
                        meta.default_bin, meta.penalty,
                        np.ones(gc.num_features, bool), gc.scan_width,
                        gc.total_bins, dev)
    from lightgbm_torch.ops.grow import tb_source_index
    src = tb_source_index(meta.group_offset, gc.total_bins, W, dev)
    half = R // 3
    kids = [hist_window(bins, grad, hess, 0, half, W),
            hist_window(bins, grad, hess, half, R - half, W)]
    hists = torch.stack([k.reshape(G * W, 2)[src] for k in kids])  # [2,TB,2]
    gb = hists[:, :, 0][:, layout.gidx].contiguous()
    hb = hists[:, :, 1][:, layout.gidx].contiguous()
    sums = hists.sum(dim=1) / G                     # every row in each group
    scal = torch.as_tensor(pair_scalars(
        sums[:, 0].cpu().numpy(), sums[:, 1].cpu().numpy(), [half, R - half],
        params.lambda_l2, params.min_gain_to_split, params.min_data_in_leaf,
        params.min_sum_hessian_in_leaf), device=dev)
    args = (scal, gb, hb, layout.keep_r, layout.keep_f, layout.valid_r,
            layout.valid_f, layout.aux)
    k = scan_pair(*args)
    p = scan_pair_plain(*args)
    torch.cuda.synchronize()
    k_np, p_np = k.cpu().numpy(), p.cpu().numpy()
    p_cpu = scan_pair_plain(*[a.cpu() for a in args]).numpy()
    if not np.array_equal(k_np, p_cpu):
        raise AssertionError("scan_pair: differs from the plain version on "
                             "the CPU")
    F = gc.num_features
    for row, name in ((1, "threshold"), (2, "use_f"), (6, "has")):
        if not np.array_equal(k_np[:, row, :F], p_np[:, row, :F]):
            raise AssertionError("scan_pair: %s differs from the plain "
                                 "version" % name)
    fin = np.isfinite(p_np[:, 0, :F])
    if not np.array_equal(fin, np.isfinite(k_np[:, 0, :F])):
        raise AssertionError("scan_pair: finite gains differ")
    np.testing.assert_allclose(k_np[:, 0, :F][fin], p_np[:, 0, :F][fin],
                               rtol=1e-5, atol=1e-5)
    has = p_np[:, 6, :F] > 0.5
    for row in (3, 4, 5):
        np.testing.assert_allclose(k_np[:, row, :F][has], p_np[:, row, :F][has],
                                   rtol=1e-5, atol=1e-3)
    err_card = float(np.abs(k_np[:, 0, :F][fin]
                            - p_np[:, 0, :F][fin]).max()) if fin.any() else 0.0
    err_s = float(np.nanmax(np.abs(np.where(np.isfinite(k_np), k_np, 0)
                                   - np.where(np.isfinite(p_cpu), p_cpu, 0))))
    log("scan_pair B=2 F=%d Wp=%d: bit-identical to the plain version on the "
        "CPU; vs the plain version on the card thresholds/directions/has "
        "exact, %d finite gains within rtol 1e-5 (max abs err %.3g)"
        % (F, layout.Wp, int(fin.sum()), err_card))
    s_ms = device_ms(lambda: scan_pair(*args))
    s_plain = device_ms(lambda: scan_pair_plain(*args), reps=20)
    in_bytes = sum(t.numel() * 4 for t in args) + k.numel() * 4
    s_bound, s_by = bound_ms(in_bytes, 40.0 * gb.numel())
    log("scan_pair, median time per call: kernel %.4f ms, plain "
        "%.4f ms, no single PyTorch call computes it; bound %.6f ms (%s)"
        % (s_ms, s_plain, s_bound, s_by))
    return [
        {"name": "hist_window", "route": "cuda",
         "source": "lightgbm_torch/csrc/hist_window.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:170",
         "launches": 0, "max_abs_err": max(err_h, err_r), "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": library_ms},
        {"name": "scan_pair", "route": "cuda",
         "source": "lightgbm_torch/csrc/scan_pair.cu",
         "replaces": "lightgbm_tpu/ops/pallas_scan.py:262",
         "launches": 0, "max_abs_err": err_s, "ms": s_ms,
         "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
         "library_ms": None},
    ]


def logloss(y, raw):
    p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


def phase_train(lgb, X, y, ds, iters, card, profile):
    import torch
    from lightgbm_torch.ops.histogram import hist_window
    from lightgbm_torch.ops.scan import scan_pair
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbosity": -1}
    hist_window.launches = 0
    scan_pair.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    bst = lgb.train(params, ds, iters)
    torch.cuda.synchronize()
    wall = time.time() - t
    h_launch, s_launch = hist_window.launches, scan_pair.launches
    trees = bst._booster.models
    splits = [t_.num_leaves - 1 for t_ in trees]
    log("train: %d rows x %d features, %d trees, leaves per tree %s"
        % (X.shape[0], X.shape[1], len(trees), [s + 1 for s in splits]))
    log("train: %.3f s per iteration (%.1f s for %d iterations, learner "
        "set-up included) on %s" % (wall / iters, wall, iters, card))
    want = sum(1 + s for s in splits)
    if h_launch != want or s_launch != want or h_launch == 0:
        raise AssertionError(
            "launch counts: hist_window %d, scan_pair %d, expected %d each "
            "(1 + splits per tree)" % (h_launch, s_launch, want))
    log("train: hist_window launched %d times, scan_pair %d times (= trees "
        "+ splits)" % (h_launch, s_launch))
    # training logloss after each iteration, from per-tree numpy walks
    raw = np.zeros(X.shape[0])
    losses = []
    for i in range(len(trees)):
        raw += bst.predict(X, raw_score=True, start_iteration=i,
                           num_iteration=1)
        losses.append(logloss(y, raw))
    log("train: logloss per iteration %s" % ["%.6f" % v for v in losses])
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("training logloss does not fall monotonically")
    dev_score = bst._booster.train_score.score.cpu().numpy()
    gap = float(np.abs(dev_score - raw).max())
    log("train: device scores vs numpy walk, max abs diff %.3g" % gap)
    if gap > 1e-9:
        raise AssertionError("device training scores disagree with predict")
    sub = X[:200_000]
    again = lgb.Booster(model_str=bst.model_to_string())
    if not np.array_equal(again.predict(sub, raw_score=True), raw[:200_000]):
        raise AssertionError("model text round trip changes predictions")
    log("train: model_to_string -> Booster(model_str) predicts identical "
        "raw scores")
    if profile:
        phase_profile(bst, card)
    return h_launch, s_launch


def phase_profile(bst, card):
    """One more boosting iteration timed on the host clock, then another
    under torch.profiler: device time by kernel, and the device's idle
    share of the unprofiled iteration's wall time. The profiler's count of
    hist_window kernels is printed beside the wrapper's launch count, since
    a window that lost events would understate the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from lightgbm_torch.ops.histogram import hist_window
    torch.cuda.synchronize()
    t = time.time()
    bst.update()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    before = hist_window.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bst.update()
        torch.cuda.synchronize()
    rows = _device_events(prof)
    seen = sum(n for _, n, name in rows
               if name.startswith("hist_window_partial"))
    busy = sum(r[0] for r in rows)
    log("profile: one iteration %.1f ms wall (unprofiled), device busy "
        "%.1f ms (profiled iteration; profiler saw %d of %d hist_window "
        "launches), idle share %.3f (%s)"
        % (wall_ms, busy, seen, hist_window.launches - before,
           1 - busy / wall_ms, card))
    for ms, n, name in rows[:10]:
        log("profile:   %9.2f ms  %6d calls  %s" % (ms, n, name[:90]))


def phase_parity(lgb, make_higgs_like, rows, iters):
    X, y = make_higgs_like(rows, seed=11)
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbosity": -1}
    out = {}
    for dev in ("cuda", "cpu"):
        p = dict(params, device_type=dev)
        t = time.time()
        bst = lgb.train(p, lgb.Dataset(X, y, params=p), iters)
        out[dev] = bst._booster.models
        log("parity: %s trained %d trees in %.1f s"
            % (dev, len(out[dev]), time.time() - t))
    a, b = out["cuda"], out["cpu"]
    if len(a) != len(b):
        raise AssertionError("parity: %d trees on cuda, %d on cpu"
                             % (len(a), len(b)))
    worst = 0.0
    for i, (ta, tb) in enumerate(zip(a, b)):
        k = ta.num_leaves - 1
        if ta.num_leaves != tb.num_leaves or not (
                np.array_equal(ta.split_feature[:k], tb.split_feature[:k])
                and np.array_equal(ta.threshold_in_bin[:k],
                                   tb.threshold_in_bin[:k])
                and np.array_equal(ta.decision_type[:k], tb.decision_type[:k])
                and np.array_equal(ta.left_child[:k], tb.left_child[:k])
                and np.array_equal(ta.right_child[:k], tb.right_child[:k])
                and np.array_equal(ta.leaf_count[:k + 1],
                                   tb.leaf_count[:k + 1])):
            raise AssertionError("parity: tree %d differs in structure" % i)
        np.testing.assert_allclose(ta.leaf_value[:k + 1], tb.leaf_value[:k + 1],
                                   rtol=2e-4, atol=1e-12)
        worst = max(worst, float(np.max(
            np.abs(ta.leaf_value[:k + 1] - tb.leaf_value[:k + 1])
            / np.maximum(np.abs(tb.leaf_value[:k + 1]), 1e-300))))
    log("parity: %d rows x %d iterations: tree structure equal on cuda and "
        "cpu, leaf values max rel diff %.3g" % (rows, iters, worst))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--parity-rows", type=int, default=200_000)
    ap.add_argument("--parity-iters", type=int, default=5)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="after the train phase, profile one more iteration")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_torch as lgb
    from lightgbm_torch.data.synth import make_higgs_like
    from lightgbm_torch.treelearner.serial import feature_meta, grow_config
    from lightgbm_torch.ops.split import SplitParams

    card = phase_card()
    phase_build()

    X, y = make_higgs_like(args.rows)
    log("data: make_higgs_like(%d) -> %s" % (args.rows, X.shape))
    t = time.time()
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbosity": -1}
    ds = lgb.Dataset(X, y, params=params, free_raw_data=False).construct()
    inner = ds._inner
    log("data: binned and uploaded in %.1f s: %d groups, %d total bins, "
        "widest group %d" % (time.time() - t, len(inner.groups),
                             inner.total_bins, int(inner.group_widths().max())))
    cfg = lgb.Config(params)
    kernels = phase_kernels(inner.binned, feature_meta(inner),
                            grow_config(cfg, inner),
                            SplitParams.from_config(cfg))
    if not args.skip_train:
        h, s = phase_train(lgb, X, y, ds, args.iters, card, args.profile)
        kernels[0]["launches"], kernels[1]["launches"] = h, s
    del X, y, ds, inner
    if not args.skip_parity:
        phase_parity(lgb, make_higgs_like, args.parity_rows,
                     args.parity_iters)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("kernels: hist_window, scan_pair", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
