#!/usr/bin/env python3
"""Smoke test of lightgbm_torch on one NVIDIA card (an H100 for the numbers
kept in PERF.md).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. card     the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the five CUDA kernels from csrc/, in parallel;
  3. kernels  each kernel against its plain PyTorch version at the main
              paths' shapes (HIGGS: 28 groups x 255 bins): hist_window and
              scan_pair (the v1 grower), root_hist over all 10.5M payload
              lanes, seg_hist and split_pass on a 1M-lane payload segment
              (the persistent grower). Each is held bit for bit against its
              plain version on the CPU, and two launches must agree; times
              for the kernel, the plain version, one PyTorch library call
              where one computes the same function, and the bound;
  4. train    lightgbm_torch.train on HIGGS-shaped data (10.5M rows x 28
              features, max_bin=255, num_leaves=255, binary) on cuda with the
              default routing, which takes the persistent-payload grower,
              for 10 iterations: launch counts checked against the trees
              grown (root_hist = trees, split_pass = seg_hist = splits,
              scan_pair = trees + splits, hist_window = 0), training logloss
              falling every iteration, the device scores against the numpy
              walk (f32 payload scores: within 2 * (iterations + 1) f32 ulps
              of the largest score), and a model-text round trip;
  5. train v1 the same Dataset with tpu_persist_scan=false for 3
              iterations: hist_window = scan_pair = trees + splits, the
              device scores within 1e-9 of the numpy walk, the round trip;
  6. parity   200k rows x 5 iterations on cuda and on the CPU (the plain
              versions), for the persistent grower (tpu_persist_scan=force)
              and the v1 grower (false): equal tree structure, leaf values
              within rtol 2e-4.

The last lines are a JSON object of per-kernel numbers, the list of
kernels, the card's name and power limit, and the result line
{"ok": true, "device": {...}}. Options scale the run down for a quick check
(--rows, --iters, --v1-iters, --parity-rows, --parity-iters, --skip-train,
--skip-parity); the defaults are the full run. --profile adds a
torch.profiler breakdown of one more iteration of each train phase
(PERF.md's "where the time goes").
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
    log("build: %d kernels (%s) built in %.1f s (nvcc, sm_90a)"
        % (len(build.KERNELS), ", ".join(build.KERNELS), time.time() - t))
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


def _same(name, a, b):
    """Fail unless the tensors (or tuples of tensors) a and b are equal bit
    for bit; returns the max abs difference (0.0)."""
    import torch
    a = a if isinstance(a, (tuple, list)) else (a,)
    b = b if isinstance(b, (tuple, list)) else (b,)
    worst = 0.0
    for x, y_ in zip(a, b):
        x, y_ = x.cpu(), y_.cpu()
        if not torch.equal(x, y_):
            raise AssertionError("%s: differs, max abs diff %.3g" % (
                name, float((x.double() - y_.double()).abs().max())))
        if x.is_floating_point():
            worst = max(worst, float((x - y_).abs().max()) if x.numel()
                        else 0.0)
    return worst


def phase_payload_kernels(inner):
    """root_hist, seg_hist and split_pass against their plain versions at
    the persistent grower's HIGGS shapes; returns their kernel records."""
    import torch
    from lightgbm_torch.ops import payload_kernels as pk
    from lightgbm_torch.ops.payload import build_assets
    dev = torch.device("cuda")
    t = time.time()
    assets = build_assets(inner, inner.metadata.label)
    WPA, NP, G, plan, nbw, n = assets.geometry[:6]
    rng = np.random.default_rng(1)
    host = assets.pay0.view(np.int32)
    host[nbw + 2, :n] = rng.normal(size=n).astype(np.float32).view(np.int32)
    host[nbw + 3, :n] = rng.uniform(0.05, 0.25, n).astype(np.float32) \
        .view(np.int32)
    cpu = torch.from_numpy(host)
    pay = cpu.to(dev)
    plan_c, plan_d = pk.plan_tensor(plan, "cpu"), pk.plan_tensor(plan, dev)
    wp_live = nbw + 5
    log("payload: [%d, %d] int32 (%.2f GB), %d bin words, packed and "
        "uploaded in %.1f s" % (WPA, NP, WPA * NP * 4 / 1e9, nbw,
                                time.time() - t))
    lane_bytes = 4 * nbw + 8             # bin words + grad + hess per lane
    plane_bytes = 2 * G * 256 * 4
    records = []

    def library_hist(start, length):
        """index_add_ over the decoded bins of a segment, built outside the
        timed call (the yardstick of the two histogram kernels)."""
        bins = pk.unpack_group_bins(pay, plan, start, length)
        idx = (bins + torch.arange(G, device=dev)[None, :] * 256).reshape(-1)
        del bins
        gh = pay[nbw + 2:nbw + 4, start:start + length].view(torch.float32)
        vals = gh.t()[:, None, :].expand(-1, G, -1).reshape(-1, 2) \
            .contiguous()
        out = torch.zeros((G * 256, 2), device=dev)
        ms = device_ms(lambda: out.index_add_(0, idx, vals), reps=5,
                       warmup=1)
        del idx, vals, out
        torch.cuda.empty_cache()
        return ms

    # ---- root_hist over all n lanes ---------------------------------------
    k1 = pk.root_hist(pay, plan_d, nbw, n)
    k2 = pk.root_hist(pay, plan_d, nbw, n)
    torch.cuda.synchronize()
    _same("root_hist: two launches", k1, k2)
    err = _same("root_hist vs the plain version on the CPU", k1,
                pk.root_hist_plain(cpu, plan_c, nbw, n))
    ms = device_ms(lambda: pk.root_hist(pay, plan_d, nbw, n), reps=5,
                   warmup=1)
    plain_ms = device_ms(lambda: pk.root_hist_plain(pay, plan_d, nbw, n),
                         reps=3, warmup=1)
    lib_ms = library_hist(0, n)
    b_ms, b_by = bound_ms(n * lane_bytes + plane_bytes + 8, 2.0 * n * G)
    log("root_hist, %d lanes: two launches bit-identical, bit-identical to "
        "the plain version on the CPU (planes and totals); median time per "
        "call: kernel %.3f ms, plain %.3f ms, index_add_ %.3f ms; bound "
        "%.4f ms (%s)" % (n, ms, plain_ms, lib_ms, b_ms, b_by))
    records.append({"name": "root_hist", "route": "cuda",
                    "source": "lightgbm_torch/csrc/root_hist.cu",
                    "replaces": "lightgbm_tpu/ops/pallas_grow.py:944",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms})

    # ---- seg_hist on a 1M-lane segment -------------------------------------
    R = min(1_000_000, n - 777)
    args = (nbw, 777, R)
    k1 = pk.seg_hist(pay, plan_d, *args)
    k2 = pk.seg_hist(pay, plan_d, *args)
    torch.cuda.synchronize()
    _same("seg_hist: two launches", k1, k2)
    err = _same("seg_hist vs the plain version on the CPU", k1,
                pk.seg_hist_plain(cpu, plan_c, *args))
    err = max(err, _same("seg_hist ragged", pk.seg_hist(pay, plan_d, nbw,
                                                         12345, 8191),
                         pk.seg_hist_plain(cpu, plan_c, nbw, 12345, 8191)))
    ms = device_ms(lambda: pk.seg_hist(pay, plan_d, *args))
    plain_ms = device_ms(lambda: pk.seg_hist_plain(pay, plan_d, *args),
                         reps=5)
    lib_ms = library_hist(777, R)
    b_ms, b_by = bound_ms(R * lane_bytes + plane_bytes, 2.0 * R * G)
    log("seg_hist, %d lanes from lane 777: two launches bit-identical, "
        "bit-identical to the plain version on the CPU (and a ragged 8191-"
        "lane segment); median time per call: kernel %.4f ms, plain %.4f "
        "ms, index_add_ %.4f ms; bound %.4f ms (%s)"
        % (R, ms, plain_ms, lib_ms, b_ms, b_by))
    seg_rec = {"name": "seg_hist", "route": "cuda",
               "source": "lightgbm_torch/csrc/seg_hist.cu",
               "replaces": "lightgbm_tpu/ops/pallas_grow.py:866",
               "launches": 0, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}

    # ---- split_pass on a 1M-lane segment -----------------------------------
    f = 0
    col = inner.binned[777:777 + R, int(inner.group_of[f])]
    scal = [0] * pk.N_SCALARS
    scal[pk.S_NCH] = -(-R // assets.geometry[6])
    scal[pk.S_S0], scal[pk.S_NL] = 777, R
    scal[pk.S_WG], scal[pk.S_SH] = (int(assets.dec_word[f]),
                                    int(assets.dec_shift[f]))
    scal[pk.S_MASK], scal[pk.S_NB] = (int(assets.dec_mask[f]),
                                      int(assets.nb[f]))
    scal[pk.S_MT], scal[pk.S_DB] = int(assets.mt[f]), int(assets.db[f])
    scal[pk.S_THR] = int(np.median(col))
    scal[pk.S_DL], scal[pk.S_SMALL_L] = 1, 1
    scal[pk.S_LS], scal[pk.S_LE], scal[pk.S_MF] = (
        int(assets.ls[f]), int(assets.le[f]), int(assets.mf[f]))
    end = 777 + R + 1024                 # the CPU copy covers the segment
    runs = []
    for with_hist in (False, False, True):
        d = pay.clone()
        n_left, hist = pk.split_pass(d, scal, plan_d, nbw, wp_live,
                                     with_hist)
        runs.append((d, n_left, hist))
    torch.cuda.synchronize()
    if runs[0][1] != runs[1][1]:
        raise AssertionError("split_pass: two launches give n_left %d and %d"
                             % (runs[0][1], runs[1][1]))
    _same("split_pass: two launches", runs[0][0], runs[1][0])
    sub = cpu[:, :end].clone()
    p_left, p_hist = pk.split_pass(sub, scal, plan_c, nbw, wp_live, True)
    if p_left != runs[0][1]:
        raise AssertionError("split_pass: n_left %d on the card, %d in the "
                             "plain version" % (runs[0][1], p_left))
    _same("split_pass vs the plain version on the CPU", runs[0][0][:, :end],
          sub)
    _same("split_pass: lanes past the segment", runs[0][0][:, end:],
          pay[:, end:])
    _same("split_pass: in-pass histogram", runs[2][2], p_hist)
    _same("split_pass: payload with the in-pass histogram", runs[2][0],
          runs[0][0])
    del runs, sub
    d = pay.clone()
    ms = device_ms(lambda: pk._launch_split(d, scal, wp_live))
    plain_ms = device_ms(lambda: pk.split_pass_plain(d, scal, plan_d, nbw,
                                                     wp_live, False), reps=5)
    del d
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(2.0 * wp_live * R * 4, float(R))
    log("split_pass, %d lanes from lane 777 (n_left %d): two launches "
        "bit-identical, bit-identical to the plain version on the CPU "
        "(payload, n_left, the in-pass histogram), lanes past the segment "
        "untouched; median time per call: kernel %.4f ms (the partition "
        "launches, without the wrapper's host sync for n_left), plain %.4f "
        "ms, no single PyTorch call computes it; bound %.4f ms (%s)"
        % (R, p_left, ms, plain_ms, b_ms, b_by))
    records.append({"name": "split_pass", "route": "cuda",
                    "source": "lightgbm_torch/csrc/split_pass.cu",
                    "replaces": "lightgbm_tpu/ops/pallas_grow.py:292",
                    "launches": 0, "max_abs_err": 0.0, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": None})
    records.append(seg_rec)
    del pay, cpu, host, assets
    torch.cuda.empty_cache()
    return records


def logloss(y, raw):
    p = np.clip(1.0 / (1.0 + np.exp(-raw)), 1e-15, 1 - 1e-15)
    return float(-np.mean(y * np.log(p) + (1 - y) * np.log(1 - p)))


PATHS = {
    # name: (tpu_persist_scan, kernels the path launches, kernels it must
    # not launch)
    "persist": ("auto", ("root_hist", "split_pass", "seg_hist", "scan_pair"),
                ("hist_window",)),
    "v1": ("false", ("hist_window", "scan_pair"),
           ("root_hist", "split_pass", "seg_hist")),
}


def _wrappers():
    from lightgbm_torch.ops.histogram import hist_window
    from lightgbm_torch.ops.payload_kernels import (root_hist, seg_hist,
                                                    split_pass)
    from lightgbm_torch.ops.scan import scan_pair
    return {"hist_window": hist_window, "scan_pair": scan_pair,
            "root_hist": root_hist, "split_pass": split_pass,
            "seg_hist": seg_hist}


def phase_train(lgb, X, y, ds, iters, card, profile, path):
    """Train on the card along one path; returns the launch counts of the
    run, each wrapper's count set to 0 just before it and read just
    after."""
    import torch
    opt, used, unused = PATHS[path]
    params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
              "verbosity": -1, "tpu_persist_scan": opt}
    wrappers = _wrappers()
    for w in wrappers.values():
        w.launches = 0
    torch.cuda.synchronize()
    t = time.time()
    bst = lgb.train(params, ds, iters)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = {name: w.launches for name, w in wrappers.items()}
    if bst._booster.use_persist != (path == "persist"):
        raise AssertionError("train %s: the learner took the wrong grower "
                             "(use_persist=%s)"
                             % (path, bst._booster.use_persist))
    trees = bst._booster.models
    splits = [t_.num_leaves - 1 for t_ in trees]
    log("train %s: %d rows x %d features, %d trees, leaves per tree %s"
        % (path, X.shape[0], X.shape[1], len(trees), [s + 1 for s in splits]))
    log("train %s: %.3f s per iteration (%.1f s for %d iterations, learner "
        "set-up included) on %s" % (path, wall / iters, wall, iters, card))
    want = {"root_hist": len(trees), "split_pass": sum(splits),
            "seg_hist": sum(splits), "hist_window": sum(1 + s for s in splits),
            "scan_pair": sum(1 + s for s in splits)}
    for name in unused:
        want[name] = 0
    bad = {k: (counts[k], want[k]) for k in want if counts[k] != want[k]}
    if bad or any(counts[k] == 0 for k in used):
        raise AssertionError("train %s: launch counts (got, expected) %s"
                             % (path, bad))
    log("train %s: launches %s (trees %d, splits %d)"
        % (path, counts, len(trees), sum(splits)))
    raw = np.zeros(X.shape[0])
    losses = []
    for i in range(len(trees)):
        raw += bst.predict(X, raw_score=True, start_iteration=i,
                           num_iteration=1)
        losses.append(logloss(y, raw))
    log("train %s: logloss per iteration %s"
        % (path, ["%.6f" % v for v in losses]))
    if not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("training logloss does not fall monotonically")
    dev_score = bst._booster.train_score.score.cpu().numpy()
    gap = float(np.abs(dev_score - raw).max())
    # v1 keeps f64 scores; the payload keeps f32 scores, each iteration
    # adding one rounded f32 product to a rounded f32 sum
    tol = (1e-9 if path == "v1" else
           2 * (len(trees) + 1) * 1.1920929e-07 * max(1.0, np.abs(raw).max()))
    log("train %s: device scores vs numpy walk, max abs diff %.3g (limit "
        "%.3g)" % (path, gap, tol))
    if not gap <= tol:
        raise AssertionError("device training scores disagree with predict")
    sub = X[:200_000]
    again = lgb.Booster(model_str=bst.model_to_string())
    if not np.array_equal(again.predict(sub, raw_score=True), raw[:200_000]):
        raise AssertionError("model text round trip changes predictions")
    log("train %s: model_to_string -> Booster(model_str) predicts identical "
        "raw scores" % path)
    if profile:
        phase_profile(bst, card, path)
    del bst
    torch.cuda.empty_cache()
    return counts


def phase_profile(bst, card, path):
    """One more boosting iteration timed on the host clock, then another
    under torch.profiler: device time by kernel, and the device's idle
    share of the unprofiled iteration's wall time. The profiler's count of
    the path's histogram kernels is printed beside the wrappers' launch
    count, since a window that lost events would understate the busy
    time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.time()
    bst.update()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    wrappers = _wrappers()
    names, kernel = ((("root_hist", "seg_hist"), "payload_hist_partial")
                     if path == "persist"
                     else (("hist_window",), "hist_window_partial"))
    before = sum(wrappers[k].launches for k in names)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        bst.update()
        torch.cuda.synchronize()
    rows = _device_events(prof)
    seen = sum(n for _, n, key in rows if key.startswith(kernel))
    busy = sum(r[0] for r in rows)
    log("profile %s: one iteration %.1f ms wall (unprofiled), device busy "
        "%.1f ms (profiled iteration; profiler saw %d %s kernels for %d %s "
        "launches), idle share %.3f (%s)"
        % (path, wall_ms, busy, seen, kernel,
           sum(wrappers[k].launches for k in names) - before,
           " + ".join(names), 1 - busy / wall_ms, card))
    for ms, n, key in rows[:12]:
        log("profile %s:   %9.2f ms  %6d calls  %s" % (path, ms, n, key[:90]))


def phase_parity(lgb, make_higgs_like, rows, iters):
    """Each grower on cuda and on the CPU grows the same trees."""
    X, y = make_higgs_like(rows, seed=11)
    for path, opt in (("persist", "force"), ("v1", "false")):
        params = {"objective": "binary", "num_leaves": 255, "max_bin": 255,
                  "verbosity": -1, "tpu_persist_scan": opt}
        out = {}
        for dev in ("cuda", "cpu"):
            p = dict(params, device_type=dev)
            t = time.time()
            bst = lgb.train(p, lgb.Dataset(X, y, params=p), iters)
            if bst._booster.use_persist != (path == "persist"):
                raise AssertionError("parity %s: wrong grower on %s"
                                     % (path, dev))
            out[dev] = bst._booster.models
            log("parity %s: %s trained %d trees in %.1f s"
                % (path, dev, len(out[dev]), time.time() - t))
        a, b = out["cuda"], out["cpu"]
        if len(a) != len(b):
            raise AssertionError("parity %s: %d trees on cuda, %d on cpu"
                                 % (path, len(a), len(b)))
        worst = 0.0
        for i, (ta, tb) in enumerate(zip(a, b)):
            k = ta.num_leaves - 1
            if ta.num_leaves != tb.num_leaves or not (
                    np.array_equal(ta.split_feature[:k], tb.split_feature[:k])
                    and np.array_equal(ta.threshold_in_bin[:k],
                                       tb.threshold_in_bin[:k])
                    and np.array_equal(ta.decision_type[:k],
                                       tb.decision_type[:k])
                    and np.array_equal(ta.left_child[:k], tb.left_child[:k])
                    and np.array_equal(ta.right_child[:k],
                                       tb.right_child[:k])
                    and np.array_equal(ta.leaf_count[:k + 1],
                                       tb.leaf_count[:k + 1])):
                raise AssertionError("parity %s: tree %d differs in "
                                     "structure" % (path, i))
            np.testing.assert_allclose(ta.leaf_value[:k + 1],
                                       tb.leaf_value[:k + 1], rtol=2e-4,
                                       atol=1e-12)
            worst = max(worst, float(np.max(
                np.abs(ta.leaf_value[:k + 1] - tb.leaf_value[:k + 1])
                / np.maximum(np.abs(tb.leaf_value[:k + 1]), 1e-300))))
        log("parity %s: %d rows x %d iterations: tree structure equal on cuda "
            "and cpu, leaf values max rel diff %.3g"
            % (path, rows, iters, worst))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--iters", type=int, default=10,
                    help="iterations of the persistent-grower train phase")
    ap.add_argument("--v1-iters", type=int, default=3,
                    help="iterations of the v1-grower train phase")
    ap.add_argument("--parity-rows", type=int, default=200_000)
    ap.add_argument("--parity-iters", type=int, default=5)
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="after each train phase, profile one more iteration")
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
    kernels += phase_payload_kernels(inner)
    if not args.skip_train:
        persist = phase_train(lgb, X, y, ds, args.iters, card, args.profile,
                              "persist")
        v1 = phase_train(lgb, X, y, ds, args.v1_iters, card, args.profile,
                         "v1")
        # each kernel's count from the run of the path it serves: the
        # persistent grower's (this slice's main path) for scan_pair and the
        # payload kernels, the v1 grower's for hist_window
        for rec in kernels:
            rec["launches"] = (v1 if rec["name"] == "hist_window"
                               else persist)[rec["name"]]
    del X, y, ds, inner
    if not args.skip_parity:
        phase_parity(lgb, make_higgs_like, args.parity_rows,
                     args.parity_iters)
    print(json.dumps({"kernels": kernels}), flush=True)
    print("kernels: " + ", ".join(k["name"] for k in kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
