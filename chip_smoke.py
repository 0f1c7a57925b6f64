#!/usr/bin/env python3
"""Smoke test of lightgbm_torch on one NVIDIA card (an H100 for the numbers
kept in PERF.md).

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each printing its own lines; any failure raises and the script
exits non-zero without printing a result:

  1. card     the card's name and power limit (nvidia-smi);
  2. build    nvcc builds the sixteen CUDA kernel libraries from csrc/, in
              parallel;
  3. kernels  each kernel against its plain PyTorch version at the main
              paths' shapes (HIGGS: 28 groups x 255 bins): hist_window and
              scan_pair (the v1 grower), root_hist over all 10.5M payload
              lanes, seg_hist and split_pass on a 1M-lane payload segment
              from an unaligned lane (the persistent grower), level_pass
              and level_seg_hist on the 10.5M lanes cut into 128 slots as
              at depth 8 (the level phase), scan_pair at B = 256 on the
              level's children. Each is held bit for bit against its plain
              version on the CPU, and two launches must agree. scan_pair's
              knob form (lambda_l1, max_delta_step, finite monotone bounds
              with mixed signs, drawn extra_trees lanes and by-node masks
              from the numpy threefry) likewise at B = 2 and 256, timed
              beside the fast form on the same planes. The scans
              read the grower's histogram planes in place through the
              children's rows (scan_pair also through the layout's gidx),
              in a random order, and are also held equal to their gathered
              form and, at the edge shapes (B = 1, 2, 256 at Wp = 32, 256,
              1024; no valid lane; ties both ways; +inf gains; one-lane
              windows; fix lanes), to their plain versions; the gathered
              sequence (the torch gathers, then the kernel) and an empty
              kernel (the launch floor) are timed beside them, and the
              previous scan design's times printed. The
              partitions write the grower's other buffer (a second buffer
              of random words, or the payload): the source and every lane
              and row of the destination outside the segments must stay
              as they were, and the consolidation (the copy of segments
              from the second buffer back into the payload at the end of a
              tree) is held against its plain version and one copy_ per
              segment. The histogram kernels also run on skewed inputs
              (every lane in one bin, bins >= W, ragged, one-lane and
              zero-length segments; root_hist at the Expo root too).
              root_hist, seg_hist, level_seg_hist and the partitions'
              in-pass histograms share one counting-sort routine, so each
              is also held equal to a witness that does not:
              payload_hist.cuh's ownership routine over the same lanes.
              Times for the kernel, the plain version, one PyTorch library
              call where one computes the same function, the bound, the
              ownership routine for seg_hist (also on small children) and
              level_seg_hist, and, for the level kernels, the 128
              per-split launches they replace. split_pass and seg_hist
              are timed in their device form (scalars and segment in
              device memory, the fixed grids the per-split loop
              launches); split_pass's device form is also held to the host
              form, with the done flag set (nothing written or counted)
              and with the buffer parity flag (second buffer to payload).
              split_pass and the consolidation also run at the
              multiclass payload's width (wp_live 21: 5 score and 5
              snapshot rows), held to their plain versions and timed.
              The grow_step kernels (pick, commit, planes, assemble, the
              consolidation table, the score update) are held bit for bit
              against their plain versions on random mid-tree states at
              the per-split shapes, and timed. valid_walk (the held-out
              scores' tree walk) runs a 255-leaf HIGGS tree over the
              500k held-out HIGGS rows (5% NaN) and an Expo tree over
              200k bundled held-out rows: two launches and the plain
              version on the CPU bit-identical, timed beside its bound.
              At the MSLR shape (make_ltr_like: 137 features in 137
              groups, 31,095 queries of 73 rows): root_hist over 1M
              lanes, seg_hist and split_pass on a 500k-lane segment and
              scan_pair over the 137 features, each against its plain
              version on the CPU bit for bit; the ranking gradient kernels
              lambdarank_grad and xendcg_grad at that shape and on 50k
              rows in variable-length queries up to 1250 rows (past the
              lambda kernel's shared memory), without and with weights:
              two launches equal, bit for bit equal to the plain version
              on the card, equal to the plain version on the CPU (over
              the first 4000 queries) but for at most 1 value in 10^5 one
              f32 ulp off (the card's f64 exp and log2), timed beside the
              plain version and the bound (f64 operations over the card's
              f64 rate, or bytes). The bag step's kernels (csrc/bag.cu) on
              the HIGGS rows (a permutation of the row ids, the labels,
              binary gradients): bag_apply in the fraction (0.8), balanced
              (0.9 / 0.5) and GOSS (0.2 / 0.1) modes and goss_select, two
              launches equal and bit for bit equal to the plain versions
              on the CPU, goss_select's threshold equal to
              torch.kthvalue's, timed beside the plain versions on the
              card, torch.kthvalue and the bounds. DART's and RF's
              forms at the HIGGS payload (phase_dart_rf_kernels):
              valid_walk_payload (a 255-leaf tree walked over the
              training bins of a permuted payload's lanes onto f32
              scores), bag_apply's rows form (a host mask at fraction 0.7)
              and apply_scores_avg (255 segments, t = 5, a bias), two
              launches equal and equal to the plain versions on the card,
              timed beside them and their bounds;
     airline  (after the MSLR phase) on airline-shaped rows (the public
              szilard benchm-ml airline set's shape: 10M rows, categorical
              Month, DayofMonth, DayOfWeek, UniqueCarrier, Origin, Dest and
              numerical DepTime, Distance; data/synth.py:
              make_airline_like): cat_scan on 256 real node histograms
              (hist_window over random row windows of the binned set,
              binary gradients), B = 2 and 256, the sorted and the one-hot
              route, two launches equal and bit for bit equal to the plain
              version on the CPU, timed beside the plain version on the
              card and the bound; valid_walk of an airline tree (its
              categorical nodes walk the inner bitsets) over 1M held-out
              rows;
  4. train    lightgbm_torch.train on HIGGS-shaped data (10.5M rows x 28
              features, max_bin=255) on cuda with the default routing,
              along these paths, each wrapper's launch count set to 0 just
              before and read just after:
              persist  binary, num_leaves=255 (the per-split persistent
                       grower), 10 iterations;
              v1       binary, tpu_persist_scan=false, 3 iterations;
              knobs    binary with every numerical knob at once
                       (KNOB_PARAMS: lambda_l1 and max_delta_step that
                       bind, monotone +1/-1 on four features, extra_trees,
                       feature_fraction_bynode=0.8), default routing (the
                       v1 grower, scan_pair's knob form), 3 iterations, on
                       a Dataset binned with those parameters: every leaf
                       within max_delta_step x the learning rate and at
                       least one on it; the last tree's leaves equal to the
                       leaf math (L1, the clamp, the monotone bounds
                       replayed over its split records) from its rows'
                       gradient sums; a monotonicity sweep of each
                       constrained feature over the model's thresholds on
                       1000 rows; every split's feature in its node's
                       by-node sample and its threshold the node's drawn
                       bin (the numpy threefry replay);
              level    binary, num_leaves=256, max_depth=8 (the level
                       phase), 10 iterations, then 3 with
                       tpu_level_grow=off whose raw predictions must equal
                       the first 3 trees' bit for bit;
              multiclass  objective=multiclass, num_class=5 (upstream
                       examples/multiclass_classification), the labels the
                       quintiles of the latent make_higgs_like thresholds,
                       num_leaves=255, 3 iterations of 5 class trees from
                       one score snapshot (the payload carries 5 score and
                       5 snapshot rows: wp_live 21); its multi_logloss
                       must fall every iteration;
              ltr      (after the Expo phase) objective=lambdarank on the
                       MSLR shape (make_ltr_like: 2,269,935 rows x 137
                       features, labels 0-4, 73-row queries; num_leaves
                       255, lambdarank_truncation_level 30;
                       bench_full.py:101-120), 10 iterations on the
                       per-split persistent grower: its graph gates,
                       lambdarank_grad once per iteration, training
                       NDCG@10 (numpy) after the last iteration above the
                       first's; then the same with the 227k held-out rows
                       of the same make_ltr_like draw, metric=ndcg,
                       eval_at=[1, 3, 5, 10], early_stopping_rounds=5: the
                       valid path's gates, records against numpy's NDCG;
              xendcg   objective=rank_xendcg on the same rows, 3
                       iterations on the v1 grower: xendcg_grad once per
                       iteration, one get_gradients call per iteration,
                       the draws bit-equal to a sequential numpy replay of
                       the reference's LCG, NDCG@10 rising;
              bagging  (after knobs) the persist path with bagging_fraction
                       0.8 and bagging_freq 5 (upstream examples/
                       binary_classification/train.conf), 6 iterations: the
                       bag step in the graph (bag_apply once per tree), each
                       tree's in-bag count equal to the plain count of its
                       window (the row hash on the CPU), equal within a
                       window and different across one; one more iteration
                       eagerly with the bag step's rows and count held to
                       the plain version;
              goss     the persist path with boosting=goss, top_rate 0.2,
                       other_rate 0.1, learning_rate 0.5, 6 iterations:
                       every row in the bag for the first two, then
                       goss_select once per iteration, its threshold on one
                       more (eager) iteration equal to torch.kthvalue's and
                       the weighed rows to the plain version's; both paths'
                       iteration wall, busy and idle share beside the
                       persist path's;
              dart     (after goss) the persist path with boosting=dart,
                       drop_rate 0.3, 8 iterations: each iteration's
                       dropped iterations equal to a plain replay of the
                       numpy Generator at drop_seed (plain_drops), the
                       drop's and the normalize's walks on the payload
                       (valid_walk_payload twice per dropped tree, counted
                       by its wrapper) between the graph's replays, which
                       go on; one tree read per iteration; the walks timed;
              rf       boosting=rf, bagging_fraction 0.7, bagging_freq 1, 8
                       iterations: the host mask uploaded before each
                       iteration, bag_apply's rows form and
                       apply_scores_avg once per tree in the graph, each
                       tree's in-bag count equal to its mask's sum, every
                       iteration's logloss below the constant init score's,
                       the host draw's and the upload's ms; both paths'
                       iteration wall, busy and idle share beside the
                       persist path's;
              regression  objective=regression (L2) on the latent plus
                       Gaussian noise, num_leaves=255, 3 iterations; its L2
                       loss must fall every iteration;
              l1       objective=regression_l1 on the same target, 3
                       iterations: leaf renewal inside the per-split graph
                       (the renew_leaf kernel once per tree); its L1 loss
                       must fall every iteration, and one more iteration's
                       tree must carry, leaf for leaf, the median of its
                       rows' residuals (numpy on the host, over the payload
                       segments' rows); then renew_leaf against its plain
                       version on random segments (ties, -0.0, empty and
                       one-row segments, both clamps, weights) and on that
                       tree's segments over all lanes, timed beside its
                       bound, its plain version, the two stable sorts that
                       order the rows and the grower's whole renewal step;
              valid    the persist path with a 500k-row held-out set
                       (make_higgs_like seed 17, 5% NaN) binned with
                       reference=, valid_sets=[train, valid],
                       metric=[binary_logloss, auc],
                       early_stopping_rounds=5, evals_result: the model
                       text equal to the persist path's, the graph replayed,
                       valid_walk once per tree, one more read (the metric
                       values) and one more upload (the node arrays) per
                       iteration, every record within 1e-12 relative of
                       numpy's metric of predict(num_iteration=i) and of
                       the training scores; wall, busy and idle share of an
                       iteration with its evaluation beside the persist
                       path's;
              api      (after the valid path) on the persist path's
                       Booster: rollback_one_iter (model text equal to the
                       shorter text, payload scores against predict, one
                       more update grows a tree), reset_parameter of
                       num_leaves 63, lambda_l2 1 and min_data_in_leaf 200
                       (the grower rebuilt, a new graph captured, at most
                       63 leaves, the launch counts of its two iterations
                       equal to the trees'), refit on the 500k held-out
                       rows (structures kept, leaf_sums once per tree and
                       held against its plain version on the CPU on the
                       last tree's inputs and on one leaf of every row,
                       timed beside index_add_ and its bound), pickle and
                       deepcopy predicting bit-equal;
              launch counts checked against the trees, splits, level
              programs and per-split splits grown (level programs at most
              max_depth per tree) and, for the consolidation, the trees
              with a leaf at an odd depth (hist_window, level_pass and
              level_seg_hist by their wrappers' counters, every other
              kernel by its device counter, which a CUDA graph's replays
              also advance and a no-op step does not); on the per-split
              path the first iteration runs under
              set_sync_debug_mode("error"), the second is captured as one
              CUDA graph, the later ones must be its replays, and one
              iteration must read the card back exactly once (the
              graph's node count, capture and replay times printed); a
              sha256 of each path's model text; training logloss falling every
              iteration, the device scores against the numpy walk (v1:
              1e-9; f32 payload scores: within 2 * (iterations + 1) f32 ulps
              of the largest score), and a model-text round trip; on the
              payload paths the second buffer's rows (wp_live) and bytes;
              at the default sizes, the persist, v1, level, multiclass,
              regression, l1, bundled, bagging, goss, dart and rf
              digests must equal the ones recorded in PERF.md
              (KNOWN_DIGESTS); bst.predict on the card is the walk kernel
              (csrc/predict.cu), so the checks against the device scores,
              the model text round trip (a Booster read from text, on the
              card) and the level paths' predictions hold it too; on the
              multiclass, dart and rf paths the kernel's raw scores equal
              the numpy walk's (predict_device=cpu) on 100k rows and the
              converted ones (softmax, sigmoid of the average) within
              1e-12;
  4b. predict (bench.py:run_predict:879, run_serving:924) the served
              model: the first --predict-rows (2M) HIGGS rows, binary,
              255 leaves, --predict-iters (100) trees, default routing;
              predict_walk against its plain version on the card over all
              rows, bit for bit, in raw f64, raw f32 and leaf modes, each
              timed beside its bound and the node visits per second; raw
              f64 and the leaves equal to the numpy walk on 200k rows; f32
              within 2 (T + 1) half-ulps of the largest score of f64 on the
              rows whose f32 walk reaches the same leaves (the others, a
              value between a threshold and its f32 rounding, counted and
              at most 1%); then,
              predict_walk's launch count set to 0 just before and read
              just after (it must equal the sync servers' requests plus
              the async servers' batches): BatchServer(256, 65536) over
              --serve-rows (8M) rows of ragged batches (rows/s, staging
              buckets used against max_compiles(): pinned buffers, the
              walk takes each batch unpadded), BatchServer(256, 4096) under
              open-loop Poisson traffic (400 requests at 50 rps: p50,
              p99, queue depth), the run_serving mix (400 requests of 1-64
              rows from 8 client threads over the first 500k rows,
              max_wait_ms 5) through the sync server and AsyncBatchServer
              (rps, vs_sync, p50/p99, coalesce_ratio), and a
              ModelRegistry swapped between the model and its first 50
              iterations every 2 ms under that mix, then a swap and a
              rollback: every served row equal to the kernel's direct
              output (raw) bit for bit. The airline model's walk over its
              1M held-out rows and the bundled Expo model's over its 200k
              (648 raw features) are held to the numpy walk likewise
              (100k and 200k rows);
  5. bundled  the Expo shape (make_expo_like: 8 dense + 640 one-hot
              columns, EFB-bundled into 18 groups; 2M rows), scan_blocks
              against its plain version at B = 256 children read in place
              from their [256, 18 * 256] planes, then the
              bundled train path (num_leaves=256, max_depth=8, 10
              iterations; scan_blocks, no scan_pair) with the same checks
              and 3 iterations with tpu_level_grow=off (split_pass's
              in-pass histogram) bit-equal to the first 3 trees;
  6. parity   cuda against the CPU (the plain versions; the CPU sides
              train in a child process, this script with
              --parity-cpu-worker and no card visible, started with the
              script so that they run while the card's phases do; its
              results are pickled under .cache/chip_smoke/ and its log
              is echoed with "cpu worker |"), 2 iterations (5
              for the DEEP_PARITY paths: binary persist and v1, softmax
              on its three routes, the knobs, fobj), for
              the persistent (force) and v1 (false) growers and the level
              path on 200k HIGGS rows, the bundled path on 100k Expo
              rows, Poisson on the persistent grower (counts of exp(latent
              / 2)), and softmax and one-vs-all (3 classes, 1 iteration)
              on the persistent, level and v1 routes, L1 on the
              persistent and v1 growers, quantile at alpha 0.9 with
              sample weights, MAPE, cross_entropy on labels in [0, 1],
              cross_entropy_lambda with weights and reg_sqrt (the last
              five on the persistent grower; these seven at 63 leaves);
              lambdarank on the persistent and v1 growers and rank_xendcg
              on v1, weighted, on 200k make_ltr_like rows in seeded
              variable-length queries (63 leaves), the v1 grower with each
              numerical knob alone and all five together and a custom
              objective (the binary gradients from the host) on the HIGGS
              rows (63 leaves): equal tree
              structure, equal leaf values and equal model text; then
              early stopping (noisy labels, learning rate 0.5) on the
              persist, v1 and softmax-persist routes and lambdarank on
              ndcg@5 (persist; half the early-stopping rows, in
              variable-length queries): the same best_iteration and trees,
              records within 1e-12 relative, equal model text; and
              bagging (persist and v1), balanced bagging (persist) and
              GOSS (persist and v1) on --bag-parity-rows HIGGS rows, 31
              leaves, 6 iterations; DART and RF (persist and v1) on the
              same rows and DART on the bundled Expo parity rows
              (scan_blocks), 31 leaves, 8 iterations; the Booster API on
              the 200k HIGGS rows at 31 leaves (phase_parity_api):
              rollback then update on the persistent grower, a split key
              reset after one iteration on both growers, refit of the v1
              run's model on half of the rows: model digests equal.

The last lines are a JSON object of per-kernel numbers, the list of
kernels, the card's name and power limit, and the result line
{"ok": true, "device": {...}}. Options scale the run down for a quick check
(--rows, --iters, --v1-iters, --level-iters, --off-iters, --mc-iters,
--reg-iters, --l1-iters, --expo-rows, --parity-rows, --expo-parity-rows,
--parity-iters, --mc-parity-iters, --valid-rows, --expo-valid-rows,
--es-rows, --es-rounds, --ltr-rows, --ltr-valid-rows, --ltr-iters,
--xendcg-iters, --rank-parity-rows, --knob-iters, --deep-parity-iters,
--airline-rows, --airline-iters, --airline-valid-rows, --cat-parity-rows,
--bag-iters, --bag-parity-rows, --predict-rows, --predict-iters,
--serve-rows, --skip-train, --skip-parity); the
defaults are the full run. --profile
adds a torch.profiler breakdown of one more iteration of each train path
(PERF.md's "where the time goes"), with the partition's stages (count,
scan, scatter, consolidation; a copy-back kernel fails the run), the split
scan beside the torch index/gather kernels, the count of device kernels
and copies, and the host time split into Python, launch calls and time
blocked in copies that wait for the card, with the grower steps'
record_function ranges where the iteration runs them eagerly.
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
H100_F64_OPS_PER_S = 34e12      # f64 outside the tensor cores (data sheet)
T0 = time.time()


def log(msg: str) -> None:
    print("[%7.1fs] %s" % (time.time() - T0, msg), flush=True)


def _device_events(prof):
    """(device ms, calls, name) of every kernel and copy the card ran."""
    out = []
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA") \
                or ev.key.startswith("grow::"):   # a range, not a kernel
            continue
        us = getattr(ev, "self_device_time_total",
                     getattr(ev, "self_cuda_time_total", 0))
        if us > 0:
            out.append((us / 1e3, ev.count, ev.key))
    return sorted(out, reverse=True)


def device_ms(fn, reps: int = 20, warmup: int = 3,
              sleep_cycles: int = 200_000_000) -> float:
    """Median time of one call of fn on the card's clock: CUDA events
    recorded between `reps` back-to-back calls, all queued behind a sleep
    kernel so that the host's launch time opens no gap between them
    (except where fn itself waits for the card, as the plain versions'
    boolean masks do). The default sleep, ~0.1 s of cycles, covers the
    queueing of 20 calls; a few quick calls need ~1 ms (2M cycles)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(reps + 1)]
    torch.cuda._sleep(sleep_cycles)     # the queue fills meanwhile
    ev[0].record()
    for i in range(reps):
        fn()
        ev[i + 1].record()
    ev[-1].synchronize()
    return float(np.median([ev[i].elapsed_time(ev[i + 1])
                            for i in range(reps)]))


def bound_ms(nbytes: float, ops: float, f64: bool = False):
    """The least time for `nbytes` moved and `ops` operations (f32, or f64
    with `f64`): (ms, what bounds it)."""
    t_bytes = nbytes / H100_BYTES_PER_S * 1e3
    t_ops = ops / (H100_F64_OPS_PER_S if f64 else H100_F32_OPS_PER_S) * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


# per-call times of the scans' previous design (one block of Wp threads
# per pair, serial prefix sums in shared memory) at the same shapes
# (PERF.md; NVIDIA H100 80GB HBM3, 700.00 W), printed beside this run's
PREVIOUS_MS = {"scan_pair": 0.0125, "scan_pair B=256": 0.1383,
          "scan_blocks": 0.2004}


def launch_floor():
    """One launch of an empty kernel (scan_pair.cu's empty_launch): the
    least a kernel launch costs, timed beside the scans."""
    import ctypes
    import torch
    from lightgbm_torch.ops.build import load
    fn = load("scan_pair").empty_launch
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    if fn(torch.cuda.current_stream().cuda_stream) != 0:
        raise AssertionError("the empty kernel did not launch")


def scan_pair_bound(scal, gb, layout, out):
    """scan_pair's bound: the children's gathered lanes, the layout's
    masks, gidx and scalars read once, the output written once; about 40
    operations per (child, feature, lane)."""
    nbytes = (scal.numel() + 2 * gb.numel() + 4 * layout.keep_r.numel()
              + layout.aux.numel() + out.numel()) * 4 \
        + layout.gidx.numel() * 8
    return bound_ms(nbytes, 40.0 * gb.numel())


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


def library_hist_window(bins, grad, hess, W):
    """The time of one index_add_ computing hist_window over all rows of
    `bins` (the flattened (group, bin) index and the values built outside
    the timed call): hist_window's yardstick."""
    import torch
    G = bins.shape[1]
    idx = (bins.long() + torch.arange(G, device=bins.device)[None, :] * W) \
        .reshape(-1)
    vals = torch.stack([grad, hess], 1)[:, None, :].expand(-1, G, -1) \
        .reshape(-1, 2).contiguous()
    out = torch.zeros((G * W, 2), device=bins.device)
    ms = device_ms(lambda: out.index_add_(0, idx, vals), reps=5, warmup=1)
    del idx, vals, out
    torch.cuda.empty_cache()
    return ms


def phase_kernels(binned: np.ndarray, meta, gc, params):
    """hist_window and scan_pair (both forms) against their plain versions
    at the v1 path's shapes; returns the kernel records for the JSON line
    (launches filled in by the train phase)."""
    import torch
    from lightgbm_torch.ops.histogram import hist_window, hist_window_plain
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
    # skewed inputs: every row in one bin; bins >= W (left out); a ragged
    # segment over several row blocks
    one = torch.full_like(bins, 7)
    err_r = max(err_r, check_hist(one, grad, hess, 0, R, W,
                                  "every row in bin 7"))
    wide = torch.randint(0, 256, bins.shape, dtype=torch.uint8, device=dev)
    err_r = max(err_r, check_hist(wide, grad, hess, 13, R - 20, 40,
                                  "bins >= W=40, ragged over row blocks"))
    del wide

    ms = device_ms(lambda: hist_window(bins, grad, hess, 0, R, W))
    plain_ms = device_ms(lambda: hist_window_plain(bins, grad, hess, 0, R,
                                                   W), reps=5)
    library_ms = library_hist_window(bins, grad, hess, W)
    b_ms, b_by = bound_ms(R * (G + 8) + G * W * 8, 2.0 * R * G)
    log("hist_window %d rows, median time per call: kernel %.4f ms, "
        "plain %.4f ms, index_add_ %.4f ms; bound %.4f ms (%s)"
        % (R, ms, plain_ms, library_ms, b_ms, b_by))
    one_ms = device_ms(lambda: hist_window(one, grad, hess, 0, R, W))
    log("hist_window %d rows, every row in one bin: kernel %.4f ms, "
        "index_add_ %.4f ms; bound %.4f ms" % (
            R, one_ms, library_hist_window(one, grad, hess, W), b_ms))
    del one
    N = binned.shape[0]
    if N > R:
        # the main path's largest call: the root histogram over every row
        full = torch.as_tensor(binned, device=dev)
        gf = torch.as_tensor(rng.normal(size=N).astype(np.float32),
                             device=dev)
        _same("hist_window root, %d rows: two launches" % N,
              hist_window(full, gf, gf, 0, N, W),
              hist_window(full, gf, gf, 0, N, W))
        root_ms = device_ms(lambda: hist_window(full, gf, gf, 0, N, W),
                            reps=5, warmup=1)
        root_lib = library_hist_window(full, gf, gf, W)
        log("hist_window root, %d rows: kernel %.3f ms (median per call), "
            "index_add_ %.3f ms; bound %.3f ms"
            % (N, root_ms, root_lib,
               bound_ms(N * (G + 8) + G * W * 8, 2.0 * N * G)[0]))
        full.fill_(7)
        log("hist_window root, %d rows, every row in one bin: kernel %.3f "
            "ms, index_add_ %.3f ms" % (
                N, device_ms(lambda: hist_window(full, gf, gf, 0, N, W),
                             reps=5, warmup=1),
                library_hist_window(full, gf, gf, W)))
        del full, gf
        torch.cuda.empty_cache()

    return [
        {"name": "hist_window", "route": "cuda",
         "source": "lightgbm_torch/csrc/hist_window.cu",
         "replaces": "lightgbm_tpu/ops/pallas_histogram.py:170",
         "launches": 0, "max_abs_err": max(err_h, err_r), "ms": ms,
         "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
         "library_ms": library_ms},
        check_scan_pair(bins, grad, hess, R, meta, gc, params),
        phase_knob_kernels(bins, grad, hess, R, meta, gc, params)]


def check_scan_pair(bins, grad, hess, R, meta, gc, params):
    """scan_pair at B = 2 on real child histograms (hist_window of rows
    [0, R/3) and [R/3, R)) against its plain version, timed; returns its
    kernel record."""
    import torch
    from lightgbm_torch.ops.histogram import hist_window
    from lightgbm_torch.ops.scan import (ScanLayout, pair_scalars, scan_pair,
                                         scan_pair_plain)
    dev = bins.device
    G, W = bins.shape[1], gc.hist_width
    # the two children sit at rows 5 and 2 of the grower's [L, TB] planes;
    # the kernel reads them through rows and the layout's gidx
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
    rows = torch.tensor([5, 2], device=dev)
    gh = torch.zeros((8, gc.total_bins), device=dev)
    hh = torch.zeros_like(gh)
    gh[rows], hh[rows] = hists[:, :, 0], hists[:, :, 1]
    sums = hists.sum(dim=1) / G                     # every row in each group
    scal = torch.as_tensor(pair_scalars(
        sums[:, 0].cpu().numpy(), sums[:, 1].cpu().numpy(), [half, R - half],
        params.lambda_l2, params.min_gain_to_split, params.min_data_in_leaf,
        params.min_sum_hessian_in_leaf), device=dev)
    masks = (layout.keep_r, layout.keep_f, layout.valid_r, layout.valid_f,
             layout.aux)
    maps = {"rows": rows, "gidx": layout.gidx}
    k = scan_pair(scal, gh, hh, *masks, **maps)
    _same("scan_pair B=2: two launches", k, scan_pair(scal, gh, hh, *masks,
                                                      **maps))
    gb = gh[rows][:, layout.gidx].contiguous()
    hb = hh[rows][:, layout.gidx].contiguous()
    args = (scal, gb, hb) + masks
    _same("scan_pair B=2: the rows form vs the gathered form", k,
          scan_pair(*args))
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
    log("scan_pair B=2 F=%d Wp=%d, rows %s of [8, %d] planes through gidx: "
        "two launches bit-identical, equal to the gathered form, "
        "bit-identical to the plain version on the CPU; vs the plain version "
        "on the card thresholds/directions/has exact, %d finite gains within "
        "rtol 1e-5 (max abs err %.3g)" % (F, layout.Wp, rows.tolist(),
                                          gc.total_bins, int(fin.sum()),
                                          err_card))
    s_ms = device_ms(lambda: scan_pair(scal, gh, hh, *masks, **maps))
    old_ms = device_ms(lambda: scan_pair(
        scal, gh[rows][:, layout.gidx], hh[rows][:, layout.gidx], *masks))
    s_plain = device_ms(lambda: scan_pair_plain(*args), reps=20)
    floor_ms = device_ms(launch_floor)
    s_bound, s_by = scan_pair_bound(scal, gb, layout, k)
    log("scan_pair B=2, median time per call: kernel %.4f ms (previous "
        "design: %.4f), the gathered sequence (four torch gathers, then the "
        "kernel on the gathered planes) %.4f ms, plain %.4f ms, no single "
        "PyTorch call computes it; launch floor (an empty kernel) %.4f ms; "
        "bound %.6f ms (%s)" % (s_ms, PREVIOUS_MS["scan_pair"], old_ms,
                                s_plain, floor_ms, s_bound, s_by))
    return {"name": "scan_pair", "route": "cuda",
            "source": "lightgbm_torch/csrc/scan_pair.cu",
            "replaces": "lightgbm_tpu/ops/pallas_scan.py:262",
            "launches": 0, "max_abs_err": err_s, "ms": s_ms,
            "plain_ms": s_plain, "bound_ms": s_bound, "bound_by": s_by,
            "library_ms": None, "launch_floor_ms": floor_ms,
            "gathers_and_kernel_ms": old_ms}


# ---- the split scan's numerical knobs (v1 grower) ---------------------------

# every knob at once, each set to bind at HIGGS scale: lambda_l1 against
# leaf gradient sums of hundreds to thousands, max_delta_step against the
# early trees' outputs (up to ~2), the latent's signs as monotone
# constraints (higgs_latent: +x0, -x1, +x21, -x22), extra_trees and a
# by-node sample of 23 of the 28 features
KNOB_MONO = {0: 1, 1: -1, 21: 1, 22: -1}
KNOB_PARAMS = {"lambda_l1": 100.0, "max_delta_step": 0.5,
               "monotone_constraints": [KNOB_MONO.get(f, 0)
                                        for f in range(28)],
               "extra_trees": True, "feature_fraction_bynode": 0.8}


def knob_bound(scal, gb, layout, out, node):
    """The knob form's bound: scan_pair_bound's bytes plus the node
    inputs and the wider scalars, and about 100 operations per (child,
    feature, lane): the fast form's 40 with each direction's two leaf
    gains through ThresholdL1, the clamped outputs and the gains given
    them."""
    nbytes = (scal.numel() + 2 * gb.numel() + 4 * layout.keep_r.numel()
              + layout.aux.numel() + out.numel() + node.numel()) * 4 \
        + layout.gidx.numel() * 8
    return bound_ms(nbytes, 100.0 * gb.numel())


def knob_layout_inputs(meta, gc, params, sums, B, tags, dev, l1):
    """The knob form's inputs for B children of the HIGGS layout: the
    layout with KNOB_MONO's signs in aux row 1, the [B, 16] scalars
    (lambda_l1 `l1` and KNOB_PARAMS' max_delta_step, finite monotone bounds
    alternating with open ones) and the node draws of `tags` under the
    tree key of extra seed 6, tree 1 (the port's threefry)."""
    import torch
    from lightgbm_torch.ops.grow import Knobs, node_draws
    from lightgbm_torch.ops.scan import ScanLayout, knob_scalars
    from lightgbm_torch.ops.split import SplitParams
    from lightgbm_torch.utils import random as tf
    F = gc.num_features
    mono = np.array([KNOB_MONO.get(f, 0) for f in range(F)])
    layout = ScanLayout(meta.bin_start, meta.bin_end, meta.missing_type,
                        meta.default_bin, meta.penalty, np.ones(F, bool),
                        gc.scan_width, gc.total_bins, dev, mono)
    p = SplitParams(params.lambda_l2, params.min_gain_to_split,
                    params.min_data_in_leaf, params.min_sum_hessian_in_leaf,
                    l1, KNOB_PARAMS["max_delta_step"])
    cmin = np.where(np.arange(B) % 2, -0.3, -np.inf).astype(np.float32)
    cmax = np.where(np.arange(B) % 2, 0.05, np.inf).astype(np.float32)
    scal = knob_scalars(sums[:, 0], sums[:, 1], sums[:, 2], p, cmin, cmax,
                        True)
    knobs = Knobs(mono, True, True, int(np.ceil(0.8 * F)),
                  tf.fold_in(tf.prng_key(6), 1))
    node = node_draws(knobs, tags, np.ones(F, bool),
                      np.asarray(meta.bin_end) - np.asarray(meta.bin_start),
                      layout.Fp)
    return (layout, torch.as_tensor(scal, device=dev),
            torch.as_tensor(node, device=dev))


def phase_knob_kernels(bins, grad, hess, R, meta, gc, params):
    """scan_pair's knob form at the v1 path's shape (B = 2: the children
    of rows [0, R/3) and [R/3, R)) and at B = 256 (256 row segments), read
    in place through rows and gidx: two launches bit-identical, the rows
    form equal to the gathered form, bit for bit equal to its plain
    version on the CPU; every knob exercised (L1, the clamp, finite
    monotone bounds, mixed signs, drawn lanes, node masks). Times the knob
    form beside the fast form on the same planes; returns its record."""
    import torch
    from lightgbm_torch.ops.grow import tb_source_index
    from lightgbm_torch.ops.histogram import hist_window
    from lightgbm_torch.ops.scan import scan_pair, scan_pair_plain
    dev = bins.device
    G, W = bins.shape[1], gc.hist_width
    src = tb_source_index(meta.group_offset, gc.total_bins, W, dev)
    rng = np.random.default_rng(5)
    recs = {}
    for B in (2, 256):
        cuts = np.array([0, R // 3, R]) if B == 2 else np.concatenate(
            [[0], np.sort(rng.choice(np.arange(1, R), B - 1, replace=False)),
             [R]])
        segs = list(zip(cuts[:-1], np.diff(cuts)))
        L = B + 6
        gh = torch.zeros((L, gc.total_bins), device=dev)
        hh = torch.zeros_like(gh)
        rows = torch.as_tensor(rng.choice(L, B, replace=False), device=dev)
        sums = np.zeros((B, 3), np.float64)
        for b, (s0, n) in enumerate(segs):
            h = hist_window(bins, grad, hess, int(s0), int(n), W)
            h = h.reshape(G * W, 2)[src]
            gh[rows[b]], hh[rows[b]] = h[:, 0], h[:, 1]
            sums[b] = (float(grad[s0:s0 + n].double().sum()),
                       float(hess[s0:s0 + n].double().sum()), n)
        # lambda_l1 binds at both sizes: 333k-row children have |G| of
        # hundreds, 4k-row ones of tens
        l1 = KNOB_PARAMS["lambda_l1"] if B == 2 else 10.0
        layout, scal, node = knob_layout_inputs(
            meta, gc, params, sums, B, list(range(2, 2 + B)), dev, l1)
        masks = (layout.keep_r, layout.keep_f, layout.valid_r,
                 layout.valid_f, layout.aux)
        maps = {"rows": rows, "gidx": layout.gidx}
        k = scan_pair(scal, gh, hh, *masks, node=node, **maps)
        _same("scan_pair knob form B=%d: two launches" % B, k,
              scan_pair(scal, gh, hh, *masks, node=node, **maps))
        gb = gh[rows][:, layout.gidx].contiguous()
        hb = hh[rows][:, layout.gidx].contiguous()
        args = (scal, gb, hb) + masks
        _same("scan_pair knob form B=%d: rows form vs gathered form" % B, k,
              scan_pair(*args, node=node))
        cpu = [a.cpu() for a in args]
        err = _same("scan_pair knob form B=%d vs the plain version on the "
                    "CPU" % B, k, scan_pair_plain(*cpu, node=node.cpu()))
        has = k[:, 6].cpu().numpy() > 0.5
        drawn = (node[:, 0].cpu().numpy() >= 0) & has
        if not has.any() or not np.array_equal(
                k[:, 1].cpu().numpy()[drawn], node[:, 0].cpu().numpy()[drawn]):
            raise AssertionError("scan_pair knob form B=%d: no split, or a "
                                 "split off its drawn lane" % B)
        fast = scal[:, :8].contiguous()
        ms = device_ms(lambda: scan_pair(scal, gh, hh, *masks, node=node,
                                         **maps))
        fast_ms = device_ms(lambda: scan_pair(fast, gh, hh, *masks, **maps))
        b_ms, b_by = knob_bound(scal, gb, layout, k, node)
        rec = {"ms": ms, "fast_ms": fast_ms, "bound_ms": b_ms,
               "bound_by": b_by, "max_abs_err": err, "splits": int(has.sum())}
        if B == 2:
            rec["plain_ms"] = device_ms(lambda: scan_pair_plain(
                *args, node=node), reps=20)
        log("scan_pair knob form B=%d F=%d Wp=%d (l1 %g, max_delta_step %g, "
            "monotone %s, %d drawn lanes, by-node masks): two launches "
            "bit-identical, rows form = gathered form, bit-identical to the "
            "plain version on the CPU, %d of %d children split; median per "
            "call %.4f ms (fast form on the same planes %.4f ms)%s; bound "
            "%.6f ms (%s)"
            % (B, gc.num_features, layout.Wp, l1,
               KNOB_PARAMS["max_delta_step"], KNOB_MONO,
               int((node[:, 0] >= 0).sum()), int(has.any(axis=1).sum()), B,
               ms, fast_ms, ", plain %.4f ms" % rec["plain_ms"]
               if B == 2 else "", b_ms, b_by))
        recs[B] = rec
        del gh, hh, gb, hb, k
    r2 = recs[2]
    return {"name": "scan_pair_knob", "route": "cuda",
            "source": "lightgbm_torch/csrc/scan_pair.cu",
            "replaces": "lightgbm_tpu/ops/pallas_scan.py:262",
            "launches": 0, "max_abs_err": max(r["max_abs_err"]
                                              for r in recs.values()),
            "ms": r2["ms"], "plain_ms": r2["plain_ms"],
            "bound_ms": r2["bound_ms"], "bound_by": r2["bound_by"],
            "library_ms": None, "fast_form_ms": r2["fast_ms"],
            "b256_ms": recs[256]["ms"], "b256_fast_form_ms": recs[256][
                "fast_ms"], "b256_bound_ms": recs[256]["bound_ms"]}


def knob_node_tags(tree):
    """The key tag of each internal node's scan (ops/grow.py: the root 0,
    the children of split s 2s and 2s + 1; split s is internal node s - 1,
    a node's own scan ran when its parent's split made it)."""
    tags = np.zeros(max(tree.num_leaves - 1, 0), np.int64)
    for p in range(tree.num_leaves - 1):
        for side, c in enumerate((tree.left_child[p], tree.right_child[p])):
            if c >= 0:
                tags[c] = 2 * (p + 1) + side
    return tags


def check_knob_draws(bst, inner, seed):
    """Replays every node's draws with the port's numpy threefry: each
    split's feature lies in its node's by-node sample and its threshold is
    the node's drawn extra_trees bin. Returns (nodes, trees) checked."""
    from lightgbm_torch.treelearner.serial import bynode_count
    from lightgbm_torch.utils import random as tf
    b = bst._booster
    F = inner.num_features
    nb = np.asarray(inner.bin_end) - np.asarray(inner.bin_start)
    k = bynode_count(b.config, F)
    base = tf.prng_key(seed)
    nodes = 0
    for i, tree in enumerate(b.models):
        tkey = tf.fold_in(base, i + 1)          # the learner's tree counter
        for n, tag in enumerate(knob_node_tags(tree)):
            key = tf.fold_in(tkey, int(tag))
            f = int(tree.split_feature_inner[n])
            mask = tf.bynode_mask(key, np.ones(F, bool), k)
            want = int(tf.extra_trees_bins(key, nb)[f])
            if not mask[f] or int(tree.threshold_in_bin[n]) != want:
                raise AssertionError(
                    "knobs: tree %d node %d splits feature %d at bin %d; its "
                    "draws: sample %s, bin %d" % (i, n, f,
                                                  tree.threshold_in_bin[n],
                                                  np.nonzero(mask)[0], want))
            nodes += 1
    return nodes, len(b.models)


def check_monotone_sweep(bst, X, rows=1000):
    """Each constrained feature sweeps every split threshold of the model
    (and the value just past it) on `rows` rows: the raw score moves only
    in the constraint's direction. Returns the largest move per feature."""
    sub = X[:rows].copy()
    moved = {}
    for f, sign in KNOB_MONO.items():
        thr = sorted({float(t.threshold[k]) for t in bst._booster.models
                      for k in range(t.num_leaves - 1)
                      if t.split_feature[k] == f})
        grid = sorted({float(np.nanmin(X[:rows, f])) - 1.0,
                       float(np.nanmax(X[:rows, f])) + 1.0} | set(thr)
                      | {float(np.nextafter(t, np.inf)) for t in thr})
        raw = []
        for v in grid:
            sub[:, f] = v
            raw.append(bst.predict(sub, raw_score=True))
        sub[:, f] = X[:rows, f]
        step = np.diff(np.stack(raw), axis=0) * sign
        if step.size and step.min() < 0:
            raise AssertionError("knobs: feature %d (constraint %+d) moves "
                                 "the score against it by %.3g"
                                 % (f, sign, -float(step.min())))
        moved[f] = (len(thr), float(step.max()) if step.size else 0.0)
    return moved


def check_knob_leaves(bst, rec):
    """max_delta_step: every leaf of the trees after the first (which
    carries the initial score) within +-mds x the learning rate, at least
    one on it. The last tree's leaves, against the leaf math on the host:
    from each leaf's gradient sums (f64 on the card, through the grower's
    row -> leaf map), -ThresholdL1(G) / (H + l2) clamped to +-mds and into
    the leaf's monotone bounds (replayed over the grower's split records
    with ops/split.py:mono_bounds), within 1e-5 + 1e-4 relative; lambda_l1
    binds: some leaf's output before the monotone clamp moves by more than
    1e-3 without it."""
    import torch
    from lightgbm_torch.ops.split import mono_bounds
    b = bst._booster
    mds, lr = KNOB_PARAMS["max_delta_step"], b.shrinkage_rate
    bound = float(np.float32(mds)) * lr
    vals = np.concatenate([t.leaf_value[:t.num_leaves]
                           for t in b.models[1:]])
    at = int(np.sum(np.abs(vals) == bound))
    if not np.all(np.abs(vals) <= bound) or at == 0:
        raise AssertionError("knobs: leaves past max_delta_step x lr %r "
                             "(largest %r), %d on it"
                             % (bound, float(np.abs(vals).max()), at))
    grad, hess, arr, row_leaf = rec
    L = arr.num_leaves
    key = row_leaf.to(torch.int64)
    G = torch.zeros(L, dtype=torch.float64, device=key.device) \
        .index_add_(0, key, grad.double()).cpu().numpy()
    H = torch.zeros(L, dtype=torch.float64, device=key.device) \
        .index_add_(0, key, hess.double()).cpu().numpy()
    # each leaf's monotone bounds: split k of leaf l makes leaves l and
    # k + 1 from l's bounds and the two outputs the split gave them (a
    # leaf's output until its own split is that split's internal value)
    cmin = np.full(L, -np.inf, np.float32)
    cmax = np.full(L, np.inf, np.float32)

    def output(leaf, k):
        later = [j for j in range(k + 1, L - 1) if arr.split_leaf[j] == leaf]
        return arr.internal_value[later[0]] if later else arr.leaf_value[leaf]
    for k in range(L - 1):
        l, r = int(arr.split_leaf[k]), k + 1
        cmin[l], cmax[l], cmin[r], cmax[r] = mono_bounds(
            cmin[l], cmax[l], KNOB_MONO.get(int(arr.split_feature[k]), 0),
            output(l, k), output(r, k))
    l1, l2 = KNOB_PARAMS["lambda_l1"], float(b.config.lambda_l2)

    def unbounded(g):
        return np.clip(-g / (H + l2), -mds, mds)
    free = unbounded(np.sign(G) * np.maximum(0.0, np.abs(G) - l1))
    with_l1 = np.clip(free, cmin, cmax)
    got = np.asarray(arr.leaf_value[:L], np.float64)
    off = np.abs(got - with_l1) > 1e-5 + 1e-4 * np.abs(with_l1)
    # lambda_l1 moves the output before the monotone clamp
    sens = int(np.sum(np.abs(free - unbounded(G)) > 1e-3))
    if off.any() or not sens:
        raise AssertionError("knobs: %d of the last tree's %d leaves are off "
                             "the leaf math (worst %.3g); %d leaves depend "
                             "on lambda_l1" % (int(off.sum()), L, float(
                                 np.abs(got - with_l1).max()), sens))
    bounded = int(np.sum(np.isfinite(cmin) | np.isfinite(cmax)))
    return at, len(vals), sens, bounded, L


def phase_grow_step():
    """The grow_step kernels against their plain versions on the CPU, bit
    for bit, on random mid-tree states at the per-split path's shapes
    (HIGGS: 255 leaves, 28 features in 28 groups, Fp = 32; Expo's block
    scan: Gp = 24, Wp = 256) with -inf gains, ties across leaves and
    features, +inf and NaN scan gains, children at max_depth, zero
    hessians and forced_right features (the CPU tests' builders,
    tests/test_torch_step_cases.py); with the done flag set they write
    nothing. Then the time of one step's four kernels (pick, commit,
    planes, assemble), of a no-op step, and of the tree's end (the
    consolidation table and the score update over the 10.5M-lane score
    row). Returns the kernel record."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_step_cases import (assert_same_state, on, random_case,
                                       state_arrays)
    from lightgbm_torch.ops import grow_step as gs

    def steps(c, mode):
        S, k = c["S"], c["k"]
        gs.pick(S, c["feat"], k)
        l = S.st[gs.ST_LEAF:gs.ST_LEAF + 1]
        S.st[gs.ST_NLEFT:gs.ST_NLEFT + 1] = S.li[l, gs.LI_NROWS] // 3
        gs.commit(S, k)
        gs.planes(S, c["gh"], c["hh"], c["small"])
        out = c["out_pair"] if mode == gs.SCAN_PAIR else c["out_blocks"]
        gs.assemble(S, out, mode, c["owner"], c["Wp"], c["feat"], k, True)
        gs.cons_table(S)
        gs.apply_scores(S, c["score"], 0.1)

    shapes = {gs.SCAN_PAIR: dict(L=255, F=28, Fp=32, G=28, Gp=32, Wp=256),
              gs.SCAN_BLOCKS: dict(L=256, F=648, Fp=648, G=18, Gp=24,
                                   Wp=256)}
    cases = 0
    for mode, shape in shapes.items():
        for seed in range(6):
            c = random_case(seed, n=1_000_000, **shape)
            if seed == 4:
                c["out_pair"][0, 0, 5] = float("inf")
                c["out_blocks"][1, 0, 2] = float("nan")
            if seed == 5:
                c["S"].li[:, gs.LI_DEPTH] = c["k"].max_depth - 1
            d = on(c, "cuda")
            steps(c, mode)
            steps(d, mode)
            torch.cuda.synchronize()
            assert_same_state(state_arrays(c["S"]), state_arrays(d["S"]))
            for key in ("gh", "hh", "score"):
                _same("grow_step mode %d seed %d: %s" % (mode, seed, key),
                      d[key], c[key])
            d["S"].st[gs.ST_DONE] = 1
            before = state_arrays(d["S"])
            gh0 = d["gh"].clone()
            steps(d, mode)
            after = state_arrays(d["S"])
            after["st"][0, gs.ST_NLEFT] = before["st"][0, gs.ST_NLEFT]
            after["tab"] = before["tab"]   # the table is rebuilt every tree
            assert_same_state(before, after)
            _same("grow_step with the done flag set: planes", d["gh"], gh0)
            cases += 1
    log("grow_step: pick, commit, planes, assemble, the consolidation "
        "table and the score update bit-identical to their plain versions "
        "on the CPU in %d random mid-tree states (scan_pair and scan_blocks "
        "assembly; -inf, +inf and NaN gains, ties across leaves and "
        "features, children at max_depth, zero hessians, forced_right); "
        "with the done flag set nothing is written" % cases)

    # ---- times at the HIGGS per-split shape -------------------------------
    c = on(random_case(11, n=10_500_000, **shapes[gs.SCAN_PAIR]), "cuda")
    S, k = c["S"], c["k"]
    S.st[gs.ST_NLEFT] = 1000
    base = S.blob.clone()
    kern = {
        "pick": lambda: gs.pick(S, c["feat"], k),
        "commit": lambda: gs.commit(S, k),
        "planes": lambda: gs.planes(S, c["gh"], c["hh"], c["small"]),
        "assemble": lambda: gs.assemble(S, c["out_pair"], gs.SCAN_PAIR,
                                        c["owner"], c["Wp"], c["feat"], k,
                                        True)}
    times = {}
    for name, fn in kern.items():
        S.blob.copy_(base)
        times[name] = device_ms(fn, sleep_cycles=2_000_000)
    S.blob.copy_(base)
    S.st[gs.ST_DONE] = 1
    noop_ms = device_ms(lambda: [f() for f in kern.values()])
    S.blob.copy_(base)
    cons_ms = device_ms(lambda: gs.cons_table(S), sleep_cycles=2_000_000)
    apply_ms = device_ms(lambda: gs.apply_scores(S, c["score"], 0.1))
    step_ms = sum(times.values())
    plain = on(random_case(11, n=10_500_000, **shapes[gs.SCAN_PAIR]), "cuda")

    def plain_step():
        P = plain["S"]
        P.blob.copy_(base)
        gs.pick_plain(P, plain["feat"], k)
        gs.commit_plain(P, k)
        gs.planes_plain(P, plain["gh"], plain["hh"], plain["small"])
        gs.assemble_plain(P, plain["out_pair"], gs.SCAN_PAIR,
                          plain["owner"], c["Wp"], plain["feat"], k, True)
    plain_ms = device_ms(plain_step, reps=5, warmup=1)
    L, TBp, Fp = S.L, c["gh"].shape[1], c["out_pair"].shape[2]
    # bytes a step must move: the gains, one leaf row and one feature row
    # (pick); the parent's and the smaller child's planes read, both
    # children's written (planes); the scan output read and two leaf rows
    # written (assemble); the split record, scalars and state words
    nbytes = (L * 4 + 20 * 8 + 10 * 4 + 6 * TBp * 4 + 2 * 8 * Fp * 4
              + 4 * 20 * 8 + 16 * 4 + 2 * 9 * 4)
    b_ms, b_by = bound_ms(nbytes, 2.0 * TBp + 4.0 * L + 4.0 * Fp)
    n = c["score"].shape[0]
    apply_bound = bound_ms(2.0 * n * 4 + L * 20.0, float(n))[0]
    log("grow_step at the HIGGS per-split shape (L=%d, G*256=%d, Fp=%d): "
        "one step's kernels %.4f ms (pick %.4f, commit %.4f, planes %.4f, "
        "assemble %.4f), plain versions %.4f ms, bound %.6f ms (%s); a "
        "no-op step (done set) %.4f ms; the end of a tree: the "
        "consolidation table %.4f ms, the score update over %d lanes %.4f "
        "ms (bound %.4f ms)"
        % (L, TBp, Fp, step_ms, times["pick"], times["commit"],
           times["planes"], times["assemble"], plain_ms, b_ms, b_by,
           noop_ms, cons_ms, n, apply_ms, apply_bound))
    del c, plain
    torch.cuda.empty_cache()
    return {"name": "grow_step", "route": "cuda",
            "source": "lightgbm_torch/csrc/grow_step.cu",
            "replaces": "lightgbm_tpu/ops/grow_persist.py:1533",
            "launches": 0, "max_abs_err": 0.0, "ms": step_ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "kernel_ms": times, "noop_step_ms": noop_ms,
            "cons_table_ms": cons_ms, "apply_scores_ms": apply_ms,
            "apply_scores_bound_ms": apply_bound}


def phase_scan_edges():
    """scan_pair and scan_blocks against their plain versions on the CPU at
    the edge shapes, bit for bit, in the rows form (planes read in place
    through a random choice of rows): B = 1, 2 and 256 at Wp = 32, 256 and
    1024; features with no valid lane (one bin, masked out of the tree);
    exact ties in both directions (empty bins); +inf gains (l2 = 0 and
    zero-hessian sides); per-child valid masks; one-lane and two-lane
    windows, fix lanes, dense groups as wide as the plane and G < Gp; an
    inf gain times a zero penalty. The inputs are the card tests' builders
    (tests/test_torch_scan_rows.py)."""
    import torch
    sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(
        __file__)), "tests"))
    from test_torch_scan_rows import (block_case, pair_args, pair_case)
    from lightgbm_torch.ops.block_scan import scan_blocks
    from lightgbm_torch.ops.scan import scan_pair

    def on(dev, t):
        return t.to(dev) if torch.is_tensor(t) else t

    def pair(c, dev):
        return scan_pair(*[on(dev, a) for a in pair_args(c)],
                         rows=on(dev, c["rows"]), gidx=on(dev, c["gidx"]))

    def blocks(c, dev, do_fix):
        return scan_blocks(*[on(dev, c[k]) for k in ("scal", "gh", "hh",
                                                     "masks")],
                           do_fix, on(dev, c["rows"]), c["G"])
    cases = 0
    inf = dict(l2=0.0, min_data=0, min_hess=0.0, zero_hess=0.3)
    for Wp in (32, 256, 1024):
        for B in (1, 2, 256):
            c = pair_case(100 + B, B, Wp)
            _same("scan_pair B=%d Wp=%d vs the CPU" % (B, Wp),
                  pair(c, "cuda"), pair(c, "cpu"))
            b = block_case(200 + B, B, Wp)
            for do_fix in (True, False):
                _same("scan_blocks B=%d Wp=%d do_fix=%s vs the CPU"
                      % (B, Wp, do_fix), blocks(b, "cuda", do_fix),
                      blocks(b, "cpu", do_fix))
            cases += 3
    for label, c in (("+inf gains", pair_case(7, 64, 256, **inf)),
                     ("per-child valid masks",
                      pair_case(7, 64, 256, batched=True))):
        _same("scan_pair, %s, vs the CPU" % label, pair(c, "cuda"),
              pair(c, "cpu"))
        cases += 1
    for label, c in (("+inf gains", block_case(9, 64, 256, **inf)),
                     ("inf times a zero penalty",
                      block_case(9, 64, 256, zero_pen=True, **inf))):
        _same("scan_blocks, %s, vs the CPU" % label,
              blocks(c, "cuda", c["do_fix"]), blocks(c, "cpu", c["do_fix"]))
        cases += 1
    torch.cuda.synchronize()
    log("scan edges: scan_pair and scan_blocks bit-identical to their plain "
        "versions on the CPU in %d cases (B = 1, 2, 256 at Wp = 32, 256, "
        "1024; no valid lane, ties both ways, +inf gains, per-child valid "
        "masks, one-lane windows, fix lanes, G < Gp, inf times a zero "
        "penalty)" % cases)


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


def split_scalars(assets, inner, f, s0, n_l, default_left, small_l):
    """The S_* scalars of a split of lanes [s0, s0 + n_l) of a pristine
    payload (lane i is row i) on feature f at the median of its bins."""
    from lightgbm_torch.ops import payload_kernels as pk
    col = inner.binned[s0:s0 + n_l, int(inner.group_of[f])]
    scal = [0] * pk.N_SCALARS
    scal[pk.S_NCH] = -(-n_l // assets.geometry[6])
    scal[pk.S_S0], scal[pk.S_NL] = s0, n_l
    scal[pk.S_WG], scal[pk.S_SH] = (int(assets.dec_word[f]),
                                    int(assets.dec_shift[f]))
    scal[pk.S_MASK], scal[pk.S_NB] = (int(assets.dec_mask[f]),
                                      int(assets.nb[f]))
    scal[pk.S_MT], scal[pk.S_DB] = int(assets.mt[f]), int(assets.db[f])
    scal[pk.S_THR] = int(np.median(col)) if n_l else 0
    scal[pk.S_DL], scal[pk.S_SMALL_L] = int(default_left), int(small_l)
    scal[pk.S_LS], scal[pk.S_LE], scal[pk.S_MF] = (
        int(assets.ls[f]), int(assets.le[f]), int(assets.mf[f]))
    return scal


def random_segments(rng, n, S):
    """S disjoint (start, length) segments covering lanes [0, n), cut at
    S - 1 random lanes: the leaves of one tree level, of uneven sizes."""
    cuts = np.sort(rng.choice(np.arange(1, n), S - 1, replace=False))
    bounds = np.concatenate([[0], cuts, [n]])
    return [(int(a), int(b - a)) for a, b in zip(bounds[:-1], bounds[1:])]


def segment_sums(pay, nbw, segs):
    """[S] f32 grad sums, [S] f32 hess sums (f64 sums rounded) and [S]
    lengths of payload segments."""
    import torch
    gh = pay[nbw + 2:nbw + 4].view(torch.float32)
    sums = np.array([gh[:, st:st + ln].double().sum(dim=1).cpu().numpy()
                     for st, ln in segs], np.float64).astype(np.float32)
    return sums[:, 0], sums[:, 1], np.array([ln for _, ln in segs])


def index_add_inputs(pay, plan, nbw, segs):
    """(index, values, out) of one index_add_ computing the planes of every
    segment of `segs` at once ([S * G * 256] bins): the yardstick of the
    payload histogram kernels, built outside the timed call."""
    import torch
    dev = pay.device
    G = len(plan)
    lanes = torch.cat([torch.arange(st, st + ln, device=dev)
                       for st, ln in segs])
    slot = torch.repeat_interleave(
        torch.arange(len(segs), device=dev),
        torch.as_tensor([ln for _, ln in segs], device=dev))
    bins = torch.stack([(pay[w, lanes] >> sh) & mk for w, sh, mk in plan],
                       dim=1).long()
    idx = (slot[:, None] * (G * 256) + torch.arange(G, device=dev)[None, :]
           * 256 + bins).reshape(-1)
    del bins, slot
    gh = pay[nbw + 2:nbw + 4][:, lanes].view(torch.float32)
    vals = gh.t()[:, None, :].expand(-1, G, -1).reshape(-1, 2).contiguous()
    del gh, lanes
    return idx, vals, torch.zeros((len(segs) * G * 256, 2), device=dev)


def library_hist_segments(pay, plan, nbw, segs):
    """The time of one index_add_ computing the planes of every segment of
    `segs` at once (index_add_inputs)."""
    import torch
    idx, vals, out = index_add_inputs(pay, plan, nbw, segs)
    ms = device_ms(lambda: out.index_add_(0, idx, vals), reps=5, warmup=1)
    del idx, vals, out
    torch.cuda.empty_cache()
    return ms


def ownership_hist(pay, plan_d, nbw, start, length):
    """The histogram of lanes [start, start + length) by payload_hist.cuh's
    ownership routine (split_pass.cu's witness launcher): an independent
    implementation of the payload histograms' contract, the witness of the
    counting-sort kernels (not counted as a launch of any wrapper)."""
    from lightgbm_torch.ops import payload_kernels as pk
    return pk._launch_hist("split_pass", "ownership_hist_launch", pay,
                           plan_d, nbw, start, length)


def ownership_multi(pay, plan_d, nbw, tables):
    """The ownership routine over the segments of `tables` (level_pass.cu's
    witness launcher): the witness of level_seg_hist and of level_pass's
    in-pass histograms."""
    from lightgbm_torch.ops import payload_kernels as pk
    return pk._launch_multi_hist("level_pass", "ownership_multi_launch", pay,
                                 plan_d, nbw, tables)


def sentinel(shape, dev, seed):
    """A buffer of random words on the card, so that a lane a partition
    must not write shows when it is written."""
    import torch
    g = torch.Generator(dev).manual_seed(seed)
    return torch.randint(0, 2 ** 31 - 1, shape, dtype=torch.int32,
                         device=dev, generator=g)


def same_outside(name, dst, dst0, segs, wp_live):
    """Every lane of `dst` outside the (start, length) segments, and every
    row from wp_live on, as in `dst0`."""
    import torch
    keep = torch.ones(dst.shape[1], dtype=torch.bool, device=dst.device)
    for st, ln in segs:
        keep[st:st + ln] = False
    _same(name + ": lanes outside the segments", dst[:, keep], dst0[:, keep])
    _same(name + ": rows from wp_live on", dst[wp_live:], dst0[wp_live:])


def seg_hist_dev(pay, plan_d, nbw, start, length, max_length):
    """A call of seg_hist's device form over lanes [start, start + length)
    (the segment uploaded once, outside the call) with the scratch of a
    grower whose payload has max_length lanes: the per-split loop's
    launches, its fixed grids' idle blocks included."""
    import torch
    from lightgbm_torch.ops import payload_kernels as pk
    seg = torch.tensor([start, length], dtype=torch.int64, device=pay.device)
    out, partial = pk.hist_scratch(pay, plan_d.shape[0], max_length)
    return lambda: pk.seg_hist_device(pay, plan_d, nbw, seg, out, partial)


def run_consolidate_device(src, dst0, tab, wp_live):
    from lightgbm_torch.ops import payload_kernels as pk
    dst = dst0.clone()
    pk.consolidate_device(src, dst, tab, wp_live)
    return dst


def run_consolidate_plain(src, dst0, segs, wp_live):
    from lightgbm_torch.ops import payload_kernels as pk
    dst = dst0.clone()
    pk.consolidate_plain(src, dst, segs, wp_live)
    return dst


def check_split_device(pay, second0, scal, plan_d, nbw, wp_live, run,
                       n_left):
    """split_pass's device form against the host form's run `run` (dst,
    n_left, in-pass histogram) at the path's shape: the same destination,
    n_left, smaller child and histogram from the scalars in device memory;
    with the done flag set nothing is written or counted; with the parity
    flag set the partition runs from the second buffer into the payload,
    equal to the host form in that direction. Returns the number of
    checks."""
    import torch
    from lightgbm_torch.ops import counters
    from lightgbm_torch.ops import payload_kernels as pk
    dev = pay.device
    G = plan_d.shape[0]
    scal_d = torch.tensor(scal + [0], dtype=torch.int32, device=dev)
    res = torch.full((3,), -1, dtype=torch.int64, device=dev)
    zero = torch.zeros(1, dtype=torch.int64, device=dev)
    one = torch.ones(1, dtype=torch.int64, device=dev)
    d = second0.clone()
    hist = pk.hist_scratch(d, G, scal[pk.S_NL])
    pk.split_pass_device(pay, d, scal_d, res, plan_d, nbw, wp_live, hist,
                         done=zero, swap=zero)
    _same("split_pass device form vs the host form: destination", d, run[0])
    _same("split_pass device form vs the host form: in-pass histogram",
          hist[0], torch.stack(run[2]))
    if res.tolist() != [n_left, *pk._child(scal, n_left)]:
        raise AssertionError("split_pass device form: res %s, n_left %d"
                             % (res.tolist(), n_left))
    before = counters.read(dev)
    snap = (d.clone(), res.clone(), hist[0].clone())
    pk.split_pass_device(pay, d, scal_d, res, plan_d, nbw, wp_live, hist,
                         done=one, swap=zero)
    for name, a, b in zip(("destination", "res", "histogram"), snap,
                          (d, res, hist[0])):
        _same("split_pass with the done flag set: " + name, a, b)
    if counters.read(dev) != before:
        raise AssertionError("split_pass with the done flag set was counted")
    # parity 1: the leaf lives in the second buffer, the children go to
    # the payload (the host form's second-buffer-to-payload direction)
    src_b, dst_b = pay[:wp_live].clone(), pay.clone()
    want = dst_b.clone()
    pk.split_pass(src_b, want, scal, plan_d, nbw, wp_live, False)
    pk.split_pass_device(dst_b, src_b, scal_d, res, plan_d, nbw, wp_live,
                         done=zero, swap=one)
    _same("split_pass device form with the parity flag vs the host form "
          "from the second buffer", dst_b, want)
    log("split_pass device form at %d lanes: destination, n_left, the "
        "smaller child and the in-pass histogram equal to the host form's; "
        "the done flag writes and counts nothing; the parity flag runs the "
        "partition from the second buffer into the payload as the host "
        "form does" % scal[pk.S_NL])
    return 4


def wide_partition(pay, plan_d, plan_c, nbw, n, scal, R, K=5):
    """split_pass and the consolidation at the payload width of K classes
    (the HIGGS multiclass path: wp_live = nbw + 4 + 2K moving rows, the K
    score rows and their snapshot riding every partition): a payload of
    that width (the HIGGS payload's rows, then random words), split_pass on
    the same segment into a second buffer of wp_live rows, held to its
    plain version on the CPU with every lane and row outside the segment
    untouched, and the consolidation of 128 segments over all lanes held to
    one copy_; both timed beside their bounds. Returns the numbers for
    split_pass's record."""
    import torch
    from lightgbm_torch.ops import payload_kernels as pk
    from lightgbm_torch.ops.payload import payload_weight_row
    dev, NP = pay.device, pay.shape[1]
    wp = payload_weight_row(nbw, K)
    wide = sentinel((-(-wp // 8) * 8, NP), dev, 11)
    wide[:nbw + 5] = pay[:nbw + 5]
    second0 = sentinel((wp, NP), dev, 12)
    d = second0.clone()
    n_left = pk.split_pass(wide, d, scal, plan_d, nbw, wp, False)[0]
    end = 777 + R + 1024
    dst_c = second0[:, :end].cpu().contiguous()
    p_left = pk.split_pass(wide[:, :end].cpu().contiguous(), dst_c, scal,
                           plan_c, nbw, wp, False)[0]
    if p_left != n_left:
        raise AssertionError("split_pass at wp_live %d: n_left %d on the "
                             "card, %d in the plain version"
                             % (wp, n_left, p_left))
    err = _same("split_pass at wp_live %d vs the plain version on the CPU"
                % wp, d[:, :end], dst_c)
    same_outside("split_pass at wp_live %d" % wp, d, second0, [(777, R)], wp)
    del dst_c
    scal_d = torch.tensor(scal, dtype=torch.int32, device=dev)
    res = torch.empty(3, dtype=torch.int64, device=dev)
    work = pk.split_scratch(wide)
    ms = device_ms(lambda: pk._launch_split(wide, d, scal_d, res, wp, work))
    plain_ms = device_ms(lambda: pk.split_pass_plain(wide, d, scal, plan_d,
                                                     nbw, wp, False), reps=5)
    b_ms, b_by = bound_ms(2.0 * wp * R * 4, float(R))
    cover = random_segments(np.random.default_rng(2), n, 128)
    ctab = torch.tensor(cover, dtype=torch.int64, device=dev)
    c_dst = wide.clone()
    pk.consolidate(d, c_dst, cover, wp)
    ref = wide.clone()
    ref[:wp, :n].copy_(d[:, :n])
    _same("consolidate at wp_live %d vs one copy_" % wp, c_dst, ref)
    del ref
    c_ms = device_ms(lambda: pk._launch_consolidate(d, c_dst, wp, ctab,
                                                    -(-NP // 1024), False))
    c_plain = device_ms(lambda: pk.consolidate_plain(d, c_dst, cover, wp),
                        reps=5)
    c_lib = device_ms(lambda: c_dst[:wp, :n].copy_(d[:, :n]))
    c_bound = bound_ms(2.0 * wp * n * 4, 0.0)[0]
    log("split_pass at wp_live %d (the %d-class payload, [%d, %d] int32, "
        "its second buffer %d bytes), %d lanes from lane 777: bit-identical "
        "to the plain version on the CPU, every lane and row outside the "
        "segment untouched; kernel %.4f ms, plain %.4f ms, bound %.4f ms "
        "(%s); consolidate of 128 segments over all %d lanes: equal to one "
        "copy_, kernel %.4f ms, plain %.4f ms, one copy_ %.4f ms, bound "
        "%.4f ms" % (wp, K, wide.shape[0], NP, wp * NP * 4, R, ms, plain_ms,
                     b_ms, b_by, n, c_ms, c_plain, c_lib, c_bound))
    del wide, second0, d, c_dst, work
    torch.cuda.empty_cache()
    return {"wp_live_%d" % wp: {
        "ms": ms, "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
        "max_abs_err": err, "consolidate_ms": c_ms,
        "consolidate_plain_ms": c_plain, "consolidate_library_ms": c_lib,
        "consolidate_bound_ms": c_bound}}


def check_root_hist(pay, cpu, plan, nbw, n, label):
    """root_hist over lanes [0, n) of the payload `pay` (and its CPU copy):
    two launches bit-identical, bit-identical to the plain version on the
    CPU (planes and totals), planes equal to seg_hist's over the same lanes
    (the same counting-sort routine over a segment) and to the ownership
    routine's (ownership_hist, an independent implementation of the same
    contract). Returns (max abs err, kernel ms, index_add_ ms, bound ms,
    bound_by), times median per call."""
    import torch
    from lightgbm_torch.ops import payload_kernels as pk
    plan_c, plan_d = pk.plan_tensor(plan, "cpu"), pk.plan_tensor(plan,
                                                                pay.device)
    k1 = pk.root_hist(pay, plan_d, nbw, n)
    k2 = pk.root_hist(pay, plan_d, nbw, n)
    seg = pk.seg_hist(pay, plan_d, nbw, 0, n)
    own = ownership_hist(pay, plan_d, nbw, 0, n)
    torch.cuda.synchronize()
    _same("root_hist %s: two launches" % label, k1, k2)
    _same("root_hist %s: planes vs seg_hist over the same lanes" % label,
          k1[:2], seg)
    _same("root_hist %s: planes vs the ownership routine over the same "
          "lanes" % label, k1[:2], own)
    err = _same("root_hist %s vs the plain version on the CPU" % label, k1,
                pk.root_hist_plain(cpu, plan_c, nbw, n))
    del k1, k2, seg, own
    ms = device_ms(lambda: pk.root_hist(pay, plan_d, nbw, n), reps=5,
                   warmup=1)
    lib_ms = library_hist_segments(pay, plan, nbw, [(0, n)])
    G = len(plan)
    b_ms, b_by = bound_ms(n * (4 * nbw + 8) + 2 * G * 256 * 4 + 8,
                          2.0 * n * G)
    log("root_hist %s, %d lanes x %d groups: two launches bit-identical, "
        "planes equal to seg_hist's and the ownership routine's, "
        "bit-identical to the plain version on "
        "the CPU (planes and totals); median time per call: kernel %.3f ms, "
        "index_add_ %.3f ms; bound %.4f ms (%s)"
        % (label, n, G, ms, lib_ms, b_ms, b_by))
    return err, ms, lib_ms, b_ms, b_by


# (start, length) of seg_hist's ragged checks: a short segment, zero
# lanes, one lane, a tile less and more one lane, a row block and one
# lane, 3 row blocks less 7 lanes (four teams per group at 28 groups), 7
# (two) and 13 row blocks (one), and 19 row blocks (longer than 19 *
# 16384 lanes), each from an unaligned lane
SEG_CASES = [(12345, 8191), (5, 0), (777, 1), (13, 1023), (1029, 1025),
             (3, 16385), (99, 3 * 16384 - 7), (11, 100_003), (7, 200_000),
             (4097, 400_001)]
# lengths of the small children timed against the ownership routine
SMALL_CHILDREN = (1024, 8192, 16384)


def phase_payload_kernels(inner, meta, gc, params):
    """root_hist, seg_hist, split_pass, level_pass and level_seg_hist
    against their plain versions at the persistent grower's HIGGS shapes,
    and scan_pair at B = 256 on the level's children; returns (their kernel
    records, scan_pair's numbers at B = 256)."""
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
        "uploaded in %.1f s; the grower's second buffer: [%d, %d] int32, %d "
        "bytes" % (WPA, NP, WPA * NP * 4 / 1e9, nbw, time.time() - t,
                   wp_live, NP, wp_live * NP * 4))
    lane_bytes = 4 * nbw + 8             # bin words + grad + hess per lane
    plane_bytes = 2 * G * 256 * 4
    records = []

    # ---- root_hist over all n lanes ---------------------------------------
    err, ms, lib_ms, b_ms, b_by = check_root_hist(pay, cpu, plan, nbw, n,
                                                  "HIGGS")
    plain_ms = device_ms(lambda: pk.root_hist_plain(pay, plan_d, nbw, n),
                         reps=3, warmup=1)
    log("root_hist HIGGS: plain version %.3f ms per call" % plain_ms)
    # skewed: every lane in one bin of every group (all bin words 7 in each
    # byte), the full length and a ragged one
    one = pay.clone()
    one[:nbw, :n] = 0x07070707
    one_c = one.cpu()
    check_root_hist(one, one_c, plan, nbw, n, "every lane in bin 7")
    nr = min(1_000_003, n - 5)
    k1 = pk.root_hist(pay, plan_d, nbw, nr)
    _same("root_hist ragged (%d lanes): two launches" % nr, k1,
          pk.root_hist(pay, plan_d, nbw, nr))
    err = max(err, _same("root_hist ragged (%d lanes) vs the plain version "
                         "on the CPU" % nr, k1,
                         pk.root_hist_plain(cpu, plan_c, nbw, nr)))
    del k1
    torch.cuda.empty_cache()
    records.append({"name": "root_hist", "route": "cuda",
                    "source": "lightgbm_torch/csrc/root_hist.cu",
                    "replaces": "lightgbm_tpu/ops/pallas_grow.py:944",
                    "launches": 0, "max_abs_err": err, "ms": ms,
                    "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                    "library_ms": lib_ms})

    # ---- seg_hist on a 1M-lane segment, skewed, ragged and small ---------
    R = min(1_000_000, n - 777)
    args = (nbw, 777, R)
    k1 = pk.seg_hist(pay, plan_d, *args)
    k2 = pk.seg_hist(pay, plan_d, *args)
    own = ownership_hist(pay, plan_d, *args)
    torch.cuda.synchronize()
    _same("seg_hist: two launches", k1, k2)
    _same("seg_hist vs the ownership routine", k1, own)
    err = _same("seg_hist vs the plain version on the CPU", k1,
                pk.seg_hist_plain(cpu, plan_c, *args))
    err = max(err, _same("seg_hist, every lane in bin 7",
                         pk.seg_hist(one, plan_d, *args),
                         pk.seg_hist_plain(one_c, plan_c, *args)))
    del k1, k2, own, one_c
    cases = [(st, ln) for st, ln in SEG_CASES if st + ln <= n]
    for st, ln in cases:
        err = max(err, _same("seg_hist, %d lanes from lane %d" % (ln, st),
                             pk.seg_hist(pay, plan_d, nbw, st, ln),
                             pk.seg_hist_plain(cpu, plan_c, nbw, st, ln)))
    ms = device_ms(seg_hist_dev(pay, plan_d, nbw, 777, R, n))
    own_ms = device_ms(lambda: ownership_hist(pay, plan_d, *args))
    plain_ms = device_ms(lambda: pk.seg_hist_plain(pay, plan_d, *args),
                         reps=5)
    lib_ms = library_hist_segments(pay, plan, nbw, [(777, R)])
    b_ms, b_by = bound_ms(R * lane_bytes + plane_bytes, 2.0 * R * G)
    log("seg_hist, %d lanes from lane 777: two launches bit-identical, "
        "equal to the ownership routine, bit-identical to the plain version "
        "on the CPU (and on every lane in one bin, and on %d ragged "
        "segments: (start, length) %s); median time per call: kernel %.4f "
        "ms (the device form: the segment in device memory, the fixed grids "
        "of a %d-lane payload), ownership routine %.4f ms, plain %.4f ms, "
        "index_add_ %.4f ms; bound %.4f ms (%s)"
        % (R, len(cases), cases, ms, n, own_ms, plain_ms, lib_ms, b_ms,
           b_by))
    log("seg_hist, %d lanes, every lane in bin 7: kernel %.4f ms, ownership "
        "routine %.4f ms, index_add_ %.4f ms" % (
            R, device_ms(seg_hist_dev(one, plan_d, nbw, 777, R, n)),
            device_ms(lambda: ownership_hist(one, plan_d, *args)),
            library_hist_segments(one, plan, nbw, [(777, R)])))
    del one
    torch.cuda.empty_cache()
    for ln in SMALL_CHILDREN:
        sa = (nbw, 777, ln)
        log("seg_hist, a small child of %d lanes from lane 777: kernel %.4f "
            "ms, ownership routine %.4f ms, index_add_ %.4f ms; bound %.6f "
            "ms" % (ln, device_ms(seg_hist_dev(pay, plan_d, nbw, 777, ln,
                                                n)),
                    device_ms(lambda: ownership_hist(pay, plan_d, *sa)),
                    library_hist_segments(pay, plan, nbw, [(777, ln)]),
                    bound_ms(ln * lane_bytes + plane_bytes, 2.0 * ln * G)[0]))
    seg_rec = {"name": "seg_hist", "route": "cuda",
               "source": "lightgbm_torch/csrc/seg_hist.cu",
               "replaces": "lightgbm_tpu/ops/pallas_grow.py:866",
               "launches": 0, "max_abs_err": err, "ms": ms,
               "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
               "library_ms": lib_ms}

    # ---- split_pass on a 1M-lane segment, both directions -----------------
    scal = split_scalars(assets, inner, 0, 777, R, 1, 1)
    end = 777 + R + 1024                 # the CPU copies cover the segment
    seg = [(777, R)]
    second0 = sentinel((wp_live, NP), dev, 7)
    runs = []
    for with_hist in (False, False, True):
        d = second0.clone()
        n_left, hist = pk.split_pass(pay, d, scal, plan_d, nbw, wp_live,
                                     with_hist)
        runs.append((d, n_left, hist))
    torch.cuda.synchronize()
    if runs[0][1] != runs[1][1]:
        raise AssertionError("split_pass: two launches give n_left %d and %d"
                             % (runs[0][1], runs[1][1]))
    _same("split_pass: two launches", runs[0][0], runs[1][0])
    _same("split_pass: the source", pay, cpu)
    same_outside("split_pass", runs[0][0], second0, seg, wp_live)
    dst_c = second0[:, :end].cpu().contiguous()
    p_left, p_hist = pk.split_pass(cpu[:, :end].clone(), dst_c, scal, plan_c,
                                   nbw, wp_live, True)
    if p_left != runs[0][1]:
        raise AssertionError("split_pass: n_left %d on the card, %d in the "
                             "plain version" % (runs[0][1], p_left))
    _same("split_pass vs the plain version on the CPU", runs[0][0][:, :end],
          dst_c)
    _same("split_pass: in-pass histogram vs the plain version on the CPU",
          runs[2][2], p_hist)
    _same("split_pass: destination with the in-pass histogram", runs[2][0],
          runs[0][0])
    # the other direction, from a second buffer into a payload: its rows
    # from wp_live on stay as they were
    src_b, pay0_b = pay[:wp_live].clone(), sentinel(tuple(pay.shape), dev, 8)
    dst_b = pay0_b.clone()
    if pk.split_pass(src_b, dst_b, scal, plan_d, nbw, wp_live,
                     False)[0] != p_left:
        raise AssertionError("split_pass, second buffer to payload: n_left")
    _same("split_pass, second buffer to payload vs payload to second buffer",
          dst_b[:wp_live, 777:777 + R], runs[0][0][:, 777:777 + R])
    _same("split_pass, second buffer to payload: the source", src_b,
          pay[:wp_live])
    same_outside("split_pass, second buffer to payload", dst_b, pay0_b, seg,
                 wp_live)
    del src_b, pay0_b, dst_b
    # the in-pass histogram (the counting sort) of the smaller child against
    # seg_hist and the ownership witness over the same lanes
    part1 = runs[2][0]
    child = pk._child(scal, p_left)
    _same("split_pass's in-pass histogram vs seg_hist over the smaller "
          "child", runs[2][2], pk.seg_hist(part1, plan_d, nbw, *child))
    _same("split_pass's in-pass histogram vs the ownership routine",
          runs[2][2], ownership_hist(part1, plan_d, nbw, *child))
    child_d = torch.tensor(child, dtype=torch.int64, device=dev)
    hscr = pk.hist_scratch(part1, G, n)
    hist_ms = device_ms(lambda: pk._launch_hist_dev(
        "split_pass_hist_launch", part1, plan_d, nbw, child_d, *hscr, None))
    log("split_pass's in-pass histogram of the smaller child (%d lanes from "
        "lane %d, partitioned buffer): equal to seg_hist's and the "
        "ownership routine's; kernel %.4f ms, seg_hist %.4f ms, ownership "
        "routine %.4f ms, index_add_ %.4f ms; bound %.4f ms" % (
            child[1], child[0], hist_ms,
            device_ms(lambda: pk.seg_hist(part1, plan_d, nbw, *child)),
            device_ms(lambda: ownership_hist(part1, plan_d, nbw, *child)),
            library_hist_segments(part1, plan, nbw, [child]),
            bound_ms(child[1] * lane_bytes + plane_bytes,
                     2.0 * child[1] * G)[0]))
    dev_err = check_split_device(pay, second0, scal, plan_d, nbw, wp_live,
                                 runs[2], p_left)
    del runs, dst_c, p_hist, part1, hscr
    d = second0.clone()
    scal_d = torch.tensor(scal, dtype=torch.int32, device=dev)
    res = torch.empty(3, dtype=torch.int64, device=dev)
    work = pk.split_scratch(pay)
    ms = device_ms(lambda: pk._launch_split(pay, d, scal_d, res, wp_live,
                                            work))
    done1 = torch.ones(1, dtype=torch.int64, device=dev)
    noop_ms = device_ms(lambda: pk._launch_split(pay, d, scal_d, res,
                                                 wp_live, work, done1))
    plain_ms = device_ms(lambda: pk.split_pass_plain(pay, d, scal, plan_d,
                                                     nbw, wp_live, False),
                         reps=5)
    del d
    torch.cuda.empty_cache()
    b_ms, b_by = bound_ms(2.0 * wp_live * R * 4, float(R))
    log("split_pass, %d lanes from lane 777 (n_left %d) into a second "
        "buffer and back: two launches bit-identical, bit-identical to the "
        "plain version on the CPU (destination, n_left, the in-pass "
        "histogram), the source and every lane and row outside the segment "
        "untouched; median time per call: kernel %.4f ms (the device form: "
        "scalars in device memory, the fixed persistent grids), plain %.4f "
        "ms, no single PyTorch call computes it; bound %.4f ms (%s); with "
        "the done flag set (a no-op step) %.4f ms"
        % (R, p_left, ms, plain_ms, b_ms, b_by, noop_ms))
    sp_rec = {"name": "split_pass", "route": "cuda",
              "source": "lightgbm_torch/csrc/split_pass.cu",
              "replaces": "lightgbm_tpu/ops/pallas_grow.py:292",
              "launches": 0, "max_abs_err": 0.0, "ms": ms,
              "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
              "library_ms": None, "inpass_hist_ms": hist_ms,
              "noop_ms": noop_ms, "device_form_checks": dev_err}
    sp_rec.update(wide_partition(pay, plan_d, plan_c, nbw, n, scal, R))
    records.append(sp_rec)
    records.append(seg_rec)
    level_recs, cons, scan_b256 = phase_level_kernels(
        pay, cpu, second0, assets, inner, meta, gc, params)
    sp_rec.update(cons)
    records += level_recs
    del pay, cpu, host, assets, second0
    torch.cuda.empty_cache()
    return records, scan_b256


def phase_level_kernels(pay, cpu, second0, assets, inner, meta, gc, params):
    """level_pass and level_seg_hist against their plain versions on the
    pristine HIGGS payload `pay` (and its CPU copy) cut into 128 slots, as
    at depth 8 of a 256-leaf tree (a lane left out between neighbours), the
    level written into a copy of the second buffer `second0`; the
    consolidation of half of the slots back into the payload; and scan_pair
    at B = 256 on the level's children. Returns (the two kernel records,
    the consolidation's numbers for split_pass's record, scan_pair's
    numbers at B = 256 for its record)."""
    import torch
    from lightgbm_torch.ops import payload_kernels as pk
    from lightgbm_torch.ops.scan import (ScanLayout, pair_scalars, scan_pair,
                                         scan_pair_plain)
    dev = pay.device
    WPA, NP, G, plan, nbw, n = assets.geometry[:6]
    plan_c, plan_d = pk.plan_tensor(plan, "cpu"), pk.plan_tensor(plan, dev)
    wp_live = nbw + 5
    S = 128
    rng = np.random.default_rng(2)
    cover = random_segments(rng, n, S)
    slots = [(st + 1, ln - 2) for st, ln in cover]
    lanes = sum(ln for _, ln in slots)
    F = inner.num_features
    scal = np.array([split_scalars(assets, inner, j % F, s0, n_l, j % 2,
                                   (j // 2) % 2) + [0]
                     for j, (s0, n_l) in enumerate(slots)], np.int64)

    # ---- level_pass: the partition of all 128 slots ------------------------
    runs = []
    for with_hist in (False, False, True):
        d = second0.clone()
        n_left, hist = pk.level_pass(pay, d, scal, plan_d, nbw, wp_live,
                                     with_hist)
        runs.append((d, n_left, hist))
    torch.cuda.synchronize()
    if not np.array_equal(runs[0][1], runs[1][1]):
        raise AssertionError("level_pass: two launches give different "
                             "n_left")
    _same("level_pass: two launches", runs[0][0], runs[1][0])
    _same("level_pass: the source", pay, cpu)
    same_outside("level_pass", runs[0][0], second0, slots, wp_live)
    t = time.time()
    sub = second0.cpu()
    p_left, p_hist = pk.level_pass(cpu, sub, scal, plan_c, nbw, wp_live,
                                   True)
    log("level_pass: the plain version on the CPU took %.1f s" % (
        time.time() - t))
    if not np.array_equal(p_left, runs[0][1]):
        raise AssertionError("level_pass: n_left differs from the plain "
                             "version on the CPU")
    _same("level_pass vs the plain version on the CPU", runs[0][0], sub)
    _same("level_pass: in-pass histograms vs the plain version on the CPU",
          runs[2][2], p_hist)
    _same("level_pass: destination with the in-pass histograms", runs[2][0],
          runs[0][0])
    part = runs[0][0]
    inpass = runs[2][2]
    del runs
    kids = pk.level_children(scal, p_left)
    small = sum(ln for _, ln in kids)

    # ---- level_seg_hist: the smaller children after the partition -----------
    htab = pk._multi_hist_tables(kids, G, dev)
    k1 = pk.level_seg_hist(part, plan_d, nbw, kids)
    k2 = pk.level_seg_hist(part, plan_d, nbw, kids)
    own = ownership_multi(part, plan_d, nbw, htab)
    torch.cuda.synchronize()
    _same("level_seg_hist: two launches", k1, k2)
    _same("level_seg_hist vs the ownership routine over the same children",
          k1, own)
    _same("level_pass's in-pass histograms vs level_seg_hist over the same "
          "children", inpass, k1)
    err_seg = _same("level_seg_hist vs the plain version on the CPU", k1,
                    p_hist)
    # zero-length, one-lane and ragged segments in one table
    odd = [(st, ln) for st, ln in SEG_CASES if st + ln <= n] + [(n - 1, 1),
                                                                 (n, 0)]
    err_seg = max(err_seg, _same(
        "level_seg_hist over %s vs the plain version on the CPU" % odd,
        pk.level_seg_hist(part, plan_d, nbw, odd),
        pk.level_seg_hist_plain(sub, plan_c, nbw, odd)))
    del k1, k2, own, p_hist, inpass

    # ---- consolidation: half of the slots back into the payload ------------
    back = slots[1::2]
    c_dev = pay.clone()
    pk.consolidate(part, c_dev, back, wp_live)
    ref = pay.clone()
    for st, ln in back:
        ref[:wp_live, st:st + ln].copy_(part[:, st:st + ln])
    c_cpu = cpu.clone()
    pk.consolidate_plain(sub, c_cpu, back, wp_live)
    torch.cuda.synchronize()
    _same("consolidate vs one copy_ per segment", c_dev, ref)
    _same("consolidate vs the plain version on the CPU", c_dev, c_cpu)
    _same("consolidate: the source", part, sub)
    del c_dev, ref, c_cpu
    # timed over every lane: the most a tree can consolidate
    c_dst = pay.clone()
    ctab = torch.tensor(cover, dtype=torch.int64, device=dev)
    cons_ms = device_ms(lambda: pk._launch_consolidate(
        part, c_dst, wp_live, ctab, -(-NP // 1024), False))
    # the grower's form: a leaf table of 2 * S entries (the even-depth
    # leaves with length 0), over the same lanes
    ltab = torch.zeros((2 * S, 2), dtype=torch.int64, device=dev)
    ltab[1::2] = ctab
    _same("consolidate from a %d-entry leaf table vs the plain version on "
          "the CPU" % (2 * S),
          run_consolidate_device(part, pay, ltab, wp_live),
          run_consolidate_plain(sub, cpu, cover, wp_live))
    cons_dev_ms = device_ms(lambda: pk._launch_consolidate(
        part, c_dst, wp_live, ltab, -(-NP // 1024), False))
    cons_plain = device_ms(lambda: pk.consolidate_plain(part, c_dst, cover,
                                                        wp_live), reps=5)
    cons_lib = device_ms(lambda: c_dst[:wp_live, :n].copy_(part[:, :n]))
    del c_dst
    torch.cuda.empty_cache()
    cons_bound, cons_by = bound_ms(2.0 * wp_live * n * 4, 0.0)
    log("consolidate, %d of the slots' segments from the second buffer into "
        "the payload: equal to one copy_ per segment and bit-identical to "
        "the plain version on the CPU, the source untouched; over all %d "
        "lanes in %d segments, median time per call: kernel %.4f ms, plain "
        "%.4f ms, one copy_ %.4f ms; bound %.4f ms (%s); from a "
        "256-entry leaf table (the grower's form) %.4f ms"
        % (len(back), n, S, cons_ms, cons_plain, cons_lib, cons_bound,
           cons_by, cons_dev_ms))
    cons = {"consolidate_ms": cons_ms, "consolidate_plain_ms": cons_plain,
            "consolidate_leaf_table_ms": cons_dev_ms,
            "consolidate_bound_ms": cons_bound,
            "consolidate_library_ms": cons_lib, "consolidate_launches": 0}

    # ---- times ---------------------------------------------------------------
    tables = pk._level_tables(scal, dev)
    d = second0.clone()
    lp_ms = device_ms(lambda: pk._launch_level(pay, d, wp_live, tables))
    lp_plain = device_ms(lambda: pk.level_pass_plain(pay, d, scal, plan_d,
                                                     nbw, wp_live, False),
                         reps=3, warmup=1)
    rows = [torch.tensor(r[:pk.N_SCALARS].tolist(), dtype=torch.int32,
                         device=dev) for r in scal if r[pk.S_NL] > 0]
    res = torch.empty(3, dtype=torch.int64, device=dev)
    work = pk.split_scratch(pay)
    lp_split = device_ms(lambda: [pk._launch_split(pay, d, r, res, wp_live,
                                                   work)
                                  for r in rows], reps=5, warmup=1)
    del d
    torch.cuda.empty_cache()
    lp_bound, lp_by = bound_ms(2.0 * wp_live * lanes * 4 + scal.size * 4,
                               float(lanes))
    lpk = pk._multi_hist_tables(kids, G, dev)
    lp_hist = device_ms(lambda: pk._launch_multi_hist(
        "level_pass", "level_pass_hist_launch", part, plan_d, nbw, lpk))
    log("level_pass, %d slots over %d lanes (smaller children %d lanes) "
        "into a second buffer: two launches bit-identical, bit-identical to "
        "the plain version on the CPU (destination, n_left, the in-pass "
        "histograms), the source and every lane outside the segments "
        "untouched; median time per call: kernel %.4f ms (the partition "
        "launches, without the wrapper's host sync for n_left), plain %.4f "
        "ms, %d split_pass partitions %.4f ms, no single PyTorch call "
        "computes it; bound %.4f ms (%s); the in-pass histograms %.4f ms"
        % (S, lanes, small, lp_ms, lp_plain, len(rows), lp_split, lp_bound,
           lp_by, lp_hist))
    ls_ms = device_ms(lambda: pk._launch_multi_hist(
        "level_seg_hist", "level_seg_hist_launch", part, plan_d, nbw, htab))
    own_ms = device_ms(lambda: ownership_multi(part, plan_d, nbw, htab))
    ls_plain = device_ms(lambda: pk.level_seg_hist_plain(part, plan_d, nbw,
                                                         kids),
                         reps=3, warmup=1)
    live = [(st, ln) for st, ln in kids if ln > 0]
    live_d = [torch.tensor(c, dtype=torch.int64, device=dev) for c in live]
    hscr = pk.hist_scratch(part, G, n)
    ls_split = device_ms(lambda: [pk.seg_hist_device(part, plan_d, nbw, c,
                                                     *hscr)
                                  for c in live_d], reps=5, warmup=1)
    ls_lib = library_hist_segments(part, plan, nbw, kids)
    ls_bound, ls_by = bound_ms(small * (4 * nbw + 8) + S * 2 * G * 256 * 4,
                               2.0 * small * G)
    log("level_seg_hist, %d smaller children, %d lanes: two launches "
        "bit-identical, equal to the ownership routine and to level_pass's "
        "in-pass histograms, bit-identical to the plain version on the CPU "
        "(and on %d ragged, one-lane and zero-length segments); median time "
        "per call: kernel %.4f ms, ownership routine %.4f ms, plain %.4f ms, "
        "%d seg_hist launches %.4f ms, index_add_ %.4f ms; bound %.4f ms "
        "(%s)" % (S, small, len(odd), ls_ms, own_ms, ls_plain, len(live),
                  ls_split, ls_lib, ls_bound, ls_by))

    # ---- scan_pair at B = 256: both children of every slot -------------------
    # the level's 256 children are the rows of [256, G * 256] planes, read in
    # a random order through rows and the layout's gidx
    both = [c for (s0, n_l), nl in zip(slots, p_left)
            for c in ((s0, int(nl)), (s0 + int(nl), n_l - int(nl)))]
    gh, hh = pk.level_seg_hist(part, plan_d, nbw, both)
    sg, sh, cnt = segment_sums(part, nbw, both)
    order = rng.permutation(len(both))
    group_of, ls, nb = assets.efb[0], assets.efb[1], assets.efb[2]
    start = group_of.astype(np.int64) * 256 + ls
    layout = ScanLayout(start, start + nb, meta.missing_type,
                        meta.default_bin, meta.penalty, np.ones(F, bool),
                        gc.scan_width, G * 256, dev)
    sc = torch.as_tensor(pair_scalars(
        sg[order], sh[order], cnt[order], params.lambda_l2,
        params.min_gain_to_split, params.min_data_in_leaf,
        params.min_sum_hessian_in_leaf), device=dev)
    masks = (layout.keep_r, layout.keep_f, layout.valid_r, layout.valid_f,
             layout.aux)
    maps = {"rows": torch.as_tensor(order, device=dev), "gidx": layout.gidx}
    k = scan_pair(sc, gh, hh, *masks, **maps)
    _same("scan_pair B=%d: two launches" % len(both), k,
          scan_pair(sc, gh, hh, *masks, **maps))
    _same("scan_pair B=%d vs the plain version on the CPU" % len(both), k,
          scan_pair(sc.cpu(), gh.cpu(), hh.cpu(), *[m.cpu() for m in masks],
                    **{n: v.cpu() for n, v in maps.items()}))
    sp_ms = device_ms(lambda: scan_pair(sc, gh, hh, *masks, **maps))
    rows_d = maps["rows"]
    sp_old = device_ms(lambda: scan_pair(sc, gh[rows_d][:, layout.gidx],
                                         hh[rows_d][:, layout.gidx], *masks))
    gb = gh[rows_d][:, layout.gidx]
    sp_bound, _ = scan_pair_bound(sc, gb, layout, k)
    log("scan_pair B=%d F=%d Wp=%d (the level's children, rows in a random "
        "order of [%d, %d] planes): two launches bit-identical, "
        "bit-identical to the plain version on the CPU; median time per "
        "call %.4f ms (previous design: %.4f), the gathered sequence (four "
        "torch gathers, then the kernel on the gathered planes) %.4f ms; "
        "bound %.6f ms"
        % (len(both), F, layout.Wp, len(both), G * 256, sp_ms,
           PREVIOUS_MS["scan_pair B=256"], sp_old, sp_bound))
    scan_b256 = {"b256_ms": sp_ms, "b256_bound_ms": sp_bound,
                 "b256_gathers_and_kernel_ms": sp_old}
    del part, sub, gh, hh, gb, k
    torch.cuda.empty_cache()
    return [
        {"name": "level_pass", "route": "cuda",
         "source": "lightgbm_torch/csrc/level_pass.cu",
         "replaces": "lightgbm_tpu/ops/pallas_grow.py:543",
         "launches": 0, "max_abs_err": 0.0, "ms": lp_ms,
         "plain_ms": lp_plain, "bound_ms": lp_bound, "bound_by": lp_by,
         "library_ms": None, "inpass_hist_ms": lp_hist},
        {"name": "level_seg_hist", "route": "cuda",
         "source": "lightgbm_torch/csrc/level_seg_hist.cu",
         "replaces": "lightgbm_tpu/ops/pallas_grow.py:785",
         "launches": 0, "max_abs_err": err_seg, "ms": ls_ms,
         "plain_ms": ls_plain, "bound_ms": ls_bound, "bound_by": ls_by,
         "library_ms": ls_lib},
    ], cons, scan_b256


def logloss(y, raw):
    """Binary logloss of raw scores (tensors on one device), in f64."""
    import torch
    p = torch.sigmoid(raw.double()).clamp(1e-15, 1 - 1e-15)
    y = y.double()
    return float(-(y * torch.log(p) + (1 - y) * torch.log(1 - p)).mean())


def multi_logloss(y, raw):
    """Multiclass logloss of [K, n] raw scores and [n] class labels
    (tensors on one device), in f64: the mean of -log softmax[label]."""
    import torch
    lp = torch.log_softmax(raw.double(), dim=0)
    return float(-lp.gather(0, y.long()[None]).mean())


def l2_loss(y, raw):
    """Mean squared error of raw scores, in f64."""
    return float(((raw.double() - y.double()) ** 2).mean())


def l1_loss(y, raw):
    """Mean absolute error of raw scores, in f64."""
    return float((raw.double() - y.double()).abs().mean())


LOSSES = {"multiclass": ("multi_logloss", multi_logloss),
          "regression": ("l2 loss", l2_loss), "l1": ("l1 loss", l1_loss)}


def higgs_latent(n, seed=7):
    """(X, y, latent): make_higgs_like's rows and labels, and the f32
    latent it thresholds at 0 (its logit plus its logistic noise, redrawn
    from the same seed): the source of the multiclass and regression
    targets."""
    from lightgbm_torch.data.synth import make_higgs_like
    X, y = make_higgs_like(n, seed=seed)
    rng = np.random.default_rng(seed)
    rng.normal(size=(n, X.shape[1]))            # the features' draw
    x = X.astype(np.float32)
    logit = (0.8 * x[:, 0] - 0.5 * x[:, 1] + 0.4 * x[:, 21]
             - 0.3 * x[:, 22] + 0.5 * np.tanh(x[:, 4] * x[:, 5]))
    del x
    latent = logit + rng.logistic(size=n).astype(np.float32) * 0.8
    if not np.array_equal(latent > 0, y > 0):
        raise AssertionError("the redrawn latent does not threshold to "
                             "make_higgs_like's labels")
    return X, y, latent


def quantile_classes(latent, K):
    """K classes of equal size: the latent cut at its 1/K quantiles (the
    upstream multiclass example's num_class, on HIGGS-shaped rows)."""
    return np.digitize(latent, np.quantile(latent, np.arange(1, K) / K)) \
        .astype(np.float64)


def l2_target(latent, seed=13):
    """The latent plus standard Gaussian noise."""
    return latent + np.random.default_rng(seed).normal(size=len(latent))


def phase_block_kernels(inner, meta, gc, params):
    """scan_blocks against its plain version at the bundled path's shape:
    B = 256 children (the 256 segments of the Expo payload cut as a tree
    level's children), read in a random order from their [256, G * 256]
    group planes in place, with the dataset's mask stack; the gathered
    sequence (the rows gathered and padded to [Gp, Wp], then the kernel)
    and scan_pair over the same planes gathered into per-feature windows
    timed beside it. Returns the kernel record."""
    import torch
    import torch.nn.functional as F_
    from lightgbm_torch.ops import payload_kernels as pk
    from lightgbm_torch.ops.block_scan import (BlockScanLayout, scan_blocks,
                                               scan_blocks_plain)
    from lightgbm_torch.ops.payload import build_assets
    from lightgbm_torch.ops.scan import ScanLayout, pair_scalars, scan_pair
    dev = torch.device("cuda")
    assets = build_assets(inner, inner.metadata.label)
    WPA, NP, G, plan, nbw, n = assets.geometry[:6]
    rng = np.random.default_rng(3)
    host = assets.pay0.view(np.int32)
    host[nbw + 2, :n] = rng.normal(size=n).astype(np.float32).view(np.int32)
    host[nbw + 3, :n] = rng.uniform(0.05, 0.25, n).astype(np.float32) \
        .view(np.int32)
    pay = torch.from_numpy(host).to(dev)
    plan_d = pk.plan_tensor(plan, dev)
    # root_hist at the bundled path's root: 18 groups in byte and nibble
    # slots, each bundle's shared zero bin holding most lanes
    check_root_hist(pay, torch.from_numpy(host), plan, nbw, n, "Expo")
    B = 256
    segs = random_segments(rng, n, B)
    gh, hh = pk.level_seg_hist(pay, plan_d, nbw, segs)
    sg, sh, cnt = segment_sums(pay, nbw, segs)
    order = rng.permutation(B)
    scal8 = pair_scalars(sg[order], sh[order], cnt[order], params.lambda_l2,
                         params.min_gain_to_split, params.min_data_in_leaf,
                         params.min_sum_hessian_in_leaf)
    scal = torch.as_tensor(np.concatenate([scal8, sh[order, None]], axis=1),
                           device=dev)
    blk = BlockScanLayout(assets.efb, meta.penalty, G, dev)
    masks = blk.tree_masks(np.ones(inner.num_features, bool))
    rows = torch.as_tensor(order, device=dev)
    args = (scal, gh, hh, masks, blk.do_fix, rows, G)
    k1 = scan_blocks(*args)
    k2 = scan_blocks(*args)
    torch.cuda.synchronize()
    _same("scan_blocks: two launches", k1, k2)
    err = _same("scan_blocks vs the plain version on the CPU", k1,
                scan_blocks(*[a.cpu() if torch.is_tensor(a) else a
                              for a in args]))
    pad = (0, blk.Wp - 256, 0, blk.Gp - G)

    def gathered():
        return (F_.pad(gh[rows].reshape(B, G, 256), pad),
                F_.pad(hh[rows].reshape(B, G, 256), pad))
    gb, hb = gathered()
    _same("scan_blocks: the rows form vs the gathered form", k1,
          scan_blocks(scal, gb, hb, masks, blk.do_fix))
    fin = torch.isfinite(k1[:, 0]).sum().item()
    ms = device_ms(lambda: scan_blocks(*args))
    old_ms = device_ms(lambda: scan_blocks(scal, *gathered(), masks,
                                           blk.do_fix))
    plain_ms = device_ms(lambda: scan_blocks_plain(scal, gb, hb, masks,
                                                   blk.do_fix),
                         reps=3, warmup=1)
    floor_ms = device_ms(launch_floor)
    nbytes = (scal.numel() + 2 * B * G * 256 + masks.numel()
              + k1.numel()) * 4 + B * 8
    b_ms, b_by = bound_ms(nbytes, 40.0 * gb.numel())
    # scan_pair over the same planes gathered into per-feature windows
    start = assets.efb[0].astype(np.int64) * 256 + assets.efb[1]
    layout = ScanLayout(start, start + assets.efb[2], meta.missing_type,
                        meta.default_bin, meta.penalty,
                        np.ones(inner.num_features, bool), gc.scan_width,
                        G * 256, dev)
    pargs = (torch.as_tensor(scal8, device=dev), gh, hh, layout.keep_r,
             layout.keep_f, layout.valid_r, layout.valid_f, layout.aux)
    pair_ms = device_ms(lambda: scan_pair(*pargs, rows=rows,
                                          gidx=layout.gidx))
    log("scan_blocks B=%d G=%d (Gp=%d) Wp=%d, %d features, do_fix=%s, rows "
        "in a random order of [%d, %d] planes: two launches bit-identical, "
        "equal to the gathered form, bit-identical to the plain version on "
        "the CPU (%d groups with a split); median time per call: kernel "
        "%.4f ms (previous design: %.4f), the gathered sequence (rows "
        "gathered and padded, then the kernel) %.4f ms, plain %.4f ms, no "
        "single PyTorch call computes it; launch floor %.4f ms; bound %.6f "
        "ms (%s); scan_pair over the %d per-feature windows (Fp=%d, Wp=%d) "
        "%.4f ms"
        % (B, G, blk.Gp, blk.Wp, inner.num_features, blk.do_fix, B, G * 256,
           fin, ms, PREVIOUS_MS["scan_blocks"], old_ms, plain_ms, floor_ms,
           b_ms, b_by, inner.num_features, layout.Fp, layout.Wp, pair_ms))
    del pay, host, assets, gh, hh, gb, hb, args, pargs
    torch.cuda.empty_cache()
    return {"name": "scan_blocks", "route": "cuda",
            "source": "lightgbm_torch/csrc/scan_blocks.cu",
            "replaces": "lightgbm_tpu/ops/pallas_scan.py:525",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "launch_floor_ms": floor_ms,
            "gathers_and_kernel_ms": old_ms}


# name: (parameters beyond COMMON, kernels the path launches, kernels it
# must not launch). grow_* are the grow_step kernels and apply_scores the
# score update (ops/grow_step.py).
COMMON = {"objective": "binary", "max_bin": 255, "verbosity": -1}
STEPS = ("grow_root", "grow_pick", "grow_commit", "grow_planes",
         "grow_assemble")
PATHS = {
    "persist": ({"num_leaves": 255, "tpu_persist_scan": "auto"},
                ("root_hist", "split_pass", "seg_hist", "scan_pair",
                 "consolidate", "apply_scores") + STEPS,
                ("hist_window", "level_pass", "level_seg_hist",
                 "scan_blocks")),
    "v1": ({"num_leaves": 255, "tpu_persist_scan": "false"},
           ("hist_window", "scan_pair"),
           ("root_hist", "split_pass", "seg_hist", "level_pass",
            "level_seg_hist", "scan_blocks", "consolidate",
            "apply_scores") + STEPS),
    "level": ({"num_leaves": 256, "max_depth": 8},
              ("root_hist", "level_pass", "level_seg_hist", "scan_pair",
               "apply_scores"),
              ("hist_window", "scan_blocks", "grow_root")),
    "bundled": ({"num_leaves": 256, "max_depth": 8},
                ("root_hist", "level_pass", "scan_blocks", "apply_scores"),
                ("hist_window", "scan_pair", "seg_hist", "level_seg_hist",
                 "grow_root")),
}
# the multiclass (K = 5, the upstream examples/multiclass_classification
# train.conf's num_class) and regression paths take the per-split route
PATHS["multiclass"] = ({"objective": "multiclass", "num_class": 5,
                        "num_leaves": 255, "tpu_persist_scan": "auto"},
                       ) + PATHS["persist"][1:]
PATHS["regression"] = ({"objective": "regression", "num_leaves": 255,
                        "tpu_persist_scan": "auto"},) + PATHS["persist"][1:]
# L1 (upstream examples/regression with objective=regression_l1) renews
# every tree's leaves inside the per-split graph
PATHS["l1"] = ({"objective": "regression_l1", "num_leaves": 255,
                "tpu_persist_scan": "auto"},
               PATHS["persist"][1] + ("renew_leaf",), PATHS["persist"][2])
# MSLR lambdarank (bench_full.py:101-120: MSLR-WEB30K's width, truncation
# level 30; the per-split persistent grower, the pairwise lambdas in its
# graph) and rank_xendcg on the same rows (the v1 grower)
LTR = {"objective": "lambdarank", "num_leaves": 255,
       "lambdarank_truncation_level": 30}
RANK_PATHS = ("ltr", "xendcg")
V1_PATHS = ("v1", "xendcg", "knobs")
CAT_PATHS = ("airline", "airline onehot")
PATHS["ltr"] = (dict(LTR, tpu_persist_scan="auto"),
                PATHS["persist"][1] + ("lambdarank_grad",),
                PATHS["persist"][2] + ("xendcg_grad",))
PATHS["xendcg"] = (dict(LTR, objective="rank_xendcg", tpu_persist_scan="auto"),
                   PATHS["v1"][1] + ("xendcg_grad",),
                   PATHS["v1"][2] + ("lambdarank_grad",))
# the split scan's numerical knobs, all at once (KNOB_PARAMS), by default
# routing: the v1 grower with scan_pair's knob form (scan_pair_knob)
PATHS["knobs"] = (dict(KNOB_PARAMS, num_leaves=255, tpu_persist_scan="auto"),
                  ("hist_window", "scan_pair_knob"),
                  PATHS["v1"][2] + ("scan_pair",))
# categorical features (the airline set's six columns) on the v1 grower,
# the default routing: scan_pair over the numerical features, cat_scan over
# the categorical ones, one launch each per evaluation; the default
# max_cat_to_onehot (4: every column takes the sorted many-vs-many scan)
# and 32 (one-hot for Month, DayofMonth, DayOfWeek and UniqueCarrier)
AIRLINE = {"num_leaves": 255, "tpu_persist_scan": "auto",
           "categorical_feature": "0,1,2,3,4,5"}
PATHS["airline"] = (AIRLINE, ("hist_window", "scan_pair", "cat_scan"),
                    PATHS["v1"][2] + ("scan_pair_knob",))
PATHS["airline onehot"] = (dict(AIRLINE, max_cat_to_onehot=32),
                           ) + PATHS["airline"][1:]
V1_PATHS += ("airline", "airline onehot")
# row sampling on the per-split persistent grower, the bag step in its
# graph: bagging as upstream examples/binary_classification/train.conf sets
# it (bagging_fraction 0.8, bagging_freq 5), and GOSS (top_rate 0.2,
# other_rate 0.1; learning_rate 0.5, so sampling starts at iteration 2)
BAG_PATHS = ("bagging", "goss")
PATHS["bagging"] = ({"num_leaves": 255, "tpu_persist_scan": "auto",
                     "bagging_fraction": 0.8, "bagging_freq": 5},
                    PATHS["persist"][1] + ("bag_apply",),
                    PATHS["persist"][2] + ("goss_select",))
PATHS["goss"] = ({"num_leaves": 255, "tpu_persist_scan": "auto",
                  "boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
                  "learning_rate": 0.5},
                 PATHS["persist"][1] + ("bag_apply", "goss_select"),
                 PATHS["persist"][2])
# DART (drop_rate 0.3, the rest at its defaults) and RF (bagging_fraction
# 0.7, bagging_freq 1) on the per-split persistent grower, by default
# routing: DART's drop and normalize walk the payload between the graph's
# replays (valid_walk_payload, counted by its wrapper); RF's iteration
# bags with the host's mask (bag_apply's rows form, slot bag_rows) and
# ends with the running average (apply_scores_avg) in the graph
DART_RF_PATHS = ("dart", "rf")
DART_RF_ITERS = 8      # iterations of each; a short run cuts rows, not these
PATHS["dart"] = ({"num_leaves": 255, "tpu_persist_scan": "auto",
                  "boosting": "dart", "drop_rate": 0.3},
                 PATHS["persist"][1] + ("valid_walk_payload",),
                 PATHS["persist"][2] + ("bag_apply", "bag_rows",
                                        "apply_scores_avg"))
PATHS["rf"] = ({"num_leaves": 255, "tpu_persist_scan": "auto",
                "boosting": "rf", "bagging_fraction": 0.7,
                "bagging_freq": 1},
               tuple(k for k in PATHS["persist"][1] if k != "apply_scores")
               + ("bag_rows", "apply_scores_avg"),
               PATHS["persist"][2] + ("apply_scores", "bag_apply",
                                      "valid_walk_payload"))
# the model digests that the earlier paths' full runs recorded (sha256 of
# the model text without its parameters; first and last hex digits,
# PERF.md section 6): a run at the default sizes must reproduce them.
# (PERF.md had bundled's tail as "a85fe823", a miscopy of "...a8f414fe823":
# its 8 leading and 5 trailing digits agree with the digest printed since.
# goss's text now starts with its driver's name, "goss", for "tree": the
# same text with "tree" first hashes to the digest recorded before,
# 5ff7b4ad...0712.)
KNOWN_DIGESTS = {"persist": ("cab22751", "49c488"),
                 "v1": ("b122b60b", "eedebe"),
                 "level": ("b9771780", "807332c"),
                 "multiclass": ("40635bfe", "44a85dc"),
                 "regression": ("277f605d", "9145ce"),
                 "bundled": ("32e491a8", "fe823"),
                 "l1": ("55c69e16", "d731d22a"),
                 "bagging": ("8dad1e05", "0c85"),
                 "goss": ("61428ba6", "1eaa6b"),
                 "dart": ("3f872a5d", "5f3913e2"),
                 "rf": ("d7e4138f", "c8fa3f1f")}
FULL_SIZE = {"on": False}     # main sets it when every size is the default
# the kernels whose launches a Python counter counts (they run eagerly on
# every path); every other kernel of the paths counts its launches on the
# device (ops/counters.py), replays of a CUDA graph included
PY_COUNTED = ("hist_window", "level_pass", "level_seg_hist", "valid_walk",
              "valid_walk_payload")


def _wrappers():
    from lightgbm_torch.ops.histogram import hist_window
    from lightgbm_torch.ops.payload_kernels import level_pass, level_seg_hist
    from lightgbm_torch.ops.valid_walk import valid_walk, valid_walk_payload
    return {"hist_window": hist_window, "level_pass": level_pass,
            "level_seg_hist": level_seg_hist, "valid_walk": valid_walk,
            "valid_walk_payload": valid_walk_payload}


def reset_counts():
    """Every launch count to 0: the Python counters of PY_COUNTED and the
    device counters."""
    from lightgbm_torch.ops import counters
    for w in _wrappers().values():
        w.launches = 0
    counters.reset("cuda")


def read_counts():
    """The launch counts since reset_counts (reads the device counters)."""
    from lightgbm_torch.ops import counters
    out = {name: w.launches for name, w in _wrappers().items()}
    out.update(counters.read("cuda"))
    return out


def has_odd_leaf(tree) -> bool:
    """Does a leaf of `tree` lie at an odd depth? (A walk over the model's
    child arrays, apart from the grower's own bookkeeping: such a leaf's
    segment ends the tree in the second buffer.)"""
    stack = [(0, 0)] if tree.num_leaves > 1 else []
    while stack:
        node, depth = stack.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child < 0:
                if depth % 2 == 0:
                    return True
            else:
                stack.append((child, depth + 1))
    return False


def expected_launches(bst, trees, drops=0):
    """Each kernel's launches for the trees of `bst`: v1 scans and
    histograms once per node; the persistent grower runs root_hist per
    tree, one level_pass (level_seg_hist when G > 20) and one scan per
    level program, one split_pass (seg_hist when G > 20) and one scan per
    split of its per-split loop (the device steps after a tree stops
    growing do nothing and count nothing), the grow_step kernels once per
    split (grow_root and the root's assembly once per tree without a level
    phase), one consolidate per tree with a leaf at an odd depth and one
    score update per tree with a split; with leaf renewal one renew_leaf
    per tree with a split, on either grower; with a ranking objective its
    gradient kernel once per iteration; on a categorical Dataset (v1)
    cat_scan once per evaluation, as scan_pair; with a bag on the persistent
    grower bag_apply once per tree and, for GOSS, goss_select once per
    iteration from int(1 / learning_rate) on; for RF the bag step's rows
    form and the running average once per tree (no bag_apply, no score
    add); for DART valid_walk_payload twice per dropped tree (`drops`).
    Returns (counts, per-tree (level programs, per-split splits))."""
    nodes = sum(t.num_leaves for t in trees)
    renew = sum(t.num_leaves > 1 for t in trees) \
        if bst._booster.objective.is_renew_tree_output else 0
    # a ranking objective's gradient pass: once per iteration
    grad = {"lambdarank": "lambdarank_grad", "rank_xendcg": "xendcg_grad"}
    rank = {grad[bst._booster.objective.name]: len(trees)
            // bst._booster.num_tree_per_iteration} \
        if bst._booster.objective.name in grad else {}
    if not bst._booster.use_persist:
        scan = ("scan_pair_knob" if bst._booster.tree_learner.knobs
                else "scan_pair")
        # a categorical Dataset: one cat_scan beside each scan
        cat = nodes if bst._booster.tree_learner.cat is not None else 0
        return dict({"hist_window": nodes, scan: nodes, "cat_scan": cat,
                     "renew_leaf": renew}, **rank), []
    gr = bst._booster.tree_learner._persist_gr
    stats = gr.grow_stats
    if len(stats) != len(trees):
        raise AssertionError("grow_stats has %d trees, the model %d"
                             % (len(stats), len(trees)))
    T = len(trees)
    lv = sum(a for a, _ in stats)
    fb = sum(b for _, b in stats)
    sep = not gr.inpass_hist
    roots = 0 if gr.use_level else T
    scan = "scan_blocks" if gr.blocks is not None else "scan_pair"
    bagged = bst._booster.bag_spec()
    K = bst._booster.num_tree_per_iteration
    if bagged[0] == "goss":
        skip = int(1.0 / float(bst._booster.config.learning_rate))
        rank["goss_select"] = sum(i >= skip for i in range(T // K))
    # RF: the rows form of the bag step and the running average in place
    # of bag_apply's hashed forms and the score add; DART: two payload
    # walks per dropped tree (its subtraction and its normalization)
    rf = bst._booster.config.boosting == "rf"
    grown = sum(t.num_leaves > 1 for t in trees)
    return {"root_hist": T, "level_pass": lv, "split_pass": fb,
            "bag_apply": T if bagged[0] != "none" and not rf else 0,
            "bag_rows": T if rf else 0,
            "level_seg_hist": lv if sep else 0, "seg_hist": fb if sep else 0,
            scan: T + lv + fb,
            "consolidate": sum(has_odd_leaf(t) for t in trees),
            "grow_root": roots, "grow_pick": fb, "grow_commit": fb,
            "grow_planes": fb, "grow_assemble": fb + roots,
            "apply_scores": 0 if rf else grown,
            "apply_scores_avg": grown if rf else 0,
            "valid_walk_payload": 2 * drops,
            "renew_leaf": renew, **rank}, stats


def model_digest(bst, num_iteration=None) -> str:
    """sha256 of the model text (of its first `num_iteration` iterations;
    by default the Booster's) without its parameters block."""
    import hashlib
    text = bst.model_to_string(num_iteration=num_iteration) \
        .split("\nparameters:")[0]
    return hashlib.sha256(text.encode()).hexdigest()


def d2h_reads(bst):
    """One more boosting iteration under torch.profiler (the card's
    activity only): (its device-to-host copies, host-to-device copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        bst.update()
        torch.cuda.synchronize()
    dtoh = htod = 0
    for ev in prof.key_averages():
        if "Memcpy DtoH" in ev.key:
            dtoh += ev.count
        elif "Memcpy HtoD" in ev.key:
            htod += ev.count
    return dtoh, htod


WALK_ROWS = 1_000_000     # rows the numpy walk checks (it walks ~1M rows/s)


def check_graph(bst, gr, path, walls):
    """The per-split path (no level phase): the first iteration ran eagerly
    under set_sync_debug_mode("error") (any synchronizing torch operation
    raises), the second was captured as one CUDA graph, the later ones
    replayed it; one more iteration reads the card back exactly once. A
    path with a level phase runs eagerly and is only reported."""
    if gr.use_level:
        log("train %s: the level phase runs on the host; its iterations run "
            "eagerly (no graph)" % path)
        return None
    if len(walls) >= 3 and (gr._graph is None or gr.replays != len(walls) - 2):
        raise AssertionError("train %s: %d iterations, %s graph, %d replays"
                             % (path, len(walls), "a" if gr._graph else "no",
                                gr.replays))
    st = gr.graph_stats
    dtoh, htod = d2h_reads(bst)
    log("train %s: iteration 1 (eager, set_sync_debug_mode('error')) %.1f "
        "ms; iteration 2 (capture %.1f ms, instantiate %.1f ms, then the "
        "first replay) %.1f ms; replayed iterations %.1f ms each (mean of "
        "%d); the graph has %s nodes; %d replays so far"
        % (path, walls[0] * 1e3, st.get("capture_ms", float("nan")),
           st.get("instantiate_ms", float("nan")),
           (walls[1] if len(walls) > 1 else float("nan")) * 1e3,
           np.mean(walls[2:]) * 1e3 if len(walls) > 2 else float("nan"),
           max(len(walls) - 2, 0), st.get("nodes"), gr.replays))
    log("train %s: device-to-host reads in one iteration: %d (the tree); "
        "host-to-device copies: %d" % (path, dtoh, htod))
    if dtoh != 1:
        raise AssertionError("train %s: %d device-to-host reads in one "
                             "per-split iteration, expected 1"
                             % (path, dtoh))
    return dtoh, htod


def check_renewed_leaves(bst):
    """One more iteration of a renewal path: each leaf value of its tree
    read back must be the median of label - score over the leaf's rows
    (the payload segment of the device leaf table, mapped to rows through
    the row-id row; the scores before the iteration), computed on the host
    by the port's numpy PercentileFun, rounded to the leaf table's f32 and
    times the learning rate: the renewed values are the ones the tree
    carries."""
    import torch
    from lightgbm_torch.objectives.base import percentile
    b = bst._booster
    gr, pay = b.tree_learner._persist_gr, b.tree_learner._persist_carry
    before = b.train_score.score.cpu().numpy()
    label = b.objective.raw_label.astype(np.float64)
    t = time.time()
    bst.update()
    torch.cuda.synchronize()
    tree = b.models[-1]
    li = gr.state.li.cpu().numpy()
    rid = pay[gr.nbw + 1, :gr.n].cpu().numpy()
    lr = b.shrinkage_rate
    from lightgbm_torch.ops import grow_step as gs
    for leaf in range(tree.num_leaves):
        st, nr = int(li[leaf, gs.LI_START]), int(li[leaf, gs.LI_NROWS])
        rows = rid[st:st + nr]
        want = float(np.float32(percentile(label[rows] - before[rows],
                                           b.objective.renew_alpha))) * lr
        if tree.leaf_value[leaf] != want:
            raise AssertionError(
                "train l1: leaf %d of the last tree is %r, the median of its "
                "%d rows' residuals gives %r" % (leaf, tree.leaf_value[leaf],
                                                 nr, want))
    log("train l1: one more iteration (%.1f s with the host check): every "
        "one of the %d leaves read back is its rows' residual median "
        "(numpy PercentileFun over the payload segment's rows, f32, times "
        "the learning rate), bit for bit" % (time.time() - t,
                                             tree.num_leaves))


def plain_drops(cfg, iters):
    """The dropped iterations of each of `iters` DART iterations, drawn
    apart from the port's code: numpy's Generator at drop_seed in
    DroppingTrees' order (dart.hpp:97-146), the weighted drop (each tree's
    weight its shrinkage, times k / (k + 1) when k trees are dropped with
    it), the max_drop cap, skip_drop."""
    if cfg.uniform_drop or cfg.xgboost_dart_mode:
        raise AssertionError("plain_drops: the weighted drop only")
    rng = np.random.default_rng(cfg.drop_seed)
    weights, out = [], []
    for it in range(iters):
        drop = []
        if not rng.random() < cfg.skip_drop and sum(weights) > 0:
            total = sum(weights)
            inv_avg = len(weights) / total
            rate = cfg.drop_rate
            if cfg.max_drop > 0:
                rate = min(rate, cfg.max_drop * inv_avg / total)
            for i in range(it):
                if rng.random() < rate * weights[i] * inv_avg:
                    drop.append(i)
                    if len(drop) >= cfg.max_drop:
                        break
        k = len(drop)
        for i in drop:
            weights[i] *= k / (k + 1.0)
        weights.append(cfg.learning_rate / (1.0 + k))
        out.append(drop)
    return out


def watch_dart_rf(path, rec):
    """Wrap the DART or RF host steps of the path in hand (None for
    another path): DART's drop and normalize, timed with the card
    synchronized around them, and each iteration's dropped iterations;
    RF's host bag draw (its [n] mask's sum and ms) and its upload into the
    bag step's buffer (ms, the card synchronized around it). Returns the
    function that restores them."""
    import torch
    if path == "dart":
        from lightgbm_torch.boosting.dart import DART
        drop, norm = DART._dropping_trees, DART._normalize

        def timed(fn, key):
            def run(self):
                torch.cuda.synchronize()
                t = time.perf_counter()
                fn(self)
                torch.cuda.synchronize()
                rec.setdefault(key, []).append(
                    (time.perf_counter() - t) * 1e3)
                if key == "drop_ms":
                    rec.setdefault("drops", []).append(list(self.drop_index))
            return run
        DART._dropping_trees = timed(drop, "drop_ms")
        DART._normalize = timed(norm, "normalize_ms")

        def undo():
            DART._dropping_trees, DART._normalize = drop, norm
        return undo
    if path == "rf":
        from lightgbm_torch.boosting.gbdt import GBDT
        from lightgbm_torch.ops.bag import BagState
        draw, put = GBDT._draw_bag, BagState.set

        def drawn(self, it):
            t = time.perf_counter()
            mask = draw(self, it)
            rec.setdefault("draw_ms", []).append(
                (time.perf_counter() - t) * 1e3)
            rec.setdefault("in_bag", []).append(
                None if mask is None else int(mask.sum()))
            return mask

        def uploaded(self, b):
            torch.cuda.synchronize()
            t = time.perf_counter()
            put(self, b)
            torch.cuda.synchronize()
            if b.rows is not None:
                rec.setdefault("upload_ms", []).append(
                    (time.perf_counter() - t) * 1e3)
        GBDT._draw_bag, BagState.set = drawn, uploaded

        def undo():
            GBDT._draw_bag, BagState.set = draw, put
        return undo
    return lambda: None


def check_dart_rf_path(bst, path, rec):
    """After the dart path: each iteration's dropped iterations equal the
    plain replay's (plain_drops) and some iteration dropped trees; the
    walks' times. After the rf path: each tree's in-bag count (its root's
    count) equals the sum of its iteration's host mask, the masks differ,
    the bag step's device buffer holds as many rows in the bag as the
    last tree's root; the host draw's and the upload's times."""
    b = bst._booster
    if path == "dart":
        want = plain_drops(b.config, len(rec["drops"]))
        if rec["drops"] != want:
            raise AssertionError("train dart: dropped iterations %s, the "
                                 "plain replay's %s" % (rec["drops"], want))
        if not sum(len(d) for d in want):
            raise AssertionError("train dart: no iteration dropped a tree")
        log("train dart: dropped iterations per iteration %s = the plain "
            "replay of numpy's Generator at drop_seed %d; drop (subtract "
            "walks) %s ms, normalize (walks) %s ms per iteration, the card "
            "synchronized around each" % (
                rec["drops"], b.config.drop_seed,
                ["%.3f" % v for v in rec["drop_ms"]],
                ["%.3f" % v for v in rec["normalize_ms"]]))
        return
    roots = [int(t.internal_count[0]) for t in b.models]
    bags = rec["in_bag"]
    if None in bags or roots[:len(bags)] != bags or len(set(bags)) < 2:
        raise AssertionError("train rf: rows in the bag per tree %s, the "
                             "host masks' sums %s" % (roots, bags))
    # the buffer holds the mask of the model's last iteration (the run
    # went on past the counted iterations)
    gr = b.tree_learner._persist_gr
    on_card = int(gr.bag.rows.sum())
    if on_card != roots[-1]:
        raise AssertionError("train rf: the bag step's buffer holds %d rows "
                             "in the bag, the last tree %d"
                             % (on_card, roots[-1]))
    log("train rf: rows in the bag per tree %s = each iteration's host "
        "mask's sum (bagging_fraction %g of %d rows); host draw "
        "(rng.random(n) < fraction) %s ms, mask upload %s ms per iteration"
        % (roots, b.config.bagging_fraction, b.train_data.num_data,
           ["%.1f" % v for v in rec["draw_ms"]],
           ["%.3f" % v for v in rec["upload_ms"]]))


def phase_train(lgb, X, y, ds, iters, card, profile, path, off_iters=0,
                keep=None):
    """Train on the card along one path, one iteration at a time (train,
    then Booster.update); returns the launch counts of the run, each
    wrapper's count set to 0 just before it and read just after. The
    training logloss is taken on the device scores after every iteration;
    the numpy walk over the first WALK_ROWS rows checks the final scores.
    With off_iters, then train that many iterations with
    tpu_level_grow=off and hold their scores and raw predictions to the
    first trees' bit for bit. With a dict `keep`, fill it for later phases:
    the model digest after each iteration ("digests"), the first tree
    ("tree"), the host-to-device copies of one iteration ("htod") and one
    more iteration timed and profiled ("iteration": profile_iteration)."""
    import torch
    extra, used, unused = PATHS[path]
    params = dict(COMMON, **extra)
    y_d = torch.as_tensor(y, device="cuda")
    wall, losses, kept, walls = 0.0, [], None, []
    loss_name, loss = LOSSES.get(path, ("logloss", logloss))
    if path in RANK_PATHS:
        # NDCG@10 of the device scores in numpy: it must rise
        md = ds._inner.metadata
        ndcg10 = np_ndcg(md.label.astype(np.float64), md.query_boundaries,
                         [10])
        loss_name = "ndcg@10"

        def loss(_y, sc):
            return ndcg10(sc.cpu().numpy())[0]
    draws = []
    if path == "xendcg":
        # record each iteration's uniform draws (check_xendcg_draws)
        from lightgbm_torch.objectives.rank import RankXENDCG
        next_floats = RankXENDCG._next_floats

        def recorded(self):
            draws.append(next_floats(self))
            return draws[-1]
        RankXENDCG._next_floats = recorded
    last_tree = []
    if path == "knobs":
        # the last tree's gradients, grower arrays and row -> leaf map
        # (check_knob_leaves)
        from lightgbm_torch.treelearner.serial import SerialTreeLearner
        train_arrays = SerialTreeLearner.train_arrays

        def recording(self, grad, hess, bag=None):
            out = train_arrays(self, grad, hess, bag)
            last_tree[:] = [(grad, hess) + tuple(out)]
            return out
        SerialTreeLearner.train_arrays = recording
    host = {}
    unwatch = watch_dart_rf(path, host)
    reset_counts()
    torch.cuda.synchronize()
    bst = None
    try:
        for i in range(iters):
            t = time.time()
            if bst is None:
                bst = lgb.train(params, ds, 1)
            else:
                bst.update()
            torch.cuda.synchronize()
            walls.append(time.time() - t)
            wall += walls[-1]
            score = bst._booster.train_score.score
            losses.append(loss(y_d, score))
            if i + 1 == off_iters:
                kept = score.cpu().numpy()
        counts = read_counts()
    finally:
        unwatch()
        if path == "xendcg":
            RankXENDCG._next_floats = next_floats
        if path == "knobs":
            SerialTreeLearner.train_arrays = train_arrays
    digest = model_digest(bst)
    if FULL_SIZE["on"] and path in KNOWN_DIGESTS:
        head, tail = KNOWN_DIGESTS[path]
        if not (digest.startswith(head) and digest.endswith(tail)):
            raise AssertionError("train %s: model digest %s, the recorded "
                                 "one is %s...%s" % (path, digest, head,
                                                     tail))
        log("train %s: model digest equal to the recorded one (%s...%s)"
            % (path, head, tail))
    if path == "xendcg":
        check_xendcg_draws(bst, draws, iters)
    if bst._booster.use_persist != (path not in V1_PATHS):
        raise AssertionError("train %s: the learner took the wrong grower "
                             "(use_persist=%s)"
                             % (path, bst._booster.use_persist))
    trees = bst._booster.models
    splits = [t_.num_leaves - 1 for t_ in trees]
    if path in CAT_PATHS:
        ncat = [t_.num_cat for t_ in trees]
        if not sum(ncat):
            raise AssertionError("train %s: no categorical split" % path)
        if keep is not None:
            keep["num_cat"] = ncat
        log("train %s: categorical splits per tree %s of %s splits; "
            "iteration walls %s s" % (path, ncat, splits,
                                      ["%.3f" % w for w in walls]))
    log("train %s: %d rows x %d features, %d trees, leaves per tree %s"
        % (path, X.shape[0], X.shape[1], len(trees), [s + 1 for s in splits]))
    log("train %s: %.3f s per iteration (%.1f s for %d iterations, learner "
        "set-up included) on %s" % (path, wall / iters, wall, iters, card))
    K = bst._booster.num_tree_per_iteration
    drops = sum(len(d) for d in host.get("drops", ())) * K
    want, stats = expected_launches(bst, trees, drops)
    bad = {k: (counts[k], want.get(k, 0)) for k in counts
           if counts[k] != want.get(k, 0)}
    if bad or any(counts[k] == 0 for k in used) \
            or any(counts[k] for k in unused):
        raise AssertionError("train %s: launch counts (got, expected) %s, "
                             "all %s" % (path, bad, counts))
    log("train %s: launches %s (trees %d, splits %d; %s counted by the "
        "wrappers, the rest by the kernels on the device)"
        % (path, counts, len(trees), sum(splits), "/".join(PY_COUNTED)))
    log("train %s: model digest %s (sha256 of the model text without its "
        "parameters, after %d iterations)" % (path, digest, iters))
    if bst._booster.use_persist:
        from lightgbm_torch.ops.payload import payload_weight_row
        gr = bst._booster.tree_learner._persist_gr
        sec = gr.second
        log("train %s: the payload [%d, %d] int32 (%d bytes, %d score rows "
            "and %d snapshot rows), the second payload buffer [%d, %d] "
            "int32, %d bytes" % (path, gr.assets.geometry[0], sec.shape[1],
                                 gr.assets.geometry[0] * sec.shape[1] * 4,
                                 K, K if K > 1 else 0, sec.shape[0],
                                 sec.shape[1], sec.numel() * 4))
        if sec.shape[0] != payload_weight_row(gr.nbw, K) or gr.K != K:
            raise AssertionError("train %s: the second buffer has %d rows "
                                 "for %d trees per iteration, expected %d"
                                 % (path, sec.shape[0], K,
                                    payload_weight_row(gr.nbw, K)))
        copies = check_graph(bst, gr, path, walls)
        if keep is not None and copies is not None:
            keep["htod"] = copies[1]
    if keep is not None:
        keep["digests"] = {i: model_digest(bst, i)
                           for i in range(1, iters + 1)}
        keep["tree"] = bst._booster.models[0]
    if path in ("level", "bundled"):
        md = PATHS[path][0]["max_depth"]
        if any(not 0 < a <= md for a, _ in stats):
            raise AssertionError("train %s: level programs per tree %s, "
                                 "expected 1..%d" % (path, stats, md))
        log("train %s: (level programs, per-split splits) per tree %s"
            % (path, stats))
    log("train %s: %s per iteration (device scores) %s"
        % (path, loss_name, ["%.6f" % v for v in losses]))
    if path in RANK_PATHS:
        if not losses[-1] > losses[0]:
            raise AssertionError("training %s after the last iteration is "
                                 "not above the first's" % loss_name)
    elif path == "rf":
        # the average of trees each fit to the constant's gradients: below
        # the constant's loss at every iteration (logloss is convex in the
        # raw score), not falling at every step
        const = float(loss(y_d, torch.full_like(
            bst._booster.train_score.score, bst._booster.init_scores[0])))
        if not max(losses) < const:
            raise AssertionError("training %s %s, the constant init "
                                 "score's %.6f" % (loss_name, losses, const))
    elif path in ("goss", "dart"):
        # goss: each tree fits an amplified sample at learning rate 0.5;
        # dart: the drops move the scores back: the loss over every row
        # need not fall at every step
        if not losses[-1] < losses[0]:
            raise AssertionError("training %s after the last iteration is "
                                 "not below the first's" % loss_name)
    elif not all(b < a for a, b in zip(losses, losses[1:])):
        raise AssertionError("training %s does not fall monotonically"
                             % loss_name)
    sub = X[:WALK_ROWS]
    raw = bst.predict(sub, raw_score=True)
    dev_score = bst._booster.train_score.score[..., :len(sub)].cpu().numpy()
    if K > 1:
        dev_score = dev_score.T
    gap = float(np.abs(dev_score - raw).max())
    # v1 keeps f64 scores; the payload keeps f32 scores, each iteration
    # adding one rounded f32 product to a rounded f32 sum
    # (DART: its two walks per dropped tree add too; RF: the average takes
    # a multiply, an add and a multiply per iteration)
    adds = len(trees) // K + 1 + 2 * drops // K
    tol = (1e-9 if path in V1_PATHS else
           (3 if path == "rf" else 2) * adds * 1.1920929e-07
           * max(1.0, np.abs(raw).max()))
    log("train %s: device scores vs numpy walk on the first %d rows, max abs "
        "diff %.3g (limit %.3g)" % (path, len(sub), gap, tol))
    if not gap <= tol:
        raise AssertionError("device training scores disagree with predict")
    again = lgb.Booster(model_str=bst.model_to_string())
    if not np.array_equal(again.predict(X[:200_000], raw_score=True),
                          raw[:200_000]):
        raise AssertionError("model text round trip changes predictions")
    log("train %s: model_to_string -> Booster(model_str) predicts identical "
        "raw scores" % path)
    if path in ("multiclass",) + DART_RF_PATHS:
        check_predict_cover(bst, sub, path)
    if path == "l1":
        check_renewed_leaves(bst)
    if path in BAG_PATHS:
        check_bag_path(bst, path)
    if path in DART_RF_PATHS:
        check_dart_rf_path(bst, path, host)
        if keep is not None:
            keep["host"] = host
    if path == "knobs":
        t = time.time()
        at, nleaves, sens, bounded, L = check_knob_leaves(bst, last_tree[0])
        log("train knobs: max_delta_step %g: %d of the %d leaves after the "
            "first tree sit at +-%r (max_delta_step x learning rate), none "
            "past it; the last tree's %d leaves (%d with monotone bounds) "
            "equal the leaf math with lambda_l1 %g, and %d of them move by "
            "more than 1e-3 without it (before the monotone clamp)"
            % (KNOB_PARAMS["max_delta_step"], at, nleaves,
               float(np.float32(KNOB_PARAMS["max_delta_step"]))
               * bst._booster.shrinkage_rate, L, bounded,
               KNOB_PARAMS["lambda_l1"], sens))
        moved = check_monotone_sweep(bst, X)
        log("train knobs: monotone sweep over 1000 rows, each constrained "
            "feature at every split threshold of the model and just past "
            "it: the raw score moves only in the constraint's direction "
            "(feature: (thresholds, largest move)) %s" % moved)
        nodes, ntrees = check_knob_draws(bst, ds._inner,
                                         int(bst._booster.config.extra_seed))
        log("train knobs: draw replay (numpy threefry, extra_seed %d): every "
            "one of the %d splits of the %d trees lies in its node's "
            "by-node sample and on its drawn extra_trees bin (%.1f s of "
            "host checks)" % (int(bst._booster.config.extra_seed), nodes,
                              ntrees, time.time() - t))
    if keep is not None and path in ("persist", "l1", "ltr", "knobs",
                                     "airline") + BAG_PATHS + DART_RF_PATHS:
        keep["iteration"] = profile_iteration(bst.update)
    if keep is not None and path in ("persist", "l1", "airline", "bundled"):
        keep["bst"] = bst
    if profile:
        phase_profile(bst, card, path)
    if off_iters:
        t = time.time()
        off = lgb.train(dict(params, tpu_level_grow="off"), ds, off_iters)
        gr = off._booster.tree_learner._persist_gr
        if gr.use_level or any(a for a, _ in gr.grow_stats):
            raise AssertionError("train %s: tpu_level_grow=off ran the level "
                                 "phase" % path)
        same_scores = np.array_equal(
            off._booster.train_score.score.cpu().numpy(), kept)
        a = off.predict(sub, raw_score=True)
        b = bst.predict(sub, raw_score=True, num_iteration=off_iters)
        if not (same_scores and np.array_equal(a, b)):
            raise AssertionError(
                "train %s: tpu_level_grow=off differs from the level phase's "
                "first %d trees (device scores equal: %s; predictions max abs "
                "diff %.3g)" % (path, off_iters, same_scores,
                                float(np.abs(a - b).max())))
        log("train %s: %d iterations with tpu_level_grow=off (%d per-split "
            "splits, %.1f s): device scores on all %d rows and raw "
            "predictions on the first %d equal the level run's after %d "
            "trees, bit for bit" % (path, off_iters,
                                    sum(b_ for _, b_ in gr.grow_stats),
                                    time.time() - t, X.shape[0], len(sub),
                                    off_iters))
        del off
    del bst
    torch.cuda.empty_cache()
    return counts


def np_logloss(y, raw):
    """binary_logloss of raw scores in numpy, the JAX package's formula
    (lightgbm_tpu/metrics/pointwise.py: sigmoid 1, probabilities clamped
    at 1e-15), unweighted."""
    prob = 1.0 / (1.0 + np.exp(-raw))
    eps = 1e-15
    pos = np.where(prob > eps, -np.log(np.maximum(prob, eps)), -np.log(eps))
    neg = np.where(1.0 - prob > eps, -np.log(np.maximum(1.0 - prob, eps)),
                   -np.log(eps))
    return float(np.sum(np.where(y > 0, pos, neg))) / len(y)


def np_auc(y, raw):
    """AUC in numpy with the JAX package's tie rule (lightgbm_tpu/metrics/
    pointwise.py:AUCMetric), unweighted."""
    order = np.argsort(-raw, kind="stable")
    s, pos = raw[order], (y[order] > 0).astype(np.float64)
    new = np.empty(len(s), dtype=bool)
    new[0] = True
    new[1:] = s[1:] != s[:-1]
    gid = np.cumsum(new) - 1
    gp = np.bincount(gid, weights=pos)
    gn = np.bincount(gid, weights=1.0 - pos)
    before = np.concatenate([[0.0], np.cumsum(gp)[:-1]])
    accum = float(np.sum(gn * (gp * 0.5 + before)))
    sp, sw = float(pos.sum()), float(len(y))
    return accum / (sp * (sw - sp)) if 0.0 < sp != sw else 1.0


NP_METRICS = {"binary_logloss": np_logloss, "auc": np_auc}


def profile_iteration(fn):
    """fn (one boosting iteration, maybe with its evaluation) once timed
    on the host clock, then once more under torch.profiler: (wall ms of
    the first, device busy ms of the second, its device events, its
    device-to-host and host-to-device copies)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.time()
    fn()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    rows = _device_events(prof)
    dtoh = sum(n for _, n, key in rows if "Memcpy DtoH" in key)
    htod = sum(n for _, n, key in rows if "Memcpy HtoD" in key)
    return wall_ms, sum(r[0] for r in rows), rows, dtoh, htod


def leaf_depths(tree):
    """[num_leaves] depth of each leaf of a models.tree.Tree."""
    depth = np.zeros(max(tree.num_leaves, 1), np.int64)
    stack = [(0, 1)] if tree.num_leaves > 1 else []
    while stack:
        node, d = stack.pop()
        for child in (tree.left_child[node], tree.right_child[node]):
            if child < 0:
                depth[~child] = d
            else:
                stack.append((child, d + 1))
    return depth


def phase_valid_walk(label, tree, train_inner, valid_inner, seed):
    """valid_walk over a validation set on the card: two launches
    bit-identical, bit-identical to the plain version on the CPU; timed
    beside the plain version on the card and its bound (the bins read
    once, the f64 scores read and written once, the node table and leaves
    read once; the data's node visits at ~12 integer operations each).
    Returns the kernel's record (launches filled in by main)."""
    import torch
    from lightgbm_torch.models.tree import walk_leaves_plain
    from lightgbm_torch.ops.valid_walk import pack, valid_walk, \
        valid_walk_plain
    dev = torch.device("cuda")
    L = tree.num_leaves
    (pc,) = pack([tree], [tree.leaf_value[:L]], train_inner, "cpu")
    (pd,) = pack([tree], [tree.leaf_value[:L]], train_inner, dev)
    bins_c = torch.from_numpy(valid_inner.binned)
    bins_d = valid_inner.to_device(dev).bins
    n, G = bins_c.shape
    base = np.random.default_rng(seed).normal(size=n)
    ref = torch.as_tensor(base.copy())
    valid_walk_plain(bins_c, pc.nodes, pc.leaves, ref, pc.words)
    outs = []
    for _ in range(2):
        s = torch.as_tensor(base, device=dev)
        valid_walk(bins_d, pd.nodes, pd.leaves, s, pd.words)
        torch.cuda.synchronize()
        outs.append(s.cpu())
    _same("valid_walk %s: two launches" % label, outs[0], outs[1])
    err = _same("valid_walk %s vs the plain version on the CPU" % label,
                outs[0], ref)
    leaves = walk_leaves_plain(bins_c, pc.nodes, pc.words).numpy()
    depth = leaf_depths(tree)
    visits = int(depth[leaves].sum())
    scratch = torch.as_tensor(base, device=dev)
    ms = device_ms(lambda: valid_walk(bins_d, pd.nodes, pd.leaves, scratch,
                                      pd.words),
                   sleep_cycles=20_000_000)
    plain_ms = device_ms(lambda: valid_walk_plain(bins_d, pd.nodes,
                                                  pd.leaves, scratch,
                                                  pd.words),
                         reps=3, warmup=1)
    nbytes = n * G + 16 * n + pd.nodes.numel() * 4 + pd.leaves.numel() * 8 \
        + pd.words.numel() * 4
    b_ms, b_by = bound_ms(nbytes, 12.0 * visits)
    log("valid_walk %s: a %d-leaf tree (depth %d) over %d rows x %d groups "
        "(%s, %d categorical nodes): two launches bit-identical, "
        "bit-identical to the plain version on the CPU; %d node visits "
        "(mean depth %.2f); median time "
        "per call: kernel %.4f ms, plain (per-level torch walk on the card) "
        "%.4f ms, no single PyTorch call computes it; bound %.6f ms (%s)"
        % (label, L, int(depth.max()), n, G,
           "EFB-bundled" if valid_inner.has_bundles else "one feature per "
           "group", tree.num_cat, visits, visits / n, ms, plain_ms, b_ms,
           b_by))
    return {"name": "valid_walk", "route": "cuda",
            "source": "lightgbm_torch/csrc/valid_walk.cu",
            "replaces": "lightgbm_tpu/models/tree.py:420 (predict_leaf_"
                        "binned: the JAX package's host numpy walk; no "
                        "Pallas kernel)",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "rows": n, "leaves": L}


def phase_cat_kernels(lgb, inner, y, params, R=256, seed=4):
    """cat_scan at the airline path's shape: the categorical layout of the
    binned airline set (six features, 12 to 255 bins), on R = 256 real
    node histograms (hist_window over random row windows of 2k-200k rows,
    binary gradients of random scores), B = 2 and B = 256 nodes, the
    sorted route (the default max_cat_to_onehot) and the one-hot one (32):
    two launches equal, and bit for bit equal to the plain version on the
    CPU. Timed (sorted route) beside the plain version on the card and the
    bound: each node's bins of the six features read once (grad and hess),
    its scalars and mask, the records written once. Returns the kernel's
    record (launches filled in by main)."""
    import torch
    from lightgbm_torch.ops.cat_scan import (cat_scalars, cat_scan,
                                             cat_scan_rows_plain)
    from lightgbm_torch.ops.grow import tb_source_index
    from lightgbm_torch.ops.histogram import hist_window
    from lightgbm_torch.treelearner.serial import (cat_scan_setup,
                                                   grow_config)
    from lightgbm_torch.ops.split import SplitParams
    dev = torch.device("cuda")
    cfg = lgb.Config(params)
    sp = SplitParams.from_config(cfg)
    gc = grow_config(cfg, inner)
    data = inner.to_device(dev)
    n = data.bins.shape[0]
    rng = np.random.default_rng(seed)
    p_ = 1.0 / (1.0 + np.exp(-(rng.normal(size=n) * 0.5 - 1.4)))
    grad = torch.as_tensor((p_ - y).astype(np.float32), device=dev)
    hess = torch.as_tensor((p_ * (1 - p_)).astype(np.float32), device=dev)
    tb_src = tb_source_index(inner.group_offset, inner.total_bins,
                             gc.hist_width, dev)
    lengths = np.exp(rng.uniform(np.log(2000), np.log(200_000), R)
                     ).astype(np.int64)
    starts = rng.integers(0, n - lengths)
    gh = torch.empty((R, gc.total_bins), dtype=torch.float32, device=dev)
    hh = torch.empty_like(gh)
    for r in range(R):
        h = hist_window(data.bins, grad, hess, int(starts[r]),
                        int(lengths[r]), gc.hist_width)
        h = h.reshape(-1, 2)[tb_src]
        gh[r], hh[r] = h[:, 0], h[:, 1]
    g64 = grad.double().cpu().numpy()
    h64 = hess.double().cpu().numpy()
    sg = np.array([g64[a:a + b].sum() for a, b in zip(starts, lengths)],
                  np.float32)
    sh = np.array([h64[a:a + b].sum() for a, b in zip(starts, lengths)],
                  np.float32) + np.float32(2e-15)
    gh_c, hh_c = gh.cpu(), hh.cpu()
    rec = {}
    for route, onehot in (("sorted", cfg.max_cat_to_onehot), ("onehot", 32)):
        cat = cat_scan_setup(lgb.Config(dict(params,
                                             max_cat_to_onehot=onehot)),
                             inner, sp, dev, False)
        cat_c = cat_scan_setup(lgb.Config(dict(params,
                                               max_cat_to_onehot=onehot)),
                               inner, sp, "cpu", False)
        C = cat.layout.C
        for B in (2, R):
            sel = rng.permutation(R)[:B]
            rows = torch.as_tensor(sel)
            cs = cat_scalars(sg[sel], sh[sel], lengths[sel], sp,
                             np.full(B, -np.inf, np.float32),
                             np.full(B, np.inf, np.float32))
            fm = np.ones((B, C), np.float32)
            args = (torch.as_tensor(cs, device=dev), gh, hh,
                    rows.to(dev), cat.layout,
                    torch.as_tensor(fm, device=dev), cat.par)
            a = cat_scan(*args)
            b = cat_scan(*args)
            torch.cuda.synchronize()
            _same("cat_scan %s B=%d: two launches" % (route, B),
                  a.view(torch.int32).cpu(), b.view(torch.int32).cpu())
            ref = cat_scan_rows_plain(torch.as_tensor(cs), gh_c, hh_c, rows,
                                      cat_c.layout, torch.as_tensor(fm),
                                      cat_c.par.cpu())
            err = _same("cat_scan %s B=%d vs the plain version on the CPU"
                        % (route, B), a.view(torch.int32).cpu(),
                        ref.view(torch.int32))
            fin = torch.isfinite(ref[..., 0])
            if not bool(fin.any()):
                raise AssertionError("cat_scan %s B=%d: no split: the "
                                     "check is vacuous" % (route, B))
            if route != "sorted":
                continue
            ms = device_ms(lambda: cat_scan(*args),
                           sleep_cycles=2_000_000 if B == 2 else 20_000_000)
            plain_ms = device_ms(lambda: cat_scan_rows_plain(*args),
                                 reps=3, warmup=1)
            nb = cat.layout.meta[1].sum().item()
            nbytes = B * nb * 8 + cs.nbytes + fm.nbytes + a.numel() * 4 \
                + cat.layout.meta.numel() * 4 + C * 4 + 64
            b_ms, b_by = bound_ms(nbytes, 0.0)
            key = "" if B == 2 else "b256_"
            rec.update({key + "ms": ms, key + "plain_ms": plain_ms,
                        key + "bound_ms": b_ms, key + "bound_by": b_by})
            if B == 2:
                rec["max_abs_err"] = err
            log("cat_scan: B=%d nodes x %d categorical features (%d bins, "
                "widest %d), sorted route: two launches equal, bit for bit "
                "equal to the plain version on the CPU (%d of %d records "
                "split); median time per call: kernel %.4f ms, plain (torch "
                "on the card) %.3f ms, no single PyTorch call computes it; "
                "bound %.6f ms (%s)" % (B, C, nb, cat.layout.W,
                                        int(fin.sum()), fin.numel(), ms,
                                        plain_ms, b_ms, b_by))
        log("cat_scan: the %s route at B=2 and B=%d bit for bit equal to "
            "the plain version on the CPU" % (route, R))
    return dict({"name": "cat_scan", "route": "cuda",
                 "source": "lightgbm_torch/csrc/cat_scan.cu",
                 "replaces": "lightgbm_tpu/ops/split.py:572 (find_best_"
                             "split_categorical: XLA ops; no Pallas kernel)",
                 "launches": 0, "library_ms": None}, **{
        k: rec[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                            "bound_by", "b256_ms", "b256_plain_ms",
                            "b256_bound_ms")})


RENEW_SIZES = (0, 1, 2, 3, 7, 40, 0, 1, 2, 513, 4096, 5, 100_003)


def phase_renew_kernel(bst):
    """renew_leaf against its plain version on the CPU, bit for bit: on
    random segments (RENEW_SIZES rows: empty, one-row, two-row, large)
    with tied integer residuals (-0.0 beside +0.0) and f32 weights, at
    alphas that reach both clamps, into f32 and f64 outputs; then on the
    segments of a real HIGGS L1 tree (`bst`: the L1 path's Booster, its
    last tree's device leaf table over all lanes, the payload's scores),
    unweighted as the path runs it (f32 leaf table, nseg the tree's leaf
    count) and with random weights. Times (median per call on the card):
    the kernel, its plain version on the card, the two stable sorts that
    order the rows (the library sort the design uses), and the whole
    renewal step of the grower (scatter to row order, segment keys, sorts,
    kernel). Bound: unweighted, each segment's two lanes (order and
    residual), its (start, count) and its output; weighted, every lane's
    order entry and weight, read once. No single PyTorch call computes a
    per-segment percentile: library_ms is null. Returns the kernel's
    record (launches filled in by main)."""
    import torch
    from lightgbm_torch.ops.renew import (renew_leaf, renew_leaf_plain,
                                          renew_segments, segment_order)
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    key = np.repeat(np.arange(len(RENEW_SIZES)), RENEW_SIZES)
    rng.shuffle(key)
    n = len(key)
    res = rng.integers(-4, 5, n).astype(np.float64)
    res[(res == 0) & (rng.random(n) < 0.5)] = -0.0
    w = rng.uniform(0.2, 3.0, n).astype(np.float32)
    sz = torch.as_tensor(np.asarray(RENEW_SIZES, np.int64))
    seg = torch.stack([torch.cumsum(sz, 0) - sz, sz], 1)
    cases = 0
    for alpha in (0.5, 0.1, 0.9, 0.0001, 0.9999):
        for weighted in (False, True):
            for dt in (torch.float64, torch.float32):
                out = {}
                for d in ("cuda", "cpu"):
                    o = torch.full((len(RENEW_SIZES),), 9.5, dtype=dt,
                                   device=d)
                    renew_segments(torch.as_tensor(res, device=d),
                                   torch.as_tensor(key, device=d),
                                   torch.as_tensor(w, device=d)
                                   if weighted else None, seg.to(d), o,
                                   alpha)
                    out[d] = o
                torch.cuda.synchronize()
                _same("renew_leaf random segments alpha %g %s" % (
                    alpha, "weighted" if weighted else "unweighted"),
                    out["cuda"], out["cpu"])
                cases += 1
    log("renew_leaf: %d random-segment cases (%d segments, %d rows, tied "
        "integer residuals with -0.0, empty/one/two-row segments, alphas "
        "0.5/0.1/0.9/1e-4/0.9999, f32 and f64 outputs) bit-identical to "
        "the plain version on the CPU" % (cases, len(RENEW_SIZES), n))
    # a real tree: the L1 path's last tree over all 10.5M lanes
    b = bst._booster
    gr, pay = b.tree_learner._persist_gr, b.tree_learner._persist_carry
    obj = b.objective
    cap = {}

    def grab(rs, key_, seg_, out_, nseg_):
        cap.update(rs=rs.clone(), key=key_.clone(), seg=seg_.clone(),
                   out=out_.clone(), nseg=nseg_.clone())
    gr.renew(pay, grab)
    label = torch.as_tensor(obj.raw_label, device=dev)
    resid = (label.double() - cap["rs"]) + 0.0
    order = segment_order(resid, cap["key"])
    wts = torch.as_tensor(np.random.default_rng(42).uniform(
        0.5, 2.0, gr.n).astype(np.float32), device=dev)
    S = int(cap["nseg"].item())
    counts = cap["seg"][:, 1].cpu().numpy()[:S]
    cpu = {k: v.cpu() for k, v in (("order", order), ("resid", resid),
                                   ("seg", cap["seg"]), ("nseg", cap["nseg"]),
                                   ("w", wts))}
    err = 0.0
    for weighted in (False, True):
        out_d = cap["out"].clone()
        renew_leaf(order, resid, wts if weighted else None, cap["seg"],
                   out_d, obj.renew_alpha, cap["nseg"])
        out_c = cap["out"].cpu().clone()
        renew_leaf_plain(cpu["order"], cpu["resid"],
                         cpu["w"] if weighted else None, cpu["seg"], out_c,
                         obj.renew_alpha, cpu["nseg"])
        torch.cuda.synchronize()
        err = max(err, _same("renew_leaf HIGGS tree %s" % (
            "weighted" if weighted else "unweighted"), out_d, out_c))
    scratch = cap["out"].clone()
    ms = device_ms(lambda: renew_leaf(order, resid, None, cap["seg"],
                                      scratch, obj.renew_alpha, cap["nseg"]),
                   sleep_cycles=20_000_000)
    w_ms = device_ms(lambda: renew_leaf(order, resid, wts, cap["seg"],
                                        scratch, obj.renew_alpha,
                                        cap["nseg"]), reps=5, warmup=1)
    plain_ms = device_ms(lambda: renew_leaf_plain(
        order, resid, None, cap["seg"], scratch, obj.renew_alpha,
        cap["nseg"]), reps=3, warmup=1)
    sort_ms = device_ms(lambda: segment_order(resid, cap["key"]), reps=5,
                        warmup=1)
    step_ms = device_ms(lambda: gr.renew(pay, obj.renew_tree_output), reps=5,
                        warmup=1)
    b_ms, b_by = bound_ms(S * (2 * 16 + 16 + 4), 10.0 * S)
    wb_ms, wb_by = bound_ms(12.0 * gr.n + S * (2 * 8 + 16 + 4), 1.0 * gr.n)
    log("renew_leaf: a %d-leaf HIGGS L1 tree's segments over %d lanes "
        "(largest %d, smallest %d rows): unweighted (the path's call) and "
        "with random weights bit-identical to the plain version on the CPU; "
        "median time per call: kernel %.4f ms (weighted %.4f), plain "
        "(a loop over segments on the card) %.2f ms, the two stable sorts "
        "that order the rows %.4f ms, the grower's whole renewal step %.4f "
        "ms; bound %.6f ms (%s; weighted %.4f ms, %s); no single PyTorch "
        "call computes it" % (S, gr.n, int(counts.max()), int(counts.min()),
                              ms, w_ms, plain_ms, sort_ms, step_ms, b_ms,
                              b_by, wb_ms, wb_by))
    return {"name": "renew_leaf", "route": "cuda",
            "source": "lightgbm_torch/csrc/renew_leaf.cu",
            "replaces": "lightgbm_tpu/boosting/gbdt.py:747 (_renew_tree_"
                        "output: the JAX package's host numpy percentiles, "
                        "objectives/base.py:214-256; no Pallas kernel)",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": None, "sort_ms": sort_ms, "step_ms": step_ms,
            "weighted_ms": w_ms, "weighted_bound_ms": wb_ms,
            "lanes": gr.n, "segments": S}


BAG_MODES = (("fraction", ("bagging", 0.8, 1.0, 1.0), 5, 0),
             ("balanced", ("bagging", 1.0, 0.9, 0.5), 5, 0),
             ("goss", ("goss", 0.2, 0.1), 5, 2))


def phase_bag_kernels(y):
    """bag_apply and goss_select at the HIGGS shape (len(y) live lanes: a
    permutation of the row ids, the labels, binary gradients at random
    scores, f32 rows as the payload holds them): in the
    fraction (0.8, the bagging path's), balanced (0.9 / 0.5) and GOSS (top
    0.2, other 0.1, past its skip count) modes, two launches equal and bit
    for bit equal to the plain versions on the CPU (grad and hess rows, the
    in-bag count, the threshold); goss_select's threshold equal to
    torch.kthvalue's. Times (median per call on the card): each kernel,
    its plain version on the card, torch.kthvalue on the same |g * h|
    (goss_select's library call; bag_apply has none), and the bounds:
    bag_apply reads the row-id, grad and hess rows (and the label row when
    balanced) and writes grad and hess once; goss_select reads grad and
    hess once. Returns the two kernels' records (launches filled in by
    main)."""
    import torch
    from lightgbm_torch.ops import bag
    n = len(y)
    rng = np.random.default_rng(43)
    p = 1.0 / (1.0 + np.exp(-1.5 * rng.normal(size=n)))
    rows = np.zeros((4, n), np.int32)
    rows[0] = np.asarray(y, np.float32).view(np.int32)
    rows[1] = rng.permutation(n).astype(np.int32)
    rows[2] = (p - y).astype(np.float32).view(np.int32)
    rows[3] = (p * (1.0 - p)).astype(np.float32).view(np.int32)
    host = torch.as_tensor(rows)
    dev = host.cuda()
    recs, t0 = {}, time.time()

    def views(t):
        return (t[1], t[0].view(torch.float32), t[2].view(torch.float32),
                t[3].view(torch.float32))

    def run(t, b, plain=False):
        st = bag.BagState(t.device)
        st.set(b)
        rid, lab, g, h = views(t)
        if b.mode == bag.MODE_GOSS:
            (bag.goss_select_plain if plain else bag.goss_select)(g, h, n, st)
        if plain:
            bag.bag_apply_plain(rid, lab, g, h, n, b.mode, st)
        else:
            bag.bag_apply(rid, lab, g, h, n, b.mode, st)
        return st
    for name, spec, it, skip in BAG_MODES:
        b = bag.bag_iteration(spec, 3, 5, it, n, skip)
        outs = []
        for _ in range(2):
            t = dev.clone()
            st = run(t, b)
            outs.append((t, st.count.clone(), st.sel[:2].clone()))
        tc = host.clone()
        stc = run(tc, b, plain=True)
        torch.cuda.synchronize()
        _same("bag step %s: two launches" % name, outs[0], outs[1])
        _same("bag step %s vs plain on the CPU" % name, outs[0],
              (tc, stc.count, stc.sel[:2]))
        cnt = int(outs[0][1])
        extra = ""
        st = bag.BagState("cuda")
        st.set(b)
        rid, lab, g, h = views(dev)
        if b.mode == bag.MODE_GOSS:
            s = (g[:n] * h[:n]).abs()
            k = b.top_k
            kth = torch.kthvalue(s, n - k + 1).values
            thr = int(outs[0][2][0])
            want = int(kth.view(torch.int32)) & 0xFFFFFFFF
            if thr != want:
                raise AssertionError("goss_select: threshold bits %#x, "
                                     "torch.kthvalue's %#x" % (thr, want))
            sel_ms = device_ms(lambda: bag.goss_select(g, h, n, st))
            sel_plain = device_ms(lambda: bag.goss_select_plain(g, h, n, st),
                                  reps=3, warmup=1)
            kth_ms = device_ms(lambda: torch.kthvalue(s, n - k + 1), reps=5,
                               warmup=1)
            sb_ms, sb_by = bound_ms(8.0 * n, 2.0 * n)
            recs["goss_select"] = {
                "name": "goss_select", "route": "cuda",
                "source": "lightgbm_torch/csrc/bag.cu",
                "replaces": "lightgbm_tpu/ops/grow_persist.py:521 "
                            "(_kth_largest, jnp in the fused driver's GOSS "
                            "transform; no Pallas kernel)",
                "launches": 0, "max_abs_err": 0.0, "ms": sel_ms,
                "plain_ms": sel_plain, "bound_ms": sb_ms, "bound_by": sb_by,
                "library_ms": kth_ms, "lanes": n, "top_k": k}
            bag.goss_select(g, h, n, st)
            extra = ("; goss_select %.4f ms (plain %.2f, torch.kthvalue "
                     "%.4f, bound %.4f %s), threshold %r = torch.kthvalue's"
                     % (sel_ms, sel_plain, kth_ms, sb_ms, sb_by,
                        float(kth)))
        # in place: a 0/1 weight is idempotent, GOSS's amplification only
        # scales the rest (the time does not depend on the values)
        work = dev.clone()
        wr = views(work)
        ms = device_ms(lambda: bag.bag_apply(*wr, n, b.mode, st))
        plain_ms = device_ms(lambda: bag.bag_apply_plain(*wr, n, b.mode, st),
                             reps=3, warmup=1)
        per_lane = 24.0 if b.mode == bag.MODE_BALANCED else 20.0
        b_ms, b_by = bound_ms(per_lane * n, 12.0 * n)
        recs.setdefault("bag_apply", {
            "name": "bag_apply", "route": "cuda",
            "source": "lightgbm_torch/csrc/bag.cu",
            "replaces": "lightgbm_tpu/ops/grow_persist.py:569 "
                        "(make_bag_transform with _hash_uniform:498 and "
                        "make_goss_weight_fn:540, jnp in the fused driver; "
                        "no Pallas kernel)",
            "launches": 0, "max_abs_err": 0.0, "library_ms": None,
            "lanes": n})
        r = recs["bag_apply"]
        if name == "fraction":
            r.update(ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by)
        else:
            r.update({name + "_ms": ms, name + "_plain_ms": plain_ms,
                      name + "_bound_ms": b_ms})
        log("bag step %s (%s): %d of %d lanes in the bag; two launches and "
            "the plain version on the CPU bit-identical (grad/hess rows, "
            "count%s); bag_apply %.4f ms (plain on the card %.2f ms), bound "
            "%.4f ms (%s, %d bytes a lane)%s"
            % (name, spec, cnt, n, ", threshold" if b.mode == bag.MODE_GOSS
               else "", ms, plain_ms, b_ms, b_by, per_lane, extra))
        del work, wr
    log("bag kernels: %.1f s" % (time.time() - t0))
    return [recs["bag_apply"], recs["goss_select"]]


def phase_dart_rf_kernels(tree, inner):
    """DART's and RF's kernel forms at the HIGGS payload (its n live lanes
    in a random permutation of the row ids, as a grown payload holds
    them; G groups): valid_walk_payload (a 255-leaf tree of the persist
    path, its values times -1/3 as a drop-and-normalize step scales them,
    walked over the training bins onto an f32 score row), bag_apply's
    rows form (a host mask drawn at fraction 0.7; -0.0 where a negative
    gradient meets 0) and apply_scores_avg (255 random segments over the
    lanes, a -0.0 leaf, t = 5, the binary init score as the bias): two
    launches bit-identical, bit-identical to the plain version on the same
    inputs on the card. Times (median per call): the kernel, the plain
    version on the card, and the bound: the walk reads each lane's row
    id, its row of bins and its score and writes the score (4 + G + 8
    bytes; ~12 integer operations per node visit), the rows bag reads the
    row id, the row's mask byte, grad and hess and writes both (21
    bytes), the average reads and writes the score (8 bytes). No single
    PyTorch call computes any of them. Returns the three records
    (launches filled in by main)."""
    import torch
    from lightgbm_torch.models.tree import walk_leaves_plain
    from lightgbm_torch.ops import bag
    from lightgbm_torch.ops import grow_step as gs
    from lightgbm_torch.ops.valid_walk import (pack, valid_walk_payload,
                                               valid_walk_payload_plain)
    dev = torch.device("cuda")
    t0 = time.time()
    n, G = inner.binned.shape
    pad = 4096
    rng = np.random.default_rng(47)
    rid = torch.zeros(n + pad, dtype=torch.int32, device=dev)
    rid[:n] = torch.as_tensor(rng.permutation(n).astype(np.int32),
                              device=dev)
    bins = inner.to_device(dev).bins
    recs = []
    # (a) the payload walk
    L = tree.num_leaves
    (pd,) = pack([tree], [tree.leaf_value[:L] * (-1.0 / 3.0)], inner, dev)
    base = torch.as_tensor(rng.normal(size=n + pad).astype(np.float32),
                           device=dev)
    outs = []
    for _ in range(2):
        sc = base.clone()
        valid_walk_payload(bins, rid, pd.nodes, pd.leaves, sc, n, pd.words)
        outs.append(sc)
    ref = base.clone()
    valid_walk_payload_plain(bins, rid, pd.nodes, pd.leaves, ref, n,
                             pd.words)
    _same("valid_walk_payload: two launches", outs[0], outs[1])
    err = _same("valid_walk_payload vs plain", outs[0], ref)
    _same("valid_walk_payload: lanes past n", outs[0][n:], base[n:])
    depth = leaf_depths(tree)
    visits = int(torch.as_tensor(depth, device=dev)[walk_leaves_plain(
        bins, pd.nodes, pd.words)].sum())
    scratch = base.clone()
    ms = device_ms(lambda: valid_walk_payload(bins, rid, pd.nodes, pd.leaves,
                                              scratch, n, pd.words),
                   sleep_cycles=20_000_000)
    plain_ms = device_ms(lambda: valid_walk_payload_plain(
        bins, rid, pd.nodes, pd.leaves, scratch, n, pd.words), reps=3,
        warmup=1)
    b_ms, b_by = bound_ms(n * (4.0 + G + 8.0) + pd.nodes.numel() * 4
                          + pd.leaves.numel() * 8, 12.0 * visits)
    log("valid_walk_payload: a %d-leaf tree over %d lanes x %d groups "
        "(%d node visits): two launches and the plain version on the card "
        "bit-identical, lanes past n untouched; kernel %.4f ms, plain %.4f "
        "ms, bound %.4f ms (%s)" % (L, n, G, visits, ms, plain_ms, b_ms,
                                    b_by))
    recs.append({"name": "valid_walk_payload", "route": "cuda",
                 "source": "lightgbm_torch/csrc/valid_walk.cu",
                 "replaces": "lightgbm_tpu/ops/grow_persist.py:1816 "
                             "(add_score_delta of DART's drop and "
                             "normalize, jnp; no Pallas kernel)",
                 "launches": 0, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None, "lanes": n, "leaves": L})
    del outs, ref, scratch
    # (b) the rows bag
    g = torch.as_tensor(rng.normal(size=n + pad).astype(np.float32),
                        device=dev)
    g[n:] = 0.0
    g[:4] = torch.tensor([-0.0, 0.0, -1.5, 2.0])
    h = torch.as_tensor(rng.uniform(0.01, 0.25, n + pad).astype(np.float32),
                        device=dev)
    h[n:] = 0.0
    label = torch.zeros(n + pad, dtype=torch.float32, device=dev)
    mask = rng.random(n) < 0.7
    mask[rid[:3].cpu().numpy()] = False
    st = bag.BagState(dev)
    st.set(bag.rows_iteration(0, mask))
    outs = []
    for plain in (False, False, True):
        gg, hh = g.clone(), h.clone()
        (bag.bag_apply_plain if plain else bag.bag_apply)(
            rid, label, gg, hh, n, bag.MODE_ROWS, st)
        outs.append((gg, hh, st.count.clone()))
    _same("bag_apply rows: two launches", outs[0], outs[1])
    err = _same("bag_apply rows vs plain", outs[0], outs[2])
    if int(outs[0][2][0]) != int(mask.sum()) or not (
            float(outs[0][0][2]) == 0.0
            and bool(torch.signbit(outs[0][0][2]))):
        raise AssertionError("bag_apply rows: count %d, mask sum %d, lane 2 "
                             "%r" % (int(outs[0][2][0]), int(mask.sum()),
                                     float(outs[0][0][2])))
    work = (g.clone(), h.clone())
    ms = device_ms(lambda: bag.bag_apply(rid, label, *work, n,
                                         bag.MODE_ROWS, st))
    plain_ms = device_ms(lambda: bag.bag_apply_plain(
        rid, label, *work, n, bag.MODE_ROWS, st), reps=3, warmup=1)
    b_ms, b_by = bound_ms(21.0 * n, 3.0 * n)
    log("bag_apply rows: %d of %d lanes in the bag; two launches and the "
        "plain version on the card bit-identical (-0.0 kept); kernel %.4f "
        "ms, plain %.4f ms, bound %.4f ms (%s, 21 bytes a lane)"
        % (int(mask.sum()), n, ms, plain_ms, b_ms, b_by))
    recs.append({"name": "bag_rows", "route": "cuda",
                 "source": "lightgbm_torch/csrc/bag.cu",
                 "replaces": "lightgbm_tpu/ops/grow_persist.py:1828 "
                             "(apply_row_weights of the fused RF driver, "
                             "jnp; no Pallas kernel)",
                 "launches": 0, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None, "lanes": n})
    del outs, work, g, h, label
    # (c) the running average
    S = gs.GrowState(255, dev)
    cuts = np.sort(rng.choice(np.arange(1, n), 254, replace=False))
    starts = np.concatenate([[0], cuts])
    vals = rng.normal(size=255).astype(np.float32)
    vals[7] = -0.0
    S.li[:, gs.LI_START] = torch.as_tensor(starts, device=dev)
    S.li[:, gs.LI_NROWS] = torch.as_tensor(
        np.concatenate([cuts, [n]]) - starts, device=dev)
    S.lf[:, gs.LF_VALUE] = torch.as_tensor(vals, device=dev)
    S.st[gs.ST_S] = 255
    gs.set_avg(S, 5.0, -0.37086)
    outs = []
    for plain in (False, False, True):
        sc = base.clone()
        (gs.apply_avg_plain if plain else gs.apply_scores_avg)(S, sc[:n])
        outs.append(sc)
    _same("apply_scores_avg: two launches", outs[0], outs[1])
    err = _same("apply_scores_avg vs plain", outs[0], outs[2])
    scratch = base.clone()
    ms = device_ms(lambda: gs.apply_scores_avg(S, scratch[:n]))
    plain_ms = device_ms(lambda: gs.apply_avg_plain(S, scratch[:n]),
                         reps=3, warmup=1)
    b_ms, b_by = bound_ms(8.0 * n, 4.0 * n)
    log("apply_scores_avg: 255 leaves over %d lanes, t = 5: two launches and "
        "the plain version on the card bit-identical; kernel %.4f ms, plain "
        "%.4f ms, bound %.4f ms (%s)" % (n, ms, plain_ms, b_ms, b_by))
    recs.append({"name": "apply_scores_avg", "route": "cuda",
                 "source": "lightgbm_torch/csrc/grow_step.cu",
                 "replaces": "lightgbm_tpu/ops/grow_persist.py:1775 "
                             "(apply_scores_avg of the fused RF driver, "
                             "jnp; no Pallas kernel)",
                 "launches": 0, "max_abs_err": err, "ms": ms,
                 "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
                 "library_ms": None, "lanes": n})
    log("dart/rf kernels: %.1f s" % (time.time() - t0))
    return recs


def check_bag_path(bst, path):
    """After the bagging or goss path: the in-bag count of each tree (its
    root's count) against the plain count of its window (bagging: rows
    whose hash at fold_in(PRNGKey(bagging_seed), it // bagging_freq) is
    below the fraction, on the CPU), equal within a window and different
    across one; then one more iteration eagerly (no graph) with the bag
    step watched: goss_select's threshold equal to torch.kthvalue's over
    that iteration's |g * h| and the weighed rows and count equal to the
    plain version's on the CPU from the same rows."""
    import torch
    from lightgbm_torch.ops import bag
    from lightgbm_torch.ops.grow_persist import PersistGrower
    b = bst._booster
    cfg, n = b.config, b.train_data.num_data
    roots = [int(t.internal_count[0]) for t in b.models]
    if path == "bagging":
        freq = int(cfg.bagging_freq)
        rid = torch.arange(n)
        want = {}
        for it in range(len(roots)):
            w = it // freq
            if w not in want:
                k0, k1 = bag.window_key(cfg.bagging_seed, w)
                want[w] = int((bag.hash_uniform_plain(rid, k0, k1)
                               < np.float32(cfg.bagging_fraction)).sum())
            if roots[it] != want[w]:
                raise AssertionError("train bagging: iteration %d has %d "
                                     "rows in the bag, the plain count of "
                                     "window %d is %d" % (it, roots[it], w,
                                                          want[w]))
        if len(want) > 1 and len(set(want.values())) < 2:
            raise AssertionError("train bagging: the windows' counts %s "
                                 "do not change" % want)
        log("train bagging: rows in the bag per iteration %s = the plain "
            "count of each bagging_freq=%d window %s" % (roots, freq, want))
    else:
        skip = int(1.0 / float(cfg.learning_rate))
        if roots[:skip] != [n] * min(skip, len(roots)) or \
                max(roots[skip:], default=0) >= n:
            raise AssertionError("train goss: rows in the bag %s" % roots)
        log("train goss: rows in the bag per iteration %s (all %d below "
            "int(1 / learning_rate) = %d)" % (roots, n, skip))
    gr = b.tree_learner._persist_gr
    seen = {}
    step = PersistGrower.bag_step

    def watched(self, pay):
        seen["rows"] = pay[self.nbw:self.nbw + 4, :self.n].to("cpu",
                                                              copy=True)
        step(self, pay)
        seen["after"] = pay[self.nbw + 2:self.nbw + 4, :self.n].to(
            "cpu", copy=True)
        seen["count"] = int(self.bag.count[0])
        seen["sel"] = self.bag.sel[:2].to("cpu", copy=True)
        seen["ints"] = self.bag.ints.to("cpu", copy=True)
        seen["flts"] = self.bag.flts.to("cpu", copy=True)
    gr.capture = False
    PersistGrower.bag_step = watched
    try:
        bst.update()
        torch.cuda.synchronize()
    finally:
        PersistGrower.bag_step = step
        gr.capture = True
    rows = seen["rows"].clone()
    st = bag.BagState("cpu")
    st.ints.copy_(seen["ints"])
    st.flts.copy_(seen["flts"])
    lab, rid = rows[0].view(torch.float32), rows[1]
    g, h = rows[2].view(torch.float32), rows[3].view(torch.float32)
    msg = ""
    if gr._bag_mode == bag.MODE_GOSS:
        s = (g * h).abs()
        k = int(st.ints[bag.BI_TOPK])
        kth = torch.kthvalue(s, n - k + 1).values
        if int(seen["sel"][0]) != int(kth.view(torch.int32)) & 0xFFFFFFFF:
            raise AssertionError("train goss: threshold bits %#x, "
                                 "torch.kthvalue's %r" % (
                                     int(seen["sel"][0]), float(kth)))
        bag.goss_select_plain(g, h, n, st)
        msg = ", its threshold %r equal to torch.kthvalue's" % float(kth)
    bag.bag_apply_plain(rid, lab, g, h, n, gr._bag_mode, st)
    _same("train %s: one more iteration's bag step vs plain" % path,
          seen["after"], rows[2:4])
    if seen["count"] != int(st.count[0]):
        raise AssertionError("train %s: bag count %d, plain %d"
                             % (path, seen["count"], int(st.count[0])))
    log("train %s: one more iteration (eager, the bag step watched): %d "
        "rows in the bag%s; rows and count bit-identical to the plain "
        "version on the CPU" % (path, seen["count"], msg))


def np_eval_binary(lab, qb):
    return lambda sc: {m: fn(lab, sc) for m, fn in NP_METRICS.items()}


def np_eval_ndcg(lab, qb):
    fn = np_ndcg(lab, qb, [1, 3, 5, 10])
    return lambda sc: dict(zip(("ndcg@1", "ndcg@3", "ndcg@5", "ndcg@10"),
                               fn(sc)))


# a path with a held-out set: (its metric parameters, numpy's metrics by
# record name: a function of (labels, query boundaries) that returns one of
# the raw scores)
VALID = {"persist": ({"metric": ["binary_logloss", "auc"]}, np_eval_binary),
         "ltr": ({"metric": ["ndcg"], "eval_at": [1, 3, 5, 10]},
                 np_eval_ndcg)}


def phase_train_valid(lgb, ds, Xv, yv, iters, card, plain, path="persist",
                      gv=None):
    """A valid path: the `path`'s parameters and Dataset with a held-out
    set (query sizes `gv`) binned against it, valid_sets=[train, valid],
    VALID's metrics (HIGGS: binary_logloss and auc; MSLR: ndcg at 1, 3, 5
    and 10), early_stopping_rounds=5, evals_result.
    Gates: the model text equal to the persist path's after as many
    iterations (`plain`: phase_train's keep of that path); the graph
    captured once and replayed by every later iteration; valid_walk
    launched once per tree with a split (every other kernel as the
    persist path); one more iteration with its evaluation reads the card
    twice (the trees, the metric values) and copies to it once more than
    the persist path's iteration (the node arrays); every recorded value
    within 1e-12 relative of numpy's metric of predict(Xv, raw_score=True,
    num_iteration=i) and of the training scores after iteration i.
    Returns (launch counts, the first tree, the validation set's
    BinnedDataset)."""
    import torch
    metric_params, np_eval = VALID[path]
    params = dict(COMMON, **PATHS[path][0], **metric_params)
    dv = lgb.Dataset(Xv, yv, group=gv, reference=ds, params=params)
    rec, train_scores = {}, []

    def keep_scores(env):
        train_scores.append(env.model._booster.train_score.score.cpu()
                            .numpy())

    reset_counts()
    torch.cuda.synchronize()
    t = time.time()
    bst = lgb.train(params, ds, iters, valid_sets=[ds, dv],
                    valid_names=["training", "valid"],
                    early_stopping_rounds=5, evals_result=rec,
                    verbose_eval=False, callbacks=[keep_scores])
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_counts()
    trees = bst._booster.models
    n = len(next(iter(rec["valid"].values())))
    tag = "valid" if path == "persist" else path + " valid"
    log("train %s: %d rows + a held-out set of %d rows, %d iterations "
        "(best %d) in %.1f s with the evaluation and the numpy copies of "
        "the training scores, %d trees, leaves per tree %s"
        % (tag, ds.num_data(), len(yv), n, bst.best_iteration, wall,
           len(trees), [t_.num_leaves for t_ in trees]))
    want, _ = expected_launches(bst, trees)
    want["valid_walk"] = sum(t_.num_leaves > 1 for t_ in trees)
    bad = {k: (counts[k], want.get(k, 0)) for k in counts
           if counts[k] != want.get(k, 0)}
    if bad or not counts["valid_walk"]:
        raise AssertionError("train %s: launch counts (got, expected) "
                             "%s, all %s" % (tag, bad, counts))
    log("train %s: launches %s (valid_walk once per tree with a split: "
        "%d)" % (tag, counts, counts["valid_walk"]))
    digest = model_digest(bst, -1)
    if digest != plain["digests"][n]:
        raise AssertionError("train %s: the model differs from the "
                             "persist path's after %d iterations (sha256 "
                             "%s against %s)" % (tag, n, digest,
                                                 plain["digests"][n]))
    log("train %s: model digest %s, equal to the persist path's after "
        "%d iterations (validation changes no tree)" % (tag, digest, n))
    gr = bst._booster.tree_learner._persist_gr
    if gr.use_level or gr._graph is None or gr.replays != n - 2:
        raise AssertionError("train %s: %d iterations, %s graph, %d "
                             "replays" % (tag, n, "a" if gr._graph else "no",
                                          gr.replays))
    log("train %s: the graph (%s nodes) captured at iteration 2 and "
        "replayed by the %d later iterations"
        % (tag, gr.graph_stats.get("nodes"), gr.replays))
    # every record against numpy, iteration by iteration
    raw = np.zeros(len(yv))
    y_train = ds._inner.metadata.label
    evals = {"valid": np_eval(yv, dv._inner.metadata.query_boundaries),
             "training": np_eval(y_train,
                                 ds._inner.metadata.query_boundaries)}
    worst = 0.0
    for i in range(1, n + 1):
        raw = raw + trees[i - 1].predict(Xv)
        for name, sc in (("valid", raw), ("training", train_scores[i - 1])):
            for metric, want_v in evals[name](sc).items():
                got = rec[name][metric][i - 1]
                rel = abs(got - want_v) / abs(want_v)
                worst = max(worst, rel)
                if not rel <= 1e-12:
                    raise AssertionError(
                        "train %s: iteration %d %s %s recorded %r, numpy "
                        "%r" % (tag, i, name, metric, got, want_v))
    if not np.array_equal(raw, bst.predict(Xv, raw_score=True,
                                           num_iteration=n)):
        raise AssertionError("train %s: the summed trees differ from "
                             "predict(num_iteration=%d)" % (tag, n))
    log("train %s: %d records x 2 sets x %d metrics within %.3g relative "
        "of numpy's metrics of predict(Xv, raw_score=True, num_iteration=i) "
        "and of the training scores (limit 1e-12); valid %s"
        % (tag, n, len(rec["valid"]), worst, "; ".join(
            "%s %s" % (m, ["%.6f" % v for v in vals])
            for m, vals in rec["valid"].items())))
    # one more iteration with its evaluation, as the engine runs it
    it = profile_iteration(lambda: (bst.update(),
                                    bst._evaluate(True, None)))
    ev = profile_iteration(lambda: bst._evaluate(True, None))
    wall_ms, busy, rows, dtoh, htod = it
    p_wall, p_busy, _, _, _ = plain["iteration"]
    walk_ms = sum(ms for ms, _, key in rows if "valid_walk" in key)
    log("train %s: one iteration with its evaluation %.1f ms wall, %.1f "
        "ms busy, idle %.3f; the persist path's iteration %.1f / %.1f / "
        "%.3f; valid_walk %.3f ms of it, the evaluation alone %.2f ms busy "
        "(%.1f ms wall) (%s)"
        % (tag, wall_ms, busy, 1 - busy / wall_ms, p_wall, p_busy,
           1 - p_busy / p_wall, walk_ms, ev[1], ev[0], card))
    log("train %s: the evaluation's device time by kernel: %s"
        % (tag, "; ".join("%.2f ms / %d %s" % (ms, n_, key[:60])
                          for ms, n_, key in ev[2][:6])))
    log("train %s: device-to-host reads in that iteration: %d (the "
        "trees, the metric values); host-to-device copies: %d (the persist "
        "path's: %d, + the node arrays)" % (tag, dtoh, htod,
                                              plain["htod"]))
    if dtoh != 2 or htod != plain["htod"] + 1:
        raise AssertionError("train %s: %d reads and %d uploads in one "
                             "iteration with validation" % (tag, dtoh, htod))
    first, vinner = trees[0], dv._inner
    del bst, train_scores
    torch.cuda.empty_cache()
    return counts, first, vinner


ES_ROUTES = (
    ("persist", {"objective": "binary", "num_leaves": 63,
                 "tpu_persist_scan": "force"}, True, "binary"),
    ("v1", {"objective": "binary", "num_leaves": 63,
            "tpu_persist_scan": "false"}, False, "binary"),
    ("softmax persist", {"objective": "multiclass", "num_class": 3,
                         "metric": ["multi_logloss", "multi_error"],
                         "num_leaves": 31, "tpu_persist_scan": "force"},
     True, "multi"),
    ("lambdarank persist", {"objective": "lambdarank", "metric": ["ndcg"],
                            "eval_at": [5], "num_leaves": 63,
                            "tpu_persist_scan": "force"}, True, "rank"),
)


def parity_es_side(lgb, data, dev, rounds):
    """Early stopping on `dev`: each route of ES_ROUTES with noisy labels
    and learning_rate 0.5, valid_sets=[train, valid],
    early_stopping_rounds=3, at most `rounds` rounds: {route:
    (best_iteration, trees, evals_result, model digest)}."""
    out = {}
    for route, extra, persist, key in ES_ROUTES:
        X, y, Xv, yv, *groups = data[key]
        g, gv = groups or (None, None)
        p = dict(COMMON, learning_rate=0.5, **extra, device_type=dev)
        p.setdefault("metric", ["binary_logloss", "auc"])
        t = time.time()
        dt = lgb.Dataset(X, y, group=g, params=p)
        dv = lgb.Dataset(Xv, yv, group=gv, reference=dt, params=p)
        rec = {}
        bst = lgb.train(p, dt, rounds, valid_sets=[dt, dv],
                        early_stopping_rounds=3, evals_result=rec,
                        verbose_eval=False)
        if bst._booster.use_persist != persist:
            raise AssertionError("parity es %s: wrong grower on %s"
                                 % (route, dev))
        out[route] = (bst.best_iteration, bst.num_trees(), rec,
                      model_digest(bst, -1))
        first = next(iter(rec["valid_1"]))
        log("parity es %s: %s stopped after %d rounds (best %d, %d "
            "trees) in %.1f s" % (route, dev, len(rec["valid_1"][first]),
                                  bst.best_iteration, bst.num_trees(),
                                  time.time() - t))
    return out


def phase_parity_es(cuda, cpu, rounds):
    """Early stopping on cuda and on the CPU (parity_es_side's results):
    the same best_iteration and number of trees (the stop must fire),
    records within 1e-12 relative, equal model text."""
    for route, _, _, _ in ES_ROUTES:
        (bc, tc, rc, dc), (bp, tp, rp, dp) = cuda[route], cpu[route]
        first = next(iter(rc["valid_1"]))
        if not 0 < bc < len(rc["valid_1"][first]) < rounds:
            raise AssertionError("parity es %s: early stopping did not fire "
                                 "(best %d)" % (route, bc))
        if (bc, tc) != (bp, tp) or dc != dp:
            raise AssertionError("parity es %s: best %d / %d trees / %s on "
                                 "cuda, %d / %d / %s on cpu"
                                 % (route, bc, tc, dc[:16], bp, tp, dp[:16]))
        worst = 0.0
        for name in rc:
            for metric in rc[name]:
                a, b = np.array(rc[name][metric]), np.array(rp[name][metric])
                if a.shape != b.shape:
                    raise AssertionError("parity es %s: %s %s has %d records "
                                         "on cuda, %d on cpu" % (
                                             route, name, metric, len(a),
                                             len(b)))
                rel = np.abs(a - b) / np.maximum(np.abs(b), 1e-300)
                worst = max(worst, float(rel.max()))
        if not worst <= 1e-12:
            raise AssertionError("parity es %s: records differ by %.3g "
                                 "relative" % (route, worst))
        log("parity es %s: best_iteration %d, %d trees, model text (sha256 "
            "%s) equal on cuda and cpu; records within %.3g relative"
            % (route, bc, tc, dc[:16], worst))


# per path: each wrapper whose every launch runs one histogram partial
# kernel, and that kernel's name prefix (the payload_ordered.cuh kernel is
# a template on its caller's tag)
PROFILED = {
    "persist": (("root_hist", "payload_ordered_partial<RootHist"),
                ("seg_hist", "payload_ordered_partial<SegHist")),
    "level": (("root_hist", "payload_ordered_partial<RootHist"),
              ("level_seg_hist", "payload_ordered_partial<LevelSegHist"),
              ("seg_hist", "payload_ordered_partial<SegHist")),
    "bundled": (("root_hist", "payload_ordered_partial<RootHist"),
                ("level_pass", "payload_ordered_partial<LevelPassHist"),
                ("split_pass", "payload_ordered_partial<SplitPassHist")),
    "v1": (("hist_window", "hist_window_partial"),),
}
PROFILED["multiclass"] = PROFILED["regression"] = PROFILED["l1"] = \
    PROFILED["ltr"] = PROFILED["bagging"] = PROFILED["goss"] = \
    PROFILED["dart"] = PROFILED["rf"] = PROFILED["persist"]
PROFILED["xendcg"] = PROFILED["knobs"] = PROFILED["airline"] = \
    PROFILED["airline onehot"] = PROFILED["v1"]
# the kernels of the port's own sources (csrc/); every other kernel in a
# profile is PyTorch's (the gradient fills, copies, the score snapshot)
OWN_KERNELS = ("payload_ordered_partial", "hist_window", "split_", "level_",
               "consolidate_copy", "gs_", "scan_pair", "scan_blocks",
               "seg_hist", "root_hist", "ordered_", "payload_hist_reduce",
               "empty_launch", "renew_leaf", "lambdarank_grad",
               "xendcg_grad", "cat_scan", "bag_apply", "gsel_")


# the partition's kernels: count, scan and scatter of split_pass and
# level_pass, and the end-of-tree consolidation
PARTITION_STAGES = ("split_count", "split_scan", "split_scatter",
                    "level_count", "level_scan", "level_scatter",
                    "consolidate_copy")


def seg_hist_call_mix(bst):
    """One more per-split iteration run eagerly (the grower's capture off),
    with every seg_hist call's segment and buffer recorded, then each call
    that did work (the done flag clear) timed again, alone, in the device
    form on the buffer it read, as that iteration left it (each child's
    lanes hold the same rows, in leaf order): seg_hist against one
    index_add_ over the same lanes, both on the card's clock behind a
    short sleep kernel, and the call's bound. Logged in all and by the
    teams per group the kernel takes at HIGGS's 28 groups on an H100 (up
    to 4 row blocks: four; 5 to 9: two; more: one)."""
    import torch
    import lightgbm_torch.ops.grow_persist as gp
    from lightgbm_torch.ops.histogram import row_blocks
    gr = bst._booster.tree_learner._persist_gr
    calls, real = [], gp.seg_hist_device

    def record(pay, plan, nbw, seg, out, partial, done=None, alt=None,
               swap=None):
        calls.append((pay, alt, plan, int(nbw), seg.clone(), done.clone(),
                      swap.clone()))
        return real(pay, plan, nbw, seg, out, partial, done=done, alt=alt,
                    swap=swap)

    gp.seg_hist_device = record
    gr.capture = False
    try:
        bst.update()
        torch.cuda.synchronize()
    finally:
        gp.seg_hist_device = real
        gr.capture = True
    live = []
    for pay, alt, plan, nbw, seg, done, swap in calls:
        if int(done[0]) == 0:
            st, ln = seg.tolist()
            live.append((alt if int(swap[0]) else pay, plan, nbw, st, ln))
    if not live:
        raise AssertionError("the per-split iteration made no seg_hist call")
    classes = {}
    for pay, plan, nbw, st, ln in live:
        k_ms = device_ms(seg_hist_dev(pay, plan, nbw, st, ln, gr.n), reps=3,
                         warmup=1, sleep_cycles=2_000_000)
        idx, vals, out = index_add_inputs(pay, plan.tolist(), nbw,
                                          [(st, ln)])
        l_ms = device_ms(lambda: out.index_add_(0, idx, vals), reps=3,
                         warmup=1, sleep_cycles=2_000_000)
        del idx, vals, out
        G = plan.shape[0]
        b_ms = bound_ms(ln * (4 * nbw + 8) + 2 * G * 256 * 4,
                        2.0 * ln * G)[0]
        nb = row_blocks(ln, G)[0]
        cls = ("up to 4 row blocks" if nb <= 4 else
               "5 to 9 row blocks" if nb <= 9 else "10 or more row blocks")
        for key in ("all", cls):
            c = classes.setdefault(key, [0, 0, 0.0, 0.0, 0.0])
            c[0] += 1
            c[1] += ln
            c[2] += k_ms
            c[3] += l_ms
            c[4] += b_ms
    torch.cuda.empty_cache()
    lens = sorted(c[4] for c in live)
    log("seg_hist over one per-split iteration's %d calls (%d queued, %d of "
        "them no-ops after the tree stopped; lengths %d to %d, median %d), "
        "each timed alone in the device form: %s" % (
            len(live), len(calls), len(calls) - len(live), lens[0], lens[-1],
            lens[len(lens) // 2],
            "; ".join("%s: %d calls, %d lanes, kernel %.4f ms (mean %.4f), "
                      "index_add_ %.4f ms (mean %.4f), bound %.4f ms"
                      % (key, n, lanes, k, k / n, li, li / n, b)
                      for key, (n, lanes, k, li, b) in classes.items())))


# CUDA runtime and driver calls that queue work, and those that wait for
# the card (a copy to or from pageable memory waits for its stream)
LAUNCH_API = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
              "cuLaunchKernelEx", "cudaGraphLaunch", "cuGraphLaunch")
WAIT_API = ("cudaMemcpyAsync", "cudaMemcpy", "cuMemcpy",
            "cudaStreamSynchronize", "cuStreamSynchronize",
            "cudaEventSynchronize")


def host_split(prof, wall_ms, path):
    """The host time of the profiled iteration (wall_ms, the host clock
    around the update) split into (a) Python, (b) launch calls and (c)
    time blocked in copies that wait for the card (the device-to-host
    reads, and host-to-device copies from pageable memory, which wait for
    their stream), from the profiler's CPU events; and the grower steps'
    record_function ranges (grow::*, inclusive host time) where the
    iteration ran them eagerly."""
    launch = wait = 0.0
    n_launch = n_wait = 0
    steps = {}
    for ev in prof.key_averages():
        if str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        key = ev.key
        if key.startswith(LAUNCH_API):
            launch += ev.self_cpu_time_total / 1e3
            n_launch += ev.count
        elif key.startswith(WAIT_API):
            wait += ev.self_cpu_time_total / 1e3
            n_wait += ev.count
        elif key.startswith("grow::"):
            steps[key] = (ev.cpu_time_total / 1e3, ev.count)
    log("profile %s: host split of the profiled iteration (%.1f ms on the "
        "host clock): (a) Python %.1f ms, (b) launch calls %.1f ms in %d "
        "calls, (c) blocked in copies that wait for the card %.1f ms in %d "
        "calls" % (path, wall_ms, wall_ms - launch - wait, launch, n_launch,
                   wait, n_wait))
    if steps:
        log("profile %s: grower steps (record_function, inclusive host ms "
            "and calls): %s" % (path, ", ".join(
                "%s %.1f/%d" % (k[6:], v[0], v[1])
                for k, v in sorted(steps.items(), key=lambda kv: -kv[1][0]))))


def phase_profile(bst, card, path):
    """One more boosting iteration timed on the host clock, then another
    under torch.profiler: device time by kernel, and the device's idle
    share of the unprofiled iteration's wall time; the host split of the
    profiled iteration. The profiler's count of the path's histogram
    kernels is printed beside their launch count, since a window that lost
    events would understate the busy time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t = time.time()
    bst.update()
    torch.cuda.synchronize()
    wall_ms = (time.time() - t) * 1e3
    names = tuple(w for w, _ in PROFILED[path])
    kernels = tuple(k for _, k in PROFILED[path])
    before = read_counts()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        bst.update()
        t2 = time.perf_counter()
        torch.cuda.synchronize()
    after = read_counts()
    rows = _device_events(prof)
    seen = sum(n for _, n, key in rows
               if key.removeprefix("void ").startswith(kernels))
    busy = sum(r[0] for r in rows)
    log("profile %s: one iteration %.1f ms wall (unprofiled), device busy "
        "%.1f ms (profiled iteration; profiler saw %d %s kernels for %d %s "
        "launches), idle share %.3f (%s)"
        % (path, wall_ms, busy, seen, "/".join(kernels),
           sum(after[k] - before[k] for k in names),
           " + ".join(names), 1 - busy / wall_ms, card))
    log("profile %s: %d device kernels and copies in the profiled "
        "iteration" % (path, sum(n for _, n, _ in rows)))
    host_split(prof, (t2 - t1) * 1e3, path)
    for ms, n, key in rows[:12]:
        log("profile %s:   %9.2f ms  %6d calls  %s" % (path, ms, n, key[:90]))
    log("profile %s: partition stages: %s" % (path, ", ".join(
        "%s %.2f ms in %d calls" % (
            k, sum(ms for ms, _, key in rows
                   if key.removeprefix("void ").startswith(k + "(")),
            sum(n for _, n, key in rows
                if key.removeprefix("void ").startswith(k + "(")))
        for k in PARTITION_STAGES)))
    scan = "scan_blocks_kernel" if path == "bundled" else "scan_pair_kernel"
    gathers = [(ms, n) for ms, n, key in rows
               if "index" in key.lower() or "gather" in key.lower()]
    log("profile %s: the split scan %s %.2f ms in %d calls; torch index/"
        "gather kernels (none of them the scan's operands) %.2f ms in %d "
        "calls" % (path, scan, sum(ms for ms, _, key in rows
                                   if key.removeprefix("void ").startswith(
                                       scan)),
                   sum(n for _, n, key in rows
                       if key.removeprefix("void ").startswith(scan)),
                   sum(ms for ms, _ in gathers), sum(n for _, n in gathers)))
    if any("copy_back" in key for _, _, key in rows):
        raise AssertionError("profile %s: a copy-back kernel ran" % path)
    log("profile %s: histogram partials by wrapper: %s" % (path, ", ".join(
        "%s %.2f ms in %d calls" % (
            w, sum(ms for ms, _, key in rows
                   if key.removeprefix("void ").startswith(k)),
            sum(n for _, n, key in rows
                if key.removeprefix("void ").startswith(k)))
        for w, k in PROFILED[path])))
    theirs = [(ms, n, key) for ms, n, key in rows
              if not key.removeprefix("void ").startswith(OWN_KERNELS)]
    log("profile %s: PyTorch's kernels and copies (the gradient fills, the "
        "score snapshot and the stash copies) %.2f ms in %d calls: %s" % (
            path, sum(ms for ms, _, _ in theirs),
            sum(n for _, n, _ in theirs),
            "; ".join("%.2f ms / %d %s" % (ms, n, key[:70])
                      for ms, n, key in theirs[:6])))
    if path in RANK_PATHS:
        rk = [(ms, n) for ms, n, key in rows
              if key.removeprefix("void ").startswith(("lambdarank_grad",
                                                      "xendcg_grad"))]
        log("profile %s: the profiler saw the ranking gradient kernel %d "
            "times, %.3f ms (a graph replay's first kernels can fall outside "
            "its window; the kernel phase times it apart)"
            % (path, sum(c for _, c in rk), sum(m for m, _ in rk)))
    if path == "l1":
        renew = [(ms, n) for ms, n, key in rows if "renew_leaf" in key]
        sorts = [(ms, n) for ms, n, key in rows if "sort" in key.lower()]
        log("profile l1: the renewal's kernels: renew_leaf %.3f ms in %d "
            "calls, sort kernels %.3f ms in %d calls (%.1f%% of busy)"
            % (sum(m for m, _ in renew), sum(c for _, c in renew),
               sum(m for m, _ in sorts), sum(c for _, c in sorts),
               100 * sum(m for m, _ in renew + sorts) / busy))
    steps = [(ms, n, key) for ms, n, key in rows
             if key.removeprefix("void ").startswith("gs_")]
    if steps:
        log("profile %s: grow_step kernels %.2f ms in %d calls (%s)" % (
            path, sum(ms for ms, _, _ in steps), sum(n for _, n, _ in steps),
            ", ".join("%s %.2f/%d" % (key.removeprefix("void ")
                                      .split("(")[0], ms, n)
                      for ms, n, key in steps)))
    if path == "persist":
        seg_hist_call_mix(bst)


PARITY = (
    # name, data, parameters beyond COMMON, the route: persistent grower,
    # level phase, block scan
    ("persist", "higgs", {"num_leaves": 255, "tpu_persist_scan": "force"},
     (True, False, False)),
    ("v1", "higgs", {"num_leaves": 255, "tpu_persist_scan": "false"},
     (False, False, False)),
    ("level", "higgs", {"num_leaves": 256, "max_depth": 8,
                        "tpu_persist_scan": "force"}, (True, True, False)),
    ("bundled", "expo", {"num_leaves": 256, "max_depth": 8,
                         "tpu_persist_scan": "force"}, (True, True, True)),
    ("poisson", "higgs-counts", {"objective": "poisson", "num_leaves": 255,
                                 "tpu_persist_scan": "force"},
     (True, False, False)),
) + tuple(
    ("%s %s" % (obj, name), "higgs-3", dict(extra, objective=obj,
                                            num_class=3), route)
    for obj in ("multiclass", "multiclassova")
    for name, extra, route in (
        ("persist", {"num_leaves": 255, "tpu_persist_scan": "force"},
         (True, False, False)),
        ("level", {"num_leaves": 256, "max_depth": 8,
                   "tpu_persist_scan": "force"}, (True, True, False)),
        ("v1", {"num_leaves": 255, "tpu_persist_scan": "false"},
         (False, False, False)))) + tuple(
    # leaf renewal on both growers, the row gradient mode (MAPE,
    # cross-entropy, reg_sqrt) on the persistent one; "-w": sample weights.
    # 63 leaves: the CPU side of a 255-leaf path takes ~15 s
    (path, name, dict(extra, num_leaves=63,
                      tpu_persist_scan="false" if path.endswith("v1")
                      else "force"), (not path.endswith("v1"), False, False))
    for path, name, extra in (
        ("l1 persist", "higgs-l2", {"objective": "regression_l1"}),
        ("l1 v1", "higgs-l2", {"objective": "regression_l1"}),
        ("quantile 0.9 weighted", "higgs-l2-w", {"objective": "quantile",
                                                 "alpha": 0.9}),
        ("mape", "higgs-mape", {"objective": "mape"}),
        ("cross_entropy", "higgs-01", {"objective": "cross_entropy"}),
        ("cross_entropy_lambda weighted", "higgs-01-w",
         {"objective": "cross_entropy_lambda"}),
        ("reg_sqrt persist", "higgs-abs", {"objective": "regression",
                                           "reg_sqrt": True}))) + tuple(
    # ranking, weighted, on make_ltr_like rows in variable-length queries
    ("%s %s weighted" % (obj, route), "ltr-w",
     {"objective": obj, "num_leaves": 63,
      "tpu_persist_scan": "force" if route == "persist" else "false"},
     (route == "persist", False, False))
    for obj, route in (("lambdarank", "persist"), ("lambdarank", "v1"),
                       ("rank_xendcg", "v1"))) + tuple(
    # the split scan's knobs on v1 by default routing (at 200k rows the
    # card would take the persistent grower without them), each alone and
    # all five together, at 63 leaves; lambda_l1 sized to this row count
    ("knobs %s" % name, "higgs", dict(extra, num_leaves=63),
     (False, False, False))
    for name, extra in (
        ("lambda_l1", {"lambda_l1": 10.0}),
        ("max_delta_step", {"max_delta_step": 0.5}),
        ("monotone", {"monotone_constraints":
                      KNOB_PARAMS["monotone_constraints"]}),
        ("extra_trees", {"extra_trees": True}),
        ("bynode", {"feature_fraction_bynode": 0.8}),
        ("all five", dict(KNOB_PARAMS, lambda_l1=10.0)))) + (
    # a custom objective (the binary gradients from the host) on v1
    ("fobj binary", "higgs", {"objective": "none", "num_leaves": 63,
                              "fobj": "binary"}, (False, False, False)),
    # categorical features on v1, both routes of cat_scan, 3 iterations at
    # 63 leaves (the CPU side of a 255-leaf path takes ~13 s)
    ("airline sorted", "airline", dict(AIRLINE, iters=3, num_leaves=63),
     (False, False, False)),
    ("airline onehot", "airline", dict(PATHS["airline onehot"][0], iters=3,
                                       num_leaves=63),
     (False, False, False))) + tuple(
    # bagging (the bagging path's fraction and window), balanced bagging
    # and GOSS (the goss path's rates, sampling from iteration 2) on
    # --bag-parity-rows HIGGS rows, 31 leaves, 6 iterations: a window
    # boundary and four sampled GOSS iterations, the persistent grower's
    # later iterations graph replays with new device scalars
    ("%s %s" % (name, route), "higgs-bag",
     dict(extra, num_leaves=31, iters=6,
          tpu_persist_scan="force" if route == "persist" else "false"),
     (route == "persist", False, False))
    for name, extra, routes in (
        ("bagging", {"bagging_fraction": 0.8, "bagging_freq": 5},
         ("persist", "v1")),
        ("balanced bagging", {"pos_bagging_fraction": 0.9,
                              "neg_bagging_fraction": 0.5,
                              "bagging_freq": 2}, ("persist",)),
        ("goss", {"boosting": "goss", "top_rate": 0.2, "other_rate": 0.1,
                  "learning_rate": 0.5}, ("persist", "v1")))
    for route in routes) + tuple(
    # DART (drop_rate 0.3: drops from iteration 3) and RF (the rf path's
    # bag) on both growers on --bag-parity-rows HIGGS rows, and DART on the
    # bundled Expo rows, 31 leaves, 8 iterations
    ("%s %s" % (name, route), data,
     dict(extra, num_leaves=31, iters=8,
          tpu_persist_scan="force" if route in ("persist", "bundled")
          else "false"),
     (route != "v1", False, route == "bundled"))
    for name, extra, routes in (
        ("dart", {"boosting": "dart", "drop_rate": 0.3},
         (("persist", "higgs-bag"), ("v1", "higgs-bag"),
          ("bundled", "expo"))),
        ("rf", {"boosting": "rf", "bagging_fraction": 0.7,
                "bagging_freq": 1},
         (("persist", "higgs-bag"), ("v1", "higgs-bag"))))
    for route, data in routes)
# the paths trained `--deep-parity-iters` iterations (ROADMAP C7: the
# binary persist and v1 paths and softmax on its three routes; the knob
# and custom-objective paths)
DEEP_PARITY = ("persist", "v1", "multiclass persist", "multiclass level",
               "multiclass v1", "fobj binary") + tuple(
    p[0] for p in PARITY if p[0].startswith("knobs "))


def binary_fobj(preds, ds):
    """A custom objective: the binary objective's gradients (sigmoid 1,
    labels in {0, 1}) in numpy f64."""
    y = np.where(ds.get_label() > 0, 1.0, -1.0)
    resp = -y / (1.0 + np.exp(y * preds))
    a = np.abs(resp)
    return resp, a * (1.0 - a)


FOBJ = {"binary": binary_fobj}


def parity_side(lgb, data, dev, iters, mc_iters, deep_iters):
    """Every PARITY path trained on `dev`: {path: (trees, model digest,
    iterations)}. `data` maps a PARITY data name to (X, y), (X, y,
    weights) or (X, y, weights or None, query sizes); the DEEP_PARITY
    paths train `deep_iters` iterations, the other multiclass paths
    `mc_iters` (3 trees each), the rest `iters`."""
    built, out = {}, {}
    for path, name, extra, (persist, level, blocks) in PARITY:
        X, y, *rest = data[name]
        w = rest[0] if rest else None
        g = rest[1] if len(rest) > 1 else None
        extra = dict(extra)
        fobj = FOBJ.get(extra.pop("fobj", None))
        own_iters = extra.pop("iters", None)
        params = dict(COMMON, **extra)
        n_it = own_iters or (
            deep_iters if path in DEEP_PARITY else
            mc_iters if params.get("num_class", 1) > 1 else iters)
        p = dict(params, device_type=dev)
        t = time.time()
        ds = built.get(name) or lgb.Dataset(X, y, weight=w, group=g,
                                            params=p)
        if g is not None:
            # the ranking paths share one binned Dataset per device (137
            # features take seconds to bin)
            built[name] = ds
        bst = lgb.train(p, ds, n_it, fobj=fobj)
        if bst._booster.use_persist != persist:
            raise AssertionError("parity %s: wrong grower on %s"
                                 % (path, dev))
        if level or blocks:
            gr = bst._booster.tree_learner._persist_gr
            if level and not sum(a for a, _ in gr.grow_stats) or \
                    (gr.blocks is not None) != blocks:
                raise AssertionError("parity %s: the level phase or the "
                                     "block scan did not run on %s"
                                     % (path, dev))
        out[path] = (bst._booster.models, model_digest(bst), n_it)
        log("parity %s: %s trained %d trees in %.1f s"
            % (path, dev, len(out[path][0]), time.time() - t))
    return out


def phase_parity(cuda, cpu, rows):
    """Each PARITY path grew the same trees on cuda and on the CPU
    (`cuda`, `cpu`: parity_side's results), with the same leaf values and
    the same model text (sha256 without the parameters); `rows`: the rows
    of each data name."""
    for path, name, _, _ in PARITY:
        (a, dc, n_it), (b, dp, _) = cuda[path], cpu[path]
        if len(a) != len(b):
            raise AssertionError("parity %s: %d trees on cuda, %d on cpu"
                                 % (path, len(a), len(b)))
        for i, (ta, tb) in enumerate(zip(a, b)):
            k = ta.num_leaves - 1
            if ta.num_leaves != tb.num_leaves or not all(
                    np.array_equal(getattr(ta, f)[:k], getattr(tb, f)[:k])
                    for f in ("split_feature", "threshold_in_bin",
                              "decision_type", "left_child", "right_child")
            ) or not np.array_equal(ta.leaf_count[:k + 1],
                                    tb.leaf_count[:k + 1]):
                raise AssertionError("parity %s: tree %d differs in "
                                     "structure" % (path, i))
            if not np.array_equal(ta.leaf_value[:k + 1],
                                  tb.leaf_value[:k + 1]):
                raise AssertionError(
                    "parity %s: tree %d leaf values differ, max abs diff "
                    "%.3g" % (path, i, float(np.abs(
                        ta.leaf_value[:k + 1] - tb.leaf_value[:k + 1]).max())))
        if dc != dp:
            raise AssertionError("parity %s: model text differs (sha256 %s "
                                 "on cuda, %s on cpu)" % (path, dc, dp))
        log("parity %s: %d rows x %d iterations (%d trees): tree structure, "
            "leaf values and model text (sha256 %s) equal on cuda and cpu"
            % (path, rows[name], n_it, len(a), dc[:16]))


# ---- the Booster API between iterations: rollback, reset, refit ------------

# the split keys the api phase resets on the persist path's Booster
API_RESET = {"num_leaves": 63, "lambda_l2": 1.0, "min_data_in_leaf": 200}


def leaf_sums_record(cap, card):
    """leaf_sums on the inputs of refit's last tree (`cap`: its leaf of
    every held-out row, the f32 grad and hess, its leaf count; the rows
    ordered by leaf as refit orders them) and on one leaf holding every
    row: two launches equal, equal bit for bit to the plain version on the
    CPU. Times (median per call on the card): the kernel,
    the plain version on the card (a loop over the leaves), and one
    index_add_ of the (grad, hess, 1) rows by leaf, widened to f64 (a
    library call that sums the same values in an order of its own). Bound:
    the function's data, each row's int32 leaf and f32 grad and hess read
    once and each leaf's (sums, count) written once; two f64 adds a
    row."""
    import torch
    from lightgbm_torch.ops.refit import (leaf_segments, leaf_sums,
                                          leaf_sums_plain)
    order, seg = leaf_segments(cap["leaf"], cap["num_leaves"])
    g, h = cap["grad"], cap["hess"]
    n, L = order.numel(), seg.shape[0]
    err = 0.0
    whole = torch.tensor([[0, n]], dtype=torch.int64, device=order.device)
    for label, o, sg in (("the last tree's %d leaves" % L, order, seg),
                         ("one leaf holding every row", order, whole)):
        outs = []
        for _ in range(2):
            out = torch.full((sg.shape[0], 3), 7.5, dtype=torch.float64,
                             device=o.device)
            leaf_sums(o, g, h, sg, out)
            outs.append(out)
        cpu = torch.empty((sg.shape[0], 3), dtype=torch.float64)
        leaf_sums_plain(o.cpu(), g.cpu(), h.cpu(), sg.cpu(), cpu)
        torch.cuda.synchronize()
        err = max(err, _same("leaf_sums two launches, " + label,
                             outs[0], outs[1]),
                  _same("leaf_sums, " + label, outs[0], cpu))
    out = torch.empty((L, 3), dtype=torch.float64, device=order.device)
    ms = device_ms(lambda: leaf_sums(order, g, h, seg, out),
                   sleep_cycles=20_000_000)
    plain_ms = device_ms(lambda: leaf_sums_plain(order, g, h, seg, out),
                         reps=3, warmup=1)
    leaf = cap["leaf"].long()
    rows = torch.stack([g, h, torch.ones_like(g)], 1).double()
    acc = torch.zeros((L, 3), dtype=torch.float64, device=order.device)
    lib_ms = device_ms(lambda: acc.index_add_(0, leaf, rows),
                       sleep_cycles=20_000_000)
    b_ms, b_by = bound_ms(12.0 * n + 24.0 * L, 2.0 * n, f64=True)
    counts = seg[:, 1].cpu().numpy()
    log("leaf_sums: %d held-out rows in %d leaves (largest %d rows, %d "
        "empty) and in one leaf: two launches and the plain version on the "
        "CPU bit-identical; median time per call: kernel %.4f ms, plain (a "
        "loop over the leaves on the card) %.3f ms, index_add_ %.4f ms; "
        "bound %.6f ms (%s) (%s)" % (n, L, int(counts.max()),
                                     int((counts == 0).sum()), ms, plain_ms,
                                     lib_ms, b_ms, b_by, card))
    return {"name": "leaf_sums", "route": "cuda",
            "source": "lightgbm_torch/csrc/leaf_sums.cu",
            "replaces": "lightgbm_tpu/boosting/gbdt.py:802 (refit: the JAX "
                        "package's host np.bincount per leaf; no Pallas "
                        "kernel)",
            "launches": 0, "max_abs_err": err, "ms": ms,
            "plain_ms": plain_ms, "bound_ms": b_ms, "bound_by": b_by,
            "library_ms": lib_ms, "rows": n, "leaves": L}


def phase_api(lgb, bst, X, Xv, yv, card):
    """The Booster API between iterations on the persist path's Booster
    (10.5M HIGGS rows, 255 leaves; its graph replayed):
      rollback  rollback_one_iter(): the model text equal to its first
                n - 1 iterations' text, the payload's f32 scores equal to
                predict() on the first WALK_ROWS rows within 2 (n + 2) f32
                ulps of the largest score (each add and the subtraction
                rounding once), then one update() that grows a tree;
      reset     reset_parameter(API_RESET) and two update()s: the grower
                rebuilt for the new leaf budget, its first iteration run
                checked and its second captured as a new CUDA graph, at
                most 63 leaves a tree, the launch counts of the two equal
                to expected_launches;
      refit     refit() on the held-out rows: every tree's structure kept
                and its leaf counts summing to the rows, leaf_sums once
                per tree (its record: leaf_sums_record on the last tree's
                inputs);
      copies    pickle and deepcopy round trips predict bit-equal on the
                card.
    Returns (the launch counts of the refit, leaf_sums's record)."""
    import copy
    import pickle
    import torch
    from lightgbm_torch.ops import refit as refit_mod
    t_all = time.time()
    g = bst._booster
    sub = X[:WALK_ROWS]
    n_it = bst.current_iteration()
    t = time.time()
    short = bst.model_to_string(num_iteration=n_it - 1)
    bst.rollback_one_iter()
    torch.cuda.synchronize()
    roll_ms = (time.time() - t) * 1e3
    if bst.model_to_string() != short or bst.current_iteration() != n_it - 1:
        raise AssertionError("api: the rolled-back model text differs from "
                             "its first %d iterations' text" % (n_it - 1))
    raw = bst.predict(sub, raw_score=True)
    gap = float(np.abs(g.train_score.score[:len(sub)].cpu().numpy()
                       - raw).max())
    tol = 2 * (n_it + 2) * 1.1920929e-07 * max(1.0, np.abs(raw).max())
    if not gap <= tol:
        raise AssertionError("api: payload scores after the rollback differ "
                             "from predict by %.3g (limit %.3g)" % (gap, tol))
    t = time.time()
    bst.update()
    torch.cuda.synchronize()
    upd_ms = (time.time() - t) * 1e3
    if bst.current_iteration() != n_it or g.models[-1].num_leaves < 2:
        raise AssertionError("api: the update after the rollback grew no "
                             "tree")
    log("api rollback: %d -> %d iterations in %.1f ms, model text equal to "
        "the first %d iterations', payload scores vs predict on %d rows max "
        "abs diff %.3g (limit %.3g); one more update() %.1f ms grew a "
        "%d-leaf tree" % (n_it, n_it - 1, roll_ms, n_it - 1, len(sub), gap,
                          tol, upd_ms, g.models[-1].num_leaves))
    # split keys: the grower rebuilt, its graph captured anew
    old = g.tree_learner._persist_gr
    old_graph = old._graph
    reset_counts()
    t = time.time()
    bst.reset_parameter(dict(API_RESET))
    walls = []
    for _ in range(2):
        t1 = time.time()
        bst.update()
        torch.cuda.synchronize()
        walls.append((time.time() - t1) * 1e3)
    counts = read_counts()
    reset_ms = (time.time() - t) * 1e3
    gr = g.tree_learner._persist_gr
    trees = g.models[-2:]
    if gr is old or old_graph is None or gr._graph is None \
            or gr._graph[0] is old_graph[0] or not g.use_persist:
        raise AssertionError("api reset: the grower was not rebuilt with a "
                             "new graph (use_persist %s)" % g.use_persist)
    if gr.gc.num_leaves != 63 or any(t_.num_leaves > 63 for t_ in trees):
        raise AssertionError("api reset: trees of %s leaves after "
                             "num_leaves=63" % [t_.num_leaves
                                                for t_ in trees])
    want, _ = expected_launches(bst, trees)
    bad = {k: (counts[k], want.get(k, 0)) for k in counts
           if counts[k] != want.get(k, 0)}
    if bad:
        raise AssertionError("api reset: launch counts (got, expected) %s"
                             % bad)
    log("api reset: reset_parameter(%s) and two update()s in %.1f ms (%s "
        "ms): the grower rebuilt (%d leaves), the first iteration checked, "
        "the second captured as a new graph (%s nodes, capture %.1f ms), "
        "trees of %s leaves; launches %s equal to the trees' (%s)"
        % (API_RESET, reset_ms, ["%.1f" % w for w in walls],
           gr.gc.num_leaves, gr.graph_stats.get("nodes"),
           gr.graph_stats.get("capture_ms", 0.0),
           [t_.num_leaves for t_ in trees],
           {k: v for k, v in counts.items() if v}, card))
    # refit on the held-out rows, the per-leaf sums' inputs of its last
    # tree kept
    cap = {}
    sums = refit_mod.per_leaf_sums

    def keep(leaf, grad, hess, num_leaves):
        cap.update(leaf=leaf, grad=grad, hess=hess, num_leaves=num_leaves)
        return sums(leaf, grad, hess, num_leaves)
    refit_mod.per_leaf_sums = keep
    reset_counts()
    try:
        t = time.time()
        r = bst.refit(Xv, yv, decay_rate=0.9)
        torch.cuda.synchronize()
        refit_s = time.time() - t
        refit_counts = read_counts()
    finally:
        refit_mod.per_leaf_sums = sums
    T = len(g.models)
    if refit_counts["leaf_sums"] != T or len(r._booster.models) != T:
        raise AssertionError("api refit: leaf_sums ran %d times for %d "
                             "trees" % (refit_counts["leaf_sums"], T))
    for i, (a, b) in enumerate(zip(g.models, r._booster.models)):
        k = a.num_leaves - 1
        if b.num_leaves != a.num_leaves or not all(
                np.array_equal(getattr(a, f)[:k], getattr(b, f)[:k])
                for f in ("split_feature", "threshold", "decision_type",
                          "left_child", "right_child")) \
                or int(b.leaf_count[:k + 1].sum()) != len(yv):
            raise AssertionError("api refit: tree %d changed its structure "
                                 "or lost rows" % i)
    moved = float(np.abs(r.predict(Xv[:WALK_ROWS], raw_score=True)
                         - bst.predict(Xv[:WALK_ROWS], raw_score=True)).max())
    log("api refit: %d trees fit again to %d held-out rows (decay_rate 0.9) "
        "in %.2f s: structures equal, leaf counts sum to the rows, "
        "leaf_sums launched %d times, raw scores moved by up to %.4g"
        % (T, len(yv), refit_s, refit_counts["leaf_sums"], moved))
    rec = leaf_sums_record(cap, card)
    rec["refit_s"] = refit_s
    # pickling and copying go through model text
    t = time.time()
    want = bst.predict(X[:200_000], raw_score=True)
    for how, other in (("pickle", pickle.loads(pickle.dumps(bst))),
                       ("deepcopy", copy.deepcopy(bst))):
        if not np.array_equal(other.predict(X[:200_000], raw_score=True),
                              want):
            raise AssertionError("api: the %s round trip predicts other "
                                 "raw scores" % how)
    log("api copies: pickle and deepcopy round trips predict raw scores "
        "bit-equal on the card on 200000 rows (%.2f s)" % (time.time() - t))
    api_s = time.time() - t_all
    rec.update(api_s=api_s, rollback_ms=roll_ms, update_after_rollback_ms=
               upd_ms, reset_updates_ms=walls)
    log("api: %.1f s in all (%s)" % (api_s, card))
    return refit_counts, rec


API_PARITY_RESET = {"num_leaves": 15, "lambda_l2": 1.0,
                    "min_data_in_leaf": 50}


API_PARITY = ("rollback persist", "reset persist", "reset v1", "refit")


def parity_api_side(lgb, X, y, dev):
    """The Booster API on `dev` on the parity rows (31 leaves): rollback
    then update on the persistent grower; a split key reset
    (API_PARITY_RESET) after one iteration on the persistent and the v1
    grower; refit of the v1 run's model on the second half of the rows.
    {path: model digest}."""
    half = len(y) // 2
    texts, out = {}, {}
    for path in API_PARITY:
        t = time.time()
        if path == "refit":
            src = lgb.Booster(params=dict(COMMON, num_leaves=31,
                                          device_type=dev),
                              model_str=texts["reset v1"])
            bst = src.refit(X[half:], y[half:], decay_rate=0.5)
        else:
            p = dict(COMMON, num_leaves=31, device_type=dev,
                     tpu_persist_scan="false" if path.endswith("v1")
                     else "force")
            bst = lgb.Booster(p, lgb.Dataset(X, y, params=p))
            bst.update()
            if path == "rollback persist":
                bst.update()
                bst.rollback_one_iter()
            else:
                bst.reset_parameter(dict(API_PARITY_RESET))
            bst.update()
            if bst._booster.use_persist != path.endswith("persist") \
                    or bst.current_iteration() != 2:
                raise AssertionError("parity %s: wrong grower or "
                                     "iterations on %s" % (path, dev))
            texts[path] = bst.model_to_string()
        out[path] = model_digest(bst)
        log("parity %s: %s in %.1f s" % (path, dev, time.time() - t))
    return out


def phase_parity_api(cuda, cpu):
    """The Booster API paths' model digests (parity_api_side's results)
    equal on cuda and on the CPU."""
    for path in API_PARITY:
        if cuda[path] != cpu[path]:
            raise AssertionError("parity %s: model text differs (sha256 %s "
                                 "on cuda, %s on cpu)"
                                 % (path, cuda[path], cpu[path]))
        log("parity %s: model text (sha256 %s) equal on cuda and cpu"
            % (path, cuda[path][:16]))


def parity_data(args):
    """The parity phase's data, from seeds: (data by PARITY name, the
    early-stopping data)."""
    from lightgbm_torch.data.synth import make_airline_like, make_expo_like
    Xp, yp, lat = higgs_latent(args.parity_rows, seed=11)
    counts = np.random.default_rng(17).poisson(np.exp(lat / 2))
    y_l2 = l2_target(lat, seed=19)
    wp = np.random.default_rng(23).uniform(0.5, 2.0, len(yp))
    y01 = 1.0 / (1.0 + np.exp(-lat.astype(np.float64)))
    data = {"higgs": (Xp, yp), "higgs-3": (Xp, quantile_classes(lat, 3)),
            "higgs-counts": (Xp, counts.astype(np.float64)),
            "expo": make_expo_like(args.expo_parity_rows, seed=11),
            "higgs-l2": (Xp, y_l2), "higgs-l2-w": (Xp, y_l2, wp),
            "higgs-mape": (Xp, 3.0 * y_l2),
            "higgs-abs": (Xp, np.abs(y_l2)),
            "higgs-01": (Xp, y01), "higgs-01-w": (Xp, y01, wp)}
    Xr, yr, _ = ltr_data(args.rank_parity_rows, 7)
    gr = rank_sizes(len(yr), 8, longest=400)
    wr = np.random.default_rng(9).uniform(0.5, 2.0, len(yr))
    data["ltr-w"] = (Xr, yr, wr, gr)
    data["airline"] = make_airline_like(args.cat_parity_rows, seed=5)
    data["higgs-bag"] = (Xp[:args.bag_parity_rows],
                         yp[:args.bag_parity_rows])
    log("data: make_ltr_like(%d, seed=7) in %d queries of 1 to %d rows"
        % (args.rank_parity_rows, len(gr), gr.max()))
    return data, es_data(args.es_rows)


def parity_sides(lgb, args, dev):
    """The parity phase's training on `dev`: ((parity_side's,
    parity_es_side's and parity_api_side's results), the rows of each
    data name)."""
    data, es = parity_data(args)
    t = time.time()
    out = (parity_side(lgb, data, dev, args.parity_iters,
                       args.mc_parity_iters, args.deep_parity_iters),
           parity_es_side(lgb, es, dev, args.es_rounds),
           parity_api_side(lgb, *data["higgs"], dev))
    log("parity: every path trained on %s in %.1f s" % (dev, time.time() - t))
    return out, {name: len(v[1]) for name, v in data.items()}


# the CPU sides of the parity phase run in a process of their own, started
# with the script, while the card's phases run; its results and its log
# land here (under the checkout's .cache/, which git ignores)
PARITY_CPU_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              ".cache", "chip_smoke")


def start_parity_cpu():
    """Start the parity phase's CPU sides in a child process: this script
    with --parity-cpu-worker and the same sizes, no card visible to it."""
    os.makedirs(PARITY_CPU_DIR, exist_ok=True)
    out = os.path.join(PARITY_CPU_DIR, "parity_cpu.pkl")
    if os.path.exists(out):
        os.remove(out)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    with open(os.path.join(PARITY_CPU_DIR, "parity_cpu.log"), "w") as log_f:
        return subprocess.Popen(
            [sys.executable, os.path.abspath(__file__),
             "--parity-cpu-worker"] + sys.argv[1:],
            stdout=log_f, stderr=subprocess.STDOUT, env=env)


def parity_cpu_worker(args) -> int:
    """The child's work: every parity path's CPU side, pickled for the
    parent. Its torch leaves two cores to the parent's host loops."""
    import pickle
    import torch
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_torch as lgb
    torch.set_num_threads(max(1, (os.cpu_count() or 4) - 2))
    res = parity_sides(lgb, args, "cpu")
    os.makedirs(PARITY_CPU_DIR, exist_ok=True)
    tmp = os.path.join(PARITY_CPU_DIR, "parity_cpu.pkl.tmp")
    with open(tmp, "wb") as f:
        pickle.dump(res, f)
    os.replace(tmp, os.path.join(PARITY_CPU_DIR, "parity_cpu.pkl"))
    return 0


def collect_parity_cpu(child):
    """Wait for the child, echo its log, return its results."""
    import pickle
    t = time.time()
    rc = child.wait()
    with open(os.path.join(PARITY_CPU_DIR, "parity_cpu.log")) as f:
        for line in f:
            print("cpu worker | " + line.rstrip("\n"), flush=True)
    if rc != 0:
        raise AssertionError("the parity phase's CPU worker exited with %d"
                             % rc)
    with open(os.path.join(PARITY_CPU_DIR, "parity_cpu.pkl"), "rb") as f:
        res = pickle.load(f)
    log("parity: waited %.1f s for the CPU sides" % (time.time() - t))
    return res


# ---- learning to rank (MSLR-WEB30K's shape) --------------------------------

# rows of the variable-length query set of the ranking kernel checks
LONG_ROWS = 50_000
# queries of the MSLR shape held against the plain versions on the CPU
CPU_QUERIES = 4000
# f64 operations of one pair of unequal labels in lambdarank_grad's pair
# loop (csrc/rank_grad.cu:pair_terms and the two sums; exp and each
# division counted as one)
PAIR_OPS = 22


def np_ndcg(label, qb, ks):
    """fn(score) -> [NDCG@k for k in ks] in numpy (the JAX package's
    metrics/rank.py:NDCGMetric, unweighted, default label gains, an
    all-negative query counting 1): each query's rows by descending score,
    ties in row order (one stable lexsort), DCG over the first k, over the
    max DCG of its descending labels (computed once)."""
    from lightgbm_torch.metrics.dcg import _DISCOUNT_CACHE
    gain_of = np.power(2.0, np.arange(32)) - 1.0
    counts = np.diff(qb)
    Q = len(counts)
    qid = np.repeat(np.arange(Q), counts)
    rank = np.arange(len(label)) - np.repeat(qb[:-1], counts)
    lab = label.astype(np.int64)
    by_label = np.lexsort((-lab, qid))
    disc = {k: np.where(rank < k, _DISCOUNT_CACHE[np.minimum(rank, 65535)],
                        0.0) for k in ks}
    best = {k: np.bincount(qid, weights=gain_of[lab[by_label]] * disc[k],
                           minlength=Q) for k in ks}

    def fn(score):
        by_score = np.lexsort((-score + 0.0, qid))
        out = []
        for k in ks:
            dcg = np.bincount(qid, weights=gain_of[lab[by_score]] * disc[k],
                              minlength=Q)
            per = np.where(best[k] > 0.0,
                           dcg / np.where(best[k] > 0.0, best[k], 1.0), 1.0)
            out.append(float(np.sum(per)) / Q)
        return out
    return fn


def rank_sizes(n, seed, longest=1250):
    """Seeded query sizes adding up to n: a few one-document queries, then
    sizes from 1 to 200, every 40th from longest - 225 to `longest` (at the
    default, past the ranking kernel's 1024 rows of shared memory)."""
    rng = np.random.default_rng(seed)
    sizes = [1, 1, 2]
    total = 4
    while total < n:
        s = (int(rng.integers(max(1, longest - 225), longest + 1))
             if len(sizes) % 40 == 0 else int(rng.integers(1, 201)))
        sizes.append(min(s, n - total))
        total += sizes[-1]
    return np.asarray(sizes, dtype=np.int64)


def rank_objective(lgb, name, y, group, extra=None):
    """The port's ranking objective `name` initialised on labels `y` and
    query sizes `group` (its main-path inputs)."""
    from types import SimpleNamespace
    from lightgbm_torch.objectives import create_objective
    cfg = lgb.Config(dict(LTR, objective=name, **(extra or {})))
    qb = np.concatenate([[0], np.cumsum(group)]).astype(np.int32)
    md = SimpleNamespace(label=y.astype(np.float32), weight=None,
                         query_boundaries=qb, num_queries=len(group))
    obj = create_objective(cfg.objective, cfg)
    obj.init(md, len(y))
    return obj, qb


def check_near_cpu(name, k, c):
    """The kernel against its plain version on the CPU: equal, except where
    the card's f64 exp or log2 rounds its last bit unlike the host's, which
    moves an f32 result by at most one ulp; at most 1 value in 10^5 may
    differ so. Returns (the count of unequal values, the max abs diff)."""
    a, b = k.cpu().numpy(), c.cpu().numpy()
    ne = a != b
    if not ne.any():
        return 0, 0.0
    gap = np.abs(a[ne] - b[ne])
    worst = float((gap / np.spacing(np.maximum(np.abs(a[ne]),
                                               np.abs(b[ne])))).max())
    if ne.sum() > max(1, k.numel() // 100_000) or worst > 1.0:
        raise AssertionError("%s: %d values differ from the plain version "
                             "on the CPU, up to %.3g f32 ulps"
                             % (name, int(ne.sum()), worst))
    return int(ne.sum()), float(gap.max())


def phase_rank_kernels(lgb, y, group):
    """lambdarank_grad and xendcg_grad against their plain versions: at the
    MSLR shape (`group`: 31,095 queries of 73 rows over make_ltr_like's
    labels) and on LONG_ROWS of the same labels cut into variable-length
    queries up to 1250 rows (rank_sizes; the longest past the kernel's
    shared memory), without and with f32 weights. Two launches equal, equal
    to the plain version on the card bit for bit (the same exp and log2),
    and to the plain version on the CPU over the first CPU_QUERIES queries
    (check_near_cpu). Timed at the
    MSLR shape beside the plain version on the card and the bound (bytes
    read and written once; f64 operations: PAIR_OPS per pair of unequal
    labels and one comparison per (row, row) of a query for the ranks, over
    the card's f64 rate). No single PyTorch call computes either.
    Returns their two kernel records."""
    import torch
    from lightgbm_torch.ops.rank import (QueryPlan, lambdarank_grad,
                                         lambdarank_grad_plain, xendcg_grad,
                                         xendcg_grad_plain)
    dev = torch.device("cuda")
    rng = np.random.default_rng(41)
    n = len(y)
    score = np.round(rng.normal(size=n) * 2.0, 2)
    score[rng.random(n) < 0.05] = 0.0
    score[rng.random(n) < 0.05] = -0.0
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rnd = (rng.integers(0, 32768, n) / 32768.0).astype(np.float64)
    L = min(LONG_ROWS, n)
    sets = {"MSLR": (y, group), "long": (y[:L], rank_sizes(L, 43))}
    recs = {}
    lr_cpu_ne = xe_cpu_ne = 0
    lr_err = xe_err = 0.0
    for label, (yy, gg) in sets.items():
        obj, qb = rank_objective(lgb, "lambdarank", yy, gg)
        m = len(yy)
        on = {d: {"score": torch.as_tensor(score[:m], device=d),
                  "w": torch.as_tensor(w[:m], device=d),
                  "rnd": torch.as_tensor(rnd[:m], device=d)}
              for d in ("cuda", "cpu")}
        counts = np.diff(qb).astype(np.int64)
        # the CPU holds the first CPU_QUERIES queries (queries are
        # independent: their rows' values are the whole run's)
        qc = min(CPU_QUERIES, len(counts))
        mc = int(qb[qc])
        cplan = QueryPlan(qb[:qc + 1], "cpu")
        for weighted in (False, True):
            t = time.time()
            ww = on["cuda"]["w"] if weighted else None
            args = {"card": (on["cuda"]["score"], obj._on("cuda", "_lab"),
                             obj._on("cuda", "_gain"),
                             obj._on("cuda", "inverse_max_dcgs"),
                             obj._on("cuda", "_disc"), ww, obj.plan("cuda"),
                             obj.sigmoid, obj.norm),
                    "host": (on["cpu"]["score"][:mc],
                            obj._on("cpu", "_lab")[:mc],
                            obj._on("cpu", "_gain")[:mc],
                            obj._on("cpu", "inverse_max_dcgs")[:qc],
                            obj._on("cpu", "_disc"),
                            on["cpu"]["w"][:mc] if weighted else None,
                            cplan, obj.sigmoid, obj.norm)}
            k1 = lambdarank_grad(*args["card"])
            k2 = lambdarank_grad(*args["card"])
            pg = torch.empty(m, dtype=torch.float32, device=dev)
            ph = torch.empty_like(pg)
            lambdarank_grad_plain(*args["card"], pg, ph)
            torch.cuda.synchronize()
            what = "lambdarank_grad %s %s" % (label, "weighted" if weighted
                                             else "unweighted")
            _same(what + ": two launches", k1, k2)
            _same(what + " vs the plain version on the card", k1, (pg, ph))
            c = lambdarank_grad(*args["host"])
            near = [check_near_cpu(what + " " + x, k1[i][:mc], c[i])
                    for i, x in enumerate(("grad", "hess"))]
            ne = sum(x[0] for x in near)
            lr_cpu_ne += ne
            lr_err = max([lr_err] + [x[1] for x in near])
            if not all(bool(torch.isfinite(t_).all()) for t_ in k1):
                raise AssertionError(what + ": a non-finite gradient")
            log("%s: %d queries (longest %d) over %d rows: two launches "
                "bit-identical, bit-identical to the plain version on the "
                "card; on the CPU (the first %d queries) %d of %d values "
                "one f32 ulp off (%.1f s with the plain versions)"
                % (what, len(counts), counts.max(), m, qc, ne, 2 * mc,
                   time.time() - t))
            if label == "MSLR" or weighted:
                ms = device_ms(lambda: lambdarank_grad(*args["card"]))
                recs[("lambdarank_grad", label, weighted)] = ms
            if label == "MSLR" and not weighted:
                plain_ms = device_ms(lambda: lambdarank_grad_plain(
                    *args["card"], pg, ph), reps=3, warmup=1)
                labs = obj._lab.astype(np.int64)
                qid = np.repeat(np.arange(len(counts)), counts)
                per = np.bincount(qid * 32 + labs,
                                  minlength=len(counts) * 32) \
                    .reshape(-1, 32).astype(np.float64)
                pairs = float(((counts.astype(np.float64) ** 2
                                - (per ** 2).sum(1)) / 2).sum())
                cmps = float((counts.astype(np.float64) ** 2).sum())
                nbytes = m * (8 + 4 + 8 + 8) + len(counts) * (8 + 4) \
                    + 8 * counts.max()
                lr_bound = bound_ms(nbytes, PAIR_OPS * pairs + cmps,
                                    f64=True)
                lr_plain, lr_pairs = plain_ms, pairs
                log("lambdarank_grad MSLR: %d pairs of unequal labels (of "
                    "%d), %d rank comparisons; median time per call: "
                    "kernel %.4f ms, plain %.3f ms (on the card), no single "
                    "PyTorch call computes it; bound %.4f ms (%s)"
                    % (pairs, float((counts * (counts - 1) // 2).sum()),
                       cmps, ms, plain_ms, lr_bound[0], lr_bound[1]))
            # xendcg_grad on the same queries and draws
            xa = {"card": (on["cuda"]["score"], obj._on("cuda", "label"),
                           on["cuda"]["rnd"], ww, obj.plan("cuda")),
                  "host": (on["cpu"]["score"][:mc],
                          obj._on("cpu", "label")[:mc],
                          on["cpu"]["rnd"][:mc],
                          on["cpu"]["w"][:mc] if weighted else None, cplan)}
            x1 = xendcg_grad(*xa["card"])
            x2 = xendcg_grad(*xa["card"])
            xg = torch.empty(m, dtype=torch.float32, device=dev)
            xh = torch.empty_like(xg)
            xendcg_grad_plain(*xa["card"], xg, xh)
            torch.cuda.synchronize()
            what = "xendcg_grad %s %s" % (label, "weighted" if weighted
                                         else "unweighted")
            _same(what + ": two launches", x1, x2)
            _same(what + " vs the plain version on the card", x1, (xg, xh))
            c = xendcg_grad(*xa["host"])
            near = [check_near_cpu(what + " " + x, x1[i][:mc], c[i])
                    for i, x in enumerate(("grad", "hess"))]
            ne = sum(x[0] for x in near)
            xe_cpu_ne += ne
            xe_err = max([xe_err] + [x[1] for x in near])
            log("%s: two launches bit-identical, bit-identical to the plain "
                "version on the card; on the CPU (the first %d queries) %d of "
                "%d values one f32 ulp off" % (what, qc, ne, 2 * mc))
            if label == "MSLR" and not weighted:
                xe_ms = device_ms(lambda: xendcg_grad(*xa["card"]))
                xe_plain = device_ms(lambda: xendcg_grad_plain(
                    *xa["card"], xg, xh), reps=3, warmup=1)
                xe_bound = bound_ms(m * (8 + 4 + 8 + 8) + len(counts) * 4,
                                    30.0 * m, f64=True)
                log("xendcg_grad MSLR: median time per call: kernel %.4f "
                    "ms, plain %.3f ms (on the card), no single PyTorch call "
                    "computes it; bound %.4f ms (%s)"
                    % (xe_ms, xe_plain, xe_bound[0], xe_bound[1]))
        del on, args, xa, k1, k2, x1, x2, pg, ph, xg, xh, c
        torch.cuda.empty_cache()
    lr = {"name": "lambdarank_grad", "route": "cuda",
          "source": "lightgbm_torch/csrc/rank_grad.cu",
          "replaces": "lightgbm_tpu/objectives/rank.py:120 (one_query, "
                      "jnp; no Pallas kernel)",
          "launches": 0, "max_abs_err": lr_err,
          "ms": recs[("lambdarank_grad", "MSLR", False)],
          "plain_ms": lr_plain, "bound_ms": lr_bound[0],
          "bound_by": lr_bound[1], "library_ms": None,
          "weighted_ms": recs[("lambdarank_grad", "MSLR", True)],
          "long_weighted_ms": recs[("lambdarank_grad", "long", True)],
          "pairs": lr_pairs, "cpu_unequal": lr_cpu_ne}
    xe = {"name": "xendcg_grad", "route": "cuda",
          "source": "lightgbm_torch/csrc/rank_grad.cu",
          "replaces": "lightgbm_tpu/objectives/rank.py:383 (grad_fn, jnp; "
                      "no Pallas kernel)",
          "launches": 0, "max_abs_err": xe_err, "ms": xe_ms,
          "plain_ms": xe_plain, "bound_ms": xe_bound[0],
          "bound_by": xe_bound[1], "library_ms": None,
          "cpu_unequal": xe_cpu_ne}
    return [lr, xe]


def phase_mslr_kernels(inner, meta, gc, params):
    """The payload kernels at G = 137 (the MSLR shape): root_hist over 1M
    lanes, seg_hist and split_pass on a 500k-lane segment from an unaligned
    lane, each against its plain version on the CPU bit for bit and two
    launches equal (root_hist and seg_hist also against the ownership
    witness), timed; then scan_pair over the 137 features (check_scan_pair).
    Returns {kernel name: its MSLR numbers}."""
    import torch
    from lightgbm_torch.ops import payload_kernels as pk
    from lightgbm_torch.ops.payload import build_assets
    dev = torch.device("cuda")
    t = time.time()
    assets = build_assets(inner, inner.metadata.label)
    WPA, NP, G, plan, nbw, n = assets.geometry[:6]
    rng = np.random.default_rng(5)
    host = assets.pay0.view(np.int32)
    host[nbw + 2, :n] = rng.normal(size=n).astype(np.float32).view(np.int32)
    host[nbw + 3, :n] = rng.uniform(0.05, 0.25, n).astype(np.float32) \
        .view(np.int32)
    cpu = torch.from_numpy(host)
    pay = cpu.to(dev)
    plan_c, plan_d = pk.plan_tensor(plan, "cpu"), pk.plan_tensor(plan, dev)
    wp_live = nbw + 5
    log("payload MSLR: [%d, %d] int32, %d groups in %d bin words, built "
        "and uploaded in %.1f s" % (WPA, NP, G, nbw, time.time() - t))
    out = {}
    # root_hist over the first 1M lanes (its CPU plain version takes
    # seconds a million lanes at 137 groups), the others over 500k
    _, ms, lib_ms, b_ms, _ = check_root_hist(pay, cpu, plan, nbw,
                                             min(n, 1_000_000), "MSLR")
    out["root_hist"] = {"mslr_ms": ms, "mslr_bound_ms": b_ms,
                        "mslr_library_ms": lib_ms}
    R = min(500_000, n - 777)
    args = (nbw, 777, R)
    k1 = pk.seg_hist(pay, plan_d, *args)
    _same("seg_hist MSLR: two launches", k1, pk.seg_hist(pay, plan_d, *args))
    _same("seg_hist MSLR vs the ownership routine", k1,
          ownership_hist(pay, plan_d, *args))
    _same("seg_hist MSLR vs the plain version on the CPU", k1,
          pk.seg_hist_plain(cpu, plan_c, *args))
    ms = device_ms(seg_hist_dev(pay, plan_d, nbw, 777, R, n))
    b_ms = bound_ms(R * (4 * nbw + 8) + 2 * G * 256 * 4, 2.0 * R * G)[0]
    lib_ms = library_hist_segments(pay, plan, nbw, [(777, R)])
    log("seg_hist MSLR, %d lanes x %d groups from lane 777: two launches "
        "bit-identical, equal to the ownership routine and to the plain "
        "version on the CPU; kernel %.4f ms (device form), index_add_ %.4f "
        "ms; bound %.4f ms" % (R, G, ms, lib_ms, b_ms))
    out["seg_hist"] = {"mslr_ms": ms, "mslr_bound_ms": b_ms,
                       "mslr_library_ms": lib_ms}
    del k1
    scal = split_scalars(assets, inner, 0, 777, R, 1, 1)
    end = 777 + R + 1024
    second0 = sentinel((wp_live, NP), dev, 11)
    d1, d2 = second0.clone(), second0.clone()
    n1, _ = pk.split_pass(pay, d1, scal, plan_d, nbw, wp_live, False)
    n2, _ = pk.split_pass(pay, d2, scal, plan_d, nbw, wp_live, False)
    torch.cuda.synchronize()
    if n1 != n2:
        raise AssertionError("split_pass MSLR: n_left %d and %d" % (n1, n2))
    _same("split_pass MSLR: two launches", d1, d2)
    _same("split_pass MSLR: the source", pay, cpu)
    same_outside("split_pass MSLR", d1, second0, [(777, R)], wp_live)
    dst_c = second0[:, :end].cpu().contiguous()
    p_left, _ = pk.split_pass(cpu[:, :end].clone(), dst_c, scal, plan_c, nbw,
                              wp_live, False)
    if p_left != n1:
        raise AssertionError("split_pass MSLR: n_left %d on the card, %d in "
                             "the plain version" % (n1, p_left))
    _same("split_pass MSLR vs the plain version on the CPU", d1[:, :end],
          dst_c)
    scal_d = torch.tensor(scal, dtype=torch.int32, device=dev)
    res = torch.empty(3, dtype=torch.int64, device=dev)
    work = pk.split_scratch(pay)
    ms = device_ms(lambda: pk._launch_split(pay, d1, scal_d, res, wp_live,
                                            work))
    b_ms = bound_ms(2.0 * wp_live * R * 4, float(R))[0]
    log("split_pass MSLR, %d lanes at wp_live %d (n_left %d): two launches "
        "bit-identical, bit-identical to the plain version on the CPU, the "
        "source and everything outside the segment untouched; kernel %.4f "
        "ms (device form); bound %.4f ms" % (R, wp_live, n1, ms, b_ms))
    out["split_pass"] = {"mslr_ms": ms, "mslr_bound_ms": b_ms}
    del pay, cpu, host, assets, second0, d1, d2, dst_c, work
    torch.cuda.empty_cache()
    # scan_pair over the 137 features' windows, on children of 300k rows
    R = min(300_000, n)
    bins = torch.as_tensor(np.ascontiguousarray(inner.binned[:R]),
                           device=dev)
    grad = torch.as_tensor(rng.normal(size=R).astype(np.float32), device=dev)
    hess = torch.as_tensor(rng.uniform(0.05, 0.25, R).astype(np.float32),
                           device=dev)
    rec = check_scan_pair(bins, grad, hess, R, meta, gc, params)
    out["scan_pair"] = {"mslr_ms": rec["ms"], "mslr_bound_ms": rec["bound_ms"]}
    return out


def lcg_replay(qb, seed, iters):
    """The reference's per-query LCG (include/LightGBM/utils/random.h:101-
    110; query q seeded with seed + q) replayed sequentially, position by
    position over all queries at once: [iters, n] NextFloat() draws."""
    counts = np.diff(qb).astype(np.int64)
    x = (np.uint64(seed) + np.arange(len(counts), dtype=np.uint64)) \
        & np.uint64(0xFFFFFFFF)
    out = np.zeros((iters, int(qb[-1])))
    for it in range(iters):
        for j in range(int(counts.max())):
            live = counts > j
            x[live] = (np.uint64(214013) * x[live] + np.uint64(2531011)) \
                & np.uint64(0xFFFFFFFF)
            v = ((x[live] >> np.uint64(16)) & np.uint64(0x7FFF)) \
                .astype(np.float32) / np.float32(32768.0)
            out[it, qb[:-1][live] + j] = v
    return out


def check_xendcg_draws(bst, draws, iters):
    """The rank_xendcg path's draws: one get_gradients call per iteration,
    each iteration's draws bit-equal to a sequential replay of the LCG."""
    obj = bst._booster.objective
    if len(draws) != iters:
        raise AssertionError("train xendcg: %d draws for %d iterations"
                             % (len(draws), iters))
    want = lcg_replay(obj.query_boundaries, obj.seed, iters)
    for i, d in enumerate(draws):
        if not np.array_equal(d, want[i]):
            raise AssertionError("train xendcg: iteration %d's draws differ "
                                 "from the LCG replay" % (i + 1))
    log("train xendcg: %d iterations drew %d x %d uniforms, one "
        "get_gradients call each, bit-equal to a sequential numpy replay of "
        "the reference's per-query LCG (seed %d)"
        % (iters, iters, want.shape[1], obj.seed))


def ltr_data(n, seed, noise=0.0):
    """make_ltr_like(n) rows (137 features, labels 0-4) and its 73-row
    queries; with `noise`, that share of the labels redrawn."""
    from lightgbm_torch.data.synth import make_ltr_like
    X, y, g = make_ltr_like(n, seed=seed)
    if noise:
        rng = np.random.default_rng(seed + 100)
        flip = rng.random(len(y)) < noise
        y[flip] = rng.integers(0, 5, int(flip.sum()))
    return X, y, g


def ltr_split(n, n_valid, seed, noise=0.0):
    """(X, y, group, Xv, yv, group_v): make_ltr_like(n + n_valid) cut after
    its first n // 73 queries. make_ltr_like draws its relevance weights
    from its seed, so a held-out set is cut from the same draw, not drawn
    with another seed (that would be another ranking task)."""
    X, y, g = ltr_data(n + n_valid, seed, noise)
    q = n // 73
    m = int(g[:q].sum())
    return X[:m], y[:m], g[:q], X[m:], y[m:], g[q:]


def held_out_higgs(n):
    """A held-out HIGGS set: make_higgs_like(n, seed=17) with 5% of its
    values NaN (rows the training set never showed)."""
    from lightgbm_torch.data.synth import make_higgs_like
    Xv, yv = make_higgs_like(n, seed=17)
    Xv[np.random.default_rng(18).random(Xv.shape) < 0.05] = np.nan
    return Xv, yv


def es_data(n):
    """The early-stopping parity data: HIGGS rows and a held-out quarter,
    binary labels with 30% flipped and 3 latent classes with 30% redrawn,
    so that the held-out loss turns within a few rounds; make_ltr_like
    rows and a held-out quarter with half their labels redrawn, in
    variable-length queries, half as many rows (the held-out NDCG
    turns)."""
    out = {}
    X, y, _, Xv, yv, _ = ltr_split(n // 2, n // 8, 31, noise=0.5)
    out["rank"] = (X, y, Xv, yv, rank_sizes(len(y), 33, 600),
                   rank_sizes(len(yv), 34, 600))
    for name in ("binary", "multi"):
        parts = []
        for rows, seed in ((n, 21), (n // 4, 22)):
            X, y, lat = higgs_latent(rows, seed=seed)
            rng = np.random.default_rng(seed + 100)
            if name == "binary":
                y = np.where(rng.random(rows) < 0.3, 1.0 - y, y)
            else:
                y = quantile_classes(lat, 3)
                flip = rng.random(rows) < 0.3
                y[flip] = rng.integers(0, 3, int(flip.sum()))
            parts += [X, y]
        out[name] = tuple(parts)
    return out


def make_dataset(lgb, X, y, params, what, group=None):
    t = time.time()
    ds = lgb.Dataset(X, y, group=group, params=params,
                     free_raw_data=False).construct()
    inner = ds._inner
    log("data: %s binned and uploaded in %.1f s: %d features in %d groups "
        "(bundled: %s), %d total bins, widest group %d"
        % (what, time.time() - t, inner.num_features, len(inner.groups),
           inner.has_bundles, inner.total_bins,
           int(inner.group_widths().max())))
    return ds, inner


# ---- prediction and serving (predict/, serving/; bench.py:879-960) ---------

# rows of the numpy walk's check of the served model, and of the other
# paths' coverage checks against the numpy walk
PREDICT_NUMPY_ROWS = 200_000
PREDICT_COVER_ROWS = 100_000
SERVE_MIX_ROWS = 500_000        # the run_serving mix's rows (bench.py:951)


def walk_visits(trees, walk, leaf):
    """Node visits of a leaf-mode result `leaf` ([n, T] int32 on the card):
    the sum over rows and trees of the depth of the leaf reached."""
    import torch
    T = len(trees)
    starts = walk.tree_leaf.cpu().numpy()
    table = np.zeros(int(starts[-1]) + max(t.num_leaves for t in trees),
                     np.int64)
    for s, t in zip(starts, trees):
        d = leaf_depths(t)
        table[s:s + len(d)] = d
    table_d = torch.as_tensor(table, device="cuda")
    idx = walk.tree_leaf.long()[None, :T] + leaf.long()
    return int(table_d[idx].sum())


def walk_bound(n, F, x_bytes, out_bytes, walk, visits, trees_per_row):
    """predict_walk's bound: the rows read once, the output and the
    ensemble's tensors once; two operations (the threshold compare and the
    zero test) per node visit and one add per tree and row, at the rows'
    type's rate."""
    ens_bytes = sum(t.numel() * t.element_size() for t in walk[:5])
    ops = 2.0 * visits + float(n) * trees_per_row
    return bound_ms(n * F * x_bytes + out_bytes + ens_bytes, ops,
                    f64=x_bytes == 8)


def check_predict_cover(bst, X, label, numpy_rows=PREDICT_COVER_ROWS):
    """bst.predict on the card (its default route) over all rows of X: the
    walk kernel, one launch; its raw scores equal to the numpy walk's
    (predict_device=cpu) on the first `numpy_rows` rows, bit for bit, and
    the converted predictions within 1e-12."""
    from lightgbm_torch.ops.predict import predict_walk
    t = time.time()
    n0 = predict_walk.launches
    raw = bst.predict(X, raw_score=True)
    conv = bst.predict(X[:numpy_rows])
    if predict_walk.launches != n0 + 2:
        raise AssertionError("predict %s: %d walk launches for 2 calls"
                             % (label, predict_walk.launches - n0))
    t_card = time.time() - t
    t = time.time()
    want = bst.predict(X[:numpy_rows], raw_score=True, predict_device="cpu")
    gap = float(np.abs(conv - bst.predict(X[:numpy_rows],
                                          predict_device="cpu")).max())
    if not np.array_equal(raw[:numpy_rows], want) or not gap <= 1e-12:
        raise AssertionError("predict %s: the walk kernel differs from the "
                             "numpy walk (raw equal: %s; converted max abs "
                             "diff %.3g)" % (label, np.array_equal(
                                 raw[:numpy_rows], want), gap))
    gb = bst._booster
    log("predict %s: %d trees (%d per iteration%s) over %d rows x %d "
        "features on the card (%.2f s with the conversion); raw equal to "
        "the numpy walk on the first %d (%.1f s), converted within %.3g "
        "(limit 1e-12)" % (label, len(gb.models), gb.num_tree_per_iteration,
                           ", average_output" if gb.average_output else "",
                           X.shape[0], X.shape[1], t_card, numpy_rows,
                           time.time() - t, gap))


def poisson_open_loop(server, X, rps, n_requests, rng, direct):
    """bench.py:poisson_open_loop's open-loop Poisson load (arrivals drawn
    up front at `rps`, served in arrival order on this thread; latency from
    the scheduled arrival, queue depth the arrived requests not yet
    started), every answer held to `direct` (the kernel's output for X)."""
    n = len(X)
    lo, hi = server.min_batch // 2, server.min_batch * 4
    arrivals = np.cumsum(rng.exponential(1.0 / rps, n_requests))
    sizes = rng.integers(max(lo, 1), max(hi, 2), n_requests)
    starts = rng.integers(0, max(n - int(sizes.max()), 1), n_requests)
    lat = np.empty(n_requests)
    qdepth = np.empty(n_requests, np.int64)
    t0 = time.perf_counter()
    for i in range(n_requests):
        now = time.perf_counter() - t0
        if now < arrivals[i]:
            time.sleep(arrivals[i] - now)
            now = arrivals[i]
        qdepth[i] = int(np.searchsorted(arrivals, now, side="right")) - i
        k, i0 = int(sizes[i]), int(starts[i])
        out = server.predict(X[i0:i0 + k], raw_score=True,
                             arrival_t=t0 + float(arrivals[i]))
        lat[i] = (time.perf_counter() - t0) - arrivals[i]
        if not np.array_equal(out, direct[i0:i0 + k]):
            raise AssertionError("serve poisson: request %d differs from "
                                 "the kernel's output" % i)
    st = server.stats()
    return {"requests": n_requests, "rps": float(rps),
            "p50": float(np.percentile(lat, 50)),
            "p99": float(np.percentile(lat, 99)),
            "queue_wait_p99": float(st["queue_wait_p99"]),
            "qdepth_mean": float(qdepth.mean()),
            "qdepth_max": int(qdepth.max())}


def drive_clients(predict_fn, reqs, clients):
    """bench.py:run_serving's drive: `reqs` through `predict_fn` from a
    pool of `clients` threads; (seconds, latencies, outputs)."""
    from concurrent.futures import ThreadPoolExecutor
    lat = np.empty(len(reqs))
    outs = [None] * len(reqs)

    def one(i):
        t = time.perf_counter()
        outs[i] = predict_fn(reqs[i][2])
        lat[i] = time.perf_counter() - t

    t0 = time.time()
    with ThreadPoolExecutor(clients) as pool:
        list(pool.map(one, range(len(reqs))))
    return time.time() - t0, lat, outs


def phase_predict(lgb, X, y, card, rows, iters):
    """The served model (bench.py:run_predict:879-896: HIGGS rows, binary,
    255 leaves, `iters` trees, default routing) trained on the first
    `rows` rows; predict_walk against its plain version on the card over
    all of them, bit for bit, in raw f64, raw f32 and leaf modes, each
    timed beside its bound (and the node visits per second); raw f64 and
    the leaves equal to the numpy walk on the first PREDICT_NUMPY_ROWS.
    Returns (its kernel record, the booster, its rows, its raw scores on
    the card)."""
    import torch
    from lightgbm_torch.ops.predict import predict_walk, predict_walk_plain
    from lightgbm_torch.predict import CudaPredictor
    n = min(rows, len(y))
    Xp = np.ascontiguousarray(X[:n], np.float64)
    params = dict(COMMON, num_leaves=255)
    t = time.time()
    ds = lgb.Dataset(Xp, y[:n], params=params)
    bst = lgb.train(params, ds, iters)
    torch.cuda.synchronize()
    gb = bst._booster
    trees = gb.models
    if not gb.use_persist or len(trees) != iters:
        raise AssertionError("predict: the served model took the wrong "
                             "grower or stopped early (%d trees)"
                             % len(trees))
    log("predict: the served model: %d rows, %d trees of %d-%d leaves "
        "(depth up to %d), trained in %.1f s (binning included)"
        % (n, len(trees), min(t_.num_leaves for t_ in trees),
           max(t_.num_leaves for t_ in trees),
           max(int(leaf_depths(t_).max()) for t_ in trees),
           time.time() - t))
    del ds
    t = time.time()
    pr = gb.device_predictor()
    pr32 = CudaPredictor(pr.ensemble, dtype="f32", device=pr.device)
    log("predict: compiled ensemble (%d depth buckets, %d node slots) on "
        "the card in %.2f s" % (len(pr.ensemble.buckets),
                                pr.walk.records.shape[0], time.time() - t))
    X64 = torch.as_tensor(Xp, device="cuda")
    X32 = X64.float()
    T = len(trees)
    modes = (("f64", X64, pr.walk, False), ("f32", X32, pr32.walk, False),
             ("leaf", X64, pr.walk, True))
    outs, times = {}, {}
    for mode, Xd, walk, leaf in modes:
        a = predict_walk(Xd, walk, 1, leaf=leaf)
        b = predict_walk(Xd, walk, 1, leaf=leaf)
        plain = predict_walk_plain(Xd, walk, 1, leaf=leaf)
        torch.cuda.synchronize()
        if not (torch.equal(a, b) and torch.equal(a, plain)):
            raise AssertionError(
                "predict_walk %s: two launches equal %s, equal to the plain "
                "version %s" % (mode, torch.equal(a, b),
                                torch.equal(a, plain)))
        del b, plain
        ms = device_ms(lambda: predict_walk(Xd, walk, 1, leaf=leaf), reps=10)
        plain_ms = device_ms(lambda: predict_walk_plain(Xd, walk, 1,
                                                        leaf=leaf),
                             reps=1, warmup=0)
        outs[mode], times[mode] = a, (ms, plain_ms)
    visits = walk_visits(trees, pr.walk, outs["leaf"])
    bounds = {"f64": walk_bound(n, 28, 8, n * 8, pr.walk, visits, T),
              "f32": walk_bound(n, 28, 4, n * 4, pr32.walk, visits, T),
              "leaf": walk_bound(n, 28, 8, n * T * 4, pr.walk, visits, 0)}
    for mode in ("f64", "f32", "leaf"):
        ms, plain_ms = times[mode]
        log("predict_walk %s: %d rows x %d trees, two launches and the "
            "plain version on the card bit-identical; %.4f ms (plain "
            "%.3f ms), bound %.4f ms (%s), %.3g node visits/s (%d visits, "
            "%.2f per row and tree) (%s)"
            % (mode, n, T, ms, plain_ms, bounds[mode][0], bounds[mode][1],
               visits / (ms / 1e3), visits, visits / (n * T), card))
    # the f32 mode against f64: a row whose f32 value lies between a
    # threshold and its f32 rounding takes the other branch (the JAX
    # package's f32 mode does the same); a row that reaches the same leaves
    # differs by its T f32 adds, each off by at most half an ulp of the
    # largest score, and the rounded leaf values
    raw64 = outs["f64"][:, 0]
    leaf32 = predict_walk(X32, pr32.walk, 1, leaf=True)
    same = (leaf32 == outs["leaf"]).all(dim=1)
    flips = n - int(same.sum())
    diff32 = (outs["f32"][:, 0].double() - raw64).abs()
    gap32 = float(diff32.max())
    gap_same = float(diff32[same].max()) if flips < n else 0.0
    lim32 = 2 * (T + 1) * 2.0 ** -24 * float(raw64.abs().max())
    log("predict_walk f32: %d of %d rows (%.4f%%) reach another leaf in some "
        "tree (a value between a threshold and its f32 rounding); the rest "
        "within %.3g of f64 (limit %.3g: 2 (T + 1) f32 half-ulps of the "
        "largest score); max abs diff over all rows %.3g"
        % (flips, n, 100.0 * flips / n, gap_same, lim32, gap32))
    if not gap_same <= lim32 or flips > n // 100:
        raise AssertionError("predict_walk f32 drifts from f64")
    del leaf32, same, diff32
    m = min(PREDICT_NUMPY_ROWS, n)
    t = time.time()
    np_raw = gb.predict_raw(Xp[:m])
    np_leaf = gb.predict_leaf_index(Xp[:m], device="cpu")
    if not (np.array_equal(raw64[:m].cpu().numpy(), np_raw)
            and np.array_equal(outs["leaf"][:m].cpu().numpy(), np_leaf)):
        raise AssertionError("predict_walk differs from the numpy walk")
    log("predict_walk: raw f64 scores and leaf indices equal to the numpy "
        "walk's on the first %d rows, bit for bit (numpy %.1f s)"
        % (m, time.time() - t))
    ms, plain_ms = times["f64"]
    rec = {"name": "predict_walk", "route": "cuda",
           "source": "lightgbm_torch/csrc/predict.cu",
           "replaces": "lightgbm_tpu/predict/runtime.py:85 (no TPU kernel: "
                       "the XLA _traverse_bucket, with its lax.scan sum, "
                       ":197)",
           "launches": 0, "max_abs_err": 0.0, "ms": ms,
           "plain_ms": plain_ms, "bound_ms": bounds["f64"][0],
           "bound_by": bounds["f64"][1], "library_ms": None,
           "rows": n, "trees": T, "node_visits": visits,
           "node_visits_per_s": visits / (ms / 1e3), "f32_max_diff": gap32,
           "f32_leaf_flip_rows": flips, "f32_same_leaf_max_diff": gap_same}
    for mode in ("f32", "leaf"):
        rec.update({mode + "_ms": times[mode][0],
                    mode + "_plain_ms": times[mode][1],
                    mode + "_bound_ms": bounds[mode][0],
                    mode + "_bound_by": bounds[mode][1]})
    direct = raw64.cpu().numpy()
    del outs, X64, X32, pr32
    torch.cuda.empty_cache()
    return rec, bst, Xp, direct


def phase_serve(bst, Xp, direct, card, serve_rows):
    """The serving paths on the served model, predict_walk's launch count
    set to 0 just before and read just after: BatchServer(256, 65536) over
    `serve_rows` rows of ragged batches (bench.py:_predict_one_shape:790),
    BatchServer(256, 4096) under open-loop Poisson traffic (400 requests at
    50 rps, bench.py:poisson_open_loop:831), the run_serving mix (400
    requests of 1-64 rows from 8 client threads, max_wait_ms 5, bench.py:
    924) through the sync server and AsyncBatchServer, then a
    ModelRegistry swapped between the model and its first 50 iterations
    under that load, and a swap and rollback. Every served row equals the
    kernel's direct output bit for bit (raw scores). Returns the record's
    serving fields."""
    import threading
    import torch
    from lightgbm_torch.ops.predict import predict_walk
    from lightgbm_torch.predict import BatchServer
    from lightgbm_torch.serving import AsyncBatchServer, ModelRegistry
    pr = bst._booster.device_predictor()
    n = len(Xp)
    text_b = bst.model_to_string(num_iteration=50)
    reg = ModelRegistry()
    reg.load("a", booster=bst)
    reg.load("b", model_str=text_b)
    nm = min(SERVE_MIX_ROWS, n)
    ref_b = reg.resolve("b").predict(Xp[:nm], raw_score=True)
    torch.cuda.synchronize()
    out = {}
    predict_walk.launches = 0
    # throughput: ragged batches over the ladder
    server = BatchServer(pr, min_batch=256, max_batch=1 << 16)
    b = server.min_batch
    while b <= server.max_batch:
        server.predict(Xp[:min(b, n)], raw_score=True)
        b <<= 1
    rng = np.random.default_rng(0)
    served, t0 = 0, time.time()
    while served < serve_rows:
        k = int(rng.integers(server.min_batch // 2, server.max_batch))
        i0 = int(rng.integers(0, max(n - k, 1)))
        k = min(k, n - i0)
        if not np.array_equal(server.predict(Xp[i0:i0 + k], raw_score=True),
                              direct[i0:i0 + k]):
            raise AssertionError("serve ragged: a batch differs from the "
                                 "kernel's output")
        served += k
    wall = time.time() - t0
    st = server.stats()
    sync_launches = st["requests"]
    out.update(serve_rows=served, serve_s=wall,
               serve_rows_per_s=served / wall, serve_buckets=st["compiles"],
               serve_bucket_bound=server.max_compiles())
    log("serve ragged: %d rows in %d batches of %d-%d rows, %.3f s: %.4g "
        "rows/s (%s); staging buckets used %d of max_compiles() %d (no "
        "padding rows walked); every row equal to the kernel's output" % (
            served, st["requests"] - len(st["buckets_compiled"]),
            server.min_batch // 2, server.max_batch, wall, served / wall,
            card, st["compiles"], server.max_compiles()))
    if st["compiles"] > server.max_compiles():
        raise AssertionError("serve ragged: more buckets than the ladder")
    # open-loop Poisson traffic on the small ladder
    server = BatchServer(pr, min_batch=256, max_batch=4096)
    b = server.min_batch
    while b <= server.max_batch:
        server.predict(Xp[:b], raw_score=True)
        b <<= 1
    pois = poisson_open_loop(server, Xp, 50.0, 400,
                             np.random.default_rng(7), direct)
    sync_launches += server.stats()["requests"]
    out.update({"poisson_" + k: v for k, v in pois.items()})
    log("serve poisson: %d requests of %d-%d rows at %.0f rps, open loop: "
        "p50 %.3f ms, p99 %.3f ms, queue wait p99 %.3f ms, queue depth mean "
        "%.3f max %d (%s)" % (400, 128, 1023, 50.0, pois["p50"] * 1e3,
                              pois["p99"] * 1e3,
                              pois["queue_wait_p99"] * 1e3,
                              pois["qdepth_mean"], pois["qdepth_max"], card))
    # the run_serving mix: the sync server, then continuous batching
    rng = np.random.default_rng(11)
    sizes = rng.integers(1, 65, 400)
    starts = rng.integers(0, nm - 65, 400)
    reqs = [(int(s), int(k), Xp[int(s):int(s) + int(k)])
            for s, k in zip(starts, sizes)]

    def held(outs, refs, label):
        for (s, k, _), o in zip(reqs, outs):
            if not any(np.array_equal(o, r[s:s + k]) for r in refs):
                raise AssertionError("serve %s: rows [%d:%d] equal no "
                                     "model's kernel output" % (label, s,
                                                                s + k))

    sync = BatchServer(pr, min_batch=256, max_batch=4096)
    b = sync.min_batch
    while b <= sync.max_batch:
        sync.predict(Xp[:b], raw_score=True)
        b <<= 1
    t_sync, lat_sync, outs = drive_clients(
        lambda X_: sync.predict(X_, raw_score=True), reqs, 8)
    held(outs, (direct,), "sync")
    sync_launches += sync.stats()["requests"]
    srv = AsyncBatchServer(pr, min_batch=256, max_batch=4096,
                           max_wait_ms=5.0).start()
    try:
        t_async, lat_async, outs = drive_clients(
            lambda X_: srv.predict(X_, raw_score=True, timeout=60.0), reqs,
            8)
    finally:
        srv.stop(timeout=60.0)
    held(outs, (direct,), "async")
    ast = srv.stats()
    async_launches = ast["batches"]
    out.update(mix_requests=400, mix_clients=8,
               sync_rps=400 / t_sync, async_rps=400 / t_async,
               vs_sync=t_sync / t_async,
               sync_p50=float(np.percentile(lat_sync, 50)),
               sync_p99=float(np.percentile(lat_sync, 99)),
               async_p50=float(np.percentile(lat_async, 50)),
               async_p99=float(np.percentile(lat_async, 99)),
               coalesce_ratio=ast["coalesce_ratio"],
               async_batches=ast["batches"], flushes=ast["flushes"])
    log("serve mix: 400 requests of 1-64 rows from 8 client threads: sync "
        "%.1f rps (p50 %.3f ms, p99 %.3f ms), async %.1f rps (p50 %.3f ms, "
        "p99 %.3f ms), vs_sync %.2f; async %d batches, coalesce_ratio %.2f, "
        "flushes %s (%s)" % (
            out["sync_rps"], out["sync_p50"] * 1e3, out["sync_p99"] * 1e3,
            out["async_rps"], out["async_p50"] * 1e3,
            out["async_p99"] * 1e3, out["vs_sync"], ast["batches"],
            ast["coalesce_ratio"], ast["flushes"], card))
    # hot swap under the same load, then a swap and a rollback
    stop = threading.Event()

    def swapper():
        flip = True
        while not stop.is_set():
            reg.swap("b" if flip else "a")
            flip = not flip
            time.sleep(0.002)

    srv = AsyncBatchServer(reg, min_batch=256, max_batch=4096,
                           max_wait_ms=5.0).start()
    sw = threading.Thread(target=swapper)
    try:
        sw.start()
        _, _, outs = drive_clients(
            lambda X_: srv.predict(X_, raw_score=True, timeout=60.0), reqs,
            8)
        stop.set()
        sw.join(60.0)
        held(outs, (direct, ref_b), "swap")
        reg.swap("a")
        a = reg.resolve()
        reg.swap("b")
        if not np.array_equal(srv.predict(Xp[:5000], raw_score=True,
                                          timeout=60.0), ref_b[:5000]):
            raise AssertionError("serve swap: model b differs")
        reg.rollback()
        if reg.resolve() is not a or not np.array_equal(
                srv.predict(Xp[:5000], raw_score=True, timeout=60.0),
                direct[:5000]):
            raise AssertionError("serve rollback: not the same model")
    finally:
        stop.set()
        sw.join(60.0)
        srv.stop(timeout=60.0)
    rst = srv.stats()
    async_launches += rst["batches"]
    torch.cuda.synchronize()
    launches = predict_walk.launches
    log("serve swap: %d swaps under the mix (every answer equal to one "
        "model's kernel output, %d requests, %d errors), then swap and "
        "rollback bit-exact; predict_walk launches in the serve phase %d "
        "(sync requests %d + async batches %d)" % (
            rst["registry"]["swaps"], rst["requests"], rst["errors"],
            launches, sync_launches, async_launches))
    if launches != sync_launches + async_launches or not launches \
            or rst["errors"]:
        raise AssertionError("serve: %d walk launches, expected %d"
                             % (launches, sync_launches + async_launches))
    out["launches"] = launches
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rows", type=int, default=10_500_000)
    ap.add_argument("--iters", type=int, default=10,
                    help="iterations of the per-split persistent train path")
    ap.add_argument("--v1-iters", type=int, default=3,
                    help="iterations of the v1-grower train path")
    ap.add_argument("--level-iters", type=int, default=10,
                    help="iterations of the level and bundled train paths")
    ap.add_argument("--off-iters", type=int, default=3,
                    help="tpu_level_grow=off iterations held to the level "
                    "paths' first trees")
    ap.add_argument("--mc-iters", type=int, default=3,
                    help="iterations of the HIGGS multiclass path (5 "
                    "classes, 5 trees per iteration)")
    ap.add_argument("--reg-iters", type=int, default=3,
                    help="iterations of the HIGGS regression path")
    ap.add_argument("--l1-iters", type=int, default=3,
                    help="iterations of the HIGGS L1 path (leaf renewal)")
    ap.add_argument("--expo-rows", type=int, default=2_000_000)
    ap.add_argument("--parity-rows", type=int, default=200_000)
    ap.add_argument("--expo-parity-rows", type=int, default=100_000)
    ap.add_argument("--parity-iters", type=int, default=2)
    ap.add_argument("--deep-parity-iters", type=int, default=5,
                    help="iterations of the DEEP_PARITY paths (binary "
                         "persist and v1, softmax, the knobs, fobj)")
    ap.add_argument("--knob-iters", type=int, default=3,
                    help="iterations of the HIGGS knob path (every knob)")
    ap.add_argument("--mc-parity-iters", type=int, default=1,
                    help="iterations of the multiclass parity paths (3 "
                    "classes)")
    ap.add_argument("--valid-rows", type=int, default=500_000,
                    help="held-out HIGGS rows of the HIGGS valid path (it "
                    "trains --iters iterations)")
    ap.add_argument("--expo-valid-rows", type=int, default=200_000,
                    help="held-out Expo rows the valid_walk phase walks")
    ap.add_argument("--es-rows", type=int, default=50_000,
                    help="training rows of the early-stopping parity "
                    "routes (a quarter as many held out)")
    ap.add_argument("--es-rounds", type=int, default=40,
                    help="the most rounds of an early-stopping parity run")
    ap.add_argument("--ltr-rows", type=int, default=2_270_000,
                    help="make_ltr_like rows of the MSLR paths (73-row "
                    "queries, 137 features)")
    ap.add_argument("--ltr-valid-rows", type=int, default=227_000,
                    help="held-out rows of the ltr path (the queries after "
                    "the training rows of one make_ltr_like draw)")
    ap.add_argument("--ltr-iters", type=int, default=10,
                    help="iterations of the ltr path (lambdarank), with and "
                    "without the held-out set")
    ap.add_argument("--xendcg-iters", type=int, default=3,
                    help="iterations of the xendcg path (rank_xendcg, v1)")
    ap.add_argument("--rank-parity-rows", type=int, default=200_000,
                    help="make_ltr_like rows of the ranking parity paths")
    ap.add_argument("--airline-rows", type=int, default=10_000_000,
                    help="make_airline_like rows of the airline paths")
    ap.add_argument("--airline-iters", type=int, default=3,
                    help="iterations of each airline path (sorted and "
                    "one-hot categorical scans, v1)")
    ap.add_argument("--airline-valid-rows", type=int, default=1_000_000,
                    help="held-out airline rows the valid_walk phase walks")
    ap.add_argument("--cat-parity-rows", type=int, default=200_000,
                    help="make_airline_like rows of the categorical parity "
                    "paths")
    ap.add_argument("--bag-iters", type=int, default=6,
                    help="iterations of the bagging and goss paths (a "
                    "bagging_freq=5 window boundary inside)")
    ap.add_argument("--bag-parity-rows", type=int, default=100_000,
                    help="HIGGS rows of the bagging and GOSS parity paths")
    ap.add_argument("--predict-rows", type=int, default=2_000_000,
                    help="HIGGS rows of the served model (the first rows "
                    "of the training matrix) and of the walk's checks")
    ap.add_argument("--predict-iters", type=int, default=100,
                    help="trees of the served model (255 leaves)")
    ap.add_argument("--serve-rows", type=int, default=8_000_000,
                    help="rows served in ragged batches by the sync server")
    ap.add_argument("--skip-train", action="store_true")
    ap.add_argument("--skip-parity", action="store_true")
    ap.add_argument("--profile", action="store_true",
                    help="after each train path, profile one more iteration")
    ap.add_argument("--parity-cpu-worker", action="store_true",
                    help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.parity_cpu_worker:
        return parity_cpu_worker(args)
    # the recorded digests hold at the default sizes
    FULL_SIZE["on"] = all(getattr(args, k) == ap.get_default(k) for k in (
        "rows", "iters", "v1_iters", "level_iters", "mc_iters", "reg_iters",
        "l1_iters", "expo_rows", "bag_iters"))

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this test "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import lightgbm_torch as lgb

    card = phase_card()
    parity_cpu = None if args.skip_parity else start_parity_cpu()
    try:
        return run(args, lgb, torch, card, parity_cpu)
    finally:
        if parity_cpu is not None and parity_cpu.poll() is None:
            parity_cpu.kill()
            parity_cpu.wait()


def run(args, lgb, torch, card, parity_cpu) -> int:
    """Every phase after the card's name (the module docstring), the
    parity phase's CPU sides running meanwhile in `parity_cpu`."""
    from lightgbm_torch.data.synth import make_airline_like, make_expo_like
    from lightgbm_torch.treelearner.serial import feature_meta, grow_config
    from lightgbm_torch.ops.split import SplitParams
    phase_build()

    X, y, latent = higgs_latent(args.rows)
    log("data: make_higgs_like(%d) -> %s, and its latent (the multiclass "
        "and regression targets)" % (args.rows, X.shape))
    params = dict(COMMON, num_leaves=255)
    ds, inner = make_dataset(lgb, X, y, params, "HIGGS")
    cfg = lgb.Config(params)
    meta, gc = feature_meta(inner), grow_config(cfg, inner)
    split_params = SplitParams.from_config(cfg)
    kernels = phase_kernels(inner.binned, meta, gc, split_params)
    phase_scan_edges()
    payload_recs, scan_b256 = phase_payload_kernels(inner, meta, gc,
                                                    split_params)
    kernels[1].update(scan_b256)                    # scan_pair's record
    kernels += payload_recs
    kernels.append(phase_grow_step())
    kernels += phase_bag_kernels(y)
    runs, persist_keep = {}, {}
    Xv, yv = held_out_higgs(args.valid_rows)
    log("data: make_higgs_like(%d, seed=17) held out, %d NaN values"
        % (args.valid_rows, int(np.isnan(Xv).sum())))
    if not args.skip_train:
        runs["persist"] = phase_train(lgb, X, y, ds, args.iters, card,
                                      args.profile, "persist",
                                      keep=persist_keep)
        runs["valid"], tree, vinner = phase_train_valid(
            lgb, ds, Xv, yv, args.iters, card, persist_keep)
    else:
        tree = lgb.train(dict(COMMON, **PATHS["persist"][0]), ds, 1) \
            ._booster.models[0]
        vinner = lgb.Dataset(Xv, yv, reference=ds).construct()._inner
    kernels.append(phase_valid_walk("HIGGS", tree, inner, vinner, 1))
    kernels += phase_dart_rf_kernels(tree, inner)
    # rollback, a split key reset and refit on the persist path's Booster
    api_bst = persist_keep.pop("bst", None) or lgb.train(
        dict(COMMON, **PATHS["persist"][0]), ds, 3)
    runs["api"], rec = phase_api(lgb, api_bst, X, Xv, yv, card)
    kernels.append(rec)
    del Xv, yv, tree, vinner, api_bst
    if not args.skip_train:
        runs["v1"] = phase_train(lgb, X, y, ds, args.v1_iters, card,
                                 args.profile, "v1")
        runs["level"] = phase_train(lgb, X, y, ds, args.level_iters, card,
                                    args.profile, "level", args.off_iters)
        # the monotone constraints are the Dataset's (set when it is built,
        # as in the JAX package), so the knob path bins its own
        ds_knobs, _ = make_dataset(lgb, X, y,
                                   dict(COMMON, **PATHS["knobs"][0]),
                                   "HIGGS with the knob parameters")
        knob_keep = {}
        runs["knobs"] = phase_train(lgb, X, y, ds_knobs, args.knob_iters,
                                    card, args.profile, "knobs",
                                    keep=knob_keep)
        del ds_knobs
        wall, busy, _, _, _ = knob_keep["iteration"]
        log("train knobs: one more iteration %.1f ms wall, %.1f ms busy, "
            "idle %.3f (%s)" % (wall, busy, 1 - busy / wall, card))
        next(k for k in kernels if k["name"] == "scan_pair_knob").update(
            knob_wall_ms=wall, knob_busy_ms=busy)
        del knob_keep
        # row sampling on the per-split graph: bagging, then GOSS
        wall0, busy0 = persist_keep["iteration"][:2]
        bag_rec = next(k for k in kernels if k["name"] == "bag_apply")
        for path in BAG_PATHS:
            keep_b = {}
            runs[path] = phase_train(lgb, X, y, ds, args.bag_iters, card,
                                     args.profile, path, keep=keep_b)
            wall, busy = keep_b["iteration"][:2]
            log("train %s: one more iteration %.1f ms wall, %.1f ms busy, "
                "idle %.3f; the persist path's (no bag) %.1f / %.1f / %.3f "
                "(%s)" % (path, wall, busy, 1 - busy / wall, wall0, busy0,
                          1 - busy0 / wall0, card))
            bag_rec.update({path + "_wall_ms": wall, path + "_busy_ms": busy,
                            "persist_wall_ms": wall0,
                            "persist_busy_ms": busy0})
        # DART and RF on the per-split graph
        for path in DART_RF_PATHS:
            keep_d = {}
            runs[path] = phase_train(lgb, X, y, ds, DART_RF_ITERS, card,
                                     args.profile, path, keep=keep_d)
            wall, busy = keep_d["iteration"][:2]
            log("train %s: one more iteration %.1f ms wall, %.1f ms busy, "
                "idle %.3f; the persist path's %.1f / %.1f / %.3f (%s)"
                % (path, wall, busy, 1 - busy / wall, wall0, busy0,
                   1 - busy0 / wall0, card))
            rec = next(k for k in kernels if k["name"] == (
                "valid_walk_payload" if path == "dart" else "bag_rows"))
            rec.update({path + "_wall_ms": wall, path + "_busy_ms": busy,
                        "persist_wall_ms": wall0, "persist_busy_ms": busy0})
            h = keep_d["host"]
            if path == "dart":
                rec.update(drops=h["drops"], drop_ms=h["drop_ms"],
                           normalize_ms=h["normalize_ms"])
            else:
                rec.update(draw_ms=h["draw_ms"], upload_ms=h["upload_ms"])
        # the same bins with multiclass labels, then with an L2 target
        y5 = quantile_classes(latent, 5)
        ds.set_label(y5)
        log("data: the HIGGS rows relabelled: 5 classes, the latent's "
            "quintiles, %s rows each" % np.bincount(y5.astype(np.int64)))
        runs["multiclass"] = phase_train(lgb, X, y5, ds, args.mc_iters,
                                         card, args.profile, "multiclass")
        y_reg = l2_target(latent)
        ds.set_label(y_reg)
        log("data: the HIGGS rows relabelled: the latent plus Gaussian "
            "noise (mean %.4f, sd %.4f)" % (y_reg.mean(), y_reg.std()))
        runs["regression"] = phase_train(lgb, X, y_reg, ds, args.reg_iters,
                                         card, args.profile, "regression")
        l1_keep = {}
        runs["l1"] = phase_train(lgb, X, y_reg, ds, args.l1_iters, card,
                                 args.profile, "l1", keep=l1_keep)
        wall, busy, _, _, _ = l1_keep["iteration"]
        rec = phase_renew_kernel(l1_keep["bst"])
        log("train l1: one more iteration %.1f ms wall, %.1f ms busy, idle "
            "%.3f; the grower's renewal step %.4f ms, %.1f%% of busy (the "
            "regression path's iteration: see its profile)"
            % (wall, busy, 1 - busy / wall, rec["step_ms"],
               100 * rec["step_ms"] / busy))
        rec.update(l1_wall_ms=wall, l1_busy_ms=busy)
        kernels.append(rec)
        del y5, y_reg, l1_keep
    else:
        ds.set_label(l2_target(latent))
        kernels.append(phase_renew_kernel(lgb.train(
            dict(COMMON, **PATHS["l1"][0]), ds, 2)))
    # prediction and serving on the served model (bench.py:879-960)
    t = time.time()
    rec, pbst, Xp, direct = phase_predict(lgb, X, y, card, args.predict_rows,
                                          args.predict_iters)
    rec.update(phase_serve(pbst, Xp, direct, card, args.serve_rows))
    kernels.append(rec)
    log("predict and serve: %.1f s" % (time.time() - t))
    del pbst, Xp, direct
    del X, y, latent, ds, inner

    X, y = make_expo_like(args.expo_rows)
    log("data: make_expo_like(%d) -> %s" % (args.expo_rows, X.shape))
    params = dict(COMMON, **PATHS["bundled"][0])
    ds, inner = make_dataset(lgb, X, y, params, "Expo")
    if not inner.has_bundles:
        raise AssertionError("the Expo-shaped data are not EFB-bundled")
    cfg = lgb.Config(params)
    kernels.append(phase_block_kernels(inner, feature_meta(inner),
                                       grow_config(cfg, inner),
                                       SplitParams.from_config(cfg)))
    expo_keep = {}
    if not args.skip_train:
        runs["bundled"] = phase_train(lgb, X, y, ds, args.level_iters, card,
                                      args.profile, "bundled",
                                      args.off_iters, keep=expo_keep)
    else:
        expo_keep["bst"] = lgb.train(params, ds, 1)
        expo_keep["tree"] = expo_keep["bst"]._booster.models[0]
    Xe, ye = make_expo_like(args.expo_valid_rows, seed=9)
    erec = phase_valid_walk("Expo", expo_keep["tree"], inner, lgb.Dataset(
        Xe, ye, reference=ds).construct()._inner, 2)
    check_predict_cover(expo_keep["bst"], Xe, "bundled Expo",
                        numpy_rows=len(Xe))
    walk_rec = next(k for k in kernels if k["name"] == "valid_walk")
    walk_rec.update({"expo_" + k: erec[k] for k in (
        "ms", "plain_ms", "bound_ms", "max_abs_err", "rows", "leaves")})
    del Xe, ye, expo_keep
    del X, y, ds, inner

    # MSLR-WEB30K's shape: lambdarank, rank_xendcg, their kernels, and the
    # payload kernels at G = 137
    X, y, g, Xv, yv, gv = ltr_split(args.ltr_rows, args.ltr_valid_rows, 3)
    log("data: make_ltr_like(%d) -> %s in %d queries of %d rows, labels %s; "
        "its last %d queries (%d rows) held out"
        % (args.ltr_rows + args.ltr_valid_rows, X.shape, len(g), g[0],
           np.bincount(y.astype(np.int64)).tolist(), len(gv), len(yv)))
    params = dict(COMMON, **PATHS["ltr"][0])
    ds, inner = make_dataset(lgb, X, y, params, "MSLR", group=g)
    cfg = lgb.Config(params)
    mslr = phase_mslr_kernels(inner, feature_meta(inner),
                              grow_config(cfg, inner),
                              SplitParams.from_config(cfg))
    for rec in kernels:
        rec.update(mslr.get(rec["name"], {}))
    kernels += phase_rank_kernels(lgb, y, g)
    if not args.skip_train:
        ltr_keep = {}
        runs["ltr"] = phase_train(lgb, X, y, ds, args.ltr_iters, card,
                                  args.profile, "ltr", keep=ltr_keep)
        runs["ltr valid"], _, _ = phase_train_valid(
            lgb, ds, Xv, yv, args.ltr_iters, card, ltr_keep, "ltr", gv)
        wall, busy, _, _, _ = ltr_keep["iteration"]
        log("train ltr: one more iteration %.1f ms wall, %.1f ms busy, idle "
            "%.3f (%s)" % (wall, busy, 1 - busy / wall, card))
        del ltr_keep
        runs["xendcg"] = phase_train(lgb, X, y, ds, args.xendcg_iters, card,
                                     args.profile, "xendcg")
    del X, y, g, Xv, yv, gv, ds, inner

    # the airline set's shape (szilard/benchm-ml): six categorical columns
    # on the v1 grower, cat_scan beside scan_pair
    t = time.time()
    X, y = make_airline_like(args.airline_rows, seed=1)
    log("data: make_airline_like(%d) -> %s in %.1f s, %.4f delayed"
        % (args.airline_rows, X.shape, time.time() - t, y.mean()))
    params = dict(COMMON, **AIRLINE)
    ds, inner = make_dataset(lgb, X, y, params, "airline")
    log("data: airline bins per feature %s, categorical %s, %d MB of bins"
        % ([m.num_bin for m in inner.bin_mappers],
           inner.is_categorical.astype(int).tolist(),
           inner.binned.nbytes // 2**20))
    kernels.append(phase_cat_kernels(lgb, inner, y, params))
    if not args.skip_train:
        cat_keep = {}
        runs["airline"] = phase_train(lgb, X, y, ds, args.airline_iters,
                                      card, args.profile, "airline",
                                      keep=cat_keep)
        runs["airline onehot"] = phase_train(
            lgb, X, y, ds, args.airline_iters, card, args.profile,
            "airline onehot")
        wall, busy, _, _, _ = cat_keep["iteration"]
        log("train airline: one more iteration %.1f ms wall, %.1f ms busy, "
            "idle %.3f (%s)" % (wall, busy, 1 - busy / wall, card))
        next(k for k in kernels if k["name"] == "cat_scan").update(
            airline_wall_ms=wall, airline_busy_ms=busy,
            airline_num_cat=cat_keep["num_cat"])
        tree, cat_bst = cat_keep["tree"], cat_keep["bst"]
        del cat_keep
    else:
        cat_bst = lgb.train(params, ds, 1)
        tree = cat_bst._booster.models[0]
    Xa, ya = make_airline_like(args.airline_valid_rows, seed=2)
    arec = phase_valid_walk("airline", tree, inner, lgb.Dataset(
        Xa, ya, reference=ds).construct()._inner, 3)
    check_predict_cover(cat_bst, Xa, "airline")
    del cat_bst
    walk_rec.update({"airline_" + k: arec[k] for k in (
        "ms", "plain_ms", "bound_ms", "max_abs_err", "rows", "leaves")})
    del X, y, Xa, ya, ds, inner, tree
    if not args.skip_train:
        # each kernel's count from the run of the path it serves: the v1
        # grower's for hist_window, the per-split persistent grower's for
        # scan_pair, root_hist, split_pass and seg_hist, the level path's
        # for level_pass and level_seg_hist, the bundled path's for
        # scan_blocks
        # (grow_step: its splits, one commit each; its other kernels'
        # counts beside them)
        serves = {"hist_window": "v1", "scan_pair_knob": "knobs",
                  "level_pass": "level",
                  "level_seg_hist": "level", "scan_blocks": "bundled",
                  "valid_walk": "valid", "renew_leaf": "l1",
                  "lambdarank_grad": "ltr", "xendcg_grad": "xendcg",
                  "cat_scan": "airline", "bag_apply": "bagging",
                  "goss_select": "goss", "valid_walk_payload": "dart",
                  "bag_rows": "rf", "apply_scores_avg": "rf",
                  "leaf_sums": "api"}
        for rec in kernels:
            if rec["name"] == "predict_walk":
                continue            # counted over the serve phase
            run = runs[serves.get(rec["name"], "persist")]
            if rec["name"] == "grow_step":
                rec["launches"] = run["grow_commit"]
                rec["step_launches"] = {k: run[k] for k in STEPS
                                        + ("apply_scores",)}
            else:
                rec["launches"] = run[rec["name"]]
            if "consolidate_launches" in rec:
                rec["consolidate_launches"] = runs["persist"]["consolidate"]
            # the per-split path's kernels in the HIGGS multiclass and
            # regression runs too
            if rec["name"] in runs["multiclass"] and \
                    serves.get(rec["name"], "persist") == "persist":
                rec["multiclass_launches"] = runs["multiclass"][rec["name"]]
                rec["regression_launches"] = runs["regression"][rec["name"]]
                rec["l1_launches"] = runs["l1"][rec["name"]]
                rec["ltr_launches"] = runs["ltr"][rec["name"]]
            if rec["name"] in ("hist_window", "scan_pair"):
                rec["xendcg_launches"] = runs["xendcg"][rec["name"]]
            if rec["name"] == "hist_window":
                rec["knobs_launches"] = runs["knobs"]["hist_window"]
            if rec["name"] in ("hist_window", "scan_pair", "cat_scan"):
                rec["airline_launches"] = runs["airline"][rec["name"]]
                rec["airline_onehot_launches"] = \
                    runs["airline onehot"][rec["name"]]
            if rec["name"] == "split_pass":
                rec["multiclass_consolidate_launches"] = \
                    runs["multiclass"]["consolidate"]
            if rec["name"] == "bag_apply":
                rec["goss_launches"] = runs["goss"]["bag_apply"]
    if not args.skip_parity:
        t = time.time()
        (cuda, cuda_es, cuda_api), rows = parity_sides(lgb, args, "cuda")
        (cpu, cpu_es, cpu_api), _ = collect_parity_cpu(parity_cpu)
        phase_parity(cuda, cpu, rows)
        phase_parity_es(cuda_es, cpu_es, args.es_rounds)
        phase_parity_api(cuda_api, cpu_api)
        log("parity: %d paths in %.1f s after the card's other phases"
            % (len(PARITY) + len(ES_ROUTES) + len(API_PARITY),
               time.time() - t))
    print(json.dumps({"kernels": kernels}), flush=True)
    print("kernels: " + ", ".join(k["name"] for k in kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
