"""Bucketed batch-serving layer over the device predictor.

The port's counterpart of lightgbm_tpu/predict/serve.py. Serving traffic
is ragged. Each incoming batch is staged in a pinned host buffer of a
power-of-two row bucket between ``min_batch`` and ``max_batch``, so a
server allocates at most ``max_compiles() = log2(max_batch / min_batch) +
1`` staging buffers whatever batch sizes arrive (``stats()['compiles']``:
the buckets used; ``bucket_hits`` the batches that reused one). The
ladder's names are the JAX package's, whose buckets are its compiled
shapes; here the walk kernel takes any row count and walks each batch's
rows alone, with no padding rows. Batches larger than ``max_batch``
stream through in ``max_batch`` chunks (bounded device memory).

On one card, :func:`place_batch` copies a batch to the predictor's device
from its pinned staging buffer (:class:`PinnedStage`), because the
host-to-device copy is the host's main cost. Several cards (the JAX
package's row sharding over a mesh) wait for ROADMAP queue A, item 11.
"""
from __future__ import annotations

import threading
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..telemetry.histo import Histogram
from ..utils.log import LightGBMError
from .compile import _next_pow2
from .runtime import CudaPredictor


def one_device(predictor: CudaPredictor, devices) -> torch.device:
    """The predictor's device; `devices`, when given, must name it alone
    (serving over several cards is ROADMAP queue A, item 11)."""
    if devices is not None:
        devs = [torch.device(d) for d in devices]
        if len(devs) != 1:
            raise LightGBMError(
                "serving over %d devices is not ported (ROADMAP queue A, "
                "item 11: row sharding over several cards); pass one "
                "device" % len(devs))
        if devs[0].type != predictor.device.type or (
                devs[0].index is not None
                and devs[0].index != predictor.device.index):
            raise LightGBMError("serving device %s is not the predictor's "
                                "(%s)" % (devs[0], predictor.device))
    return predictor.device


class PinnedStage:
    """Pinned host buffers for the batches bound for one card, one per
    (bucket rows, features, dtype). A buffer is refilled only after its
    last copy to the card has completed (the event recorded after the
    copy), so a batch in flight never sees its rows change. Thread-safe."""

    def __init__(self):
        self._bufs: Dict[Tuple, list] = {}
        self._lock = threading.Lock()

    def place(self, parts: Sequence[np.ndarray], bucket: int,
              dtype: torch.dtype, device: torch.device) -> torch.Tensor:
        """The row blocks `parts` ([n_i, F] each, n_i summing to at most
        `bucket`) one after the other in an [n, F] tensor on `device`,
        copied from the bucket's pinned buffer on the current stream."""
        F = parts[0].shape[1]
        n = sum(p.shape[0] for p in parts)
        key = (bucket, F, dtype)
        with self._lock:
            ent = self._bufs.get(key)
            if ent is None:
                ent = [torch.empty((bucket, F), dtype=dtype,
                                   pin_memory=True), None]
                self._bufs[key] = ent
            buf, done = ent
            if done is not None:
                done.synchronize()
            host = buf.numpy()
            off = 0
            for p in parts:
                host[off:off + p.shape[0]] = p
                off += p.shape[0]
            X_dev = buf[:n].to(device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(device))
            ent[1] = ev
        return X_dev


def place_batch(parts: Sequence[np.ndarray], bucket: int,
                predictor: CudaPredictor,
                stage: Optional[PinnedStage]) -> torch.Tensor:
    """Row blocks -> one [n, F] batch on the predictor's device, in its
    dtype: through the pinned `stage` (its `bucket` buffer) on a card,
    directly on the CPU. Shared by the sync BatchServer and the async
    server's admission loop."""
    if predictor.device.type == "cuda":
        return stage.place(parts, bucket, predictor.dtype, predictor.device)
    return torch.from_numpy(np.concatenate(parts).astype(predictor.np_dtype,
                                                         copy=False))


class BatchServer:
    """Bucketed staging and chunking for one CudaPredictor.

    ``min_batch``/``max_batch`` bound the power-of-two bucket ladder of
    the staging buffers.
    ``devices`` may name the predictor's device; more than one raises
    (ROADMAP queue A, item 11).
    """

    def __init__(self, predictor: CudaPredictor, min_batch: int = 256,
                 max_batch: int = 1 << 16, devices=None):
        if max_batch < min_batch:
            raise ValueError("max_batch %d < min_batch %d"
                             % (max_batch, min_batch))
        self.predictor = predictor
        self.min_batch = _next_pow2(max(int(min_batch), 1))
        self.max_batch = _next_pow2(int(max_batch))
        self.device = one_device(predictor, devices)
        self._stage = PinnedStage() if self.device.type == "cuda" else None
        # instance-local serving stats, under _lock
        self._compiled_buckets = set()
        self._bucket_hits = 0
        # per-request end-to-end latency and queue wait (arrival -> service
        # start, when the caller gives arrival_t); queue depth sampled at
        # admission (requests admitted, not yet answered)
        self._h_e2e = Histogram("predict::e2e_latency", unit="s",
                                category="predict")
        self._h_queue = Histogram("predict::queue_wait", unit="s",
                                  category="predict")
        self._h_qdepth = Histogram("predict::queue_depth", unit="req",
                                   category="predict")
        self._depth = 0
        self._qdepth_max = 0
        self._lock = threading.Lock()

    # ------------------------------------------------------------------
    def bucket_rows(self, n: int) -> int:
        """Smallest ladder bucket holding n rows (n <= max_batch)."""
        return min(max(_next_pow2(n), self.min_batch), self.max_batch)

    def max_compiles(self) -> int:
        """The number of buckets the ladder can use (the JAX package's
        compile bound; here the bound on staging buffers)."""
        return int(np.log2(self.max_batch // self.min_batch)) + 1

    def _serve_chunk(self, X: np.ndarray, raw_score: bool) -> np.ndarray:
        n = X.shape[0]
        bucket = self.bucket_rows(n)
        with self._lock:
            if bucket in self._compiled_buckets:
                self._bucket_hits += 1
            else:
                self._compiled_buckets.add(bucket)
        X_dev = place_batch([X], bucket, self.predictor, self._stage)
        return self.predictor.predict_padded(X_dev, n, raw_score=raw_score)

    def predict(self, X, raw_score: bool = False,
                arrival_t: float = None) -> np.ndarray:
        """Serve one request of any size; rows beyond max_batch stream in
        max_batch chunks. ``arrival_t`` (a ``time.perf_counter()`` stamp)
        marks when the request arrived: its gap to service start is the
        queue wait, and the end-to-end latency runs from it."""
        self._admit()
        t_start = time.perf_counter()
        try:
            q_wait = max(t_start - arrival_t, 0.0) \
                if arrival_t is not None else 0.0
            X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
            if X.ndim == 1:
                X = X.reshape(1, -1)
            if X.shape[0] <= self.max_batch:
                out = self._serve_chunk(X, raw_score)
            else:
                outs = [self._serve_chunk(X[i:i + self.max_batch],
                                          raw_score)
                        for i in range(0, X.shape[0], self.max_batch)]
                out = np.concatenate(outs, axis=0)
        finally:
            with self._lock:
                self._depth -= 1
        e2e = time.perf_counter() - (arrival_t if arrival_t is not None
                                     else t_start)
        with self._lock:
            self._h_queue.record(q_wait)
            self._h_e2e.record(e2e)
        return out

    def _admit(self) -> int:
        """Count a request in; returns the depth after admission (the
        admission-time queue-depth sample)."""
        with self._lock:
            self._depth += 1
            self._qdepth_max = max(self._qdepth_max, self._depth)
            self._h_qdepth.record(float(self._depth))
            return self._depth

    # ------------------------------------------------------------------
    def stats(self) -> dict:
        """Per-server serving stats; ``latency_p50``/``latency_p99`` and
        ``queue_wait_p99`` are the SLO shortcuts."""
        with self._lock:
            return {
                "buckets_compiled": sorted(self._compiled_buckets),
                "compiles": len(self._compiled_buckets),
                "compile_bound": self.max_compiles(),
                "bucket_hits": self._bucket_hits,
                "requests": self._h_e2e.count,
                "latency_p50": self._h_e2e.percentile(0.50),
                "latency_p99": self._h_e2e.percentile(0.99),
                "queue_wait_p99": self._h_queue.percentile(0.99),
                "qdepth_max": self._qdepth_max,
                "latency": self._h_e2e.to_dict(),
                "queue_wait": self._h_queue.to_dict(),
                "queue_depth": self._h_qdepth.to_dict(),
            }
