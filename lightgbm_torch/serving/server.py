"""Async request queue with continuous batching over the bucket ladder.

The port's counterpart of lightgbm_tpu/serving/server.py. The synchronous
:class:`predict.serve.BatchServer` answers one request per walk: a burst of
small requests costs one launch and one round trip each, each batch a
few rows. This server puts an admission queue in front of the same
machinery and runs a service loop that

  * **admits while a batch is in flight**: a batch's copy to the card, its
    walk and its copy back are queued on a side CUDA stream with an event
    after them, so the loop builds the next coalesced batch while the card
    runs this one, and waits only at the event (one batch on the card, one
    being built: an in-flight pipeline of depth 2);
  * **coalesces** the FIFO prefix of compatible requests (same model
    snapshot, same raw flag, same feature width) into ONE batch of at
    most ``max_batch`` rows, staged in the pinned buffer of its
    power-of-two bucket of the sync server's ladder;
  * **flushes deadline-aware**: a sub-bucket batch is held for coalescing
    only while the card is busy or until the oldest request has waited
    ``max_wait``; then it is flushed partial. A full bucket flushes at
    once; an idle card with at least ``min_batch`` rows flushes at once.

Callers get a :class:`ServeFuture` per request and block only on their own
rows. The model is pinned at admission (a snapshot out of the
:class:`serving.registry.ModelRegistry`): a swap lands between requests,
never inside one. Queue wait (admission -> service start) and end-to-end
latency (admission -> answer) go into the instance histograms of
``stats()``.
"""
from __future__ import annotations

import contextlib
import threading
import time
from collections import deque
from typing import List, Optional

import numpy as np
import torch

from ..predict.compile import _next_pow2
from ..predict.runtime import CudaPredictor
from ..predict.serve import PinnedStage, one_device, place_batch
from ..telemetry.histo import Histogram

# service-loop poll bound: how long the loop sleeps when the queue is
# empty; also the deadline-check granularity while holding a partial
# batch (a fraction of max_wait, floored so an idle server stays cheap)
_MIN_POLL_S = 0.0005


class ServingError(RuntimeError):
    pass


class ServeFuture:
    """Per-request handle: the caller blocks only on its own rows.

    Oversized requests (rows > max_batch) are admitted as several
    chunked parts sharing one future; parts re-assemble in order."""

    __slots__ = ("_event", "_parts", "_missing", "_exc", "_lock")

    def __init__(self, parts: int = 1):
        self._event = threading.Event()
        self._parts: List[Optional[np.ndarray]] = [None] * parts
        self._missing = parts
        self._exc: Optional[BaseException] = None
        self._lock = threading.Lock()

    def _set_part(self, index: int, value: np.ndarray) -> None:
        with self._lock:
            if self._parts[index] is None:
                self._parts[index] = value
                self._missing -= 1
            if self._missing <= 0:
                self._event.set()

    def _set_exception(self, exc: BaseException) -> None:
        with self._lock:
            if self._exc is None:
                self._exc = exc
            self._event.set()

    def done(self) -> bool:
        return self._event.is_set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        if not self._event.wait(timeout):
            raise TimeoutError("serving request not finished within %r s"
                               % timeout)
        if self._exc is not None:
            raise self._exc
        if len(self._parts) == 1:
            return self._parts[0]
        return np.concatenate(self._parts, axis=0)


class _Request:
    """One admitted chunk: rows + routing snapshot + its future part."""

    __slots__ = ("X", "n", "raw_score", "predictor", "arrival_t",
                 "future", "part")

    def __init__(self, X, n, raw_score, predictor, arrival_t, future,
                 part):
        self.X = X
        self.n = n
        self.raw_score = raw_score
        self.predictor = predictor
        self.arrival_t = arrival_t
        self.future = future
        self.part = part


class _Inflight:
    """One dispatched batch: its output (a host tensor once `done` has
    fired on a card) and the event after its copy back."""

    __slots__ = ("out", "done", "group", "rows", "predictor")

    def __init__(self, out, done, group, rows, predictor):
        self.out = out
        self.done = done
        self.group = group
        self.rows = rows
        self.predictor = predictor


class AsyncBatchServer:
    """Continuous-batching server over one model source.

    ``model`` is either a fixed :class:`CudaPredictor` or a
    :class:`serving.registry.ModelRegistry` (hot-swap: each request
    snapshots the then-active predictor at admission).

    ``max_wait_ms`` is the deadline budget a sub-bucket batch may spend
    waiting to coalesce. ``devices`` may name the one device; more than one
    raises (ROADMAP queue A, item 11).
    """

    def __init__(self, model, min_batch: int = 256,
                 max_batch: int = 1 << 16, devices=None,
                 max_wait_ms: float = 5.0):
        if max_batch < min_batch:
            raise ValueError("max_batch %d < min_batch %d"
                             % (max_batch, min_batch))
        self._registry = model if not isinstance(model, CudaPredictor) \
            else None
        self._fixed = model if isinstance(model, CudaPredictor) else None
        if self._fixed is not None:
            one_device(self._fixed, devices)
        elif devices is not None:
            one_device(self._registry.resolve(), devices)
        self.min_batch = _next_pow2(max(int(min_batch), 1))
        self.max_batch = _next_pow2(int(max_batch))
        self.max_wait = max(float(max_wait_ms), 0.0) / 1e3
        self._poll = max(self.max_wait / 4.0, _MIN_POLL_S)
        self._stage = PinnedStage()
        self._streams = {}           # device -> side stream (service loop)
        # admission state (guarded by _cond's lock)
        self._cond = threading.Condition()
        self._pending: deque = deque()
        self._depth = 0              # admitted, not yet answered
        self._qdepth_max = 0
        self._stopping = False
        self._thread: Optional[threading.Thread] = None
        # in-flight pipeline (service-loop private, depth <= 2)
        self._inflight: deque = deque()
        # instance-local stats, under _cond
        self._requests = 0
        self._batches = 0
        self._flushes = {"full": 0, "deadline": 0, "idle": 0}
        self._errors = 0
        self._compiled_buckets = set()
        self._h_e2e = Histogram("serving::e2e_latency", unit="s",
                                category="serving")
        self._h_queue = Histogram("serving::queue_wait", unit="s",
                                  category="serving")
        self._h_qdepth = Histogram("serving::queue_depth", unit="req",
                                   category="serving")
        self._h_batch_rows = Histogram("serving::batch_rows", lo=1.0,
                                       hi=1e7, unit="rows",
                                       category="serving")

    # -- lifecycle -----------------------------------------------------
    def start(self) -> "AsyncBatchServer":
        if self._thread is None or not self._thread.is_alive():
            self._stopping = False
            self._thread = threading.Thread(
                target=self._loop, name="serving-loop", daemon=True)
            self._thread.start()
        return self

    def stop(self, drain: bool = True,
             timeout: Optional[float] = None) -> None:
        """Stop the loop; with drain (default) every queued request is
        answered first. `timeout` bounds the wait for the loop; a loop
        still running after it raises ServingError."""
        with self._cond:
            self._stopping = True
            if not drain:
                err = ServingError("server stopped without drain")
                while self._pending:
                    self._pending.popleft().future._set_exception(err)
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise ServingError("the serving loop did not stop within "
                                   "%r s" % timeout)
            self._thread = None

    def __enter__(self) -> "AsyncBatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- admission -----------------------------------------------------
    def _resolve(self) -> CudaPredictor:
        if self._fixed is not None:
            return self._fixed
        return self._registry.resolve()

    def submit(self, X, raw_score: bool = False,
               arrival_t: Optional[float] = None) -> ServeFuture:
        """Admit one request; returns its future. The model snapshot is
        taken HERE. Requests larger than max_batch are chunked into parts
        behind one future."""
        arrival = arrival_t if arrival_t is not None \
            else time.perf_counter()
        X = np.ascontiguousarray(np.asarray(X, dtype=np.float64))
        if X.ndim == 1:
            X = X.reshape(1, -1)
        if X.shape[0] == 0:
            raise ValueError("empty request")
        predictor = self._resolve()
        n_parts = (X.shape[0] + self.max_batch - 1) // self.max_batch
        future = ServeFuture(parts=n_parts)
        reqs = [_Request(X[i * self.max_batch:(i + 1) * self.max_batch],
                         min(self.max_batch,
                             X.shape[0] - i * self.max_batch),
                         bool(raw_score), predictor, arrival, future, i)
                for i in range(n_parts)]
        with self._cond:
            if self._stopping:
                raise ServingError("server is stopped")
            self._pending.extend(reqs)
            self._depth += 1
            self._qdepth_max = max(self._qdepth_max, self._depth)
            self._requests += 1
            self._h_qdepth.record(float(self._depth))
            self._cond.notify()
        return future

    def predict(self, X, raw_score: bool = False,
                arrival_t: Optional[float] = None,
                timeout: Optional[float] = None) -> np.ndarray:
        """Blocking convenience: submit + wait on this request only."""
        return self.submit(X, raw_score=raw_score,
                           arrival_t=arrival_t).result(timeout)

    # -- service loop ---------------------------------------------------
    def _loop(self) -> None:
        while self._step():
            pass

    def _step(self) -> bool:
        group = self._admit_wave()
        if group:
            self._inflight.append(self._dispatch(group))
        if self._inflight and (len(self._inflight) >= 2 or not group):
            self._finalize(self._inflight.popleft())
        with self._cond:
            if self._stopping and not self._pending \
                    and not self._inflight:
                return False
        return True

    def _admit_wave(self) -> Optional[List[_Request]]:
        """Take the FIFO prefix of coalescible requests when the flush
        policy says go; None to hold (or when the queue is idle)."""
        with self._cond:
            if not self._pending and not self._inflight \
                    and not self._stopping:
                self._cond.wait(timeout=self._poll)
            if not self._pending:
                return None
            head = self._pending[0]
            key = (id(head.predictor), head.raw_score, head.X.shape[1])
            rows = 0
            take = 0
            for r in self._pending:
                if (id(r.predictor), r.raw_score, r.X.shape[1]) != key \
                        or rows + r.n > self.max_batch:
                    break
                rows += r.n
                take += 1
            full = rows >= self.max_batch or take < len(self._pending)
            waited = time.perf_counter() - head.arrival_t
            idle = not self._inflight
            if self._stopping:
                cause = "idle"
            elif full:
                cause = "full"
            elif waited >= self.max_wait:
                cause = "deadline"
            elif idle and rows >= self.min_batch:
                cause = "idle"
            else:
                # hold: the card is busy, or a sub-bucket batch is still
                # inside its coalescing window (the deadline branch above
                # bounds every wait). With an idle card, sleep out a slice
                # of the window on the condition; an arrival wakes us.
                if idle:
                    self._cond.wait(timeout=min(
                        max(self.max_wait - waited, 0.0) + 1e-4,
                        self._poll))
                return None
            group = [self._pending.popleft() for _ in range(take)]
            self._flushes[cause] += 1
        return group

    def _side_stream(self, device: torch.device):
        """The stream a batch for `device` runs on: a side CUDA stream of
        the service loop, or nothing on the CPU."""
        if device.type != "cuda":
            return contextlib.nullcontext(), None
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device)
        # after whatever the default stream queued before (a predictor's
        # ensemble upload): the side stream does not wait for it on its own
        s.wait_stream(torch.cuda.current_stream(device))
        return torch.cuda.stream(s), s

    def _dispatch(self, group: List[_Request]) -> _Inflight:
        """Stage, copy to the card, walk and copy back one coalesced batch,
        all queued on the side stream; returns before the card finishes."""
        pred = group[0].predictor
        raw = group[0].raw_score
        rows = sum(r.n for r in group)
        bucket = min(max(_next_pow2(rows), self.min_batch), self.max_batch)
        t_svc = time.perf_counter()
        ctx, stream = self._side_stream(pred.device)
        try:
            with ctx:
                X_dev = place_batch([r.X for r in group], bucket, pred,
                                    self._stage)
                out = pred.dispatch_padded(X_dev, raw_score=raw)
                done = None
                if stream is not None:
                    host = torch.empty(out.shape, dtype=out.dtype,
                                       pin_memory=True)
                    host.copy_(out, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record(stream)
                    out = host
        except Exception as exc:       # noqa: BLE001 — futures must
            out, done = exc, None      # never hang on any error
        with self._cond:
            for r in group:
                self._h_queue.record(max(t_svc - r.arrival_t, 0.0))
            self._compiled_buckets.add((id(pred), bucket))
            self._batches += 1
            self._h_batch_rows.record(float(rows))
        return _Inflight(out, done, group, rows, pred)

    def _finalize(self, inf: _Inflight) -> None:
        """Wait for one batch, hand each request its rows, record the
        end-to-end latency from arrival."""
        try:
            if isinstance(inf.out, Exception):
                raise inf.out
            if inf.done is not None:
                inf.done.synchronize()
            out = inf.predictor.finalize_padded(inf.out, inf.rows)
        except Exception as exc:           # noqa: BLE001 — futures must
            self._fail_group(inf.group, exc)   # never hang on any error
            return
        off = 0
        t_done = time.perf_counter()
        for r in inf.group:
            r.future._set_part(r.part, out[off:off + r.n])
            off += r.n
        with self._cond:
            for r in inf.group:
                self._h_e2e.record(max(t_done - r.arrival_t, 0.0))
            self._depth -= len({id(r.future) for r in inf.group
                                if r.part == 0})

    def _fail_group(self, group: List[_Request],
                    exc: BaseException) -> None:
        for r in group:
            r.future._set_exception(exc)
        with self._cond:
            self._errors += len(group)
            self._depth -= len({id(r.future) for r in group
                                if r.part == 0})

    # -- stats ----------------------------------------------------------
    def stats(self) -> dict:
        """Serving stats, the async analog of BatchServer.stats() (same SLO
        shortcut keys), plus ``coalesce_ratio`` (requests per batch)."""
        with self._cond:
            d = {
                "requests": self._requests,
                "batches": self._batches,
                "coalesce_ratio": (self._requests / self._batches
                                   if self._batches else 0.0),
                "flushes": dict(self._flushes),
                "errors": self._errors,
                "depth": self._depth,
                "qdepth_max": self._qdepth_max,
                "buckets_compiled": sorted({b for _, b in
                                            self._compiled_buckets}),
                "latency_p50": self._h_e2e.percentile(0.50),
                "latency_p99": self._h_e2e.percentile(0.99),
                "queue_wait_p99": self._h_queue.percentile(0.99),
                "queue_wait_max": (self._h_queue.vmax
                                   if self._h_queue.count else None),
                "max_wait": self.max_wait,
                "latency": self._h_e2e.to_dict(),
                "queue_wait": self._h_queue.to_dict(),
                "batch_rows": self._h_batch_rows.to_dict(),
            }
        if self._registry is not None:
            d["registry"] = self._registry.stats()
        return d
