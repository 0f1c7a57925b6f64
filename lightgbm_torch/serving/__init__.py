"""Async serving: the admission layer above :mod:`predict`.

The port's counterpart of lightgbm_tpu/serving/:

* :mod:`server`   — :class:`AsyncBatchServer`: an admission queue with
  continuous batching over the power-of-two bucket ladder, deadline-aware
  partial flushes, per-request futures, and an in-flight pipeline of depth
  2 on a side CUDA stream;
* :mod:`registry` — :class:`ModelRegistry`: named model slots, atomic
  hot-swap (admission-time snapshots: in-flight requests finish on the old
  model, none dropped), bit-exact rollback, loads from a Booster, a model
  file or model text.

The sync :class:`predict.serve.BatchServer` remains the one-caller path.
"""
from .registry import ModelRegistry, ModelSlot, QuantRefusedError
from .server import AsyncBatchServer, ServeFuture, ServingError

__all__ = ["AsyncBatchServer", "ServeFuture", "ServingError",
           "ModelRegistry", "ModelSlot", "QuantRefusedError"]
