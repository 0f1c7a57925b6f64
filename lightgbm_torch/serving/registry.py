"""Multi-model registry with atomic hot-swap and rollback.

The port's counterpart of lightgbm_tpu/serving/registry.py. Named model
slots, each pinning one :class:`CudaPredictor` (ensemble tensors on the
card). The ACTIVE slot is a single reference the admission path snapshots
per request; swapping is one assignment under the registry lock, so:

  * requests admitted before the swap finish on the model they were
    admitted against (the async server pins the predictor at admission;
    a request never mixes two models' trees);
  * requests admitted after the swap route to the new model;
  * nothing is dropped: the old predictor stays alive (and on the card)
    until the last in-flight batch against it finalizes.

Load paths: an in-memory Booster, a model file or a model string (the
reference text format). ``rollback()`` restores the previously active slot
bit for bit, because the old predictor object is kept, not reloaded.

Quantized serving (the JAX package's f16 grid under its quant_audit
certificate, serving/quantized.py) is not ported: ``quant`` takes
``none`` only (ROADMAP queue A, item 8, step 3, with item 13's
certificate).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional

from ..predict.compile import compile_ensemble
from ..predict.runtime import CudaPredictor
from ..utils.log import LightGBMError

QUANT_NONE = "none"


class QuantRefusedError(LightGBMError):
    """A quantized load was asked for; the port serves none yet."""


class ModelSlot:
    """One named, immutable registry entry."""

    __slots__ = ("name", "predictor", "quant", "source", "num_trees",
                 "loaded_at")

    def __init__(self, name: str, predictor: CudaPredictor, quant: str,
                 source: str):
        self.name = name
        self.predictor = predictor
        self.quant = quant
        self.source = source
        self.num_trees = predictor.ensemble.num_trees
        self.loaded_at = time.time()

    def describe(self) -> dict:
        return {"name": self.name, "quant": self.quant,
                "source": self.source, "num_trees": self.num_trees,
                "loaded_at": self.loaded_at}


class ModelRegistry:
    """Named slots + one atomic active pointer (see the module doc).
    ``device``: where the predictors live (default: the params'
    ``device_type``, ``cuda`` unless they ask for the CPU)."""

    def __init__(self, dtype: str = "f64", params: Optional[dict] = None,
                 device=None):
        self.dtype = dtype
        self.params = dict(params or {})
        if device is None:
            from ..config import Config
            device = Config(self.params).device_type
        self.device = device
        self._slots: Dict[str, ModelSlot] = {}
        self._active: Optional[ModelSlot] = None
        self._previous: Optional[ModelSlot] = None
        self._swaps = 0
        self._lock = threading.RLock()

    # -- loading -------------------------------------------------------
    def load(self, name: str, booster=None, model_file: str = None,
             model_str: str = None, quant: str = QUANT_NONE,
             activate: bool = False) -> ModelSlot:
        """Compile a model into the named slot (exactly one source).

        ``activate=True`` swaps the new slot in atomically; the first
        successful load activates unconditionally so a fresh registry is
        servable at once. A refused load leaves the registry as it was.
        """
        sources = [s for s in (booster, model_file, model_str)
                   if s is not None]
        if len(sources) != 1:
            raise ValueError(
                "load() needs exactly one of booster/model_file/model_str "
                "(got %d)" % len(sources))
        q = str(quant or QUANT_NONE).lower()
        if q not in ("none", "", "off", "false", "0"):
            raise QuantRefusedError(
                "quant=%s: quantized serving is not ported (ROADMAP queue "
                "A, item 8, step 3: f16 serving admitted by item 13's "
                "quant_certify certificate; int8 is refused by it); load "
                "with quant=none" % quant)
        if model_file is not None:
            source = "file:%s" % model_file
        elif model_str is not None:
            source = "string"
        else:
            source = "booster"
        if booster is None:
            from ..basic import Booster
            booster = Booster(params=self.params, model_file=model_file,
                              model_str=model_str)
        gb = booster._booster
        ens = compile_ensemble(gb._used_models(0, -1),
                               gb.num_tree_per_iteration,
                               gb.average_output, gb.max_feature_idx)
        pred = CudaPredictor(ens, gb.objective, dtype=self.dtype,
                             device=self.device)
        slot = ModelSlot(name, pred, QUANT_NONE, source)
        with self._lock:
            self._slots[name] = slot
            if activate or self._active is None:
                self._swap_locked(slot)
        return slot

    # -- swap / rollback ----------------------------------------------
    def _swap_locked(self, slot: ModelSlot) -> None:
        # the atomic flip: one reference assignment under the lock —
        # admission snapshots (resolve()) see strictly-before or
        # strictly-after, never a mix
        self._previous = self._active
        self._active = slot
        self._swaps += 1

    def swap(self, name: str) -> ModelSlot:
        """Atomically make the named slot active; returns it."""
        with self._lock:
            slot = self._slots.get(name)
            if slot is None:
                raise KeyError("no model slot %r (have: %s)"
                               % (name, sorted(self._slots) or "none"))
            self._swap_locked(slot)
            return slot

    def rollback(self) -> ModelSlot:
        """Restore the previously active slot: the same predictor object,
        so scores after the rollback equal those before the swap bit for
        bit."""
        with self._lock:
            if self._previous is None:
                raise RuntimeError(
                    "nothing to roll back to (fewer than two "
                    "activations so far)")
            slot = self._previous
            self._swap_locked(slot)
            return slot

    # -- resolution ----------------------------------------------------
    def resolve(self, name: Optional[str] = None) -> CudaPredictor:
        """Predictor snapshot for admission: the active slot's (or a named
        slot's) predictor, captured once."""
        with self._lock:
            slot = self._active if name is None else self._slots.get(name)
            if slot is None:
                raise RuntimeError(
                    "no active model in the registry"
                    if name is None else "no model slot %r" % name)
            return slot.predictor

    def active(self) -> Optional[ModelSlot]:
        with self._lock:
            return self._active

    def names(self) -> List[str]:
        with self._lock:
            return sorted(self._slots)

    def drop(self, name: str) -> None:
        """Remove a slot (refused while active: swap away first)."""
        with self._lock:
            if self._active is not None and self._active.name == name:
                raise RuntimeError("cannot drop the active slot %r"
                                   % name)
            self._slots.pop(name, None)
            if self._previous is not None and self._previous.name == name:
                self._previous = None

    def stats(self) -> dict:
        with self._lock:
            return {
                "slots": {n: s.describe()
                          for n, s in self._slots.items()},
                "active": (self._active.name
                           if self._active is not None else None),
                "previous": (self._previous.name
                             if self._previous is not None else None),
                "swaps": self._swaps,
            }
