"""Training entry point of the port (reference python-package engine.py).

``train`` without validation sets, callbacks, custom objectives or ``cv``:
those are ROADMAP.md queue A items and are refused when asked for.
"""
from __future__ import annotations

import copy
from typing import Any, Dict

from .basic import Booster, Dataset
from .utils.log import Log, LightGBMError

_ROUND_COUNT_KEYS = (
    "num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
    "num_round", "num_rounds", "num_boost_round", "n_estimators")


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100, valid_sets=None, fobj=None,
          feval=None, init_model=None, early_stopping_rounds=None,
          callbacks=None) -> Booster:
    """Train a booster for ``num_boost_round`` iterations (a round-count
    alias in ``params`` wins, as in the reference), stopping early when no
    leaf can split."""
    for name, value, item in (
            ("valid_sets", valid_sets, "item 18: metrics and validation sets"),
            ("feval", feval, "item 18: metrics and validation sets"),
            ("early_stopping_rounds", early_stopping_rounds,
             "item 18: metrics and validation sets"),
            ("callbacks", callbacks, "item 19: callbacks"),
            ("fobj", fobj, "item 17: other objectives"),
            ("init_model", init_model, "item 10: resilience")):
        if value is not None:
            raise LightGBMError("train(%s=...) is not ported yet "
                                "(ROADMAP.md queue A, %s)" % (name, item))
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = copy.deepcopy(params)
    for key in _ROUND_COUNT_KEYS:
        if key in params:
            Log.warning("Found `%s` in params. Will use it instead of "
                        "argument" % key)
            num_boost_round = int(params.pop(key))
            break
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    booster = Booster(params=params, train_set=train_set)
    for _ in range(num_boost_round):
        if booster.update():
            break
    return booster
