"""Training entry point of the port (reference python-package engine.py).

The port of the single-machine ``train`` of lightgbm_tpu/engine.py
(:23-133, :479-739): the alias precedence for the round count and early
stopping, the callbacks staged by a registry (``order``, before and after
the iteration), the evaluation plan (the training set when it is among
``valid_sets``, names ``valid_%d`` otherwise), early stopping as a callback
that raises ``EarlyStopException``, and ``best_iteration`` /
``best_score``.

Every round fires the callbacks and evaluates, as the JAX package's loop
does, also after a round that found nothing left to split (a later
``update`` then returns at once). One evaluation round reads its metric
values back with one copy.

Ranking trains from a ``Dataset(..., group=)``; a validation set carries
its own groups, and ``eval_at``/``label_gain`` reach the ndcg and map
metrics, whose early stopping keeps the bigger value.

A custom objective (``fobj``) sets ``objective=none`` and hands each
round's host gradients to ``Booster.update`` (the JAX package's
engine.py:591), which trains them on the v1 grower.

Refused, naming the ROADMAP.md item that will bring them: ``init_model``
(queue A, item 10) and ``num_machines > 1`` (item 11); ``cv`` is item 9.
"""
from __future__ import annotations

import collections
import copy
from typing import Any, Dict, List, Optional, Tuple

from . import callback
from .basic import Booster, Dataset
from .config import Config
from .utils.log import LightGBMError, Log

_ROUND_COUNT_KEYS = (
    "num_iterations", "num_iteration", "n_iter", "num_tree", "num_trees",
    "num_round", "num_rounds", "num_boost_round", "n_estimators")
_STOP_ROUND_KEYS = ("early_stopping_round", "early_stopping_rounds",
                    "early_stopping", "n_iter_no_change")


def _alias_override(params: Dict[str, Any], keys, fallback):
    """Pop the first matching alias out of `params`; params win over the
    keyword argument (reference alias precedence, engine.py:119-155)."""
    for key in keys:
        if key in params:
            Log.warning("Found `%s` in params. Will use it instead of "
                        "argument" % key)
            return int(params.pop(key))
    return fallback


class _CallbackRegistry:
    """Staged callback dispatch.

    Callbacks carry an `order` (implicit ones set their own; user-supplied
    ones default to negative offsets so they fire ahead of implicit ones)
    and a `before_iteration` flag selecting the stage. Dispatch is a stable
    sort by order within each stage.
    """

    def __init__(self, user_callbacks=None):
        self._pre: List = []
        self._post: List = []
        user_callbacks = list(user_callbacks or ())
        for offset, cb in enumerate(user_callbacks):
            cb.__dict__.setdefault("order", offset - len(user_callbacks))
        # identical objects registered twice fire once
        for cb in dict.fromkeys(user_callbacks):
            self.add(cb)

    def add(self, cb) -> None:
        stage = (self._pre if getattr(cb, "before_iteration", False)
                 else self._post)
        stage.append(cb)

    def seal(self) -> None:
        self._pre.sort(key=lambda cb: getattr(cb, "order", 0))
        self._post.sort(key=lambda cb: getattr(cb, "order", 0))

    def fire_pre(self, env: "callback.CallbackEnv") -> None:
        for cb in self._pre:
            cb(env)

    def fire_post(self, env: "callback.CallbackEnv") -> None:
        """May raise callback.EarlyStopException."""
        for cb in self._post:
            cb(env)


class _EvalPlan(collections.namedtuple(
        "_EvalPlan", ["eval_train", "train_name", "attached"])):
    """Which datasets each round evaluates: the train set itself (when the
    caller listed it among valid_sets) plus the attached held-out sets."""

    @classmethod
    def build(cls, train_set: Dataset, valid_sets, valid_names):
        if valid_sets is None:
            return cls(False, "training", [])
        if isinstance(valid_sets, Dataset):
            valid_sets = [valid_sets]
        if isinstance(valid_names, str):
            valid_names = [valid_names]
        names = list(valid_names) if valid_names is not None else []
        eval_train = False
        train_name = "training"
        attached: List[Tuple[Dataset, str]] = []
        for pos, ds in enumerate(valid_sets):
            label = names[pos] if pos < len(names) else "valid_%d" % pos
            if ds is train_set:
                eval_train = True
                if pos < len(names):
                    train_name = label
            else:
                if not isinstance(ds, Dataset):
                    raise TypeError("Training only accepts Dataset object")
                attached.append((ds, label))
        return cls(eval_train, train_name, attached)

    def attach(self, booster: Booster, params: Dict[str, Any],
               train_set: Dataset) -> None:
        if self.eval_train:
            booster.set_train_data_name(self.train_name)
        for ds, label in self.attached:
            ds._update_params(params).set_reference(train_set)
            booster.add_valid(ds, label)

    def evaluate(self, booster: Booster, feval) -> List:
        return booster._evaluate(self.eval_train, feval)

    @property
    def active(self) -> bool:
        return self.eval_train or bool(self.attached)


def train(params: Dict[str, Any], train_set: Dataset,
          num_boost_round: int = 100,
          valid_sets: Optional[List[Dataset]] = None,
          valid_names: Optional[List[str]] = None,
          fobj=None, feval=None, init_model=None,
          early_stopping_rounds: Optional[int] = None,
          evals_result: Optional[Dict] = None,
          verbose_eval=True, learning_rates=None,
          callbacks=None) -> Booster:
    """Train a booster for ``num_boost_round`` iterations (reference
    engine.py:18-290): a round-count or early-stopping alias in ``params``
    wins over the argument; ``valid_sets`` (the training set among them is
    evaluated as ``training``), ``feval``, ``early_stopping_rounds``,
    ``evals_result``, ``verbose_eval``, ``learning_rates`` and
    ``callbacks`` as in the JAX package; ``fobj(scores, train_set) ->
    (grad, hess)`` replaces the objective."""
    if init_model is not None:
        raise LightGBMError("train(init_model=...) is not ported yet "
                            "(ROADMAP.md queue A, item 10: resilience)")
    if not isinstance(train_set, Dataset):
        raise TypeError("Training only accepts Dataset object")
    params = copy.deepcopy(params)
    num_boost_round = _alias_override(params, _ROUND_COUNT_KEYS,
                                      num_boost_round)
    early_stopping_rounds = _alias_override(params, _STOP_ROUND_KEYS,
                                            early_stopping_rounds)
    if num_boost_round <= 0:
        raise ValueError("num_boost_round should be greater than zero.")
    cfg = Config(params)
    if int(cfg.num_machines) > 1:
        raise LightGBMError("num_machines > 1 is not ported yet (ROADMAP.md "
                            "queue A, item 11: distributed training)")
    # the JAX package checkpoints, resumes and traces under these keys
    # (engine.py:502, 622-659, 738); the port would ignore them
    asked = [k for k, on in (
        ("checkpoint_dir", bool(str(cfg.checkpoint_dir))),
        ("snapshot_freq > 0", int(cfg.snapshot_freq) > 0),
        ("tpu_telemetry=%s" % cfg.tpu_telemetry,
         str(cfg.tpu_telemetry).lower() != "off")) if on]
    if asked:
        raise LightGBMError("%s: checkpoints, resumption and telemetry are "
                            "not ported yet (ROADMAP.md queue A, item 10: "
                            "resilience)" % ", ".join(asked))
    if fobj is not None:
        params["objective"] = "none"

    plan = _EvalPlan.build(train_set, valid_sets, valid_names)

    registry = _CallbackRegistry(callbacks)
    if verbose_eval is True:
        registry.add(callback.print_evaluation())
    elif isinstance(verbose_eval, int) and not isinstance(verbose_eval, bool):
        registry.add(callback.print_evaluation(verbose_eval))
    if early_stopping_rounds is not None and early_stopping_rounds > 0:
        registry.add(callback.early_stopping(
            early_stopping_rounds, params.get("first_metric_only", False),
            verbose=bool(verbose_eval)))
    if learning_rates is not None:
        registry.add(callback.reset_parameter(learning_rate=learning_rates))
    if evals_result is not None:
        registry.add(callback.record_evaluation(evals_result))
    registry.seal()

    booster = Booster(params=params, train_set=train_set)
    plan.attach(booster, params, train_set)
    booster.best_iteration = 0

    def env_for(round_no: int, evals) -> callback.CallbackEnv:
        return callback.CallbackEnv(
            model=booster, params=params, iteration=round_no,
            begin_iteration=0, end_iteration=num_boost_round,
            evaluation_result_list=evals)

    final_evals: List = []
    for round_no in range(num_boost_round):
        registry.fire_pre(env_for(round_no, None))
        booster.update(fobj=fobj)
        final_evals = plan.evaluate(booster, feval) if plan.active else []
        try:
            registry.fire_post(env_for(round_no, final_evals))
        except callback.EarlyStopException as stop:
            booster.best_iteration = stop.best_iteration + 1
            final_evals = stop.best_score
            break

    booster.best_score = collections.defaultdict(collections.OrderedDict)
    for entry in final_evals:
        booster.best_score[entry[0]][entry[1]] = entry[2]
    return booster
