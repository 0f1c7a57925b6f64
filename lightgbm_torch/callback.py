"""Training callbacks of the port.

The port's own copy of lightgbm_tpu/callback.py, which implements the
CallbackEnv protocol of the reference python package
(python-package/lightgbm/callback.py): the same factory names, env fields,
`order`/`before_iteration` attributes and EarlyStopException contract, so
user callbacks written for LightGBM run unchanged. Each factory returns a
small stateful object whose `__call__(env)` does the work.

``reset_parameter`` goes through GBDT.reset_config, which takes the
learning rate, the split keys and the bagging keys; any other key raises.
"""
from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional

from .utils.log import Log


class EarlyStopException(Exception):
    """Raised by the early_stopping callback to end training."""

    def __init__(self, best_iteration: int, best_score):
        super().__init__()
        self.best_iteration = best_iteration
        self.best_score = best_score


class CallbackEnv(NamedTuple):
    """State handed to every callback once per iteration.

    A NamedTuple like the reference's, so third-party callbacks that
    tuple-unpack or index it positionally keep working.
    """
    model: object
    params: dict
    iteration: int
    begin_iteration: int
    end_iteration: int
    evaluation_result_list: list


def _format_eval_result(value, show_stdv: bool = True) -> str:
    """One eval tuple -> 'data's metric: 0.123 [+ 0.01]'.

    Tuples are (data, metric, value, is_higher_better) from train() or the
    5-field (data, metric, mean, is_higher_better, stdv) from cv().
    """
    if len(value) == 4:
        return f"{value[0]}'s {value[1]}: {value[2]:g}"
    if len(value) == 5:
        base = f"{value[0]}'s {value[1]}: {value[2]:g}"
        return base + (f" + {value[4]:g}" if show_stdv else "")
    raise ValueError("Wrong metric value")


class _EvalLogger:
    """Prints the eval tuples every `period` iterations."""

    def __init__(self, period: int, show_stdv: bool):
        self.order = 10
        self.before_iteration = False
        self.period = period
        self.show_stdv = show_stdv

    def __call__(self, env: CallbackEnv) -> None:
        if self.period <= 0 or not env.evaluation_result_list:
            return
        if (env.iteration + 1) % self.period:
            return
        line = "\t".join(_format_eval_result(v, self.show_stdv)
                         for v in env.evaluation_result_list)
        Log.info("[%d]\t%s" % (env.iteration + 1, line))


def print_evaluation(period: int = 1, show_stdv: bool = True) -> Callable:
    """Log evaluation results every `period` iterations."""
    return _EvalLogger(period, show_stdv)


class _HistoryRecorder:
    """Appends each iteration's eval values into a user-supplied dict of
    {data_name: {eval_name: [values...]}}."""

    def __init__(self, store: Dict):
        self.order = 20
        self.before_iteration = False
        if not isinstance(store, dict):
            raise TypeError("eval_result should be a dictionary")
        store.clear()
        self.store = store

    def __call__(self, env: CallbackEnv) -> None:
        for item in env.evaluation_result_list:
            data_name, eval_name, value = item[0], item[1], item[2]
            self.store.setdefault(data_name, {}) \
                      .setdefault(eval_name, []).append(value)


def record_evaluation(eval_result: Dict) -> Callable:
    """Record evaluation history into `eval_result`."""
    return _HistoryRecorder(eval_result)


class _ParamScheduler:
    """Re-applies parameters on a schedule before each iteration.

    Values may be lists (indexed by iteration) or callables(iteration).
    They route through GBDT.reset_config (the ResetConfig analog,
    gbdt.cpp:704), which takes the learning rate, the split keys and the
    bagging keys and raises for any other key.
    """

    def __init__(self, schedule: Dict):
        self.order = 10
        self.before_iteration = True
        self.schedule = schedule
        self._prev = None   # last applied values (reset only on change)

    def _value_at(self, key, spec, env: CallbackEnv):
        step = env.iteration - env.begin_iteration
        if isinstance(spec, list):
            if len(spec) != env.end_iteration - env.begin_iteration:
                raise ValueError("Length of list %r has to equal to "
                                 "'num_boost_round'" % key)
            return spec[step]
        return spec(step)

    def __call__(self, env: CallbackEnv) -> None:
        updates = {k: self._value_at(k, v, env)
                   for k, v in self.schedule.items()}
        if not updates:
            return
        # apply only the keys whose value CHANGED since the previous
        # iteration (reference _reset_parameter_callback compares per
        # entry)
        prev = self._prev or {}
        changed = {k: v for k, v in updates.items()
                   if k not in prev or prev[k] != v}
        self._prev = updates
        if not changed:
            return
        inner = getattr(env.model, "_booster", None)
        if inner is not None:
            inner.reset_config(changed)
        env.params.update(changed)


def reset_parameter(**kwargs) -> Callable:
    """Change parameters on a per-iteration schedule."""
    return _ParamScheduler(kwargs)


class _MetricState:
    """Best-so-far tracker for one (dataset, metric) eval stream."""

    __slots__ = ("best_value", "best_iteration", "best_snapshot", "bigger")

    def __init__(self, bigger_is_better: bool):
        self.bigger = bigger_is_better
        self.best_value = float("-inf") if bigger_is_better else float("inf")
        self.best_iteration = 0
        self.best_snapshot = None

    def update(self, value, iteration, snapshot) -> None:
        improved = (value > self.best_value if self.bigger
                    else value < self.best_value)
        if self.best_snapshot is None or improved:
            self.best_value = value
            self.best_iteration = iteration
            self.best_snapshot = snapshot


class _EarlyStopper:
    """Stops training when no tracked metric improves for N rounds."""

    def __init__(self, stopping_rounds: int, first_metric_only: bool,
                 verbose: bool):
        self.order = 30
        self.before_iteration = False
        self.rounds = stopping_rounds
        self.first_metric_only = first_metric_only
        self.verbose = verbose
        self.states: Optional[List[_MetricState]] = None
        self.enabled = True
        self.first_metric = ""

    def _setup(self, env: CallbackEnv) -> None:
        boosting = next((env.params[k] for k in
                         ("boosting", "boosting_type", "boost")
                         if k in env.params), None)
        if boosting == "dart":
            self.enabled = False
            Log.warning("Early stopping is not available in dart mode")
            return
        if not env.evaluation_result_list:
            raise ValueError(
                "For early stopping, at least one dataset and eval metric "
                "is required for evaluation")
        if self.verbose:
            Log.info("Training until validation scores don't improve for "
                     "%d rounds" % self.rounds)
        # metric name may carry a 'top-k' prefix: compare the last token
        self.first_metric = env.evaluation_result_list[0][1].split(" ")[-1]
        self.states = [_MetricState(bool(item[3]))
                       for item in env.evaluation_result_list]

    # -- the best-so-far trackers as a JSON-able snapshot ---------------
    def state_dict(self) -> Optional[Dict]:
        """JSON-able snapshot of the per-metric best trackers (None until
        the first evaluation); the JAX package's resilience checkpoints
        carry it, so a resumed run keeps the same patience clock and
        rollback point (the port's checkpoints: ROADMAP.md queue A, item
        10)."""
        if self.states is None:
            return None
        return {"first_metric": self.first_metric,
                "states": [{"bigger": s.bigger,
                            "best_value": s.best_value,
                            "best_iteration": s.best_iteration,
                            "best_snapshot": s.best_snapshot}
                           for s in self.states]}

    def load_state_dict(self, snap: Dict) -> None:
        self.first_metric = snap["first_metric"]
        self.states = []
        for sd in snap["states"]:
            st = _MetricState(bool(sd["bigger"]))
            st.best_value = float(sd["best_value"])
            st.best_iteration = int(sd["best_iteration"])
            st.best_snapshot = ([tuple(t) for t in sd["best_snapshot"]]
                                if sd["best_snapshot"] else None)
            self.states.append(st)

    def _stop(self, state: _MetricState, reason: str) -> None:
        if self.verbose:
            Log.info("%s, best iteration is:\n[%d]\t%s" % (
                reason, state.best_iteration + 1,
                "\t".join(_format_eval_result(v)
                          for v in state.best_snapshot)))
        raise EarlyStopException(state.best_iteration, state.best_snapshot)

    def __call__(self, env: CallbackEnv) -> None:
        if self.states is None and self.enabled:
            self._setup(env)
        if not self.enabled:
            return
        results = env.evaluation_result_list
        data_names = {item[0] for item in results}
        is_last = env.iteration == env.end_iteration - 1
        for state, item in zip(self.states, results):
            state.update(item[2], env.iteration, results)
            if self.first_metric_only and \
                    item[1].split(" ")[-1] != self.first_metric:
                continue
            train_only_stream = item[0] == "training" and len(data_names) > 1
            if not train_only_stream and \
                    env.iteration - state.best_iteration >= self.rounds:
                self._stop(state, "Early stopping")
            if is_last:
                self._stop(state, "Did not meet early stopping")


def early_stopping(stopping_rounds: int, first_metric_only: bool = False,
                   verbose: bool = True) -> Callable:
    """Stop training when validation metrics stall for `stopping_rounds`."""
    return _EarlyStopper(stopping_rounds, first_metric_only, verbose)
