"""Multiclass training on the persistent grower's level phase
(``max_depth=3``), apart from tests/test_torch_multiclass.py so that the
two files' JAX interpret runs share the test workers; the data, routes and
rules are that file's."""
import numpy as np
import pytest

from test_torch_multiclass import (BASE, check_route, class_data,
                                   train_port)


@pytest.mark.parametrize("objective", ["multiclass", "multiclassova"])
def test_multiclass_level_matches_jax(objective, monkeypatch):
    check_route(objective, "level", monkeypatch)


def test_multiclass_level_equals_per_split():
    """The level phase grows the per-split loop's trees for every class:
    raw predictions bit-equal with tpu_level_grow on and off (level
    numbering differs in the model text)."""
    params = dict(BASE, objective="multiclass", num_class=3,
                  tpu_persist_scan="force", max_depth=4, num_leaves=16)
    X, y = class_data(seed=8)
    a = train_port(params, X, y, 4)
    b = train_port(dict(params, tpu_level_grow="off"), X, y, 4)
    assert a._booster.tree_learner._persist_gr.use_level
    assert not b._booster.tree_learner._persist_gr.use_level
    np.testing.assert_array_equal(a.predict(X, raw_score=True),
                                  b.predict(X, raw_score=True))
    np.testing.assert_array_equal(a._booster.train_score.score.numpy(),
                                  b._booster.train_score.score.numpy())
