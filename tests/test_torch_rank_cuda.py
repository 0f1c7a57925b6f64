"""The ranking kernels and ranking training on the card, against the CPU.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_rank_cuda.py

  * ``lambdarank_grad`` and ``xendcg_grad`` against their plain versions
    on inputs made with numpy: one-document queries, queries whose labels
    are all 0, tied scores, -0.0 beside +0.0, queries longer than the
    kernel's shared-memory capacity (1024 rows: those read device memory),
    with and without weights, lambdarank with norm on and off and sigmoid
    1 and 2. Against the plain version on the card (the same exp and log2)
    bit for bit, and two launches agree; against the plain version on the
    CPU equal, or 1 f32 ulp apart in at most 1 of 1000 values (where the
    card's f64 exp or log2 rounds its last bit unlike the host's); the
    device counter counts one per launch;
  * training on the card against the CPU, model text equal: lambdarank on
    the persistent (``force``) and v1 (``off``) growers with weights, and
    rank_xendcg on v1 (4 iterations, 63 leaves, 20k make_ltr_like rows cut
    into seeded variable-length queries).

Without a card each test skips.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.data.synth import make_ltr_like
from lightgbm_torch.metrics.dcg import default_label_gain, discounts
from lightgbm_torch.ops import counters
from lightgbm_torch.ops.rank import (LR_SMEM_ROWS, QueryPlan,
                                     lambdarank_grad, xendcg_grad)

pytestmark = pytest.mark.cuda

SIZES = (1, 1, 2, 5, 73, 73, 0, 300, LR_SMEM_ROWS, LR_SMEM_ROWS + 1, 1250,
         7, 1)


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")


def rank_inputs(seed, sizes=SIZES):
    """Host inputs of both kernels: boundaries, int labels (query 2 all 0),
    gains, inverse max DCGs, scores with ties and -0.0, weights, draws."""
    rng = np.random.default_rng(seed)
    qb = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    n = int(qb[-1])
    lab = rng.integers(0, 5, n).astype(np.int32)
    lab[qb[2]:qb[3]] = 0
    gain = default_label_gain()[lab]
    inv = 1.0 / (1.0 + rng.random(len(sizes)) * 20)
    inv[2] = 0.0
    score = np.round(rng.normal(size=n) * 2, 1)
    score[rng.random(n) < 0.1] = 0.0
    score[rng.random(n) < 0.05] = -0.0
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    rnd = (rng.integers(0, 32768, n) / 32768.0).astype(np.float64)
    return dict(qb=qb, lab=lab, gain=gain, inv=inv, score=score, w=w,
                rnd=rnd)


def assert_f32_close(a, b, what):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    ne = a != b
    assert ne.sum() <= max(1, a.size // 1000), (what, int(ne.sum()))
    assert np.all(np.abs(a - b) <= np.spacing(np.maximum(np.abs(a),
                                                         np.abs(b)))), what


def _lambdarank(t, dev, weighted, sigmoid, norm):
    plan = QueryPlan(t["qb"], dev)
    on = {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
    return lambdarank_grad(on["score"], on["lab"], on["gain"], on["inv"],
                           discounts(plan.max_len, dev),
                           on["w"] if weighted else None, plan, sigmoid,
                           norm)


@pytest.mark.parametrize("sigmoid,norm", [(1.0, True), (1.0, False),
                                          (2.0, True)])
@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_lambdarank_grad_matches_plain(weighted, sigmoid, norm):
    _card()
    t = rank_inputs(int(sigmoid * 10) + 2 * norm + weighted)
    counters.reset("cuda")
    a = _lambdarank(t, "cuda", weighted, sigmoid, norm)
    b = _lambdarank(t, "cuda", weighted, sigmoid, norm)
    assert counters.read("cuda")["lambdarank_grad"] == 2
    torch.cuda.synchronize()
    from lightgbm_torch.ops.rank import lambdarank_grad_plain
    plan = QueryPlan(t["qb"], "cuda")
    on = {k: torch.as_tensor(v, device="cuda") for k, v in t.items()}
    g = torch.full((len(t["lab"]),), 7.0, device="cuda")
    h = g.clone()
    lambdarank_grad_plain(on["score"], on["lab"], on["gain"], on["inv"],
                          discounts(plan.max_len, "cuda"),
                          on["w"] if weighted else None, plan, sigmoid,
                          norm, g, h)
    cpu = _lambdarank(t, "cpu", weighted, sigmoid, norm)
    for i, what in enumerate(("grad", "hess")):
        assert torch.equal(a[i], b[i]), what
        assert torch.equal(a[i], (g, h)[i]), what
        assert_f32_close(a[i], cpu[i], what)
        assert torch.isfinite(a[i]).all()
    # the all-zero query and one-document queries get zero gradients
    qb = t["qb"]
    assert not a[0][qb[2]:qb[3]].any() and float(a[0][0]) == 0.0


@pytest.mark.parametrize("weighted", [False, True],
                         ids=["unweighted", "weighted"])
def test_xendcg_grad_matches_plain(weighted):
    _card()
    t = rank_inputs(40 + weighted)
    out = {}
    for dev in ("cuda", "cpu"):
        plan = QueryPlan(t["qb"], dev)
        on = {k: torch.as_tensor(v, device=dev) for k, v in t.items()}
        out[dev] = xendcg_grad(on["score"], on["lab"].float(), on["rnd"],
                               on["w"] if weighted else None, plan)
    counters.reset("cuda")
    plan = QueryPlan(t["qb"], "cuda")
    on = {k: torch.as_tensor(v, device="cuda") for k, v in t.items()}
    again = xendcg_grad(on["score"], on["lab"].float(), on["rnd"],
                        on["w"] if weighted else None, plan)
    assert counters.read("cuda")["xendcg_grad"] == 1
    for i, what in enumerate(("grad", "hess")):
        assert torch.equal(out["cuda"][i], again[i]), what
        assert_f32_close(out["cuda"][i], out["cpu"][i], what)


def rank_rows(n, seed, f=24):
    X, y, _ = make_ltr_like(n, n_feat=f, docs_per_query=50, seed=seed)
    rng = np.random.default_rng(seed)
    sizes = []
    while sum(sizes) < len(y):
        sizes.append(min(int(rng.integers(1, 120)), len(y) - sum(sizes)))
    return X, y, np.asarray(sizes)


@pytest.mark.parametrize("objective,route,weighted", [
    ("lambdarank", "force", True), ("lambdarank", "off", True),
    ("rank_xendcg", "off", False)])
def test_cuda_ranking_training_matches_cpu(objective, route, weighted):
    _card()
    X, y, g = rank_rows(20_000, 17)
    w = (np.random.default_rng(18).uniform(0.5, 2.0, len(y)) if weighted
         else None)
    text = {}
    for dev in ("cuda", "cpu"):
        p = {"objective": objective, "num_leaves": 63, "max_bin": 63,
             "min_data_in_leaf": 20, "learning_rate": 0.2,
             "tpu_persist_scan": route, "device_type": dev,
             "verbosity": -1}
        bst = lp.train(p, lp.Dataset(X, y, weight=w, group=g, params=p), 4)
        assert bst._booster.use_persist == (route == "force")
        text[dev] = bst.model_to_string().split("parameters:")[0]
    assert text["cuda"] == text["cpu"]
