"""The validation-score tree walk and the metrics on the card, against
their CPU versions.

These tests import numpy, torch and lightgbm_torch only (no JAX), so they
run on a machine that has a card and no JAX:

    python -m pytest --noconftest -m cuda tests/test_torch_valid_cuda.py

Without a card each test skips. valid_walk (csrc/valid_walk.cu) is held
bit for bit against its plain version on the CPU (the per-level walk of
models/tree.py) on skewed trees: one split, a 255-deep chain, NaN and zero
defaults both ways, EFB-bundled groups (rows outside a feature's bin range
take its most frequent bin), a tree without a split, and a tree too large
for the kernel's shared-memory node table; two launches must agree. The
metrics run on the card's scores and on the CPU's: within 1e-12 relative
(the card's exp and log may differ from the CPU's in the last bit; the
sums add in another order). A training run with validation sets and early
stopping on the card gives the CPU's trees, record lengths and
best_iteration, and its records within 1e-12 relative.
"""
import numpy as np
import pytest
import torch

import lightgbm_torch as lp
from lightgbm_torch.config import Config
from lightgbm_torch.data.dataset import Metadata
from lightgbm_torch.metrics import create_metric
from lightgbm_torch.models.tree import Tree, kDefaultLeftMask
from lightgbm_torch.objectives import create_objective
from lightgbm_torch.ops.valid_walk import pack, valid_walk, valid_walk_plain

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (the CUDA kernels have no CPU mode)")
    return torch.device("cuda")


class Layout:
    """The per-feature metadata a node record folds in: the first
    `bundled` features share group 0 (EFB: local bin 0 is the group's
    default, each feature a bin range after it), every other feature has
    a group of its own."""

    def __init__(self, nbins, bundled, rng):
        F = len(nbins)
        groups = ([list(range(bundled))] if bundled else []) + \
            [[f] for f in range(bundled, F)]
        self.group_of = np.zeros(F, np.int32)
        self.bin_start = np.zeros(F, np.int32)
        self.bin_end = np.zeros(F, np.int32)
        offsets, widths, off = [], [], 0
        for g, feats in enumerate(groups):
            offsets.append(off)
            local = 1 if len(feats) > 1 else 0
            for f in feats:
                self.group_of[f] = g
                self.bin_start[f] = off + local
                self.bin_end[f] = off + local + nbins[f]
                local += nbins[f]
            widths.append(local)
            off += local
        self.group_offset = np.asarray(offsets, np.int32)
        self.widths = np.asarray(widths)
        self.G = len(groups)
        self.most_freq_bin = np.array([rng.integers(0, n) for n in nbins],
                                      np.int32)
        self.default_bin = np.array([rng.integers(0, n) for n in nbins],
                                    np.int32)
        self.nbins = np.asarray(nbins)

    def rows(self, n, rng, skew=False):
        """[n, G] uint8 group-local bins; skewed: most rows in bin 0."""
        b = np.stack([rng.integers(0, w, n) for w in self.widths],
                     1).astype(np.uint8)
        if skew:
            b[rng.random((n, self.G)) < 0.8] = 0
        return b


def random_tree(L, layout, rng, chain=False):
    """A tree of L leaves grown as Tree::Split numbers them: split k turns
    leaf `leaf` into internal node k (left child keeps the leaf id, right
    child is leaf k + 1); a chain always splits the newest leaf, with
    threshold bin 0 and no missing type, so most rows walk deep down it."""
    t = Tree(L)
    t.num_leaves = L
    F = len(layout.nbins)
    for k in range(L - 1):
        leaf = k if chain else int(rng.integers(0, k + 1))
        parent = t.leaf_parent[leaf]
        if parent >= 0:
            if t.left_child[parent] == ~leaf:
                t.left_child[parent] = k
            else:
                t.right_child[parent] = k
        f = int(rng.integers(0, F))
        t.split_feature_inner[k] = t.split_feature[k] = f
        t.threshold_in_bin[k] = 0 if chain else int(
            rng.integers(0, layout.nbins[f]))
        mt = 0 if chain else int(rng.integers(0, 3))
        t.decision_type[k] = (mt << 2) | (
            kDefaultLeftMask if rng.random() < 0.5 else 0)
        t.left_child[k], t.right_child[k] = ~leaf, ~(k + 1)
        t.leaf_parent[leaf] = t.leaf_parent[k + 1] = k
    t.leaf_value[:L] = rng.normal(size=L)
    return t


CASES = [
    # (name, leaves, bundled features, chain, skewed rows)
    ("one split", 2, 0, False, False),
    ("255-deep chain", 256, 0, True, False),
    ("255 leaves", 255, 0, False, False),
    ("bundled groups", 63, 5, False, True),
    ("no split", 1, 0, False, False),
    ("beyond shared memory", 1500, 3, False, False),
]


@pytest.mark.parametrize("name,L,bundled,chain,skew", CASES,
                         ids=[c[0] for c in CASES])
def test_valid_walk_matches_plain(name, L, bundled, chain, skew):
    dev = _card()
    rng = np.random.default_rng(L + bundled)
    layout = Layout(rng.integers(30, 60, 9) if chain
                    else rng.integers(2, 40, 9), bundled, rng)
    tree = random_tree(L, layout, rng, chain)
    n = 70_001
    bins = layout.rows(n, rng, skew)
    base = rng.normal(size=n)
    (pc,) = pack([tree], [tree.leaf_value[:L]], layout, "cpu")
    (pd,) = pack([tree], [tree.leaf_value[:L]], layout, dev)
    ref = torch.as_tensor(base.copy())
    valid_walk_plain(torch.as_tensor(bins), pc.nodes, pc.leaves, ref)
    bins_d = torch.as_tensor(bins, device=dev)
    outs = []
    for _ in range(2):
        s = torch.as_tensor(base, device=dev)
        before = valid_walk.launches
        valid_walk(bins_d, pd.nodes, pd.leaves, s)
        assert valid_walk.launches == before + 1
        outs.append(s.cpu())
    assert torch.equal(outs[0], ref)
    assert torch.equal(outs[1], outs[0])
    if L > 1:      # the walk reaches more than one leaf
        assert len(np.unique((ref - torch.as_tensor(base)).numpy())) > 1


def test_valid_walk_packs_many_trees_in_one_buffer():
    dev = _card()
    rng = np.random.default_rng(5)
    layout = Layout(rng.integers(2, 40, 6), 2, rng)
    trees = [random_tree(L, layout, rng) for L in (7, 1, 31, 2)]
    lvs = [t.leaf_value[:t.num_leaves] for t in trees]
    bins = layout.rows(5000, rng)
    ref = torch.zeros((len(trees), 5000), dtype=torch.float64)
    got = torch.zeros((len(trees), 5000), dtype=torch.float64, device=dev)
    for k, (pc, pd) in enumerate(zip(pack(trees, lvs, layout, "cpu"),
                                     pack(trees, lvs, layout, dev))):
        valid_walk_plain(torch.as_tensor(bins), pc.nodes, pc.leaves, ref[k])
        valid_walk(torch.as_tensor(bins, device=dev), pd.nodes, pd.leaves,
                   got[k])
    assert torch.equal(got.cpu(), ref)


METRICS = [("l2", "regression"), ("rmse", "regression"),
           ("l1", "regression"), ("quantile", "regression"),
           ("huber", "regression"), ("fair", "regression"),
           ("poisson", "poisson"), ("mape", "regression"),
           ("gamma", "gamma"), ("gamma_deviance", "gamma"),
           ("tweedie", "tweedie"), ("binary_logloss", "binary"),
           ("binary_error", "binary"), ("auc", "binary"),
           ("cross_entropy", "binary"), ("cross_entropy_lambda", "binary"),
           ("kldiv", "binary"), ("multi_logloss", "multiclass"),
           ("multi_error", "multiclass"), ("auc_mu", "multiclass")]


@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("metric,objective", METRICS,
                         ids=[m for m, _ in METRICS])
def test_metric_on_card_matches_cpu(metric, objective, weighted):
    dev = _card()
    rng = np.random.default_rng(3)
    n, K = 20_000, 3
    multi = objective == "multiclass"
    if multi:
        label = rng.integers(0, K, n).astype(np.float64)
    elif objective in ("poisson", "tweedie"):
        label = rng.poisson(2.0, n).astype(np.float64)
    elif objective == "gamma":
        label = rng.gamma(2.0, 1.0, n)
    elif metric == "kldiv":
        label = rng.random(n)
    elif objective == "binary":
        label = (rng.random(n) < 0.4).astype(np.float64)
    else:
        label = rng.normal(size=n)
    cfg = Config({"objective": objective, "num_class": K if multi else 1,
                  "multi_error_top_k": 2})
    md = Metadata(n)
    md.set_label(label)
    md.set_weight(rng.random(n) + 0.5 if weighted else None)
    score = np.round(rng.normal(size=(K, n) if multi else n), 2)
    vals = []
    for d in ("cpu", dev):
        m = create_metric(metric, cfg)
        m.init(md, n, d)
        obj = create_objective(cfg.objective, cfg)
        obj.init(md, n)
        (v,) = m.eval(torch.as_tensor(score, device=d), obj)
        assert v.device.type == torch.device(d).type and v.dim() == 0
        vals.append(float(v))
    assert np.isfinite(vals[0])
    assert abs(vals[1] - vals[0]) <= 1e-12 * abs(vals[0])


def _noisy(n, seed, f=8):
    from lightgbm_torch.data.synth import make_higgs_like
    X, y = make_higgs_like(n, seed=seed)
    X = X[:, :f].copy()
    rng = np.random.default_rng(seed)
    X[rng.random(X.shape) < 0.05] = np.nan
    return X, np.where(rng.random(n) < 0.3, 1.0 - y, y)


@pytest.mark.parametrize("route", ["force", "false"])
def test_cuda_early_stopping_matches_cpu(route):
    _card()
    X, y = _noisy(20_000, 3)
    Xv, yv = _noisy(5000, 4)
    out = {}
    for dev in ("cuda", "cpu"):
        p = {"objective": "binary", "num_leaves": 63, "learning_rate": 0.5,
             "metric": ["binary_logloss", "auc"], "verbosity": -1,
             "tpu_persist_scan": route, "device_type": dev}
        dt = lp.Dataset(X, y, params=p)
        dv = lp.Dataset(Xv, yv, reference=dt, params=p)
        rec = {}
        bst = lp.train(p, dt, 40, valid_sets=[dt, dv],
                       early_stopping_rounds=3, evals_result=rec,
                       verbose_eval=False)
        out[dev] = (bst.best_iteration, bst.num_trees(), rec,
                    bst.model_to_string(num_iteration=-1)
                    .split("parameters:")[0])
    (bc, tc, rc, mc), (bp, tp, rp, mp) = out["cuda"], out["cpu"]
    assert 0 < bc < 40 and (bc, tc) == (bp, tp) and mc == mp
    for name in ("training", "valid_1"):
        for metric in ("binary_logloss", "auc"):
            a, b = np.array(rc[name][metric]), np.array(rp[name][metric])
            assert len(a) == len(b) == tc
            np.testing.assert_allclose(a, b, rtol=1e-12, atol=0)
