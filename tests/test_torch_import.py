"""The port stands alone: no JAX, nothing of the JAX package, and no quiet
CPU fallback on its CUDA paths."""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import lightgbm_torch as lgb
from lightgbm_torch.utils.log import LightGBMError

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "lightgbm_torch")


def test_import_leaves_jax_out():
    code = ("import sys, lightgbm_torch, lightgbm_torch.engine, "
            "lightgbm_torch.convert, lightgbm_torch.ops.grow, "
            "lightgbm_torch.ops.grow_persist, lightgbm_torch.ops.payload, "
            "lightgbm_torch.ops.payload_kernels, lightgbm_torch.ops.build, "
            "lightgbm_torch.ops.block_scan, lightgbm_torch.ops.predict, "
            "lightgbm_torch.predict, lightgbm_torch.predict.serve, "
            "lightgbm_torch.serving, lightgbm_torch.serving.registry, "
            "lightgbm_torch.telemetry; "
            "bad = [m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m.startswith('lightgbm_tpu')]; "
            "print(bad); sys.exit(1 if bad else 0)")
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(
    [os.path.join(d, f) for d, _, fs in os.walk(PKG) for f in fs
     if f.endswith(".py")] + [os.path.join(REPO, "chip_smoke.py")]))
def test_no_jax_import_statement(path):
    mods = list(_imports(path))
    assert not [m for m in mods
                if m.split(".")[0] in ("jax", "jaxlib", "lightgbm_tpu")]


def test_cuda_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.random.default_rng(0).normal(size=(200, 3))
    y = (X[:, 0] > 0).astype(float)
    with pytest.raises(LightGBMError, match="device_type=cpu"):
        lgb.Dataset(X, y).construct()
    with pytest.raises(LightGBMError, match="device_type=cpu"):
        lgb.train({"objective": "binary"}, lgb.Dataset(X, y), 1)
    # asking for the CPU is fine
    lgb.Dataset(X, y, params={"device_type": "cpu"}).construct()


def test_gpu_is_an_alias_of_cuda():
    assert lgb.Config({"device": "gpu"}).device_type == "cuda"
    assert lgb.Config({}).device_type == "cuda"
    with pytest.raises(LightGBMError):
        lgb.Config({"device_type": "tpu"})
