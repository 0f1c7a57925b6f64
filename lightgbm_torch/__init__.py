"""lightgbm_torch: the PyTorch / CUDA port of lightgbm_tpu.

Slice 1 of the port: the leaf-wise GBDT training path (binary objective,
dense numerical data) on an NVIDIA H100, with the histogram and split-scan
kernels written by hand in CUDA C++ (``csrc/``). The JAX package
``lightgbm_tpu`` stays beside it as the reference; this package imports
neither JAX nor anything of that package.

    import lightgbm_torch as lgb
    ds = lgb.Dataset(X, y)                       # device_type=cuda default
    bst = lgb.train({"objective": "binary"}, ds, 10)
    bst.predict(X)

``device_type=cpu`` runs the kernels' plain PyTorch versions on the host.

Validation sets, metrics, early stopping and the callbacks:

    dv = lgb.Dataset(Xv, yv, reference=ds)
    rec = {}
    bst = lgb.train(params, ds, 100, valid_sets=[ds, dv],
                    early_stopping_rounds=5, evals_result=rec)
"""
from .basic import Booster, Dataset
from .callback import (EarlyStopException, early_stopping, print_evaluation,
                       record_evaluation, reset_parameter)
from .config import Config
from .engine import train
from .utils.log import LightGBMError, Log

__all__ = ["Booster", "Config", "Dataset", "EarlyStopException",
           "LightGBMError", "Log", "early_stopping", "print_evaluation",
           "record_evaluation", "reset_parameter", "train"]
__version__ = "0.1.0"
