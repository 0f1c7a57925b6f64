"""Device-resident batched prediction runtime.

The port's counterpart of lightgbm_tpu/predict/runtime.py: a
:class:`CudaPredictor` puts a :class:`CompiledEnsemble` on its device once
(ops/predict.py:upload) and serves batches with one launch of the walk
kernel (``csrc/predict.cu``), then the objective's ``convert_output`` on
the device output (every objective converts torch tensors: sigmoid,
softmax, exp, reg_sqrt's sign * r^2, log1p(exp(r))).

The walk reproduces models/tree.py:_decision exactly, and the raw f64
scores equal the numpy walk (GBDT.predict_raw) bit for bit: each class
sums its trees' leaf values from +0.0 in model order. ``dtype='f32'``
walks f32 rows against f32 thresholds and sums in f32, as the JAX
package's f32 mode: a row whose value lies between a threshold and its
f32 rounding takes the other branch; the others stay within 1e-6 of f64
on the tests' models.

The device is explicit: ``cuda`` (a card; without one the constructor
raises) or ``cpu``, where the walk is its plain PyTorch version (the
tests' predictor). The kernel takes any row count, so rows are walked as
given, with no padding; serve.BatchServer adds chunking.
"""
from __future__ import annotations

import numpy as np
import torch

from ..ops.predict import predict_walk, upload
from ..utils.log import LightGBMError
from .compile import CompiledEnsemble, EnsembleCompileError, flatten


def predict_device(device) -> torch.device:
    """`device` as a torch.device with an index (the current card for a
    bare ``cuda``); raises for a card that is not there."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise LightGBMError(
                "predict on cuda but torch.cuda.is_available() is False; "
                "pass device_type=cpu (or predict_device=cpu) to predict "
                "with the numpy walk on the host")
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
    elif device.type != "cpu":
        raise LightGBMError("no prediction kernel for device %s" % device)
    return device


class CudaPredictor:
    """Serve batched predictions for one compiled ensemble on one device.

    One instance keeps the ensemble tensors on the device; :meth:`predict`
    copies the rows there and runs the walk. :meth:`dispatch_padded` and
    :meth:`finalize_padded` split a batch at its one host copy, so that a
    server can build the next batch while this one runs
    (serving/server.py). Their names are the JAX package's; a batch may
    carry rows past ``n_valid``, which are dropped.
    """

    def __init__(self, ensemble: CompiledEnsemble, objective=None,
                 dtype: str = "f64", device="cuda"):
        if ensemble.num_trees % ensemble.num_tree_per_iteration != 0:
            raise EnsembleCompileError(
                "tree count %d is not a multiple of num_tree_per_iteration"
                " %d" % (ensemble.num_trees, ensemble.num_tree_per_iteration))
        if dtype not in ("f64", "f32"):
            raise LightGBMError("unknown predict dtype %r (f64 or f32)"
                                % (dtype,))
        self.ensemble = ensemble
        self.objective = objective
        self.num_class = ensemble.num_tree_per_iteration
        self.num_features = ensemble.max_feature_idx + 1
        self.device = predict_device(device)
        self.dtype = torch.float32 if dtype == "f32" else torch.float64
        self.np_dtype = np.float32 if dtype == "f32" else np.float64
        self.walk = upload(flatten(ensemble), self.dtype, self.device)

    # -- device side ---------------------------------------------------
    def _check_rows(self, X_dev: torch.Tensor) -> None:
        if X_dev.device != self.device or X_dev.dim() != 2 \
                or X_dev.shape[1] < self.num_features:
            raise LightGBMError(
                "predict: rows must be a [n, >= %d] tensor on %s (got %s "
                "on %s)" % (self.num_features, self.device,
                            list(X_dev.shape), X_dev.device))

    def dispatch_padded(self, X_dev: torch.Tensor,
                        raw_score: bool = False) -> torch.Tensor:
        """Queue the walk and the objective's conversion for device rows
        [n, F] on the current stream WITHOUT waiting: returns the [n, K]
        device output. Pair with :meth:`finalize_padded`."""
        self._check_rows(X_dev)
        out = predict_walk(X_dev, self.walk, self.num_class,
                           self.ensemble.average_output)
        if raw_score or self.objective is None:
            return out
        if self.num_class == 1:
            return self.objective.convert_output(out[:, 0])[:, None]
        return self.objective.convert_output(out)

    def finalize_padded(self, out: torch.Tensor,
                        n_valid: int) -> np.ndarray:
        """The host side of a :meth:`dispatch_padded` result (a device
        tensor, or its copy already on the host): the one device-to-host
        copy of its first `n_valid` rows. [n_valid] for one class, else
        [n_valid, K]."""
        res = out[:n_valid].cpu().numpy()
        return res[:, 0] if self.num_class == 1 else res

    def predict_padded(self, X_dev: torch.Tensor, n_valid: int,
                       raw_score: bool = False) -> np.ndarray:
        """Device rows [n, F] -> host predictions of the first `n_valid`:
        dispatch and finalize at once (serve.BatchServer)."""
        return self.finalize_padded(
            self.dispatch_padded(X_dev, raw_score=raw_score), n_valid)

    # -- host API -------------------------------------------------------
    def _upload_rows(self, X) -> torch.Tensor:
        """The rows on the device in the walk's dtype, copied once."""
        X = np.ascontiguousarray(X, dtype=self.np_dtype)
        if X.ndim == 1:
            X = X.reshape(1, -1)
        return torch.from_numpy(X).to(self.device)

    def predict(self, X, raw_score: bool = False) -> np.ndarray:
        X_dev = self._upload_rows(X)
        return self.predict_padded(X_dev, X_dev.shape[0],
                                   raw_score=raw_score)

    def predict_leaf(self, X) -> np.ndarray:
        """[n, T] int32 leaf indices (pred_leaf)."""
        X_dev = self._upload_rows(X)
        self._check_rows(X_dev)
        return predict_walk(X_dev, self.walk, self.num_class,
                            leaf=True).cpu().numpy()
