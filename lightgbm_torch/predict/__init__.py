"""The inference subsystem on the card.

The port's counterpart of lightgbm_tpu/predict/, in three layers:

* :mod:`compile` — pack a trained ensemble into padded, depth-bucketed
  arrays (the JAX package's, field for field) and flatten them, trees in
  model order, for the walk kernel (host, once);
* :mod:`runtime` — :class:`CudaPredictor`: the ensemble on the device, the
  walk (``ops/predict.py``, ``csrc/predict.cu``) and the objective's output
  transform; raw f64 scores equal the numpy walk bit for bit;
* :mod:`serve`   — batching and chunking for ragged serving traffic
  (:class:`BatchServer`), fed from pinned staging buffers sized by a
  power-of-two row ladder.

Selected by ``predict_device`` (a Booster.predict keyword or a parameter):
``cuda`` (alias ``gpu``), where unset the ``device_type`` (``cuda`` by
default); ``cpu`` keeps the numpy walk of models/tree.py.
"""
from .compile import (CompiledEnsemble, EnsembleCompileError, FlatEnsemble,
                      TreeBucket, compile_ensemble, flatten, quant_spec,
                      quantize_ensemble)
from .runtime import CudaPredictor
from .serve import BatchServer, PinnedStage, place_batch

__all__ = ["CompiledEnsemble", "EnsembleCompileError", "FlatEnsemble",
           "TreeBucket", "compile_ensemble", "flatten", "quant_spec",
           "quantize_ensemble", "CudaPredictor",
           "BatchServer", "PinnedStage", "place_batch"]
