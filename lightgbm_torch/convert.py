"""Carrying state across from the JAX package.

The two packages share no code, so what one produced reaches the other as
plain data:

  * :func:`booster_from_reference` loads LightGBM model text written by the
    JAX package (``model_to_string``) into a port Booster;
  * :func:`dataset_from_reference` builds the port's binned dataset from the
    numpy arrays of a JAX ``BinnedDataset``, so both packages grow trees on
    identical bins;
  * :func:`assets_from_reference` turns the JAX package's persistent-payload
    assets (``grow_persist.PersistAssets``) into the port's, so both
    packages' payload kernels and growers run on the same payload.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .basic import Booster
from .data.dataset import BinnedDataset
from .ops.payload import PersistAssets


def booster_from_reference(model_text: str, params=None) -> Booster:
    """A port Booster from the JAX package's model text (with `params`:
    ``{"device_type": "cpu"}`` predicts with the numpy walk)."""
    return Booster(params=params, model_str=model_text)


def dataset_from_reference(arrays: Dict[str, np.ndarray]) -> BinnedDataset:
    """A port BinnedDataset from a JAX BinnedDataset's arrays: ``bins``
    (its ``binned`` matrix), ``group_offset``, ``bin_start``, ``bin_end``,
    ``missing_type`` (its ``missing_type_arr``), ``default_bin``,
    ``most_freq_bin`` and optionally ``label``."""
    return BinnedDataset.from_arrays(
        arrays["bins"], arrays["group_offset"], arrays["bin_start"],
        arrays["bin_end"], arrays["missing_type"], arrays["default_bin"],
        arrays["most_freq_bin"], label=arrays.get("label"))


def assets_from_reference(jax_assets) -> PersistAssets:
    """The port's PersistAssets from the JAX package's: the uint32 ``pay0``
    (a host array there too) and the per-feature decode arrays as numpy,
    the geometry and the EFB layout as they are. Only the f32-score layout
    (``score64=False``) has a counterpart in the port."""
    geometry = tuple(jax_assets.geometry)
    if len(geometry) > 10 and geometry[10]:
        raise ValueError("score64 payloads (the JAX package's widened XLA "
                         "mode) have no counterpart in the port")

    def i32(a):
        return np.asarray(a, dtype=np.int32)
    return PersistAssets(
        pay0=np.asarray(jax_assets.pay0, dtype=np.uint32),
        dec_word=i32(jax_assets.dec_word), dec_shift=i32(jax_assets.dec_shift),
        dec_mask=i32(jax_assets.dec_mask), nb=i32(jax_assets.nb),
        mt=i32(jax_assets.mt), db=i32(jax_assets.db), ls=i32(jax_assets.ls),
        le=i32(jax_assets.le), mf=i32(jax_assets.mf), geometry=geometry,
        efb=tuple(np.asarray(a) if isinstance(a, np.ndarray) else a
                  for a in jax_assets.efb))
