"""Carrying state across from the JAX package.

The two packages share no code, so what one produced reaches the other as
plain data:

  * :func:`booster_from_reference` loads LightGBM model text written by the
    JAX package (``model_to_string``) into a port Booster;
  * :func:`dataset_from_reference` builds the port's binned dataset from the
    numpy arrays of a JAX ``BinnedDataset``, so both packages grow trees on
    identical bins.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from .basic import Booster
from .data.dataset import BinnedDataset


def booster_from_reference(model_text: str) -> Booster:
    """A port Booster from the JAX package's model text."""
    return Booster(model_str=model_text)


def dataset_from_reference(arrays: Dict[str, np.ndarray]) -> BinnedDataset:
    """A port BinnedDataset from a JAX BinnedDataset's arrays: ``bins``
    (its ``binned`` matrix), ``group_offset``, ``bin_start``, ``bin_end``,
    ``missing_type`` (its ``missing_type_arr``), ``default_bin``,
    ``most_freq_bin`` and optionally ``label``."""
    return BinnedDataset.from_arrays(
        arrays["bins"], arrays["group_offset"], arrays["bin_start"],
        arrays["bin_end"], arrays["missing_type"], arrays["default_bin"],
        arrays["most_freq_bin"], label=arrays.get("label"))
