"""Host data layer of the port: binning, the binned dataset, synthetic data."""
from .bin_mapper import BinMapper, MissingType
from .dataset import BinnedDataset, DeviceData, Metadata
from .synth import make_higgs_like

__all__ = ["BinMapper", "MissingType", "BinnedDataset", "DeviceData",
           "Metadata", "make_higgs_like"]
