"""Host utilities of the PyTorch port."""
from .log import LightGBMError, Log

__all__ = ["LightGBMError", "Log"]
