"""Boosting drivers of the port (gbdt in this slice)."""
from .gbdt import GBDT

__all__ = ["GBDT"]
