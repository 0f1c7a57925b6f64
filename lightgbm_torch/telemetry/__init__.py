"""Instance-local serving statistics (the port's copy of the JAX package's
``telemetry.histo.Histogram``)."""
from .histo import Histogram

__all__ = ["Histogram"]
