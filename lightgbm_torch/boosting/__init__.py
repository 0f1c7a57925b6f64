"""Boosting drivers of the port: gbdt, dart, goss and rf."""
from ..utils.log import Log
from .dart import DART
from .gbdt import GBDT
from .goss import GOSS
from .rf import RF

__all__ = ["GBDT", "DART", "GOSS", "RF", "create_boosting"]


def create_boosting(boosting_type: str) -> GBDT:
    """The driver of a boosting type (the JAX package's create_boosting)."""
    cls = {"gbdt": GBDT, "dart": DART, "goss": GOSS, "rf": RF}.get(
        boosting_type)
    if cls is None:
        Log.fatal("Unknown boosting type %s" % boosting_type)
    return cls()
