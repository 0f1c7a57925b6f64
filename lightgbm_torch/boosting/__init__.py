"""Boosting drivers of the port: gbdt and goss."""
from .gbdt import GBDT
from .goss import GOSS

__all__ = ["GBDT", "GOSS", "create_boosting"]


def create_boosting(boosting_type: str) -> GBDT:
    """The driver of a boosting type (the JAX package's create_boosting);
    the tree learner refuses the types not ported (dart, rf)."""
    return GOSS() if boosting_type == "goss" else GBDT()
