"""Tree model of the port."""
from .tree import Tree

__all__ = ["Tree"]
