"""Objective functions of the port (binary in this slice)."""
from .base import ObjectiveFunction, create_objective, parse_objective_string

__all__ = ["ObjectiveFunction", "create_objective", "parse_objective_string"]
