"""Tree learners of the port (serial in this slice)."""
from .serial import ColSampler, SerialTreeLearner, check_fast_path

__all__ = ["ColSampler", "SerialTreeLearner", "check_fast_path"]
