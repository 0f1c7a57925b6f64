"""Logging with LightGBM-style levels (Fatal/Warning/Info/Debug).

The port's own copy of the JAX package's logger (lightgbm_tpu/utils/log.py):
a tiny static-level logger with a pluggable callback. Fatal raises
:class:`LightGBMError`.
"""
from __future__ import annotations

import sys
from typing import Callable, Optional


class LightGBMError(Exception):
    """Raised on fatal errors (reference: Log::Fatal throws std::runtime_error)."""


class Log:
    FATAL = -1
    WARNING = 0
    INFO = 1
    DEBUG = 2

    _level: int = INFO
    _callback: Optional[Callable[[str], None]] = None

    @classmethod
    def reset_level(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def reset_callback(cls, callback: Optional[Callable[[str], None]]) -> None:
        cls._callback = callback

    @classmethod
    def _write(cls, level_str: str, msg: str) -> None:
        text = "[LightGBM-Torch] [%s] %s\n" % (level_str, msg)
        if cls._callback is not None:
            cls._callback(text)
        else:
            sys.stderr.write(text)
            sys.stderr.flush()

    @classmethod
    def debug(cls, msg: str, *args) -> None:
        if cls._level >= cls.DEBUG:
            cls._write("Debug", msg % args if args else msg)

    @classmethod
    def info(cls, msg: str, *args) -> None:
        if cls._level >= cls.INFO:
            cls._write("Info", msg % args if args else msg)

    @classmethod
    def warning(cls, msg: str, *args) -> None:
        if cls._level >= cls.WARNING:
            cls._write("Warning", msg % args if args else msg)

    @classmethod
    def fatal(cls, msg: str, *args) -> None:
        text = msg % args if args else msg
        cls._write("Fatal", text)
        raise LightGBMError(text)
