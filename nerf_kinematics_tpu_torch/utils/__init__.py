"""Utilities: structured logging, numerical guards, timing, FLOP counts."""

from .logging import get_logger, progress, success

__all__ = ["get_logger", "success", "progress"]
