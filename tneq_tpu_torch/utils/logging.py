"""Colored, rank-prefixed logging.

Equivalent of the reference's ``log_utils.py`` (``ColoredFormatter``,
``setup_colored_logger`` with ``[Rank n]`` prefixes) and the ANSI palette of
``callbacks.py:5-25``.  Counterpart of ``tneq_tpu/utils/logging.py``, where
the prefix is JAX's process index; here it is the ``torch.distributed``
rank when a process group is up, else 0.
"""

from __future__ import annotations

import logging
import sys
from typing import Optional

import torch.distributed as dist

__all__ = ["Colors", "setup_logger", "setup_colored_logger"]


class Colors:
    RESET = "\033[0m"
    RED = "\033[31m"
    GREEN = "\033[32m"
    YELLOW = "\033[33m"
    BLUE = "\033[34m"
    MAGENTA = "\033[35m"
    CYAN = "\033[36m"

    @staticmethod
    def wrap(color: str, text: str) -> str:
        return f"{color}{text}{Colors.RESET}"


_LEVEL_COLORS = {
    logging.DEBUG: Colors.CYAN,
    logging.INFO: Colors.GREEN,
    logging.WARNING: Colors.YELLOW,
    logging.ERROR: Colors.RED,
    logging.CRITICAL: Colors.MAGENTA,
}


class ColoredFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        color = _LEVEL_COLORS.get(record.levelno)
        return Colors.wrap(color, msg) if color else msg


def setup_logger(
    name: str = "tneq_tpu",
    level: int = logging.INFO,
    stream=None,
) -> logging.Logger:
    """Plain logger (reference ``setup_simple_logger``)."""
    logger = logging.getLogger(name)
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(stream or sys.stderr)
        handler.setFormatter(
            logging.Formatter("%(asctime)s %(name)s %(levelname)s: %(message)s")
        )
        logger.addHandler(handler)
    return logger


def setup_colored_logger(
    name: str = "tneq_tpu",
    rank: Optional[int] = None,
    level: int = logging.INFO,
) -> logging.Logger:
    """Colored logger with a rank prefix (reference
    ``setup_colored_logger``, ``log_utils.py:62-103``).  ``rank`` defaults to
    ``torch.distributed.get_rank()`` when a process group is up, else 0."""
    if rank is None:
        rank = dist.get_rank() if dist.is_available() and dist.is_initialized() else 0
    logger = logging.getLogger(f"{name}.r{rank}")
    logger.setLevel(level)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            ColoredFormatter(
                f"%(asctime)s [Rank {rank}] %(levelname)s: %(message)s"
            )
        )
        logger.addHandler(handler)
    return logger
