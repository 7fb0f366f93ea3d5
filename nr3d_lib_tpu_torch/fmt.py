"""Colored, rank-aware console logging (port of nr3d_lib_tpu/fmt.py): only
the master process (`parallel.is_master`) prints below WARNING."""

from __future__ import annotations

import logging
import sys

__all__ = ["log", "colored_str", "GREEN", "RED", "YELLOW", "CYAN", "BOLD"]

GREEN = "\033[92m"
RED = "\033[91m"
YELLOW = "\033[93m"
CYAN = "\033[96m"
BOLD = "\033[1m"
_RESET = "\033[0m"

_LEVEL_COLORS = {
    logging.DEBUG: CYAN,
    logging.INFO: GREEN,
    logging.WARNING: YELLOW,
    logging.ERROR: RED,
    logging.CRITICAL: RED + BOLD,
}


def colored_str(msg: str, color: str) -> str:
    return f"{color}{msg}{_RESET}"


class _ColorFormatter(logging.Formatter):
    def format(self, record):
        color = _LEVEL_COLORS.get(record.levelno, "")
        prefix = colored_str(f"[{record.levelname}]", color)
        return f"{prefix} {self.formatTime(record, '%H:%M:%S')} " \
            f"{record.getMessage()}"


class _MasterOnlyFilter(logging.Filter):
    def filter(self, record):
        from nr3d_lib_tpu_torch.parallel import is_master

        return is_master() or record.levelno >= logging.WARNING


def _build_logger() -> logging.Logger:
    logger = logging.getLogger("nr3d_torch")
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(_ColorFormatter())
        handler.addFilter(_MasterOnlyFilter())
        logger.addHandler(handler)
        logger.setLevel(logging.INFO)
        logger.propagate = False
    return logger


log = _build_logger()
