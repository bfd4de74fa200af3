"""Structured logging with the reference's level scheme.

Reference: qylog with levels -1(dbg)..3(fatal), pluggable sink via
QY265SetLogPrintf (SURVEY.md 2.1 "Logging", 5.5). We keep the numeric levels
for CLI compatibility and expose a set_log_printf-style hook, but back it
with Python logging.
"""

from __future__ import annotations

import logging
import sys
from typing import Callable

_LEVEL_MAP = {-1: logging.DEBUG, 0: logging.INFO, 1: logging.WARNING,
              2: logging.ERROR, 3: logging.CRITICAL}

logger = logging.getLogger("ks265codec_tpu")
_handler = logging.StreamHandler(sys.stderr)
_handler.setFormatter(logging.Formatter("%(message)s"))
logger.addHandler(_handler)
logger.setLevel(logging.INFO)

_sink: Callable[[int, str], None] | None = None


def set_log_level(level: int) -> None:
    """level: -1 dbg, 0 info, 1 warn, 2 err, 3 fatal (reference semantics)."""
    logger.setLevel(_LEVEL_MAP.get(level, logging.INFO))


def set_log_printf(fn: Callable[[int, str], None] | None) -> None:
    """Pluggable sink, analogous to QY265SetLogPrintf (qy265def.h:188)."""
    global _sink
    _sink = fn


def log(level: int, msg: str) -> None:
    if _sink is not None:
        _sink(level, msg)
    logger.log(_LEVEL_MAP.get(level, logging.INFO), msg)
