"""Log-level convention (reference pkg/consts/consts.go:24-29).

A copy of the JAX package's ``consts.py``; the port imports nothing of
that package.

The reference maps logr V-levels to zap's inverted scale: Error=-2,
Warning=-1, Info=0, Debug=1. Python's logging uses the opposite ordering;
:func:`v_level_to_logging` converts so consumers porting operators keep their
verbosity semantics, and :func:`setup_logging` configures the root logger the
way the reference's zap defaults would.
"""

import logging

# logr-style V-levels (reference values)
LOG_LEVEL_ERROR = -2
LOG_LEVEL_WARNING = -1
LOG_LEVEL_INFO = 0
LOG_LEVEL_DEBUG = 1

_V_TO_PY = {
    LOG_LEVEL_ERROR: logging.ERROR,
    LOG_LEVEL_WARNING: logging.WARNING,
    LOG_LEVEL_INFO: logging.INFO,
    LOG_LEVEL_DEBUG: logging.DEBUG,
}


def v_level_to_logging(v: int) -> int:
    """Map a logr V-level to a Python logging level (clamped)."""
    if v <= LOG_LEVEL_ERROR:
        return logging.ERROR
    if v >= LOG_LEVEL_DEBUG:
        return logging.DEBUG
    return _V_TO_PY[v]


def setup_logging(v_level: int = LOG_LEVEL_INFO) -> None:
    """Configure root logging at the given logr verbosity."""
    logging.basicConfig(
        level=v_level_to_logging(v_level),
        format="%(asctime)s %(levelname)s %(name)s %(message)s")
