"""Leveled logger (counterpart of kaminpar_tpu/utils/logger.py;
kaminpar-common/logger.{h,cc}).

LOG / LOG_WARNING / LOG_ERROR with a process-global OutputLevel, as in
include/kaminpar-shm/kaminpar.h:32-38.  The logger is this package's own
(`kaminpar_tpu_torch`), so its level never touches the JAX package's.
"""

from __future__ import annotations

import enum
import logging
import sys


class OutputLevel(enum.IntEnum):
    """Mirrors kaminpar::OutputLevel (include/kaminpar-shm/kaminpar.h:32-38)."""

    QUIET = 0
    PROGRESS = 1
    APPLICATION = 2
    EXPERIMENT = 3
    DEBUG = 4


class _DynamicStderrHandler(logging.StreamHandler):
    """Resolves sys.stderr at emit time (it may be redirected later)."""

    def __init__(self):
        super().__init__(stream=None)

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):  # base __init__ assigns; ignore
        pass


_LOGGER = logging.getLogger("kaminpar_tpu_torch")
if not _LOGGER.handlers:
    handler = _DynamicStderrHandler()
    handler.setFormatter(logging.Formatter("[kaminpar-tpu-torch] %(message)s"))
    _LOGGER.addHandler(handler)
    # default OutputLevel is APPLICATION, so INFO must pass through
    _LOGGER.setLevel(logging.INFO)
    _LOGGER.propagate = False

_OUTPUT_LEVEL = OutputLevel.APPLICATION


def set_output_level(level: OutputLevel) -> None:
    global _OUTPUT_LEVEL
    _OUTPUT_LEVEL = OutputLevel(level)
    _LOGGER.setLevel(
        logging.ERROR
        if level == OutputLevel.QUIET
        else logging.INFO
        if level < OutputLevel.DEBUG
        else logging.DEBUG
    )


def output_level() -> OutputLevel:
    return _OUTPUT_LEVEL


def log(msg: str) -> None:
    if _OUTPUT_LEVEL >= OutputLevel.APPLICATION:
        _LOGGER.info(msg)


def log_progress(msg: str) -> None:
    if _OUTPUT_LEVEL >= OutputLevel.PROGRESS:
        _LOGGER.info(msg)


def log_debug(msg: str) -> None:
    if _OUTPUT_LEVEL >= OutputLevel.DEBUG:
        _LOGGER.debug(msg)


def log_warning(msg: str) -> None:
    _LOGGER.warning("Warning: %s", msg)


def log_error(msg: str) -> None:
    _LOGGER.error("Error: %s", msg)
