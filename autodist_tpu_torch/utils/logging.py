"""Singleton framework logger: timestamped file under the working dir + stderr.

Counterpart of ``autodist_tpu/utils/logging.py``: PID-tagged format, level
from ``AUTODIST_MIN_LOG_LEVEL``.
"""
import logging as _pylogging
import os
import sys
import time

from autodist_tpu_torch import const

_LOGGER_NAME = "autodist_tpu_torch"
_logger = None
_logger_pid = None


def _build_logger():
    logger = _pylogging.getLogger(_LOGGER_NAME)
    logger.propagate = False
    level = const.ENV.AUTODIST_MIN_LOG_LEVEL.val.upper()
    logger.setLevel(getattr(_pylogging, level, _pylogging.INFO))
    fmt = _pylogging.Formatter(
        fmt="%(asctime)s %(levelname)s [pid %(process)d] %(filename)s:%(lineno)d] %(message)s")
    # A rebuild (fork, tests resetting the singleton) gets the same logger
    # object back: drop the old handlers so lines are not duplicated.
    for h in list(logger.handlers):
        logger.removeHandler(h)
        h.close()
    stream = _pylogging.StreamHandler(sys.stderr)
    stream.setFormatter(fmt)
    logger.addHandler(stream)
    try:
        const.ensure_working_dirs()
        path = os.path.join(const.DEFAULT_LOG_DIR,
                            time.strftime("log_%Y%m%d_%H%M%S_") + str(os.getpid()) + ".txt")
        fh = _pylogging.FileHandler(path)
        fh.setFormatter(fmt)
        logger.addHandler(fh)
    except OSError:
        pass  # read-only filesystems: stderr only
    return logger


def get_logger():
    global _logger, _logger_pid
    if _logger is None or _logger_pid != os.getpid():
        _logger = _build_logger()
        _logger_pid = os.getpid()
    return _logger


def debug(msg, *args, **kwargs):
    get_logger().debug(msg, *args, **kwargs)


def info(msg, *args, **kwargs):
    get_logger().info(msg, *args, **kwargs)


def warning(msg, *args, **kwargs):
    get_logger().warning(msg, *args, **kwargs)


def error(msg, *args, **kwargs):
    get_logger().error(msg, *args, **kwargs)


def set_verbosity(level):
    get_logger().setLevel(level)
