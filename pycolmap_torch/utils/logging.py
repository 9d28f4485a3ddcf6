"""Logging facade (API parity: pycolmap/main.cc:21-89 glog binding).

The reference binds glog with severity levels, log_dir, and Python-callsite
attribution. Here we wrap stdlib logging with the same surface:
``logging.info/warning/error/fatal`` of this module plus the flag-style
attributes (minloglevel, alsologtostderr, log_dir). Port of
``pycolmap_tpu/utils/logging.py``; the logger is named ``pycolmap_torch``.
"""

from __future__ import annotations

import logging as _py_logging
import os
import sys

_logger = None


def get_logger():
    global _logger
    if _logger is None:
        _logger = _py_logging.getLogger("pycolmap_torch")
        if not _logger.handlers:
            handler = _py_logging.StreamHandler(sys.stderr)
            handler.setFormatter(
                _py_logging.Formatter("%(levelname).1s%(asctime)s %(message)s", "%m%d %H:%M:%S")
            )
            _logger.addHandler(handler)
        _logger.setLevel(_py_logging.INFO)
    return _logger


class _LoggingModule:
    """Mirrors the pycolmap.logging interface (main.cc:39-89)."""

    INFO = 0
    WARNING = 1
    ERROR = 2
    FATAL = 3

    def __init__(self):
        self.log_dir = ""
        self.logtostderr = False
        self.alsologtostderr = True
        self._minloglevel = 0

    @property
    def minloglevel(self):
        return self._minloglevel

    @minloglevel.setter
    def minloglevel(self, level):
        self._minloglevel = level
        get_logger().setLevel(
            [_py_logging.INFO, _py_logging.WARNING, _py_logging.ERROR,
             _py_logging.CRITICAL][max(0, min(3, int(level)))]
        )

    @property
    def verbose_level(self):
        return 0 if self._minloglevel > 0 else 1

    def set_log_destination(self, level, path):
        self.log_dir = str(path)
        handler = _py_logging.FileHandler(os.path.join(self.log_dir, "pycolmap_torch.log")
                                          if os.path.isdir(self.log_dir) else self.log_dir)
        get_logger().addHandler(handler)

    def info(self, msg):
        get_logger().info(msg)

    def warning(self, msg):
        get_logger().warning(msg)

    def error(self, msg):
        get_logger().error(msg)

    def fatal(self, msg):
        get_logger().critical(msg)
        raise RuntimeError(msg)


logging = _LoggingModule()
