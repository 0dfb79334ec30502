"""Logging for lmcache_tpu_torch (a copy of lmcache_tpu.logging_utils).

Mirrors the capability of the reference logger (reference:
lmcache/logging.py:1-14) but avoids its global ``logging.basicConfig`` at
import time (an anti-pattern flagged in SURVEY.md §5): we configure a
dedicated handler on our own package logger only.
"""

import logging
import os
import sys

_FORMAT = ("\033[33m%(levelname)s\033[0m \033[32m%(asctime)s.%(msecs)03d "
           "%(name)s:%(lineno)d\033[0m %(message)s")
_DATEFMT = "%H:%M:%S"

_LOG_LEVEL = os.environ.get("LMCACHE_TPU_TORCH_LOG_LEVEL", "INFO").upper()

_root = logging.getLogger("lmcache_tpu_torch")
if not _root.handlers:
    _handler = logging.StreamHandler(sys.stderr)
    _handler.setFormatter(logging.Formatter(_FORMAT, datefmt=_DATEFMT))
    _root.addHandler(_handler)
    _root.setLevel(_LOG_LEVEL)
    _root.propagate = False


def init_logger(name: str) -> logging.Logger:
    """Return a child logger under the ``lmcache_tpu_torch`` namespace."""
    if not name.startswith("lmcache_tpu_torch"):
        name = f"lmcache_tpu_torch.{name}"
    return logging.getLogger(name)
