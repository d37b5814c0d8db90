"""Logging for the PyTorch port (counterpart of
``deepspeed_tpu/utils/logging.py``; the port keeps its own copy so that it
never imports the JAX package)."""
from __future__ import annotations

import logging
import os
import sys

LOG_LEVELS = {
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warning": logging.WARNING,
    "error": logging.ERROR,
    "critical": logging.CRITICAL,
}


def _create_logger(name: str = "deepspeed_tpu_torch",
                   level: int = logging.INFO) -> logging.Logger:
    lg = logging.getLogger(name)
    lg.setLevel(level)
    lg.propagate = False
    if not lg.handlers:
        handler = logging.StreamHandler(stream=sys.stdout)
        handler.setFormatter(logging.Formatter(
            "[%(asctime)s] [%(levelname)s] [%(name)s] %(message)s"))
        lg.addHandler(handler)
    env_level = os.environ.get("DSTPU_LOG_LEVEL")
    if env_level:
        lg.setLevel(LOG_LEVELS.get(env_level.lower(), logging.INFO))
    return lg


logger = _create_logger()
