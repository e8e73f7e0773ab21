"""The package logger (port of ``internevo_tpu/utils/logger.py``; reference
``internlm/utils/logger.py``).

Every logger is named under ``internevo_tpu_torch`` and writes through one
stdout handler on that package logger.  Records still propagate to the root
logger, so a caller's own handlers (pytest's ``caplog`` among them) see them.
"""

from __future__ import annotations

import logging
import sys

LOGGER_NAME = "internevo_tpu_torch"
LOGGER_FORMAT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"


def get_logger(name: str = LOGGER_NAME, level: int = logging.INFO) -> logging.Logger:
    if not name.startswith(LOGGER_NAME):
        name = f"{LOGGER_NAME}.{name}"
    package = logging.getLogger(LOGGER_NAME)
    if not any(getattr(h, "_internevo", False) for h in package.handlers):
        package.setLevel(level)
        handler = logging.StreamHandler(sys.stdout)
        handler.setFormatter(logging.Formatter(LOGGER_FORMAT))
        handler._internevo = True
        package.addHandler(handler)
    return logging.getLogger(name)
