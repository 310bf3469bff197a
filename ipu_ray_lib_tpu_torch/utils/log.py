"""Logging setup mirroring the reference's spdlog configuration.

Copy of ``ipu_ray_lib_tpu/utils/log.py`` under the port's own logger name
(``ipu_ray_lib_tpu_torch``), so that the two packages' handlers never mix
in a process that imports both (ref: src/app_utils.cpp:190-210 — level
names, pattern with thread id).
"""

import logging
import sys

_LEVELS = {
    "trace": logging.DEBUG - 5,
    "debug": logging.DEBUG,
    "info": logging.INFO,
    "warn": logging.WARNING,
    "err": logging.ERROR,
    "critical": logging.CRITICAL,
    "off": logging.CRITICAL + 10,
}
LEVELS = tuple(_LEVELS)

logging.addLevelName(_LEVELS["trace"], "TRACE")

_logger = logging.getLogger("ipu_ray_lib_tpu_torch")


def logger() -> logging.Logger:
    return _logger


def setup_logging(level: str = "info") -> None:
    if level not in _LEVELS:
        raise ValueError(f"Invalid log-level: '{level}'")
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(
        logging.Formatter("[%(asctime)s] [%(levelname).1s] [%(thread)d] %(message)s")
    )
    _logger.handlers[:] = [handler]
    _logger.setLevel(_LEVELS[level])
