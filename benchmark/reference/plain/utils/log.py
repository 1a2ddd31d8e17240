"""Engine logging.

Counterpart of stable_renderer_tpu/utils/log.py, the replacement of the
reference's layered logger setup
(reference: source/common_utils/debug_utils.py:42-230 — colored console + rotating
file handlers + a UI log event). Here: one stdlib logger per subsystem with a color
console handler; file logging is opt-in via SR_TPU_LOG_FILE.
"""

from __future__ import annotations

import logging
import os
import sys

_COLORS = {
    logging.DEBUG: "\033[90m",
    logging.INFO: "\033[36m",
    logging.WARNING: "\033[33m",
    logging.ERROR: "\033[31m",
    logging.CRITICAL: "\033[41m",
}
_RESET = "\033[0m"


class _ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        msg = super().format(record)
        if sys.stderr.isatty():
            color = _COLORS.get(record.levelno, "")
            return f"{color}{msg}{_RESET}"
        return msg


_configured: dict[str, logging.Logger] = {}


def get_logger(name: str = "sr_tpu_torch") -> logging.Logger:
    if name in _configured:
        return _configured[name]
    logger = logging.getLogger(name)
    if not logger.handlers:
        handler = logging.StreamHandler(sys.stderr)
        handler.setFormatter(
            _ColorFormatter("[%(asctime)s|%(name)s|%(levelname)s] %(message)s", "%H:%M:%S")
        )
        logger.addHandler(handler)
        log_file = os.environ.get("SR_TPU_LOG_FILE")
        if log_file:
            fh = logging.FileHandler(log_file)
            fh.setFormatter(
                logging.Formatter("[%(asctime)s|%(name)s|%(levelname)s] %(message)s")
            )
            logger.addHandler(fh)
        level = os.environ.get("SR_TPU_LOG_LEVEL", "INFO").upper()
        logger.setLevel(getattr(logging, level, logging.INFO))
        logger.propagate = False
    _configured[name] = logger
    return logger


EngineLogger = get_logger("sr_tpu_torch.engine")
