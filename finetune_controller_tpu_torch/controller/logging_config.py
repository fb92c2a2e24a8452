"""Logging setup (reference: ``app/utils/logging_config.py:5-44``).

Same shape — dictConfig, colored console handler, root INFO with package DEBUG —
but the color formatter is stdlib ANSI (colorlog is not in the image).
"""

from __future__ import annotations

import logging
import logging.config

_COLORS = {
    logging.DEBUG: "\x1b[36m",
    logging.INFO: "\x1b[32m",
    logging.WARNING: "\x1b[33m",
    logging.ERROR: "\x1b[31m",
    logging.CRITICAL: "\x1b[35m",
}
_RESET = "\x1b[0m"


class ColorFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        color = _COLORS.get(record.levelno, "")
        record.levelcolor = f"{color}{record.levelname:8s}{_RESET}"
        return super().format(record)


def setup_logging(level: int = logging.INFO) -> None:
    logging.config.dictConfig(
        {
            "version": 1,
            "disable_existing_loggers": False,
            "formatters": {
                "color": {
                    "()": ColorFormatter,
                    "format": "%(asctime)s %(levelcolor)s %(name)s: %(message)s",
                }
            },
            "handlers": {
                "console": {
                    "class": "logging.StreamHandler",
                    "formatter": "color",
                }
            },
            "root": {"level": level, "handlers": ["console"]},
            "loggers": {
                "finetune_controller_tpu": {"level": logging.DEBUG},
            },
        }
    )
