"""Logging setup: level/format parity with the reference logging config
(log.go:10-34, logging/logging.go:27-53, config.go:269-293).

`setup_logging(level, fmt)` configures the root gubernator_tpu_torch logger with
either text or JSON lines; `parse_log_level` accepts the reference's
level names.  Library users who configure logging themselves can ignore
this module entirely — all framework code logs through stdlib loggers
under the "gubernator_tpu_torch" namespace.
"""
from __future__ import annotations

import json
import logging
import sys
import time
from typing import Optional

LEVELS = {
    "panic": logging.CRITICAL,
    "fatal": logging.CRITICAL,
    "error": logging.ERROR,
    "warn": logging.WARNING,
    "warning": logging.WARNING,
    "info": logging.INFO,
    "debug": logging.DEBUG,
    "trace": logging.DEBUG,
}


def parse_log_level(name: str) -> int:
    """Level name -> stdlib level (LogLevelJSON, logging/logging.go:27-53);
    unknown names raise like the reference's unmarshal error."""
    try:
        return LEVELS[name.strip().lower()]
    except KeyError:
        raise ValueError(
            f"unknown log level '{name}'; one of {sorted(set(LEVELS))}"
        ) from None


class JsonFormatter(logging.Formatter):
    """One JSON object per line (GUBER_LOG_FORMAT=json)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "time": time.strftime(
                "%Y-%m-%dT%H:%M:%S", time.localtime(record.created)
            ),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out)


def setup_logging(
    level: str = "info",
    fmt: str = "text",
    stream=None,
) -> None:
    """Configure root logging (text|json) once, idempotently."""
    handler = logging.StreamHandler(stream or sys.stderr)
    if fmt == "json":
        handler.setFormatter(JsonFormatter())
    else:
        handler.setFormatter(
            logging.Formatter(
                "%(asctime)s %(name)s %(levelname)s %(message)s"
            )
        )
    root = logging.getLogger()
    root.handlers[:] = [handler]
    root.setLevel(parse_log_level(level))
