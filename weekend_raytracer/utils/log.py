"""Structured logging for the framework.

The reference's only observability is ``eprintln!`` on errors and on-screen
FPS text (SURVEY.md §5); the rebuild provides leveled, structured logging
with an optional JSON-lines mode for production log pipelines.
"""
from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Any

_LOGGER_NAME = "weekend_raytracer"


class JsonFormatter(logging.Formatter):
    def format(self, record: logging.LogRecord) -> str:
        payload: dict[str, Any] = {
            "ts": round(time.time(), 3),
            "level": record.levelname.lower(),
            "logger": record.name,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "fields", None)
        if extra:
            payload.update(extra)
        if record.exc_info:
            payload["exc"] = self.formatException(record.exc_info)
        return json.dumps(payload)


def get_logger(name: str | None = None) -> logging.Logger:
    """Framework logger; level via WRT_LOG_LEVEL, json via WRT_LOG_JSON=1."""
    root = logging.getLogger(_LOGGER_NAME)
    if not root.handlers:
        handler = logging.StreamHandler(sys.stderr)
        if os.environ.get("WRT_LOG_JSON") == "1":
            handler.setFormatter(JsonFormatter())
        else:
            handler.setFormatter(logging.Formatter(
                "%(asctime)s %(levelname).1s %(name)s: %(message)s",
                datefmt="%H:%M:%S",
            ))
        root.addHandler(handler)
        root.setLevel(os.environ.get("WRT_LOG_LEVEL", "INFO").upper())
        root.propagate = False
    return root.getChild(name) if name else root


def log_event(logger: logging.Logger, msg: str, **fields: Any) -> None:
    """Log with structured fields: rendered as JSON keys under
    WRT_LOG_JSON, appended as k=v text otherwise (so the fields are never
    silently dropped in the default text formatter)."""
    if fields and os.environ.get("WRT_LOG_JSON") != "1":
        kv = " ".join(f"{k}={v}" for k, v in fields.items())
        msg = f"{msg} {kv}"
    logger.info(msg, extra={"fields": fields})
