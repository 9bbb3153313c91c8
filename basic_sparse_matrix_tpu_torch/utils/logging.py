"""Structured logging.

The reference's closest thing to logging is stray ``println!`` debug output
in library code (the reference crate's ``src/sparse.rs:61,544,663-665``). Here:
one library logger, opt-in JSON-lines emission for machine consumption by the
bench harness, and helpers for per-op event records.
"""

from __future__ import annotations

import json
import logging
import sys
import time
from typing import Any, Dict, Optional

LOGGER_NAME = "basic_sparse_matrix_tpu_torch"


def get_logger() -> logging.Logger:
    return logging.getLogger(LOGGER_NAME)


class JsonLinesHandler(logging.Handler):
    """Emits each record as one JSON line (for the bench harness)."""

    def __init__(self, stream=None):
        super().__init__()
        self.stream = stream or sys.stderr

    def emit(self, record: logging.LogRecord) -> None:
        payload: Dict[str, Any] = {
            "ts": time.time(),
            "level": record.levelname,
            "msg": record.getMessage(),
        }
        extra = getattr(record, "event", None)
        if extra:
            payload.update(extra)
        self.stream.write(json.dumps(payload) + "\n")
        self.stream.flush()


def configure(level: int = logging.INFO, json_lines: bool = False,
              stream=None) -> logging.Logger:
    logger = get_logger()
    logger.setLevel(level)
    logger.handlers.clear()
    if json_lines:
        logger.addHandler(JsonLinesHandler(stream))
    else:
        h = logging.StreamHandler(stream or sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s %(name)s %(levelname)s %(message)s"))
        logger.addHandler(h)
    return logger


def event(name: str, **fields) -> None:
    """Structured event record (shows up as JSON when configured so)."""
    get_logger().info(name, extra={"event": {"event": name, **fields}})
