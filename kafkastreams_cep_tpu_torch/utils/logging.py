"""Logging configuration — the ``logback.xml`` analog.

The reference ships a console logback config at INFO with DEBUG-level
per-edge evaluation logs (``src/main/resources/logback.xml``,
``NFA.java:180,232``).  Here the engine hot path is compiled, so per-edge
logging is host-side only: lifecycle events (compiles, lane assignment,
checkpoints) at INFO, decode details at DEBUG.  Library code only creates
loggers; this helper is the opt-in console setup for applications.

``configure_logging(json_lines=True)`` swaps the human format for one JSON
object per line (``{"type": "log", "ts": ..., "level": ..., ...}``) —
shape-compatible with the telemetry trace stream
(``utils/telemetry.JsonlTraceSink``), so lifecycle logs, spans, and
metrics snapshots can be tailed, filtered, and joined as ONE
machine-parseable stream.
"""

from __future__ import annotations

import json
import logging

ROOT = "kafkastreams_cep_tpu_torch"

_FORMAT = "%(asctime)s %(levelname)-5s %(name)s - %(message)s"


class JsonLinesFormatter(logging.Formatter):
    """One compact JSON object per record, keyed like the trace events
    (``type`` discriminates logs from spans/metrics in a merged stream)."""

    def format(self, record: logging.LogRecord) -> str:
        out = {
            "type": "log",
            "ts": self.formatTime(record, "%Y-%m-%dT%H:%M:%S")
            + f".{int(record.msecs):03d}",
            "level": record.levelname,
            "logger": record.name,
            "msg": record.getMessage(),
        }
        if record.exc_info:
            out["exc"] = self.formatException(record.exc_info)
        return json.dumps(out, default=str)


def configure_logging(
    level: int = logging.INFO, json_lines: bool = False
) -> logging.Logger:
    """Attach a console handler to the package root logger (idempotent).

    Re-invoking with a different ``json_lines`` re-formats the existing
    handler in place rather than stacking a second one.
    """
    logger = logging.getLogger(ROOT)
    logger.setLevel(level)
    # Exact-type check: FileHandler subclasses StreamHandler and must not
    # suppress the console handler this function owns.
    handler = next(
        (h for h in logger.handlers if type(h) is logging.StreamHandler),
        None,
    )
    if handler is None:
        handler = logging.StreamHandler()
        logger.addHandler(handler)
    handler.setFormatter(
        JsonLinesFormatter() if json_lines else logging.Formatter(_FORMAT)
    )
    return logger


def get_logger(name: str) -> logging.Logger:
    """A child logger under the package root."""
    return logging.getLogger(f"{ROOT}.{name}")
