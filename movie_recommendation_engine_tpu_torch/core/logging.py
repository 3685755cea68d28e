"""Structured metrics logging: every record is one JSON line.

Copy of ``MetricsLogger`` from ``movie_recommendation_engine_tpu/core/logging.py``
(the JAX profiler hook is not ported).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any


class MetricsLogger:
    def __init__(self, stream=None, pretty: bool = True):
        self.stream = stream or sys.stdout
        self.pretty = pretty
        self.history: list[dict[str, Any]] = []

    def log(self, event: str, **fields: Any) -> None:
        rec = {"event": event, "time": time.time(), **fields}
        self.history.append(rec)
        line = json.dumps({k: _jsonable(v) for k, v in rec.items()})
        print(line, file=self.stream, flush=True)

    def log_epoch(self, epoch: int, **fields: Any) -> None:
        self.log("epoch", epoch=epoch, **fields)


def _jsonable(v: Any) -> Any:
    try:
        json.dumps(v)
        return v
    except TypeError:
        return str(v)
