"""Structured metrics logging (every record is one JSON line) and traces.

Port of ``movie_recommendation_engine_tpu/core/logging.py``: ``MetricsLogger``
as it is, and ``trace``, which takes a ``torch.profiler`` trace where JAX
takes a ``jax.profiler`` one.
"""

from __future__ import annotations

import contextlib
import json
import os
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


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str | None):
    """A ``torch.profiler`` trace of the block (CPU activity, and CUDA
    activity when a card is present), exported as a Chrome trace to
    ``log_dir/trace.json``; a no-op when ``log_dir`` is None."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
