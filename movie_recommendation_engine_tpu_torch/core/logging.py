"""Structured metrics logging (every record is one JSON line), program spans
and traces.

Port of ``movie_recommendation_engine_tpu/core/logging.py``: ``MetricsLogger``
as it is, and ``trace``, which takes a ``torch.profiler`` trace where JAX
takes a ``jax.profiler`` one. ``span`` (the port's own) marks the program's
layer boundaries for ``SpanRecorder``.
"""

from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time
from typing import Any, NamedTuple

from torch.autograd import profiler as _autograd_profiler


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
    ``log_dir/trace.json``; a no-op when ``log_dir`` is None. Each program
    span of the block is also a ``record_function`` range of its name."""
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
    RECORDER.annotate += 1
    try:
        yield
    finally:
        RECORDER.annotate -= 1
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


# ---------------------------------------------------------------------------
# Program spans
# ---------------------------------------------------------------------------

class SpanRecord(NamedTuple):
    """One closed span: times are ``time.time_ns()``, the clock the
    profiler's device events are stamped on; ``parent`` is the id of the
    innermost span open on the same thread when it opened (None at top)."""

    name: str
    start_ns: int
    end_ns: int
    id: int
    parent: int | None
    thread: str
    attrs: dict


class Span:
    """A span that is recorded or timed (``span`` hands out the shared
    ``_OFF`` for every other). ``seconds`` is its duration once closed."""

    __slots__ = ("rec", "name", "recorded", "sync", "start_ns", "end_ns", "id", "parent",
                 "attrs", "_range")

    def __init__(self, rec: SpanRecorder, name: str, recorded: bool, sync, start_ns):
        self.rec, self.name, self.recorded, self.sync = rec, name, recorded, sync
        self.start_ns, self.end_ns = start_ns, None
        self.id = self.parent = self._range = None
        self.attrs: dict = {}

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) / 1e9

    def __enter__(self) -> Span:
        if self.recorded:
            stack = self.rec.stack()
            self.parent = stack[-1] if stack else None
            self.id = next(self.rec.ids)
            stack.append(self.id)
            if self.rec.annotate:
                import torch
                self._range = torch.profiler.record_function(self.name)
                self._range.__enter__()
        if self.start_ns is None:
            self.start_ns = time.time_ns()
        return self

    def __exit__(self, *exc) -> bool:
        if not self.recorded:
            self.end_ns = time.time_ns()
            return False
        try:
            if self.sync is not None and self.sync.type == "cuda":
                import torch
                torch.cuda.synchronize(self.sync)
        finally:
            self.end_ns = time.time_ns()
            if self._range is not None:
                self._range.__exit__(*exc)
            self.rec.stack().pop()
            self.rec.add(SpanRecord(self.name, self.start_ns, self.end_ns, self.id, self.parent,
                                    threading.current_thread().name, self.attrs))
        return False


class _Off:
    """The span of a block that is neither recorded nor timed: shared, it
    allocates nothing and reads no clock."""

    __slots__ = ()
    recorded = False

    def __enter__(self) -> _Off:
        return self

    def __exit__(self, *exc) -> bool:
        return False


_OFF = _Off()


class SpanRecorder:
    """Program spans kept in memory. It records while ``enable``d, or while a
    ``torch.profiler`` runs in the process, so that a profiled window holds
    the program's spans on the clock of its device events without its
    caller asking for them. ``drain`` hands them over; nothing is written
    while they are taken. At most ``LIMIT`` are kept between drains (the
    rest are counted in ``dropped``), so that a long profile cannot grow
    them without bound."""

    LIMIT = 1 << 18

    def __init__(self):
        self.enabled = False
        self.annotate = 0          # > 0 while ``trace`` runs
        self.records: list[SpanRecord] = []
        self.dropped = 0
        self.ids = itertools.count(1)
        self._local = threading.local()

    def on(self) -> bool:
        return self.enabled or _autograd_profiler._is_profiler_enabled

    def span(self, name: str, *, sync=None, timed: bool = False, start_ns: int | None = None):
        """A context manager over the block. Recorded while the recorder is
        on; ``sync`` (a device) is then synchronized at the block's end, so
        that the device work it queued lies inside the span. ``timed`` spans
        read the clock (``.seconds``) whether recorded or not, for a caller
        that logs the duration; ``start_ns`` opens the span at an earlier
        instant of the same clock. Any other span, while the recorder is
        off, is the shared ``_OFF``: no sync, no record."""
        recorded = self.on()
        if not (recorded or timed):
            return _OFF
        return Span(self, name, recorded, sync, start_ns)

    def stack(self) -> list[int]:
        """The ids of the spans open on the calling thread, innermost last."""
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def add(self, record: SpanRecord) -> None:
        if len(self.records) < self.LIMIT:
            self.records.append(record)
        else:
            self.dropped += 1

    def enable(self) -> None:
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def drain(self) -> list[SpanRecord]:
        """The spans closed since the last drain, in the order they closed."""
        out, self.records = self.records, []
        return out


RECORDER = SpanRecorder()
span = RECORDER.span
enable = RECORDER.enable
disable = RECORDER.disable
drain = RECORDER.drain
