"""The port's program spans in a traced run, for the per-layer readers.

The port records its spans (``core.logging.SpanRecorder``) while a
``torch.profiler`` runs in the process, which in a traced run on the card
is exactly the measured window (``harness.Run.window``). The spans are
stamped with ``time.time_ns()``, the clock of the profiler's device events
and of the harness's own spans. A run without them (an untraced run, a run
on the CPU, or a port that records none) reads nothing here, and its
readers return None.

``spans(run)`` drains the recorder once per run into
``run.records["program_spans"]`` and, where the run holds a device trace,
prints two notes: ``idle_by_program_span``, the window's device-idle time by
the innermost program span open (``at_gap_start``: each gap whole, named by
the span open at its start, as the harness names gaps by its own spans;
``over_gap``: each instant of a gap by the span open then), and
``busy_in_program_spans``, the share of the device's busy time inside the
spans of each name.
"""

from __future__ import annotations

import heapq
import statistics

import numpy as np

OUTSIDE = "outside program spans"


def spans(run) -> list[tuple]:
    """The run's program spans: (name, start_ns, end_ns, id, parent, thread,
    attrs) tuples, in the order they closed."""
    if "program_spans" not in run.records:
        try:
            from movie_recommendation_engine_tpu_torch.core import logging as plog
        except ImportError:
            plog = None
        drain = getattr(plog, "drain", None)
        got = [tuple(s) for s in drain()] if drain is not None else []
        run.records["program_spans"] = got
        if got and run.device_trace is not None:
            ops, window = run.device_trace["ops"], run.window_ns
            run.note("idle_by_program_span", at_gap_start=idle_by_span(ops, got, *window),
                     over_gap=idle_over_spans(ops, got, *window))
            run.note("busy_in_program_spans", **busy_in_spans(ops, got, *window))
    return run.records["program_spans"]


def durations_ms(run, name: str) -> list[float]:
    return [(s[2] - s[1]) / 1e6 for s in spans(run) if s[0] == name]


def mean_ms(run, name: str) -> float | None:
    vals = durations_ms(run, name)
    return sum(vals) / len(vals) if vals else None


def median_ms(run, name: str) -> float | None:
    vals = durations_ms(run, name)
    return statistics.median(vals) if vals else None


def queue_ms(run) -> list[float]:
    """Each request's queue wait (ms), rebuilt from the ``server.batch``
    spans: its submit time to its batch's start (the batch taken)."""
    out = []
    for s in spans(run):
        if s[0] == "server.batch":
            out.extend((s[1] - t) / 1e6 for t in s[6].get("submitted_ns", ()))
    return out


def _gaps(ops, t0: int, t1: int) -> list[tuple[int, int]]:
    """(start, end) of each interval of [t0, t1) in which no device
    operation ran; ``ops`` are (name, start_ns, end_ns) sorted by start."""
    gaps, end = [], t0
    for _, s, f in ops:
        s, f = max(s, t0), min(f, t1)
        if f <= s:
            continue
        if s > end:
            gaps.append((end, s))
        end = max(end, f)
    if t1 > end:
        gaps.append((end, t1))
    return gaps


def idle_by_span(ops, program_spans, t0: int, t1: int) -> dict[str, float]:
    """Idle seconds of the window by the innermost program span open at each
    gap's start (the open span that started last, the later-opened one on a
    tie). One sweep over the gaps in time order with a heap of the spans
    opened so far, the latest start on top and spans closed before the
    sweep's time dropped as they surface: O((gaps + spans) log spans)."""
    order = sorted(program_spans, key=lambda s: (s[1], s[3]))
    heap: list[tuple[int, int, int, str]] = []
    i, named = 0, {}
    for start, end in _gaps(ops, t0, t1):
        while i < len(order) and order[i][1] <= start:
            s = order[i]
            heapq.heappush(heap, (-s[1], -s[3], s[2], s[0]))
            i += 1
        while heap and heap[0][2] <= start:
            heapq.heappop(heap)
        key = heap[0][3] if heap else OUTSIDE
        named[key] = named.get(key, 0.0) + (end - start) / 1e9
    return dict(sorted(named.items(), key=lambda kv: -kv[1]))


def innermost(program_spans) -> list[tuple[int, int, str]]:
    """Disjoint (start, end, name) pieces of time, each named by the
    innermost program span open through it (as ``idle_by_span`` picks it);
    time in which no span is open is left out. One sweep over the spans'
    starts and ends with the same heap: O(spans log spans)."""
    order = sorted(program_spans, key=lambda s: (s[1], s[3]))
    times = sorted({t for s in program_spans for t in (s[1], s[2])})
    heap: list[tuple[int, int, int, str]] = []
    i, out = 0, []
    for t, t_next in zip(times, times[1:]):
        while i < len(order) and order[i][1] <= t:
            s = order[i]
            heapq.heappush(heap, (-s[1], -s[3], s[2], s[0]))
            i += 1
        while heap and heap[0][2] <= t:
            heapq.heappop(heap)
        if heap:
            out.append((t, t_next, heap[0][3]))
    return out


def idle_over_spans(ops, program_spans, t0: int, t1: int) -> dict[str, float]:
    """Idle seconds of the window by the innermost program span open at each
    instant of each gap: the gaps and ``innermost``'s pieces, both sorted
    and disjoint, walked together."""
    pieces = innermost(program_spans)
    named, j = {}, 0
    for start, end in _gaps(ops, t0, t1):
        covered = 0
        while j < len(pieces) and pieces[j][1] <= start:
            j += 1
        k = j
        while k < len(pieces) and pieces[k][0] < end:
            a, b, name = pieces[k]
            overlap = min(b, end) - max(a, start)
            if overlap > 0:
                named[name] = named.get(name, 0.0) + overlap / 1e9
                covered += overlap
            k += 1
        if end - start > covered:
            named[OUTSIDE] = named.get(OUTSIDE, 0.0) + (end - start - covered) / 1e9
    return dict(sorted(named.items(), key=lambda kv: -kv[1]))


def _union(intervals) -> tuple[np.ndarray, np.ndarray]:
    """Sorted disjoint (starts, ends) covering the given (start, end)s."""
    starts, ends = [], []
    for s, f in sorted(intervals):
        if f <= s:
            continue
        if starts and s <= ends[-1]:
            ends[-1] = max(ends[-1], f)
        else:
            starts.append(s)
            ends.append(f)
    return np.asarray(starts, np.int64), np.asarray(ends, np.int64)


def _covered(starts: np.ndarray, ends: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Length of the disjoint intervals (starts, ends) before each time t."""
    lengths = ends - starts
    before = np.concatenate([[0], np.cumsum(lengths)])     # before[j]: intervals < j
    k = np.searchsorted(starts, t, side="right") - 1      # the last that starts <= t
    j = np.maximum(k, 0)
    return np.where(k >= 0, before[j] + np.clip(t - starts[j], 0, lengths[j]), 0)


def busy_in_spans(ops, program_spans, t0: int, t1: int) -> dict[str, float]:
    """For each span name, the share (%) of the window's device busy time
    (the union of its operations' intervals) that lies inside that name's
    spans."""
    bs, bf = _union((max(s, t0), min(f, t1)) for _, s, f in ops)
    busy = int((bf - bs).sum())
    if busy <= 0:
        return {}
    out = {}
    for name in sorted({s[0] for s in program_spans}):
        ss, sf = _union((s[1], s[2]) for s in program_spans if s[0] == name)
        if ss.size:
            inside = (_covered(ss, sf, bf) - _covered(ss, sf, bs)).sum()
            out[name] = 100.0 * float(inside) / busy
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))
