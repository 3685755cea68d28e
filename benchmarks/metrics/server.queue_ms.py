"""Median queue wait of a request in the window (ms): from its submit to its
batch taken off the queue (the linger included), rebuilt from the program's
``server.batch`` spans, which carry their requests' submit times."""

import statistics

from benchmarks import program_spans


def read(run):
    vals = program_spans.queue_ms(run)
    return statistics.median(vals) if vals else None
