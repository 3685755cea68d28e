"""Median wall time of a batch in the server's worker (ms): the program's
``server.batch`` spans, from the batch taken off the queue to every answer of
it set."""

from benchmarks import program_spans


def read(run):
    return program_spans.median_ms(run, "server.batch")
