"""Median wall time of a batch's search (ms): the program's ``server.search``
spans, the index's search through the copy of its results to the host."""

from benchmarks import program_spans


def read(run):
    return program_spans.median_ms(run, "server.search")
