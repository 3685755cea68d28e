"""The 99th percentile of request latency over the window (ms), from each
request's due time to its answer, a failed request counted as missing:
the serving cell's tail, a per-layer reading beside ``serve_p50_ms``: its
spread from run to run on a shared host (25-54% a set) is too wide for any
bound (see PERF.md)."""


def read(run):
    return run.records.get("p99_ms")
