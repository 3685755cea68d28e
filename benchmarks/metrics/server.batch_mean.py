"""Mean requests per device search in the window: the server's own
``num_requests`` over ``num_batches``, its counters reset as the window
opens."""


def read(run):
    b = run.records.get("num_batches")
    return run.records["num_requests"] / b if b else None
