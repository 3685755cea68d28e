"""Mean wall time of the neighbourhood refresh per epoch (ms): the trainer's
``neighborhoods`` event (walks and top-K, then the pool operators' build,
the device synchronized), averaged over the window's epochs."""


def read(run):
    vals = run.records.get("refresh_s", [])
    return 1e3 * sum(vals) / len(vals) if vals else None
