"""Mean wall time of a train step in the window (ms): the trainer's own
``step_ms_avg`` per epoch (host clock, the device synchronized at both ends,
the epoch's first block of steps left out), averaged over the epochs.
Nothing to read where an epoch has a single block of steps."""

import math


def read(run):
    vals = [e["step_ms_avg"] for e in run.records.get("epochs", [])
            if not math.isnan(e["step_ms_avg"])]
    return sum(vals) / len(vals) if vals else None
