"""Mean wall time of validation per epoch (ms): the harness's host clock
around ``Trainer.evaluate`` on every validation pair, synchronized."""


def read(run):
    vals = run.spans_named("validate")
    return 1e3 * sum(vals) / len(vals) if vals else None
