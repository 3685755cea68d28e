"""Mean wall time of the refresh's walk graph (walks, importance top-K and, on
the dense rung, the pool matrices) per refresh in the window (ms): the
program's ``trainer.refresh.walks`` spans, the device synchronized at their
end."""

from benchmarks import program_spans


def read(run):
    return program_spans.mean_ms(run, "trainer.refresh.walks")
