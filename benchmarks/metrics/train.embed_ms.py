"""Mean wall time of validation's embedding pass in the window (ms): the
program's ``trainer.evaluate.embed`` spans, the device synchronized at their
end."""

from benchmarks import program_spans


def read(run):
    return program_spans.mean_ms(run, "trainer.evaluate.embed")
