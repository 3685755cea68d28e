"""Mean wall time of validation's ranks in the window (ms): the program's
``trainer.evaluate.ranks`` spans (the ranks, their one copy to the host, the
HR and MRR sums)."""

from benchmarks import program_spans


def read(run):
    return program_spans.mean_ms(run, "trainer.evaluate.ranks")
