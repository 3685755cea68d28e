"""Mean wall time of an epoch's batches in the window (ms): the program's
``trainer.epoch_batches`` spans (the permutation of the train pairs on the
host, their copies to the device, synchronized)."""

from benchmarks import program_spans


def read(run):
    return program_spans.mean_ms(run, "trainer.epoch_batches")
