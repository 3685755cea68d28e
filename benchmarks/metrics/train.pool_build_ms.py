"""Mean wall time of the pool operators' build per refresh in the window (ms):
the program's ``trainer.refresh.pool_build`` spans
(``set_neighborhood_tables``: hub operators and segment layouts; on the dense
rung the tables' copies), the device synchronized at their end."""

from benchmarks import program_spans


def read(run):
    return program_spans.mean_ms(run, "trainer.refresh.pool_build")
