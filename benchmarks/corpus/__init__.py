"""The benchmark's corpora: a frozen copy of the synthetic generator and the
cache that writes each corpus once as MovieLens CSVs."""
