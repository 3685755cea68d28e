"""The traffic drivers: one per kind of traffic mix (``traffic/<mix>.json``
names its ``driver``)."""
