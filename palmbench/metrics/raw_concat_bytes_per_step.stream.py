"""Bytes the raw store's concatenation copies a step (bytes of
``raw.concat`` over the calls of ``clsm.insert``)."""
from palmbench.metrics._spans import per_call

LAYER = "indexes and ingest"
UNIT, BETTER, SOURCE, MOVES = "bytes", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["raw.concat"], "clsm.insert", field="bytes", scale=1)
