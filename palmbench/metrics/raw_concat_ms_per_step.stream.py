"""Host time concatenating the raw store's chunks into one array a step
(self time of ``raw.concat`` over the calls of ``clsm.insert``)."""
from palmbench.metrics._spans import per_call

LAYER = "indexes and ingest"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["raw.concat"], "clsm.insert")
