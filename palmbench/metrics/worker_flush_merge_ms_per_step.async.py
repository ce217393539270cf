"""Host time the ingest worker spent flushing the write buffer into
level-0 runs and merging runs a step, off the acknowledged path: the total
time of ``clsm.flush`` (its merges inside) over the calls of
``ingest.submit``, the steps. A program without ``ingest.submit`` reads
nothing."""
from palmbench.metrics._spans import per_call

LAYER = "indexes and ingest"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["clsm.flush"], "ingest.submit", field="total_ns")
