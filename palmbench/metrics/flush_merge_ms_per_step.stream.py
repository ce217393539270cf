"""Host time flushing the write buffer into level-0 runs and merging runs
a step (total time of ``clsm.flush``, its merges inside, over the calls of
``clsm.insert``)."""
from palmbench.metrics._spans import per_call

LAYER = "indexes and ingest"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["clsm.flush"], "clsm.insert", field="total_ns")
