"""Host time ``ingest`` waited on backpressure a step: the total time of
``ingest.backpressure`` (opened only while the unflushed backlog is over
``max_lag_entries``) over the calls of ``ingest.submit``, the steps. A
program without those spans reads nothing."""
from palmbench.metrics._spans import per_call

LAYER = "indexes and ingest"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["ingest.backpressure"], "ingest.submit", field="total_ns")
