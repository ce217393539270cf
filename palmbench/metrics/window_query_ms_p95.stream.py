"""The 95th percentile of ``StreamingIndex.window_knn_batch`` over every
step of the window: planning, passes and the arena upkeep they trigger."""
from palmbench.metrics._read import durations_ms, p95

LAYER = "plan and execute"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "ingest_series_per_s"


def read(r):
    return p95(durations_ms(r, "window_knn_batch"))
