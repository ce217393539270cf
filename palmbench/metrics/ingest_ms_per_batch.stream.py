"""Host time inside ``StreamingIndex.ingest`` per ingested batch, over the
window: appends, flushes, merges."""
from palmbench.metrics._read import durations_ms

LAYER = "indexes and ingest"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "host_clock", "ingest_series_per_s"


def read(r):
    d = durations_ms(r, "ingest")
    return float(d.mean()) if d.size else None
