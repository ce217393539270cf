"""Unflushed entries a step's queries saw: the backlog of buffered and
flushing entries (``StreamingIndex.ingest_lag()["lag_entries"]``) counted
once each ``ingest`` returns, over the steps. The queries brute-force these
entries as the plan's dense source."""
LAYER = "plan and execute"
UNIT, BETTER, SOURCE, MOVES = "count", "lower", "program_counter", "ingest_series_per_s"


def read(r):
    n = r.counts.get("steps", 0)
    return r.counts.get("lag_entries", 0) / n if n else None
