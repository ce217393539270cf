"""Queries answered over the whole window, per second of it."""
UNIT, BETTER, SOURCE = "queries/s", "higher", "host_clock"


def read(r):
    n = sum(q.items for q in r.records if q.kind != "ingest")
    return n / r.window_s if n else None
