"""Series acknowledged by ``ingest`` over the whole window (each batch
followed by its query batch), per second of it."""
UNIT, BETTER, SOURCE = "series/s", "higher", "host_clock"


def read(r):
    n = sum(q.items for q in r.records if q.kind == "ingest")
    return n / r.window_s if n else None
