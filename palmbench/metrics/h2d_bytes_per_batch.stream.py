"""Host-to-device bytes the verify engine counts (arena uploads and
extends after each append, row lists, queries) per step, over the window."""
LAYER = "verify engine"
UNIT, BETTER, SOURCE, MOVES = "bytes", "lower", "program_counter", "ingest_series_per_s"


def read(r):
    n = r.counts.get("steps", 0)
    return r.counts.get("engine.h2d_bytes", 0) / n if n else None
