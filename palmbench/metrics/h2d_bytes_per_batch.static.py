"""Host-to-device bytes the verify engine counts (arena uploads, row lists,
queries) per query batch, over the window."""
from palmbench.metrics._read import requests

LAYER = "verify engine"
UNIT, BETTER, SOURCE, MOVES = "bytes", "lower", "program_counter", "queries_per_s"


def read(r):
    n = requests(r)
    return r.counts.get("engine.h2d_bytes", 0) / n if n else None
