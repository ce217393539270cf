"""Device verification passes per request: the change in the verify
engine's ``calls`` over the window, per query batch."""
from palmbench.metrics._read import requests

LAYER = "plan and execute"
UNIT, BETTER, SOURCE, MOVES = "count", "lower", "program_counter", "queries_per_s"


def read(r):
    n = requests(r)
    return r.counts.get("engine.calls", 0) / n if n else None
