"""Host time keeping the raw store's device arena current a step: centering,
quantizing and the norms of the rows before their upload (self time of
``arena.build`` and ``arena.extend`` over the calls of ``clsm.insert``)."""
from palmbench.metrics._spans import per_call

LAYER = "verify engine"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["arena.build", "arena.extend"], "clsm.insert")
