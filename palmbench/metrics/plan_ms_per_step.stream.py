"""Host time planning a step's window query: each run's lower bounds and
position lists, and the unflushed chunks concatenated (self time of
``plan.exact`` and ``plan.buffer`` over the calls of ``clsm.insert``)."""
from palmbench.metrics._spans import per_call

LAYER = "plan and execute"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_call(r, ["plan.exact", "plan.buffer"], "clsm.insert")
