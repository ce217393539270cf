"""Host time planning the exact tier a batch: the queries' PAA, the zone
maps' lower bounds and the per-block position lists (self time of the
``plan.exact`` span over its calls)."""
from palmbench.metrics._spans import per_call

LAYER = "plan and execute"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "queries_per_s"


def read(r):
    return per_call(r, ["plan.exact"], "plan.exact")
