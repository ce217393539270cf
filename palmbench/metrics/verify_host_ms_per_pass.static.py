"""The verify engine's host time a pass: padding queries and rows before
the upload, the f64 re-rank of the slate with its certificate, and the
host re-screen of uncertified queries (self time of ``verify.stage``,
``verify.rerank`` and ``verify.fallback`` over the calls of
``verify.stage``)."""
from palmbench.metrics._spans import per_call

LAYER = "verify engine"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "queries_per_s"


def read(r):
    return per_call(r, ["verify.stage", "verify.rerank", "verify.fallback"],
                    "verify.stage")
