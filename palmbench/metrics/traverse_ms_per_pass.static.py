"""Host time of the traversal a verification pass: choosing each round's
blocks, gathering their positions and folding the pass into the top-k
state (self time of ``execute.round`` and ``execute.merge`` over the calls
of ``verify.stage``)."""
from palmbench.metrics._spans import per_call

LAYER = "plan and execute"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "queries_per_s"


def read(r):
    return per_call(r, ["execute.round", "execute.merge"], "verify.stage")
