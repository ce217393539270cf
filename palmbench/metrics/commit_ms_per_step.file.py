"""Host time persisting runs and committing them a step (total time of
``storage.persist``, the run files and their fsyncs, and ``storage.commit``,
the WAL's rotation, the raw fsync, the manifest and the directory fsync,
over the calls of ``clsm.insert``)."""
from palmbench.metrics._storage import per_step

LAYER = "storage"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_step(r, ["storage.persist", "storage.commit"])
