"""Host time appending and fsyncing the write-ahead log a step (total time
of ``storage.wal``, the record's encoding, write and fsync, over the calls
of ``clsm.insert``)."""
from palmbench.metrics._storage import per_step

LAYER = "storage"
UNIT, BETTER, SOURCE, MOVES = "ms", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_step(r, ["storage.wal"])
