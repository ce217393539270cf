"""Bytes the file backend writes a step: raw rows, WAL records, run files,
manifests (the bytes of the four writing ``storage.*`` spans over the calls
of ``clsm.insert``)."""
from palmbench.metrics._storage import WRITES, per_step

LAYER = "storage"
UNIT, BETTER, SOURCE, MOVES = "bytes", "lower", "program_span", "ingest_series_per_s"


def read(r):
    return per_step(r, WRITES, field="bytes", scale=1)
