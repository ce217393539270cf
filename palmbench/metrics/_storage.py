"""Readers of the file backend's spans (``storage.*``) a step, a step
being a call of ``clsm.insert``. A program without those spans, or a cell
on the modeled disk, reads nothing."""
from palmbench.metrics._spans import per_call, totals

# the spans that write: their bytes are every byte the backend writes
WRITES = ["storage.wal", "storage.persist", "storage.commit", "storage.raw_write"]


def per_step(r, names, field="total_ns", scale=1e-6):
    t = totals(r)
    if not t or not any(n in t for n in names):
        return None
    return per_call(r, names, "clsm.insert", field=field, scale=scale)
