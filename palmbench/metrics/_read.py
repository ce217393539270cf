"""Helpers the metric readers share."""
import numpy as np

INGEST = "ingest"


def durations_ms(r, kind=None, skip=INGEST):
    return np.array([(q.t1 - q.t0) * 1e3 for q in r.records
                     if (kind is None and q.kind != skip) or q.kind == kind])


def requests(r, kind=None) -> int:
    return int(durations_ms(r, kind).size)


def p95(values):
    return float(np.percentile(values, 95)) if len(values) else None


def idle_share(r):
    if r.trace is None or r.trace.window_s <= 0 or r.trace.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.window_s)
