"""``screen_dense_kernel``'s share of its roofline over the traced window.

The work is the batch's, counted from what its plan asks, not from the
launches: the exact tier screens every query of a batch against every
entry it verifies, so P = batch x E (query, entry) pairs with E the
``entries_verified`` of ``QueryStats``. The least time is the larger of
2 d P float32 operations over the FP32 peak and 4 d E bytes (each entry's
row read once) over HBM's, against the kernel's device time in the trace.
"""
from palmbench.peaks import least_seconds

LAYER = "kernels"
UNIT, BETTER, SOURCE, MOVES = "%", "higher", "device_trace", "queries_per_s"
KERNEL = "screen_dense_kernel"


def read(r):
    t = None if r.trace is None else r.trace.kernel_s.get(KERNEL)
    e = r.counts.get("entries_verified", 0)
    if not t or not e:
        return None
    d = r.sizes["series_len"]
    pairs = r.sizes["batch"] * e
    return 100.0 * least_seconds(2.0 * d * pairs, 4.0 * d * e) / t
