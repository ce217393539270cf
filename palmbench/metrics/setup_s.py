"""Set-up: from process start to the first timed request (building the
index from the generated collection, or the stream's prefill, and the
warm-up requests)."""
UNIT, BETTER, SOURCE = "s", "lower", "host_clock"


def read(r):
    return r.setup_s
