"""The share of the traced window in which no record of the card's was
running (1 minus the union of device activity over the window)."""
from palmbench.metrics._read import idle_share

LAYER = "card"
UNIT, BETTER, SOURCE, MOVES = "%", "lower", "device_trace", "ingest_series_per_s"


def read(r):
    return idle_share(r)
