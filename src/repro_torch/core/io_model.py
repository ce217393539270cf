"""Explicit I/O accounting — the paper's cost currency and its "heat map".

Every index operation reports its storage accesses here. The demo paper's
heat-map visualization of query access patterns becomes a machine-readable
access log that benchmarks and examples aggregate (and render as ASCII).

Cost model defaults approximate a 2018-era SATA SSD (the paper's setting):
sequential ~500 MB/s, random 4K ~ 10k IOPS. They are configurable so the
same accounting can model NVMe or HBM-resident runs.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
from typing import List, Tuple

import numpy as np


@dataclasses.dataclass
class IOStats:
    seq_read_bytes: int = 0
    rand_read_bytes: int = 0
    seq_write_bytes: int = 0
    rand_write_bytes: int = 0
    seq_ops: int = 0
    rand_ops: int = 0

    def merge(self, other: "IOStats") -> "IOStats":
        return IOStats(
            self.seq_read_bytes + other.seq_read_bytes,
            self.rand_read_bytes + other.rand_read_bytes,
            self.seq_write_bytes + other.seq_write_bytes,
            self.rand_write_bytes + other.rand_write_bytes,
            self.seq_ops + other.seq_ops,
            self.rand_ops + other.rand_ops,
        )

    @property
    def total_bytes(self) -> int:
        return (
            self.seq_read_bytes
            + self.rand_read_bytes
            + self.seq_write_bytes
            + self.rand_write_bytes
        )


@dataclasses.dataclass
class DiskModel:
    """Accounting + cost estimation for a modeled storage device."""

    seq_mbps: float = 500.0
    rand_iops: float = 10_000.0
    page_bytes: int = 4096
    stats: IOStats = dataclasses.field(default_factory=IOStats)
    # access log for the heat map: (offset_pages, n_pages, kind); a bulk
    # record (see read_rand_rows) holds an array of offsets, one access each
    log: List[Tuple[object, int, str]] = dataclasses.field(default_factory=list)
    keep_log: bool = False
    # background ingest accounts flush/merge I/O from the worker thread
    # while queries account reads concurrently — counter updates are
    # read-modify-write, so they serialize here
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)
    # per-thread accounting suspension depth (see :meth:`unaccounted`)
    _tls: threading.local = dataclasses.field(
        default_factory=threading.local, repr=False, compare=False)

    def _suspended(self) -> bool:
        return getattr(self._tls, "suspend", 0) > 0

    @contextlib.contextmanager
    def unaccounted(self):
        """Suspend accounting for I/O issued by the CALLING thread only.

        For measurement-side reads that must not pollute the modeled cost
        figures — e.g. the serving loop's recall oracle re-running a query
        through the exact tier. Unlike the old save/restore of ``stats``
        (a racy in-place mutation of state a concurrent ingest worker is
        accounting into), this is a thread-local depth counter: the
        worker's flush/merge I/O keeps landing in the shared stats
        untouched while the oracle's own reads vanish. Re-entrant."""
        # thread-local state: only ever touched by its own thread, so the
        # instance lock is deliberately not taken
        self._tls.suspend = getattr(self._tls, "suspend", 0) + 1  # palmlint: ignore[lock-discipline]
        try:
            yield self
        finally:
            self._tls.suspend -= 1  # palmlint: ignore[lock-discipline] — thread-local

    def reset(self) -> None:
        with self._lock:
            self.stats = IOStats()
            self.log = []

    def read_seq(self, nbytes: int, offset: int = 0) -> None:
        if self._suspended():
            return
        with self._lock:
            self.stats.seq_read_bytes += int(nbytes)
            self.stats.seq_ops += 1
            if self.keep_log and nbytes:
                # ceil-divide like the random paths: a 4097-byte read
                # touches 2 pages, not 1
                pages = max(1, (int(nbytes) + self.page_bytes - 1) // self.page_bytes)
                self.log.append((offset // self.page_bytes, pages, "rs"))

    def read_rand(self, nbytes: int, offset: int = 0) -> None:
        if self._suspended():
            return
        with self._lock:
            self.stats.rand_read_bytes += int(nbytes)
            pages = max(1, (int(nbytes) + self.page_bytes - 1) // self.page_bytes)
            self.stats.rand_ops += pages
            if self.keep_log and nbytes:
                self.log.append((offset // self.page_bytes, pages, "rr"))

    def read_rand_rows(self, offsets: np.ndarray, nbytes: int) -> None:
        """One random read of ``nbytes`` at each byte offset in ``offsets``:
        the accounting and the heat-map log of that many :meth:`read_rand`
        calls, taken in one step and logged as one record."""
        if self._suspended():
            return
        offsets = np.asarray(offsets, np.int64)
        if offsets.size == 0:
            return
        pages = max(1, (int(nbytes) + self.page_bytes - 1) // self.page_bytes)
        with self._lock:
            self.stats.rand_read_bytes += int(nbytes) * offsets.size
            self.stats.rand_ops += pages * offsets.size
            if self.keep_log and nbytes:
                self.log.append((offsets // self.page_bytes, pages, "rr"))

    def write_seq(self, nbytes: int, offset: int = 0) -> None:
        if self._suspended():
            return
        with self._lock:
            self.stats.seq_write_bytes += int(nbytes)
            self.stats.seq_ops += 1
            if self.keep_log and nbytes:
                # ceil-divide like the random paths (page parity with reads)
                pages = max(1, (int(nbytes) + self.page_bytes - 1) // self.page_bytes)
                self.log.append((offset // self.page_bytes, pages, "ws"))

    def write_rand(self, nbytes: int, offset: int = 0) -> None:
        if self._suspended():
            return
        with self._lock:
            self.stats.rand_write_bytes += int(nbytes)
            pages = max(1, (int(nbytes) + self.page_bytes - 1) // self.page_bytes)
            self.stats.rand_ops += pages
            if self.keep_log and nbytes:
                self.log.append((offset // self.page_bytes, pages, "wr"))

    def read_seq_ranges(self, ranges, unit_bytes: int = 1) -> None:
        """One sequential read per [lo, hi) range (in ``unit_bytes`` units).
        ``ranges`` must already be disjoint and ascending — the output of
        :func:`coalesce_ranges`. The batched approximate tier funnels every
        query's block range through here so overlapping seeks collapse into
        few long sequential reads — the accounting form of the paper's
        one-seek-plus-one-sequential-read claim."""
        for lo, hi in ranges:
            self.read_seq((hi - lo) * unit_bytes, offset=lo * unit_bytes)

    def modeled_seconds(self) -> float:
        """Estimated wall time of the recorded I/O pattern on the modeled device."""
        s = self.stats
        seq = (s.seq_read_bytes + s.seq_write_bytes) / (self.seq_mbps * 1e6)
        rand = s.rand_ops / self.rand_iops
        return seq + rand

    def heatmap(self, n_bins: int = 64, max_page: int | None = None) -> List[int]:
        """Aggregate the access log into n_bins page-range bins (the demo's
        heat map). Returns access counts per bin."""
        if not self.log:
            return [0] * n_bins
        offs = [np.ravel(np.asarray(off, np.int64)) for off, _, _ in self.log]
        lens = np.concatenate([np.full(o.size, n, np.int64)
                               for o, (_, n, _) in zip(offs, self.log)])
        offs = np.concatenate(offs)
        mp = max_page or int((offs + lens).max()) or 1
        b0 = np.minimum(n_bins - 1, offs * n_bins // mp)
        # page ranges are half-open: the last page touched is off + n - 1,
        # so an access ending exactly on a bin boundary must not bleed a
        # count into the next bin
        b1 = np.minimum(n_bins - 1, (offs + lens - 1) * n_bins // mp)
        # each access adds one to bins b0..b1: a difference array, summed
        diff = np.zeros(n_bins + 1, np.int64)
        np.add.at(diff, b0, 1)
        np.add.at(diff, b1 + 1, -1)
        return np.cumsum(diff[:-1]).tolist()


def coalesce_ranges(ranges) -> List[Tuple[int, int]]:
    """Merge half-open [lo, hi) ranges into sorted disjoint ranges.

    Overlapping and back-to-back ranges fuse, empty ranges drop out. Used to
    deduplicate the per-query block reads of a batched approximate query
    into the minimal set of sequential reads."""
    spans = sorted((int(lo), int(hi)) for lo, hi in ranges if hi > lo)
    out: List[Tuple[int, int]] = []
    for lo, hi in spans:
        if out and lo <= out[-1][1]:
            if hi > out[-1][1]:
                out[-1] = (out[-1][0], hi)
        else:
            out.append((lo, hi))
    return out


def render_heatmap(bins: List[int], width: int = 64) -> str:
    """ASCII rendering of the access heat map (dark = hot)."""
    shades = " .:-=+*#%@"
    mx = max(bins) or 1
    return "".join(shades[min(len(shades) - 1, v * (len(shades) - 1) // mx)] for v in bins[:width])
