"""Async readahead over the executor's coalesced spans.

The approximate tier already deduplicates every query batch's block reads
into disjoint ascending [lo, hi) spans (``coalesce_ranges``); when a run
is file-backed those spans are mmap page ranges the verification pass is
about to fault in one by one. :class:`ReadaheadPool` takes the coalesced
span list the moment the executor produces it and touches the pages on a
small thread pool, so the page cache is warm (or the faults are at least
in flight) by the time verification reads the same rows.

Prefetching is strictly advisory: it reads immutable published runs, it
swallows its own errors, and query answers are identical with the pool
disabled — only the fault timing changes. ``drain()`` exists for tests
and counters, not correctness.
"""
from __future__ import annotations

import threading
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional, Sequence, Tuple

import numpy as np


class ReadaheadPool:
    """Touches file-backed array spans ahead of the verification pass."""

    def __init__(self, workers: int = 2):
        self._lock = threading.Lock()
        self._pool = ThreadPoolExecutor(max_workers=workers,
                                        thread_name_prefix="coconut-readahead")
        self._pending: List[object] = []
        self.spans = 0
        self.bytes = 0
        self.errors = 0

    def prefetch(self, arrays: Sequence[np.ndarray],
                 ranges: List[Tuple[int, int]]) -> None:
        """Queue a readahead of ``arrays[lo:hi]`` for every coalesced
        [lo, hi) row range. Returns immediately."""
        if not ranges:
            return
        arrays = [a for a in arrays if a is not None]
        if not arrays:
            return
        fut = self._pool.submit(self._touch, arrays, list(ranges))
        with self._lock:
            self._pending.append(fut)
            if len(self._pending) > 64:  # keep the bookkeeping bounded
                self._pending = [f for f in self._pending if not f.done()]

    def _touch(self, arrays, ranges) -> None:
        nbytes = nspans = 0
        try:
            for lo, hi in ranges:
                for a in arrays:
                    seg = a[lo:hi]
                    if seg.size == 0:
                        continue
                    # one element per 4 KiB page faults the whole span in
                    step = max(1, 4096 // int(seg.itemsize))
                    float(np.asarray(seg).reshape(-1)[::step].sum())
                    nbytes += int(seg.nbytes)
                nspans += 1
        except Exception:  # noqa: BLE001 — readahead must never break a query
            with self._lock:
                self.errors += 1
            return
        with self._lock:
            self.spans += nspans
            self.bytes += nbytes

    def drain(self, timeout: Optional[float] = 30.0) -> None:
        """Wait for every queued readahead (tests/counters only)."""
        with self._lock:
            pending, self._pending = self._pending, []
        for f in pending:
            f.result(timeout=timeout)

    def stats(self) -> dict:
        with self._lock:
            return {"prefetch_spans": self.spans,
                    "prefetch_bytes": self.bytes,
                    "prefetch_errors": self.errors}


_POOL: Optional[ReadaheadPool] = None
_POOL_LOCK = threading.Lock()


def get_pool() -> ReadaheadPool:
    """The process-wide readahead pool (lazy; daemon worker threads)."""
    global _POOL
    with _POOL_LOCK:
        if _POOL is None:
            _POOL = ReadaheadPool()
        return _POOL
