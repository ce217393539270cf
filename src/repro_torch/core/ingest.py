"""Background ingest pipeline — flush/merge work off the query path.

The paper's streaming headline is that the sortable format lets an
LSM-style index absorb new series with sequential writes *while* continuing
to answer queries — the classic LSM write/read overlap (O'Neil et al.).
:class:`IngestPipeline` supplies the "while": ingest submission becomes a
buffer append plus a worker wake-up, and the expensive half of ingestion —
external-sorting a flush into a level-0 run, cascading tiered merges — runs
on a single background worker that publishes every new or merged run
through the CLSM's :class:`repro_torch.core.run_registry.RunRegistry`. Queries
keep planning from the previous snapshot and flip to the new one at the
next epoch read; nothing on the query path ever waits for compaction.

Single-writer discipline: exactly one worker mutates the run set (plus the
caller thread's buffer appends, which are registry-atomic), so flushes and
merges never race each other and ``publish_merge`` victims are always
present. Queries are pure snapshot readers.

Worker failures are latched and re-raised on the submitting thread at the
next ``insert``/``drain``/``close`` so they cannot vanish silently.

Tracing: ``insert`` is the span ``ingest.submit`` (its calls are the
submissions) and a wait on backpressure inside it is ``ingest.backpressure``
(opened only when the backlog is over ``max_lag_entries``, so its calls are
the waits); neither encloses device work. The worker's flushes and merges
are ``clsm.flush`` / ``clsm.merge``: their time adds to ``spans.totals()``,
but torch's profiler keeps the ranges of the thread it was started on only
(unless its session was started with ``profile_all_threads``), so they do
not reach a trace. :attr:`IngestPipeline.counts` counts the same events
whether or not the profiler records (``COUNTS``).
"""
from __future__ import annotations

import threading
import time
from typing import Optional

import numpy as np

from .. import spans
from .clsm import CLSM
from .run_registry import BufferChunk

# IngestPipeline.counts: submissions; backpressure waits and their ns; the
# backlog (buffered plus flushing entries) right after each append, summed
# and its largest; flushes and merges the worker finished
COUNTS = ("submits", "waits", "wait_ns", "lag_sum", "lag_max", "flushes",
          "merges")


class IngestPipeline:
    """Moves a CLSM's flush/external-sort/merge work onto a worker thread.

    ``insert`` is cheap (one registry buffer append); the worker drains the
    buffer into level-0 runs and runs the cascading merges, publishing each
    step atomically. ``max_lag_entries`` is the backpressure knob: when the
    unflushed backlog (buffer + in-flight flushes) exceeds it, ``insert``
    blocks until the worker catches up — bounding memory without ever
    blocking *queries*."""

    def __init__(self, lsm: CLSM, *, max_lag_entries: Optional[int] = None):
        if (max_lag_entries is not None
                and max_lag_entries < lsm.cfg.buffer_entries):
            # below the flush threshold the worker would never flush while
            # insert() waits for a backlog it cannot shrink: a deadlock
            raise ValueError(
                f"max_lag_entries ({max_lag_entries}) must be >= "
                f"buffer_entries ({lsm.cfg.buffer_entries}): backpressure "
                "can only release once the worker's flush threshold is "
                "reachable")
        self.lsm = lsm
        self.max_lag_entries = max_lag_entries
        self._cond = threading.Condition()
        self._stop = False
        self._busy = False  # worker is mid-flush (entries in flight)
        self._done = False  # worker has exited (nothing will flush anymore)
        self._flush_all = False
        self._error: Optional[BaseException] = None
        self.counts = dict.fromkeys(COUNTS, 0)
        self._worker = threading.Thread(target=self._run, name="coconut-ingest",
                                        daemon=True)
        self._worker.start()

    # ---------------------------------------------------------- submitting
    def _raise_pending(self) -> None:
        # Condition's default lock is an RLock, so this nests safely under
        # callers (drain) that already hold the cond
        with self._cond:
            if self._error is None:
                return
            err, self._error = self._error, None
        raise RuntimeError("ingest worker failed") from err

    def insert(self, series: np.ndarray, ids: np.ndarray,
               ts: np.ndarray) -> None:
        """Submit one ingest batch: append to the registry buffer and wake
        the worker. Returns as soon as the batch is query-visible. Raises
        once the pipeline is closed or its worker has died — data must not
        silently pile into a buffer nothing will ever flush."""
        with spans.span("ingest.submit"):
            self._raise_pending()
            if self._stop:
                raise RuntimeError("ingest pipeline is closed (no worker will "
                                   "flush this data)")
            chunk = BufferChunk(
                series=np.asarray(series, np.float32),
                ids=np.asarray(ids, np.int64),
                ts=np.asarray(ts, np.int64),
            )
            self.lsm.append_chunk(chunk)
            with self._cond:
                lag = self._backlog()
                self.counts["submits"] += 1
                self.counts["lag_sum"] += lag
                self.counts["lag_max"] = max(self.counts["lag_max"], lag)
                self._cond.notify_all()
                if self.max_lag_entries is not None and lag > self.max_lag_entries:
                    # a close() mid-wait still drains: wake on _done (worker
                    # exited), not on _stop alone, so a closing worker gets to
                    # shrink the backlog before we judge it stranded
                    t0 = time.perf_counter_ns()
                    with spans.span("ingest.backpressure"):
                        self._cond.wait_for(
                            lambda: self._done or self._error is not None
                            or self._backlog() <= self.max_lag_entries)
                    self.counts["waits"] += 1
                    self.counts["wait_ns"] += time.perf_counter_ns() - t0
                    if (self._error is None and self._done
                            and self._backlog() > self.max_lag_entries):
                        # the worker exited while this insert waited on
                        # backpressure: its data sits in a buffer nothing will
                        # ever flush — fail loudly instead of returning success
                        raise RuntimeError(
                            "ingest pipeline is closed (no worker will flush "
                            "this data)")
            self._raise_pending()

    def reset_counts(self) -> None:
        with self._cond:
            for name in COUNTS:
                self.counts[name] = 0

    def _backlog(self) -> int:
        snap = self.lsm.registry.current()
        return snap.buffer_n + snap.flushing_n

    def _work_available(self) -> bool:
        snap = self.lsm.registry.current()
        pending = snap.buffer_n >= self.lsm.cfg.buffer_entries
        return pending or (self._flush_all and snap.buffer_n > 0)

    # ------------------------------------------------------------- worker
    def _run(self) -> None:
        while True:
            with self._cond:
                self._cond.wait_for(lambda: self._stop or self._work_available())
                if self._stop and not self._work_available():
                    self._done = True
                    self._cond.notify_all()
                    return
                self._busy = True
            flushes, merges = self.lsm.n_flushes, self.lsm.n_merges
            try:
                # one flush (+ its cascading merges) per loop turn so stop/
                # drain requests are observed between publishes
                self.lsm._flush()
            except BaseException as e:  # noqa: BLE001 - latched for callers
                with self._cond:
                    self._error = e
                    self._stop = True
                    self._busy = False
                    self._done = True
                    self._cond.notify_all()
                return
            with self._cond:
                self.counts["flushes"] += self.lsm.n_flushes - flushes
                self.counts["merges"] += self.lsm.n_merges - merges
                self._busy = False
                self._cond.notify_all()  # backpressure + drain waiters

    # ----------------------------------------------------------- draining
    def drain(self, *, flush_buffer: bool = False,
              timeout: Optional[float] = None) -> bool:
        """Block until the worker has no pending work. With
        ``flush_buffer=True`` the remaining (sub-threshold) buffer is
        flushed too, so every ingested entry ends up in a published run.
        Returns False on timeout."""
        with self._cond:
            self._raise_pending()
            if flush_buffer:
                self._flush_all = True
                self._cond.notify_all()

            def _settled() -> bool:
                if self._error is not None:
                    return True
                if self._work_available() or self._busy:
                    return False
                # a flush_buffer drain is only done once the buffer really
                # emptied — the idle gap between worker turns is not enough
                return not (flush_buffer
                            and self.lsm.registry.current().buffer_n > 0)

            ok = self._cond.wait_for(_settled, timeout=timeout)
            # only the drain that requested the full flush may clear the
            # flag, and only once it was honored — a concurrent plain
            # drain() clearing it would strand this one's request
            if flush_buffer and ok and self._error is None:
                self._flush_all = False
            self._raise_pending()
            return bool(ok)

    def close(self, *, timeout: Optional[float] = 30.0) -> None:
        """Drain pending work and stop the worker (idempotent).

        "Drain" includes the sub-threshold buffer remainder: ``_flush_all``
        is raised together with ``_stop``, so the worker flushes everything
        still buffered before exiting — no ingested entry is stranded in a
        buffer nothing will ever flush."""
        with self._cond:
            self._flush_all = True
            self._stop = True
            self._cond.notify_all()
        self._worker.join(timeout=timeout)
        self._raise_pending()

    @property
    def running(self) -> bool:
        return self._worker.is_alive()
