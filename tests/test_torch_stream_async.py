"""The async BTP stream (``StreamConfig(ingest="async")``) on the CPU: its
flush, sort and merge run on the ingest worker, which a test gate holds
inside each flush once it has taken its chunk, so queries see buffered
chunks, in-flight flush chunks and merges published between two steps.
Every window query answers as the sync stream does, bit for bit, and as
the benchmark's plain reference (``palmbench/reference.py``, float64)
does within the benchmark's limits. Backpressure engages past
``max_lag_entries`` and releases; a drain leaves every id in the runs
once; ``ingest.submit`` and ``ingest.backpressure`` open on the caller's
thread and enclose no torch operator, ``clsm.flush`` opens on the
worker's; the pipeline's counters match a count kept by hand."""
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from palmbench import judge, reference  # noqa: E402
from palmbench.gen import RowStream  # noqa: E402
from repro_torch import spans  # noqa: E402
from repro_torch.core import (  # noqa: E402
    StreamConfig, StreamingIndex, SummarizationConfig,
)

torch.set_num_threads(1)

L, BATCH, BUFFER, WINDOW, K = 64, 128, 256, 4, 5
LIMIT = 4e-7  # the stream cells' dist_gap and id_gap
SEED = 2_147_483_701
WAIT_S = 60  # the longest any wait in these tests may take


def _config(ingest, max_lag=None):
    return StreamConfig(
        scheme="BTP", summarization=SummarizationConfig(series_len=L, n_segments=8,
                                                        card_bits=8),
        buffer_entries=BUFFER, growth_factor=2, block_size=32, ingest=ingest,
        max_lag_entries=max_lag, storage="model", screen_dtype="f32",
        device="cpu")


class Gate:
    """Holds the ingest worker in each flush, after it has taken its chunk
    from the buffer and before it builds the run, until let through."""

    def __init__(self, index):
        self._cond = threading.Condition()
        self._permits, self._open, self.held = 0, False, 0
        real = index.lsm.registry.take_for_flush

        def take(n):
            out = real(n)
            with self._cond:
                self.held += 1
                self._cond.notify_all()
                assert self._cond.wait_for(lambda: self._open or self._permits,
                                           timeout=WAIT_S)
                if not self._open:
                    self._permits -= 1
                self.held -= 1
            return out

        index.lsm.registry.take_for_flush = take

    def wait_held(self):
        with self._cond:
            assert self._cond.wait_for(lambda: self.held, timeout=WAIT_S)

    def let_through(self, n=1):
        with self._cond:
            self._permits += n
            self._cond.notify_all()

    def open(self):
        with self._cond:
            self._open = True
            self._cond.notify_all()


def _rows():
    return RowStream(SEED, "stream", L, "cpu", BATCH * 4)


def _ingest(index, rows, b):
    return index.ingest(rows.rows(b * BATCH, (b + 1) * BATCH),
                        np.full(BATCH, b, np.int64))


def test_window_answers_equal_the_sync_streams_and_the_reference():
    prefill, steps = 10, 12
    rows, queries = _rows(), RowStream(SEED, "query", L, "cpu", 64)
    sync, lazy = StreamingIndex(_config("sync")), StreamingIndex(_config("async"))
    seen = {"buffer_chunks": 0, "flushing": 0, "merges_between_steps": 0}
    asked = []
    try:
        for b in range(prefill):
            _ingest(sync, rows, b)
            _ingest(lazy, rows, b)
        assert lazy.drain(timeout=WAIT_S)
        gate = Gate(lazy)
        merges = lazy.lsm.n_merges
        for b in range(prefill, prefill + steps):
            if b == prefill + 6:  # the held flushes go through, merges after
                gate.open()
                assert lazy.drain(timeout=WAIT_S)
            ids = _ingest(lazy, rows, b)
            assert np.array_equal(ids, _ingest(sync, rows, b))
            if b == prefill + 1:
                gate.wait_held()  # a flush chunk in flight from here on
            snap = lazy.lsm.registry.current()
            seen["buffer_chunks"] = max(seen["buffer_chunks"], len(snap.buffer))
            seen["flushing"] = max(seen["flushing"], snap.flushing_n)
            if lazy.lsm.n_merges > merges:
                seen["merges_between_steps"] += 1
                merges = lazy.lsm.n_merges
            Q = queries.rows(b * 8, (b + 1) * 8)
            t0 = max(0, b - WINDOW)
            d2, got, _ = lazy.window_knn_batch(Q, t0, b, k=K)
            d2_sync, got_sync, _ = sync.window_knn_batch(Q, t0, b, k=K)
            assert np.array_equal(d2, d2_sync) and np.array_equal(got, got_sync), b
            asked.append((b, Q, d2, got))
    finally:
        sync.close()
        lazy.close()
    assert seen["buffer_chunks"] >= 3 and seen["flushing"] == BUFFER
    assert seen["merges_between_steps"] >= 1, seen

    X = rows.device_rows(0, (prefill + steps) * BATCH)
    ref_d, ref_i, lo, hi = [], [], [], []
    for b, Q, _, _ in asked:
        a, z = max(0, b - WINDOW) * BATCH, (b + 1) * BATCH
        d, i = reference.exact_topk(Q, [(a, X[a:z])], K)
        ref_d.append(d)
        ref_i.append(i)
        lo.append(np.full(len(Q), a))
        hi.append(np.full(len(Q), z))
    Q = np.concatenate([x[1] for x in asked])
    got_i = np.concatenate([x[3] for x in asked])
    r = judge.readings(np.concatenate([x[2] for x in asked]), got_i,
                       np.concatenate(ref_d), np.concatenate(ref_i),
                       reference.true_d2(Q, got_i, X), np.concatenate(lo),
                       np.concatenate(hi))
    assert r["dist_gap"] <= LIMIT and r["id_gap"] <= LIMIT and r["bad_ids"] == 0, r


def test_backpressure_engages_past_max_lag_and_releases():
    index = StreamingIndex(_config("async", max_lag=BUFFER))
    gate = Gate(index)
    rows = _rows()
    try:
        _ingest(index, rows, 0)
        _ingest(index, rows, 1)  # a backlog of 256, not over the limit
        gate.wait_held()
        done = threading.Event()
        t = threading.Thread(target=lambda: (_ingest(index, rows, 2), done.set()))
        t.start()
        assert not done.wait(0.3)  # 384 unflushed: the third batch waits
        assert index.pipeline.counts["waits"] == 0
        gate.let_through()  # the held flush publishes: a backlog of 128
        t.join(WAIT_S)
        assert done.is_set() and not t.is_alive()
        counts = index.pipeline.counts
        assert counts["waits"] == 1 and counts["wait_ns"] >= 0.3e9, counts
        assert index.ingest_lag()["lag_entries"] <= BUFFER
        gate.open()
        assert index.drain(flush_buffer=True, timeout=WAIT_S)
    finally:
        index.close()


def test_after_a_drain_every_id_is_in_the_runs_once():
    index = StreamingIndex(_config("async", max_lag=2 * BUFFER))
    rows, n = _rows(), 23
    try:
        for b in range(n):
            _ingest(index, rows, b)
            if b % 5 == 0:
                time.sleep(0.01)  # let the worker run between some steps
        assert index.drain(flush_buffer=True, timeout=WAIT_S)
        snap = index.lsm.registry.current()
        assert snap.buffer_n == 0 and snap.flushing_n == 0
        held = np.concatenate([r.ids for r in snap.runs_newest_first()])
        assert np.array_equal(np.sort(held), np.arange(n * BATCH))
    finally:
        index.close()


@pytest.fixture(scope="module")
def traced():
    """One profiled async stream with a wait on backpressure: (the spans
    opened, each with its thread's name; the trace's ``coconut.`` ranges
    and ``aten::`` events; the span totals)."""
    opened = []

    def recording(name, args=None):
        opened.append((name, threading.current_thread().name))
        return real(name, args)

    real = spans.record_function
    spans.record_function = recording
    spans.reset()
    index = StreamingIndex(_config("async", max_lag=BUFFER))
    gate = Gate(index)
    rows = _rows()
    Q = RowStream(SEED, "query", L, "cpu", 64).rows(0, 8)
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            for b in range(2):
                _ingest(index, rows, b)
                index.window_knn_batch(Q, 0, b, k=K)
            gate.wait_held()
            release = threading.Timer(0.2, gate.open)
            release.start()
            _ingest(index, rows, 2)  # waits until the timer opens the gate
            index.window_knn_batch(Q, 0, 2, k=K)
            assert index.drain(flush_buffer=True, timeout=WAIT_S)
            release.join(WAIT_S)
    finally:
        spans.record_function = real
        index.close()
    totals = spans.totals()
    spans.reset()
    ranges, aten = [], []
    for e in prof.profiler.kineto_results.events():
        a = e.start_ns()
        ev = (e.name(), a, a + e.duration_ns())
        if ev[0].startswith(spans.PREFIX):
            ranges.append(ev)
        elif ev[0].startswith("aten::"):
            aten.append(ev)
    return opened, ranges, aten, totals


def test_ingest_spans_open_on_the_callers_thread_and_flushes_on_the_workers(traced):
    opened, _, _, totals = traced
    caller = threading.current_thread().name
    where = {}
    for name, thread in opened:
        where.setdefault(name, set()).add(thread)
    assert where[spans.PREFIX + "ingest.submit"] == {caller}
    assert where[spans.PREFIX + "ingest.backpressure"] == {caller}
    assert where[spans.PREFIX + "clsm.flush"] == {"coconut-ingest"}
    assert totals["ingest.submit"]["calls"] == 3
    assert totals["ingest.backpressure"]["calls"] == 1
    assert totals["ingest.backpressure"]["total_ns"] >= 0.2e9


def test_no_ingest_span_encloses_a_torch_operator(traced):
    _, ranges, aten, _ = traced
    mine = [r for r in ranges if r[0].startswith(spans.PREFIX + "ingest.")]
    assert {r[0] for r in mine} == {spans.PREFIX + "ingest.submit",
                                   spans.PREFIX + "ingest.backpressure"}
    inside = {name for name, a, b in aten
              if any(ra <= a and b <= rb for _, ra, rb in mine)}
    assert inside <= {"aten::lift_fresh"}, inside


def test_pipeline_counts_match_a_count_kept_by_hand():
    """Eight batches of 128 with every flush held: the backlog after the
    j-th append is 128 j (flushing chunks count); then four flushes and,
    at growth 2, three merges (two of level 0, one of level 1)."""
    index = StreamingIndex(_config("async"))
    gate = Gate(index)
    rows, n = _rows(), 8
    try:
        index.pipeline.reset_counts()
        for b in range(n):
            _ingest(index, rows, b)
        counts = dict(index.pipeline.counts)
        gate.open()
        assert index.drain(flush_buffer=True, timeout=WAIT_S)
        after = index.pipeline.counts
    finally:
        index.close()
    lags = [BATCH * (j + 1) for j in range(n)]
    assert counts == {"submits": n, "waits": 0, "wait_ns": 0,
                      "lag_sum": sum(lags), "lag_max": max(lags),
                      "flushes": 0, "merges": 0}
    assert (after["flushes"], after["merges"]) == (n * BATCH // BUFFER, 3)
    index.pipeline.reset_counts()
    assert set(index.pipeline.counts.values()) == {0}
