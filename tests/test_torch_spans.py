"""The port's host spans (``repro_torch.spans``) on the CPU.

Off the profiler a span is one shared null context and records nothing.
Under ``torch.profiler`` a static tree's exact batch and a stream's ingest
and window queries record every span of the query and ingest paths; self
time leaves out nested spans; every range lies on the clock the benchmark
opens its window with; and no range encloses a torch operator but
``aten::lift_fresh`` (``torch.from_numpy``, which queues nothing): where a
card exists, no span encloses device work.
"""
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import (
    CTree, CTreeConfig, RawStore, StreamConfig, StreamingIndex,
    SummarizationConfig,
)

torch.set_num_threads(1)

L = 64
SCFG = SummarizationConfig(series_len=L, n_segments=8, card_bits=8)
SPANS = ("plan.exact", "plan.buffer", "execute.round", "execute.merge",
         "verify.stage", "verify.rerank", "verify.fallback", "raw.concat",
         "raw.grow", "arena.build", "arena.extend", "clsm.insert", "clsm.flush",
         "clsm.merge")


@pytest.fixture(autouse=True)
def _fresh_totals():
    spans.reset()
    yield
    spans.reset()


def _znorm(X):
    X = X - X.mean(axis=1, keepdims=True)
    return (X / X.std(axis=1, keepdims=True)).astype(np.float32)


def _tree(X, block_size=64):
    raw = RawStore(L, screen_dtype="f32", device="cpu")
    ids = raw.append(X)
    tree = CTree(CTreeConfig(summarization=SCFG, block_size=block_size,
                             screen_dtype="f32", device="cpu"))
    tree.bulk_build(X, ids)
    return tree, raw


def _near_duplicates():
    """16 near copies of each row, more than a slate holds: no certificate
    clears them, so the host re-screens every query."""
    rng = np.random.default_rng(2)
    base = (3000.0 + 0.01 * rng.standard_normal((256, L))).astype(np.float32)
    X = (np.tile(base, (16, 1))
         + 1e-6 * rng.standard_normal((4096, L))).astype(np.float32)
    Q = np.stack([X[i] + 0.001 * rng.standard_normal(L).astype(np.float32)
                  for i in range(16)])
    return X, Q


def _stream():
    return StreamingIndex(StreamConfig(
        scheme="BTP", summarization=SCFG, buffer_entries=1024, growth_factor=4,
        block_size=64, materialized=False, ingest="sync", storage="model",
        screen_dtype="f32", device="cpu"))


def _calls():
    """The traced calls, each a thunk: two exact batches over static trees
    (one whose certificate fails), then a stream's ingests and window
    queries (flushes, a merge, the store's concatenation, arena extends)."""
    rng = np.random.default_rng(7)
    tree, raw = _tree(_znorm(rng.standard_normal((8192, L))))
    Q = _znorm(rng.standard_normal((16, L)))
    hard_X, hard_Q = _near_duplicates()
    hard_tree, hard_raw = _tree(hard_X, block_size=256)  # one device pass
    index = _stream()
    calls = [lambda: tree.knn_batch(Q, 5, raw=raw),
             lambda: hard_tree.knn_batch(hard_Q, 5, raw=hard_raw)]
    for b in range(12):
        X = _znorm(rng.standard_normal((512, L)))
        calls.append(lambda X=X, b=b: index.ingest(X, np.full(512, b, np.int64)))
        calls.append(lambda b=b: index.window_knn_batch(Q, max(0, b - 6), b, k=5))
    return calls


@pytest.fixture(scope="module")
def traced():
    """(range events, aten events, call windows, span totals) of one traced
    run of :func:`_calls`."""
    calls = _calls()
    spans.reset()
    windows = []
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for call in calls:
            t0 = time.time_ns()
            call()
            windows.append((t0, time.time_ns()))
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
    return ranges, aten, windows, totals


def test_off_the_profiler_a_span_is_the_shared_null_context():
    assert spans.span("plan.exact") is spans.span("raw.concat", 1 << 20)
    with spans.span("plan.exact") as s:
        assert s is None
    rng = np.random.default_rng(3)
    tree, raw = _tree(_znorm(rng.standard_normal((8192, L))))
    tree.knn_batch(_znorm(rng.standard_normal((16, L))), 5, raw=raw)
    assert spans.totals() == {}


@pytest.mark.parametrize("name", SPANS)
def test_the_traced_paths_record_every_span(traced, name):
    ranges, _, _, totals = traced
    assert totals[name]["calls"] > 0
    assert totals[name]["total_ns"] >= totals[name]["self_ns"] >= 0
    # on one thread every call is one profiler range
    assert sum(r[0] == spans.PREFIX + name for r in ranges) == totals[name]["calls"]


def test_bytes_of_the_store_concatenation_and_the_arena(traced):
    totals = traced[3]
    # each static tree's store is concatenated once (8,192 and 4,096 rows),
    # the stream's after appends that a device pass then reads
    concat = totals["raw.concat"]
    assert concat["bytes"] % (L * 4) == 0 and concat["calls"] >= 3
    assert concat["bytes"] > (8192 + 4096) * L * 4
    assert totals["arena.build"]["bytes"] >= (8192 + 4096) * L * 4
    assert totals["arena.extend"]["bytes"] % (L * 4) == 0
    assert totals["arena.extend"]["bytes"] > 0


def test_self_time_leaves_out_the_nested_spans(traced):
    t = traced[3]
    # clsm.insert > clsm.flush > clsm.merge, nothing else inside them
    assert t["clsm.insert"]["self_ns"] == (t["clsm.insert"]["total_ns"]
                                           - t["clsm.flush"]["total_ns"])
    assert t["clsm.flush"]["self_ns"] == (t["clsm.flush"]["total_ns"]
                                          - t["clsm.merge"]["total_ns"])
    assert t["clsm.merge"]["self_ns"] == t["clsm.merge"]["total_ns"]
    for name in SPANS:
        if not name.startswith("clsm."):
            assert t[name]["self_ns"] == t[name]["total_ns"], name


def test_ranges_lie_on_the_clock_of_the_benchmark_window(traced):
    ranges, _, windows, _ = traced
    slack = 1_000_000  # 1 ms
    starts = [w[0] for w in windows]
    for name, a, b in ranges:
        i = int(np.searchsorted(starts, a + slack, side="right")) - 1
        assert i >= 0, name
        t0, t1 = windows[i]
        assert t0 - slack <= a <= b <= t1 + slack, (name, a - t0, t1 - b)


def test_no_span_encloses_a_torch_operator_but_from_numpy(traced):
    ranges, aten, _, _ = traced
    inside = set()
    for name, a, b in aten:
        if any(ra <= a and b <= rb for _, ra, rb in ranges):
            inside.add(name)
    assert inside <= {"aten::lift_fresh"}


def test_spans_of_one_request_share_its_number(monkeypatch):
    """The outermost entry point numbers the request; a nested one (the
    stream's window query calls the LSM's) keeps the number."""
    seen = []

    def recording(name, args=None):
        seen.append((name, args))
        return real(name, args)

    real = spans.record_function
    monkeypatch.setattr(spans, "record_function", recording)
    rng = np.random.default_rng(5)
    tree, raw = _tree(_znorm(rng.standard_normal((8192, L))))
    Q = _znorm(rng.standard_normal((16, L)))
    index = _stream()
    with profile(activities=[ProfilerActivity.CPU]):
        tree.knn_batch(Q, 5, raw=raw)
        tree.knn_batch(Q, 5, raw=raw)
        for b in range(3):
            index.ingest(_znorm(rng.standard_normal((512, L))),
                         np.full(512, b, np.int64))
        mark = len(seen)
        index.window_knn_batch(Q, 0, 2, k=5)
    assert all(a and a.startswith("request=") for _, a in seen)
    numbers = [a for _, a in seen]
    # two tree batches, three ingests, one window query
    assert len(dict.fromkeys(numbers)) == 6
    assert len(set(numbers[mark:])) == 1
    assert spans.span("plan.exact") is spans.span("raw.concat")  # off again


def test_async_ingest_adds_its_worker_spans_to_the_totals():
    index = StreamingIndex(StreamConfig(
        scheme="BTP", summarization=SCFG, buffer_entries=1024, growth_factor=4,
        block_size=64, ingest="async", storage="model", screen_dtype="f32",
        device="cpu"))
    rng = np.random.default_rng(11)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for b in range(10):
                index.ingest(_znorm(rng.standard_normal((512, L))),
                             np.full(512, b, np.int64))
            assert index.drain(timeout=60)
    finally:
        index.close()
    t = spans.totals()
    assert t["clsm.flush"]["calls"] == 5 and t["clsm.merge"]["calls"] == 1
    assert "clsm.insert" not in t  # the pipeline buffers without CLSM.insert


def test_totals_from_several_threads_add_up():
    n, threads = 2000, 4

    def work():
        for _ in range(n):
            with spans.span("verify.stage", 3):
                pass

    with profile(activities=[ProfilerActivity.CPU]):
        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()
    t = spans.totals()["verify.stage"]
    assert t["calls"] == n * threads and t["bytes"] == 3 * n * threads
