"""The file backend's spans (``storage.*``) on the CPU.

A file-backed stream's ingest, flushes, merges and recovery open each of
the five; their bytes are the bytes the backend counts as written
(``StreamingIndex.measured_io()``); a stream on the modeled disk opens
none; answers are the same traced and untraced; and, as every span, none
encloses a torch operator but ``aten::lift_fresh``.
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import StreamConfig, StreamingIndex, SummarizationConfig
from repro_torch.core.storage.backend import WRITE_COUNTERS

torch.set_num_threads(1)

L = 64
SCFG = SummarizationConfig(series_len=L, n_segments=8, card_bits=8)
STORAGE = ("storage.wal", "storage.persist", "storage.commit",
           "storage.raw_write", "storage.recover")
WRITES = STORAGE[:4]
BATCH, BATCHES = 256, 12


@pytest.fixture(autouse=True)
def _fresh_totals():
    spans.reset()
    yield
    spans.reset()


def _config(storage, path=None):
    # a buffer that 256-row batches do not fill evenly: the WAL's rotation
    # keeps survivors; growth 2 merges every other flush
    return StreamConfig(
        scheme="BTP", summarization=SCFG, buffer_entries=384, growth_factor=2,
        block_size=64, ingest="sync", storage=storage,
        storage_dir=None if path is None else str(path), screen_dtype="f32",
        device="cpu")


def _batches():
    rng = np.random.default_rng(17)
    X = rng.standard_normal((BATCHES * BATCH, L)).astype(np.float32).cumsum(axis=1)
    return [X[b * BATCH:(b + 1) * BATCH] for b in range(BATCHES)]


def _queries():
    rng = np.random.default_rng(18)
    return rng.standard_normal((8, L)).astype(np.float32).cumsum(axis=1)


def _run(index):
    """Every batch ingested, each followed by a window query; the answers."""
    out = []
    for b, X in enumerate(_batches()):
        index.ingest(X, np.full(BATCH, b, np.int64))
        d2, ids, _ = index.window_knn_batch(_queries(), max(0, b - 4), b, k=5)
        out.append((d2, ids))
    return out


@pytest.fixture
def traced(tmp_path):
    """(span totals, torch operators and storage ranges of the trace, the
    answers, the index's measured counters, its WAL's appended bytes) of a
    traced file-backed run and its recovery."""
    index = StreamingIndex(_config("file", tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        answers = _run(index)
        measured = index.measured_io()
        wal_bytes = index.storage.wal.appended_bytes
        StreamingIndex.recover(_config("file"), str(tmp_path)).close()
    index.close()
    ranges, aten = [], []
    for e in prof.profiler.kineto_results.events():
        ev = (e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
        if ev[0].startswith(spans.PREFIX + "storage."):
            ranges.append(ev)
        elif ev[0].startswith("aten::"):
            aten.append(ev)
    return spans.totals(), ranges, aten, answers, measured, wal_bytes


@pytest.mark.parametrize("name", STORAGE)
def test_each_storage_span_fires_on_a_file_backed_stream(traced, name):
    totals, ranges = traced[:2]
    assert totals[name]["calls"] > 0
    assert sum(r[0] == spans.PREFIX + name for r in ranges) == totals[name]["calls"]
    assert (totals[name]["bytes"] > 0) == (name in WRITES)


def test_wal_span_bytes_are_the_records_written(traced):
    totals, measured, wal_bytes = traced[0], traced[4], traced[5]
    assert totals["storage.wal"]["calls"] == BATCHES == measured["wal_records"]
    assert totals["storage.wal"]["bytes"] == wal_bytes == measured["wal_write_bytes"]
    # each record: a 20-byte header, the rows, their ids and timestamps
    assert wal_bytes == BATCHES * (20 + BATCH * (L * 4 + 16))


def test_write_span_bytes_add_up_to_the_measured_writes(traced):
    totals, measured = traced[0], traced[4]
    assert measured["write_bytes"] == sum(measured[k] for k in WRITE_COUNTERS)
    assert sum(totals[n]["bytes"] for n in WRITES) == measured["write_bytes"]
    assert totals["storage.raw_write"]["bytes"] == measured["raw_write_bytes"]
    # the rotation rewrote survivors: the buffer is not a multiple of a batch
    assert measured["wal_rotate_bytes"] > 0
    assert totals["storage.commit"]["calls"] == measured["manifest_commits"]


def test_no_storage_span_encloses_a_torch_operator_but_from_numpy(traced):
    ranges, aten = traced[1], traced[2]
    inside = {name for name, a, b in aten
              if any(ra <= a and b <= rb for _, ra, rb in ranges)}
    assert inside <= {"aten::lift_fresh"}


def test_a_stream_on_the_modeled_disk_opens_no_storage_span():
    index = StreamingIndex(_config("model"))
    with profile(activities=[ProfilerActivity.CPU]):
        _run(index)
    t = spans.totals()
    assert t["clsm.insert"]["calls"] == BATCHES
    assert not [n for n in t if n.startswith("storage.")]


def test_answers_are_the_same_traced_and_untraced(traced, tmp_path):
    index = StreamingIndex(_config("file", tmp_path / "untraced"))
    try:
        plain = _run(index)
    finally:
        index.close()
    assert spans.totals() == traced[0]  # nothing recorded off the profiler
    for (d0, i0), (d1, i1) in zip(plain, traced[3]):
        assert np.array_equal(i0, i1) and d0.tobytes() == d1.tobytes()
