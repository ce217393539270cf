"""The port's crash-consistent file storage against the reference's.

Every check of ``tests/test_storage.py`` runs on the port (``device="cpu"``)
on the same seeded numpy inputs, and each holds the port to the reference:
WAL files are byte for byte the reference's; the file backend answers
bitwise as the port's model backend and as the reference's file backend;
a crash at any injected point recovers to exactly the acknowledged entry
set, answering as an uncrashed index (of either package) over the same
entries. On top: each package recovers a directory the other wrote, the
arena dtype survives recovery at f32, bf16 and int8 with the device screen
running over the memory-mapped tables, and ``CTree(storage=...)`` drops a
rebuilt run's files.
"""
import glob
import json
import os

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core.storage import wal as rwal  # noqa: E402
from repro_torch.core import verify_engine as pve  # noqa: E402
from repro_torch.core.run_registry import BufferChunk, RunRegistry  # noqa: E402
from repro_torch.core.storage import prefetch as pprefetch  # noqa: E402
from repro_torch.core.storage.wal import WriteAheadLog, replay_file  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

D = 64


def _scfg(pkg):
    return pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)


def _series(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, D)).astype(np.float32).cumsum(axis=1)


def _chunk(n, seed, id0=0, t=0):
    return BufferChunk(series=_series(n, seed),
                       ids=np.arange(id0, id0 + n, dtype=np.int64),
                       ts=np.full(n, t, np.int64))


def _stream_cfg(pkg=P, path=None, backend="model", **kw):
    kw.setdefault("buffer_entries", 64)
    kw.setdefault("block_size", 32)
    kw.setdefault("growth_factor", 2)
    if pkg is P:
        kw.setdefault("device", "cpu")
    return pkg.StreamConfig(scheme="BTP", summarization=_scfg(pkg),
                            storage=backend,
                            storage_dir=None if path is None else str(path),
                            **kw)


def _batches(n_batch, bsz, seed0=0):
    out, t = [], 0
    for b in range(n_batch):
        out.append((_series(bsz, seed0 + b), np.arange(t, t + bsz, dtype=np.int64)))
        t += bsz
    return out


def _ingest(idx, batches):
    for S, ts in batches:
        idx.ingest(S, ts)
    return idx


def _assert_same(a, b):
    """Equal (d2, ids) answers, bit for bit, with equal dtypes."""
    for x, y in zip(a[:2], b[:2]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


# ---------------------------------------------------------------------------
# WAL record mechanics: the port's files are byte for byte the reference's
# ---------------------------------------------------------------------------
def _wal_pair(tmp_path):
    port = WriteAheadLog(str(tmp_path / "port"), series_len=D)
    ref = rwal.WriteAheadLog(str(tmp_path / "ref"), series_len=D)
    return port, ref


def _bytes(path):
    with open(path, "rb") as f:
        return f.read()


def test_wal_roundtrip_with_and_without_ts(tmp_path):
    port, ref = _wal_pair(tmp_path)
    c1 = _chunk(10, seed=1)
    c2 = BufferChunk(series=_series(5, 2), ids=np.arange(10, 15, dtype=np.int64))
    for wal in (port, ref):
        wal.open(0)
        wal.append(c1)
        wal.append(c2)
        wal.close()
    assert _bytes(port.path(0)) == _bytes(ref.path(0))
    for path in (port.path(0), ref.path(0)):  # the port reads either file
        chunks, good = replay_file(path, D)
        assert good == os.path.getsize(path)
        assert len(chunks) == 2
        np.testing.assert_array_equal(chunks[0].series, c1.series)
        np.testing.assert_array_equal(chunks[0].ids, c1.ids)
        np.testing.assert_array_equal(chunks[0].ts, c1.ts)
        np.testing.assert_array_equal(chunks[1].series, c2.series)
        assert chunks[1].ts is None


def test_wal_torn_tail_is_truncated_on_open(tmp_path):
    wal = WriteAheadLog(str(tmp_path), series_len=D)
    wal.open(0)
    wal.append(_chunk(8, seed=3))
    wal.append(_chunk(8, seed=4, id0=8))
    wal.close()
    full = os.path.getsize(wal.path(0))
    with open(wal.path(0), "r+b") as f:  # tear the second record mid-payload
        f.truncate(full - 37)
    torn = _bytes(wal.path(0))
    wal2 = WriteAheadLog(str(tmp_path), series_len=D)
    chunks = wal2.open(0)
    assert len(chunks) == 1 and chunks[0].n == 8
    # the reference truncates the same torn file to the same prefix
    os.makedirs(tmp_path / "ref")
    with open(tmp_path / "ref" / "wal-00000000.log", "wb") as f:
        f.write(torn)
    rchunks = rwal.WriteAheadLog(str(tmp_path / "ref"), series_len=D).open(0)
    assert [c.n for c in rchunks] == [8]
    assert _bytes(wal2.path(0)) == _bytes(tmp_path / "ref" / "wal-00000000.log")
    # the torn tail is physically gone: appends continue from a clean prefix
    wal2.append(_chunk(4, seed=5, id0=8))
    wal2.close()
    chunks, _ = replay_file(wal2.path(0), D)
    assert [c.n for c in chunks] == [8, 4]


def test_wal_corrupt_record_drops_it_and_everything_after(tmp_path):
    wal = WriteAheadLog(str(tmp_path), series_len=D)
    wal.open(0)
    sizes = []
    for i in range(3):
        wal.append(_chunk(6, seed=10 + i, id0=6 * i))
        sizes.append(os.path.getsize(wal.path(0)))
    wal.close()
    with open(wal.path(0), "r+b") as f:  # flip a payload byte of record 2
        f.seek(sizes[0] + 40)
        b = f.read(1)
        f.seek(sizes[0] + 40)
        f.write(bytes([b[0] ^ 0xFF]))
    chunks, good = replay_file(wal.path(0), D)
    assert len(chunks) == 1 and good == sizes[0]  # record 3 goes too
    rchunks, rgood = rwal.replay_file(wal.path(0), D)
    assert (len(rchunks), rgood) == (1, good)


def test_wal_truncate_front_splits_partial_record(tmp_path):
    port, ref = _wal_pair(tmp_path)
    for wal in (port, ref):
        wal.open(0)
        wal.append(_chunk(10, seed=20, id0=0))
        wal.append(_chunk(10, seed=21, id0=10))
    old = port.truncate_front(13)  # splits the second record at entry 3
    ref.truncate_front(13)
    assert old.endswith("wal-00000000.log") and port.log_id == 1
    assert port.entries == 7
    survivors = port.chunks()
    assert len(survivors) == 1
    np.testing.assert_array_equal(survivors[0].ids, np.arange(13, 20))
    # the rotated file replays to the same survivors, and is the reference's
    chunks, _ = replay_file(port.path(1), D)
    np.testing.assert_array_equal(chunks[0].ids, np.arange(13, 20))
    port.close()
    ref.close()
    assert _bytes(port.path(1)) == _bytes(ref.path(1))


# ---------------------------------------------------------------------------
# model-vs-file answer parity, and the reference's file backend
# ---------------------------------------------------------------------------
def _both_tiers(idx, Q):
    return (idx.window_knn_batch(Q, 0, 10**9, k=5),
            idx.window_knn_approx_batch(Q, 50, 200, k=5, n_blocks=2))


@pytest.mark.parametrize("materialized", [False, True])
def test_file_backend_answers_match_model_backend(tmp_path, materialized):
    """Same stream, same queries, both tiers: the port's file backend is
    pure storage — every answer is bitwise-equal to its modeled backend's
    and to the reference's file backend's."""
    Q = _series(4, seed=999)
    batches = _batches(6, 40, seed0=100)
    answers = {}
    for pkg, backend in ((P, "model"), (P, "file"), (R, "file")):
        path = tmp_path / f"{pkg.__name__}-{backend}"
        cfg = _stream_cfg(pkg, path if backend == "file" else None, backend,
                          materialized=materialized)
        answers[pkg, backend] = _both_tiers(_ingest(pkg.StreamingIndex(cfg),
                                                    batches), Q)
    for tier in range(2):
        _assert_same(answers[P, "model"][tier], answers[P, "file"][tier])
        _assert_same(answers[R, "file"][tier], answers[P, "file"][tier])


# ---------------------------------------------------------------------------
# recovery
# ---------------------------------------------------------------------------
def test_fresh_directory_recovers_empty(tmp_path):
    idx = P.StreamingIndex.recover(_stream_cfg(), str(tmp_path))
    assert idx.raw.n == 0 and idx.n_partitions == 0
    assert idx.raw.device.type == "cpu"
    idx.ingest(_series(10, seed=0), np.arange(10, dtype=np.int64))
    assert idx.raw.n == 10


def test_clean_reopen_preserves_answers_and_id_sequence(tmp_path):
    batches = _batches(5, 40, seed0=200)
    idx = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path, "file")), batches)
    Q = _series(3, seed=998)
    got = idx.window_knn_batch(Q, 0, 10**9, k=5)
    n = idx.raw.n
    ref = _ingest(R.StreamingIndex(_stream_cfg(R)), batches)
    _assert_same(ref.window_knn_batch(Q, 0, 10**9, k=5), got)

    idx.close()  # the files close; the index still answers
    _assert_same(got, idx.window_knn_batch(Q, 0, 10**9, k=5))
    idx2 = P.StreamingIndex.recover(_stream_cfg(), str(tmp_path))
    assert idx2.raw.n == n
    runs = list(idx2.lsm.registry.current().runs_newest_first())
    assert runs and all(r.device.type == "cpu" and r._storage is not None
                        for r in runs)
    _assert_same(got, idx2.window_knn_batch(Q, 0, 10**9, k=5))
    # ids keep ascending from the durable extent
    ids = idx2.ingest(_series(8, seed=201), np.arange(n, n + 8, dtype=np.int64))
    np.testing.assert_array_equal(ids, np.arange(n, n + 8))


def _crash_then_recover(tmp_path, point, crash_batch, batches):
    """Ingest until ``point`` fires at ``crash_batch``; recover; return the
    recovered index + how many batches were fully acknowledged."""
    idx = P.StreamingIndex(_stream_cfg(P, tmp_path, "file"))
    n_ok = 0
    for i, (S, ts) in enumerate(batches):
        if i == crash_batch:
            idx.storage.crash_after = point
        try:
            idx.ingest(S, ts)
            n_ok += 1
        except P.SimulatedCrash:
            break
    else:
        raise AssertionError(f"crash point {point!r} never fired")
    # the process is gone; recover from the directory alone
    return P.StreamingIndex.recover(_stream_cfg(), str(tmp_path)), n_ok


def _assert_equals_uncrashed(tmp_path, rec_idx, n_batches, batches, Q, k=5):
    """The recovered index answers bitwise-equal to uncrashed indexes (the
    port's and the reference's file backends) that ingested exactly the
    acknowledged batches."""
    ctl = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path / "control", "file")),
                  batches[:n_batches])
    rctl = _ingest(R.StreamingIndex(_stream_cfg(R, tmp_path / "rcontrol", "file")),
                   batches[:n_batches])
    assert rec_idx.raw.n == ctl.raw.n == rctl.raw.n
    got = rec_idx.window_knn_batch(Q, 0, 10**9, k=k)
    _assert_same(ctl.window_knn_batch(Q, 0, 10**9, k=k), got)
    _assert_same(rctl.window_knn_batch(Q, 0, 10**9, k=k), got)


@pytest.mark.parametrize("point", ["wal-append", "pre-manifest"])
def test_crash_recovery_quick(tmp_path, point):
    """Tier-1 cut of the crash sweep: one point before any commit, one
    between run-publish and manifest commit."""
    batches = _batches(6, 40, seed0=300)
    Q = _series(3, seed=997)
    rec, n_ok = _crash_then_recover(tmp_path, point, 3, batches)
    # the crashed batch WAS WAL-appended before every injected point fired,
    # so it is part of the acknowledged durable set
    _assert_equals_uncrashed(tmp_path, rec, n_ok + 1, batches, Q)


@pytest.mark.slow
@pytest.mark.parametrize("point,crash_batch", [
    ("wal-append", 3), ("flush-taken", 3), ("run-persisted", 3),
    ("pre-manifest", 3), ("post-manifest", 3),
    ("merge-pre-manifest", 6), ("merge-post-manifest", 6),
])
def test_crash_recovery_sweep(tmp_path, point, crash_batch):
    """Every injected point between WAL append and manifest commit (flush
    AND merge paths): recovery equals the uncrashed run bitwise, and
    ingest can continue afterwards with the same equality."""
    batches = _batches(10, 40, seed0=400)
    Q = _series(3, seed=996)
    rec, n_ok = _crash_then_recover(tmp_path, point, crash_batch, batches)
    acked = n_ok + 1
    _assert_equals_uncrashed(tmp_path, rec, acked, batches, Q)
    # life goes on: ingest the remaining batches into the recovered index
    # and a fresh control; answers stay bitwise-equal
    ctl = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path / "resumed", "file")),
                  batches[:acked])
    _ingest(rec, batches[acked:])
    _ingest(ctl, batches[acked:])
    _assert_same(ctl.window_knn_batch(Q, 0, 10**9, k=5),
                 rec.window_knn_batch(Q, 0, 10**9, k=5))


def test_orphan_run_dirs_and_stale_wals_are_deleted(tmp_path):
    idx = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path, "file")),
                  _batches(4, 40, seed0=500))
    runs_dir = tmp_path / "runs"
    os.makedirs(runs_dir / "run-99999999")
    (runs_dir / "run-99999999" / "meta.json").write_text("{}")
    stale = tmp_path / "wal" / "wal-00000099.log"
    stale.write_bytes(b"junk")
    idx2 = P.StreamingIndex.recover(_stream_cfg(), str(tmp_path))
    assert not (runs_dir / "run-99999999").exists()
    assert not stale.exists()
    assert idx2.raw.n == idx.raw.n


def test_manifest_is_valid_json_and_names_live_runs(tmp_path):
    batches = _batches(4, 40, seed0=600)
    idx = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path / "port", "file")),
                  batches)
    _ingest(R.StreamingIndex(_stream_cfg(R, tmp_path / "ref", "file")), batches)
    man = json.loads((tmp_path / "port" / "MANIFEST.json").read_text())
    named = {name for _, names in man["levels"] for name in names}
    on_disk = {os.path.basename(p)
               for p in glob.glob(str(tmp_path / "port" / "runs" / "*"))}
    assert named == on_disk  # every named run exists, no unnamed leftovers
    live = {os.path.basename(r._storage.dir)
            for r in idx.lsm.registry.current().runs_newest_first()}
    assert named == live
    # the reference commits the same manifest after the same stream
    assert man == json.loads((tmp_path / "ref" / "MANIFEST.json").read_text())


# ---------------------------------------------------------------------------
# readahead + measured counters + restore mechanics
# ---------------------------------------------------------------------------
def test_prefetch_counters_advance_and_answers_unchanged(tmp_path):
    idx = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path, "file")),
                  _batches(6, 40, seed0=700))
    pool = pprefetch.get_pool()
    before = pool.stats()["prefetch_spans"]
    Q = _series(4, seed=995)
    got = idx.window_knn_approx_batch(Q, 0, 10**9, k=5, n_blocks=2)
    pool.drain()
    stats = pool.stats()
    assert stats["prefetch_spans"] > before
    assert stats["prefetch_errors"] == 0
    # readahead is advisory: a second identical query answers identically
    _assert_same(got, idx.window_knn_approx_batch(Q, 0, 10**9, k=5, n_blocks=2))


def test_measured_counters_populated(tmp_path):
    idx = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path, "file")),
                  _batches(4, 40, seed0=800))
    idx.window_knn_batch(_series(2, seed=994), 0, 10**9, k=3)
    m = idx.measured_io()
    assert m["raw_write_bytes"] == idx.raw.n * D * 4
    assert m["wal_records"] == 4
    assert m["wal_write_bytes"] > 0
    assert m["run_write_bytes"] > 0
    assert m["manifest_commits"] > 0
    assert m["raw_read_bytes"] > 0
    # the modeled backend measures nothing
    assert P.StreamingIndex(_stream_cfg()).measured_io() == {}


def test_registry_restore_is_one_epoch_bump_and_guards_nonempty():
    reg = RunRegistry()
    e0 = reg.current().epoch
    snap = reg.restore([(0, [object()]), (1, [object(), object()])],
                       [_chunk(5, seed=900)])
    assert snap.epoch == e0 + 1  # ONE bump for the whole recovered state
    assert snap.n_runs == 3 and snap.buffer_n == 5 and snap.flushing == ()
    with pytest.raises(ValueError):
        reg.restore([], [_chunk(1, seed=901)])


# ---------------------------------------------------------------------------
# each package recovers the other's directory
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("materialized", [False, True])
@pytest.mark.parametrize("writer", ["reference", "port"])
def test_each_package_recovers_the_others_directory(tmp_path, writer,
                                                    materialized):
    """One package writes a directory (runs, manifest, a WAL holding the
    unflushed tail); the other recovers it and answers, on both tiers, as
    the writer did."""
    wpkg, rpkg = (R, P) if writer == "reference" else (P, R)
    batches = _batches(7, 40, seed0=1000)
    Q = _series(4, seed=993)
    w = _ingest(wpkg.StreamingIndex(_stream_cfg(wpkg, tmp_path, "file",
                                                materialized=materialized)),
                batches)
    assert w.lsm.registry.current().buffer_n > 0  # the WAL is not empty
    want = _both_tiers(w, Q)
    rec = rpkg.StreamingIndex.recover(_stream_cfg(rpkg, materialized=materialized),
                                      str(tmp_path))
    assert rec.raw.n == w.raw.n == 7 * 40
    assert rec.n_partitions == w.n_partitions
    got = _both_tiers(rec, Q)
    for tier in range(2):
        _assert_same(want[tier], got[tier])


# ---------------------------------------------------------------------------
# arena dtypes through recovery, the device screen over the mapped tables
# ---------------------------------------------------------------------------
def _dtype_cfg(pkg, path, dtype):
    return _stream_cfg(pkg, path, "file", buffer_entries=1024, block_size=128,
                       growth_factor=3, screen_dtype=dtype)


def _dtype_answers(idx, Q):
    return [idx.window_knn_batch(Q, t0, t1, k=5) for t0, t1 in ((0, 11), (2, 9))]


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
def test_screen_dtype_survives_file_backend_recovery(tmp_path, dtype):
    """The raw store and every run keep the stream's arena dtype through
    the meta round trip; before and after recovery the device screen runs
    over arenas filled from the memory-mapped files (12 queries, windows of
    thousands of entries: past the engine's floors) and answers as the
    reference's file backend."""
    rng = np.random.default_rng(5)
    batches = [(rng.standard_normal((300, D)).astype(np.float32).cumsum(axis=1),
                np.full(300, b, np.int64)) for b in range(12)]
    Q = _series(12, seed=992)
    idx = _ingest(P.StreamingIndex(_dtype_cfg(P, tmp_path / "port", dtype)),
                  batches)
    assert idx.raw.screen_dtype == dtype  # FileStore raw inherits the cfg
    runs = list(idx.lsm.registry.current().runs_newest_first())
    assert runs and all(r.screen_dtype == dtype for r in runs)
    ref = _ingest(R.StreamingIndex(_dtype_cfg(R, tmp_path / "ref", dtype)),
                  batches)
    want = _dtype_answers(ref, Q)
    eng = pve.get_engine("cpu")
    calls0 = eng.stats["calls"]
    for a, b in zip(want, _dtype_answers(idx, Q)):
        _assert_same(a, b)
    assert eng.stats["calls"] > calls0  # the device screen served
    idx.close()
    rec = P.StreamingIndex.recover(
        _stream_cfg(buffer_entries=1024, block_size=128, growth_factor=3,
                    screen_dtype=dtype), str(tmp_path / "port"))
    rruns = list(rec.lsm.registry.current().runs_newest_first())
    assert rruns and all(r.screen_dtype == dtype for r in rruns)
    assert isinstance(rec.raw._all(), np.memmap)
    calls0 = eng.stats["calls"]
    for a, b in zip(want, _dtype_answers(rec, Q)):
        _assert_same(a, b)
    assert eng.stats["calls"] > calls0
    rec.close()


# ---------------------------------------------------------------------------
# the static index on the file backend
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("how", ["bulk_build", "insert"])
def test_ctree_rebuild_drops_the_old_runs_directory(tmp_path, how):
    """A CTree built with ``storage=`` persists its run; a rebuild (a second
    bulk build, or inserts past the gap capacity) persists the new run and
    deletes the old one's directory. Answers equal the reference CTree's."""
    X = _series(600, seed=31)
    Q = _series(3, seed=32)
    eng = P.StorageEngine(str(tmp_path), _scfg(P), device="cpu")
    ids = eng.raw.append(X[:500])
    rraw = R.RawStore(D)
    rraw.append(X[:500])
    trees = []
    for pkg, kw in ((P, {"storage": eng}), (R, {})):
        cfg = pkg.CTreeConfig(summarization=_scfg(pkg), block_size=64,
                              fill_factor=0.9,
                              **({"device": "cpu"} if pkg is P else {}))
        ct = pkg.CTree(cfg, **kw)
        ct.bulk_build(X[:500], ids)
        trees.append(ct)
    ct, rct = trees
    first = ct.run._storage.dir
    assert os.path.isdir(first) and ct.run.device.type == "cpu"
    if how == "bulk_build":
        for t in trees:
            t.bulk_build(X[:500], ids)
    else:
        new = eng.raw.append(X[500:])
        rraw.append(X[500:])
        for t in trees:
            assert t.insert(X[500:], new)  # past the gaps: rebuilt
    assert not os.path.exists(first)
    assert os.path.isdir(ct.run._storage.dir)
    assert os.listdir(tmp_path / "runs") == [os.path.basename(ct.run._storage.dir)]
    _assert_same(rct.knn_batch(Q, k=5, raw=rraw), ct.knn_batch(Q, k=5, raw=eng.raw))


@pytest.mark.parametrize("materialized", [False, True])
def test_kernel_backend_over_mapped_runs_copies_and_answers_as_the_model(
        tmp_path, materialized):
    """``backend="kernel"`` over a file-backed index: the rows a pass sends
    to ``topk_ed`` come off read-only memmaps (a materialized run's
    contiguous span is a slice of its ``series.bin``); they are copied,
    never aliased (torch would warn), and the answers equal the model
    backend's on both tiers."""
    import warnings

    Q = _series(4, seed=991)
    batches = _batches(6, 40, seed0=1100)
    out = []
    for backend in ("model", "file"):
        idx = _ingest(P.StreamingIndex(_stream_cfg(
            P, tmp_path if backend == "file" else None, backend,
            materialized=materialized)), batches)
        with warnings.catch_warnings():
            warnings.simplefilter("error")
            out.append((idx.window_knn_batch(Q, 0, 10**9, k=5, backend="kernel"),
                        idx.window_knn_approx_batch(Q, 0, 10**9, k=5, n_blocks=2,
                                                    backend="kernel")))
    for tier in range(2):
        _assert_same(out[0][tier], out[1][tier])


def test_async_ingest_commits_on_the_worker(tmp_path):
    """Under async ingest the flushes and merges run on the pipeline's
    worker through the same persist -> publish -> commit steps: after a
    drain the manifest names the live runs, the WAL holds only the buffer,
    and the recovered index answers as the writer and the reference."""
    batches = _batches(7, 40, seed0=1200)
    Q = _series(4, seed=990)
    idx = _ingest(P.StreamingIndex(_stream_cfg(P, tmp_path, "file",
                                               ingest="async")), batches)
    assert idx.drain(timeout=60)
    snap = idx.lsm.registry.current()
    man = json.loads((tmp_path / "MANIFEST.json").read_text())
    assert {name for _, names in man["levels"] for name in names} == {
        os.path.basename(r._storage.dir) for r in snap.runs_newest_first()}
    assert idx.storage.wal.entries == snap.buffer_n
    want = _both_tiers(idx, Q)
    idx.close()
    rec = P.StreamingIndex.recover(_stream_cfg(), str(tmp_path))
    ref = _ingest(R.StreamingIndex(_stream_cfg(R)), batches)
    for tier, got in enumerate(_both_tiers(rec, Q)):
        _assert_same(want[tier], got)
        _assert_same(_both_tiers(ref, Q)[tier], got)
