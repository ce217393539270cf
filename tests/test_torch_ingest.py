"""The port's epoch registry and background ingest under concurrency (the
reference suite's stress and retirement tests, run against ``repro_torch``
on the CPU): every query answers from one pinned snapshot, brute-force
equal over that snapshot's entries while flushes and merges publish; an
arena a merge replaces is released only after the last pin drops."""
import threading

import numpy as np
import torch

from repro_torch.core import (
    CLSM, CLSMConfig, RawStore, StreamConfig, StreamingIndex,
    SummarizationConfig,
)
from repro_torch.core.verify_engine import get_engine

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

CFG = SummarizationConfig(series_len=64, n_segments=8, card_bits=6)


def _series(n, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 64)).astype(np.float32).cumsum(axis=1)


def _snapshot_bruteforce(snap, X_all, window, Q, k):
    """Exact top-k over exactly the pinned snapshot's entries (f64 diff
    form, cast to f32 like the engine's re-rank)."""
    ids = [c.ids for c in snap.buffer + snap.flushing]
    ts = [c.ts for c in snap.buffer + snap.flushing]
    for r in snap.runs_newest_first():
        ids.append(r.ids)
        ts.append(r.ts)
    gids = np.concatenate(ids) if ids else np.zeros(0, np.int64)
    gts = np.concatenate(ts) if ts else np.zeros(0, np.int64)
    if window is not None:
        gids = gids[(gts >= window[0]) & (gts <= window[1])]
    vals = np.full((len(Q), k), np.inf, np.float32)
    if gids.size == 0:
        return vals
    X = X_all[gids].astype(np.float64)
    d2 = ((X[None, :, :] - Q[:, None, :].astype(np.float64)) ** 2).sum(-1)
    kk = min(k, gids.size)
    vals[:, :kk] = np.sort(d2.astype(np.float32), axis=1)[:, :kk]
    return vals


def test_queries_racing_ingest_are_snapshot_consistent():
    idx = StreamingIndex(StreamConfig(scheme="BTP", summarization=CFG,
                                      buffer_entries=128, growth_factor=2,
                                      block_size=32, ingest="async",
                                      device="cpu"))
    n_ingest, bsz = 24, 100
    X_parts = [_series(bsz, seed=200 + b) for b in range(n_ingest)]
    X_all = np.concatenate(X_parts)
    errors: list = []
    stop = threading.Event()

    def worker(wid):
        rng = np.random.default_rng(wid)
        n_checked = 0
        try:
            while not stop.is_set() or n_checked < 5:
                Q = _series(12, seed=int(rng.integers(1 << 30)))
                window = None
                if rng.random() < 0.5:
                    t0 = int(rng.integers(0, n_ingest))
                    window = (t0, int(rng.integers(t0, n_ingest)))
                with idx.lsm.registry.pin() as snap:
                    vals, gids, _ = idx.lsm.knn_batch(
                        Q, k=5, raw=idx.raw, window=window, snapshot=snap)
                    bv = _snapshot_bruteforce(snap, X_all, window, Q, 5)
                np.testing.assert_allclose(vals, bv, rtol=1e-5, atol=1e-4)
                for qi in range(len(Q)):  # no phantom or stale entries
                    for vj, gj in zip(vals[qi], gids[qi]):
                        if gj >= 0:
                            true = float(((X_all[gj] - Q[qi]).astype(np.float64)
                                          ** 2).sum())
                            assert abs(true - float(vj)) <= 1e-4 + 1e-5 * true
                n_checked += 1
        except Exception as e:  # noqa: BLE001 - surfaced on the main thread
            errors.append(e)

    threads = [threading.Thread(target=worker, args=(w,)) for w in range(4)]
    for t in threads:
        t.start()
    for b in range(n_ingest):
        idx.ingest(X_parts[b], np.full(bsz, b, np.int64))
    idx.drain(timeout=300)
    stop.set()
    for t in threads:
        t.join(timeout=120)
    idx.close()
    assert not errors, errors[0]
    assert idx.lsm.n_merges > 0  # the race exercised merges


def test_no_arena_released_while_pinned():
    eng = get_engine("cpu")
    raw = RawStore(64, device="cpu")
    lsm = CLSM(CLSMConfig(summarization=CFG, buffer_entries=64,
                          growth_factor=2, block_size=32, materialized=True,
                          merge=False, device="cpu"), disk=raw.disk)
    for i in range(2):
        x = _series(64, seed=300 + i)
        lsm.insert(x, raw.append(x), np.full(64, i, np.int64))
    runs = lsm.registry.current().runs_newest_first()
    assert len(runs) == 2
    for r in runs:
        r.device_view()  # the arenas exist
    lsm.cfg.merge = True
    before = eng.stats["released_arenas"]
    with lsm.registry.pin():
        lsm._maybe_merge(0)
        assert lsm.registry.retired_pending == 2
        assert eng.stats["released_arenas"] == before  # pinned: kept
    assert lsm.registry.retired_pending == 0
    assert eng.stats["released_arenas"] == before + 2


def test_async_ingest_matches_sync_after_drain():
    out = []
    for mode in ("sync", "async"):
        idx = StreamingIndex(StreamConfig(scheme="BTP", summarization=CFG,
                                          buffer_entries=256, growth_factor=2,
                                          block_size=64, ingest=mode,
                                          device="cpu"))
        for b in range(10):
            idx.ingest(_series(150, seed=400 + b), np.full(150, b, np.int64))
        idx.drain(timeout=60)
        Q = _series(12, seed=9)
        out.append(idx.window_knn_batch(Q, 2, 8, k=4)[:2])
        idx.close()
    np.testing.assert_array_equal(out[0][0], out[1][0])
    np.testing.assert_array_equal(out[0][1], out[1][1])
