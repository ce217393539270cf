"""The port's streaming window queries against the reference.

The same stream (made with numpy) goes into a reference and a port
``StreamingIndex`` under PP, TP and BTP, with sync and async ingest, at
every screen dtype. ``window_knn_batch`` and ``window_knn_approx_batch``
must return the same ids and the same f32 d2, the approximate tier the same
recall@k per query, and both engines the same device-pass and fallback
counts. The batches clear the engine's device floors (more than
``MIN_DEVICE_BATCH`` queries, windows of more than ``MIN_DEVICE_CANDIDATES``
entries), so the port's verification runs its screen+select path (the plain
versions, on the CPU).
"""
import numpy as np
import pytest
import torch

pytest.importorskip("jax")

import repro.core as R  # noqa: E402
import repro_torch.core as P  # noqa: E402
from repro.core import verify_engine as rve  # noqa: E402
from repro_torch.core import verify_engine as pve  # noqa: E402

# the suite runs several workers on a few cores: one intra-op thread each
torch.set_num_threads(1)

D = 64
BATCHES, BSZ = 12, 300
WINDOWS = [(2, 9), (0, 11), (6, 11)]


def _cfg(pkg, scheme, ingest, dtype):
    scfg = pkg.SummarizationConfig(series_len=D, n_segments=8, card_bits=6)
    kw = {"device": "cpu"} if pkg is P else {}
    return pkg.StreamConfig(scheme=scheme, summarization=scfg,
                            buffer_entries=1024, growth_factor=3,
                            block_size=128, ingest=ingest, screen_dtype=dtype,
                            **kw)


def _engine(pkg):
    return rve.get_engine() if pkg is R else pve.get_engine("cpu")


def _serve(pkg, scheme, ingest, dtype):
    """Ingest the stream, querying every fourth batch (after a drain, so an
    async worker has published the same runs as the sync path)."""
    idx = pkg.StreamingIndex(_cfg(pkg, scheme, ingest, dtype))
    eng = _engine(pkg)
    calls0, fb0 = eng.stats["calls"], eng.stats["fallbacks"]
    rng = np.random.default_rng(1)
    qrng = np.random.default_rng(7)
    out = []
    try:
        for b in range(BATCHES):
            x = rng.standard_normal((BSZ, D)).astype(np.float32).cumsum(axis=1)
            idx.ingest(x, np.full(BSZ, b, np.int64))
            if (b + 1) % 4:
                continue
            idx.drain()
            Q = qrng.standard_normal((12, D)).astype(np.float32).cumsum(axis=1)
            for t0, t1 in WINDOWS:
                if t0 > b:
                    continue
                ev, eids, _ = idx.window_knn_batch(Q, t0, t1, k=5)
                av, aids, _ = idx.window_knn_approx_batch(Q, t0, t1, k=5,
                                                          n_blocks=2)
                recall = [P.recall_at_k(aids[i:i + 1], eids[i:i + 1])
                          for i in range(Q.shape[0])]
                out.append((ev, eids, av, aids, np.array(recall)))
        out.append(idx.n_partitions)
    finally:
        idx.close()
    return out, eng.stats["calls"] - calls0, eng.stats["fallbacks"] - fb0


@pytest.mark.parametrize("dtype", ["f32", "bf16", "int8"])
@pytest.mark.parametrize("ingest", ["sync", "async"])
@pytest.mark.parametrize("scheme", ["PP", "TP", "BTP"])
def test_window_queries_equal_reference(scheme, ingest, dtype):
    got, calls, fallbacks = _serve(P, scheme, ingest, dtype)
    want, rcalls, rfallbacks = _serve(R, scheme, ingest, dtype)
    assert got[-1] == want[-1]  # the same partitions
    assert len(got) == len(want) > 1
    for g, w in zip(got[:-1], want[:-1]):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert calls == rcalls  # the device screen ran, pass for pass
    assert fallbacks == rfallbacks
    # TP never merges its 1024-entry flushes, so no pass clears the
    # candidate floor; the merging schemes verify on the device
    assert calls > 0 or scheme == "TP"


def test_exact_window_answers_are_brute_force():
    """The port's exact tier alone, held to an f64 scan of the window."""
    idx = P.StreamingIndex(_cfg(P, "BTP", "sync", "int8"))
    rng = np.random.default_rng(1)
    xs = []
    for b in range(BATCHES):
        x = rng.standard_normal((BSZ, D)).astype(np.float32).cumsum(axis=1)
        idx.ingest(x, np.full(BSZ, b, np.int64))
        xs.append(x)
    X = np.concatenate(xs).astype(np.float64)
    T = np.repeat(np.arange(BATCHES), BSZ)
    Q = np.random.default_rng(3).standard_normal((12, D)).astype(
        np.float32).cumsum(axis=1)
    for t0, t1 in WINDOWS:
        vals, ids, _ = idx.window_knn_batch(Q, t0, t1, k=5)
        inwin = np.nonzero((T >= t0) & (T <= t1))[0]
        d2 = ((Q.astype(np.float64)[:, None, :] - X[inwin][None]) ** 2).sum(-1)
        bf = inwin[np.argsort(d2, axis=1, kind="stable")[:, :5]]
        np.testing.assert_array_equal(ids, bf)
        np.testing.assert_allclose(vals, np.sort(d2, axis=1)[:, :5], rtol=1e-6)
