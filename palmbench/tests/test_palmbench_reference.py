"""The plain reference agrees with the port at a tiny size on the CPU, and
the generator is a function of the seed and the row's position alone."""
import numpy as np
import pytest
import torch

from palmbench import judge, reference
from palmbench.gen import RowStream
from repro_torch.core import (CTree, CTreeConfig, RawStore, StreamConfig,
                              StreamingIndex, SummarizationConfig)

CPU = torch.device("cpu")
SCFG = SummarizationConfig(series_len=256, n_segments=16, card_bits=8)


def rows(seed, label, lo, hi, chunk=1000):
    return RowStream(seed, label, 256, CPU, chunk).rows(lo, hi)


def test_rows_depend_on_seed_and_position_only():
    a = rows(3_000_000_021, "base", 0, 2500)
    b = rows(3_000_000_021, "base", 700, 2100, chunk=1000)
    assert np.array_equal(a[700:2100], b)
    assert not np.array_equal(a, rows(3_000_000_022, "base", 0, 2500))
    assert not np.array_equal(a, rows(3_000_000_021, "query", 0, 2500))
    assert a.dtype == np.float32 and np.isfinite(a).all()
    assert np.abs(a.mean(axis=1)).max() < 1e-5  # z-normalized rows
    assert np.abs(a.std(axis=1) - 1).max() < 1e-5
    # a burst on about a tenth: smooth where white noise is not
    quake = np.abs(np.diff(a, axis=1)).mean(axis=1) < 1.0
    assert 0.05 < quake.mean() < 0.15


@pytest.fixture(scope="module")
def tree():
    X = rows(11, "base", 0, 6000)
    raw = RawStore(256, screen_dtype="f32", device="cpu")
    ids = raw.append(X)
    t = CTree(CTreeConfig(summarization=SCFG, block_size=64, screen_dtype="f32",
                          device="cpu"))
    t.bulk_build(X, ids)
    return t, raw, X


def test_exact_reference_matches_the_tree(tree):
    t, raw, X = tree
    Q = rows(11, "query", 0, 24)
    d2, ids, _ = t.knn_batch(Q, 5, raw=raw)
    Xt = torch.from_numpy(X)
    rd, ri = reference.exact_topk(Q, [(0, Xt[:2500]), (2500, Xt[2500:])], 5)
    assert np.array_equal(np.sort(ri, axis=1), np.sort(ids, axis=1))
    np.testing.assert_allclose(d2, rd, rtol=1e-6)
    true = reference.true_d2(Q, ids, Xt)
    r = judge.readings(d2, ids, rd, ri, true, np.zeros(24, int), np.full(24, 6000))
    assert r["bad_ids"] == 0 and r["dist_gap"] < 1e-6 and r["id_gap"] < 1e-6


def test_window_reference_matches_the_stream():
    idx = StreamingIndex(StreamConfig(scheme="BTP", summarization=SCFG,
                                      buffer_entries=512, growth_factor=4,
                                      block_size=64, storage="model",
                                      screen_dtype="f32", device="cpu"))
    X = rows(13, "stream", 0, 20 * 300)
    for b in range(20):
        idx.ingest(X[b * 300:(b + 1) * 300], np.full(300, b, np.int64))
    Q = rows(13, "query", 0, 16)
    d2, ids, _ = idx.window_knn_batch(Q, 12, 19, k=5)
    Xt = torch.from_numpy(X)
    rd, ri = reference.exact_topk(Q, [(3600, Xt[3600:6000])], 5)
    true = reference.true_d2(Q, ids, Xt)
    r = judge.readings(d2, ids, rd, ri, true, np.full(16, 3600), np.full(16, 6000))
    assert r["bad_ids"] == 0 and r["dist_gap"] < 1e-6 and r["id_gap"] < 1e-6


def test_readings_see_each_kind_of_wrong_answer():
    rd = np.array([[1.0, 2.0, 3.0]])
    ri = np.array([[4, 5, 6]])
    ok = judge.readings(rd, ri, rd, ri, rd, [0], [10])
    assert ok == {"dist_gap": 0.0, "id_gap": 0.0, "bad_ids": 0}
    assert judge.readings(rd, [[4, 4, 6]], rd, ri, rd, [0], [10])["bad_ids"] == 1
    assert judge.readings(rd, [[4, 5, 11]], rd, ri, rd, [0], [10])["bad_ids"] == 1
    assert judge.readings(rd, [[4, 5, -1]], rd, ri, rd, [0], [10])["bad_ids"] == 1
    wrong = judge.readings([[1.0, 2.0, 3.3]], ri, rd, ri, [[1.0, 2.0, 3.3]], [0], [10])
    assert wrong["dist_gap"] == pytest.approx(0.1)
    lie = judge.readings(rd, ri, rd, ri, [[1.0, 2.0, 3.6]], [0], [10])
    assert lie["id_gap"] == pytest.approx(0.2)
