"""A file-backed BTP stream (``StreamConfig(storage="file")``) on the CPU,
dropped without ``close()`` mid-stream and at its end as a crash leaves it,
reopened each time with ``StreamingIndex.recover``: every window query,
before and after each recovery, answers as the benchmark's plain reference
(``palmbench/reference.py``, float64) does, id for id, within the
benchmark's limits."""
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from palmbench import judge, reference  # noqa: E402
from palmbench.gen import RowStream  # noqa: E402
from repro_torch.core import (  # noqa: E402
    StreamConfig, StreamingIndex, SummarizationConfig,
)

torch.set_num_threads(1)

L, BATCH, BATCHES, WINDOW, K = 64, 200, 14, 4, 5
CRASH_AFTER = 7  # batches ingested before the mid-stream recovery
LIMIT = 4e-7  # the stream cells' dist_gap and id_gap


def _config(path):
    return StreamConfig(
        scheme="BTP", summarization=SummarizationConfig(series_len=L, n_segments=8,
                                                        card_bits=8),
        buffer_entries=512, growth_factor=2, block_size=64, ingest="sync",
        storage="file", storage_dir=str(path), screen_dtype="f32", device="cpu")


def test_recovered_stream_answers_every_window_as_the_reference(tmp_path):
    rows = RowStream(2_147_483_659, "stream", L, "cpu", BATCH * 4)
    queries = RowStream(2_147_483_659, "query", L, "cpu", 64)
    X = rows.device_rows(0, BATCHES * BATCH)
    index = StreamingIndex(_config(tmp_path))
    asked = []  # (batch, queries, d2, ids)

    def ask(idx, b):
        Q = queries.rows(b * 8, (b + 1) * 8)
        d2, ids, _ = idx.window_knn_batch(Q, max(0, b - WINDOW), b, k=K)
        asked.append((b, Q, d2, ids))

    for b in range(BATCHES):
        ids = index.ingest(rows.rows(b * BATCH, (b + 1) * BATCH),
                           np.full(BATCH, b, np.int64))
        assert np.array_equal(ids, np.arange(b * BATCH, (b + 1) * BATCH))
        ask(index, b)
        if b + 1 == CRASH_AFTER:
            index = StreamingIndex.recover(_config(tmp_path), str(tmp_path))
            assert index.raw.n == CRASH_AFTER * BATCH
            ask(index, b)
    index = StreamingIndex.recover(_config(tmp_path), str(tmp_path))
    try:
        assert index.raw.n == BATCHES * BATCH
        ask(index, BATCHES - 1)
    finally:
        index.close()

    ref_d, ref_i, lo, hi = [], [], [], []
    for b, Q, _, _ in asked:
        a, z = max(0, b - WINDOW) * BATCH, (b + 1) * BATCH
        d, i = reference.exact_topk(Q, [(a, X[a:z])], K)
        ref_d.append(d)
        ref_i.append(i)
        lo.append(np.full(len(Q), a))
        hi.append(np.full(len(Q), z))
    got_d = np.concatenate([x[2] for x in asked])
    got_i = np.concatenate([x[3] for x in asked])
    Q = np.concatenate([x[1] for x in asked])
    ref_i = np.concatenate(ref_i)
    r = judge.readings(got_d, got_i, np.concatenate(ref_d), ref_i,
                       reference.true_d2(Q, got_i, X), np.concatenate(lo),
                       np.concatenate(hi))
    assert r["bad_ids"] == 0 and r["dist_gap"] <= LIMIT and r["id_gap"] <= LIMIT, r
    assert np.array_equal(got_i, ref_i)
