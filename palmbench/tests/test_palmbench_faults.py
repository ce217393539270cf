"""The comparison that decides ``correct`` fails the faults a cell can
have, and the TF32 control, on a whole run at the smoke sizes on the CPU.
The isolation check is left to the command's own tests (this process
imports the JAX package elsewhere)."""
import time
from pathlib import Path

import numpy as np
import pytest

from palmbench import harness, judge
from repro_torch.core import CTree, StreamingIndex

ROOT = Path(__file__).resolve().parents[2]


def run(cell, control=False, seed=3_000_000_023):
    return harness.run(ROOT, cell, seed, 0.3, False, time.perf_counter(),
                       smoke=True, control=control)


def unchanged(d2, ids):  # the state the call started from, returned as is
    return np.full_like(d2, np.inf), np.full_like(ids, -1)


def half(d2, ids):  # half the batch left out, its rows taken from the rest
    h = len(d2) // 2
    return np.concatenate([d2[:h], d2[:len(d2) - h]]), np.concatenate(
        [ids[:h], ids[:len(ids) - h]])


def altered(d2, ids):  # one answer altered where it is produced
    ids = ids.copy()
    ids[0, -1] = (ids[0, -1] + 1) % 8192
    return d2, ids


@pytest.mark.parametrize("fault", [unchanged, half, altered])
def test_static_cell_fails_each_fault(monkeypatch, fault):
    real = CTree.knn_batch

    def broken(self, Q, k=1, **kw):
        d2, ids, st = real(self, Q, k, **kw)
        return (*fault(d2, ids), st)

    monkeypatch.setattr(CTree, "knn_batch", broken)
    result, chk, _ = run("ctree-seismic-exact-b64")
    assert result["correct"] is False, chk


@pytest.mark.parametrize("fault", [half, altered])
def test_stream_cell_fails_each_answer_fault(monkeypatch, fault):
    real = StreamingIndex.window_knn_batch

    def broken(self, Q, t0, t1, k=1, **kw):
        d2, ids, st = real(self, Q, t0, t1, k, **kw)
        return (*fault(d2, ids), st)

    monkeypatch.setattr(StreamingIndex, "window_knn_batch", broken)
    result, chk, _ = run("stream-seismic-btp-exact-b16")
    assert result["correct"] is False, chk


def test_stream_cell_fails_an_ingest_that_leaves_the_index_unchanged(monkeypatch):
    real = StreamingIndex.ingest
    calls = []

    def broken(self, series, ts):
        calls.append(1)
        if len(calls) <= 12:  # the prefill (smoke size) goes in
            return real(self, series, ts)
        return self.raw.append(series)  # acknowledged, never indexed

    monkeypatch.setattr(StreamingIndex, "ingest", broken)
    result, chk, _ = run("stream-seismic-btp-exact-b16")
    assert result["correct"] is False, chk


@pytest.mark.parametrize("cell", ["ctree-seismic-exact-b64",
                                  "stream-seismic-btp-exact-b16"])
def test_sound_run_passes_and_tf32_control_fails(cell):
    result, chk, ctrl = run(cell, control=True)
    assert result["correct"] is True, chk
    limits = {k: v["limit"] for k, v in chk.items()}
    assert not judge.passed(judge.checks(ctrl, limits)), ctrl
