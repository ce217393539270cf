"""The file-backed stream cell at the smoke sizes on the CPU: a sound run
is ``correct`` with ``lost_series`` 0 and its TF32 control is not; a WAL
record dropped before recovery, a recovered index missing its last
acknowledged batch, and one recovered answer altered each turn ``correct``
false."""
import os
import time
from pathlib import Path

import numpy as np
import pytest

from palmbench import harness, judge
from palmbench.drivers import stream_file
from repro_torch.core import StreamingIndex
from repro_torch.core.storage import StorageEngine
from repro_torch.core.storage.wal import replay_file

ROOT = Path(__file__).resolve().parents[2]
CELL = "stream-seismic-btp-file-b16"
SEED = 3_000_000_029
STEPS = 3  # after an even prefill, an odd count: the WAL ends holding a record


def run(control=False):
    return harness.run(ROOT, CELL, SEED, 0.3, False, time.perf_counter(),
                       smoke=True, control=control)


def steps_run():
    """The cell's driver by hand for ``STEPS`` window steps (the harness's
    window is timed, so its last batch may or may not be in the WAL), then
    released and judged; returns the checks."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic = harness.resolve(bench, CELL)
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = harness.Context(config, traffic, SEED, False, torch.device("cpu"),
                              smoke=True)
        drv = harness.driver(traffic["driver"])
        st = drv.setup(ctx)
        assert ctx.sizes["prefill_batches"] % 2 == 0
        ctx.recording = True
        for _ in range(STEPS):
            drv.step(ctx, st)
        ctx.recording = False
        drv.release(ctx, st)
        del st
        return judge.checks(drv.judge(ctx, ctx.answers), ctx.sizes["limits"])
    finally:
        torch.set_num_threads(threads)


def wrap_recover(monkeypatch, before=None, after=None):
    """``StreamingIndex.recover`` with ``before(directory)`` run first and
    ``after(index)`` given the recovered index."""
    real = StreamingIndex.recover.__func__

    def recover(cls, cfg, storage_dir):
        if before:
            before(storage_dir)
        index = real(cls, cfg, storage_dir)
        if after:
            after(index)
        return index

    monkeypatch.setattr(StreamingIndex, "recover", classmethod(recover))


def test_sound_run_is_correct_and_the_tf32_control_is_not():
    result, chk, ctrl = run(control=True)
    assert result["correct"] is True, chk
    assert chk["lost_series"] == {"value": 0, "limit": 0}
    limits = {k: v["limit"] for k, v in chk.items()}
    assert not judge.passed(judge.checks(ctrl, limits)), ctrl
    assert not list((ROOT / "build" / "palmbench-store").glob(f"{os.getpid()}-*"))


def test_sound_steps_pass():
    chk = steps_run()
    assert judge.passed(chk), chk


def test_a_wal_record_dropped_before_recovery_fails(monkeypatch):
    dropped = []

    def drop_last_record(storage_dir):
        wal = os.path.join(storage_dir, "wal")
        (log,) = [os.path.join(wal, f) for f in os.listdir(wal)]
        series_len = 256
        chunks, good = replay_file(log, series_len)
        assert chunks and good == os.path.getsize(log)
        last = 20 + chunks[-1].n * (series_len * 4 + 16)
        os.truncate(log, good - last)
        dropped.append(chunks[-1].n)

    wrap_recover(monkeypatch, before=drop_last_record)
    chk = steps_run()
    assert dropped and chk["lost_series"]["value"] >= dropped[0], chk
    assert not judge.passed(chk)


def test_a_recovery_missing_the_last_acknowledged_batch_fails(monkeypatch):
    real = StorageEngine.recover

    def recover(self):
        levels, chunks = real(self)
        return levels, chunks[:-1]

    monkeypatch.setattr(StorageEngine, "recover", recover)
    chk = steps_run()
    assert chk["lost_series"]["value"] > 0, chk
    assert not judge.passed(chk)


def test_one_recovered_answer_altered_fails(monkeypatch):
    def alter(index):
        real = index.window_knn_batch

        def altered(*args, **kw):
            d2, ids, st = real(*args, **kw)
            ids = ids.copy()
            ids[0, -1] = (ids[0, -1] + 1) % np.iinfo(np.int32).max
            return d2, ids, st

        index.window_knn_batch = altered

    wrap_recover(monkeypatch, after=alter)
    chk = steps_run()
    assert chk["lost_series"]["value"] == 0
    assert not judge.passed(chk), chk


def test_finished_runs_stores_are_removed_and_a_live_ones_kept(tmp_path):
    finished, live = tmp_path / "999999999-abc", tmp_path / f"{os.getpid()}-abc"
    for d in (finished, live, tmp_path / "stray"):
        d.mkdir()
    stream_file._clear_finished(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == [live.name]
