"""The async stream cell at the smoke sizes on the CPU: a sound run is
``correct`` and its TF32 control is not; an acknowledged batch that is
never appended, a step answered from the snapshot before its batch, an id
a merge leaves in two runs, and an id the drain after the window publishes
twice each turn ``correct`` false."""
import time
from pathlib import Path

import pytest
import torch

from palmbench import harness, judge
from repro_torch.core import StreamingIndex
from repro_torch.core.ingest import IngestPipeline
from repro_torch.core.run_registry import RunRegistry

ROOT = Path(__file__).resolve().parents[2]
CELL = "stream-seismic-btp-async-b16"
SEED = 3_000_000_041
# at the smoke sizes the window holds a level-0 merge, and 20 batches of
# 512 leave 256 entries buffered (buffer_entries 384) for the drain to flush
STEPS = 8


def steps_run(fault=None, at_release=None):
    """The cell's driver by hand: set-up, ``fault(mp)`` (a
    ``pytest.MonkeyPatch``) if given, ``STEPS`` window steps, then
    ``at_release(mp)`` if given, release and judge; returns (checks, the
    count of unsound ids after the drain)."""
    bench = harness.load_json(ROOT / "BENCHMARK.json")
    _, config, traffic = harness.resolve(bench, CELL)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        ctx = harness.Context(config, traffic, SEED, False, torch.device("cpu"),
                              smoke=True)
        drv = harness.driver(traffic["driver"])
        st = drv.setup(ctx)
        with pytest.MonkeyPatch.context() as mp:
            if fault:
                fault(mp)
            ctx.recording = True
            for _ in range(STEPS):
                drv.step(ctx, st)
            ctx.recording = False
            if at_release:
                at_release(mp)
            drv.release(ctx, st)
        del st
        chk = judge.checks(drv.judge(ctx, ctx.answers), ctx.sizes["limits"])
        return chk, ctx.unsound_ids
    finally:
        torch.set_num_threads(threads)


def test_sound_run_is_correct_and_the_tf32_control_is_not():
    result, chk, ctrl = harness.run(ROOT, CELL, SEED, 0.3, False,
                                    time.perf_counter(), smoke=True, control=True)
    assert result["correct"] is True, chk
    limits = {k: v["limit"] for k, v in chk.items()}
    assert not judge.passed(judge.checks(ctrl, limits)), ctrl


def test_sound_steps_pass():
    chk, unsound = steps_run()
    assert judge.passed(chk) and unsound == 0, chk


def test_an_acknowledged_batch_never_appended_fails():
    def fault(mp):
        real, calls = IngestPipeline.insert, []

        def insert(self, series, ids, ts):
            calls.append(1)
            if len(calls) != 2:  # the second window step's batch is dropped
                real(self, series, ids, ts)

        mp.setattr(IngestPipeline, "insert", insert)

    chk, unsound = steps_run(fault)
    assert unsound == 512, unsound  # the smoke batch
    assert not judge.passed(chk), chk


def test_a_step_answered_from_the_snapshot_before_its_batch_fails():
    def fault(mp):
        ingest, query = StreamingIndex.ingest, StreamingIndex.window_knn_batch

        def stale_ingest(self, series, ts):
            self.stale = self.lsm.registry.current()
            return ingest(self, series, ts)

        def stale_query(self, Q, t0, t1, k=1, **kw):
            return query(self, Q, t0, t1, k, snapshot=self.stale, **kw)

        mp.setattr(StreamingIndex, "ingest", stale_ingest)
        mp.setattr(StreamingIndex, "window_knn_batch", stale_query)

    chk, unsound = steps_run(fault)
    assert unsound == 0
    assert not judge.passed(chk), chk


def test_an_id_a_merge_leaves_in_two_runs_fails():
    kept = []

    def fault(mp):
        real = RunRegistry.publish_merge

        def publish_merge(self, level, victims, merged):
            if kept:
                return real(self, level, victims, merged)
            kept.append(victims[0])  # the first merge keeps one input
            return real(self, level, list(victims)[1:], merged)

        mp.setattr(RunRegistry, "publish_merge", publish_merge)

    chk, unsound = steps_run(fault)
    assert kept and unsound == kept[0].n, (unsound, kept)
    assert not judge.passed(chk), chk


def test_an_id_the_drain_publishes_twice_fails():
    """The window's answers are sound: only the drained runs show it."""
    twice = []

    def at_release(mp):
        real = RunRegistry.publish_flush

        def publish_flush(self, chunk, run, level=0):
            snap = real(self, chunk, run, level)
            if twice:
                return snap
            twice.append(run.n)
            with self._lock:  # the run installed a second time
                return self._install_locked(snap._with(
                    levels=snap._levels_with(level, snap.level_runs(level) + (run,))))

        mp.setattr(RunRegistry, "publish_flush", publish_flush)

    chk, unsound = steps_run(at_release=at_release)
    assert twice == [256] and unsound == 256, (twice, unsound)
    assert chk["bad_ids"]["value"] == 256 and chk["dist_gap"]["value"] <= 4e-7, chk
    assert not judge.passed(chk)
