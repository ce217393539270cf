"""The port's raw store (``RawStore``) on the CPU: one host buffer that
grows geometrically, into which a read copies the batches appended since
the last read.

Each sequence below is a list of steps: a number appends that many rows, a
``"r"`` reads the whole store. Beside it stands the number of regrowths
it makes: the first read allocates exactly the rows it finds, and a read
that finds no room moves the filled rows to a buffer ``GROWTH`` times
larger (or as large as the store, where that is more).
"""
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import RawStore
from repro_torch.core.ctree import GROWTH

torch.set_num_threads(1)

L = 8
ROW = L * 4

SEQUENCES = {
    # name: (steps, regrowths)
    "empty": (["r"], 0),
    "one-append": ([100, "r", "r"], 0),
    "appends-then-a-read": ([50, 30, 20, "r"], 0),
    "within-capacity": ([100, "r", 50, "r", 40, "r"], 1),
    "past-the-factor": ([10, "r", 100, "r"], 1),
    "a-read-after-every-append": ([37, "r"] * 10, 4),
    "reads-before-the-first-rows": (["r", "r", 64, "r", 1, "r"], 1),
}


def _batches(steps, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((s, L)).astype(np.float32)
            if s != "r" else None for s in steps]


def _table(batches):
    rows = [b for b in batches if b is not None]
    return (np.concatenate(rows) if rows
            else np.zeros((0, L), np.float32))


def _replay(steps, on_read=None, seed=0):
    """Run ``steps`` on a new store; ``on_read(store, read, the batches
    appended so far, concatenated)`` after every read. Returns the store
    and every batch appended."""
    raw = RawStore(L, device="cpu")
    batches = _batches(steps, seed)
    seen = []
    for b in batches:
        if b is None:
            got = raw._all()
            if on_read:
                on_read(raw, got, _table(seen))
        else:
            raw.append(b)
            seen.append(b)
    return raw, seen


@pytest.mark.parametrize("name", SEQUENCES)
def test_a_read_is_the_concatenation_of_the_appended_batches(name):
    steps, regrowths = SEQUENCES[name]
    caps = []  # the buffer's rows at each read that found rows

    def check(raw, got, want):
        assert got.dtype == np.float32 and got.shape == want.shape
        assert got.tobytes() == want.tobytes()
        if want.shape[0]:
            cap = raw._buf.shape[0]
            if not caps:  # the first allocation: exactly the rows read
                assert cap == want.shape[0]
            elif cap != caps[-1]:
                assert cap == max(want.shape[0], GROWTH * caps[-1])
            caps.append(cap)

    raw, seen = _replay(steps, check)
    want = _table(seen)
    assert raw._all().tobytes() == want.tobytes()
    ids = np.arange(raw.n)[::3]
    assert np.array_equal(raw.fetch(ids), want[ids])
    assert sum(a != b for a, b in zip(caps, caps[1:])) == regrowths


@pytest.mark.parametrize("regrow", [False, True], ids=["in-place", "regrowth"])
def test_arrays_and_views_taken_before_an_append_keep_their_rows(regrow):
    rng = np.random.default_rng(1)

    def rows(n):
        return rng.standard_normal((n, L)).astype(np.float32)

    raw = RawStore(L, screen_dtype="f32", device="cpu")
    raw.append(rows(300))
    raw._all()  # a buffer of 300 rows
    raw.append(rows(100))
    held = raw._all()  # regrown to 600 rows, 200 spare
    snap = held.copy()
    view = raw.device_view()
    table = view.table[:view.n].clone()
    old = raw._buf
    raw.append(rows(300 if regrow else 150))
    now = raw._all()
    assert (raw._buf is not old) == regrow
    assert np.shares_memory(now, held) != regrow
    newer = raw.device_view()
    assert newer.n == raw.n and view.n == snap.shape[0]
    for a in (held, view.host, now[:snap.shape[0]], newer.host[:snap.shape[0]]):
        assert a.tobytes() == snap.tobytes()
    assert torch.equal(view.table[:view.n], table)


@pytest.mark.parametrize("name", [n for n in SEQUENCES if n != "empty"])
def test_norms_after_growth_are_the_per_row_einsum(name):
    steps, _ = SEQUENCES[name]
    asked = []

    def check(raw, got, want):
        ids = np.arange(want.shape[0])[::-2]
        asked.append(raw.norms2(ids))
        per_row = np.array([np.einsum("ij,ij->i", want[i:i + 1], want[i:i + 1])[0]
                            for i in ids], np.float32)
        assert asked[-1].tobytes() == per_row.tobytes()

    raw, seen = _replay(steps + [5], check, seed=3)
    want = _table(seen)
    ids = np.arange(raw.n)
    whole = np.einsum("ij,ij->i", want, want)
    assert raw.norms2(ids).tobytes() == whole.tobytes()
    with pytest.raises(IndexError):
        raw.norms2(np.array([raw.n]))


def test_one_thread_appends_while_another_reads():
    """Every read (the array itself, kept) is a prefix of the final table:
    no row below a reader's n is written again."""
    rng = np.random.default_rng(5)
    batches = [rng.standard_normal((int(s), L)).astype(np.float32)
               for s in rng.integers(1, 60, 400)]
    raw = RawStore(L, device="cpu")
    reads, norms, errors = [], [], []
    done = threading.Event()
    # on a loaded host a thread can take longer to start than the appender
    # takes to finish: all three begin together
    start = threading.Barrier(3, timeout=60)
    deadline = time.time() + 60

    def appender():
        try:
            start.wait()
            for i, b in enumerate(batches):
                raw.append(b)
                # halfway, the readers have read at least twice (60 s at most)
                while i == len(batches) // 2 and len(reads) < 2 and time.time() < deadline:
                    time.sleep(1e-3)
        except Exception as e:  # reported below
            errors.append(e)
        finally:
            done.set()

    def reader():
        try:
            start.wait()
            while not done.is_set():
                a = raw._all()
                reads.append(a)
                if a.shape[0]:
                    ids = np.arange(0, a.shape[0], 7)
                    norms.append((ids, raw.norms2(ids)))
        except Exception as e:  # reported below
            errors.append(e)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=appender),
                   threading.Thread(target=reader),
                   threading.Thread(target=reader)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    final = np.concatenate(batches)
    assert raw._all().tobytes() == final.tobytes()
    assert len(reads) > 1
    for a in reads:
        assert a.tobytes() == final[:a.shape[0]].tobytes()
    n2 = np.einsum("ij,ij->i", final, final)
    for ids, got in norms:
        assert got.tobytes() == n2[ids].tobytes()


@pytest.mark.parametrize("name", SEQUENCES)
def test_traced_reads_copy_the_pending_rows_and_count_the_regrowths(name):
    steps, regrowths = SEQUENCES[name]
    raw = RawStore(L, device="cpu")

    def span_totals(name):
        return spans.totals().get(name, {"calls": 0, "bytes": 0})

    spans.reset()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pending, fresh = 0, True  # rows appended since the last read
            for b in _batches(steps):
                if b is not None:
                    raw.append(b)
                    pending, fresh = pending + b.shape[0], True
                    continue
                concat, grow = span_totals("raw.concat"), span_totals("raw.grow")
                filled = raw.n - pending
                raw._all()
                concat2, grow2 = span_totals("raw.concat"), span_totals("raw.grow")
                # a read after an append copies exactly the pending rows
                assert concat2["calls"] - concat["calls"] == int(fresh)
                assert concat2["bytes"] - concat["bytes"] == pending * ROW
                # a regrowth moves exactly the rows filled before the read
                assert grow2["bytes"] - grow["bytes"] == (
                    (grow2["calls"] - grow["calls"]) * filled * ROW)
                pending, fresh = 0, False
            grows = span_totals("raw.grow")["calls"]
    finally:
        spans.reset()
    assert grows == regrowths
