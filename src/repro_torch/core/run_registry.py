"""Epoch-based run registry — snapshot-consistent run sets for concurrent
ingest and query (the CLSM write path's analogue of MVCC).

The streaming index used to mutate ``CLSM.levels`` in place: a query planned
mid-merge saw whatever the dict happened to contain, and moving flush/merge
work off the query path was impossible without racing the planner. This
module makes the run set an immutable value:

* :class:`RunSet` — one immutable snapshot of the whole ingest state: the
  per-level sorted runs, the in-memory write buffer (as chunks), and the
  chunks currently being flushed (taken from the buffer, run not yet
  published). Every snapshot carries an ``epoch`` number.
* :class:`RunRegistry` — the single mutable cell holding the current
  :class:`RunSet`. Every mutation (buffer append, flush take/publish, merge
  publish) builds a NEW snapshot and swaps it in under the registry lock
  with one epoch bump — the CAS-style double-buffer swap: a merge builds
  its output run entirely off to the side, then one ``publish_merge``
  retires the inputs and installs the output atomically. Readers never
  block: ``current()`` is a reference read, and a plan built from a
  snapshot sees a frozen world however many flushes/merges land while it
  executes.
* **Epoch pinning + deferred retirement** — :meth:`RunRegistry.pin` hands a
  query a snapshot and records its epoch. Runs that a merge replaces are
  not released immediately: they are parked on a retirement list tagged
  with the epoch that superseded them, and their device arenas
  (:mod:`repro_torch.core.verify_engine`) are only released once every pinned
  epoch has advanced past that tag — so an in-flight plan's sources stay
  alive (and stay warm on the device) for exactly as long as any query can
  still verify against them.

Invariant: every ingested entry is, at every epoch, in exactly ONE of the
snapshot's three places (buffer chunk, flushing chunk, or published run) —
``take_for_flush`` moves entries buffer->flushing and ``publish_flush``
moves them flushing->run in single atomic swaps, so a pinned query never
sees an entry twice or not at all.
"""
from __future__ import annotations

import contextlib
import dataclasses
import threading
import time
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True, eq=False)  # identity eq: ndarray fields
class BufferChunk:
    """One immutable ingest batch: (B, n) series + aligned ids/timestamps."""

    series: np.ndarray
    ids: np.ndarray
    ts: Optional[np.ndarray] = None

    @property
    def n(self) -> int:
        return int(self.series.shape[0])


@dataclasses.dataclass(frozen=True)
class RunSet:
    """An immutable snapshot of the whole ingest state at one epoch."""

    epoch: int
    # ascending (level, runs) pairs; runs in insertion (oldest-first) order
    levels: Tuple[Tuple[int, Tuple[object, ...]], ...] = ()
    buffer: Tuple[BufferChunk, ...] = ()  # unflushed ingest, oldest first
    flushing: Tuple[BufferChunk, ...] = ()  # taken for flush, run not published

    # ------------------------------------------------------------- helpers
    def level_runs(self, level: int) -> Tuple[object, ...]:
        for lv, runs in self.levels:
            if lv == level:
                return runs
        return ()

    def level_dict(self) -> Dict[int, List[object]]:
        """The historical ``CLSM.levels`` mapping (a fresh mutable copy)."""
        return {lv: list(runs) for lv, runs in self.levels}

    def runs_newest_first(self) -> List[object]:
        out: List[object] = []
        for _, runs in self.levels:  # levels ascend: small/recent first
            out.extend(reversed(runs))
        return out

    def dense_chunks(self) -> Tuple[BufferChunk, ...]:
        """Entries not yet in any run (buffer + in-flight flushes), newest
        first — the plan's brute-force dense tail. Flushing chunks were
        taken from the buffer earlier, so they are older than anything
        still buffered."""
        return tuple(reversed(self.flushing + self.buffer))

    @property
    def buffer_n(self) -> int:
        return sum(c.n for c in self.buffer)

    @property
    def flushing_n(self) -> int:
        return sum(c.n for c in self.flushing)

    @property
    def n_runs(self) -> int:
        return sum(len(runs) for _, runs in self.levels)

    # ------------------------------------------------------- constructors
    def _with(self, **kw) -> "RunSet":
        kw.setdefault("epoch", self.epoch + 1)
        return dataclasses.replace(self, **kw)

    def _levels_with(self, level: int, runs: Sequence[object]) -> Tuple:
        """The levels tuple with one level replaced (dropped if empty)."""
        out = [(lv, rs) for lv, rs in self.levels if lv != level]
        if runs:
            out.append((level, tuple(runs)))
        out.sort(key=lambda p: p[0])
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class _Retired:
    """A run superseded by a merge, awaiting its last pinned reader."""

    run: object
    epoch: int  # the epoch whose snapshot no longer contains the run


class RunRegistry:
    """The mutable cell: current :class:`RunSet` + pins + retirement."""

    def __init__(self):
        self._lock = threading.RLock()
        self._current = RunSet(epoch=0)
        self._pins: Dict[int, int] = {}  # epoch -> pin count
        self._retired: List[_Retired] = []
        self.publish_time = time.time()  # wall time of the last epoch bump
        self.released_runs = 0  # retired runs whose resources were released

    # ------------------------------------------------------------ reading
    def current(self) -> RunSet:
        return self._current  # one reference read: never blocks on writers

    @contextlib.contextmanager
    def pin(self) -> Iterator[RunSet]:
        """Pin the current snapshot for the duration of a query: retired
        runs it references stay unreleased until the pin drops."""
        with self._lock:
            snap = self._current
            self._pins[snap.epoch] = self._pins.get(snap.epoch, 0) + 1
        try:
            yield snap
        finally:
            with self._lock:
                left = self._pins[snap.epoch] - 1
                if left:
                    self._pins[snap.epoch] = left
                else:
                    del self._pins[snap.epoch]
                self._reap_locked()

    @property
    def pinned_epochs(self) -> List[int]:
        with self._lock:
            return sorted(self._pins)

    @property
    def retired_pending(self) -> int:
        with self._lock:
            return len(self._retired)

    # ----------------------------------------------------------- mutation
    def _install_locked(self, snap: RunSet) -> RunSet:
        self._current = snap
        self.publish_time = time.time()
        return snap

    def append_buffer(self, chunk: BufferChunk) -> RunSet:
        """Publish one ingest batch into the write buffer (epoch bump)."""
        with self._lock:
            cur = self._current
            return self._install_locked(cur._with(buffer=cur.buffer + (chunk,)))

    def restore(self, levels: Sequence[Tuple[int, Sequence[object]]],
                buffer: Sequence[BufferChunk]) -> RunSet:
        """Install a recovered state (storage-engine crash recovery) in ONE
        epoch bump: the manifest's runs plus the replayed WAL chunks become
        the current snapshot atomically — a query planned before the bump
        sees the (empty) pre-recovery world, one planned after sees all of
        it, nobody sees a half-restored set. Only valid before any ingest
        (the registry must still be empty)."""
        with self._lock:
            cur = self._current
            if cur.levels or cur.buffer or cur.flushing:
                raise ValueError("restore() into a non-empty registry")
            lv = tuple(sorted(((int(l), tuple(rs)) for l, rs in levels
                               if rs), key=lambda p: p[0]))
            return self._install_locked(
                cur._with(levels=lv, buffer=tuple(buffer), flushing=()))

    def take_for_flush(self, n: int) -> Tuple[Optional[BufferChunk], RunSet]:
        """Atomically move the oldest ``n`` buffered entries into the
        in-flight ``flushing`` set. Returns the taken chunk (None when the
        buffer is empty) — the token ``publish_flush`` later retires."""
        with self._lock:
            cur = self._current
            avail = cur.buffer_n
            n = min(n, avail)
            if n <= 0:
                return None, cur
            series = np.concatenate([c.series for c in cur.buffer])
            ids = np.concatenate([c.ids for c in cur.buffer])
            ts = None
            if all(c.ts is not None for c in cur.buffer):
                ts = np.concatenate([c.ts for c in cur.buffer])
            taken = BufferChunk(series[:n], ids[:n],
                                None if ts is None else ts[:n])
            rest: Tuple[BufferChunk, ...] = ()
            if n < avail:
                rest = (BufferChunk(series[n:], ids[n:],
                                    None if ts is None else ts[n:]),)
            snap = self._install_locked(cur._with(buffer=rest,
                                           flushing=cur.flushing + (taken,)))
            return taken, snap

    def publish_flush(self, chunk: BufferChunk, run: object,
                      level: int = 0) -> RunSet:
        """Swap an in-flight chunk for its freshly built run: one epoch bump
        removes the chunk from ``flushing`` and appends the run to the
        level — a query pinned before the bump sees the chunk, one pinned
        after sees the run, nobody sees both."""
        with self._lock:
            cur = self._current
            if not any(c is chunk for c in cur.flushing):  # pragma: no cover
                raise ValueError("publish_flush: chunk was not taken for flush")
            flushing = tuple(c for c in cur.flushing if c is not chunk)
            levels = cur._levels_with(level, cur.level_runs(level) + (run,))
            return self._install_locked(cur._with(levels=levels, flushing=flushing))

    def publish_merge(self, level: int, victims: Sequence[object],
                      merged: object) -> RunSet:
        """The double-buffered merge commit: the merged run (built entirely
        off to the side) replaces its inputs in ONE epoch bump. The inputs
        are parked for deferred retirement, not released."""
        with self._lock:
            cur = self._current
            runs = list(cur.level_runs(level))
            for v in victims:  # identity removal: runs hold ndarray fields
                for i, r in enumerate(runs):
                    if r is v:
                        del runs[i]
                        break
                else:  # pragma: no cover - merge raced another merge
                    raise ValueError("publish_merge: victim not in level")
            levels = cur._levels_with(level, runs)
            # a second level changes in the same swap: splice the target in
            nxt = ()
            for lv, rs in levels:
                if lv == level + 1:
                    nxt = rs
            levels = tuple((lv, rs) for lv, rs in levels if lv != level + 1)
            levels = tuple(sorted(levels + ((level + 1, nxt + (merged,)),),
                                  key=lambda p: p[0]))
            snap = self._install_locked(cur._with(levels=levels))
            for v in victims:
                self._retired.append(_Retired(run=v, epoch=snap.epoch))
            self._reap_locked()
            return snap

    # --------------------------------------------------------- retirement
    def _reap_locked(self) -> None:
        """Release retired runs no pinned epoch can still reference: a run
        retired at epoch E was last visible at E-1, so it is reclaimable
        once every live pin is >= E (future pins only ever see >= E)."""
        if not self._retired:
            return
        floor = min(self._pins) if self._pins else self._current.epoch
        keep: List[_Retired] = []
        for r in self._retired:
            if r.epoch <= floor:
                release = getattr(r.run, "release_device_view", None)
                if release is not None:
                    release()
                release_storage = getattr(r.run, "release_storage", None)
                if release_storage is not None:
                    release_storage()
                self.released_runs += 1
            else:
                keep.append(r)
        self._retired = keep
