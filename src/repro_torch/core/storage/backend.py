"""Storage backend selection + the crash-consistent storage engine.

Two backends implement the same store surface (the ``StorageBackend``
protocol — what :class:`repro_torch.core.ctree.RawStore` already exposes):

* ``model`` — the default: in-memory arrays + :class:`DiskModel`
  accounting (the simulation the repo grew up on).
* ``file`` — :class:`repro_torch.core.storage.file_store.FileStore` raw rows +
  mmap'd sorted-run files + a write-ahead log, orchestrated by
  :class:`StorageEngine`. Modeled accounting still runs (same DiskModel,
  comparable figures); *measured* byte counters ride alongside.

Selection: ``StreamConfig.storage`` is ``"auto"`` by default, which
resolves through the ``REPRO_STORAGE`` env var (CI's file-backend leg
sets ``REPRO_STORAGE=file``) and falls back to ``model``.

Durability protocol (single writer — the flush/merge thread):

1. every ingest batch is WAL-appended (fsync) *before* it becomes
   query-visible (``CLSM.append_chunk``);
2. a flush persists its run files, publishes the run in-memory, then
   commits: rotate the WAL past the flushed entries, fsync the raw file,
   write ``MANIFEST.json`` atomically (tmp + fsync + rename + dir fsync);
3. a merge persists the merged run, publishes in-memory, then commits a
   manifest naming the merged run instead of its victims. Victim files
   are unlinked only after that commit (open mmaps keep the data alive
   for pinned queries — POSIX unlink semantics).

The manifest is the single commit point: recovery loads exactly the runs
it names, deletes every run directory and WAL segment it does not, and
replays the active WAL (torn tails truncated) back into buffer chunks —
so a crash at ANY point between a WAL append and a manifest commit
recovers to the same durable entry set, merely placed differently
(buffer vs run), and query answers are bitwise identical either way.

Fault injection: tests set ``engine.crash_after = "<point>"`` and the
engine raises :class:`SimulatedCrash` at that named point; the test then
abandons the index objects and recovers from the directory, which is
exactly what a process kill exercises (minus the fds, which POSIX closes
for us either way).
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Dict, List, Optional, Protocol, Sequence, Tuple

import numpy as np

from ... import spans
from ..ctree import SortedRun, _zone_maps
from ..io_model import DiskModel
from ..run_registry import BufferChunk
from ..summarization import SummarizationConfig
from ..verify_engine import resolve_device
from .file_store import FileStore
from .wal import WriteAheadLog

MANIFEST = "MANIFEST.json"
BACKENDS = ("model", "file")
# the measured counters of bytes written, which ``measured()["write_bytes"]``
# sums: the raw rows, run arrays, WAL records appended, WAL records written
# again at a rotation, run meta.json and manifest files
WRITE_COUNTERS = ("raw_write_bytes", "run_write_bytes", "wal_write_bytes",
                  "wal_rotate_bytes", "meta_write_bytes")


def _write_synced(path: str, obj) -> int:
    """Write ``obj`` as the store's JSON to ``path`` and fsync it; returns
    the bytes written."""
    text = json.dumps(obj, indent=1, sort_keys=True).encode()
    with open(path, "wb") as f:
        f.write(text)
        f.flush()
        os.fsync(f.fileno())
    return len(text)


def resolve_backend(name: str) -> str:
    """``auto`` resolves through ``REPRO_STORAGE`` (default ``model``)."""
    if name == "auto":
        name = os.environ.get("REPRO_STORAGE", "model")
    if name not in BACKENDS:
        raise ValueError(f"unknown storage backend {name!r} "
                         f"(expected one of {BACKENDS} or 'auto')")
    return name


class SimulatedCrash(BaseException):
    """Raised by the fault-injection hook; inherits BaseException so no
    recovery-under-test accidentally swallows it as an ordinary error."""


class StorageBackend(Protocol):
    """The store surface both backends serve (``RawStore``'s contract)."""

    series_len: int
    disk: DiskModel
    n: int

    def append(self, series: np.ndarray) -> np.ndarray: ...
    def fetch(self, ids: np.ndarray) -> np.ndarray: ...
    def account_fetch(self, ids: np.ndarray) -> None: ...
    def scan(self) -> np.ndarray: ...
    def norms2(self, ids: np.ndarray) -> np.ndarray: ...
    def device_view(self) -> object: ...


@dataclasses.dataclass
class RunFiles:
    """A persisted run's on-disk location (the ``SortedRun._storage``
    handle). File deletion is owned by the engine's manifest diff, not by
    this handle — releasing it only drops the mmap references."""

    dir: str


class StorageEngine:
    """Crash-consistent file storage: raw rows + run files + WAL + manifest.
    Every object it builds (the raw store, recovered runs) keeps its device
    arena on ``device`` (``"cuda"`` unless the caller says otherwise)."""

    def __init__(self, root: str, scfg: SummarizationConfig,
                 disk: Optional[DiskModel] = None, device="cuda"):
        self.device = resolve_device(device)  # a missing card raises first
        self.root = root
        self.scfg = scfg
        self.runs_dir = os.path.join(root, "runs")
        os.makedirs(self.runs_dir, exist_ok=True)
        self._lock = threading.RLock()
        self.disk = disk or DiskModel()
        self.raw = FileStore(scfg.series_len, root, disk=self.disk,
                             device=self.device)
        self.wal = WriteAheadLog(os.path.join(root, "wal"), scfg.series_len)
        self.crash_after: Optional[str] = None
        self.run_seq = 0
        self.run_write_bytes = 0
        self.meta_write_bytes = 0  # run meta.json and manifest files
        self.manifest_commits = 0
        self._referenced: set = set()
        self._recovered = False

    # ----------------------------------------------------- fault injection
    def maybe_crash(self, point: str) -> None:
        if self.crash_after == point:
            raise SimulatedCrash(point)

    # ----------------------------------------------------------------- WAL
    def append_wal(self, chunk: BufferChunk) -> None:
        """Durability point of one ingest batch (fsync'd on return)."""
        with self._lock, spans.span("storage.wal"):
            self.wal.append(chunk)
        self.maybe_crash("wal-append")

    # ---------------------------------------------------------- run files
    def persist_run(self, run: SortedRun) -> SortedRun:
        """Write a freshly built run's arrays to a new run directory and
        return an equivalent run whose arrays are read-only memmaps of
        those files (zone maps stay in memory — they are derived data).
        Empty runs are returned unchanged (nothing to persist)."""
        if run.n == 0:
            return run
        with spans.span("storage.persist"):
            d, meta = self._write_run(run)
        self.maybe_crash("run-persisted")
        return self._map_run(d, meta, bmin=run.bmin, bmax=run.bmax)

    def _write_run(self, run: SortedRun) -> Tuple[str, dict]:
        """A new run directory holding ``run``'s arrays and its meta.json,
        each file fsync'd, then the directory; returns (its path, meta)."""
        with self._lock:
            name = f"run-{self.run_seq:08d}"
            self.run_seq += 1
        d = os.path.join(self.runs_dir, name)
        os.makedirs(d)
        written = 0
        arrays = {"keys.bin": run.keys, "sax.bin": run.sax, "ids.bin": run.ids}
        if run.series is not None:
            arrays["series.bin"] = run.series
        if run.ts is not None:
            arrays["ts.bin"] = run.ts
        for fname, arr in arrays.items():
            path = os.path.join(d, fname)
            with open(path, "wb") as f:
                f.write(np.ascontiguousarray(arr).tobytes())
                f.flush()
                os.fsync(f.fileno())
            written += int(arr.nbytes)
        meta = {
            "n": int(run.n),
            "block_size": int(run.block_size),
            "t_min": int(run.t_min),
            "t_max": int(run.t_max),
            "has_series": run.series is not None,
            "has_ts": run.ts is not None,
            "series_len": int(run.cfg.series_len),
            "n_segments": int(run.cfg.n_segments),
            "card_bits": int(run.cfg.card_bits),
            "znorm": bool(run.cfg.znorm),
            "key_words": int(run.cfg.key_words),
            # arena storage dtype survives persistence AND recovery: a
            # recovered run screens at the same precision it was built with
            "screen_dtype": run.screen_dtype,
        }
        meta_bytes = _write_synced(os.path.join(d, "meta.json"), meta)
        dfd = os.open(d, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        with self._lock:
            self.run_write_bytes += written
            self.meta_write_bytes += meta_bytes
        spans.add_bytes(written + meta_bytes)
        self.disk.write_seq(written)  # modeled twin of the measured write
        return d, meta

    def _map_run(self, d: str, meta: dict, bmin=None, bmax=None) -> SortedRun:
        cfg = SummarizationConfig(series_len=meta["series_len"],
                                  n_segments=meta["n_segments"],
                                  card_bits=meta["card_bits"],
                                  znorm=meta["znorm"])
        n = meta["n"]
        mm = lambda f, dt, shape: np.memmap(os.path.join(d, f), dtype=dt,
                                            mode="r", shape=shape)
        keys = mm("keys.bin", np.uint32, (n, meta["key_words"]))
        sax = mm("sax.bin", np.uint8, (n, meta["n_segments"]))
        ids = mm("ids.bin", np.int64, (n,))
        series = (mm("series.bin", np.float32, (n, meta["series_len"]))
                  if meta["has_series"] else None)
        ts = mm("ts.bin", np.int64, (n,)) if meta["has_ts"] else None
        if bmin is None or bmax is None:
            bmin, bmax = _zone_maps(np.asarray(sax), meta["block_size"],
                                    meta["n_segments"])
        return SortedRun(cfg=cfg, keys=keys, sax=sax, ids=ids,
                         block_size=meta["block_size"], bmin=bmin, bmax=bmax,
                         series=series, ts=ts, t_min=meta["t_min"],
                         t_max=meta["t_max"],
                         screen_dtype=meta.get("screen_dtype"),
                         device=self.device, _storage=RunFiles(dir=d))

    def drop_run(self, run: SortedRun) -> None:
        """Delete an unreferenced run's files (e.g. a CTree rebuild's old
        run). Manifest-referenced runs are never dropped here — their
        lifetime is the manifest diff's."""
        handle = run._storage
        if handle is None:
            return
        with self._lock:
            if os.path.basename(handle.dir) in self._referenced:
                return
        shutil.rmtree(handle.dir, ignore_errors=True)
        run.release_storage()

    # ------------------------------------------------------------ manifest
    def _manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def _write_manifest_locked(self, levels: Sequence[Tuple[int, tuple]]) -> None:
        names: List[List[object]] = []
        referenced: set = set()
        for lv, runs in levels:
            row = [int(lv), [os.path.basename(r._storage.dir) for r in runs
                             if r._storage is not None and r.n]]
            if row[1]:
                names.append(row)
                referenced.update(row[1])
        man = {"log_id": self.wal.log_id, "run_seq": self.run_seq,
               "levels": names}
        tmp = self._manifest_path() + ".tmp"
        nbytes = _write_synced(tmp, man)
        self.meta_write_bytes += nbytes
        spans.add_bytes(nbytes)
        os.replace(tmp, self._manifest_path())
        dfd = os.open(self.root, os.O_RDONLY)
        try:
            os.fsync(dfd)
        finally:
            os.close(dfd)
        # the commit is durable: files the new manifest no longer names
        # can go (open mmaps of pinned queries keep the inodes alive)
        for name in self._referenced - referenced:
            shutil.rmtree(os.path.join(self.runs_dir, name),
                          ignore_errors=True)
        self._referenced = referenced
        self.manifest_commits += 1

    def commit_flush(self, n_entries: int, snapshot) -> None:
        """The flush commit: rotate the WAL past the ``n_entries`` now
        living in a published run, fsync the raw rows those entries map
        to, and commit a manifest of the post-flush run set."""
        self.maybe_crash("pre-manifest")
        with self._lock, spans.span("storage.commit"):
            old_log = self.wal.truncate_front(n_entries)
            self.raw.fsync()
            self._write_manifest_locked(snapshot.levels)
            if old_log and os.path.exists(old_log):
                os.unlink(old_log)
        self.maybe_crash("post-manifest")

    def commit_merge(self, snapshot) -> None:
        """The merge commit: one manifest naming the merged run instead of
        its victims (no WAL change — merges move no entries)."""
        self.maybe_crash("merge-pre-manifest")
        with self._lock, spans.span("storage.commit"):
            self._write_manifest_locked(snapshot.levels)
        self.maybe_crash("merge-post-manifest")

    # ------------------------------------------------------------ recovery
    def recover(self) -> Tuple[List[Tuple[int, list]], List[BufferChunk]]:
        """Load the durable state: the manifest's runs (as memmaps) plus
        the active WAL's surviving records (as buffer chunks), after
        deleting everything the manifest does not name. Idempotent; a
        fresh directory recovers to the empty state."""
        with self._lock, spans.span("storage.recover"):
            man = {"log_id": 0, "run_seq": 0, "levels": []}
            if os.path.exists(self._manifest_path()):
                with open(self._manifest_path()) as f:
                    man = json.load(f)
            self.run_seq = max(self.run_seq, int(man["run_seq"]))
            referenced = {name for _, names in man["levels"] for name in names}
            for entry in os.listdir(self.runs_dir):
                if entry not in referenced:
                    shutil.rmtree(os.path.join(self.runs_dir, entry),
                                  ignore_errors=True)
            active = os.path.basename(self.wal.path(int(man["log_id"])))
            for entry in os.listdir(self.wal.root):
                if entry != active:
                    os.unlink(os.path.join(self.wal.root, entry))
            chunks = self.wal.open(int(man["log_id"]))
            levels: List[Tuple[int, list]] = []
            run_n = 0
            for lv, names in man["levels"]:
                runs = []
                for name in names:
                    d = os.path.join(self.runs_dir, name)
                    with open(os.path.join(d, "meta.json")) as f:
                        meta = json.load(f)
                    runs.append(self._map_run(d, meta))
                    run_n += meta["n"]
                levels.append((int(lv), runs))
            # the durable extent: every entry a run or WAL record covers.
            # Raw rows beyond it were appended but never WAL'd (a crash in
            # the ingest submission window) — never acknowledged, dropped.
            durable = run_n + sum(c.n for c in chunks)
            self.raw.truncate(durable)
            for c in chunks:
                if c.n == 0:
                    continue
                ids = np.asarray(c.ids)
                if not np.array_equal(ids, np.arange(ids[0], ids[0] + c.n)):
                    raise ValueError("WAL chunk ids are not contiguous")
                # unflushed rows re-materialize from the WAL record itself:
                # the raw append may not have been durable, the WAL was
                self.raw.overlay(int(ids[0]), c.series)
            self._referenced = referenced
            self._recovered = True
            return levels, list(chunks)

    def close(self) -> None:
        """Close the WAL and raw files (the index stays readable; a later
        ingest opens them again). A crash skips this: recovery needs none."""
        self.wal.close()
        self.raw.close()

    # ------------------------------------------------------------ counters
    def measured(self) -> Dict[str, int]:
        """Measured (not modeled) I/O: bytes actually moved through the
        backing files, plus the process-wide readahead pool's counters."""
        from .prefetch import get_pool

        with self._lock:
            out = {
                "raw_write_bytes": self.raw.measured_write_bytes,
                "raw_read_bytes": self.raw.measured_read_bytes,
                "run_write_bytes": self.run_write_bytes,
                "wal_write_bytes": self.wal.appended_bytes,
                "wal_rotate_bytes": self.wal.rotated_bytes,
                "meta_write_bytes": self.meta_write_bytes,
                "wal_records": self.wal.records,
                "manifest_commits": self.manifest_commits,
            }
            # every byte the five counters above count, each written once
            out["write_bytes"] = sum(out[k] for k in WRITE_COUNTERS)
        out.update(get_pool().stats())
        return out
