"""FileStore — the raw data-series file as an actual file.

Drop-in for :class:`repro_torch.core.ctree.RawStore` (same fetch/append/
norms/device-view surface, same modeled :class:`DiskModel` accounting so
trajectories stay comparable across backends), but rows live in
``raw.bin`` and reads go through a read-only ``np.memmap`` — fancy
indexing on the mmap gathers straight off the page cache, so a store
much larger than RAM is served by the kernel instead of simulated by
held arrays. The device arena fills from that mapping through the
inherited ``device_view`` (centered copies are uploaded, never the
mapping itself).

On top of the modeled figures the store keeps *measured* counters
(``measured_write_bytes`` / ``measured_read_bytes``): the bytes the
process actually pushed to / pulled from the backing file.

Recovery hooks (used by :class:`repro_torch.core.storage.backend.StorageEngine`):
``truncate`` drops a non-durable tail (rows appended but never WAL'd
before a crash), ``overlay`` rewrites row ranges from replayed WAL
records (idempotent positional writes — the WAL is the source of truth
for unflushed rows), ``fsync`` is the durability point a manifest commit
takes before publishing flushed runs.
"""
from __future__ import annotations

import os
from typing import Optional

import numpy as np

from ... import spans
from ..ctree import RawStore
from ..io_model import DiskModel


class FileStore(RawStore):
    """Append-only raw series file with mmap reads and measured I/O. Its
    device arena lives on ``device`` (``"cuda"`` unless the caller says
    otherwise)."""

    def __init__(self, series_len: int, root: str,
                 disk: Optional[DiskModel] = None, device="cuda"):
        super().__init__(series_len, disk, device=device)
        self.root = root
        os.makedirs(root, exist_ok=True)
        self.path = os.path.join(root, "raw.bin")
        self._row_bytes = series_len * 4
        # r+b (not append mode): overlay() uses pwrite, whose offset an
        # O_APPEND descriptor would ignore
        if not os.path.exists(self.path):
            open(self.path, "xb").close()
        self._f = open(self.path, "r+b")
        self._f.seek(0, os.SEEK_END)
        self.n = self._f.tell() // self._row_bytes
        self.measured_write_bytes = 0
        self.measured_read_bytes = 0

    # --------------------------------------------------------------- writes
    def append(self, series: np.ndarray) -> np.ndarray:
        """Append (B, n) series to the backing file; returns their ids.

        Durability is the WAL's job (every ingest batch is WAL'd before it
        is query-visible), so the append flushes but does not fsync —
        ``fsync`` runs once per manifest commit instead of once per batch.
        """
        series = np.ascontiguousarray(series, dtype=np.float32)
        with self._lock, spans.span("storage.raw_write", series.nbytes):
            ids = np.arange(self.n, self.n + series.shape[0], dtype=np.int64)
            f = self._file_locked()
            f.seek(0, os.SEEK_END)
            f.write(series.tobytes())
            f.flush()
            self.n += series.shape[0]
            self._data = None
            self.measured_write_bytes += series.nbytes
        self.disk.write_seq(series.nbytes,
                            offset=int(ids[0]) * self._row_bytes if ids.size else 0)
        return ids

    def fsync(self) -> None:
        """Make every appended row durable (the pre-manifest barrier)."""
        with self._lock:
            f = self._file_locked()
            f.flush()
            os.fsync(f.fileno())

    def _file_locked(self):
        """The backing file, opened again after :meth:`close`."""
        if self._f is None:
            self._f = open(self.path, "r+b")
        return self._f

    def close(self) -> None:
        """Close the backing file. Reads go through memmaps and keep
        working; a later write opens the file again."""
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # ---------------------------------------------------------------- reads
    def _all(self) -> np.ndarray:
        """The whole store as a read-only memmap (re-mapped when the row
        count changed; never a concatenation)."""
        with self._lock:
            if self._data is None or self._data.shape[0] != self.n:
                if self.n == 0:
                    self._data = np.zeros((0, self.series_len), np.float32)
                else:
                    self._data = np.memmap(self.path, dtype=np.float32,
                                           mode="r",
                                           shape=(self.n, self.series_len))
            return self._data

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        ids = np.asarray(ids)
        with self._lock:
            self.measured_read_bytes += int(ids.size) * self._row_bytes
        # fancy indexing on the mmap copies the gathered rows out — the
        # modeled random-read accounting happens in account_fetch (super)
        return super().fetch(ids)

    def scan(self) -> np.ndarray:
        data = self._all()
        with self._lock:
            self.measured_read_bytes += int(data.nbytes)
        self.disk.read_seq(data.nbytes)
        return data

    # ------------------------------------------------------------- recovery
    def truncate(self, n: int) -> None:
        """Drop rows >= ``n`` (a crash's non-durable tail) and reset every
        derived cache. Recovery-time only — never races queries."""
        with self._lock:
            f = self._file_locked()
            f.truncate(n * self._row_bytes)
            f.flush()
            self.n = int(n)
            self._data = None
            self._norms2 = np.empty(0, np.float32)
            self._norms2_done = 0
            self._pending = []

    def overlay(self, row0: int, series: np.ndarray) -> None:
        """Rewrite rows [row0, row0 + B) from a replayed WAL record. The
        rows must already be inside the truncated extent."""
        series = np.ascontiguousarray(series, dtype=np.float32)
        with self._lock:
            if row0 + series.shape[0] > self.n:
                raise ValueError("overlay beyond the durable extent")
            f = self._file_locked()
            f.flush()
            os.pwrite(f.fileno(), series.tobytes(), row0 * self._row_bytes)
            self._data = None
            self._norms2 = np.empty(0, np.float32)
            self._norms2_done = 0
