"""Write-ahead log — ingest batches are durable before they are visible.

Each :class:`repro_torch.core.run_registry.BufferChunk` submitted to the index
becomes one checksummed WAL record, appended and fsync'd *before* the
chunk is published into the registry buffer. A crash at any later point
(mid-flush, mid-merge, before a manifest commit) loses no acknowledged
entry: recovery replays the surviving records back into buffer chunks.

Record layout (little-endian)::

    magic u32 | n u32 | series_len u32 | flags u32 | crc32(payload) u32
    payload = series f32 (n * series_len) + ids i64 (n) [+ ts i64 (n)]

Torn tails are expected, not errors: a crash mid-append leaves a partial
record (or a complete record with a bad checksum) at the end of the log;
replay stops at the first record that does not parse and truncates the
file back to the good prefix — everything before it is intact because
every append ends in one fsync.

Truncation of the flushed prefix is log *rotation*: once a flush made the
oldest ``n`` entries durable inside a published run, the surviving
entries are rewritten into ``wal-<id+1>.log`` (splitting a partially
flushed record if the flush boundary landed inside one) and the manifest
commit flips the active ``log_id``. The old log is deleted only after
that commit — a crash between rotation and commit recovers from the old
log and simply re-flushes.

The unflushed entries are mirrored in memory (they are exactly the
registry's buffer + flushing chunks), so rotation never re-reads the log
file on the hot path; the file is read only at recovery.
"""
from __future__ import annotations

import os
import struct
import threading
import zlib
from typing import List, Optional, Tuple

import numpy as np

from ..run_registry import BufferChunk

_MAGIC = 0xC0C0A105
_HEADER = struct.Struct("<IIIII")  # magic, n, series_len, flags, payload crc32
_F_HAS_TS = 1


def _encode(chunk: BufferChunk, series_len: int) -> bytes:
    series = np.ascontiguousarray(chunk.series, dtype=np.float32)
    ids = np.ascontiguousarray(chunk.ids, dtype=np.int64)
    payload = series.tobytes() + ids.tobytes()
    flags = 0
    if chunk.ts is not None:
        flags |= _F_HAS_TS
        payload += np.ascontiguousarray(chunk.ts, dtype=np.int64).tobytes()
    head = _HEADER.pack(_MAGIC, chunk.n, series_len, flags,
                        zlib.crc32(payload) & 0xFFFFFFFF)
    return head + payload


def replay_file(path: str, series_len: int) -> Tuple[List[BufferChunk], int]:
    """Parse a WAL file into chunks, tolerating a torn/corrupt tail.

    Returns ``(chunks, good_bytes)`` — replay stops at the first record
    whose header, length, or checksum does not check out; ``good_bytes``
    is the offset of the intact prefix (callers truncate the file there).
    """
    chunks: List[BufferChunk] = []
    good = 0
    if not os.path.exists(path):
        return chunks, good
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _HEADER.size <= len(data):
        magic, n, slen, flags, crc = _HEADER.unpack_from(data, off)
        if magic != _MAGIC or slen != series_len or n == 0:
            break
        size = n * slen * 4 + n * 8 + (n * 8 if flags & _F_HAS_TS else 0)
        start = off + _HEADER.size
        if start + size > len(data):
            break  # torn tail: the record never finished writing
        payload = data[start:start + size]
        if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
            break  # corrupt record: drop it and everything after
        series = np.frombuffer(payload, np.float32,
                               count=n * slen).reshape(n, slen).copy()
        p = n * slen * 4
        ids = np.frombuffer(payload, np.int64, count=n, offset=p).copy()
        ts = None
        if flags & _F_HAS_TS:
            ts = np.frombuffer(payload, np.int64, count=n,
                               offset=p + n * 8).copy()
        chunks.append(BufferChunk(series=series, ids=ids, ts=ts))
        off = start + size
        good = off
    return chunks, good


class WriteAheadLog:
    """Checksummed, fsync'd record log with rotation-based truncation."""

    def __init__(self, root: str, series_len: int):
        self.root = root
        self.series_len = series_len
        self._lock = threading.RLock()
        self.log_id = 0
        self.records = 0
        self.appended_bytes = 0
        self._f = None
        self._mirror: List[BufferChunk] = []  # unflushed entries, FIFO
        os.makedirs(root, exist_ok=True)

    def path(self, log_id: Optional[int] = None) -> str:
        lid = self.log_id if log_id is None else log_id
        return os.path.join(self.root, f"wal-{lid:08d}.log")

    # ------------------------------------------------------------- lifecycle
    def open(self, log_id: int) -> List[BufferChunk]:
        """Activate log ``log_id``: replay its surviving records into the
        in-memory mirror (truncating any torn tail in the file itself) and
        open it for appending. Returns the replayed chunks."""
        with self._lock:
            if self._f is not None:
                self._f.close()
            self.log_id = log_id
            path = self.path()
            chunks, good = replay_file(path, self.series_len)
            if os.path.exists(path) and good < os.path.getsize(path):
                with open(path, "r+b") as f:
                    f.truncate(good)
            self._mirror = list(chunks)
            self._f = open(path, "ab")
            return list(chunks)

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None

    # --------------------------------------------------------------- writes
    def append(self, chunk: BufferChunk) -> None:
        """Append + fsync one record: the chunk is durable on return."""
        rec = _encode(chunk, self.series_len)
        with self._lock:
            if self._f is None:
                self._f = open(self.path(), "ab")
            self._f.write(rec)
            self._f.flush()
            os.fsync(self._f.fileno())
            self._mirror.append(chunk)
            self.records += 1
            self.appended_bytes += len(rec)

    def truncate_front(self, n: int) -> Optional[str]:
        """Drop the oldest ``n`` entries by rotating to a fresh log that
        holds only the survivors (a partially flushed record is split).
        Returns the old log's path — the caller deletes it only after the
        manifest commit that records the new ``log_id``."""
        with self._lock:
            survivors: List[BufferChunk] = []
            left = n
            for c in self._mirror:
                if left >= c.n:
                    left -= c.n
                    continue
                if left > 0:
                    c = BufferChunk(series=c.series[left:], ids=c.ids[left:],
                                    ts=None if c.ts is None else c.ts[left:])
                    left = 0
                survivors.append(c)
            old_path = self.path()
            if self._f is not None:
                self._f.close()
            self.log_id += 1
            new_path = self.path()
            with open(new_path, "wb") as f:
                for c in survivors:
                    f.write(_encode(c, self.series_len))
                f.flush()
                os.fsync(f.fileno())
            self._mirror = survivors
            self._f = open(new_path, "ab")
            return old_path

    # ---------------------------------------------------------------- reads
    def chunks(self) -> List[BufferChunk]:
        """The unflushed entries as chunks (oldest first)."""
        with self._lock:
            return list(self._mirror)

    @property
    def entries(self) -> int:
        with self._lock:
            return sum(c.n for c in self._mirror)
