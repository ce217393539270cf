"""File-backed storage: mmap'd runs, a write-ahead log, crash recovery.

The default backend stays the :class:`repro_torch.core.io_model.DiskModel`
simulation; this package is the ``REPRO_STORAGE=file`` twin — same store
surface, real files, measured I/O counters next to the modeled ones, and
a WAL + manifest protocol that makes streaming ingest crash-consistent.
"""
from .backend import (  # noqa: F401
    BACKENDS,
    RunFiles,
    SimulatedCrash,
    StorageBackend,
    StorageEngine,
    resolve_backend,
)
from .file_store import FileStore  # noqa: F401
from .prefetch import ReadaheadPool, get_pool  # noqa: F401
from .wal import WriteAheadLog, replay_file  # noqa: F401

__all__ = [
    "BACKENDS",
    "FileStore",
    "ReadaheadPool",
    "RunFiles",
    "SimulatedCrash",
    "StorageBackend",
    "StorageEngine",
    "WriteAheadLog",
    "get_pool",
    "replay_file",
    "resolve_backend",
]
