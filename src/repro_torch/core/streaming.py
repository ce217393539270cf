"""Streaming window-query schemes: PP, TP, BTP (paper §3).

All three answer ``window_knn(q, t0, t1, k)`` — nearest neighbors among
series whose timestamp falls in [t0, t1] — over a continuously ingested
stream. They differ in how the temporal dimension is physically organized:

* **PP (Post-Processing)** — one aggressively-merged index; every entry's
  timestamp is examined during verification and out-of-window entries are
  discarded. No partition can be skipped by time.
* **TP (Temporal Partitioning)** — a new immutable partition per buffer
  flush, never merged. Window queries only touch partitions whose creation
  range intersects the window, but partition count grows without bound and
  small partitions prune poorly.
* **BTP (Bounded Temporal Partitioning)** — the paper's contribution,
  enabled by sortable summarizations: flushed partitions are sort-merged
  with similar-sized ones (LSM tiering), so newer data lives in small runs
  and older data in large contiguous runs. Small windows skip big runs (like
  TP); large windows benefit from the strong spatial pruning of big sorted
  runs (like PP); the number of partitions any query touches is bounded by
  growth_factor * log(N).

The scheme maps onto the query plan's ``time_skip`` flag (see
``repro_torch.core.plan``): TP/BTP drop runs whose time range misses the window
at plan build; PP plans every run and filters entries — no run metadata is
ever mutated, so concurrent PP queries are side-effect-free (the old
save/restore t_min/t_max hack is gone).

Scalar ``window_knn`` is a batch-of-1 plan; concurrent traffic goes
through ``window_knn_batch`` / ``window_knn_approx_batch``, which answer a
whole (m, n) query batch with one shared verification pass per (run,
batch) and return ((m, k) distances, (m, k) ids, stats). Exact batches
accept ``shard="mesh"`` for device-mesh execution.

``ingest="async"`` moves the flush/external-sort/merge work onto a
background :class:`repro_torch.core.ingest.IngestPipeline` worker: ``ingest``
returns as soon as the batch is registry-visible, queries keep serving
from the previous epoch snapshot while compactions publish new ones, and
answers stay snapshot-consistent (brute-force-equal over the pinned
epoch's entries). ``drain()`` waits the backlog out; ``ingest_lag()``
reports freshness (pending entries, mergeable runs, snapshot age).

``device`` places every device arena of the index (the raw store's and the
runs'); it is ``"cuda"`` unless the caller says otherwise.
"""
from __future__ import annotations

import dataclasses
import tempfile
import time
from typing import Optional

import numpy as np

from .. import spans
from .clsm import CLSM, CLSMConfig
from .ctree import RawStore, state_to_list
from .storage.backend import StorageEngine, resolve_backend
from .summarization import SummarizationConfig


@dataclasses.dataclass
class StreamConfig:
    scheme: str = "BTP"  # PP | TP | BTP
    summarization: SummarizationConfig = dataclasses.field(default_factory=SummarizationConfig)
    buffer_entries: int = 4096
    growth_factor: int = 4
    block_size: int = 512
    materialized: bool = False
    ingest: str = "sync"  # sync (flush/merge inline) | async (worker)
    # async backpressure: block ingest() while this many entries are
    # unflushed (None = unbounded backlog, queries still never block).
    # Must be >= buffer_entries — below the flush threshold the worker
    # could never shrink the backlog (IngestPipeline validates this)
    max_lag_entries: Optional[int] = None
    # storage backend: "model" (DiskModel simulation, the default),
    # "file" (crash-consistent mmap runs + WAL —
    # :mod:`repro_torch.core.storage`), or "auto" (resolve through the
    # REPRO_STORAGE env var, default model)
    storage: str = "auto"
    # file backend root; None -> a fresh temp directory per index
    storage_dir: Optional[str] = None
    # device-arena storage dtype for the screen tier, inherited by the
    # raw store and every flushed/merged run (f32|bf16|int8; None
    # resolves the engine default / REPRO_SCREEN_DTYPE)
    screen_dtype: Optional[str] = None
    # where the device arenas live: "cuda" (default) or "cpu"
    device: str = "cuda"


class StreamingIndex:
    """A streaming Coconut index with a pluggable temporal scheme."""

    def __init__(self, cfg: StreamConfig, raw: Optional[RawStore] = None):
        if cfg.scheme not in ("PP", "TP", "BTP"):
            raise ValueError(f"unknown scheme {cfg.scheme}")
        if cfg.ingest not in ("sync", "async"):
            raise ValueError(f"unknown ingest mode {cfg.ingest}")
        self.cfg = cfg
        self.storage = None
        if resolve_backend(cfg.storage) == "file" and raw is None:
            # an explicitly provided RawStore keeps its own backing; the
            # file backend only engages when it owns the raw rows too
            root = cfg.storage_dir or tempfile.mkdtemp(prefix="coconut-store-")
            self.storage = StorageEngine(root, cfg.summarization,
                                         device=cfg.device)
            raw = self.storage.raw
        self.raw = raw or RawStore(cfg.summarization.series_len,
                                   screen_dtype=cfg.screen_dtype,
                                   device=cfg.device)
        if cfg.screen_dtype is not None and self.raw.screen_dtype is None:
            # storage-backend-owned (or caller-supplied) stores inherit the
            # stream's dtype unless they already chose one
            self.raw.screen_dtype = cfg.screen_dtype
        lsm_cfg = CLSMConfig(
            summarization=cfg.summarization,
            buffer_entries=cfg.buffer_entries,
            # PP merges eagerly into one big structure (growth factor 2 keeps
            # run count minimal); TP never merges; BTP uses the tunable factor.
            growth_factor=2 if cfg.scheme == "PP" else cfg.growth_factor,
            block_size=cfg.block_size,
            materialized=cfg.materialized,
            merge=cfg.scheme != "TP",
            screen_dtype=cfg.screen_dtype,
            device=cfg.device,
        )
        self.lsm = CLSM(lsm_cfg, disk=self.raw.disk, storage=self.storage)
        if self.storage is not None:
            # load whatever a previous process made durable: the manifest's
            # runs plus the replayed WAL chunks, installed in one epoch bump
            levels, buffer = self.storage.recover()
            if levels or buffer:
                self.lsm.registry.restore(levels, buffer)
        # the PP/TP/BTP plan flag: PP never skips runs by time, it only
        # filters entries during verification
        self._window_skip = cfg.scheme in ("TP", "BTP")
        self.pipeline = None
        if cfg.ingest == "async":
            from .ingest import IngestPipeline  # lazy: sync path stays thread-free

            self.pipeline = IngestPipeline(
                self.lsm, max_lag_entries=cfg.max_lag_entries)

    @classmethod
    def recover(cls, cfg: StreamConfig, storage_dir: str) -> "StreamingIndex":
        """Reopen a file-backed index from its storage directory: the
        durable runs and WAL entries come back queryable (on ``cfg.device``),
        ids keep ascending from the durable extent, and ingest may continue."""
        cfg = dataclasses.replace(cfg, storage="file", storage_dir=storage_dir)
        return cls(cfg)

    # ---------------------------------------------------------------- ingest
    @spans.request
    def ingest(self, series: np.ndarray, ts: np.ndarray) -> np.ndarray:
        """Append a stream batch; returns assigned ids.

        Sync mode flushes/merges inline; async mode returns once the batch
        is registry-visible and leaves compaction to the pipeline worker —
        concurrent queries keep answering from their pinned snapshots."""
        ids = self.raw.append(series)
        if self.pipeline is not None:
            self.pipeline.insert(series, ids, ts)
        else:
            self.lsm.insert(series, ids, ts)
        return ids

    def drain(self, *, flush_buffer: bool = False,
              timeout: Optional[float] = None) -> bool:
        """Wait out the async ingest backlog (no-op in sync mode)."""
        if self.pipeline is None:
            if flush_buffer:
                self.lsm.flush_all()
            return True
        return self.pipeline.drain(flush_buffer=flush_buffer, timeout=timeout)

    def close(self) -> None:
        """Stop the async ingest worker, then close the file backend's
        files (each a no-op where there is none)."""
        if self.pipeline is not None:
            self.pipeline.close()
        if self.storage is not None:
            self.storage.close()

    def ingest_lag(self) -> dict:
        """Freshness of the queryable state vs the ingested stream:
        ``lag_entries`` (ingested but not yet in a published run),
        ``runs_pending_merge`` (published runs a level already has enough
        of to merge), ``epoch`` and ``snapshot_age_s`` (time since the
        last publish)."""
        reg = self.lsm.registry
        snap = reg.current()
        gf = self.lsm.cfg.growth_factor
        mergeable = 0
        if self.lsm.cfg.merge:
            mergeable = sum((len(runs) // gf) * gf
                            for _, runs in snap.levels if len(runs) >= gf)
        return {
            "epoch": snap.epoch,
            "lag_entries": snap.buffer_n + snap.flushing_n,
            "runs_pending_merge": mergeable,
            "retired_pending": reg.retired_pending,
            "snapshot_age_s": max(0.0, time.time() - reg.publish_time),
        }

    # ---------------------------------------------------------------- query
    def window_knn(self, q, t0: int, t1: int, k: int = 1, exact: bool = True,
                   n_blocks: int = 1):
        """Scalar window query — a batch-of-1 plan with the scheme's
        ``time_skip`` flag (side-effect-free under every scheme).
        Returns ([(d2, id)] ascending, stats)."""
        Q = np.asarray(q, np.float32).reshape(1, -1)
        if exact:
            vals, gids, stats = self.window_knn_batch(Q, t0, t1, k=k)
        else:
            vals, gids, stats = self.window_knn_approx_batch(
                Q, t0, t1, k=k, n_blocks=n_blocks)
        return state_to_list(vals[0], gids[0]), stats

    @spans.request
    def window_knn_batch(self, Q, t0: int, t1: int, k: int = 1, *,
                         backend: str = "device", shard=None, mesh=None,
                         snapshot=None):
        """Batched exact window query: ((m, k) d2, (m, k) ids, stats).

        One batched pass per live run (see ``CLSM.knn_batch``); under PP
        run-level temporal skipping is disabled (``time_skip=False``) while
        per-entry timestamp filtering stays on. ``snapshot`` pins the query
        to a caller-held epoch (see ``pin``)."""
        window = (int(t0), int(t1))
        return self.lsm.knn_batch(Q, k, raw=self.raw, window=window,
                                  backend=backend,
                                  time_skip=self._window_skip,
                                  shard=shard, mesh=mesh, snapshot=snapshot)

    def knn_batch(self, Q, k: int = 1, *, backend: str = "device", shard=None,
                  mesh=None, snapshot=None):
        """Batched whole-history exact query: ((m, k) d2, (m, k) ids, stats)."""
        return self.lsm.knn_batch(Q, k, raw=self.raw, backend=backend,
                                  shard=shard, mesh=mesh, snapshot=snapshot)

    def window_knn_approx_batch(self, Q, t0: int, t1: int, k: int = 1, *,
                                n_blocks: int = 1, backend: str = "device",
                                snapshot=None):
        """Batched approximate window query — the approximate serving tier.

        Every run the window admits contributes one vectorized key seek and
        one coalesced sequential block read for the whole batch (see
        ``CLSM.knn_approx_batch``). Results are a subset of the exact
        ``window_knn_batch`` answer; ``n_blocks`` trades sequential bytes
        per (query, run) for recall@k. Under PP, run-level temporal
        skipping is disabled while per-entry filtering stays on. Returns
        ((m, k) d2, (m, k) ids, stats)."""
        window = (int(t0), int(t1))
        return self.lsm.knn_approx_batch(Q, k, n_blocks=n_blocks, raw=self.raw,
                                         window=window, backend=backend,
                                         time_skip=self._window_skip,
                                         snapshot=snapshot)

    def knn_approx_batch(self, Q, k: int = 1, *, n_blocks: int = 1,
                         backend: str = "device", snapshot=None):
        """Batched whole-history approximate query: ((m, k) d2, ids, stats)."""
        return self.lsm.knn_approx_batch(Q, k, n_blocks=n_blocks, raw=self.raw,
                                         backend=backend, snapshot=snapshot)

    def pin(self):
        """Context manager pinning the current epoch: yields an immutable
        RunSet snapshot that every ``snapshot=``-taking query method accepts,
        so a multi-query exchange (e.g. one gateway-formed batch fanned into
        per-tier sub-batches) answers against ONE epoch while ingest keeps
        publishing new ones."""
        return self.lsm.registry.pin()

    def knn(self, q, k: int = 1, exact: bool = True, n_blocks: int = 1):
        """Whole-history query (no window)."""
        if exact:
            return self.lsm.knn_exact(q, k, raw=self.raw)
        return self.lsm.knn_approx(q, k, n_blocks=n_blocks, raw=self.raw)

    # ---------------------------------------------------------------- stats
    @property
    def n_partitions(self) -> int:
        return self.lsm.n_runs

    def io_stats(self):
        return self.raw.disk.stats

    def measured_io(self) -> dict:
        """Measured byte counters of the file backend (empty under the
        modeled backend — there is nothing real to measure)."""
        if self.storage is None:
            return {}
        return self.storage.measured()

    def index_bytes(self) -> int:
        return self.lsm.index_bytes()
