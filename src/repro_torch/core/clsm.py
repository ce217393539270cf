"""CoconutLSM — the write-optimized log-structured Coconut index.

Incoming series accumulate in an in-memory buffer; each flush external-sorts
the buffer into a level-0 :class:`SortedRun` (sequential write). When a level
collects ``growth_factor`` runs they are sort-merged into one run at the next
level (tiering). Every run carries its time range, which is contiguous in
stream order — this is exactly what Bounded Temporal Partitioning (BTP)
needs: newer data in small recent runs, older data in large merged runs, and
window queries skip runs whose time range misses the window.

The ``growth_factor`` knob trades writes (merge work) against reads (number
of runs a query must probe) — paper §2 "Better Read vs. Write Trade-Offs".

The whole ingest state lives in an epoch-based
:class:`repro_torch.core.run_registry.RunRegistry`: the buffer, in-flight flushes
and per-level runs are one immutable :class:`RunSet` snapshot, and every
flush/merge publishes a NEW snapshot atomically (double-buffered — the
merged run is built off to the side, then one epoch bump swaps it in).
Queries compile a pinned snapshot into one :class:`repro_torch.core.plan.QueryPlan`
— the unflushed entries as a dense source plus one source per live run,
newest first — so a query planned mid-merge keeps verifying against the
runs its epoch saw, while :class:`repro_torch.core.ingest.IngestPipeline` can run
the flush/merge work on a background worker without ever blocking the query
path. The PP/TP/BTP run-level skip is the plan's ``time_skip`` flag, decided
per run at plan build (no run metadata is ever touched).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional

import numpy as np

from .ctree import RawStore, SortedRun, state_to_list
from .execute import execute
from .io_model import DiskModel
from .plan import DenseSource, QueryPlan, SourceOps, run_time_skipped
from .run_registry import BufferChunk, RunRegistry, RunSet
from .summarization import SummarizationConfig
from .verify_engine import resolve_device


@dataclasses.dataclass
class CLSMConfig:
    summarization: SummarizationConfig = dataclasses.field(default_factory=SummarizationConfig)
    buffer_entries: int = 4096
    growth_factor: int = 4
    block_size: int = 512
    materialized: bool = False
    merge: bool = True  # False => TP (flush-only temporal partitions)
    # device-arena storage dtype for flushed/merged runs (f32|bf16|int8;
    # None resolves the engine default / REPRO_SCREEN_DTYPE)
    screen_dtype: Optional[str] = None
    device: str = "cuda"  # where flushed/merged runs keep their arenas


class CLSM:
    def __init__(self, cfg: CLSMConfig, disk: Optional[DiskModel] = None,
                 storage=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.disk = disk or DiskModel()
        # optional crash-consistent file backend
        # (:class:`repro_torch.core.storage.backend.StorageEngine`): WAL-first
        # ingest publication, persisted runs, manifest commits
        self.storage = storage
        self.registry = RunRegistry()
        self.n_flushes = 0
        self.n_merges = 0
        self.merged_bytes = 0

    # ------------------------------------------------- registry-backed views
    @property
    def levels(self) -> dict[int, list[SortedRun]]:
        """The historical level->runs mapping (a copy of the current
        snapshot — mutate the index through flush/merge publishes, not here)."""
        return self.registry.current().level_dict()

    @property
    def _buf_n(self) -> int:
        return self.registry.current().buffer_n

    # ---------------------------------------------------------------- ingest
    def append_chunk(self, chunk: BufferChunk) -> RunSet:
        """Publish one ingest batch into the buffer — WAL-first when a
        storage engine is attached: the chunk is durable (fsync'd WAL
        record) *before* it becomes query-visible, so an acknowledged batch
        survives a crash at any later point."""
        if self.storage is not None:
            self.storage.append_wal(chunk)
        return self.registry.append_buffer(chunk)

    def insert(self, series: np.ndarray, ids: np.ndarray, ts: np.ndarray) -> None:
        """Synchronous ingest: buffer the batch, flush (and merge) inline
        once the buffer fills. For ingest that must not block the caller on
        compaction, wrap the index in an
        :class:`repro_torch.core.ingest.IngestPipeline` instead."""
        chunk = BufferChunk(
            series=np.asarray(series, np.float32),
            ids=np.asarray(ids, np.int64),
            ts=np.asarray(ts, np.int64),
        )
        self.append_chunk(chunk)
        while self.registry.current().buffer_n >= self.cfg.buffer_entries:
            self._flush()

    def _flush(self) -> None:
        """One flush: take a buffer's worth of entries, external-sort them
        into a level-0 run, publish it, then run any cascading merges.
        Single-writer: only the ingesting thread (or the one pipeline
        worker) calls this — queries are pure snapshot readers."""
        n = min(self.cfg.buffer_entries, self.registry.current().buffer_n)
        if n == 0:
            return
        chunk, _ = self.registry.take_for_flush(n)
        if chunk is None:
            return
        st = self.storage
        if st is not None:
            st.maybe_crash("flush-taken")
        run, _ = SortedRun.build(
            chunk.series,
            chunk.ids,
            self.cfg.summarization,
            block_size=self.cfg.block_size,
            materialized=self.cfg.materialized,
            ts=chunk.ts,
            disk=self.disk,
            mem_budget_entries=self.cfg.buffer_entries,
            screen_dtype=self.cfg.screen_dtype,
            device=self.device,
        )
        if st is not None:
            # persist BEFORE publish: once queries can route to the run its
            # files exist; the manifest commit below makes them the durable
            # home of these entries (until then the WAL still covers them)
            run = st.persist_run(run)
        # queries planned while the run was sorting saw the chunk as a dense
        # source; this single swap makes later plans see the run instead
        snap = self.registry.publish_flush(chunk, run)
        if st is not None:
            st.commit_flush(chunk.n, snap)
        self.n_flushes += 1
        if self.cfg.merge:
            self._maybe_merge(0)

    def flush_all(self) -> None:
        while self.registry.current().buffer_n > 0:
            self._flush()

    def _maybe_merge(self, level: int) -> None:
        """Cascading tiered merges, iteratively (a worklist, not recursion:
        a deep cascade must not scale the Python stack with the level
        count). Each merge builds its output off to the side and commits
        with one ``publish_merge`` epoch bump; the replaced runs go to
        deferred retirement so pinned queries keep their sources."""
        gf = self.cfg.growth_factor
        pending = [level]
        while pending:
            lv = pending.pop()
            runs = self.registry.current().level_runs(lv)
            if len(runs) < gf:
                continue
            victims = list(runs[:gf])
            merged = self._merge_runs(victims)
            st = self.storage
            if st is not None:
                merged = st.persist_run(merged)
            snap = self.registry.publish_merge(lv, victims, merged)
            if st is not None:
                st.commit_merge(snap)
            # the target level may now overflow, and this one may still
            # hold >= gf runs — re-check both (next level first, matching
            # the old recursive order)
            pending.extend([lv, lv + 1])

    def _merge_runs(self, runs: list[SortedRun]) -> SortedRun:
        """Sort-merge runs (sequential read of inputs + sequential write)."""
        scfg = self.cfg.summarization
        syms = np.concatenate([r.sax for r in runs])
        ids = np.concatenate([r.ids for r in runs])
        ts = np.concatenate([r.ts for r in runs]) if runs[0].ts is not None else None
        series = (
            np.concatenate([r.series for r in runs]) if runs[0].materialized else None
        )
        in_bytes = sum(r.index_bytes() for r in runs)
        self.disk.read_seq(in_bytes)
        merged, _ = SortedRun.from_arrays(
            scfg,
            syms,
            ids,
            block_size=self.cfg.block_size,
            series=series,
            ts=ts,
            disk=None,  # accounted below as one sequential write
            mem_budget_entries=max(1, self.cfg.buffer_entries),
            screen_dtype=self.cfg.screen_dtype,
            device=self.device,
        )
        self.disk.write_seq(merged.index_bytes())
        self.n_merges += 1
        self.merged_bytes += in_bytes
        return merged

    # ---------------------------------------------------------------- query
    def _pinned(self, snapshot: Optional[RunSet]):
        """The query-side snapshot context: pin a fresh epoch, or pass an
        explicitly provided snapshot through (the caller pinned it)."""
        if snapshot is not None:
            return contextlib.nullcontext(snapshot)
        return self.registry.pin()

    def runs_newest_first(self, snapshot: Optional[RunSet] = None) -> list[SortedRun]:
        return (snapshot or self.registry.current()).runs_newest_first()

    def _buffer_source(self, snapshot: RunSet) -> Optional[DenseSource]:
        """The snapshot's unflushed entries (write buffer + chunks whose
        flush is still in flight) as one brute-force plan source."""
        chunks = snapshot.dense_chunks()
        if not chunks:
            return None
        series = np.concatenate([c.series for c in chunks])
        ids = np.concatenate([c.ids for c in chunks])
        ts = None
        if all(c.ts is not None for c in chunks):
            ts = np.concatenate([c.ts for c in chunks])
        return DenseSource(
            ops=SourceOps(ids=ids, ts=ts, fetch=lambda p, s=series: s[p]),
            n=series.shape[0],
        )

    def plan(
        self,
        Q: np.ndarray,
        *,
        tier: str = "exact",
        n_blocks: int = 1,
        raw: Optional[RawStore] = None,
        window: Optional[tuple[int, int]] = None,
        time_skip: bool = True,
        backend: str = "device",
        snapshot: Optional[RunSet] = None,
    ) -> QueryPlan:
        """Compile a query batch into one plan over buffer + live runs.

        The plan is built against ONE immutable :class:`RunSet` snapshot
        (``snapshot``, or the registry's current one) and records its epoch:
        every source closure resolves against that snapshot's runs, so the
        plan stays well-defined while background flushes/merges publish new
        epochs. Runs go in newest-first so the executor's folded state
        prunes the older, larger runs hardest. ``time_skip`` is the
        PP/TP/BTP flag: False (PP) plans every run and relies on
        entry-level window filtering; True (TP/BTP) drops runs whose
        [t_min, t_max] misses the window at plan build — side-effect-free
        either way."""
        snapshot = snapshot or self.registry.current()
        sources: list = []
        pruned = 0
        buf = self._buffer_source(snapshot)
        if buf is not None:
            sources.append(buf)
        for run in snapshot.runs_newest_first():
            if run.n == 0:
                continue
            skip = run_time_skipped(run.t_min, run.t_max, window,
                                    time_skip and run.ts is not None)
            if tier == "exact":
                if skip:
                    pruned += run.n_blocks
                    continue
                sources.append(run.plan_exact(Q, raw=raw, disk=self.disk))
            else:
                if skip:
                    continue
                sources.append(run.plan_approx(Q, n_blocks=n_blocks, raw=raw,
                                               disk=self.disk, backend=backend))
        return QueryPlan(m=len(Q), sources=sources, window=window,
                         time_skip=time_skip, pruned_blocks=pruned,
                         epoch=snapshot.epoch)

    def knn_exact(self, q, k=1, *, raw: Optional[RawStore] = None, window=None,
                  time_skip=True):
        """Scalar exact kNN over buffer + runs — a batch-of-1 plan through
        the shared executor. Returns ([(d2, id)] ascending, stats)."""
        vals, gids, stats = self.knn_batch(
            np.asarray(q, np.float32).reshape(1, -1), k, raw=raw, window=window,
            time_skip=time_skip,
        )
        return state_to_list(vals[0], gids[0]), stats

    def knn_batch(self, Q, k=1, *, raw: Optional[RawStore] = None, window=None,
                  backend="device", time_skip=True, shard=None, mesh=None,
                  snapshot=None):
        """Batched exact kNN across buffer + every live run.

        The batched best-so-far state threads through the runs newest-first
        (exactly like the bsf heap did), so distances verified against
        recent runs prune blocks of the older, larger runs for the whole
        batch at once. The query pins its registry epoch for its duration:
        concurrently merged-away runs stay alive (and their device arenas
        warm) until the pin drops, and the answers are snapshot-consistent
        — brute force over the pinned epoch's entries, whatever ingest
        publishes meanwhile. ``time_skip=False`` keeps entry-level window
        filtering but probes every run (PP). ``shard="mesh"`` raises until
        the mesh path is ported. Returns ((m, k) d2, (m, k) ids, stats)."""
        Q = np.asarray(Q, np.float32)
        with self._pinned(snapshot) as snap:
            plan = self.plan(Q, tier="exact", raw=raw, window=window,
                             time_skip=time_skip, snapshot=snap)
            (vals, gids), stats = execute(plan, Q, k, backend=backend,
                                          shard=shard, mesh=mesh)
        return vals, gids, stats

    def knn_approx(self, q, k=1, *, n_blocks=1, raw=None, window=None,
                   time_skip=True):
        """Scalar approximate kNN: probe the adjacent blocks of every live
        run (BTP bounds the run count, so this is a bounded number of
        I/Os). Batch-of-1 plan; returns ([(d2, id)] ascending, stats)."""
        vals, gids, stats = self.knn_approx_batch(
            np.asarray(q, np.float32).reshape(1, -1), k, n_blocks=n_blocks,
            raw=raw, window=window, time_skip=time_skip,
        )
        return state_to_list(vals[0], gids[0]), stats

    def knn_approx_batch(self, Q, k=1, *, n_blocks=1, raw=None, window=None,
                         backend="device", time_skip=True, snapshot=None):
        """Batched approximate kNN across buffer + every live run.

        The (m, k) best-so-far state folds over the runs newest-first — the
        batched analogue of the per-run heap merge. Each run contributes
        one vectorized key seek plus one coalesced sequential block read
        for the whole batch (BTP bounds the run count, so the I/O stays
        bounded). Results are a subset of the exact answer: every query
        sees only its ``n_blocks`` adjacent blocks per run, so ``n_blocks``
        trades sequential bytes for recall@k. Pins its registry epoch like
        ``knn_batch``. ``time_skip=False`` probes every run while keeping
        entry-level window filtering (PP semantics). Returns ((m, k) d2,
        (m, k) ids, stats)."""
        Q = np.asarray(Q, np.float32)
        with self._pinned(snapshot) as snap:
            plan = self.plan(Q, tier="approx", n_blocks=n_blocks, raw=raw,
                             window=window, time_skip=time_skip,
                             backend=backend, snapshot=snap)
            (vals, gids), stats = execute(plan, Q, k, backend=backend)
        return vals, gids, stats

    @property
    def n_runs(self) -> int:
        return self.registry.current().n_runs

    def index_bytes(self) -> int:
        return sum(r.index_bytes()
                   for r in self.registry.current().runs_newest_first())
