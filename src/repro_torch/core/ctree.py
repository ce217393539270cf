"""CoconutTree — the compact & contiguous read-optimized sorted index.

A CTree is a single :class:`SortedRun`: entries sorted by the bit-interleaved
sortable key, stored contiguously in fixed-size blocks with per-block zone
maps (min/max SAX symbol per segment) for block-level lower-bound pruning.
It is built bottom-up with a memory-budgeted external sort (sequential I/O
only) — the paper's headline capability.

Variants (paper §2):
  * materialized:     raw series stored inline in sorted order (bigger,
                      slower to build, fastest to query);
  * non-materialized: only summaries + ids; verification fetches raw series
                      from the RawStore (random I/O at query time).
  * fill_factor < 1:  leaves leave gaps so point inserts can be absorbed
                      without rebuilding (read/write trade-off knob).

``SortedRun`` is shared with CoconutLSM (a CLSM level run is the same
structure plus a time range).

Queries go through the plan/execute split (:mod:`repro_torch.core.plan`,
:mod:`repro_torch.core.execute`): a run *plans* its candidates — block lower
bounds from zone maps for the exact tier (``plan_exact``), per-query
sortable-key-seek entry spans for the approximate tier (``plan_approx``) —
and the shared executor performs the traversal, coalesced reads and
verification passes. The scalar ``knn_exact``/``knn_approx`` entry points
are batch-of-1 wrappers over the same engine; batched results are
((m, k) distances, (m, k) ids) arrays padded with (inf, -1).
"""
from __future__ import annotations

import dataclasses
import heapq
import threading
from typing import Optional

import numpy as np

from .. import spans
from .execute import (
    BACKENDS,
    empty_topk_state,
    execute,
    heap_to_sorted,
    merge_topk_state,
    recall_at_k,
    state_to_list,
)
from .external_sort import SortReport, external_sort_order
from .io_model import DiskModel
from .lower_bounds import mindist_region2
from .plan import (
    BlockRanges,
    BlockSource,
    DenseSource,
    QueryPlan,
    QueryStats,
    RangeSource,
    SourceOps,
    run_time_skipped,
)
from .sortable import interleave, searchsorted_keys_batch
from .summarization import SummarizationConfig, paa, sax_from_paa
from .verify_engine import get_engine, resolve_device

__all__ = [
    "CTree", "CTreeConfig", "QueryStats", "RawStore", "SortedRun",
    "empty_topk_state", "heap_to_sorted", "merge_topk_state", "recall_at_k",
]


# a full host buffer is replaced by one this many times its rows (or by
# the rows the store holds, where more)
GROWTH = 2


def _grown(buf: np.ndarray, used: int, need: int) -> np.ndarray:
    """A new buffer of at least ``need`` rows and ``GROWTH`` times ``buf``'s,
    holding ``buf``'s first ``used`` rows; ``buf`` itself is left as it
    is, for whoever still holds a view of it."""
    out = np.empty((max(need, int(GROWTH * buf.shape[0])),) + buf.shape[1:],
                   buf.dtype)
    out[:used] = buf[:used]
    return out


class RawStore:
    """The raw data-series file. Append-only; random reads are accounted.
    Its device arena lives on ``device`` (``"cuda"`` unless the caller says
    otherwise; a missing card raises here, at construction).

    Appended batches wait as pending until a read copies them into one
    host buffer that grows geometrically (``GROWTH``), so a read after an
    append copies the new rows only. Rows below ``n`` are never written
    again: an array read before an append or a regrowth keeps its rows (a
    regrowth moves them to a new buffer and leaves the old one to its
    holders)."""

    def __init__(self, series_len: int, disk: Optional[DiskModel] = None,
                 screen_dtype: Optional[str] = None, device="cuda"):
        self.series_len = series_len
        self.device = resolve_device(device)
        self.disk = disk or DiskModel()
        # arena storage dtype for the device screen tier (f32|bf16|int8;
        # None -> the engine default / REPRO_SCREEN_DTYPE)
        self.screen_dtype = screen_dtype
        # guards the buffers, _pending, _dev_view and n: the serving loop
        # appends from the ingest thread while query threads fetch
        self._lock = threading.RLock()
        self._pending: list[np.ndarray] = []  # appended, not yet in _buf
        self._buf = np.empty((0, series_len), np.float32)
        self._done = 0  # rows of _buf filled
        self._data: Optional[np.ndarray] = None  # _buf[:n] until an append
        self._norms2 = np.empty(0, np.float32)
        self._norms2_done = 0  # rows of _norms2 filled
        self._dev_view = None  # device arena over the whole store (lazy)
        self.n = 0

    def append(self, series: np.ndarray) -> np.ndarray:
        """Append (B, n) series; returns their ids. Sequential write."""
        series = np.asarray(series, dtype=np.float32)
        with self._lock:
            ids = np.arange(self.n, self.n + series.shape[0], dtype=np.int64)
            self._pending.append(series)
            self._data = None
            self.n += series.shape[0]
        self.disk.write_seq(series.nbytes, offset=int(ids[0]) * self.series_len * 4)
        return ids

    def _all(self) -> np.ndarray:
        """Rows [0, n) of the host buffer, the pending batches copied in."""
        with self._lock:
            if self._data is None:
                row = self.series_len * 4
                if self.n > self._buf.shape[0] and self._done:
                    with spans.span("raw.grow", self._done * row):
                        self._buf = _grown(self._buf, self._done, self.n)
                with spans.span("raw.concat", (self.n - self._done) * row):
                    if self.n > self._buf.shape[0]:  # the first rows: n exactly
                        self._buf = _grown(self._buf, 0, self.n)
                    for batch in self._pending:
                        self._buf[self._done:self._done + batch.shape[0]] = batch
                        self._done += batch.shape[0]
                    self._pending = []
                self._data = self._buf[:self.n]
            return self._data

    def fetch(self, ids: np.ndarray) -> np.ndarray:
        """Random fetch by id (the non-materialized query path)."""
        ids = np.asarray(ids)
        self.account_fetch(ids)
        return self._all()[ids]

    def account_fetch(self, ids: np.ndarray) -> None:
        """The modeled I/O of :meth:`fetch` without the gather — the device
        verification path reads its arena but pays the same modeled I/O."""
        ids = np.asarray(ids)
        row = self.series_len * 4
        if self.disk.keep_log and ids.size:
            # scattered page touches for the heat map: one read per row
            self.disk.read_rand_rows(ids.astype(np.int64) * row, row)
        else:
            self.disk.read_rand(ids.size * row)

    def device_view(self):
        """Device arena over the whole store (raw row == global id), built
        once and extended in place as the append-only store grows."""
        eng = get_engine(self.device)
        with self._lock:  # one thread builds/extends; others reuse
            if self._dev_view is None:
                self._dev_view = eng.build_view(self._all(),
                                                dtype=self.screen_dtype)
            elif self._dev_view.n < self.n:
                self._dev_view = eng.extend_view(self._dev_view, self._all())
            return self._dev_view

    def scan(self) -> np.ndarray:
        """Full sequential scan (used by builds)."""
        data = self._all()
        self.disk.read_seq(data.nbytes)
        return data

    def norms2(self, ids: np.ndarray) -> np.ndarray:
        """Cached squared norms by id (derived data, no modeled I/O): the
        batched verify screens only need |x|^2, not another pass over x.
        The cache grows as the store's buffer does, so a growing stream
        computes the norms of its new rows only."""
        with self._lock:
            done = self._norms2_done
            if done < self.n:
                a = self._all()
                if self.n > self._norms2.shape[0]:
                    self._norms2 = _grown(self._norms2, done, self.n)
                self._norms2[done:self.n] = np.einsum("ij,ij->i", a[done:],
                                                      a[done:])
                self._norms2_done = self.n
            return self._norms2[:self.n][ids]


def _zone_maps(sax_sorted: np.ndarray, block_size: int,
               w: int) -> tuple[np.ndarray, np.ndarray]:
    """Per-block (bmin, bmax) zone maps of key-sorted SAX rows.

    One vectorized reduction over (nb, bs, w) instead of a Python loop per
    block: pad the tail block by replicating its last row (already a
    member, so block min/max are unchanged) — merges on the background
    ingest worker spend less time holding the GIL. A free function so a
    :class:`SortedRun` is constructed complete instead of patched after
    ``__init__`` (published runs are immutable)."""
    n = sax_sorted.shape[0]
    nb = max(1, -(-n // block_size)) if n else 0
    if nb == 0:
        return np.full((0, w), 255, np.uint8), np.zeros((0, w), np.uint8)
    pad = nb * block_size - n
    sax_p = sax_sorted
    if pad:
        sax_p = np.concatenate(
            [sax_sorted, np.broadcast_to(sax_sorted[-1:], (pad, w))])
    blocks = sax_p.reshape(nb, block_size, w)
    return blocks.min(axis=1), blocks.max(axis=1)


@dataclasses.dataclass
class SortedRun:
    """A contiguous sorted-by-key array of summarized entries + zone maps."""

    cfg: SummarizationConfig
    keys: np.ndarray  # (N, nw) uint32, lexicographically sorted
    sax: np.ndarray  # (N, w) uint8
    ids: np.ndarray  # (N,) int64 position in RawStore
    block_size: int
    bmin: np.ndarray  # (nb, w) uint8 zone maps
    bmax: np.ndarray  # (nb, w) uint8
    series: Optional[np.ndarray] = None  # (N, n) f32 if materialized
    ts: Optional[np.ndarray] = None  # (N,) int64 timestamps
    t_min: int = 0
    t_max: int = 0
    screen_dtype: Optional[str] = None  # arena storage dtype (None = engine default)
    device: object = "cuda"  # where the run's device arena lives
    _norms2: Optional[np.ndarray] = None  # lazy |x|^2 cache (materialized runs)
    _dev_view: Optional[object] = None  # lazy device arena (materialized runs)
    _storage: Optional[object] = None  # on-disk home when file-backed (RunFiles)

    @property
    def n(self) -> int:
        return self.keys.shape[0]

    @property
    def n_blocks(self) -> int:
        return self.bmin.shape[0]

    @property
    def materialized(self) -> bool:
        return self.series is not None

    def index_bytes(self) -> int:
        b = self.keys.nbytes + self.sax.nbytes + self.ids.nbytes
        b += self.bmin.nbytes + self.bmax.nbytes
        if self.series is not None:
            b += self.series.nbytes
        if self.ts is not None:
            b += self.ts.nbytes
        return b

    # ------------------------------------------------------------------ build
    @staticmethod
    def from_arrays(
        cfg: SummarizationConfig,
        sax_syms: np.ndarray,
        ids: np.ndarray,
        *,
        block_size: int = 1024,
        series: Optional[np.ndarray] = None,
        ts: Optional[np.ndarray] = None,
        disk: Optional[DiskModel] = None,
        mem_budget_entries: Optional[int] = None,
        presorted: bool = False,
        screen_dtype: Optional[str] = None,
        device="cuda",
    ) -> tuple["SortedRun", SortReport]:
        """Build a run from unsorted summarized entries via external sort."""
        device = resolve_device(device)
        keys = interleave(sax_syms.astype(np.int32), cfg).reshape(-1, cfg.key_words)
        n = keys.shape[0]
        payload = cfg.series_len * 4 if series is not None else 0
        if presorted:
            order = np.arange(n)
            report = SortReport(n, 1, 0, n or 1)
        else:
            order, report = external_sort_order(
                keys, mem_budget_entries or max(1, n), disk, payload_bytes_per_entry=payload
            )
        keys = keys[order]
        sax_sorted = sax_syms[order].astype(np.uint8)
        ts_sorted = None if ts is None else np.asarray(ts, np.int64)[order]
        bmin, bmax = _zone_maps(sax_sorted, block_size, cfg.n_segments)
        # the run is fully formed at construction: published runs are
        # immutable (the sanitizer's seal tripwire enforces it), so every
        # derived field is computed before __init__, never patched after
        run = SortedRun(
            cfg=cfg,
            keys=keys,
            sax=sax_sorted,
            ids=np.asarray(ids)[order].astype(np.int64),
            block_size=block_size,
            bmin=bmin,
            bmax=bmax,
            series=None if series is None else np.asarray(series, np.float32)[order],
            ts=ts_sorted,
            t_min=int(ts_sorted.min()) if ts_sorted is not None and n else 0,
            t_max=int(ts_sorted.max()) if ts_sorted is not None and n else 0,
            screen_dtype=screen_dtype,
            device=device,
        )
        return run, report

    @staticmethod
    def build(
        series: np.ndarray,
        ids: np.ndarray,
        cfg: SummarizationConfig,
        *,
        block_size: int = 1024,
        materialized: bool = False,
        ts: Optional[np.ndarray] = None,
        disk: Optional[DiskModel] = None,
        mem_budget_entries: Optional[int] = None,
        screen_dtype: Optional[str] = None,
        device="cuda",
    ) -> tuple["SortedRun", SortReport]:
        p = paa(np.asarray(series, np.float32), cfg)
        syms = sax_from_paa(p, cfg)
        return SortedRun.from_arrays(
            cfg,
            syms,
            ids,
            block_size=block_size,
            series=series if materialized else None,
            ts=ts,
            disk=disk,
            mem_budget_entries=mem_budget_entries,
            screen_dtype=screen_dtype,
            device=device,
        )

    def entry_norms2(self) -> np.ndarray:
        """Cached (N,) squared norms of the materialized entries (runs are
        immutable after build, so this never invalidates)."""
        assert self.series is not None
        if self._norms2 is None:
            self._norms2 = np.einsum("ij,ij->i", self.series, self.series)
        return self._norms2

    def device_view(self):
        """Device arena over the materialized entries (uploaded once — runs
        are immutable after build, so the view never invalidates)."""
        assert self.series is not None
        if self._dev_view is None:
            self._dev_view = get_engine(self.device).build_view(
                self.series, dtype=self.screen_dtype)
        return self._dev_view

    def release_device_view(self) -> None:
        """Retire this run's device arena (called by the run registry once
        no pinned epoch can still plan against the run — in-flight passes
        keep the buffers alive through their own references). Safe to call
        on runs that never built an arena; a later ``device_view`` would
        lazily rebuild."""
        if self._dev_view is not None:
            get_engine(self.device).release_view(self._dev_view)
            self._dev_view = None

    def release_storage(self) -> None:
        """Drop the storage handle of a file-persisted run (deferred
        retirement, like the device view). File deletion is owned by the
        storage engine's manifest diff — a merged-away run's files were
        already unlinked at the merge's manifest commit, and the open
        memmaps kept the data alive for pinned queries until now."""
        self._storage = None

    # ------------------------------------------------------------------ query
    def _entry_bytes(self) -> int:
        per = self.cfg.key_words * 4 + self.cfg.n_segments + 8
        if self.materialized:
            per += self.cfg.series_len * 4
        if self.ts is not None:
            per += 8
        return per

    def _fetch_entries(
        self,
        idx: np.ndarray,
        raw: Optional[RawStore],
        disk: Optional[DiskModel],
        sequential: bool,
    ) -> np.ndarray:
        """Raw series for entries at positions ``idx`` (I/O accounted)."""
        if self.materialized:
            data = self.series[idx]
            if disk is not None:
                nbytes = idx.size * self.cfg.series_len * 4
                (disk.read_seq if sequential else disk.read_rand)(nbytes)
        else:
            if raw is None:
                raise ValueError("non-materialized run queried without a RawStore")
            data = raw.fetch(self.ids[idx])
        return data

    def _account_entries(
        self, idx: np.ndarray, disk: Optional[DiskModel], sequential: bool
    ) -> None:
        """The modeled I/O of :meth:`_fetch_entries` for a materialized run
        without the host gather (the device path reads its arena)."""
        if disk is not None:
            nbytes = idx.size * self.cfg.series_len * 4
            (disk.read_seq if sequential else disk.read_rand)(nbytes)

    def _ops(self, raw: Optional[RawStore], disk: Optional[DiskModel],
             *, sequential: bool, screen: bool) -> SourceOps:
        """Physical accessor bundle for the executor (all I/O accounted)."""
        norms2 = None
        if self.materialized:
            norms2 = lambda p: self.entry_norms2()[p]
        elif raw is not None:
            norms2 = lambda p: raw.norms2(self.ids[p])
        index_read = None
        if disk is not None:
            per = self.cfg.key_words * 4 + self.cfg.n_segments
            index_read = lambda count: disk.read_rand(count * per)
        # device arena accessors: materialized runs own their arena (table
        # row == entry position); non-materialized runs verify against the
        # RawStore's arena (table row == global id)
        if self.materialized:
            device_view = self.device_view
            table_rows = None  # identity
            table_ids = lambda r: self.ids[r]
            fetch_account = lambda r: self._account_entries(r, disk, sequential)
        elif raw is not None:
            device_view = raw.device_view
            table_rows = self.ids
            table_ids = lambda r: r  # raw rows ARE global ids
            fetch_account = raw.account_fetch
        else:
            device_view = table_rows = table_ids = fetch_account = None
        prefetch_ranges = None
        if self._storage is not None:
            # file-backed run: hand the executor's coalesced row spans to
            # the readahead pool so the mmap pages are faulting in while
            # the lower-bound screen decides what to verify
            from .storage.prefetch import get_pool  # lazy: storage imports ctree

            arrays = [a for a in (self.series, self.sax, self.keys)
                      if a is not None]
            pool = get_pool()
            prefetch_ranges = lambda ranges: pool.prefetch(arrays, ranges)
        return SourceOps(
            ids=self.ids,
            ts=self.ts,
            fetch=lambda p: self._fetch_entries(p, raw, disk, sequential=sequential),
            index_read=index_read,
            sax=self.sax if screen else None,
            scfg=self.cfg,
            norms2=norms2,
            series=self.series,
            device_view=device_view,
            table_rows=table_rows,
            table_ids=table_ids,
            fetch_account=fetch_account,
            prefetch_ranges=prefetch_ranges,
            device=self.device,
        )

    def plan_exact(
        self,
        Q: np.ndarray,
        *,
        raw: Optional[RawStore] = None,
        disk: Optional[DiskModel] = None,
    ) -> BlockSource:
        """Exact-tier candidate generation: per-(query, block) lower bounds
        from the zone maps, over the run's blocks as ranges of its entries;
        the executor's adaptive traversal does the rest."""
        with spans.span("plan.exact"):
            Q = np.asarray(Q, np.float32)
            qp = np.asarray(paa(Q, self.cfg))  # (m, w)
            blb = mindist_region2(
                qp[:, None, :], self.bmin.astype(np.int64),
                self.bmax.astype(np.int64), self.cfg,
            )  # (m, nb)
            return BlockSource(
                ops=self._ops(raw, disk, sequential=self.materialized,
                              screen=True),
                lb=blb,
                blocks=BlockRanges(self.n, self.block_size),
            )

    def _query_keys_batch(self, Q: np.ndarray, backend: str) -> np.ndarray:
        """Sortable keys for a query batch: (m, n) series -> (m, nw) uint32.

        ``backend="kernel"`` sends the batch to the run's device and
        produces PAA, symbols and interleaved keys there (``kernels.ops.
        summarize``: one ``paa`` and one ``sax_pack`` launch); like the
        reference's kernel path it does not z-normalize. The other backends
        summarize on the host."""
        if backend == "kernel":
            import torch

            from ..kernels import ops as kernel_ops

            q = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(self.device)
            _, _, keys = kernel_ops.summarize(q, self.cfg)
            return kernel_ops.keys_to_host(keys).reshape(-1, self.cfg.key_words)
        qp = paa(Q, self.cfg)
        qsym = sax_from_paa(qp, self.cfg).astype(np.int32)
        return interleave(qsym, self.cfg).reshape(-1, self.cfg.key_words)

    def plan_approx(
        self,
        Q: np.ndarray,
        *,
        n_blocks: int = 1,
        raw: Optional[RawStore] = None,
        disk: Optional[DiskModel] = None,
        backend: str = "device",
    ) -> RangeSource:
        """Approximate-tier candidate generation: each query is answered
        from the ``n_blocks`` blocks adjacent to its sortable-key position.

        The whole batch shares one pipeline: query keys are produced in one
        batched summarization pass, all m key seeks run as ONE
        vectorized lexicographic binary search (``searchsorted_keys_batch``
        — O(log N) fancy-indexed probes for the batch), and the resulting
        per-query entry spans go to the executor, which coalesces them into
        deduplicated sequential reads. Results are a subset of the exact
        answer — recall@k grows with ``n_blocks`` (more sequential bytes
        per query)."""
        Q = np.asarray(Q, np.float32)
        qkeys = self._query_keys_batch(Q, backend)
        pos = searchsorted_keys_batch(self.keys, qkeys)  # (m,) one batched seek
        bs = self.block_size
        # clamp: keys above every stored key still probe the tail block
        bc = np.minimum(pos, self.n - 1) // bs
        b0 = np.maximum(0, bc - (n_blocks - 1) // 2)
        b1 = np.minimum(self.n_blocks, b0 + n_blocks)
        spans = np.stack([b0 * bs, np.minimum(self.n, b1 * bs)], axis=1)
        eb = self._entry_bytes()
        read_index = read_payload = None
        if disk is not None:
            read_index = lambda rs: disk.read_seq_ranges(rs, unit_bytes=eb)
            read_payload = lambda rs: disk.read_seq_ranges(
                rs, unit_bytes=self.cfg.series_len * 4
            )
        return RangeSource(
            ops=self._ops(raw, disk, sequential=True, screen=False),
            spans=spans,
            logical_blocks=int(np.maximum(0, b1 - b0).sum()),
            read_index_ranges=read_index,
            read_payload_ranges=read_payload,
        )

    def knn_exact(
        self,
        q: np.ndarray,
        k: int = 1,
        *,
        raw: Optional[RawStore] = None,
        disk: Optional[DiskModel] = None,
        bsf: Optional[list] = None,
        window: Optional[tuple[int, int]] = None,
        stats: Optional[QueryStats] = None,
    ) -> tuple[list, QueryStats]:
        """Exact kNN within this run, sharing a best-so-far heap across runs.

        A batch-of-1 plan through the shared executor. ``bsf`` is a
        max-heap of (-dist2, id) of current best k; returns the updated
        heap. ``window=(t0, t1)`` filters by timestamp (inclusive).
        """
        stats = stats or QueryStats()
        bsf = bsf if bsf is not None else []
        if self.n == 0:
            return bsf, stats
        if run_time_skipped(self.t_min, self.t_max, window, self.ts is not None):
            stats.blocks_pruned += self.n_blocks
            return bsf, stats
        Q = np.asarray(q, np.float32).reshape(1, -1)
        plan = QueryPlan(m=1, sources=[self.plan_exact(Q, raw=raw, disk=disk)],
                         window=window)
        (vals, ids), stats = execute(plan, Q, k, state=_heap_to_state(bsf, k),
                                     stats=stats)
        return _state_to_heap(vals[0], ids[0]), stats

    def knn_batch(
        self,
        Q: np.ndarray,
        k: int = 1,
        *,
        raw: Optional[RawStore] = None,
        disk: Optional[DiskModel] = None,
        window: Optional[tuple[int, int]] = None,
        state: Optional[tuple[np.ndarray, np.ndarray]] = None,
        stats: Optional[QueryStats] = None,
        blocks_per_round: int = 32,
        backend: str = "device",
        time_skip: bool = True,
    ) -> tuple[tuple[np.ndarray, np.ndarray], QueryStats]:
        """Exact kNN for a whole query batch in one pass over this run.

        Plans this run's blocks (``plan_exact``) and hands the traversal to
        the shared executor; see :func:`repro_torch.core.execute.execute` for the
        pass structure and stats semantics. ``state`` is the batched
        best-so-far — ((m, k) distances ascending, (m, k) global ids,
        inf/-1 padded) — shared across runs the way the ``bsf`` heap is in
        ``knn_exact``. ``time_skip=False`` disables the run-level time
        range skip while keeping per-entry window filtering (PP semantics).
        """
        if backend not in BACKENDS:
            raise ValueError(f"unknown batch verify backend {backend!r}")
        Q = np.asarray(Q, np.float32)
        m = Q.shape[0]
        stats = stats if stats is not None else QueryStats()
        if state is None:
            state = empty_topk_state(m, k)
        if self.n == 0 or m == 0:
            return state, stats
        if run_time_skipped(self.t_min, self.t_max, window,
                            time_skip and self.ts is not None):
            stats.blocks_pruned += self.n_blocks * m  # per-query semantics
            return state, stats
        plan = QueryPlan(m=m, sources=[self.plan_exact(Q, raw=raw, disk=disk)],
                         window=window, time_skip=time_skip)
        return execute(plan, Q, k, state=state, stats=stats, backend=backend,
                       blocks_per_round=blocks_per_round)

    def knn_approx(
        self,
        q: np.ndarray,
        k: int = 1,
        *,
        n_blocks: int = 1,
        raw: Optional[RawStore] = None,
        disk: Optional[DiskModel] = None,
        window: Optional[tuple[int, int]] = None,
    ) -> tuple[list, QueryStats]:
        """Approximate kNN: verify only the blocks adjacent to the query key
        position (one sequential read — the sortable-summarization payoff).
        Batch-of-1 over the shared executor; returns a (-d2, id) heap."""
        stats = QueryStats()
        if self.n == 0:
            return [], stats
        Q = np.asarray(q, np.float32).reshape(1, -1)
        plan = QueryPlan(
            m=1,
            sources=[self.plan_approx(Q, n_blocks=n_blocks, raw=raw, disk=disk)],
            window=window,
        )
        (vals, ids), stats = execute(plan, Q, k, stats=stats)
        return _state_to_heap(vals[0], ids[0]), stats

    def knn_approx_batch(
        self,
        Q: np.ndarray,
        k: int = 1,
        *,
        n_blocks: int = 1,
        raw: Optional[RawStore] = None,
        disk: Optional[DiskModel] = None,
        window: Optional[tuple[int, int]] = None,
        state: Optional[tuple[np.ndarray, np.ndarray]] = None,
        stats: Optional[QueryStats] = None,
        backend: str = "device",
    ) -> tuple[tuple[np.ndarray, np.ndarray], QueryStats]:
        """Approximate kNN for a whole query batch — the batched form of
        ``knn_approx`` (same per-query answers, shared physical work).

        Plans the per-query adjacent-block spans (``plan_approx``) and lets
        the executor coalesce them into deduplicated sequential reads with
        one shared top-k pass per distinct span. ``state``/``stats`` thread
        across runs exactly like ``knn_batch`` (CLSM folds one state over
        all levels)."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown batch verify backend {backend!r}")
        Q = np.asarray(Q, np.float32)
        m = Q.shape[0]
        stats = stats if stats is not None else QueryStats()
        if self.n == 0 or m == 0:
            if state is not None:
                return (state[0].copy(), state[1].copy()), stats
            return empty_topk_state(m, k), stats
        plan = QueryPlan(
            m=m,
            sources=[self.plan_approx(Q, n_blocks=n_blocks, raw=raw, disk=disk,
                                      backend=backend)],
            window=window,
        )
        return execute(plan, Q, k, state=state, stats=stats, backend=backend)


def _heap_to_state(bsf: list, k: int) -> tuple[np.ndarray, np.ndarray]:
    """A scalar (-d2, id) heap as a (1, k) batched best-so-far state."""
    vals, ids = empty_topk_state(1, k)
    for j, (d, i) in enumerate(sorted((-nd, i) for nd, i in bsf)[:k]):
        vals[0, j] = d
        ids[0, j] = i
    return vals, ids


def _state_to_heap(vals_row: np.ndarray, ids_row: np.ndarray) -> list:
    """One (k,) state row back into the scalar (-d2, id) heap form."""
    h = [(-float(v), int(g)) for v, g in zip(vals_row, ids_row) if g >= 0]
    heapq.heapify(h)
    return h


@dataclasses.dataclass
class CTreeConfig:
    summarization: SummarizationConfig = dataclasses.field(default_factory=SummarizationConfig)
    block_size: int = 1024
    materialized: bool = False
    fill_factor: float = 1.0  # <1 leaves insert gaps (update-tolerant)
    mem_budget_entries: int = 1 << 20
    # device-arena storage dtype for the screen tier (f32|bf16|int8; None
    # resolves the engine default / REPRO_SCREEN_DTYPE)
    screen_dtype: Optional[str] = None
    device: str = "cuda"  # where the run's device arena lives


class CTree:
    """The read-optimized Coconut index: one SortedRun + insert gaps."""

    def __init__(self, cfg: CTreeConfig, disk: Optional[DiskModel] = None,
                 storage=None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.disk = disk or DiskModel()
        # optional file backend: built/rebuilt runs are persisted and served
        # from mmaps (the static index has no WAL — a bulk build is re-runnable)
        self.storage = storage
        self.run: Optional[SortedRun] = None
        # overflow entries absorbed by gaps (kept summarized + optionally raw)
        self._pending: list[tuple[np.ndarray, np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]] = []
        self._pending_n = 0
        self.build_report: Optional[SortReport] = None

    # ---------------------------------------------------------------- build
    def bulk_build(
        self,
        series: np.ndarray,
        ids: np.ndarray,
        ts: Optional[np.ndarray] = None,
    ) -> SortReport:
        scfg = self.cfg.summarization
        eff_block = max(8, int(self.cfg.block_size * self.cfg.fill_factor))
        old = self.run
        self.run, report = SortedRun.build(
            series,
            ids,
            scfg,
            block_size=eff_block,
            materialized=self.cfg.materialized,
            ts=ts,
            disk=self.disk,
            mem_budget_entries=self.cfg.mem_budget_entries,
            screen_dtype=self.cfg.screen_dtype,
            device=self.device,
        )
        if self.storage is not None:
            self.run = self.storage.persist_run(self.run)
            if old is not None and old._storage is not None:
                self.storage.drop_run(old)
        self.build_report = report
        return report

    @property
    def gap_capacity(self) -> int:
        if self.run is None:
            return 0
        full = self.cfg.block_size
        eff = self.run.block_size
        return (full - eff) * self.run.n_blocks

    def insert(
        self,
        series: np.ndarray,
        ids: np.ndarray,
        ts: Optional[np.ndarray] = None,
    ) -> bool:
        """Absorb inserts into leaf gaps (random writes); returns True if a
        rebuild was triggered (gaps exhausted)."""
        series = np.asarray(series, np.float32)
        scfg = self.cfg.summarization
        syms = sax_from_paa(paa(series, scfg), scfg).astype(np.uint8)
        self._pending.append((syms, np.asarray(ids, np.int64), series if self.cfg.materialized else None, ts))
        self._pending_n += series.shape[0]
        # each absorbed insert costs one random page read + write (find leaf, write gap)
        self.disk.read_rand(series.shape[0] * self.disk.page_bytes)
        self.disk.write_rand(series.shape[0] * self.disk.page_bytes)
        if self._pending_n > self.gap_capacity:
            self._rebuild_with_pending()
            return True
        return False

    def _rebuild_with_pending(self) -> None:
        assert self.run is not None
        scfg = self.cfg.summarization
        syms = np.concatenate([self.run.sax] + [p[0] for p in self._pending])
        ids = np.concatenate([self.run.ids] + [p[1] for p in self._pending])
        series = None
        if self.cfg.materialized:
            series = np.concatenate([self.run.series] + [p[2] for p in self._pending])
        ts = None
        if self.run.ts is not None:
            ts = np.concatenate(
                [self.run.ts] + [p[3] if p[3] is not None else np.zeros(len(p[1]), np.int64) for p in self._pending]
            )
        eff_block = max(8, int(self.cfg.block_size * self.cfg.fill_factor))
        old = self.run
        self.run, self.build_report = SortedRun.from_arrays(
            scfg,
            syms,
            ids,
            block_size=eff_block,
            series=series,
            ts=ts,
            disk=self.disk,
            mem_budget_entries=self.cfg.mem_budget_entries,
            screen_dtype=self.cfg.screen_dtype,
            device=self.device,
        )
        if self.storage is not None:
            self.run = self.storage.persist_run(self.run)
            if old._storage is not None:
                self.storage.drop_run(old)
        self._pending, self._pending_n = [], 0

    # ---------------------------------------------------------------- query
    def _pending_sources(self, raw: Optional[RawStore]) -> list[DenseSource]:
        """The (small) gap-absorbed set as brute-force plan sources."""
        out = []
        for _syms, pids, series, ts in self._pending:
            if series is not None:
                fetch = lambda p, s=series: s[p]
            else:
                fetch = lambda p, i=pids: raw.fetch(i[p])
            out.append(DenseSource(ops=SourceOps(ids=pids, ts=ts, fetch=fetch,
                                                 device=self.device),
                                   n=len(pids)))
        return out

    def plan(
        self,
        Q: np.ndarray,
        *,
        tier: str = "exact",
        n_blocks: int = 1,
        raw: Optional[RawStore] = None,
        window: Optional[tuple[int, int]] = None,
        backend: str = "device",
    ) -> QueryPlan:
        """Compile a query batch into a declarative plan: the sorted run's
        candidate source (exact blocks or approximate spans) plus one dense
        source per pending gap-absorbed chunk."""
        sources: list = []
        pruned = 0
        if self.run is not None and self.run.n:
            r = self.run
            if tier == "exact":
                if run_time_skipped(r.t_min, r.t_max, window, r.ts is not None):
                    pruned += r.n_blocks
                else:
                    sources.append(r.plan_exact(Q, raw=raw, disk=self.disk))
            else:
                sources.append(r.plan_approx(Q, n_blocks=n_blocks, raw=raw,
                                             disk=self.disk, backend=backend))
        sources.extend(self._pending_sources(raw))
        return QueryPlan(m=len(Q), sources=sources, window=window,
                         pruned_blocks=pruned)

    def knn_exact(self, q, k=1, *, raw=None, window=None):
        """Scalar exact kNN — a batch-of-1 plan through the shared executor.
        Returns ([(d2, id)] ascending, stats)."""
        vals, gids, stats = self.knn_batch(
            np.asarray(q, np.float32).reshape(1, -1), k, raw=raw, window=window
        )
        return state_to_list(vals[0], gids[0]), stats

    @spans.request
    def knn_batch(self, Q, k=1, *, raw=None, window=None, backend="device",
                  shard=None, mesh=None):
        """Batched exact kNN: ((m, k) d2 ascending, (m, k) ids), stats.

        Unfilled slots (fewer than k in-window entries) are (inf, -1).
        ``shard="mesh"`` executes on the device mesh (queries x runs 2-D,
        ``core.distributed``) with host f64 re-ranking — same answers."""
        Q = np.asarray(Q, np.float32)
        plan = self.plan(Q, tier="exact", raw=raw, window=window)
        (vals, gids), stats = execute(plan, Q, k, backend=backend, shard=shard,
                                      mesh=mesh)
        return vals, gids, stats

    def knn_approx(self, q, k=1, *, n_blocks=1, raw=None, window=None):
        """Scalar approximate kNN — a batch-of-1 plan through the executor.
        Returns ([(d2, id)] ascending, stats)."""
        vals, gids, stats = self.knn_approx_batch(
            np.asarray(q, np.float32).reshape(1, -1), k, n_blocks=n_blocks,
            raw=raw, window=window,
        )
        return state_to_list(vals[0], gids[0]), stats

    def knn_approx_batch(self, Q, k=1, *, n_blocks=1, raw=None, window=None,
                         backend="device"):
        """Batched approximate kNN: ((m, k) d2 ascending, (m, k) ids), stats.

        Per-query answers match a loop of ``knn_approx`` at the same
        ``n_blocks``; physically the batch shares one key-summarization
        pass, one vectorized key seek and coalesced sequential block reads
        (see ``SortedRun.plan_approx`` + the executor). Results are a
        subset of the exact ``knn_batch`` answer — only each query's
        ``n_blocks`` adjacent blocks are verified, so ``n_blocks`` trades
        sequential bytes read for recall@k. Unfilled slots are (inf, -1)."""
        if backend not in BACKENDS:
            raise ValueError(f"unknown batch verify backend {backend!r}")
        Q = np.asarray(Q, np.float32)
        plan = self.plan(Q, tier="approx", n_blocks=n_blocks, raw=raw,
                         window=window, backend=backend)
        (vals, gids), stats = execute(plan, Q, k, backend=backend)
        return vals, gids, stats

    def index_bytes(self) -> int:
        return 0 if self.run is None else self.run.index_bytes()
