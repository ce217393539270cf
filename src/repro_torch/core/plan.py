"""Declarative query plans — candidate generation separated from execution.

Every Coconut index variant answers every query through the same physical
recipe (the paper's sortable-summarization claim): seek into sorted keys,
read sequential block ranges, verify candidates against a best-so-far
radius. This module makes that recipe explicit: each index *plans* a query
(which entries could matter, at what lower bound, under which window
predicate) and :mod:`repro_torch.core.execute` *runs* the plan (coalesced reads,
the shared f32-screen + f64 re-rank verification passes, (m, k) state
folding). Adding a new index or serving tier means writing a plan builder,
not a fifth copy of the traversal loop.

A :class:`QueryPlan` is an ordered list of candidate sources (newest first,
so verified distances from recent data prune older sources) plus the
window predicate and run-level skip semantics as data:

* :class:`DenseSource`  — verify everything (in-memory buffers, pending
  gap inserts). No pruning structure, no stats/IO accounting by design.
* :class:`BlockSource`  — block-structured exact traversal: per-(query,
  block) lower bounds from zone maps, adaptive best-first verification,
  optional :attr:`BlockSource.refine` for ADS+'s query-time leaf splits.
  A sorted run's blocks are :class:`BlockRanges` (contiguous ranges of its
  entries); ADS+'s leaves stay position lists.
* :class:`RangeSource`  — the approximate tier on a sorted run: per-query
  contiguous entry spans around the sortable-key seek position, coalesced
  into deduplicated sequential reads.
* :class:`GroupSource`  — the approximate tier on a leaf-partitioned tree
  (ADS+): explicit (query-group, candidate-positions) pairs, one shared
  verification per distinct leaf.

PP / TP / BTP map onto plan flags instead of run mutation: ``time_skip``
decides at *plan build* whether a run whose [t_min, t_max] misses the
window is dropped (TP/BTP) or planned anyway with entry-level filtering
(PP). Skipped runs are recorded in :attr:`QueryPlan.pruned_blocks` so the
executor can keep the per-query logical accounting.

Physical access is abstracted behind :class:`SourceOps` closures so the
executor stays storage-agnostic: ``fetch`` returns raw series for entry
positions (modeled I/O accounted by the closure), ``index_read`` accounts
index-entry reads, ``norms2`` serves cached squared norms for the
screen-without-recompute fast path. The device accessors
(``device_view``/``table_rows``/``table_ids``/``fetch_account``) expose
the source's table to the default device verification backend
(:mod:`repro_torch.core.verify_engine`) without the executor ever touching a
device tensor:
the arena handle, the position->table-row map (an array, so a sorted
run's rows are slices of it), the row->global-id map, and modeled-I/O
accounting, by arena row, for passes that never materialize on the host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional, Tuple, Union

import numpy as np

from .summarization import SummarizationConfig


@dataclasses.dataclass
class QueryStats:
    blocks_pruned: int = 0
    blocks_visited: int = 0
    entries_pruned: int = 0
    entries_verified: int = 0

    def merge(self, o: "QueryStats") -> "QueryStats":
        return QueryStats(
            self.blocks_pruned + o.blocks_pruned,
            self.blocks_visited + o.blocks_visited,
            self.entries_pruned + o.entries_pruned,
            self.entries_verified + o.entries_verified,
        )


@dataclasses.dataclass
class SourceOps:
    """Physical accessors for one candidate source (all I/O accounted by
    the closures, so the executor never sees a DiskModel)."""

    ids: np.ndarray  # (N,) global ids, aligned with entry positions
    ts: Optional[np.ndarray] = None  # (N,) timestamps (window filtering)
    # positions -> (U, series_len) f32 raw series; models its own I/O
    fetch: Optional[Callable[[np.ndarray], np.ndarray]] = None
    # account reading the index entries (keys+sax) of a round: their
    # positions, or their count where the source's blocks are BlockRanges
    index_read: Optional[Callable] = None
    # entry-level lower-bound screen inputs (exact traversal)
    sax: Optional[np.ndarray] = None  # (N, w) SAX symbols
    scfg: Optional[SummarizationConfig] = None
    # cached |x|^2 per position (approximate-tier screen fast path)
    norms2: Optional[Callable[[np.ndarray], np.ndarray]] = None
    # contiguous materialized storage: zero-copy views for dense spans
    series: Optional[np.ndarray] = None
    # --- device-resident verification (the executor's "device" backend) ---
    # lazy handle to the source's device arena (a verify_engine.DeviceView,
    # cached by the data owner so the table uploads once per lifetime)
    device_view: Optional[Callable[[], object]] = None
    # (N,) arena table row of each entry position (None: row == position,
    # a materialized run; the raw-store ids of a non-materialized one)
    table_rows: Optional[np.ndarray] = None
    # arena table rows -> global series ids (the inverse answer mapping)
    table_ids: Optional[Callable[[np.ndarray], np.ndarray]] = None
    # modeled-I/O accounting of fetching the entries at these arena rows
    # WITHOUT the host gather — the device path reads the arena, not the
    # store, but pays the same modeled I/O as the host engine so stats
    # stay comparable
    fetch_account: Optional[Callable[[np.ndarray], None]] = None
    # async readahead of coalesced [lo, hi) row spans (file-backed runs
    # hand them to the readahead pool); advisory — answers never depend on it
    prefetch_ranges: Optional[Callable[[List[Tuple[int, int]]], None]] = None
    # the device the source's index lives on: backend="kernel" uploads each
    # pass's rows there and launches topk_ed on it
    device: Optional[object] = None


@dataclasses.dataclass
class DenseSource:
    """Brute-force a small entry set (write buffer, gap-absorbed inserts).

    Mirrors the pre-plan ``_buffer_scan``/``_pending_scan`` semantics:
    no stats and no modeled I/O beyond what ``fetch`` itself accounts."""

    ops: SourceOps
    n: int


@dataclasses.dataclass(frozen=True)
class BlockRanges:
    """The blocks of a sorted run as ranges of its entries: block ``b`` is
    ``[b * size, min(n, (b + 1) * size))``. :meth:`take` gives the entries
    of selected blocks without building a position list."""

    n: int
    size: int

    def __len__(self) -> int:
        return -(-self.n // self.size)

    def count(self, sel: np.ndarray) -> int:
        """Entries in the blocks ``sel``."""
        lo = np.asarray(sel, np.int64) * self.size
        return int((np.minimum(lo + self.size, self.n) - lo).sum())

    def take(self, sel: np.ndarray, a: Optional[np.ndarray] = None) -> np.ndarray:
        """``concat(a[block] for block in sel)`` in ``sel``'s order, or the
        blocks' positions where ``a`` is None. The full blocks are rows of
        ``a`` seen as (blocks, size); only the short last block, if ``sel``
        holds it, is sliced on its own."""
        sel = np.asarray(sel, np.int64)
        full = self.n // self.size
        lo = full * self.size
        if a is None:
            def rows(s):
                return (s[:, None] * self.size + np.arange(self.size)).ravel()
            tail = np.arange(lo, self.n)
        else:
            def rows(s):
                return a[:lo].reshape(full, self.size)[s].ravel()
            tail = a[lo:self.n]
        j = np.flatnonzero(sel == full)
        if j.size == 0:
            return rows(sel)
        j = int(j[0])
        return np.concatenate([rows(sel[:j]), tail, rows(sel[j + 1:])])


def block_positions(blocks, sel: np.ndarray) -> np.ndarray:
    """The entry positions of the blocks ``sel``, in ``sel``'s order, of a
    :class:`BlockSource`'s position lists or :class:`BlockRanges`."""
    if isinstance(blocks, BlockRanges):
        return blocks.take(sel)
    if len(sel) == 0:
        return np.zeros(0, np.int64)
    return np.concatenate([blocks[b] for b in sel])


@dataclasses.dataclass
class BlockSource:
    """Exact adaptive traversal over lower-bounded entry blocks."""

    ops: SourceOps
    lb: np.ndarray  # (m, nb) per-(query, block) lower bounds
    # per-block entry positions: a sorted run's BlockRanges, or a list of
    # position arrays (ADS+'s leaves, which are not contiguous and to
    # which ``refine`` appends)
    blocks: Union[BlockRanges, List[np.ndarray]]
    # adaptive refinement (ADS+): called when block b is selected for
    # verification; returns replacement [(lb_col (m,), positions), ...] or
    # None to verify the block as-is. Replaced blocks are never verified.
    refine: Optional[Callable[[int], Optional[List[Tuple[np.ndarray, np.ndarray]]]]] = None


@dataclasses.dataclass
class RangeSource:
    """Approximate tier over a sorted run: per-query contiguous spans."""

    ops: SourceOps
    spans: np.ndarray  # (m, 2) per-query [lo, hi) entry spans
    logical_blocks: int = 0  # per-(query, block) logical work for stats
    # account the coalesced sequential index read / materialized payload
    read_index_ranges: Optional[Callable[[List[Tuple[int, int]]], None]] = None
    read_payload_ranges: Optional[Callable[[List[Tuple[int, int]]], None]] = None


@dataclasses.dataclass
class GroupSource:
    """Approximate tier over a leaf-partitioned tree (ADS+)."""

    ops: SourceOps
    groups: List[Tuple[np.ndarray, np.ndarray]]  # (query rows, positions)
    group_reads: Optional[List[Callable[[], None]]] = None  # per-group leaf read
    pre_read: Optional[Callable[[], None]] = None  # tree-descent page touches


@dataclasses.dataclass
class QueryPlan:
    """An ordered, declarative description of one (batched) query."""

    m: int  # query batch size
    sources: list  # newest-first: Dense/Block/Range/Group sources
    window: Optional[Tuple[int, int]] = None  # inclusive [t0, t1] predicate
    time_skip: bool = True  # run-level temporal skip applied at build (TP/BTP)
    pruned_blocks: int = 0  # blocks of runs skipped at plan time (per query)
    # the run-registry epoch the plan was built against (None = the source
    # index is not registry-backed). Sources resolve against that pinned
    # snapshot, so the plan stays well-defined under concurrent ingest.
    epoch: Optional[int] = None


def window_mask(ts: Optional[np.ndarray], window: Optional[Tuple[int, int]],
                positions: np.ndarray) -> Optional[np.ndarray]:
    """Boolean in-window mask for entry ``positions`` (None = keep all)."""
    if window is None or ts is None:
        return None
    t = ts[positions]
    return (t >= window[0]) & (t <= window[1])


def run_time_skipped(t_min: int, t_max: int,
                     window: Optional[Tuple[int, int]],
                     time_skip: bool) -> bool:
    """Run-level temporal skip decision — the plan-flag form of PP/TP/BTP:
    under PP (``time_skip=False``) a run is never skipped, only its entries
    are filtered; under TP/BTP a run whose time range misses the window
    drops out of the plan entirely."""
    return bool(time_skip and window is not None
                and (t_max < window[0] or t_min > window[1]))
