"""ADSFull / ADS+ baseline — the state of the art the paper demos against.

A top-down-inserted iSAX tree: the root fans out on the first bit of every
segment; an overflowing leaf splits by promoting the cardinality of one
segment (round-robin). Every insert descends to a leaf — one random page
read + one random page write per entry (the cost profile Coconut removes).

Modes:
  * ``full``      — ADSFull: leaves store the raw series (materialized).
  * ``adaptive``  — ADS+: construction stores only summarizations with a
    large leaf threshold (fast, skeletal build); queries adaptively split
    the leaves they touch down to ``query_leaf_size`` and fetch raw series
    lazily from the RawStore (random reads at query time).

Queries compile to the shared plan/execute engine: the tree's non-empty
leaves become the blocks of a :class:`repro_torch.core.plan.BlockSource` (their
iSAX node regions are the zone maps), and ADS+'s query-time adaptive
splitting is the plan's ``refine`` hook — when the executor selects an
oversized leaf for verification, the leaf splits and its children re-enter
the traversal with their own (tighter) bounds, exactly the lazy refinement
of the scalar algorithm. This gives ADS+ the full batched exact tier
(``knn_batch``) through the same executor as every Coconut index.

Verification runs on ``ADSConfig.device`` (``"cuda"`` unless the caller
says otherwise): ``backend="device"`` screens full-mode leaves in a flat
device arena (the ``screen_select`` kernels), ``backend="kernel"`` uploads
each pass's rows and launches ``topk_ed``, ``backend="numpy"`` stays on the
host.

Implementation note: inserts are batched and partitioned vectorially for
host speed, but the I/O accounting matches per-entry top-down insertion.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from .ctree import RawStore
from .execute import execute, state_to_list
from .io_model import DiskModel
from .lower_bounds import mindist_region2
from .plan import BlockSource, GroupSource, QueryPlan, SourceOps
from .summarization import SummarizationConfig, paa, sax_from_paa
from .verify_engine import get_engine, resolve_device


@dataclasses.dataclass
class ADSConfig:
    summarization: SummarizationConfig = dataclasses.field(default_factory=SummarizationConfig)
    leaf_size: int = 1024
    mode: str = "full"  # full | adaptive
    query_leaf_size: int = 128  # adaptive-split target during queries
    # device-arena storage dtype for the screen tier (f32|bf16|int8; None
    # resolves the engine default / REPRO_SCREEN_DTYPE)
    screen_dtype: Optional[str] = None
    device: str = "cuda"  # where the leaf arena lives and kernels launch


class _Node:
    __slots__ = ("card", "prefix", "children", "split_seg", "sax", "ids", "ts", "series", "n")

    def __init__(self, card: np.ndarray, prefix: np.ndarray):
        self.card = card  # (w,) bits used per segment at this node
        self.prefix = prefix  # (w,) symbol prefix (card bits per segment)
        self.children: Optional[dict] = None  # split bit -> node
        self.split_seg: int = -1
        self.sax: Optional[np.ndarray] = None
        self.ids: Optional[np.ndarray] = None
        self.ts: Optional[np.ndarray] = None
        self.series: Optional[np.ndarray] = None
        self.n = 0

    @property
    def is_leaf(self) -> bool:
        return self.children is None


class ADSIndex:
    def __init__(self, cfg: ADSConfig, disk: Optional[DiskModel] = None):
        self.cfg = cfg
        self.device = resolve_device(cfg.device)
        self.disk = disk or DiskModel()
        w = cfg.summarization.n_segments
        self.root_children: dict[tuple, _Node] = {}
        self._w = w
        self._c = cfg.summarization.card_bits
        self.n = 0
        self.n_splits = 0
        self._flat_cache: Optional[dict] = None  # flattened leaf view

    # ---------------------------------------------------------------- build
    def insert_batch(
        self,
        series: np.ndarray,
        ids: np.ndarray,
        ts: Optional[np.ndarray] = None,
    ) -> None:
        scfg = self.cfg.summarization
        series = np.asarray(series, np.float32)
        syms = sax_from_paa(paa(series, scfg), scfg).astype(np.int16)
        ids = np.asarray(ids, np.int64)
        ts = np.asarray(ts, np.int64) if ts is not None else np.zeros(len(ids), np.int64)
        keep_series = series if self.cfg.mode == "full" else None
        # per-entry top-down insertion cost: descend (read) + leaf write
        self.disk.read_rand(len(ids) * self.disk.page_bytes)
        self.disk.write_rand(len(ids) * self.disk.page_bytes)
        self._flat_cache = None
        # root fan-out on the MSB of each segment
        msb = (syms >> (self._c - 1)).astype(np.int8)  # (B, w) in {0,1}
        groups: dict[tuple, np.ndarray] = {}
        view = [tuple(row) for row in msb]
        for i, key in enumerate(view):
            groups.setdefault(key, []).append(i)
        for key, idxs in groups.items():
            idxs = np.asarray(idxs)
            node = self.root_children.get(key)
            if node is None:
                card = np.ones(self._w, np.int8)
                prefix = np.asarray(key, np.int16)
                node = _Node(card, prefix)
                self.root_children[key] = node
            self._node_insert(
                node,
                syms[idxs],
                ids[idxs],
                ts[idxs],
                keep_series[idxs] if keep_series is not None else None,
            )
        self.n += len(ids)

    def _leaf_limit(self) -> int:
        return self.cfg.leaf_size

    def _node_insert(self, node: _Node, syms, ids, ts, series) -> None:
        if node.is_leaf:
            node.sax = syms if node.sax is None else np.concatenate([node.sax, syms])
            node.ids = ids if node.ids is None else np.concatenate([node.ids, ids])
            node.ts = ts if node.ts is None else np.concatenate([node.ts, ts])
            if series is not None:
                node.series = (
                    series if node.series is None else np.concatenate([node.series, series])
                )
            node.n = len(node.ids)
            if node.n > self._leaf_limit():
                self._split(node)
            return
        self._route_to_children(node, syms, ids, ts, series)

    def _route_to_children(self, node: _Node, syms, ids, ts, series) -> None:
        seg = node.split_seg
        depth = int(node.card[seg]) + 1  # bit position (1-based from MSB) used by children
        bit = (syms[:, seg] >> (self._c - depth)) & 1
        for b in (0, 1):
            m = bit == b
            if not m.any():
                continue
            child = node.children[b]
            self._node_insert(
                child, syms[m], ids[m], ts[m], series[m] if series is not None else None
            )

    def _split(self, node: _Node) -> None:
        # choose split segment round-robin: least-used cardinality first
        cands = np.where(node.card < self._c)[0]
        if cands.size == 0:
            return  # cannot split further; oversized leaf allowed
        seg = int(cands[np.argmin(node.card[cands])])
        node.split_seg = seg
        node.children = {}
        newbits = int(node.card[seg]) + 1
        for b in (0, 1):
            card = node.card.copy()
            card[seg] = newbits
            prefix = node.prefix.copy()
            prefix[seg] = (prefix[seg] << 1) | b
            node.children[b] = _Node(card, prefix)
        syms, ids, ts, series = node.sax, node.ids, node.ts, node.series
        node.sax = node.ids = node.ts = node.series = None
        node.n = 0
        self.n_splits += 1
        self._flat_cache = None
        # split rewrites both child pages
        self.disk.read_rand(self.disk.page_bytes)
        self.disk.write_rand(2 * self.disk.page_bytes)
        self._route_to_children(node, syms, ids, ts, series)

    # ---------------------------------------------------------------- query
    def _node_bounds(self, node: _Node):
        """(min_sym, max_sym) full-cardinality range covered by the node."""
        shift = self._c - node.card.astype(np.int32)
        min_sym = (node.prefix.astype(np.int32) << shift)
        max_sym = ((node.prefix.astype(np.int32) + 1) << shift) - 1
        return min_sym, max_sym

    def _flat(self) -> dict:
        """Lazily flattened view of the non-empty leaves: one contiguous
        position space for the planner. The entry arrays are copies keyed
        to the leaves at build time, so query-time adaptive splits never
        invalidate positions (``fetch``/``index_read`` keep resolving
        through the original ``offsets``/``series`` refs). The evolving
        leaf partition lives in ``blocks`` — ``[node, positions]`` cells
        that the refine hook patches in place (split parents nulled,
        children appended), so a split costs O(children), not an O(N)
        rebuild on the next query. Inserts rebuild from the real tree."""
        if self._flat_cache is None:
            leaves: list[_Node] = []
            stack = list(self.root_children.values())
            while stack:
                node = stack.pop()
                if node.is_leaf:
                    if node.n:
                        leaves.append(node)
                else:
                    stack.extend(node.children.values())
            offsets = np.cumsum([0] + [lf.n for lf in leaves])
            if leaves:
                sax = np.concatenate([lf.sax for lf in leaves])
                ids = np.concatenate([lf.ids for lf in leaves])
                ts = np.concatenate([lf.ts for lf in leaves])
            else:
                sax = np.zeros((0, self._w), np.int16)
                ids = np.zeros((0,), np.int64)
                ts = np.zeros((0,), np.int64)
            self._flat_cache = {
                "offsets": offsets,
                "sax": sax,
                "ids": ids,
                "ts": ts,
                "series": [lf.series for lf in leaves],  # refs survive splits
                "blocks": [
                    [lf, np.arange(offsets[i], offsets[i + 1])]
                    for i, lf in enumerate(leaves)
                ],
            }
        return self._flat_cache

    def _flat_blocks(self, flat: dict) -> list:
        """The live (node, positions) leaf partition — split parents drop."""
        return [e for e in flat["blocks"] if e[0] is not None]

    def _flat_device_view(self, flat: dict):
        """Device arena over the flattened leaf space (full mode): the
        per-leaf series concatenate once into the flat position space and
        upload once per flat cache generation (inserts rebuild the cache;
        query-time splits keep positions stable, so the arena survives)."""
        if flat.get("_dev_view") is None:
            L = self.cfg.summarization.series_len
            table = (
                np.concatenate(flat["series"])
                if flat["series"]
                else np.zeros((0, L), np.float32)
            )
            flat["_dev_view"] = get_engine(self.device).build_view(
                table, dtype=self.cfg.screen_dtype)
        return flat["_dev_view"]

    def _flat_ops(self, flat: dict, raw: Optional[RawStore], *,
                  screen: bool) -> SourceOps:
        """Executor accessors over the flattened leaf space (I/O accounted
        per leaf, matching the top-down tree's random-read cost profile)."""
        offsets = flat["offsets"]
        L = self.cfg.summarization.series_len

        def fetch(pos: np.ndarray) -> np.ndarray:
            if self.cfg.mode != "full":
                if raw is None:
                    raise ValueError("adaptive ADS+ requires a RawStore")
                return raw.fetch(flat["ids"][pos])
            out = np.empty((pos.size, L), np.float32)
            leaf_of = np.searchsorted(offsets, pos, side="right") - 1
            for li in np.unique(leaf_of):
                sel = leaf_of == li
                data = flat["series"][li][pos[sel] - offsets[li]]
                self.disk.read_rand(data.nbytes)
                out[sel] = data
            return out

        def fetch_account(rows: np.ndarray) -> None:
            # the modeled I/O of ``fetch`` without the gather (device path)
            if self.cfg.mode != "full":
                raw.account_fetch(rows)  # the RawStore's rows: global ids
                return
            # the flat table's rows are its positions
            leaf_of = np.searchsorted(offsets, rows, side="right") - 1
            for _, cnt in zip(*np.unique(leaf_of, return_counts=True)):
                self.disk.read_rand(int(cnt) * L * 4)

        def index_read(pos: np.ndarray) -> None:
            # one node-page touch + one summarization read per leaf visited
            leaf_of = np.searchsorted(offsets, pos, side="right") - 1
            for li, cnt in zip(*np.unique(leaf_of, return_counts=True)):
                self.disk.read_rand(self.disk.page_bytes)
                self.disk.read_rand(int(max(1, cnt)) * (self._w + 8))

        # device arena: full mode owns the flat table (row == flat position);
        # adaptive mode verifies against the RawStore arena (row == global id)
        if self.cfg.mode == "full":
            device_view = lambda: self._flat_device_view(flat)
            table_rows = None  # identity
            table_ids = lambda r: flat["ids"][r]
        elif raw is not None:
            device_view = raw.device_view
            table_rows = flat["ids"]
            table_ids = lambda r: r  # raw rows ARE global ids
        else:
            device_view = table_rows = table_ids = None
            fetch_account = None

        return SourceOps(
            ids=flat["ids"],
            ts=flat["ts"],
            fetch=fetch,
            index_read=index_read,
            sax=flat["sax"] if screen else None,
            scfg=self.cfg.summarization,
            device_view=device_view,
            table_rows=table_rows,
            table_ids=table_ids,
            fetch_account=fetch_account,
            device=self.device,
        )

    def _make_refine(self, flat: dict, blocks_tbl: list, qp: np.ndarray):
        """The adaptive-split plan hook: when the executor selects an
        oversized leaf, split it (same tree mutation + I/O accounting as
        the scalar path) and hand back the children as new blocks with
        their own bounds. Children re-split on re-selection until within
        ``query_leaf_size`` — the PQ re-push of the old best-first loop.
        Splits patch the shared ``flat["blocks"]`` partition in place, so
        later queries start from the refined leaves without an O(N)
        cache rebuild."""
        if self.cfg.mode != "adaptive":
            return None
        scfg = self.cfg.summarization
        local: list = list(blocks_tbl)  # executor block index -> shared cell

        def refine(b: int):
            entry = local[b]
            node = entry[0]
            if not (node.is_leaf and node.n > self.cfg.query_leaf_size):
                return None
            self._split(node)  # nulls _flat_cache (general safety) ...
            self._flat_cache = flat  # ... but the flat arrays are copies:
            # reinstate the cache and patch its partition instead
            if node.is_leaf:  # could not split further (cardinality exhausted)
                return None
            pos = entry[1]
            entry[0] = None  # parent replaced in the shared partition
            seg = node.split_seg
            depth = int(node.card[seg]) + 1
            bit = (flat["sax"][pos][:, seg].astype(np.int32) >> (self._c - depth)) & 1
            out = []
            for bval in (0, 1):
                child = node.children[bval]
                cpos = pos[bit == bval]
                mn, mx = self._node_bounds(child)
                col = mindist_region2(qp, mn, mx, scfg)  # (m,)
                cell = [child, cpos]
                local.append(cell)
                if cpos.size:
                    flat["blocks"].append(cell)
                out.append((col, cpos))
            return out

        return refine

    def plan(
        self,
        Q: np.ndarray,
        *,
        tier: str = "exact",
        raw: Optional[RawStore] = None,
        window: Optional[tuple[int, int]] = None,
    ) -> QueryPlan:
        """Compile a query batch into a plan over the tree's leaves.

        ``tier="exact"``: every non-empty leaf is a lower-bounded block
        (its iSAX region is the zone map) with the adaptive-split refine
        hook. ``tier="approx"``: descend every query to its mapped leaf
        and verify each DISTINCT leaf once against its query group."""
        Q = np.asarray(Q, np.float32)
        m = Q.shape[0]
        flat = self._flat()
        blocks_tbl = self._flat_blocks(flat)
        scfg = self.cfg.summarization
        if not blocks_tbl or m == 0:
            return QueryPlan(m=m, sources=[], window=window)
        if tier == "exact":
            qp = np.asarray(paa(Q, scfg))  # (m, w)
            mn = np.stack([self._node_bounds(n)[0] for n, _ in blocks_tbl])
            mx = np.stack([self._node_bounds(n)[1] for n, _ in blocks_tbl])
            lb = mindist_region2(qp[:, None, :], mn, mx, scfg)  # (m, n_leaves)
            src = BlockSource(
                ops=self._flat_ops(flat, raw, screen=True),
                lb=lb,
                blocks=[pos for _, pos in blocks_tbl],
                refine=self._make_refine(flat, blocks_tbl, qp),
            )
            return QueryPlan(m=m, sources=[src], window=window)
        # approximate tier: per-query leaf descent, deduplicated by leaf
        qsym = sax_from_paa(np.asarray(paa(Q, scfg)), scfg).astype(np.int16)
        leaf_index = {id(n): i for i, (n, _) in enumerate(blocks_tbl)}
        groups: dict[int, list[int]] = {}
        node_touches = 0
        for i in range(m):
            key = tuple((qsym[i] >> (self._c - 1)).tolist())
            node = self.root_children.get(key)
            while node is not None and not node.is_leaf:
                node_touches += 1
                depth = int(node.card[node.split_seg]) + 1
                b = int((qsym[i, node.split_seg] >> (self._c - depth)) & 1)
                node = node.children[b]
            if node is None or node.n == 0:
                continue
            groups.setdefault(leaf_index[id(node)], []).append(i)
        group_list = [
            (np.asarray(qlist), blocks_tbl[li][1])
            for li, qlist in groups.items()
        ]
        group_reads = [
            (lambda n=blocks_tbl[li][0].n: self.disk.read_rand(
                max(1, n) * (self._w + 8)))
            for li in groups
        ]
        pre_read = None
        if node_touches:
            pre_read = lambda t=node_touches: self.disk.read_rand(
                t * self.disk.page_bytes)
        src = GroupSource(
            ops=self._flat_ops(flat, raw, screen=False),
            groups=group_list,
            group_reads=group_reads,
            pre_read=pre_read,
        )
        return QueryPlan(m=m, sources=[src], window=window)

    def knn_exact(self, q, k=1, *, raw: Optional[RawStore] = None, window=None):
        """Scalar exact kNN — a batch-of-1 plan through the shared executor
        (adaptive leaves still split lazily via the plan's refine hook).
        Returns ([(d2, id)] ascending, stats)."""
        vals, gids, stats = self.knn_batch(
            np.asarray(q, np.float32).reshape(1, -1), k, raw=raw, window=window
        )
        return state_to_list(vals[0], gids[0]), stats

    def knn_batch(self, Q, k=1, *, raw: Optional[RawStore] = None, window=None,
                  backend="device", shard=None, mesh=None):
        """Batched exact kNN: ((m, k) d2 ascending, (m, k) ids), stats.

        The iSAX leaves traverse through the same executor as every
        Coconut run — shared verification passes for the whole batch, with
        adaptive leaves splitting on first touch (``refine``). Unfilled
        slots are (inf, -1). ``shard="mesh"`` executes the plan on the
        device mesh."""
        Q = np.asarray(Q, np.float32)
        plan = self.plan(Q, tier="exact", raw=raw, window=window)
        (vals, gids), stats = execute(plan, Q, k, backend=backend, shard=shard,
                                      mesh=mesh)
        return vals, gids, stats

    def knn_approx(self, q, k=1, *, raw=None, window=None):
        """Descend to the single leaf the query maps to and verify it.
        Batch-of-1 plan; returns ([(d2, id)] ascending, stats)."""
        vals, gids, stats = self.knn_approx_batch(
            np.asarray(q, np.float32).reshape(1, -1), k, raw=raw, window=window
        )
        return state_to_list(vals[0], gids[0]), stats

    def knn_approx_batch(self, Q, k=1, *, raw: Optional[RawStore] = None,
                         window=None, backend="device"):
        """Batched approximate kNN: descend every query to its leaf, then
        verify each DISTINCT leaf once against its whole query group.

        Per-query answers match a loop of ``knn_approx``; physically the
        batch deduplicates leaf verifications — queries landing in the same
        leaf (the common case for clustered workloads) share one leaf read
        and one batched top-k pass. Results are a subset of the exact
        answer (only the single mapped leaf is verified), so recall@k
        depends on how much of the true neighborhood the leaf captures.
        Returns ((m, k) d2 ascending, (m, k) ids, stats); unfilled slots
        are (inf, -1). Stats follow the batched convention: logical
        per-query ``blocks_visited``, physical shared ``entries_verified``.
        """
        Q = np.asarray(Q, np.float32)
        plan = self.plan(Q, tier="approx", raw=raw, window=window)
        (vals, gids), stats = execute(plan, Q, k, backend=backend)
        return vals, gids, stats

    def index_bytes(self) -> int:
        total = 0
        stack = list(self.root_children.values())
        while stack:
            node = stack.pop()
            if node.is_leaf:
                if node.sax is not None:
                    total += node.sax.nbytes + node.ids.nbytes + node.ts.nbytes
                    if node.series is not None:
                        total += node.series.nbytes
            else:
                stack.extend(node.children.values())
        return total
