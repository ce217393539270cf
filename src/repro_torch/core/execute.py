"""The shared query executor — one physical engine for every index & tier.

Runs the declarative :class:`repro_torch.core.plan.QueryPlan` that each index
variant's candidate generation produces. All the physical work that used to
be copied into every ``knn_*`` method lives here exactly once:

* coalesced sequential reads for the approximate tier's entry ranges;
* the adaptive best-first block traversal of the exact tier (seed pass +
  bounded rounds, entry-level MINDIST screening, ADS+'s query-time leaf
  refinement as a plan hook);
* candidate verification as one fused DEVICE pass per round (the default
  ``backend="device"``): the source's table lives in a device arena
  (:mod:`repro_torch.core.verify_engine`), each pass gathers the round's rows on
  device, screens them in f32 against cached norms, selects a top-k slate
  in-kernel, and only the tiny certified slate crosses back for the exact
  f64 re-rank — one launch instead of einsum + argpartition + host gather,
  at shape-bucketed signatures. ``backend="numpy"`` is the retained host twin (one f32-sgemm
  screen + exact f64 re-rank per pass; also the fallback below the device
  size floor and for sources without arenas); ``backend="kernel"`` fetches
  each pass's rows on the host, uploads them to the source's device
  (``SourceOps.device``) and launches the ``topk_ed`` kernel once per pass
  (the pre-engine opt-in path);
* folding of the batched (m, k) best-so-far state across sources with
  :func:`merge_topk_state` — the array analogue of the per-query bsf heap.

Scalar queries are batch-of-1 plans: ``knn_exact``/``knn_approx`` on every
index build the same plan as their batched twins and convert the (1, k)
state row to the historical [(d2, id)] list.

``shard="mesh"`` executes the exact tier on a device mesh
(:mod:`repro_torch.core.distributed`): the query batch is sharded over one
mesh axis and the planned sources (runs) over the other, each rank screens
its tile with one ``topk_ed`` launch, the per-shard slates fold with one
``all_gather``, and the host re-ranks the survivors in f64 and certifies
them, so mesh answers match the single-device engine.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import spans
from ..kernels import ops as kernel_ops
from . import host_screen, verify_engine
from .io_model import coalesce_ranges
from .lower_bounds import mindist_paa_sax2
from .plan import (
    BlockRanges,
    BlockSource,
    DenseSource,
    GroupSource,
    QueryPlan,
    QueryStats,
    RangeSource,
    block_positions,
    window_mask,
)
from .summarization import paa

BACKENDS = ("device", "numpy", "kernel")

# rounds of the exact traversal since the last reset (the seed pass
# included), those of them larger than ``blocks_per_round``, and those
# whose arena rows were slices of a sorted run's (no positions built)
ROUNDS = {"rounds": 0, "grown": 0, "ranged": 0}


def reset_rounds() -> None:
    for name in ROUNDS:
        ROUNDS[name] = 0


# ---------------------------------------------------------------------------
# batched top-k state: the array analogue of the per-query bsf heap
# ---------------------------------------------------------------------------
def empty_topk_state(m: int, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Fresh batched best-so-far: ((m, k) inf distances, (m, k) -1 ids)."""
    return np.full((m, k), np.inf, np.float32), np.full((m, k), -1, np.int64)


def merge_topk_state(
    vals: np.ndarray, ids: np.ndarray, new_vals: np.ndarray, new_ids: np.ndarray
) -> tuple[np.ndarray, np.ndarray]:
    """Row-wise merge of a (m, k) running top-k with (m, j) new candidates.

    Stable sort keeps existing entries ahead on distance ties. Callers must
    not feed an id twice (each index entry is verified at most once per
    batch, so this holds by construction)."""
    cv = np.concatenate([vals, new_vals.astype(vals.dtype)], axis=1)
    ci = np.concatenate([ids, new_ids.astype(ids.dtype)], axis=1)
    order = np.argsort(cv, axis=1, kind="stable")[:, : vals.shape[1]]
    return np.take_along_axis(cv, order, axis=1), np.take_along_axis(ci, order, axis=1)


def state_to_list(vals: np.ndarray, ids: np.ndarray) -> list[tuple[float, int]]:
    """One (k,) state row -> the scalar API's [(d2, id)] ascending list."""
    return [(float(v), int(g)) for v, g in zip(vals, ids) if g >= 0]


def heap_to_sorted(bsf: list) -> list[tuple[float, int]]:
    """Convert a (-d2, id) max-heap into [(d2, id)] ascending by distance."""
    return sorted(((-nd, i) for nd, i in bsf))


def recall_at_k(approx_ids: np.ndarray, exact_ids: np.ndarray) -> float:
    """Micro-averaged recall of a batched approximate answer against the
    exact oracle: |approx ∩ exact| / |exact| over all queries, ignoring
    (-1) pad slots. Both args are (m, k) id arrays."""
    hits = sum(
        len(set(map(int, a[a >= 0])) & set(map(int, e[e >= 0])))
        for a, e in zip(approx_ids, exact_ids)
    )
    return hits / max(1, sum(int((e >= 0).sum()) for e in exact_ids))


# ---------------------------------------------------------------------------
# candidate verification: one screen + exact re-rank, three backends
# ---------------------------------------------------------------------------
def _kernel_topk_dists(
    Q: np.ndarray, data: np.ndarray, k: int, device
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k distances of Q (m, n) against data (E, n) via one ``topk_ed``
    launch on ``device`` (the pass's rows uploaded from the host), slack
    slate + exact f64 re-rank."""
    if device is None:
        raise ValueError('backend="kernel" needs the source\'s device '
                         "(SourceOps.device)")
    data = np.ascontiguousarray(data, np.float32)
    ksel = min(k + host_screen.SLACK, data.shape[0])
    q = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(device)
    # rows of a file-backed run arrive as a read-only memmap slice: copy
    # them out, so that no tensor aliases the mapping
    x = torch.from_numpy(data if data.flags.writeable else data.copy()).to(device)
    _, rows = kernel_ops.topk_ed_bucketed(q, x, ksel)
    return host_screen.rerank_slate(Q, data, rows, k)


# ---------------------------------------------------------------------------
# the device verification path (the default backend)
# ---------------------------------------------------------------------------
def _device_ready(ops, n_candidates: int, backend: str, m: int) -> bool:
    """Route this pass to the device engine? Requires the source to expose
    an arena and the pass to clear the candidate/batch size floors — below
    them the launch overhead rivals the whole host screen, so the host
    tail runs instead (answers are identical either way)."""
    if backend != "device" or ops.device_view is None:
        return False
    return (n_candidates >= verify_engine.MIN_DEVICE_CANDIDATES
            and m >= verify_engine.MIN_DEVICE_BATCH)


def _device_screen(
    Q: np.ndarray, ops, trows: np.ndarray, k: int, *, exact: bool
) -> tuple[np.ndarray, np.ndarray]:
    """One fused device pass over the arena rows ``trows``: arena gather +
    f32-compute screen + in-kernel slate selection, host f64 re-rank of
    the slate, error-bound certification with host fallback. The arena
    may STORE quantized rows (the view's ``dtype``: bf16/int8 with per-row
    scales) — the screen upcasts in-register and the certificate is
    widened by the quantization term, so answers are exact for every
    storage dtype. Returns ((m, kk) exact d2, (m, kk) table rows, -1
    padded)."""
    view = ops.device_view()
    engine = verify_engine.get_engine(view.device)
    return engine.screen_topk(view, trows, Q, k, exact=exact)


def _table_rows(ops, pos: np.ndarray) -> np.ndarray:
    """Entry positions -> rows of the source's arena."""
    return ops.table_rows[pos] if ops.table_rows is not None else pos


def _table_gids(ops, nrows: np.ndarray) -> np.ndarray:
    """Arena rows -> GLOBAL ids, -1 kept."""
    if ops.table_ids is None:
        return nrows
    return np.where(nrows >= 0, ops.table_ids(np.maximum(nrows, 0)), -1)


def _device_topk(
    Q: np.ndarray, ops, trows: np.ndarray, k: int, *, exact: bool
) -> tuple[np.ndarray, np.ndarray]:
    """:func:`_device_screen` over the arena rows ``trows``. Returns ((m,
    kk) exact d2, (m, kk) GLOBAL ids, -1 padded)."""
    nv, nrows = _device_screen(Q, ops, trows, k, exact=exact)
    return nv, _table_gids(ops, nrows)


# ---------------------------------------------------------------------------
# the executor
# ---------------------------------------------------------------------------
def execute(
    plan: QueryPlan,
    Q: np.ndarray,
    k: int = 1,
    *,
    state: Optional[tuple[np.ndarray, np.ndarray]] = None,
    stats: Optional[QueryStats] = None,
    backend: str = "device",
    blocks_per_round: int = 32,
    shard: Optional[str] = None,
    mesh=None,
) -> tuple[tuple[np.ndarray, np.ndarray], QueryStats]:
    """Run a :class:`QueryPlan` for a query batch, folding one (m, k) state.

    Sources execute in plan order (newest first), so distances verified
    against recent data prune blocks of older, larger sources for the
    whole batch — exactly how the per-query bsf heap threaded through the
    runs before the refactor. ``state``/``stats`` thread across calls the
    same way (an index with several plans per query folds one state).

    Stats semantics under batching: ``blocks_visited``/``blocks_pruned``
    count per-(query, block) logical work (comparable to summed scalar
    stats); ``entries_verified`` counts physical fetches (shared per
    batch); ``entries_pruned`` counts window filtering + the entry-level
    MINDIST screen.

    ``shard="mesh"``: execute the exact tier as a dense device-mesh scan
    (``_execute_mesh``) — same answers as the single-device engine.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown batch verify backend {backend!r}")
    if shard not in (None, "none", "mesh"):
        raise ValueError(f"unknown shard mode {shard!r}")
    Q = np.asarray(Q, np.float32)
    m = Q.shape[0]
    stats = stats if stats is not None else QueryStats()
    if state is not None:  # copy: group merges below write rows in place
        vals, ids = state[0].copy(), state[1].copy()
    else:
        vals, ids = empty_topk_state(m, k)
    stats.blocks_pruned += plan.pruned_blocks * m  # run-level temporal skips
    if m == 0:
        return (vals, ids), stats
    if shard == "mesh":
        return _execute_mesh(plan, Q, k, vals, ids, stats, mesh)
    for src in plan.sources:
        if isinstance(src, DenseSource):
            vals, ids = _exec_dense(src, plan, Q, k, vals, ids)
        elif isinstance(src, BlockSource):
            vals, ids = _exec_blocks(
                src, plan, Q, k, vals, ids, stats, backend, blocks_per_round
            )
        elif isinstance(src, RangeSource):
            vals, ids = _exec_range(src, plan, Q, k, vals, ids, stats, backend)
        elif isinstance(src, GroupSource):
            vals, ids = _exec_group(src, plan, Q, k, vals, ids, stats, backend)
        else:  # pragma: no cover - plan builder bug
            raise TypeError(f"unknown plan source {type(src).__name__}")
    return (vals, ids), stats


def _exec_dense(src: DenseSource, plan, Q, k, vals, ids):
    """Brute-force a small set (buffers / pending inserts): window filter,
    fetch, one exact screen. Dense sources serve the EXACT tier (the write
    buffer is part of every index's ground truth), so they use the
    error-bound screen — the slack form can mis-rank under f32
    cancellation (large common offsets). By long-standing convention these
    in-memory scans contribute neither stats nor modeled I/O beyond their
    fetch."""
    if src.n == 0:
        return vals, ids
    pos = np.arange(src.n)
    win = window_mask(src.ops.ts, plan.window, pos)
    if win is not None:
        pos = pos[win]
    if pos.size == 0:
        return vals, ids
    data = src.ops.fetch(pos)
    nv, ni = host_screen.screen_topk_exact(Q, data, k)
    return merge_topk_state(vals, ids, nv, src.ops.ids[pos][ni])


def _exec_blocks(src: BlockSource, plan, Q, k, vals, ids, stats, backend,
                 blocks_per_round):
    """Adaptive best-first exact traversal over lower-bounded blocks.

    1. a seed pass over each active query's best-bounded block tightens
       every radius cheaply;
    2. bounded rounds cover the union of blocks any query still needs —
       each round is ONE shared verification of the whole batch against the
       round's entries, with an entry-level MINDIST screen against the
       current per-query radii (the batched form of the scalar path's
       per-entry pruning). Rounds of large batches grow past
       ``blocks_per_round`` while none prunes (see ``may_grow``).

    Like the dense ED scan kernel, this trades per-entry early abandoning
    for large regular passes whose extra (query, entry) pairs only ever
    tighten other queries' radii. ``src.refine`` (ADS+ adaptive splits) is
    consulted before a block is verified; replaced blocks re-enter the
    traversal as their children and are never verified themselves.
    """
    ops = src.ops
    m = Q.shape[0]
    lb = np.asarray(src.lb, np.float32).reshape(m, -1)
    ranged = isinstance(src.blocks, BlockRanges)
    blocks = src.blocks if ranged else list(src.blocks)  # refine appends
    done = np.zeros(lb.shape[1], bool)
    replaced = np.zeros(lb.shape[1], bool)
    # The entry-level MINDIST screen only pays off when per-query radii are
    # tight — small batches (the scalar wrappers above all). At large batch
    # sizes the union radius is loose, so the screen prunes little while
    # its (m, u, w) bound evaluation rivals the sgemm it tries to avoid;
    # there the shared dense pass alone is the right trade (the ED-scan
    # kernel argument). Small batches also step one block per round so the
    # radius re-checks before every block, exactly like the pre-plan
    # scalar loop.
    small = m <= 8
    qp = None
    if ops.sax is not None and small:
        qp = np.asarray(paa(Q, ops.scfg))  # (m, w) for the entry screen
    # Small batches start at ONE block per round — the radius re-checks
    # before every block, exactly like the pre-plan scalar loop — then the
    # round size doubles: once the seed + first rounds have tightened the
    # radii, remaining blocks mostly prune, and grouping what survives
    # amortizes per-round overhead (and device launches) instead of paying
    # it per block. Verifying a few extra blocks per round can only confirm
    # the exact answer, so answers are invariant to the round structure.
    round_cap = 1 if small else blocks_per_round
    # Past blocks_per_round a round keeps doubling while the rounds before
    # it pruned nothing (data on which no bound bites would otherwise pay a
    # device pass's host work every blocks_per_round blocks), and falls back
    # to blocks_per_round once one prunes. Only where the round size changes
    # nothing but that work: a batch without the entry screen (whose (m, u,
    # w) bound would grow with the round), a source without ADS+'s splits
    # (which follow the round structure and its modeled I/O), and after a
    # round verified on the device (a host round fetches its rows).
    may_grow = not small and src.refine is None
    # A sorted run's round that no entry filter thins (window_mask keeps
    # all: no window or no timestamps; no entry screen) and that goes to
    # the device needs no positions: its arena rows are slices of the
    # run's ``table_rows`` (its positions on a materialized run), in the
    # same best-first order as the positions would give them.
    sliced = ranged and qp is None and (plan.window is None or ops.ts is None)

    def try_refine(sel: np.ndarray) -> bool:
        nonlocal lb, done, replaced
        if src.refine is None:
            return False
        changed = False
        for b in sel:
            rep = src.refine(int(b))
            if rep is None:
                continue
            changed = True
            done[b] = True
            replaced[b] = True
            lb[:, b] = np.inf
            for col, pos in rep:
                lb = np.concatenate(
                    [lb, np.asarray(col, np.float32).reshape(m, 1)], axis=1
                )
                blocks.append(np.asarray(pos, np.int64))
                done = np.append(done, False)
                replaced = np.append(replaced, False)
        return changed

    def gather(sel: np.ndarray):
        """The host half of a round: the positions of the blocks ``sel``
        past the window and the entry-level screen, their modeled I/O on
        the device route, and (for that route) their arena rows. Returns
        (positions or None, arena rows or None), or None when nothing is
        left; the positions are None on the sliced route."""
        done[sel] = True
        if sliced:
            n_rows = blocks.count(sel)
            if _device_ready(ops, n_rows, backend, m):
                if ops.index_read is not None:
                    ops.index_read(n_rows)
                stats.entries_verified += n_rows
                trows = blocks.take(sel, ops.table_rows)
                ops.fetch_account(trows)
                ROUNDS["ranged"] += 1
                return None, trows
        pos = block_positions(blocks, sel)
        if ops.index_read is not None:
            ops.index_read(pos.size if ranged else pos)
        win = window_mask(ops.ts, plan.window, pos)
        if win is not None:
            stats.entries_pruned += int((~win).sum())
            pos = pos[win]
        if pos.size and qp is not None:
            # entry-level MINDIST screen vs every query's current radius:
            # an entry is fetched only if it could still improve someone
            elb = mindist_paa_sax2(
                qp[:, None, :], ops.sax[pos].astype(np.int64), ops.scfg
            )  # (m, u)
            keep = (elb < vals[:, -1][:, None]).any(axis=0)
            stats.entries_pruned += int((~keep).sum())
            pos = pos[keep]
        if pos.size == 0:
            return None
        stats.entries_verified += int(pos.size)
        if not _device_ready(ops, pos.size, backend, m):
            return pos, None
        trows = _table_rows(ops, pos)
        ops.fetch_account(trows)
        return pos, trows

    def verify(pos, trows) -> None:
        nonlocal vals, ids
        if trows is not None:
            # ONE fused arena pass (gather + screen + in-kernel select);
            # only the certified slate comes back for the f64 re-rank
            nv, nrows = _device_screen(Q, ops, trows, k, exact=True)
            with spans.span("execute.merge"):
                vals, ids = merge_topk_state(vals, ids, nv,
                                             _table_gids(ops, nrows))
            return
        data = ops.fetch(pos)
        if backend == "kernel":
            # ONE all-pairs topk_ed launch per (source, batch, pass)
            nv, ni = _kernel_topk_dists(Q, data, k, ops.device)
        else:
            nv, ni = host_screen.screen_topk_exact(Q, data, k)
        with spans.span("execute.merge"):
            gids = np.where(ni >= 0, ops.ids[pos][np.maximum(ni, 0)], -1)
            vals, ids = merge_topk_state(vals, ids, nv, gids)

    # seed pass: every active query's single best-bounded block — tightens
    # all radii with one small shared verification
    while True:
        with spans.span("execute.round"):
            worst = vals[:, -1]
            best = np.argmin(lb, axis=1)
            active = lb[np.arange(m), best] < worst
            seed = np.unique(best[active])
            seed = seed[~done[seed]]
            if seed.size == 0:
                break
            if try_refine(seed):
                continue
            picked = gather(seed)
            ROUNDS["rounds"] += 1
        if picked is not None:
            verify(*picked)
        break

    # bounded rounds: the union of blocks any query still needs, best
    # bounds first so earlier rounds tighten later ones. Blocks no query
    # needs are pruned for the whole batch.
    left = None  # blocks still needed after a round that may grow the next
    while True:
        with spans.span("execute.round"):
            worst = vals[:, -1]
            need = (lb < worst[:, None]) & ~done[None, :]
            todo = np.nonzero(need.any(axis=0))[0]
            if left is not None:
                # the round pruned nothing iff only its own blocks went
                round_cap = 2 * round_cap if todo.size == left else blocks_per_round
                left = None
            if todo.size == 0:
                break
            todo = todo[np.argsort(lb[:, todo].min(axis=0), kind="stable")]
            chunk = todo[:round_cap]
            if try_refine(chunk):
                continue
            picked = gather(chunk)
            ROUNDS["rounds"] += 1
            ROUNDS["grown"] += int(chunk.size > blocks_per_round)
            if may_grow and picked is not None and picked[1] is not None:
                left = todo.size - chunk.size
            else:
                round_cap = min(round_cap * 2, blocks_per_round)  # adaptive growth
        if picked is not None:
            verify(*picked)

    # per-query logical accounting, comparable to summed scalar stats
    worst = vals[:, -1]
    live = ~replaced
    visited_q = (done[None, :] & live[None, :] & (lb < worst[:, None])).sum(axis=1)
    stats.blocks_visited += int(visited_q.sum())
    stats.blocks_pruned += int((int(live.sum()) - visited_q).sum())
    return vals, ids


def _exec_range(src: RangeSource, plan, Q, k, vals, ids, stats, backend):
    """The approximate tier on a sorted run: coalesce the per-query entry
    spans into deduplicated sequential reads, then one shared top-k pass
    per DISTINCT span — queries that seek into the same neighborhood share
    a pass, and disjoint spans never multiply each other's distance work."""
    ops = src.ops
    lo, hi = src.spans[:, 0], src.spans[:, 1]
    stats.blocks_visited += src.logical_blocks
    # coalesce the per-query [lo, hi) entry ranges: overlapping queries
    # collapse into few long sequential index reads
    ranges = coalesce_ranges(zip(lo.tolist(), hi.tolist()))
    if ops.prefetch_ranges is not None:
        # kick the mmap page faults off now; the verify pass below reads
        # the same rows once the window filter has had its say
        ops.prefetch_ranges(ranges)
    if src.read_index_ranges is not None:
        src.read_index_ranges(ranges)
    if not ranges:
        return vals, ids
    upos = np.concatenate([np.arange(r0, r1) for r0, r1 in ranges])
    win = window_mask(ops.ts, plan.window, upos)
    if win is not None:
        stats.entries_pruned += int((~win).sum())
        upos = upos[win]
    if upos.size == 0:
        return vals, ids
    stats.entries_verified += int(upos.size)
    spans_u, inv = np.unique(np.stack([lo, hi], axis=1), axis=0, return_inverse=True)
    n_groups = spans_u.shape[0]
    qidx_g = [np.nonzero(inv == g)[0] for g in range(n_groups)]
    # each group's slice of the (sorted, window-filtered) union positions
    j01 = np.stack([np.searchsorted(upos, spans_u[:, 0]),
                    np.searchsorted(upos, spans_u[:, 1])], axis=1)
    contiguous = (ops.series is not None
                  and upos.size == sum(r1 - r0 for r0, r1 in ranges))
    # Route PER GROUP: a group takes the no-fetch device route only when it
    # clears the engine's floors ITSELF. Routing the whole pass on "any
    # group is device-ready" used to strand every small group on a
    # per-group gather from the arena's host mirror — dozens of fancy
    # gathers plus tiny device launches instead of one shared fetch (the
    # b64/nb2 throughput collapse in BENCH_streaming).
    dev = np.zeros(n_groups, bool)
    if backend == "device" and ops.device_view is not None:
        for g in range(n_groups):
            dev[g] = _device_ready(ops, int(j01[g, 1] - j01[g, 0]), backend,
                                   qidx_g[g].size)
    data_h = gid_h = xsq_h = None
    hmap = None  # upos index -> row in the shared host fetch
    if contiguous:
        # contiguous materialized ranges: slice views per group below — no
        # 10s-of-MB union gather; only the I/O accounting happens here
        if src.read_payload_ranges is not None:
            src.read_payload_ranges(ranges)
    else:
        # ONE shared fetch of exactly the rows the host-tail groups need
        # (overlapping groups share rows); device groups account the
        # modeled I/O of their remaining rows without materializing them
        hsel = np.zeros(upos.size, bool)
        for g in np.nonzero(~dev)[0]:
            hsel[j01[g, 0]:j01[g, 1]] = True
        if hsel.any():
            hmap = np.full(upos.size, -1, np.int64)
            hmap[hsel] = np.arange(int(hsel.sum()))
            hpos = upos[hsel]
            data_h = ops.fetch(hpos)
            gid_h = ops.ids[hpos]
            if backend != "kernel" and ops.norms2 is not None:
                xsq_h = ops.norms2(hpos)  # cached |x|^2: fetched once
        if dev.any():
            dsel = np.zeros(upos.size, bool)
            for g in np.nonzero(dev)[0]:
                dsel[j01[g, 0]:j01[g, 1]] = True
            dacct = dsel & ~hsel  # rows the host fetch already accounted
            if dacct.any():
                ops.fetch_account(_table_rows(ops, upos[dacct]))
    for g in range(n_groups):
        qidx = qidx_g[g]
        j0, j1 = int(j01[g, 0]), int(j01[g, 1])
        if j0 == j1:
            continue
        if dev[g]:
            # fused arena pass for this distinct span's query group; the
            # approx tier keeps its slack-screen fallback semantics
            nv, gi = _device_topk(Q[qidx], ops, _table_rows(ops, upos[j0:j1]),
                                  k, exact=False)
            mv, mi = merge_topk_state(vals[qidx], ids[qidx], nv, gi)
            vals[qidx], ids[qidx] = mv, mi
            continue
        if contiguous:
            glo, ghi = int(spans_u[g, 0]), int(spans_u[g, 1])
            sub = ops.series[glo:ghi]  # contiguous materialized: a view
            gid = ops.ids[glo:ghi]
        else:
            rows = hmap[j0:j1]
            sub = data_h[rows]
            gid = gid_h[rows]
        if backend == "kernel":
            nv, ni = _kernel_topk_dists(Q[qidx], sub, k, ops.device)
            gi = np.where(ni >= 0, gid[np.maximum(ni, 0)], -1)
        else:
            if contiguous:
                xsq_g = (ops.norms2(np.arange(glo, ghi))
                         if ops.norms2 is not None else None)
            else:
                xsq_g = None if xsq_h is None else xsq_h[rows]
            nv, ni = host_screen.screen_topk_slack(Q[qidx], sub, k, xsq=xsq_g)
            gi = gid[ni]
        mv, mi = merge_topk_state(vals[qidx], ids[qidx], nv, gi)
        vals[qidx], ids[qidx] = mv, mi
    return vals, ids


def _exec_group(src: GroupSource, plan, Q, k, vals, ids, stats, backend):
    """The approximate tier on a leaf-partitioned tree: verify each
    DISTINCT leaf once against its whole query group."""
    ops = src.ops
    if src.pre_read is not None:
        src.pre_read()
    for gnum, (qidx, pos) in enumerate(src.groups):
        qidx = np.asarray(qidx)
        stats.blocks_visited += int(qidx.size)  # per-query logical accounting
        if src.group_reads is not None:
            src.group_reads[gnum]()  # one shared leaf read
        win = window_mask(ops.ts, plan.window, pos)
        if win is not None:
            stats.entries_pruned += int((~win).sum())
            pos = pos[win]
        if pos.size == 0:
            continue
        stats.entries_verified += int(pos.size)
        if _device_ready(ops, pos.size, backend, qidx.size):
            trows = _table_rows(ops, pos)
            ops.fetch_account(trows)
            nv, gi = _device_topk(Q[qidx], ops, trows, k, exact=False)
        else:  # small leaf groups take the host tail (same answers)
            data = ops.fetch(pos)
            if backend == "kernel":
                nv, ni = _kernel_topk_dists(Q[qidx], data, k, ops.device)
                gi = np.where(ni >= 0, ops.ids[pos][np.maximum(ni, 0)], -1)
            else:
                nv, ni = host_screen.screen_topk_slack(Q[qidx], data, k)
                gi = ops.ids[pos][ni]
        mv, mi = merge_topk_state(vals[qidx], ids[qidx], nv, gi)
        vals[qidx], ids[qidx] = mv, mi
    return vals, ids


# ---------------------------------------------------------------------------
# mesh-sharded execution (queries x runs 2-D parallelism)
# ---------------------------------------------------------------------------
def _execute_mesh(plan, Q, k, vals, ids, stats, mesh):
    """Exact batched kNN as a dense device-mesh scan over the plan.

    Every planned source's in-window entries are gathered (fetch closures
    account the modeled I/O of the scan) and screened on the mesh — the
    query batch sharded over the first mesh axis, the source entries over
    the second — then the per-shard slates fold with one ``all_gather``
    and the host re-ranks the survivors in f64, so results match the
    single-device executor. The mesh is ``mesh``, else the default mesh of
    the sources' device. The approximate tier stays host-side where the
    seek/coalesce I/O model is meaningful. Every rank takes the same early
    returns, as every rank holds the same plan.
    """
    from .distributed import mesh_topk_candidates

    m = Q.shape[0]
    chunks_data, chunks_ids = [], []
    device = None
    for src in plan.sources:
        if isinstance(src, DenseSource):
            pos = np.arange(src.n)
        elif isinstance(src, BlockSource):
            pos = block_positions(src.blocks, np.arange(len(src.blocks)))
            stats.blocks_visited += len(src.blocks) * m
        else:
            raise ValueError(
                "shard='mesh' executes the exact tier only (block/dense sources)"
            )
        if device is None:
            device = src.ops.device
        win = window_mask(src.ops.ts, plan.window, pos)
        if win is not None:
            stats.entries_pruned += int((~win).sum())
            pos = pos[win]
        if pos.size == 0:
            continue
        chunks_data.append(src.ops.fetch(pos))
        chunks_ids.append(src.ops.ids[pos])
        stats.entries_verified += int(pos.size)
    if not chunks_data:
        return (vals, ids), stats
    X = np.concatenate(chunks_data)
    gids_all = np.concatenate(chunks_ids)
    c = X.shape[0]
    ksel = min(k + host_screen.SLACK, c)
    # Center the table before the f32 device screen: squared ED is
    # translation-invariant, and removing the common offset kills the
    # |x|^2 - 2<q, x> cancellation that would otherwise scramble the f32
    # ranking for large-magnitude series.
    mu = X.mean(axis=0)
    d2s, rows = mesh_topk_candidates(Q - mu, X - mu, ksel, mesh=mesh,
                                     device=device if device is not None else "cuda")
    nv, nrows = host_screen.rerank_slate(Q, X, rows, k)
    # Certify the screen as the single-device engine does; queries that
    # fail fall back to the provably exact host screen over the gathered
    # table, so mesh answers match the engine on every input.
    if ksel < c:
        qn = np.sqrt(np.einsum("mn,mn->m", Q - mu, Q - mu, dtype=np.float64))
        xn_max = float(np.sqrt(np.einsum("cn,cn->c", X - mu, X - mu,
                                         dtype=np.float64).max()))
        bad = host_screen.uncertified(nv, rows, d2s[:, -1], qn, xn_max,
                                      X.shape[1])
        if bad.size:
            host_screen.rescreen(nv, nrows, bad, Q, X, k)
    gi = np.where(nrows >= 0, gids_all[np.maximum(nrows, 0)], -1)
    vals, ids = merge_topk_state(vals, ids, nv, gi)
    return (vals, ids), stats
