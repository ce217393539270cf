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

``shard="mesh"`` (the exact tier over a device mesh) raises until the
mesh and distributed modules are ported (ROADMAP Queue 1 item 9).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .io_model import coalesce_ranges
from .lower_bounds import mindist_paa_sax2
from .plan import (
    BlockSource,
    DenseSource,
    GroupSource,
    QueryPlan,
    QueryStats,
    RangeSource,
    window_mask,
)
from .summarization import paa

BACKENDS = ("device", "numpy", "kernel")

_MESH_MISSING = ('shard="mesh" is not ported yet (ROADMAP Queue 1 item 9, '
                 "mesh and distributed)")


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
def _rerank_slate(
    Q: np.ndarray, X: np.ndarray, rows: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Exact f64 re-rank of per-query candidate slates.

    ``rows`` is (m, s) row indices into ``X`` (negative = invalid slot).
    Returns ((m, kk) d2 ascending f32, (m, kk) rows, -1 padded), kk =
    min(k, |X|) — the common tail of every screening backend, so returned
    distances are exact however the slate was selected."""
    invalid = rows < 0
    sel = np.where(invalid, 0, rows)
    diff = X[sel].astype(np.float64) - Q[:, None, :].astype(np.float64)
    d2 = np.einsum("mkn,mkn->mk", diff, diff)
    d2 = np.where(invalid, np.inf, d2.astype(np.float32))
    kk = min(k, X.shape[0])
    o = np.argsort(d2, axis=1, kind="stable")[:, :kk]
    return (
        np.take_along_axis(d2, o, axis=1),
        np.take_along_axis(np.where(invalid, -1, rows), o, axis=1),
    )


def _screen_topk_exact(
    Q: np.ndarray, data: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Provably exact top-k: one shared f32 sgemm screen, then f64 re-rank
    of everything inside the error-bound-widened kth radius.

    The screen's only error source is the f32 cross product, whose
    classical bound (2 n u |q||x|) widens the kth-best radius — selection
    stays provably sufficient however ill-conditioned the data. The f64
    re-rank of the selected tail is centered by the tail mean (squared ED
    is translation-invariant), so the matmul form stays accurate even
    under catastrophic cancellation (a common offset much larger than the
    spread); the centering is tail-sized, i.e. free."""
    m = Q.shape[0]
    u = data.shape[0]
    kk = min(k, u)
    x32 = np.ascontiguousarray(data, np.float32)
    g = x32 @ Q.T  # (U, m) f32 sgemm — the shared heavy pass
    xsq = np.einsum("un,un->u", x32, x32, dtype=np.float64)
    qsq = np.einsum("mn,mn->m", Q, Q, dtype=np.float64)
    d2a = qsq[:, None] + xsq[None, :] - 2.0 * g.T  # (m, U) f64-ish
    if kk < u:
        part = np.argpartition(d2a, kk - 1, axis=1)[:, :kk]
    else:
        part = np.broadcast_to(np.arange(kk), (m, kk)).copy()
    kth = np.take_along_axis(d2a, part, axis=1).max(axis=1)  # (m,)
    qn = np.sqrt(qsq)
    xn_max = float(np.sqrt(xsq.max()))
    bound = 4.0 * data.shape[1] * np.finfo(np.float32).eps * qn * xn_max
    cand = d2a <= (kth + 2.0 * bound)[:, None]  # (m, U)
    sel = np.nonzero(cand.any(axis=0))[0]  # (S,) small tail
    x64 = data[sel].astype(np.float64)
    mu = x64.mean(axis=0) if sel.size else 0.0  # tail-sized centering
    x64 -= mu
    q64 = Q.astype(np.float64) - mu
    d2e = (
        np.einsum("mn,mn->m", q64, q64)[:, None]
        + np.einsum("sn,sn->s", x64, x64)[None, :]
        # this matmul IS the exact f64 re-rank tail, not the f32 screen
        - 2.0 * (q64 @ x64.T)  # palmlint: ignore[precision-discipline]
    )  # (m, S) exact (centered, so the matmul form cannot cancel)
    d2e = np.maximum(d2e, 0.0).astype(np.float32)
    kks = min(kk, d2e.shape[1])
    if kks < d2e.shape[1]:
        p2 = np.argpartition(d2e, kks - 1, axis=1)[:, :kks]
    else:
        p2 = np.broadcast_to(np.arange(kks), (m, kks)).copy()
    nv = np.take_along_axis(d2e, p2, axis=1)
    o = np.argsort(nv, axis=1, kind="stable")
    return (
        np.take_along_axis(nv, o, axis=1),
        sel[np.take_along_axis(p2, o, axis=1)].astype(np.int64),
    )


def _screen_topk_slack(
    Q: np.ndarray,
    data: np.ndarray,
    k: int,
    xsq: Optional[np.ndarray] = None,
) -> tuple[np.ndarray, np.ndarray]:
    """Slack-8 top-k: rank by one f32 sgemm screen (|q|^2 is constant per
    row, so the screen orders by |x|^2 - 2<q, x> only), then exactly
    re-rank the k+8 slate in f64 — the host twin of the kernel path, with
    cached squared norms (``xsq``) so nothing union-sized is recomputed."""
    m = Q.shape[0]
    u = data.shape[0]
    if xsq is None:
        x32 = np.asarray(data, np.float32)
        xsq = np.einsum("un,un->u", x32, x32)
    d2a = Q @ data.T  # (m, U) f32 sgemm — the heavy pass
    np.multiply(d2a, -2.0, out=d2a)
    np.add(d2a, xsq[None, :], out=d2a)
    ksel = min(k + 8, u)  # slack absorbs f32 near-tie reordering
    if ksel < u:
        part = np.argpartition(d2a, ksel - 1, axis=1)[:, :ksel]
    else:
        part = np.broadcast_to(np.arange(u), (m, u)).copy()
    diff = data[part].astype(np.float64) - Q.astype(np.float64)[:, None, :]
    d2e = np.einsum("mkn,mkn->mk", diff, diff).astype(np.float32)
    kk = min(k, u)
    o = np.argsort(d2e, axis=1, kind="stable")[:, :kk]
    return (
        np.take_along_axis(d2e, o, axis=1),
        np.take_along_axis(part, o, axis=1).astype(np.int64),
    )


def _kernel_topk_dists(
    Q: np.ndarray, data: np.ndarray, k: int, device
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k distances of Q (m, n) against data (E, n) via one ``topk_ed``
    launch on ``device`` (the pass's rows uploaded from the host), slack-8
    slate + exact f64 re-rank."""
    import torch

    from ..kernels import ops as kernel_ops

    if device is None:
        raise ValueError('backend="kernel" needs the source\'s device '
                         "(SourceOps.device)")
    data = np.ascontiguousarray(data, np.float32)
    ksel = min(k + 8, data.shape[0])  # slack absorbs f32 near-tie reordering
    q = torch.from_numpy(np.ascontiguousarray(Q, np.float32)).to(device)
    # rows of a file-backed run arrive as a read-only memmap slice: copy
    # them out, so that no tensor aliases the mapping
    x = torch.from_numpy(data if data.flags.writeable else data.copy()).to(device)
    _, rows = kernel_ops.topk_ed_bucketed(q, x, ksel)
    return _rerank_slate(Q, data, rows, k)


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
    from .verify_engine import MIN_DEVICE_BATCH, MIN_DEVICE_CANDIDATES

    return n_candidates >= MIN_DEVICE_CANDIDATES and m >= MIN_DEVICE_BATCH


def _account_fetch(ops, pos: np.ndarray) -> None:
    """Modeled-I/O accounting for a device-verified pass: the engine reads
    the arena, not the store, but serving still pays the host engine's
    modeled I/O so stats and heat maps stay comparable."""
    if ops.fetch_account is not None:
        ops.fetch_account(pos)
    elif ops.fetch is not None:  # pragma: no cover - plumbing gap fallback
        ops.fetch(pos)


def _device_topk(
    Q: np.ndarray, ops, pos: np.ndarray, k: int, *, exact: bool
) -> tuple[np.ndarray, np.ndarray]:
    """One fused device pass over the entries at ``pos``: arena gather +
    f32-compute screen + in-kernel slate selection, host f64 re-rank of
    the slate, error-bound certification with host fallback. The arena
    may STORE quantized rows (``ops.screen_dtype``: bf16/int8 with per-row
    scales) — the screen upcasts in-register and the certificate is
    widened by the quantization term, so answers are exact for every
    storage dtype. Returns ((m, kk) exact d2, (m, kk) GLOBAL ids, -1
    padded)."""
    from .verify_engine import get_engine

    view = ops.device_view()
    trows = ops.table_rows(pos) if ops.table_rows is not None else pos
    nv, nrows = get_engine(view.device).screen_topk(view, trows, Q, k,
                                                    exact=exact)
    if ops.table_ids is not None:
        gids = np.where(nrows >= 0, ops.table_ids(np.maximum(nrows, 0)), -1)
    else:
        gids = nrows
    return nv, gids


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

    ``shard="mesh"`` raises ``NotImplementedError`` until the mesh and
    distributed modules are ported.
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown batch verify backend {backend!r}")
    if shard not in (None, "none", "mesh"):
        raise ValueError(f"unknown shard mode {shard!r}")
    if shard == "mesh":
        raise NotImplementedError(_MESH_MISSING)
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
    error-bound screen — the slack-8 form can mis-rank under f32
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
    nv, ni = _screen_topk_exact(Q, data, k)
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
       per-entry pruning).

    Like the dense ED scan kernel, this trades per-entry early abandoning
    for large regular passes whose extra (query, entry) pairs only ever
    tighten other queries' radii. ``src.refine`` (ADS+ adaptive splits) is
    consulted before a block is verified; replaced blocks re-enter the
    traversal as their children and are never verified themselves.
    """
    ops = src.ops
    m = Q.shape[0]
    lb = np.asarray(src.lb, np.float32).reshape(m, -1)
    blocks = list(src.blocks)
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
    qp = None
    if ops.sax is not None and m <= 8:
        qp = np.asarray(paa(Q, ops.scfg))  # (m, w) for the entry screen
    # Small batches start at ONE block per round — the radius re-checks
    # before every block, exactly like the pre-plan scalar loop — then the
    # round size doubles: once the seed + first rounds have tightened the
    # radii, remaining blocks mostly prune, and grouping what survives
    # amortizes per-round overhead (and device launches) instead of paying
    # it per block. Verifying a few extra blocks per round can only confirm
    # the exact answer, so answers are invariant to the round structure.
    round_cap = 1 if m <= 8 else blocks_per_round

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

    def verify(sel: np.ndarray) -> None:
        nonlocal vals, ids
        done[sel] = True
        pos = np.concatenate([blocks[b] for b in sel])
        if ops.index_read is not None:
            ops.index_read(pos)
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
            return
        stats.entries_verified += int(pos.size)
        if _device_ready(ops, pos.size, backend, Q.shape[0]):
            # ONE fused arena pass (gather + screen + in-kernel select);
            # only the certified slate comes back for the f64 re-rank
            _account_fetch(ops, pos)
            nv, gids = _device_topk(Q, ops, pos, k, exact=True)
        else:
            data = ops.fetch(pos)
            if backend == "kernel":
                # ONE all-pairs topk_ed launch per (source, batch, pass)
                nv, ni = _kernel_topk_dists(Q, data, k, ops.device)
            else:
                nv, ni = _screen_topk_exact(Q, data, k)
            gids = np.where(ni >= 0, ops.ids[pos][np.maximum(ni, 0)], -1)
        vals, ids = merge_topk_state(vals, ids, nv, gids)

    # seed pass: every active query's single best-bounded block — tightens
    # all radii with one small shared verification
    while True:
        worst = vals[:, -1]
        best = np.argmin(lb, axis=1)
        active = lb[np.arange(m), best] < worst
        seed = np.unique(best[active])
        seed = seed[~done[seed]]
        if seed.size == 0:
            break
        if try_refine(seed):
            continue
        verify(seed)
        break

    # bounded rounds: the union of blocks any query still needs, best
    # bounds first so earlier rounds tighten later ones. Blocks no query
    # needs are pruned for the whole batch.
    while True:
        worst = vals[:, -1]
        need = (lb < worst[:, None]) & ~done[None, :]
        todo = np.nonzero(need.any(axis=0))[0]
        if todo.size == 0:
            break
        todo = todo[np.argsort(lb[:, todo].min(axis=0), kind="stable")]
        chunk = todo[:round_cap]
        if try_refine(chunk):
            continue
        verify(chunk)
        round_cap = min(round_cap * 2, blocks_per_round)  # adaptive growth

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
                _account_fetch(ops, upos[dacct])
    for g in range(n_groups):
        qidx = qidx_g[g]
        j0, j1 = int(j01[g, 0]), int(j01[g, 1])
        if j0 == j1:
            continue
        if dev[g]:
            # fused arena pass for this distinct span's query group; the
            # approx tier keeps its slack-screen fallback semantics
            nv, gi = _device_topk(Q[qidx], ops, upos[j0:j1], k, exact=False)
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
            nv, ni = _screen_topk_slack(Q[qidx], sub, k, xsq=xsq_g)
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
            _account_fetch(ops, pos)
            nv, gi = _device_topk(Q[qidx], ops, pos, k, exact=False)
        else:  # small leaf groups take the host tail (same answers)
            data = ops.fetch(pos)
            if backend == "kernel":
                nv, ni = _kernel_topk_dists(Q[qidx], data, k, ops.device)
                gi = np.where(ni >= 0, ops.ids[pos][np.maximum(ni, 0)], -1)
            else:
                nv, ni = _screen_topk_slack(Q[qidx], data, k)
                gi = ops.ids[pos][ni]
        mv, mi = merge_topk_state(vals[qidx], ids[qidx], nv, gi)
        vals[qidx], ids[qidx] = mv, mi
    return vals, ids
