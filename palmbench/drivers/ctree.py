"""A static Coconut-Tree over the seed's collection, asked by one
closed-loop client: each request is one batch of exact queries
(``CTree.knn_batch``), sent when the previous one is answered.

Sizes from the configuration: ``n_series``, ``series_len``, ``n_segments``,
``card_bits``, ``block_size``, ``screen_dtype``, ``k``, ``gen_chunk_rows``.
From the mix: ``batch``, ``backend``, ``warmup_requests``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from palmbench import judge as jd
from palmbench import reference as ref

QUERY_CHUNK = 4096  # rows a query stream draws at a time
REF_ROWS = 1 << 18  # rows of the collection the reference takes at a time


@dataclasses.dataclass
class State:
    tree: object
    raw: object
    queries: object
    next_query: int = 0


def _ask(ctx, st, Q):
    s = ctx.sizes
    return ctx.call("knn_batch", len(Q), lambda: st.tree.knn_batch(
        Q, s["k"], raw=st.raw, backend=s["backend"]))


def setup(ctx) -> State:
    from repro_torch.core import CTree, CTreeConfig, RawStore, SummarizationConfig

    s = ctx.sizes
    n, length = s["n_series"], s["series_len"]
    X = np.empty((n, length), np.float32)
    ctx.stream("base", s["gen_chunk_rows"]).fill(X, 0)
    ctx.mark("data")
    scfg = SummarizationConfig(series_len=length, n_segments=s["n_segments"],
                               card_bits=s["card_bits"])
    raw = RawStore(length, screen_dtype=s["screen_dtype"], device=ctx.device)
    ids = raw.append(X)
    tree = CTree(CTreeConfig(summarization=scfg, block_size=s["block_size"],
                             materialized=False, screen_dtype=s["screen_dtype"],
                             device=ctx.device))
    tree.bulk_build(X, ids)
    del X
    ctx.mark("index")
    st = State(tree, raw, ctx.stream("query", QUERY_CHUNK))
    warm = ctx.stream("warmup", QUERY_CHUNK)
    m = s["batch"]
    for i in range(s["warmup_requests"]):
        _ask(ctx, st, warm.rows(i * m, (i + 1) * m))
    st.queries.chunk(0)
    ctx.mark("warm-up")
    return st


def step(ctx, st: State) -> None:
    m = ctx.sizes["batch"]
    Q = st.queries.rows(st.next_query, st.next_query + m)
    st.next_query += m
    d2, ids, stats = _ask(ctx, st, Q)
    ctx.count(queries=m, entries_verified=stats.entries_verified)
    ctx.answer((Q, d2, ids))


def release(ctx, st: State) -> None:
    st.tree = st.raw = None


def judge(ctx, answers, control=False) -> dict:
    """Every answer of the window against the reference over the same
    collection, made again from the seed."""
    s = ctx.sizes
    n, k = s["n_series"], s["k"]
    Q = np.concatenate([a[0] for a in answers])
    base = ctx.stream("base", s["gen_chunk_rows"])
    X = base.device_rows(0, n)
    blocks = [(a, X[a:a + REF_ROWS]) for a in range(0, n, REF_ROWS)]
    ref_d, ref_i = ref.exact_topk(Q, blocks, k)
    if control:
        got_d, got_i = ref.exact_topk(Q, blocks, k, precision="tf32")
    else:
        got_d = np.concatenate([a[1] for a in answers])
        got_i = np.concatenate([a[2] for a in answers])
    true = ref.true_d2(Q, got_i, X)
    m = len(Q)
    return jd.readings(got_d, got_i, ref_d, ref_i, true,
                          np.zeros(m, np.int64), np.full(m, n, np.int64))

