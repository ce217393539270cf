"""A live stream into a ``StreamingIndex``, in closed-loop steps: each step
ingests one batch (``StreamingIndex.ingest``, acknowledged when it returns)
and then asks one batch of exact window queries over the newest batches
(``StreamingIndex.window_knn_batch``). Set-up ingests ``prefill_batches``.

Series of batch b carry timestamp b; a step at batch b asks the window
[b - window_batches, b], as ``launch/serve.py --window`` does.

Sizes from the configuration: ``scheme``, ``buffer_entries``,
``growth_factor``, ``block_size``, ``screen_dtype``, ``series_len``,
``n_segments``, ``card_bits``, ``batch_size``, ``prefill_batches``,
``window_batches``, ``k``. From the mix: ``query_batch``,
``warmup_requests``, ``pool_batches``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from palmbench import judge as jd
from palmbench import reference as ref

QUERY_CHUNK = 4096  # rows a query stream draws at a time
STREAM_CHUNK_BATCHES = 8  # ingest batches a stream chunk holds


@dataclasses.dataclass
class State:
    index: object
    data: object
    queries: object
    batch: int  # the next batch to ingest
    next_query: int = 0


def _window_of(ctx, b: int) -> tuple[int, int]:
    return max(0, b - ctx.sizes["window_batches"]), b


def setup(ctx) -> State:
    from repro_torch.core import StreamConfig, StreamingIndex, SummarizationConfig

    s = ctx.sizes
    bsz = s["batch_size"]
    scfg = SummarizationConfig(series_len=s["series_len"],
                               n_segments=s["n_segments"],
                               card_bits=s["card_bits"])
    index = StreamingIndex(StreamConfig(
        scheme=s["scheme"], summarization=scfg,
        buffer_entries=s["buffer_entries"], growth_factor=s["growth_factor"],
        block_size=s["block_size"], materialized=False, ingest="sync",
        storage="model", screen_dtype=s["screen_dtype"], device=ctx.device))
    data = ctx.stream("stream", bsz * STREAM_CHUNK_BATCHES)
    for b in range(s["prefill_batches"]):
        index.ingest(data.rows(b * bsz, (b + 1) * bsz), np.full(bsz, b, np.int64))
        data.drop((b + 1) * bsz)
    ctx.mark("prefill")
    st = State(index, data, ctx.stream("query", QUERY_CHUNK), s["prefill_batches"])
    warm = ctx.stream("warmup", QUERY_CHUNK)
    m = s["query_batch"]
    t0, t1 = _window_of(ctx, st.batch - 1)
    for i in range(s["warmup_requests"]):
        st.index.window_knn_batch(warm.rows(i * m, (i + 1) * m), t0, t1, k=s["k"])
    # the window's batches, made ahead
    for b in range(st.batch, st.batch + s["pool_batches"], STREAM_CHUNK_BATCHES):
        data.chunk(b // STREAM_CHUNK_BATCHES)
    st.queries.chunk(0)
    ctx.mark("warm-up")
    return st


def step(ctx, st: State) -> None:
    s = ctx.sizes
    bsz, m, b = s["batch_size"], s["query_batch"], st.batch
    X = st.data.rows(b * bsz, (b + 1) * bsz)
    ts = np.full(bsz, b, np.int64)
    ctx.call("ingest", bsz, lambda: st.index.ingest(X, ts))
    st.batch += 1
    st.data.drop(st.batch * bsz)
    Q = st.queries.rows(st.next_query, st.next_query + m)
    st.next_query += m
    t0, t1 = _window_of(ctx, b)
    d2, ids, stats = ctx.call("window_knn_batch", m, lambda: st.index.window_knn_batch(
        Q, t0, t1, k=s["k"]))
    ctx.count(steps=1, queries=m, entries_verified=stats.entries_verified)
    ctx.answer((b, Q, d2, ids))


def release(ctx, st: State) -> None:
    st.index.close()
    st.index = None


def judge(ctx, answers, control=False) -> dict:
    """Every step's answers against the reference over that step's window:
    the rows of the batches acknowledged in it, made again from the seed."""
    s = ctx.sizes
    bsz, k = s["batch_size"], s["k"]
    last = max(a[0] for a in answers)
    X = ctx.stream("stream", bsz * STREAM_CHUNK_BATCHES).device_rows(0, (last + 1) * bsz)
    ref_d, ref_i, got_d, got_i, lo, hi = [], [], [], [], [], []
    for b, Q, d2, ids in answers:
        t0, t1 = _window_of(ctx, b)
        a, z = t0 * bsz, (t1 + 1) * bsz
        rd, ri = ref.exact_topk(Q, [(a, X[a:z])], k)
        ref_d.append(rd)
        ref_i.append(ri)
        if control:
            d2, ids = ref.exact_topk(Q, [(a, X[a:z])], k, precision="tf32")
        got_d.append(d2)
        got_i.append(ids)
        lo.append(np.full(len(Q), a, np.int64))
        hi.append(np.full(len(Q), z, np.int64))
    Q = np.concatenate([a[1] for a in answers])
    got_i = np.concatenate(got_i)
    true = ref.true_d2(Q, got_i, X)
    return jd.readings(np.concatenate(got_d), got_i, np.concatenate(ref_d),
                       np.concatenate(ref_i), true, np.concatenate(lo),
                       np.concatenate(hi))
