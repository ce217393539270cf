"""The live stream of ``stream.py`` with background compaction
(``StreamConfig(ingest="async")``, as ``launch/serve.py --ingest async``
builds it): ``ingest`` appends the batch to the write buffer, where the next
query sees it, and returns; flush, sort and merge run on the index's ingest
worker, and ``ingest`` waits only while the unflushed backlog is over
``max_lag_entries``. Steps are ``stream.step``'s; once each ``ingest``
returns, the backlog its queries will see is counted (``lag_entries``,
``StreamingIndex.ingest_lag``).

Set-up prefills through async ingest and then drains the worker, so the
window starts from a settled index that holds the sync cell's runs at the
same batch. ``release`` drains with ``flush_buffer=True`` and counts, over
the published runs, acknowledged ids they lack and ids they hold twice or
never acknowledged; then it closes the index. ``judge`` adds that count to
``stream.judge``'s ``bad_ids``.

On standard error: the pipeline's counters over the window and the batches
whose ``ingest`` waited on backpressure (a program without those counters
prints neither).

Sizes as in ``stream.py``; from the configuration also ``max_lag_entries``.
"""
from __future__ import annotations

import dataclasses
import sys

import numpy as np

from palmbench.drivers import stream

DRAIN_S = 600.0  # the longest wait for the worker to settle


@dataclasses.dataclass
class State(stream.State):
    real: object = None  # the StreamingIndex (``index`` is its counted view)
    counting: bool = False  # the pipeline's counters reset at the window's start
    waited: list = dataclasses.field(default_factory=list)  # batches that waited


class _Counted:
    """The index as ``stream.step`` calls it: once ``ingest`` returns, the
    backlog the step's queries will see is counted."""

    def __init__(self, ctx, index):
        self.ctx, self.index = ctx, index

    def ingest(self, series, ts):
        ids = self.index.ingest(series, ts)
        self.ctx.count(lag_entries=self.index.ingest_lag()["lag_entries"])
        return ids

    def window_knn_batch(self, *args, **kwargs):
        return self.index.window_knn_batch(*args, **kwargs)


def _drain(index, flush_buffer: bool) -> None:
    if not index.drain(flush_buffer=flush_buffer, timeout=DRAIN_S):
        raise SystemExit(f"palmbench: the ingest worker did not settle in {DRAIN_S} s")


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
        block_size=s["block_size"], materialized=False, ingest="async",
        max_lag_entries=s["max_lag_entries"], storage="model",
        screen_dtype=s["screen_dtype"], device=ctx.device))
    data = ctx.stream("stream", bsz * stream.STREAM_CHUNK_BATCHES)
    for b in range(s["prefill_batches"]):
        index.ingest(data.rows(b * bsz, (b + 1) * bsz), np.full(bsz, b, np.int64))
        data.drop((b + 1) * bsz)
    _drain(index, flush_buffer=False)
    ctx.mark("prefill")
    st = State(_Counted(ctx, index), data, ctx.stream("query", stream.QUERY_CHUNK),
               s["prefill_batches"], real=index)
    warm = ctx.stream("warmup", stream.QUERY_CHUNK)
    m = s["query_batch"]
    t0, t1 = stream._window_of(ctx, st.batch - 1)
    for i in range(s["warmup_requests"]):
        index.window_knn_batch(warm.rows(i * m, (i + 1) * m), t0, t1, k=s["k"])
    for b in range(st.batch, st.batch + s["pool_batches"], stream.STREAM_CHUNK_BATCHES):
        data.chunk(b // stream.STREAM_CHUNK_BATCHES)
    st.queries.chunk(0)
    ctx.mark("warm-up")
    return st


def step(ctx, st: State) -> None:
    counts = getattr(st.real.pipeline, "counts", None)
    if counts is None:  # a program whose pipeline counts nothing
        return stream.step(ctx, st)
    if ctx.recording and not st.counting:
        st.real.pipeline.reset_counts()
        st.counting = True
    waits = counts["waits"]
    stream.step(ctx, st)
    if ctx.recording and counts["waits"] > waits:
        st.waited.append(st.batch - 1)


def _unsound_ids(index, acked: int) -> int:
    """Ids ``0 .. acked - 1`` the published runs lack, plus ids they hold
    twice or that were never acknowledged."""
    held = [np.asarray(r.ids) for r in index.lsm.registry.current().runs_newest_first()]
    held = np.concatenate(held) if held else np.zeros(0, np.int64)
    ok = (held >= 0) & (held < acked)
    count = np.bincount(held[ok], minlength=acked)
    return int((count == 0).sum() + np.maximum(count - 1, 0).sum() + (~ok).sum())


def release(ctx, st: State) -> None:
    index = st.real
    acked = st.batch * ctx.sizes["batch_size"]
    if st.counting:  # before the drain's flushes
        print("window pipeline: " + ", ".join(
            f"{k} {v}" for k, v in index.pipeline.counts.items())
            + f"; backpressure waits at batches {st.waited}", file=sys.stderr)
    try:
        _drain(index, flush_buffer=True)
        bad = _unsound_ids(index, acked)
    finally:
        index.close()
    print(f"drained: {acked} ids acknowledged, {bad} missing, repeated or "
          "never acknowledged in the published runs", file=sys.stderr)
    ctx.unsound_ids = bad
    st.index = st.real = None


def judge(ctx, answers, control=False) -> dict:
    out = stream.judge(ctx, answers, control)
    out["bad_ids"] += ctx.unsound_ids
    return out
