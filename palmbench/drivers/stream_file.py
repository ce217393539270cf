"""The live stream of ``stream.py`` on the port's crash-consistent file
backend (``StreamConfig(storage="file")``, as ``launch/serve.py --storage
file`` builds it): every batch ``ingest`` acknowledges has its
write-ahead-log record fsync'd before the call returns, the raw rows and
the runs live in files read through memory maps, and each flush or merge
commits a manifest. Steps are ``stream.step``'s.

Set-up removes the store directories that finished processes left under
the checkout's ``storage_dir``, stops where its disk has less than
``free_bytes`` free, makes one directory for this run and prefills through
the file backend. Before the window it fsyncs every file and directory of
the store, so that no write-back of the set-up's files is left to fall
inside the window (the store's own files: no system-wide sync).

``release`` drops the index as a crash would leave it: no ``close()``, no
``drain()``. ``judge`` reopens the directory with
``StreamingIndex.recover`` (``recover_s``, host clock, on standard error),
then removes it, and to ``stream.judge``'s readings over the window's
answers adds:

* the last step's queries asked again of the recovered index over the
  same window, judged beside the window's answers under the same limits;
* ``lost_series``: acknowledged series the recovered index does not hold
  (an id in no run and no buffered chunk, or its raw row not the row that
  was ingested), plus ids it holds that were never acknowledged or that it
  holds twice, plus raw rows past the acknowledged ones.

Sizes as in ``stream.py``; from the configuration also ``storage``,
``ingest``, ``materialized``, ``storage_dir`` and ``free_bytes``.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

from palmbench.drivers import stream

ROOT = Path(__file__).resolve().parents[2]
CHECK_ROWS = 1 << 16  # raw rows compared with the seed's at a time


@dataclasses.dataclass
class State(stream.State):
    store: str = ""  # this run's store directory
    written: int = 0  # bytes the backend counted written over the window
    steps: int = 0  # window steps


def _config(ctx, store: str):
    from repro_torch.core import StreamConfig, SummarizationConfig

    s = ctx.sizes
    return StreamConfig(
        scheme=s["scheme"],
        summarization=SummarizationConfig(series_len=s["series_len"],
                                          n_segments=s["n_segments"],
                                          card_bits=s["card_bits"]),
        buffer_entries=s["buffer_entries"], growth_factor=s["growth_factor"],
        block_size=s["block_size"], materialized=s["materialized"],
        ingest=s["ingest"], storage=s["storage"], storage_dir=store,
        screen_dtype=s["screen_dtype"], device=ctx.device)


def _alive(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:
        return True
    return True


def _clear_finished(root: Path) -> None:
    """Remove the store directories (``<pid>-...``) of processes that have
    ended; a live process's run keeps its own."""
    if not root.is_dir():
        return
    for d in root.iterdir():
        pid = d.name.split("-", 1)[0]
        if not (pid.isdigit() and _alive(int(pid))):
            shutil.rmtree(d, ignore_errors=True)


def _disk(path: str) -> str:
    """The mount that holds ``path`` (the last, longest match in
    /proc/mounts) and the space statvfs gives, as ``df`` would."""
    real, mount = os.path.realpath(path), ("?", "", "?", "?")
    try:
        with open("/proc/mounts") as f:
            for line in f:
                dev, point, fstype, opts = line.split()[:4]
                if ((real == point or real.startswith(point.rstrip("/") + "/"))
                        and len(point) >= len(mount[1])):
                    mount = (dev, point, fstype, opts)
    except OSError:
        pass
    u = shutil.disk_usage(path)
    return (f"store {path}: {mount[0]} on {mount[1]} type {mount[2]} ({mount[3]}), "
            f"{u.free} of {u.total} bytes free")


def _sync_tree(root: str) -> None:
    """fsync every file and directory under ``root``."""
    for d, _, files in os.walk(root):
        for p in [os.path.join(d, name) for name in files] + [d]:
            fd = os.open(p, os.O_RDONLY)
            try:
                os.fsync(fd)
            finally:
                os.close(fd)


def setup(ctx) -> State:
    from repro_torch.core import StreamingIndex

    s = ctx.sizes
    root = ROOT / s["storage_dir"]
    _clear_finished(root)
    root.mkdir(parents=True, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free < s["free_bytes"]:
        raise SystemExit(f"palmbench: {root} has {free} bytes free; the cell "
                         f"needs {s['free_bytes']} for its store")
    store = tempfile.mkdtemp(prefix=f"{os.getpid()}-", dir=root)
    print(_disk(store), file=sys.stderr)
    index = StreamingIndex(_config(ctx, store))
    bsz = s["batch_size"]
    data = ctx.stream("stream", bsz * stream.STREAM_CHUNK_BATCHES)
    for b in range(s["prefill_batches"]):
        index.ingest(data.rows(b * bsz, (b + 1) * bsz), np.full(bsz, b, np.int64))
        data.drop((b + 1) * bsz)
    ctx.mark("prefill")
    st = State(index, data, ctx.stream("query", stream.QUERY_CHUNK),
               s["prefill_batches"], store=store)
    warm = ctx.stream("warmup", stream.QUERY_CHUNK)
    m = s["query_batch"]
    t0, t1 = stream._window_of(ctx, st.batch - 1)
    for i in range(s["warmup_requests"]):
        st.index.window_knn_batch(warm.rows(i * m, (i + 1) * m), t0, t1, k=s["k"])
    for b in range(st.batch, st.batch + s["pool_batches"], stream.STREAM_CHUNK_BATCHES):
        data.chunk(b // stream.STREAM_CHUNK_BATCHES)
    st.queries.chunk(0)
    _sync_tree(store)
    ctx.mark("warm-up")
    return st


def _written(index) -> int:
    """The bytes the backend counts written: the counters that
    ``measured_io()["write_bytes"]`` sums, those a program has."""
    m = index.measured_io()
    keys = ("raw_write_bytes", "run_write_bytes", "wal_write_bytes",
            "wal_rotate_bytes", "meta_write_bytes")
    return sum(m.get(k, 0) for k in keys)


def step(ctx, st: State) -> None:
    if not ctx.trace:
        return stream.step(ctx, st)
    before = _written(st.index)  # traced runs: the bytes the spans must match
    stream.step(ctx, st)
    st.written += _written(st.index) - before
    st.steps += 1


def release(ctx, st: State) -> None:
    # dropped as a crash leaves it: the recovery reads only the directory
    ctx.file_run = {"store": st.store, "acked": st.batch * ctx.sizes["batch_size"]}
    if st.steps:
        print(f"window writes: {st.written} bytes over {st.steps} steps, "
              f"{st.written / st.steps:.1f} a step (measured_io)", file=sys.stderr)
    st.index = None


def _lost(ctx, rec, acked: int) -> int:
    """Acknowledged series the recovered index lacks, plus what it holds
    that was never acknowledged or that it holds twice."""
    import torch

    snap = rec.lsm.registry.current()
    held = [np.asarray(r.ids) for r in snap.runs_newest_first()]
    held += [np.asarray(c.ids) for c in snap.dense_chunks()]
    held = np.concatenate(held) if held else np.zeros(0, np.int64)
    ok = (held >= 0) & (held < acked)
    count = np.bincount(held[ok], minlength=acked)
    extra = int(held.size - (count > 0).sum()) + max(0, rec.raw.n - acked)
    # a held id counts only where its raw row is, bit for bit, the row the
    # seed made for it
    have = count > 0
    have[min(acked, rec.raw.n):] = False
    rows = rec.raw._all()
    X = ctx.stream("stream", ctx.sizes["batch_size"] * stream.STREAM_CHUNK_BATCHES)
    for a in range(0, min(acked, rec.raw.n), CHECK_ROWS):
        b = min(a + CHECK_ROWS, acked, rec.raw.n)
        got = torch.from_numpy(np.array(rows[a:b])).to(ctx.device)
        want = X.device_rows(a, b)
        same = (got.view(torch.int32) == want.view(torch.int32)).all(dim=1)
        have[a:b] &= same.cpu().numpy()
    return int((~have).sum()) + extra


def _recover(ctx, answers, run: dict):
    """(lost_series, the last step's queries answered by the recovered
    index); removes the store after."""
    from repro_torch.core import StreamingIndex

    s = ctx.sizes
    t0 = time.perf_counter()
    rec = StreamingIndex.recover(_config(ctx, run["store"]), run["store"])
    print(f"recover_s {time.perf_counter() - t0:.6f}", file=sys.stderr)
    try:
        lost = _lost(ctx, rec, run["acked"])
        b, Q = answers[-1][:2]
        w0, w1 = stream._window_of(ctx, b)
        d2, ids, _ = rec.window_knn_batch(Q, w0, w1, k=s["k"])
    finally:
        rec.close()
        shutil.rmtree(run["store"], ignore_errors=True)
    return lost, (b, Q, d2, ids)


def judge(ctx, answers, control=False) -> dict:
    run = ctx.file_run
    if "recovered" not in run:  # once: the control reuses it
        run["recovered"] = _recover(ctx, answers, run)
    lost, again = run["recovered"]
    return {**stream.judge(ctx, list(answers) + [again], control),
            "lost_series": lost}
