"""Serving driver — the end-to-end application: serve batched
nearest-neighbor requests over a live Coconut index while the stream keeps
ingesting, with verification on the device.

    PYTHONPATH=src python -m repro_torch.launch.serve --scheme BTP \
        --batches 40 --batch-size 500 --query-batch 32

    PYTHONPATH=src python -m repro_torch.launch.serve --gateway --autotune \
        --batches 40 --batch-size 500 --requests 400

``--gateway`` serves an arrival stream of single-query clients through the
dynamic-batching gateway instead (``serve_gateway``). The device arenas
live on ``--device`` (``cuda`` unless asked otherwise; without a card that
default raises). ``--storage file --storage-dir DIR`` keeps the index in
crash-consistent files under DIR (raw rows, mmap'd runs, a write-ahead log
and a manifest); serving the same DIR again, or
``StreamingIndex.recover(cfg, DIR)``, reopens what was made durable.
``--shard mesh`` answers the exact tier on the device mesh
(``core.distributed``).

    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch smollm-360m --device cpu

``--mode lm`` runs a toy LM decode-serving loop (``serve_lm``: the smoke
config of ``--arch``, random weights) through the transformer serving path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from ..core import (
    StreamConfig, StreamingIndex, SummarizationConfig, recall_at_k,
    render_heatmap,
)
from ..core.verify_engine import get_engine, resolve_device
from ..data.synthetic import seismic


def serve_coconut(args) -> dict:
    """Serve batched kNN traffic over a live stream.

    ``--tier exact`` answers through the batched exact engine
    (``window_knn_batch``); ``--tier approx`` through the batched
    approximate tier (``window_knn_approx_batch``): one vectorized key seek
    plus coalesced sequential block reads per (run, batch). ``--n-blocks``
    is the approximate tier's recall knob. Approximate recall@k vs the
    exact oracle is measured on every served batch.

    ``--shard mesh`` executes the exact tier on the device mesh
    (``core.distributed``): the query batch sharded over one mesh axis and
    the window's entries over the other, one ``topk_ed`` launch a tile, the
    per-shard slates folded with one ``all_gather`` — answers are identical
    to the single-device engine (host f64 re-rank). Without a process
    group the mesh is one rank on ``--device`` (NCCL on a card).

    ``--ingest async`` moves flush/merge work onto the background ingest
    pipeline: queries serve from pinned epoch snapshots while compactions
    publish concurrently, and the per-batch log line reports the freshness
    lag.

    Verification runs on the device engine. At startup ``prewarm`` walks
    the pass ladder the configured stream can produce and builds the
    kernel library, so the first served batch pays no build; every log
    line reports the engine's cumulative ``traces``/``hits``.
    ``--no-prewarm`` skips it.

    ``--storage file`` serves from the crash-consistent file backend
    (``--storage-dir``, default a fresh temp dir) and logs its measured I/O.

    Returns what was served: per-batch latency, recall (approx tier) and
    ``served`` entries ``(batch, t0, t1, queries, ids, d2)``, the engine
    stats, the measured I/O (empty under the model backend) and the index
    itself for callers that check the answers."""
    tier = "approx" if args.approx else args.tier
    shard = args.shard if args.shard != "none" else None
    device = getattr(args, "device", "cuda")
    scfg = SummarizationConfig(series_len=args.series_len, n_segments=16,
                               card_bits=8)
    idx = StreamingIndex(StreamConfig(
        scheme=args.scheme, summarization=scfg, buffer_entries=4096,
        growth_factor=4, block_size=512, ingest=args.ingest,
        # getattr: programmatic callers (tests) build partial Namespaces
        storage=getattr(args, "storage", "auto"),
        storage_dir=getattr(args, "storage_dir", None),
        screen_dtype=getattr(args, "screen_dtype", None), device=device))
    if idx.storage is not None:
        print(f"[serve] file storage backend at {idx.storage.root} "
              "(WAL + manifest, crash-consistent)", flush=True)
    idx.raw.disk.keep_log = True
    engine = get_engine(device)
    if args.prewarm:
        # the non-materialized stream verifies against the RawStore arena,
        # whose capacity walks the bucket ladder as ingest grows it — walk
        # every table size the stream will reach
        sizes = sorted({args.batch_size * (b + 1) for b in range(args.batches)})
        t0 = time.perf_counter()
        n = engine.prewarm(args.series_len, args.query_batch, args.k, sizes,
                           dtype=getattr(args, "screen_dtype", None))
        print(f"[serve] prewarmed {n} pass signatures "
              f"({time.perf_counter()-t0:.1f}s) for stores up to {sizes[-1]} "
              f"entries on {engine.device}", flush=True)
    lat, recalls, lags, served = [], [], [], []
    for b in range(args.batches):
        x = seismic(args.batch_size, args.series_len, seed=b)
        idx.ingest(x, np.full(args.batch_size, b, np.int64))
        if (b + 1) % 5 == 0:  # serve a query batch every 5 ingest batches
            qs = seismic(args.query_batch, args.series_len, seed=10_000 + b)
            t0b, t1b = max(0, b - args.window), b
            t0 = time.perf_counter()
            if tier == "approx":
                got_d2, got_ids, _ = idx.window_knn_approx_batch(
                    qs, t0b, t1b, k=args.k, n_blocks=args.n_blocks)
            else:
                got_d2, got_ids, _ = idx.window_knn_batch(qs, t0b, t1b,
                                                          k=args.k, shard=shard)
            dt = (time.perf_counter() - t0) / args.query_batch
            lat.append(dt)
            served.append((b, t0b, t1b, qs, got_ids, got_d2))
            es = engine.stats
            lag = idx.ingest_lag()
            lags.append(lag["lag_entries"])
            bhist = ",".join(f"{mb}:{c}" for mb, c in
                             sorted(es["batch_hist"].items()))
            line = (f"[serve] batch {b+1}: {args.query_batch} queries "
                    f"({tier}{'+mesh' if shard == 'mesh' else ''}), "
                    f"{dt*1e3:.2f} ms/query, "
                    f"partitions={idx.n_partitions}, "
                    f"calls={es['calls']}, fallbacks={es['fallbacks']}, "
                    f"traces={es['traces']}, hits={es['hits']}, "
                    f"batch_hist={bhist or '-'}, "
                    f"epoch={lag['epoch']}, lag={lag['lag_entries']}, "
                    f"pending_merge={lag['runs_pending_merge']}, "
                    f"snap_age={lag['snapshot_age_s']:.2f}s")
            if tier == "approx":
                # score recall without letting the oracle's reads pollute
                # the approx tier's modeled-I/O figures (suspended for THIS
                # thread only, so a background ingest worker keeps
                # accounting into the shared stats)
                with idx.raw.disk.unaccounted():
                    _, exact_ids, _ = idx.window_knn_batch(qs, t0b, t1b,
                                                           k=args.k)
                recalls.append(recall_at_k(got_ids, exact_ids))
                line += f", recall@{args.k}={recalls[-1]:.3f}"
            print(line, flush=True)
    if args.ingest == "async":
        t0 = time.perf_counter()
        idx.drain(timeout=300)
        idx.close()
        print(f"[serve] drained ingest backlog in {time.perf_counter()-t0:.2f}s "
              f"(max observed lag {max(lags or [0])} entries)")
    lat_ms = np.array(lat) * 1e3
    if lat_ms.size:
        print(f"[serve] latency ms/query p50={np.percentile(lat_ms, 50):.3f} "
              f"p95={np.percentile(lat_ms, 95):.3f} max={lat_ms.max():.3f}")
    if recalls:
        print(f"[serve] approx tier n_blocks={args.n_blocks}: "
              f"mean recall@{args.k}={np.mean(recalls):.3f} "
              f"min={np.min(recalls):.3f}")
    es = engine.stats
    print(f"[serve] engine on {engine.device}: calls={es['calls']} "
          f"fallbacks={es['fallbacks']} screened={es['screened']} "
          f"arena_bytes={es['arena_bytes']} arena_dtype={es['arena_dtype']}")
    print(f"[serve] ingested {args.batches*args.batch_size} series, "
          f"{idx.n_partitions} partitions, "
          f"index={idx.index_bytes()>>20} MiB, "
          f"modeled io={idx.raw.disk.modeled_seconds():.2f}s")
    m = idx.measured_io()
    if m:
        print(f"[serve] measured io: wrote "
              f"{(m['raw_write_bytes']+m['run_write_bytes']+m['wal_write_bytes'])/1e6:.1f} MB "
              f"(raw {m['raw_write_bytes']/1e6:.1f}, runs {m['run_write_bytes']/1e6:.1f}, "
              f"wal {m['wal_write_bytes']/1e6:.1f}), read {m['raw_read_bytes']/1e6:.1f} MB, "
              f"{m['manifest_commits']} manifest commits, "
              f"{m['prefetch_spans']} readahead spans")
    print("[serve] access heat map:", render_heatmap(idx.raw.disk.heatmap()))
    return {"latency_ms": lat_ms, "recalls": recalls, "served": served,
            "engine": dict(es), "measured_io": m, "index": idx}


def serve_gateway(args) -> dict:
    """Serve an *arrival stream* of independent single-query clients through
    the dynamic-batching gateway (``core.gateway``) while background ingest
    keeps publishing epochs.

    Two thirds of ``--batches`` are ingested and drained first; the rest go
    in from a background thread while a Poisson generator submits
    ``--requests`` single queries at ``--arrival-rate`` QPS with a
    deterministic tenant mix (plain exact / recall-targeted / conflicting
    recall+latency targets; half of each with a window over the last
    ``--window`` drained batches). The gateway coalesces them into
    ladder-rung batches under ``--deadline-ms``, splits mixed batches into
    per-tier sub-batches against one pinned epoch each, and sheds
    sheddable exact traffic to the approximate tier when the rolling p99
    passes ``--slo-p99-ms``. The first requests (a quarter, at most two top
    rungs) are warm-up: drained, then the SLO window is reset (the reset
    waits until the dispatcher has accounted them). The summary
    reports client-observed latency percentiles, shed rate, the
    formed-batch histogram, and the engine's post-warm-up retrace count
    (zero when prewarmed).

    Returns what was served: ``responses`` and ``requests`` (the keyword
    arguments of each submission) in submission order, ``queries``,
    ``warmup`` (how many of them were warm-up), the measured requests'
    ``latency_ms`` and ``queue_wait_ms``, ``shed_rate``, the gateway's
    ``stats`` (read after its dispatcher stopped, so every batch is
    counted), ``retraces`` after the warm-up, the tuner's ``tuner``
    snapshot (None without ``--autotune``), the engine stats and the index
    (its ingest worker stopped) for callers that check the answers."""
    import threading

    from ..core import Gateway, GatewayConfig

    device = getattr(args, "device", "cuda")
    scfg = SummarizationConfig(series_len=args.series_len, n_segments=16,
                               card_bits=8)
    idx = StreamingIndex(StreamConfig(
        scheme=args.scheme, summarization=scfg, buffer_entries=4096,
        growth_factor=4, block_size=512, ingest="async",
        storage=getattr(args, "storage", "auto"),
        storage_dir=getattr(args, "storage_dir", None),
        screen_dtype=getattr(args, "screen_dtype", None), device=device))
    pre = max(1, (2 * args.batches) // 3)
    for b in range(pre):
        x = seismic(args.batch_size, args.series_len, seed=b)
        idx.ingest(x, np.full(args.batch_size, b, np.int64))
    idx.drain(timeout=300)
    gw = Gateway(idx, GatewayConfig(
        deadline_ms=args.deadline_ms, slo_p99_ms=args.slo_p99_ms,
        max_batch=max(8, args.query_batch), k=args.k,
        autotune=getattr(args, "autotune", False)))
    engine = get_engine(device)
    if args.prewarm:
        sizes = sorted({args.batch_size * (b + 1) for b in range(args.batches)})
        t0 = time.perf_counter()
        n = gw.prewarm(sizes, dtype=getattr(args, "screen_dtype", None))
        print(f"[gateway] prewarmed {n} traces ({time.perf_counter()-t0:.1f}s) "
              f"for stores up to {sizes[-1]} entries on {engine.device}",
              flush=True)

    stop = threading.Event()
    ingest_errors = []

    def background_ingest():
        try:
            for b in range(pre, args.batches):
                if stop.is_set():
                    return
                x = seismic(args.batch_size, args.series_len, seed=b)
                idx.ingest(x, np.full(args.batch_size, b, np.int64))
                time.sleep(0.01)
        except BaseException as e:  # re-raised on the serving thread
            ingest_errors.append(e)

    ingester = threading.Thread(target=background_ingest, daemon=True)
    ingester.start()
    rng = np.random.default_rng(12345)
    Q = seismic(args.requests, args.series_len, seed=77_000)
    warmup = min(args.requests // 4, 2 * max(8, args.query_batch))
    tickets, requests = [], []
    traces_after_warmup = None
    for i in range(args.requests):
        r = rng.random()
        kw = {}
        if r < 0.2:
            kw["target_recall"] = 0.9
        elif r < 0.3:
            kw.update(target_recall=0.9, latency_budget_ms=0.05)
        if rng.random() < 0.5:
            kw["window"] = (max(0, pre - args.window), pre - 1)
        tickets.append(gw.submit(Q[i], **kw))
        requests.append(kw)
        if i + 1 == warmup:
            for t in tickets:  # drain the warm-up phase before measuring
                t.result(timeout=120)
            gw.reset_slo_window()  # warm-up latencies must not trip the gate
            traces_after_warmup = engine.stats["traces"]
        if gw.tuner is not None and (i + 1) % 64 == 0:
            st = gw.snapshot()
            print(f"[autotune] req {i+1}: decisions={st.tuner_decisions} "
                  f"explores={st.tuner_explores} "
                  f"observations={st.tuner_observations} "
                  f"probes={st.tuner_probes} batches={st.batches} "
                  f"p99={st.p99_ms:.2f} ms", flush=True)
        time.sleep(rng.exponential(1.0 / max(args.arrival_rate, 1e-6)))
    resps = [t.result(timeout=120) for t in tickets]
    # the last batch is accounted after its shadow work, which runs after
    # its tickets resolve: stop the dispatcher before reading the stats
    gw.close(timeout=300)
    stop.set()
    ingester.join(timeout=30)
    if ingest_errors:
        raise ingest_errors[0]
    idx.drain(timeout=300)
    measured = resps[warmup:]
    lat = np.array([r.latency_ms for r in measured])
    waits = np.array([r.queue_wait_ms for r in measured])
    shed_rate = float(np.mean([r.shed for r in measured]))
    gs = gw.snapshot_stats()
    retraces = engine.stats["traces"] - (traces_after_warmup
                                         if traces_after_warmup is not None
                                         else engine.stats["traces"])
    bhist = ",".join(f"{s}:{c}" for s, c in sorted(gs["batch_hist"].items()))
    print(f"[gateway] {len(measured)} measured requests @ "
          f"{args.arrival_rate:.0f} QPS offered: "
          f"p50={np.percentile(lat, 50):.2f} ms "
          f"p95={np.percentile(lat, 95):.2f} ms "
          f"p99={np.percentile(lat, 99):.2f} ms "
          f"(queue wait p99={np.percentile(waits, 99):.2f} ms)")
    print(f"[gateway] shed_rate={shed_rate:.3f} shedding={gs['shedding']} "
          f"conflicts={gs['conflicts']} batches={gs['batches']} "
          f"deadline_flushes={gs['deadline_flushes']} "
          f"full_flushes={gs['full_flushes']} batch_hist={bhist}")
    print(f"[gateway] post-warm-up retraces={retraces} "
          f"(traces={engine.stats['traces']}, hits={engine.stats['hits']})")
    tuner = None
    if gw.tuner is not None:
        tuner = gw.tuner.snapshot()
        for label, arms in tuner["profiles"].items():
            fitted = " ".join(
                f"{arm}:p99={est['p99_ms']:.2f}ms,rec={est['recall']:.3f}"
                for arm, est in sorted(arms.items())
                if not arm.startswith("_"))
            print(f"[autotune] profile {label} "
                  f"({arms['_decisions']} decisions, "
                  f"epoch {arms['_last_epoch']}): {fitted}", flush=True)
        for entry in gw.tuner.advise_global(idx.ingest_lag(),
                                            n_series=int(idx.raw.n)):
            print(f"[autotune] [{entry.node_id}] {entry.text}", flush=True)
    idx.close()
    return {"responses": resps, "requests": requests, "queries": Q,
            "warmup": warmup, "latency_ms": lat, "queue_wait_ms": waits,
            "shed_rate": shed_rate, "stats": gs, "retraces": retraces,
            "tuner": tuner, "engine": dict(engine.stats), "index": idx}


def serve_lm(args) -> dict:
    """Greedy decode serving of ``--arch``'s smoke config: random weights
    from a generator seeded 0 on ``--device``, ``--query-batch`` prompts of
    32 tokens from ``default_rng(0)``, one prefill with room for
    ``--decode-tokens`` more, then that many greedy decode steps, timed.
    Returns the config, the logits of the prefill and of every step, and
    the generated tokens."""
    from ..configs import get_config
    from ..models.steps import make_decode_step
    from ..models.transformer import init_params, prefill

    device = resolve_device(getattr(args, "device", "cuda"))
    cfg = get_config(args.arch, smoke=True)
    params = init_params(cfg, torch.Generator(device).manual_seed(0), device)
    rng = np.random.default_rng(0)
    B, P = args.query_batch, 32
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (B, P)).astype(np.int32))
    logits, cache = prefill(params, cfg, {"tokens": toks.to(device)},
                            cache_len=P + args.decode_tokens)
    step = make_decode_step(cfg)
    seen = [logits]
    tok = logits.argmax(-1)[:, None]
    generated = [tok]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(args.decode_tokens):
        logits, cache = step(params, cache, tok)
        tok = logits.argmax(-1)[:, None]
        seen.append(logits)
        generated.append(tok)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"[serve-lm] {args.decode_tokens} tokens x batch {B}: "
          f"{dt/args.decode_tokens*1e3:.1f} ms/step, "
          f"{B*args.decode_tokens/dt:.0f} tok/s")
    return {"cfg": cfg, "logits": torch.stack(seen),
            "tokens": torch.cat(generated, dim=1)}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="coconut", choices=["coconut", "lm"])
    ap.add_argument("--scheme", default="BTP", choices=["PP", "TP", "BTP"])
    ap.add_argument("--batches", type=int, default=40)
    ap.add_argument("--batch-size", type=int, default=500)
    ap.add_argument("--series-len", type=int, default=128)
    ap.add_argument("--query-batch", type=int, default=16)
    ap.add_argument("--window", type=int, default=5)
    ap.add_argument("--k", type=int, default=5)
    ap.add_argument("--tier", default="exact", choices=["exact", "approx"],
                    help="serving tier: exact engine or the approximate "
                         "(key-seek + sequential-block-read) tier")
    ap.add_argument("--n-blocks", type=int, default=2,
                    help="approx tier: adjacent blocks read per (query, run) "
                         "— the recall vs I/O knob")
    ap.add_argument("--shard", default="none", choices=["none", "mesh"],
                    help="exact tier execution: single-device or the device "
                         "mesh (queries x runs 2-D over torch.distributed)")
    ap.add_argument("--ingest", default="sync", choices=["sync", "async"],
                    help="sync: flush/merge inline on the serving thread; "
                         "async: background ingest pipeline (queries never "
                         "block on compaction, freshness lag is logged)")
    ap.add_argument("--storage", default="auto",
                    choices=["auto", "model", "file"],
                    help="storage backend: model (DiskModel simulation), "
                         "file (crash-consistent mmap runs + WAL), or auto "
                         "(the REPRO_STORAGE env var, default model)")
    ap.add_argument("--storage-dir", default=None,
                    help="file backend root directory (default: a fresh "
                         "temp dir); reopening the same dir recovers the "
                         "durable index state")
    ap.add_argument("--screen-dtype", default=None,
                    choices=["f32", "bf16", "int8", "auto"],
                    help="device-arena storage dtype for the screen tier: "
                         "bf16 halves / int8 quarters the arena; answers "
                         "stay exact via the widened certificate + f64 "
                         "re-rank (default: the REPRO_SCREEN_DTYPE env var, "
                         "f32)")
    ap.add_argument("--device", default="cuda",
                    help="where the device arenas live and the screen runs: "
                         "cuda (default; raises without a card) or cpu")
    ap.add_argument("--gateway", action="store_true",
                    help="serve a Poisson arrival stream of independent "
                         "single-query clients through the dynamic-batching "
                         "admission gateway (deadline flush + SLO shedding) "
                         "instead of pre-formed query batches")
    ap.add_argument("--arrival-rate", type=float, default=500.0,
                    help="gateway mode: offered load in queries/second "
                         "(Poisson arrivals)")
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="gateway mode: max in-queue wait before a partial "
                         "batch is flushed (padded to the ladder rung)")
    ap.add_argument("--slo-p99-ms", type=float, default=50.0,
                    help="gateway mode: rolling-p99 latency target; past it "
                         "sheddable exact traffic serves on the approx tier "
                         "until p99 recovers (hysteresis)")
    ap.add_argument("--requests", type=int, default=400,
                    help="gateway mode: total client requests to submit")
    ap.add_argument("--autotune", action="store_true",
                    help="gateway mode: per-request tier selection via the "
                         "online autotuner (measured-feedback bandit over "
                         "the tier/n_blocks grid) instead of the static "
                         "recommender rule; adaptation state is logged "
                         "every 64 requests")
    ap.add_argument("--approx", action="store_true",
                    help="deprecated alias for --tier approx")
    ap.add_argument("--no-prewarm", dest="prewarm", action="store_false",
                    help="skip walking the pass ladder and building the "
                         "kernels at startup (the first batch pays the build)")
    ap.add_argument("--arch", default="smollm-360m")
    ap.add_argument("--decode-tokens", type=int, default=32)
    return ap


def main(argv=None):
    ap = build_parser()
    args = ap.parse_args(argv)
    # reject impossible flag combinations at parse time, not mid-batch
    if args.shard == "mesh" and (args.approx or args.tier == "approx"):
        ap.error("--shard mesh serves the exact tier only (the approx "
                 "tier's seek/coalesce I/O model is host-side)")
    if args.mode != "coconut":
        return serve_lm(args)
    if args.gateway:
        return serve_gateway(args)
    return serve_coconut(args)


if __name__ == "__main__":
    main()
