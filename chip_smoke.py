#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root, one card

Phases, each reported on lines of its own:

1. device:  a CUDA card, or a non-zero exit; its name and power limit.
2. build:   nvcc builds the hand-written kernels of ``src/repro_torch/kernels/csrc``
            for sm_90a (into ``build/repro_torch_kernels/``).
3. kernels: each kernel against its plain PyTorch version on the card, on a
            centered seismic table of 2^20 x 256 rows at f32, bf16 and int8,
            batches of 16 and 64 queries, a 3*2^14-row gather and the full
            table, slates of 13 (k = 5 plus the engine's slack) and the
            kernels' maximum. Ids must be equal except between candidates
            whose plain distances lie within the engine's certificate bound
            of each other, and every |delta d2| must lie within that bound.
4. serve:   the port's serving loop (``repro_torch.launch.serve``) over
            1,024,000 seismic series of length 256 (a 1 GiB f32 arena on the
            card), BTP, 16-query batches after every fifth of 200 ingest
            batches (40 served batches), a window of 55 ingest batches:
            exact tier at f32, exact tier at int8, approximate tier at f32
            (64 blocks per query and run). Only the tier's own query calls
            are probed, never the approximate tier's recall oracle: launch
            counts are set to 0 just before each call and read just after
            it, and each phase must have launched its kernel and kept its
            host fallbacks under a limit. Every fifth served batch runs
            under the profiler (device busy share, kernel call shapes); the
            latency percentiles come from the other 32. Every exact-tier
            answer must equal an f64 brute force over the window, computed
            on the card. Then exact int8 serving of a stream of repeating
            events, where the int8 certificate holds, checked the same way.
5. timing:  each kernel at the shape the serving loop launched it at most
            often: its device time, its plain version, one PyTorch library
            yardstick (gather + addmm + topk, used nowhere in the port) and
            the least time the card could take (its bound).

Then one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before the last line. f32 products run without TF32 throughout: the
certificate bound holds only for true f32 arithmetic.
"""
from __future__ import annotations

import collections
import contextlib
import gc
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
DEVICE = "cuda"

# the serving configuration: 200 ingest batches of 5,120 series = 1,024,000;
# the loop serves a query batch after every fifth, 40 in a phase
SERIES_LEN = 256
BATCHES = 200
BATCH_SIZE = 5_120
QUERY_BATCH = 16
WINDOW = 54  # ingest batches before the current one: 55 batches, 281,600 rows
K = 5
# approx tier: 64 blocks of 512 around each query's key cover a run of up
# to 32,768 entries whole, so a batch shares one device pass on the small
# runs; narrower spans leave every query a group of its own, below the
# engine's batch floor, and the tier screens on the host
N_BLOCKS = 64
TRACE_EVERY = 5  # every fifth served batch runs under the profiler
# the largest share of screened queries that may fall back to the host:
# f32 certifies; int8 on seismic data mostly cannot (the quantization term
# of the certificate outweighs the gaps between noise-floor neighbours) but
# the kernel must still answer some. Repeating events certify in the pass
# that holds the query's source; a pass over unrelated events certifies
# only where its 5th and 13th nearest lie apart, about half of them at 1M
# series, so at least 40% of the screened queries must certify
FALLBACK_LIMIT = {("exact", "f32"): 0.01, ("exact", "int8"): 0.999,
                  ("approx", "f32"): 0.01, "repeats": 0.6}
REPEATS = 5  # recordings of each repeating source (= k of its queries)
REPEAT_NOISE = 0.005
ENGINE_COUNTERS = ("calls", "screened", "fallbacks", "arena_bytes")

# kernel-phase shapes
TABLE_ROWS = 1 << 20
GATHER_ROWS = 3 << 14
BATCHES_M = (16, 64)

# NVIDIA H100 SXM data sheet: HBM3 rate and dense FP32 (CUDA-core) rate, at
# the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

EPS32 = 2.0 ** -23
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/screen_select.cu"
REPLACES = {
    "screen_select": "src/repro/kernels/ed_scan_kernel.py:227",
    "screen_select_quant": "src/repro/kernels/ed_scan_kernel.py:279",
}
DEVICE_KERNELS = ("screen_partial_kernel", "slate_merge_kernel")
T_START = time.perf_counter()


def log(msg: str) -> None:
    print(f"[smoke +{time.perf_counter() - T_START:7.1f}s] {msg}", flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"[smoke] FAILED: {msg}")


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ tables
def seismic_table(torch, n, d, gen, device):
    """Centered seismic-like rows made on the card: a 0.05 noise floor and,
    on a tenth of the rows, a decaying oscillation from a random onset (the
    shape of ``repro_torch.data.synthetic.seismic``)."""
    x = 0.05 * torch.randn((n, d), generator=gen, device=device)
    quake = torch.rand(n, generator=gen, device=device) < 0.1
    onset = torch.randint(0, d // 2, (n, 1), generator=gen, device=device)
    f = 0.05 + 0.2 * torch.rand((n, 1), generator=gen, device=device)
    decay = 0.01 + 0.04 * torch.rand((n, 1), generator=gen, device=device)
    rel = (torch.arange(d, device=device)[None, :] - onset).float()
    burst = torch.where(rel >= 0, torch.exp(-decay * rel.clamp_min(0))
                        * torch.sin(2 * math.pi * f * rel.clamp_min(0)), 0.0)
    x += quake[:, None] * burst
    return x - x.mean(dim=0, keepdim=True)


def stored(torch, xc, dtype):
    """The arena's storage of centered rows: (table, scale or None, norms of
    the stored values), as the engine quantizes them."""
    if dtype == "f32":
        return xc, None, (xc.double() ** 2).sum(1).float()
    if dtype == "bf16":
        t = xc.to(torch.bfloat16)
        return t, None, (t.double() ** 2).sum(1).float()
    amax = xc.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax / 127.0, torch.ones_like(amax)).float()
    t = torch.round(xc / scale[:, None]).clamp(-127, 127).to(torch.int8)
    deq = t.double() * scale.double()[:, None]
    return t, scale, (deq * deq).sum(1).float()


# ------------------------------------------------------------- one kernel
class Case:
    """One kernel call: queries, a stored table, optional row list."""

    def __init__(self, torch, ops, ref, q, table, scale, xn2, rows, s):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.q, self.table, self.scale, self.xn2, self.s = q, table, scale, xn2, s
        self.rows_host = None if rows is None else rows.to("cpu", torch.int32)
        self.rows = rows
        self.name = "screen_select" if scale is None else "screen_select_quant"
        self.n = table.shape[0] if rows is None else rows.numel()

    def kernel(self):
        """The wrapper as the engine calls it (row list in host memory)."""
        ops = self.ops
        if self.scale is None:
            return ops.screen_select(self.q, self.table, self.xn2, self.s,
                                     rows=self.rows_host)
        return ops.screen_select_quant(self.q, self.table, self.scale, self.xn2,
                                       self.s, rows=self.rows_host)

    def _gathered(self):
        if self.rows is None:
            return self.table, self.scale, self.xn2
        r = self.rows.long()
        return (self.table[r], None if self.scale is None else self.scale[r],
                self.xn2[r])

    def plain(self, k=None):
        x, sc, n2 = self._gathered()
        k = self.s if k is None else k
        if sc is None:
            return self.ref.screen_select_ref(self.q, x, n2, k)
        return self.ref.screen_select_quant_ref(self.q, x, sc, n2, k)

    def library(self):
        """The yardstick: gather, upcast, one addmm, one topk."""
        torch = self.torch
        x, sc, n2 = self._gathered()
        xf = x.float() if sc is None else x.float() * sc[:, None]
        d2 = torch.addmm(n2[None, :], self.q, xf.T, alpha=-2.0)
        return torch.topk(d2, self.s, dim=1, largest=False)

    def check(self):
        """Hold the kernel against the plain version; returns the largest
        |delta d2| and its share of the certificate bound."""
        torch = self.torch
        kv, ki, kq = self.kernel()
        pfull, pord, pq = self.plain(self.n)
        torch.cuda.synchronize()
        pv, pi = pfull[:, : self.s], pord[:, : self.s]
        _, _, n2 = self._gathered()
        xmax = math.sqrt(float(n2[n2 < 1e29].max()))
        d = self.q.shape[1]
        # each screen lies within 4 d u |q| |x|max of the exact value
        bound = 4.0 * d * EPS32 * pq.double().sqrt() * xmax
        tol = (2.0 * bound)[:, None]
        if ki.shape != pi.shape or bool((ki < 0).any()):
            fail(f"{self.name}: slate shape {tuple(ki.shape)} or empty slots")
        err = (kv.double() - pv.double()).abs()
        d2 = torch.empty_like(pfull).scatter_(1, pord.long(), pfull)
        picked = torch.gather(d2, 1, ki.long()).double()
        differ = ki != pi
        off = (picked - pv.double()).abs()
        if bool((err > tol).any()):
            fail(f"{self.name}: |delta d2| {float(err.max()):.3e} beyond the "
                 f"certificate bound {float(tol.min()):.3e}")
        if bool((differ & (off > tol)).any()):
            fail(f"{self.name}: {int(differ.sum())} ids differ beyond the bound")
        if not torch.allclose(kq, pq, rtol=1e-5):
            fail(f"{self.name}: |q|^2 differs from the plain version")
        return float(err.max()), float((err / tol).max()), int(differ.sum())

    def bound(self):
        """Least time for the same work: each input read once, each output
        written once, against the FP32 CUDA-core rate for 2 m n d flops."""
        m, d = self.q.shape
        elt = self.table.element_size()
        nbytes = (self.n * d * elt + 4 * self.n  # candidate rows + norms
                  + (4 * self.n if self.rows is not None else 0)  # row list
                  + (4 * self.n if self.scale is not None else 0)  # scales
                  + 4 * m * d + 8 * m * self.s + 4 * m)  # q, slate, |q|^2
        t_bytes = nbytes / HBM_BYTES_PER_S
        t_ops = 2.0 * m * self.n * d / FP32_FLOP_PER_S
        return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                           else "operations")


def events_ms(torch, fn, reps):
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def device_times(prof) -> collections.Counter:
    """Device microseconds by kernel or copy name, from a profiler trace.
    Host operators are skipped: their device time repeats their kernels'."""
    out = collections.Counter()
    for e in prof.key_averages():
        if str(getattr(e, "device_type", "")).endswith("CPU"):
            continue
        us = e.self_device_time_total
        if us > 0:
            out[e.key] += us
    return out


def kernel_device_ms(torch, fn, reps):
    """Device time per call of the kernels alone, and its split between the
    partial screen and the merge, from the profiler's CUPTI trace; (None,
    {}) where the trace shows no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {k: sum(us for key, us in device_times(prof).items() if k in key)
             / 1e3 / reps for k in DEVICE_KERNELS}
    total = sum(split.values())
    return (total, split) if total > 0 else (None, {})


def time_case(torch, case, reps=50):
    """kernel (device trace, else events around the wrapper), the wrapper
    call, the plain version and the library yardstick, in ms per call."""
    call_ms = events_ms(torch, case.kernel, reps)
    try:
        dev_ms, split = kernel_device_ms(torch, case.kernel, reps)
    except Exception as exc:  # the trace is a measuring tool only
        log(f"timing: profiler unavailable ({type(exc).__name__}: {exc})")
        dev_ms, split = None, {}
    return {"ms": dev_ms if dev_ms is not None else call_ms,
            "timer": "device trace" if dev_ms is not None else "events",
            "split_ms": split, "call_ms": call_ms,
            "plain_ms": events_ms(torch, case.plain, 10),
            "library_ms": events_ms(torch, case.library, 10)}


def timing_text(t, bound_ms, bound_by) -> str:
    split = ", ".join(f"{k} {v:.4f}" for k, v in t["split_ms"].items())
    return (f"kernel {t['ms']:.4f} ms ({t['timer']}{': ' + split if split else ''}), "
            f"call {t['call_ms']:.4f} ms, plain {t['plain_ms']:.4f} ms, library "
            f"{t['library_ms']:.4f} ms, bound {bound_ms:.4f} ms ({bound_by}), "
            f"kernel/bound {t['ms'] / bound_ms:.1f}")


# ------------------------------------------------------------------ phases
def phase_kernels(torch, ops, ref):
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(0)
    xc = seismic_table(torch, TABLE_ROWS, SERIES_LEN, gen, dev)
    rows = torch.randperm(TABLE_ROWS, generator=gen, device=dev)[:GATHER_ROWS]
    worst = collections.defaultdict(float)
    for dtype in ("f32", "bf16", "int8"):
        table, scale, xn2 = stored(torch, xc, dtype)
        for m in BATCHES_M:
            pick = torch.randint(0, TABLE_ROWS, (m,), generator=gen, device=dev)
            q = xc[pick] + 0.01 * torch.randn((m, SERIES_LEN), generator=gen,
                                              device=dev)
            for layout, r in (("gather", rows), ("full", None)):
                for s in (K + 8, ops.max_slate()):
                    case = Case(torch, ops, ref, q, table, scale, xn2, r, s)
                    err, share, ndiff = case.check()
                    worst[case.name] = max(worst[case.name], err)
                    what = f"kernels: {case.name} {dtype} m={m} {layout} n={case.n} s={s}"
                    log(f"{what}: max|delta d2|={err:.3e} ({share:.2e} of the "
                        f"bound), {ndiff} ids swapped within the bound")
                    if s == K + 8:
                        log(f"{what}: " + timing_text(time_case(torch, case, 20),
                                                      *case.bound()))
        del table, scale, xn2
    del xc
    return worst


@contextlib.contextmanager
def probe_tier(torch, ops, engine, method, shapes):
    """Wrap the serving tier's query method of ``StreamingIndex`` (and only
    it) for one phase. Around each call: the launch counts are set to 0 just
    before it and read just after it, and the engine's counters are read
    before and after, so a recall oracle that runs the other tier counts for
    nothing. Every TRACE_EVERY-th call also runs under the profiler, which
    gives the device's busy share, and records the kernels' call shapes;
    the other calls run bare and are the ones the latency percentiles use."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.streaming import StreamingIndex

    real = getattr(StreamingIndex, method)
    kernels = {n: getattr(ops, n) for n in ops.LAUNCHES}
    rec = {"n": 0, "traced": [], "launches": collections.Counter(),
           "engine": collections.Counter(), "busy": collections.Counter(),
           "traced_s": 0.0}

    def recorder(fname):
        def wrapped(q, x, *args, rows=None):
            n = x.shape[0] if rows is None else rows.numel()
            shapes[(fname, q.shape[0], n, x.shape[0], str(x.dtype).split(".")[-1],
                    args[-1], rows is not None)] += 1
            return kernels[fname](q, x, *args, rows=rows)
        return wrapped

    def probed(self, *args, **kwargs):
        i = rec["n"]
        rec["n"] += 1
        traced = i % TRACE_EVERY == TRACE_EVERY - 1
        before = {k: engine.stats[k] for k in ENGINE_COUNTERS}
        prof = None
        if traced:
            rec["traced"].append(i)
            for n in kernels:
                setattr(ops, n, recorder(n))
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        ops.reset_launches()  # counts from 0 for this call of the main path
        try:
            return real(self, *args, **kwargs)
        finally:
            launches = dict(ops.LAUNCHES)
            if traced:
                torch.cuda.synchronize()
                rec["traced_s"] += time.perf_counter() - t0
                prof.__exit__(None, None, None)
                for n, fn in kernels.items():
                    setattr(ops, n, fn)
                rec["busy"].update(device_times(prof))
            rec["launches"].update(launches)
            rec["engine"].update({k: engine.stats[k] - before[k]
                                  for k in ENGINE_COUNTERS})

    setattr(StreamingIndex, method, probed)
    try:
        yield rec
    finally:
        setattr(StreamingIndex, method, real)
        for n, fn in kernels.items():
            setattr(ops, n, fn)


def report_phase(name, rec, lat, kernel, fallback_limit, wall):
    """Print a phase's counts, busy share and latency percentiles over the
    untraced calls; fail if the phase's kernel never ran or its queries fell
    back to the host screen beyond ``fallback_limit``. Returns the summary."""
    es = rec["engine"]
    launches = dict(rec["launches"])
    traced = set(rec["traced"])
    bare = [v for i, v in enumerate(lat) if i not in traced]
    busy_s = sum(rec["busy"].values()) / 1e6
    top = ", ".join(f"{k[:48]} {us / 1e3:.1f} ms" for k, us in rec["busy"].most_common(4))
    share = es["fallbacks"] / max(1, es["screened"])
    p50, p95 = float(percentile(bare, 50)), float(percentile(bare, 95))
    log(f"{name}: traced {len(rec['traced'])} of {rec['n']} served batches: device "
        f"busy {busy_s:.4f}s of {rec['traced_s']:.4f}s answering them "
        f"({busy_s / max(rec['traced_s'], 1e-9):.4f}); most device time: {top}")
    log(f"{name}: {wall:.1f}s, tier launches {launches}, calls={es['calls']}, "
        f"screened={es['screened']}, fallbacks={es['fallbacks']} (share "
        f"{share:.4f}, limit {fallback_limit}), arena_bytes={es['arena_bytes']}, "
        f"ms/query p50={p50:.4f} p95={p95:.4f} over {len(bare)} untraced batches")
    if launches.get(kernel, 0) == 0:
        fail(f"{name}: the serving tier never launched {kernel}")
    if share > fallback_limit:
        fail(f"{name}: {share:.4f} of the screened queries fell back to the host")
    if len(bare) == 0 or not all(math.isfinite(v) for v in lat):
        fail(f"{name}: no untraced batches or non-finite latency")
    return launches, {"p50_ms_per_query": p50, "p95_ms_per_query": p95,
                      "untraced_batches": len(bare), "calls": es["calls"],
                      "screened": es["screened"], "fallbacks": es["fallbacks"],
                      "fallback_share": share, "arena_bytes": es["arena_bytes"],
                      "seconds": wall, "traced_seconds": rec["traced_s"],
                      "device_busy_seconds": busy_s}


def phase_serve(torch, ops, serve, engine, tier, dtype, shapes):
    argv = ["--scheme", "BTP", "--batches", str(BATCHES),
            "--batch-size", str(BATCH_SIZE), "--series-len", str(SERIES_LEN),
            "--query-batch", str(QUERY_BATCH), "--window", str(WINDOW),
            "--k", str(K), "--tier", tier, "--n-blocks", str(N_BLOCKS),
            "--screen-dtype", dtype, "--device", DEVICE]
    args = serve.build_parser().parse_args(argv)
    name = f"serve {tier} {dtype}"
    log(f"{name}: python -m repro_torch.launch.serve {' '.join(argv)}")
    method = "window_knn_approx_batch" if tier == "approx" else "window_knn_batch"
    t0 = time.perf_counter()
    with probe_tier(torch, ops, engine, method, shapes) as rec:
        out = serve.serve_coconut(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    kernel = "screen_select_quant" if dtype == "int8" else "screen_select"
    lat = [float(v) for v in out["latency_ms"]]
    launches, summary = report_phase(name, rec, lat, kernel,
                                     FALLBACK_LIMIT[(tier, dtype)], wall)
    idx = out["index"]
    if idx.raw.n != BATCHES * BATCH_SIZE:
        fail(f"{name}: ingested {idx.raw.n} series")
    X = torch.from_numpy(idx.raw.scan()).to(DEVICE)
    for b, t0b, t1b, qs, ids in out["served"]:
        lo, hi = t0b * BATCH_SIZE, (t1b + 1) * BATCH_SIZE
        got = torch.from_numpy(ids).to(DEVICE)
        if tier == "exact":
            check_exact(torch, X[lo:hi], qs, got - lo, f"{name} batch {b + 1}")
        elif bool(((got < lo) | (got >= hi)).any()):
            fail(f"{name} batch {b + 1}: an answer lies outside the window")
    if tier == "approx":
        rec_k = out["recalls"]
        summary["recall_mean"] = sum(rec_k) / len(rec_k)
        log(f"{name}: recall@{K} mean={summary['recall_mean']:.4f} "
            f"min={min(rec_k):.4f}")
    log(f"{name}: {len(out['served'])} served batches checked"
        + (" against the f64 brute force" if tier == "exact" else ""))
    del out, idx, X
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def phase_repeats(torch, ops, engine, shapes):
    """Exact int8 serving where the certificate holds: a stream of repeating
    seismic events (each source recorded REPEATS times with a small noise,
    the recordings of a batch's sources shuffled into it), queried every
    fifth batch with new recordings of sources seen so far, over the whole
    stream. The k = REPEATS nearest are then a source's earlier recordings,
    well apart from every other series, so the kernel's slates certify and
    its own answers are what the brute force checks."""
    import numpy as np

    from repro_torch.core import StreamConfig, StreamingIndex, SummarizationConfig
    from repro_torch.data.synthetic import seismic

    name = "serve exact int8 repeating events"
    per = BATCH_SIZE // REPEATS
    rng = np.random.default_rng(7)
    bases = seismic(BATCHES * per, SERIES_LEN, seed=7, quake_frac=1.0)
    idx = StreamingIndex(StreamConfig(
        scheme="BTP", summarization=SummarizationConfig(
            series_len=SERIES_LEN, n_segments=16, card_bits=8),
        buffer_entries=4096, growth_factor=4, block_size=512,
        screen_dtype="int8", device=DEVICE))
    lat, served = [], []
    t0 = time.perf_counter()
    with probe_tier(torch, ops, engine, "window_knn_batch", shapes) as rec:
        for b in range(BATCHES):
            src = np.repeat(np.arange(b * per, (b + 1) * per), REPEATS)
            rng.shuffle(src)
            x = bases[src] + (REPEAT_NOISE * rng.standard_normal(
                (src.size, SERIES_LEN))).astype(np.float32)
            idx.ingest(x, np.full(src.size, b, np.int64))
            if (b + 1) % 5:
                continue
            qsrc = rng.integers(0, (b + 1) * per, QUERY_BATCH)
            qs = bases[qsrc] + (REPEAT_NOISE * rng.standard_normal(
                (QUERY_BATCH, SERIES_LEN))).astype(np.float32)
            tq = time.perf_counter()
            _, ids, _ = idx.window_knn_batch(qs, 0, b, k=REPEATS)
            lat.append((time.perf_counter() - tq) / QUERY_BATCH * 1e3)
            served.append((b, qs, ids))
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, summary = report_phase(name, rec, lat, "screen_select_quant",
                                     FALLBACK_LIMIT["repeats"], wall)
    X = torch.from_numpy(idx.raw.scan()).to(DEVICE)
    for b, qs, ids in served:
        got = torch.from_numpy(ids).to(DEVICE)
        check_exact(torch, X[: (b + 1) * BATCH_SIZE], qs, got,
                    f"{name} batch {b + 1}", k=REPEATS)
    log(f"{name}: {len(served)} served batches checked against the f64 brute force")
    del idx, X, bases
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def percentile(a, p):
    import numpy as np

    return np.percentile(a, p) if len(a) else float("nan")


def check_exact(torch, Xw, qs, got, what, k=K):
    """The served ids against an f64 brute force over the window (diff
    form, stable order), on the card. Exact f64 ties may swap."""
    Q = torch.from_numpy(qs).to(DEVICE).double()
    Xd = Xw.double()
    d2 = torch.stack([((Xd - Q[i]) ** 2).sum(dim=1) for i in range(Q.shape[0])])
    want = torch.sort(d2, dim=1, stable=True).indices[:, :k]
    if got.shape != want.shape:
        fail(f"{what}: served shape {tuple(got.shape)}, want {tuple(want.shape)}")
    bad = got != want
    if bool(bad.any()):
        tie = torch.gather(d2, 1, got.clamp_min(0)) == torch.gather(d2, 1, want)
        if bool((bad & ~tie).any()):
            fail(f"{what}: {int(bad.sum())} served ids differ from the brute force")


def phase_timing(torch, ops, ref, shapes, worst):
    """Each kernel at the main path's most frequent shape."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1)
    entries = []
    for name in ("screen_select", "screen_select_quant"):
        mine = [(c, key) for key, c in shapes.items() if key[0] == name]
        if not mine:
            fail(f"timing: the main path never called {name}")
        count, (_, m, n, cap, dt, s, gathered) = max(mine)
        dtype = {"float32": "f32", "bfloat16": "bf16", "int8": "int8"}[dt]
        xc = seismic_table(torch, cap, SERIES_LEN, gen, dev)
        table, scale, xn2 = stored(torch, xc, dtype)
        del xc
        rows = (torch.randperm(cap, generator=gen, device=dev)[:n]
                if gathered else None)
        q = table[:m].float() * (1.0 if scale is None else scale[:m, None])
        q = q + 0.01 * torch.randn(q.shape, generator=gen, device=dev)
        case = Case(torch, ops, ref, q.contiguous(), table, scale, xn2, rows, s)
        err, share, _ = case.check()
        worst[name] = max(worst[name], err)
        t = time_case(torch, case)
        bound_ms, bound_by = case.bound()
        log(f"timing: {name} at the main path's shape m={m} n={n} table={cap} "
            f"{dtype} s={s} {'gather' if gathered else 'full'} ({count} calls): "
            + timing_text(t, bound_ms, bound_by) + f", max|delta d2|={err:.3e}")
        entries.append({"name": name, "route": "cuda", "source": KERNEL_SOURCE,
                        "replaces": REPLACES[name], "ms": t["ms"],
                        "call_ms": t["call_ms"], "plain_ms": t["plain_ms"],
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": t["library_ms"],
                        "shape": {"m": m, "n": n, "table_rows": cap, "d": SERIES_LEN,
                                  "dtype": dtype, "s": s, "gather": gathered}})
        del table, scale, xn2, rows, case
        torch.cuda.empty_cache()
    return entries


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's package is not under {SRC}: run from a checkout")
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs an NVIDIA card")
    sys.path.insert(0, str(SRC))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    assert torch.get_float32_matmul_precision() == "highest"
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    log(f"device: {kind}, {torch.cuda.device_count()} visible; nvidia-smi: {smi}; "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}")

    from repro_torch.core.verify_engine import get_engine
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.launch import serve

    t0 = time.perf_counter()
    _build.library()
    spills = [ln.strip() for ln in _build.BUILD_LOG.splitlines()
              if "spill" in ln and not ln.strip().startswith("0 bytes")]
    log(f"build: {time.perf_counter() - t0:.1f}s ({len(spills)} ptxas spill lines "
        "reporting non-zero spills)" if spills else
        f"build: {time.perf_counter() - t0:.1f}s, no register spills")

    worst = phase_kernels(torch, ops, ref)
    engine = get_engine(DEVICE)
    shapes = collections.Counter()
    launches = collections.Counter()
    summary = {}
    for tier, dtype in (("exact", "f32"), ("exact", "int8"), ("approx", "f32")):
        got, summary[f"{tier}-{dtype}"] = phase_serve(
            torch, ops, serve, engine, tier, dtype, shapes)
        launches.update(got)
    got, summary["exact-int8-repeats"] = phase_repeats(torch, ops, engine, shapes)
    launches.update(got)
    for key, c in shapes.most_common(12):
        log(f"serve: main-path call {key} x{c} (traced batches)")
    entries = phase_timing(torch, ops, ref, shapes, worst)
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["max_abs_err"] = worst[e["name"]]
    log(f"serve summary: {json.dumps(summary)}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 was switched on during the run")
    log(f"done in {time.perf_counter() - T_START:.1f}s")
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
