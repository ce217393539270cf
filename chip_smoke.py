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
            table, slates of 13 (k = 5 plus the engine's slack), one kernel
            pass (128) and 200 (two passes). Ids must be equal except
            between candidates whose plain distances lie within the
            engine's certificate bound of each other, and every |delta d2|
            must lie within that bound. The same for topk_ed (batches of 16
            and 64, a 4,096-row pass and the whole table, slates of 13, 128,
            200 and 500), whose bound also covers the norms it sums itself,
            and for min_ed (batches of 16 and 64, the whole table and a
            table of 2^20 - 37 rows, queries equal to a row that has a
            duplicate: the lower row must win), which must also equal
            topk_ed's k = 1 answer.
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
   Phases 5-10 run right after the exact f32 serve phase, on its index.
5. summarize: paa -> sax_pack over the exact f32 phase's 1,024,000 series
            and a query batch: PAA values, symbols and keys bitwise those of
            the plain versions; symbols and keys equal the host
            summarization's except on rows whose PAA lies within the f32
            error of a segment mean of a breakpoint (counted, with a limit).
6. kernel backend: 16 of the exact f32 phase's served (query batch, window)
            pairs asked again of its index with ``backend="kernel"``: every
            answer equals the ids served and the f64 brute force; the
            approximate tier (64 blocks) under ``"kernel"`` and ``"device"``
            returns the same ids for every query whose keys agree. Each
            call launches topk_ed (and paa and sax_pack in the approximate
            tier), counts set to 0 just before it and read just after.
            Every fifth pair runs under the profiler: each mode's device
            busy share, H2D copy time and kernel time (topk_ed_kernel for
            ``"kernel"``); the profiler must see topk_ed_kernel and no
            two-launch kernel where topk_ed launched.
7. long slates: the last served batch asked again at k = 200 (a slate of
            208, two kernel passes) under ``"device"`` and ``"kernel"``:
            ids equal the f64 brute force, and the tier launched its kernel.
8. 1-NN:    ``ops.min_ed`` of every served 16-query batch against all
            1,024,000 raw series: ids equal an f64 brute force except
            between rows within the f32 bound of each other (counted), and
            each answer equals topk_ed's k = 1.
9. pruning front: the last served batch's PAA (``ops.paa``), then
            ``ops.mindist`` against the SAX region of every entry of the
            index's runs and against every block zone map: bitwise the
            plain version, the host's bounds to rtol 1e-5, and every bound
            at or below the f64 squared ED of its entry (of every entry of
            its block) up to f32 slack.
10. ADS+:   an ADSIndex (the reference's defaults, full mode, 8 segments)
            over the same series, exact and approximate 16-query batches
            under ``"device"`` and ``"kernel"``: exact answers equal the f64
            brute force, approximate answers agree across the backends.
11. timing: each kernel at the shape the main path launched it at most
            often (min_ed at the 1-NN phase's, mindist at the pruning
            front's): its device time, its plain version, one PyTorch
            library yardstick (used nowhere in the port) and the least time
            the card could take (its bound); paa and sax_pack also over the
            whole 1,024,000-series set (logged).
12. gateway: run after the serve phases (once the repeating events' index
            is freed) and before the timing phase. ``serve.py --gateway
            --autotune`` (``serve_gateway``, as the command line runs it) at
            full width, three times: BTP, 133 of the 200 ingest batches of
            5,120 seismic series ingested and drained (async ingest, f32
            arenas), the other 67 ingested in the background while
            single-query clients arrive (Poisson) with the reference's
            tenant mix (70% exact, 20% recall-targeted, 10% with
            conflicting recall and latency targets, half of each windowed
            over ingest batches 79-132); top rung 64, a 5 ms deadline, a
            50 ms p99 SLO, k = 5; the first quarter of the clients, at most
            128, are warm-up. The recommender, the autotuner and the
            gateway all run, the engine on the card. The runs: overload
            (2,048 clients at GATEWAY_RATE, which formed batches of 64 need),
            steady (GATEWAY_STEADY_REQUESTS at GATEWAY_STEADY_RATE, a load
            the gateway keeps up with) and traced (the overload with
            GATEWAY_TRACED_REQUESTS clients, its measured requests under the
            profiler: device busy share only). A probe observes each run
            and changes nothing: launch counts are set to 0 when the
            warm-up's reset returns and read after the last answer, split
            between the clients' sub-batches and the tuner's shadow work.
            Each run fails unless every request was answered and accounted,
            no pass signature was new after the warm-up, every exact
            windowed answer equals the f64 brute force over rows
            [79 x 5,120, 133 x 5,120), every exact whole-history answer
            equals the f64 brute force over the rows its pinned epoch held,
            every approximate answer lies inside its window (the
            whole-history ones among its epoch's rows), and every ticket,
            read again after the gateway closed, still holds its answer (an
            error of shadow work after a ticket resolved would replace it).
            The overload run also fails unless formed batches reached the
            top rung and an exact client sub-batch of 9 or more real
            queries launched screen_select. Logged for each run: client
            p50/p95/p99 and queue-wait p99 (the traced run's include the
            profiler's cost), arrival and served rates, shed rate,
            conflicts, batches and flushes, the batch histogram, the
            tuner's counters and fitted profiles, the launches and the wall
            time; for the traced run the device busy share.
13. file storage: run after the gateway and before the timing phase, once
            the exact f32 phase's index is freed. ``serve.py --storage file
            --storage-dir DIR`` (``serve_coconut``, as the command line runs
            it) with the exact f32 phase's flags and seeds, DIR a fresh
            temporary directory that must have 4 GiB free (removed at the
            end): a 1,048,576,000-byte raw file, the runs' files, one
            fsync'd WAL record per ingest batch, rotated at each flush. Fails
            unless every served batch's ids and f32 d2 equal, bit for bit,
            what the exact f32 phase served (so every answer is the f64 brute
            force), screen_select launched in the served calls (probed as in
            phase 4) and the host fallbacks stay under that phase's limit.
            Then the index is closed and dropped, and
            ``StreamingIndex.recover`` reopens DIR on the card: it must hold
            1,024,000 rows, and the last served (query batch, window) pair,
            asked again under ``backend="device"`` and ``"kernel"``, must
            return the served ids, launching screen_select and topk_ed.
            Logged: p50/p95 ms/query beside the exact f32 phase's, the
            measured I/O (raw, run and WAL bytes, manifest commits,
            readahead spans), the recovery time and the phase's wall time.

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
import re
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
ENGINE_COUNTERS = ("calls", "screened", "fallbacks", "arena_bytes", "h2d_bytes",
                   "uploads")

# kernel-phase shapes
TABLE_ROWS = 1 << 20
GATHER_ROWS = 3 << 14
BATCHES_M = (16, 64)

# NVIDIA H100 SXM data sheet: HBM3 rate and dense FP32 (CUDA-core) rate, at
# the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOP_PER_S = 67e12

EPS32 = 2.0 ** -23
SOURCES = {
    "screen_select": "src/repro_torch/kernels/csrc/screen_fused.cu",
    "screen_select_quant": "src/repro_torch/kernels/csrc/screen_fused.cu",
    "topk_ed": "src/repro_torch/kernels/csrc/screen_fused.cu",
    "paa": "src/repro_torch/kernels/csrc/summarize.cu",
    "sax_pack": "src/repro_torch/kernels/csrc/summarize.cu",
    "min_ed": "src/repro_torch/kernels/csrc/screen_fused.cu",
    "mindist": "src/repro_torch/kernels/csrc/lower_bound.cu",
}
REPLACES = {
    "screen_select": "src/repro/kernels/ed_scan_kernel.py:227",
    "screen_select_quant": "src/repro/kernels/ed_scan_kernel.py:279",
    "topk_ed": "src/repro/kernels/ed_scan_kernel.py:184",
    "paa": "src/repro/kernels/paa_kernel.py:28",
    "sax_pack": "src/repro/kernels/sax_pack_kernel.py:43",
    "min_ed": "src/repro/kernels/ed_scan_kernel.py:331",
    "mindist": "src/repro/kernels/lb_kernel.py:30",
}
# the device kernels each wrapper launches, as the profiler names them
DEVICE_KERNELS = {"screen_select": ("screen_dense_kernel",),
                  "screen_select_quant": ("screen_quant_kernel",),
                  "topk_ed": ("topk_ed_kernel",),
                  "paa": ("paa_kernel",), "sax_pack": ("sax_pack_kernel",),
                  "min_ed": ("min_ed_kernel", "min_ed_unpack_kernel"),
                  "mindist": ("mindist_kernel",)}
# topk_ed's two-launch kernels of earlier builds: no phase launches them,
# and the device backend's serving phases launch no topk_ed kernel at all
TWO_LAUNCH_KERNELS = ("screen_partial_kernel", "slate_merge_kernel")
TOPK_PASS_ROWS = 4096  # one kernel-backend pass
# slates longer than one kernel pass (128 entries): the kernel phase's
# screens at 200, topk_ed at 200 and 500; the served batch asked again at k
# = 200 (a slate of 208 with the engine's slack)
LONG_SLATES = (200, 500)
G1_K = 200
# min_ed: planted queries equal to a row that has a duplicate further on, so
# the answer is the lower of two tied rows at a d2 of about 0 (or below)
PLANTED = 4
ODD_ROWS = TABLE_ROWS - 37  # not a whole number of the kernels' 128-row tiles
# kernel backend: served (query batch, window) pairs asked again
KERNEL_BACKEND_PAIRS = 16
# rows whose PAA lies nearer a breakpoint than the f32 error of a segment
# mean may take either symbol: at most this share of the rows (PERF.md)
NEAR_BREAKPOINT_LIMIT = 1e-3
# ADS+: the reference's ADSConfig defaults (leaves of 1,024, full mode) over
# 8-segment summaries (16 segments fan the iSAX root out to 2^16 children of
# ~16 seismic series, so no pass would reach the engine's device floor)
ADS_SEGMENTS = 8
ADS_BUILD_S = 90.0  # host build budget; inserts go in chunks of 2^18 series
ADS_CHUNK = 1 << 18
ADS_BATCHES = 4
# gateway phase: top rung, offered loads (Poisson QPS), clients (the first
# quarter, at most two top rungs, are warm-up), deadline and SLO. The
# overload rate makes formed batches reach the top rung, so that the exact
# sub-batches of a mixed batch hold 9 or more real queries (the engine's
# batch floor); the steady rate is one the gateway keeps up with; the traced
# run repeats the overload, shorter, under the profiler
GATEWAY_RUNG = 64
GATEWAY_RATE = 4000.0
GATEWAY_REQUESTS = 2048
GATEWAY_STEADY_RATE = 40.0
GATEWAY_STEADY_REQUESTS = 512
GATEWAY_TRACED_REQUESTS = 384
GATEWAY_DEADLINE_MS = 5.0
GATEWAY_SLO_MS = 50.0
# file storage phase: free space its directory must have (1 GiB of raw rows,
# the runs' files and a merge's old and new files side by side, with room)
STORE_FREE_BYTES = 4 << 30
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
        return _bound(nbytes, 2.0 * m * self.n * d)


class TopkCase:
    """One topk_ed call: queries against candidate rows taken in order, the
    norms summed by the kernel itself."""

    name = "topk_ed"

    def __init__(self, torch, ops, ref, q, x, s):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.q, self.x, self.s, self.n = q, x, s, x.shape[0]

    def kernel(self):
        return self.ops.topk_ed(self.q, self.x, self.s)

    def plain(self, k=None):
        return self.ref.topk_ed_ref(self.q, self.x, self.s if k is None else k)

    def library(self):
        """The yardstick: norms, one addmm, one topk."""
        torch = self.torch
        xn2 = (self.x * self.x).sum(1)
        d2 = torch.addmm(xn2[None, :], self.q, self.x.T, alpha=-2.0)
        return torch.topk(d2, self.s, dim=1, largest=False)

    def check(self):
        """Hold the kernel against the plain version. Both sum |q|^2, |x|^2
        and <q, x> in f32, in other orders: each d2 lies within
        4 d u (|q| + |x|max)^2 of the exact value."""
        torch = self.torch
        kv, ki = self.kernel()
        pfull, pord = self.plain(self.n)
        torch.cuda.synchronize()
        pv, pi = pfull[:, : self.s], pord[:, : self.s]
        tol = ed_bound(torch, self.q, self.x)[:, None]
        if ki.shape != pi.shape or bool((ki < 0).any()):
            fail(f"topk_ed: slate shape {tuple(ki.shape)} or empty slots")
        err = (kv.double() - pv.double()).abs()
        d2 = torch.empty_like(pfull).scatter_(1, pord.long(), pfull)
        picked = torch.gather(d2, 1, ki.long()).double()
        differ = ki != pi
        if bool((err > tol).any()):
            fail(f"topk_ed: |delta d2| {float(err.max()):.3e} beyond the bound "
                 f"{float(tol.min()):.3e}")
        if bool((differ & ((picked - pv.double()).abs() > tol)).any()):
            fail(f"topk_ed: {int(differ.sum())} ids differ beyond the bound")
        return float(err.max()), float((err / tol).max()), int(differ.sum())

    def bound(self):
        """Each row and query read once, the slate written once; 2 m n d
        flops of products and 2 n d of norms at the FP32 CUDA-core rate."""
        m, d = self.q.shape
        nbytes = 4 * self.n * d + 4 * m * d + 8 * m * self.s
        return _bound(nbytes, 2.0 * m * self.n * d + 2.0 * self.n * d)


class SummarizeCase:
    """One paa or sax_pack call at a batch of series (or of PAA rows)."""

    def __init__(self, torch, ops, ref, name, x, cfg):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.name, self.x, self.cfg = name, x, cfg
        self.bps = ops.breakpoint_table(cfg.card_bits, x.device)

    def kernel(self):
        if self.name == "paa":
            return self.ops.paa(self.x, self.cfg)
        return self.ops.sax_and_keys(self.x, self.cfg)

    def plain(self):
        if self.name == "paa":
            return self.ref.paa_ref(self.x, self.cfg.n_segments)
        return self.ref.sax_pack_ref(self.x, self.bps, self.cfg.card_bits,
                                     self.cfg.key_words)

    def library(self):
        """The yardstick: a view and a mean for PAA; bucketize and shifts
        for SAX-pack."""
        torch, cfg = self.torch, self.cfg
        if self.name == "paa":
            b, n = self.x.shape
            return self.x.view(b, cfg.n_segments, n // cfg.n_segments).mean(-1)
        sym = torch.bucketize(self.x, self.bps, right=True)
        shifts = torch.arange(cfg.card_bits - 1, -1, -1, device=self.x.device)
        bits = ((sym[:, None, :] >> shifts[None, :, None]) & 1).flatten(1)
        bits = torch.nn.functional.pad(bits, (0, 32 * cfg.key_words - bits.shape[1]))
        weights = torch.ones((), dtype=torch.int64, device=self.x.device) << \
            torch.arange(31, -1, -1, device=self.x.device)
        return sym, (bits.view(-1, cfg.key_words, 32) * weights).sum(-1)

    def bound(self):
        """Bound by bytes: each input read once, each output written once."""
        b, cfg = self.x.shape[0], self.cfg
        if self.name == "paa":
            nbytes = 4 * b * self.x.shape[1] + 4 * b * cfg.n_segments
        else:  # symbols int32, key words int64
            nbytes = (4 * b * cfg.n_segments * 2 + 8 * b * cfg.key_words
                      + 4 * self.bps.numel())
        return _bound(nbytes, 0.0)


class MinEdCase:
    """One min_ed call: queries against candidate rows taken in order, the
    norms summed by the kernel itself."""

    name = "min_ed"

    def __init__(self, torch, ops, ref, q, x):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.q, self.x, self.n = q, x, x.shape[0]

    def kernel(self):
        return self.ops.min_ed(self.q, self.x)

    def plain(self):
        return self.ref.min_ed_ref(self.q, self.x)

    def library(self):
        """The yardstick: norms, one addmm, one min (TF32 off)."""
        xn2 = (self.x * self.x).sum(1)
        return self.torch.addmm(xn2[None, :], self.q, self.x.T, alpha=-2.0).min(1)

    def check(self):
        """Hold the kernel against the plain version (topk_ed's bound: both
        sum in f32, in other orders) and against topk_ed's k = 1 answer,
        which is the same arithmetic and must be equal. Returns the largest
        |delta d2|, its share of the bound, the ids swapped within the
        bound and the kernel's answers."""
        torch = self.torch
        kv, ki = self.kernel()
        tv, ti = self.ops.topk_ed(self.q, self.x, 1)
        pfull, pord = self.ref.topk_ed_ref(self.q, self.x, self.n)
        torch.cuda.synchronize()
        pv, pi = pfull[:, 0], pord[:, 0]
        tol = ed_bound(torch, self.q, self.x)
        if ki.shape != pi.shape or bool((ki < 0).any()):
            fail(f"min_ed: answer shape {tuple(ki.shape)} or empty answers")
        if not (torch.equal(ki, ti[:, 0]) and torch.equal(kv, tv[:, 0])):
            fail("min_ed: differs from topk_ed's k = 1 answer")
        err = (kv.double() - pv.double()).abs()
        d2 = torch.empty_like(pfull).scatter_(1, pord.long(), pfull)
        picked = torch.gather(d2, 1, ki.long()[:, None])[:, 0].double()
        differ = ki != pi
        if bool((err > tol).any()):
            fail(f"min_ed: |delta d2| {float(err.max()):.3e} beyond the bound "
                 f"{float(tol.min()):.3e}")
        if bool((differ & ((picked - pv.double()).abs() > tol)).any()):
            fail(f"min_ed: {int(differ.sum())} ids differ beyond the bound")
        return float(err.max()), float((err / tol).max()), int(differ.sum()), (kv, ki)

    def bound(self):
        """Each row and query read once, the answers written once; 2 m n d
        flops of products and 2 n d of norms at the FP32 CUDA-core rate."""
        m, d = self.q.shape
        nbytes = 4 * self.n * d + 4 * m * d + 8 * m
        return _bound(nbytes, 2.0 * m * self.n * d + 2.0 * self.n * d)


class MindistCase:
    """One mindist call: one query PAA against B regions."""

    name = "mindist"

    def __init__(self, torch, ops, ref, q_paa, lo, hi, cfg):
        self.torch, self.ops, self.ref = torch, ops, ref
        self.q, self.lo, self.hi, self.cfg = q_paa, lo, hi, cfg

    def kernel(self):
        return self.ops.mindist(self.q, self.lo, self.hi, self.cfg)

    def plain(self):
        return self.ref.mindist_ref(self.q, self.lo, self.hi, self.cfg.segment_len)

    def library(self):
        """The yardstick: clamp ops and one sum."""
        d = self.torch.maximum((self.lo - self.q).clamp_min(0), (self.q - self.hi).clamp_min(0))
        return (d * d).sum(1) * self.cfg.segment_len

    def bound(self):
        """Bound by bytes: lo and hi read once, the bounds written once; 4 w
        flops a region (two differences, a square and a sum)."""
        b, w = self.lo.shape
        return _bound(8 * b * w + 4 * b + 4 * w, 4.0 * b * w)


def ed_bound(torch, q, x):
    """Per query, the bound on |delta d2| between two f32 evaluations of the
    matmul-form squared ED in any order: 2 x 4 d u (|q| + |x|max)^2."""
    d = q.shape[1]
    qn = (q.double() ** 2).sum(1).sqrt()
    xmax = float((x.double() ** 2).sum(1).max().sqrt())
    return 2.0 * 4.0 * d * EPS32 * (qn + xmax) ** 2


def _bound(nbytes, flops):
    """The larger of bytes over the HBM rate and flops over the FP32 rate,
    in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / FP32_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


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


def kernel_device_ms(torch, fn, reps, names):
    """Device time per launch of the kernels alone (``names``, e.g. min_ed's
    scan and unpack, with its split between them) from the profiler's CUPTI
    trace, averaged over the launches the trace kept. A trace that kept
    none of some kernel's launches (it drops launches of short sessions) is
    taken again with twice the launches, up to three traces; (None, {}) if
    none kept some of each."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        n = reps << attempt
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
        split, kept = {}, {}
        for k in names:
            evs = [e for e in prof.key_averages() if k in e.key
                   and not str(getattr(e, "device_type", "")).endswith("CPU")]
            kept[k] = sum(e.count for e in evs)
            if kept[k]:
                split[k] = sum(e.self_device_time_total for e in evs) / 1e3 / kept[k]
        if min(kept.values()) < n:
            log(f"timing: the trace kept {kept} of {n} launches each")
        if min(kept.values()) > 0:
            return sum(split.values()), split
    return None, {}


def time_case(torch, case, reps=50):
    """kernel (device trace, else events around the wrapper), the wrapper
    call, the plain version and the library yardstick, in ms per call."""
    call_ms = events_ms(torch, case.kernel, reps)
    try:
        dev_ms, split = kernel_device_ms(torch, case.kernel, reps,
                                         DEVICE_KERNELS[case.name])
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
                for s in (K + 8, ops.pass_slate(), LONG_SLATES[0]):
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


def phase_topk_kernels(torch, ops, ref, worst):
    """topk_ed against its plain version: a 4,096-row pass and the whole
    2^20-row seismic table, batches of 16 and 64, slates of 13, one pass
    (128) and several passes (200, 500)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(2)
    xc = seismic_table(torch, TABLE_ROWS, SERIES_LEN, gen, dev)
    rows = torch.randperm(TABLE_ROWS, generator=gen, device=dev)[:TOPK_PASS_ROWS]
    one_pass = xc[rows].contiguous()
    for m in BATCHES_M:
        pick = torch.randint(0, TABLE_ROWS, (m,), generator=gen, device=dev)
        q = xc[pick] + 0.01 * torch.randn((m, SERIES_LEN), generator=gen, device=dev)
        for layout, x in (("pass", one_pass), ("full", xc)):
            for k in (K + 8, ops.pass_slate(), *LONG_SLATES):
                case = TopkCase(torch, ops, ref, q, x, k)
                err, share, ndiff = case.check()
                worst["topk_ed"] = max(worst["topk_ed"], err)
                log(f"kernels: topk_ed f32 m={m} {layout} n={case.n} k={k}: "
                    f"max|delta d2|={err:.3e} ({share:.2e} of the bound), "
                    f"{ndiff} ids swapped within the bound")
    del xc, one_pass


def phase_min_ed_kernels(torch, ops, ref, worst):
    """min_ed against its plain version and topk_ed's k = 1 answer on a
    2^20-row seismic table, the whole table and an n that is not a tile
    multiple, batches of 16 and 64. The first PLANTED queries equal a row
    that has a duplicate further on: the answer must be the lower row, at a
    d2 of about 0 (negative where |q|^2 + |x|^2 rounds below 2 q.x)."""
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(3)
    xc = seismic_table(torch, TABLE_ROWS, SERIES_LEN, gen, dev)
    half = ODD_ROWS // 2
    low = torch.randperm(half, generator=gen, device=dev)[:PLANTED]
    xc[low + half] = xc[low]  # planted ties: row a + half duplicates row a
    for m in BATCHES_M:
        pick = torch.randint(0, TABLE_ROWS, (m,), generator=gen, device=dev)
        q = xc[pick] + 0.01 * torch.randn((m, SERIES_LEN), generator=gen, device=dev)
        q[:PLANTED] = xc[low]
        for layout, x in (("full", xc), ("odd", xc[:ODD_ROWS])):
            case = MinEdCase(torch, ops, ref, q.contiguous(), x)
            err, share, ndiff, (kv, ki) = case.check()
            worst["min_ed"] = max(worst["min_ed"], err)
            if ki[:PLANTED].tolist() != low.tolist():
                fail(f"min_ed m={m} {layout}: planted queries answered "
                     f"{ki[:PLANTED].tolist()}, want the lower rows {low.tolist()}")
            neg = int((kv[:PLANTED] < 0).sum())
            log(f"kernels: min_ed f32 m={m} {layout} n={case.n}: max|delta d2|={err:.3e} "
                f"({share:.2e} of the bound), {ndiff} ids swapped within the bound, "
                f"= topk_ed k=1; planted ties won by the lower row ({neg} of "
                f"{PLANTED} at a negative d2, d2 {[float(v) for v in kv[:PLANTED]]})")
    del xc


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
    kernels = {n: getattr(ops, n) for n in ("screen_select", "screen_select_quant")}
    rec = {"n": 0, "traced": [], "launches": collections.Counter(),
           "traced_launches": collections.Counter(), "engine": collections.Counter(),
           "traced_engine": collections.Counter(), "busy": collections.Counter(),
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
                rec["traced_launches"].update(launches)
            rec["launches"].update(launches)
            delta = {k: engine.stats[k] - before[k] for k in ENGINE_COUNTERS}
            rec["engine"].update(delta)
            if traced:
                rec["traced_engine"].update(delta)

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
    h2d_ms = sum(us for k, us in rec["busy"].items() if "HtoD" in k) / 1e3
    te = rec["traced_engine"]
    log(f"{name}: traced {len(rec['traced'])} of {rec['n']} served batches: device "
        f"busy {busy_s:.4f}s of {rec['traced_s']:.4f}s answering them "
        f"({busy_s / max(rec['traced_s'], 1e-9):.4f}); most device time: {top}; "
        f"H2D {h2d_ms:.2f} ms for the engine's {te['h2d_bytes']} bytes "
        f"({te['uploads']} arena builds or extends)")
    log(f"{name}: {wall:.1f}s, tier launches {launches}, calls={es['calls']}, "
        f"screened={es['screened']}, fallbacks={es['fallbacks']} (share "
        f"{share:.4f}, limit {fallback_limit}), arena_bytes={es['arena_bytes']}, "
        f"ms/query p50={p50:.4f} p95={p95:.4f} over {len(bare)} untraced batches")
    if launches.get(kernel, 0) == 0:
        fail(f"{name}: the serving tier never launched {kernel}")
    # the screens are one launch a pass: the traced calls ran their own
    # device kernel (where they launched the wrapper) and none of topk_ed's
    ran = [k for k in rec["busy"] if any(n in k for n in DEVICE_KERNELS[kernel])]
    if rec["traced_launches"][kernel] > 0 and not ran:
        fail(f"{name}: the profiler saw no {DEVICE_KERNELS[kernel]} in the traced calls")
    if any(n in k for k in rec["busy"]
           for n in DEVICE_KERNELS["topk_ed"] + TWO_LAUNCH_KERNELS):
        fail(f"{name}: the profiler saw a topk_ed kernel in the traced calls")
    if share > fallback_limit:
        fail(f"{name}: {share:.4f} of the screened queries fell back to the host")
    if len(bare) == 0 or not all(math.isfinite(v) for v in lat):
        fail(f"{name}: no untraced batches or non-finite latency")
    return launches, {"p50_ms_per_query": p50, "p95_ms_per_query": p95,
                      "untraced_batches": len(bare), "calls": es["calls"],
                      "screened": es["screened"], "fallbacks": es["fallbacks"],
                      "fallback_share": share, "arena_bytes": es["arena_bytes"],
                      "h2d_bytes": es["h2d_bytes"], "uploads": es["uploads"],
                      "traced_h2d_ms": h2d_ms, "traced_h2d_bytes": te["h2d_bytes"],
                      "seconds": wall, "traced_seconds": rec["traced_s"],
                      "device_busy_seconds": busy_s}


def phase_serve(torch, ops, serve, engine, tier, dtype, shapes, keep=False):
    argv = ["--scheme", "BTP", "--batches", str(BATCHES),
            "--batch-size", str(BATCH_SIZE), "--series-len", str(SERIES_LEN),
            "--query-batch", str(QUERY_BATCH), "--window", str(WINDOW),
            "--k", str(K), "--tier", tier, "--n-blocks", str(N_BLOCKS),
            "--screen-dtype", dtype, "--storage", "model", "--device", DEVICE]
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
    for b, t0b, t1b, qs, ids, _ in out["served"]:
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
    if keep:  # the later phases ask this index again
        return launches, summary, (out, X)
    del out, idx, X
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary, None


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


# ---------------------------------------------------------- file storage
def phase_file_storage(torch, ops, serve, engine, shapes, model_served):
    """The exact f32 phase again on the file backend (docstring phase 13):
    served answers bitwise the model backend's, then recovery on the card."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import StreamingIndex

    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="coconut-smoke-store-")
    try:
        free = shutil.disk_usage(root).free
        log(f"file storage: {root}, {free} bytes free (need {STORE_FREE_BYTES})")
        if free < STORE_FREE_BYTES:
            fail(f"file storage: {root} has {free} bytes free, under {STORE_FREE_BYTES}")
        argv = ["--scheme", "BTP", "--batches", str(BATCHES),
                "--batch-size", str(BATCH_SIZE), "--series-len", str(SERIES_LEN),
                "--query-batch", str(QUERY_BATCH), "--window", str(WINDOW),
                "--k", str(K), "--n-blocks", str(N_BLOCKS), "--screen-dtype", "f32",
                "--storage", "file", "--storage-dir", root, "--device", DEVICE]
        name = "serve exact f32 file storage"
        log(f"{name}: python -m repro_torch.launch.serve {' '.join(argv)}")
        args = serve.build_parser().parse_args(argv)
        t0 = time.perf_counter()
        with probe_tier(torch, ops, engine, "window_knn_batch", shapes) as rec:
            out = serve.serve_coconut(args)
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        lat = [float(v) for v in out["latency_ms"]]
        launches, summary = report_phase(name, rec, lat, "screen_select",
                                         FALLBACK_LIMIT[("exact", "f32")], wall)
        if len(out["served"]) != len(model_served):
            fail(f"{name}: served {len(out['served'])} batches, the model backend "
                 f"{len(model_served)}")
        for (b, t0b, t1b, _, ids, d2), want in zip(out["served"], model_served):
            if (b, t0b, t1b) != want[:3] or not (
                    np.array_equal(ids, want[3])
                    and np.array_equal(d2.view(np.uint32), want[4].view(np.uint32))):
                fail(f"{name} batch {b + 1}: ids or f32 d2 differ from the model "
                     "backend's")
        m = out["measured_io"]
        log(f"{name}: {len(model_served)} served batches bitwise the model "
            f"backend's; measured io {json.dumps(m)}")
        summary["measured_io"] = m
        _, t0b, t1b, qs, served_ids, _ = out["served"][-1]
        idx = out["index"]
        cfg = idx.cfg
        idx.close()
        del out, idx, rec
        gc.collect()
        torch.cuda.empty_cache()
        tr = time.perf_counter()
        idx = StreamingIndex.recover(cfg, root)
        summary["recover_seconds"] = time.perf_counter() - tr
        if idx.raw.n != BATCHES * BATCH_SIZE:
            fail(f"{name}: the recovered raw store holds {idx.raw.n} rows")
        log(f"{name}: recovered {idx.raw.n} rows, {idx.n_partitions} runs, "
            f"in {summary['recover_seconds']:.3f}s")
        for backend, kernel in (("device", "screen_select"), ("kernel", "topk_ed")):
            ops.reset_launches()
            tq = time.perf_counter()
            _, ids, _ = idx.window_knn_batch(qs, t0b, t1b, k=K, backend=backend)
            torch.cuda.synchronize()
            ms = (time.perf_counter() - tq) * 1e3
            got = dict(ops.LAUNCHES)
            launches[kernel] = launches.get(kernel, 0) + got[kernel]
            log(f"{name}: recovered index, backend={backend}: {ms:.1f} ms for "
                f"the last served batch, launches {got}")
            if got[kernel] == 0:
                fail(f"{name}: the recovered index never launched {kernel} "
                     f"under backend={backend!r}")
            if not np.array_equal(ids, served_ids):
                fail(f"{name}: the recovered index answers the last served batch "
                     f"otherwise under backend={backend!r}")
            summary[f"recovered_{backend}_ms"] = ms
        idx.close()
        del idx
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"{name}: phase {summary['phase_seconds']:.1f}s (serving {wall:.1f}s)")
    return launches, summary


# ------------------------------------------------------------ the gateway
@contextlib.contextmanager
def probe_gateway(ops, traced=False):
    """Observe the gateway for one run without changing what it does. When
    the warm-up ends (``reset_slo_window`` returns: the reset waits until
    the dispatcher has accounted the warm-up batches) the launch counts are
    set to 0; from then on each engine call of a sub-batch
    (``_query_group``, on the dispatcher thread) adds its launches to the
    clients' or, inside ``_shadow_work``, to the tuner's shadow work, and
    each client call is recorded with its tier, whether it is windowed, its
    real queries (the padding repeats the first row) and its launches.
    With ``traced`` the measured requests run under the profiler from the
    reset until the gateway closes, which ``serve_gateway`` does once the
    last ticket resolved (device busy share). Every pinned snapshot is kept
    by epoch, and every ticket in submission order beside the time it was
    submitted."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.gateway import Gateway
    from repro_torch.core.streaming import StreamingIndex

    real = {n: getattr(Gateway, n) for n in
            ("_query_group", "_shadow_work", "reset_slo_window", "submit",
             "close")}
    real_pin = StreamingIndex.pin
    rec = {"measuring": False, "in_shadow": False, "tickets": [], "sent": [],
           "snaps": {}, "client": collections.Counter(),
           "shadow": collections.Counter(), "groups": [],
           "busy": collections.Counter(), "traced_s": 0.0}

    def query_group(self, tier, nb, Qg, kk, window, snap):
        before = dict(ops.LAUNCHES)
        try:
            return real["_query_group"](self, tier, nb, Qg, kk, window, snap)
        finally:
            if rec["measuring"]:
                delta = {k: c - before[k] for k, c in ops.LAUNCHES.items()
                         if c != before[k]}
                if rec["in_shadow"]:
                    rec["shadow"].update(delta)
                else:
                    pad = (Qg[1:] == Qg[0]).all(axis=1)[::-1]
                    n_pad = int(pad.argmin()) if not pad.all() else pad.size
                    rec["client"].update(delta)
                    rec["groups"].append((tier, window is not None,
                                          Qg.shape[0] - n_pad, delta))

    def shadow_work(self, *args):
        rec["in_shadow"] = True
        try:
            return real["_shadow_work"](self, *args)
        finally:
            rec["in_shadow"] = False

    def reset_slo_window(self, *args, **kwargs):
        real["reset_slo_window"](self, *args, **kwargs)
        ops.reset_launches()  # counts from 0 for the measured requests
        rec["measuring"] = True
        if traced:
            rec["prof"] = profile(activities=[ProfilerActivity.CPU,
                                              ProfilerActivity.CUDA])
            rec["prof"].__enter__()
            rec["t_traced"] = time.perf_counter()

    def stop_trace():
        prof = rec.pop("prof", None)
        if prof is not None:
            import torch

            torch.cuda.synchronize()
            rec["traced_s"] = time.perf_counter() - rec["t_traced"]
            prof.__exit__(None, None, None)
            rec["busy"] = device_times(prof)

    def close(self, *args, **kwargs):
        stop_trace()
        return real["close"](self, *args, **kwargs)

    def submit(self, q, **kw):
        t0 = time.perf_counter()
        t = real["submit"](self, q, **kw)
        rec["tickets"].append(t)
        rec["sent"].append(t0)
        return t

    @contextlib.contextmanager
    def pin(self):
        with real_pin(self) as snap:
            rec["snaps"][snap.epoch] = snap
            yield snap

    for n, fn in (("_query_group", query_group), ("_shadow_work", shadow_work),
                  ("reset_slo_window", reset_slo_window), ("submit", submit),
                  ("close", close)):
        setattr(Gateway, n, fn)
    StreamingIndex.pin = pin
    try:
        yield rec
    finally:
        stop_trace()
        for n, fn in real.items():
            setattr(Gateway, n, fn)
        StreamingIndex.pin = real_pin


def epoch_ids(snap):
    """The ids an epoch held: its runs' and its unflushed chunks'."""
    import numpy as np

    parts = [r.ids for _, runs in snap.levels for r in runs]
    parts += [c.ids for c in snap.flushing + snap.buffer]
    return np.sort(np.concatenate(parts).astype(np.int64))


def check_gateway_answers(torch, out, snaps):
    """Gates (c)-(e): exact windowed answers against the f64 brute force
    over the window's rows; exact whole-history answers against the f64
    brute force over the rows their pinned epoch held; approximate answers
    inside their window (whole-history ones among their epoch's rows).
    Returns the counts checked."""
    import numpy as np

    idx, Q = out["index"], out["queries"]
    X = torch.from_numpy(idx.raw.scan()).to(DEVICE)
    pre = max(1, (2 * BATCHES) // 3)
    lo, hi = (pre - WINDOW) * BATCH_SIZE, pre * BATCH_SIZE
    groups = collections.defaultdict(list)  # (kind, epoch) -> request numbers
    for i, (kw, r) in enumerate(zip(out["requests"], out["responses"])):
        windowed = "window" in kw
        if windowed and kw["window"] != (pre - WINDOW, pre - 1):
            fail(f"gateway: request {i} asked window {kw['window']}")
        if r.tier_served == "exact":
            groups[("window", 0) if windowed else ("history", r.epoch)].append(i)
        elif windowed:
            if bool(((r.ids < lo) | (r.ids >= hi)).any()):
                fail(f"gateway: approximate answer {i} lies outside its window")
            groups[("approx window", 0)].append(i)
        else:
            groups[("approx", r.epoch)].append(i)
    counts = collections.Counter()
    for (kind, epoch), reqs in sorted(groups.items()):
        counts[kind] += len(reqs)
        if kind == "approx window":
            continue
        if kind == "window":
            rows, base = X[lo:hi], lo
        else:
            if epoch not in snaps:
                fail(f"gateway: no pinned snapshot of epoch {epoch}")
            held = epoch_ids(snaps[epoch])
            if not np.array_equal(held, np.arange(held.size)):
                fail(f"gateway: epoch {epoch} does not hold a prefix of the ids")
            rows, base = X[: held.size], 0
        for j in range(0, len(reqs), GATEWAY_RUNG):
            part = reqs[j:j + GATEWAY_RUNG]
            got = torch.from_numpy(np.stack([out["responses"][i].ids
                                             for i in part])).to(DEVICE) - base
            if kind == "approx":
                if bool(((got < 0) | (got >= rows.shape[0])).any()):
                    fail(f"gateway: an approximate answer of epoch {epoch} "
                         "lies outside the rows it held")
            else:
                check_exact(torch, rows, Q[part], got,
                            f"gateway {kind} exact, epoch {epoch}")
    del X
    return dict(counts)


def gateway_run(torch, ops, serve, name, rate, requests, traced=False):
    """One ``serve.py --gateway --autotune`` run at full width, ``rate`` QPS
    offered and ``requests`` clients (docstring phase 12), gated on (b)-(f).
    Returns the measured requests' launches (clients' and shadow work's)
    and the summary."""
    import numpy as np

    argv = ["--gateway", "--autotune", "--scheme", "BTP",
            "--batches", str(BATCHES), "--batch-size", str(BATCH_SIZE),
            "--series-len", str(SERIES_LEN), "--query-batch", str(GATEWAY_RUNG),
            "--window", str(WINDOW), "--k", str(K),
            "--arrival-rate", str(rate),
            "--deadline-ms", str(GATEWAY_DEADLINE_MS),
            "--slo-p99-ms", str(GATEWAY_SLO_MS),
            "--requests", str(requests), "--screen-dtype", "f32",
            "--device", DEVICE]
    args = serve.build_parser().parse_args(argv)
    what = f"gateway {name}"
    log(f"{what}: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    with probe_gateway(ops, traced=traced) as rec:
        out = serve.serve_gateway(args)
    wall = time.perf_counter() - t0
    # (f): every ticket read again after the gateway closed
    if len(rec["tickets"]) != requests:
        fail(f"{what}: {len(rec['tickets'])} tickets for {requests} requests")
    for i, (t, r) in enumerate(zip(rec["tickets"], out["responses"])):
        if t.result(timeout=0) is not r:
            fail(f"{what}: ticket {i} changed after it resolved")
    st = out["stats"]  # read after the dispatcher stopped
    if len(out["responses"]) != requests or st["served"] != requests or \
            out["index"].raw.n != BATCHES * BATCH_SIZE:
        fail(f"{what}: answered {len(out['responses'])}, accounted "
             f"{st['served']}, ingested {out['index'].raw.n}")
    if out["retraces"] != 0:  # (b)
        fail(f"{what}: {out['retraces']} new pass signatures after the warm-up")
    checked = check_gateway_answers(torch, out, rec["snaps"])  # (c)-(e)
    warm = out["warmup"]
    lat, waits = out["latency_ms"], out["queue_wait_ms"]
    sent = np.array(rec["sent"][warm:])
    done = sent + lat / 1e3  # each answer's time: its submission + latency
    big = [g for g in rec["groups"] if g[0] == "exact" and g[2] >= 9]
    sizes = collections.defaultdict(list)
    for tier, windowed, n, _ in rec["groups"]:
        sizes[f"{tier} {'window' if windowed else 'history'}"].append(n)
    busy, traced_s = rec["busy"], rec["traced_s"]
    tuner = out["tuner"]
    summary = {
        "offered_qps": rate, "requests": requests, "warmup": warm,
        "measured": int(lat.size),
        "arrival_qps": float((lat.size - 1) / max(sent[-1] - sent[0], 1e-9)),
        "served_qps": float(lat.size / max(done.max() - sent[0], 1e-9)),
        "p50_ms": float(np.percentile(lat, 50)),
        "p95_ms": float(np.percentile(lat, 95)),
        "p99_ms": float(np.percentile(lat, 99)),
        "queue_wait_p99_ms": float(np.percentile(waits, 99)),
        "shed_rate": out["shed_rate"], "conflicts": st["conflicts"],
        "batches": st["batches"], "deadline_flushes": st["deadline_flushes"],
        "full_flushes": st["full_flushes"],
        "shed_transitions": st["shed_transitions"],
        "batch_hist": {str(k): v for k, v in sorted(st["batch_hist"].items())},
        "tuner": {k: tuner[k] for k in ("decisions", "explores", "observations",
                                        "probes", "epoch_refits")},
        "client_launches": dict(rec["client"]),
        "shadow_launches": dict(rec["shadow"]),
        "exact_sub_batches_of_9_or_more": len(big),
        "their_screen_select_launches": sum(
            g[3].get("screen_select", 0) for g in big),
        "client_sub_batch_real_queries": {k: sorted(v) for k, v in sizes.items()},
        "checked": checked, "retraces": out["retraces"],
        "epochs_pinned": len(rec["snaps"]), "traced": traced,
        "seconds": wall,
    }
    if traced:
        summary.update({
            "traced_seconds": traced_s,
            "device_busy_seconds": sum(busy.values()) / 1e6,
            "busy_share": sum(busy.values()) / 1e6 / max(traced_s, 1e-9),
            "h2d_ms": sum(us for k, us in busy.items() if "HtoD" in k) / 1e3,
            "screen_dense_kernel_ms": sum(
                us for k, us in busy.items() if "screen_dense_kernel" in k) / 1e3})
        top = ", ".join(f"{k[:48]} {us / 1e3:.1f} ms"
                        for k, us in busy.most_common(4))
        log(f"{what}: traced from the reset to the last answer: device busy "
            f"{summary['device_busy_seconds']:.4f}s of {traced_s:.4f}s (share "
            f"{summary['busy_share']:.4f}); most device time: {top}")
    log(f"{what}: {wall:.1f}s; p50/p95/p99 {summary['p50_ms']:.2f} / "
        f"{summary['p95_ms']:.2f} / {summary['p99_ms']:.2f} ms, queue-wait p99 "
        f"{summary['queue_wait_p99_ms']:.2f} ms over {lat.size} measured requests "
        f"at {rate:.0f} QPS offered ({summary['arrival_qps']:.1f} arrived, "
        f"{summary['served_qps']:.1f} served){' under the profiler' if traced else ''}"
        f"; shed rate {out['shed_rate']:.4f}")
    for label, arms in tuner["profiles"].items():
        log(f"{what}: tuner profile {label}: {json.dumps(arms)}")
    for key, v in summary.items():
        log(f"{what}: {key}: {v}")
    launches = collections.Counter(rec["client"])
    launches.update(rec["shadow"])
    del out, rec
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def phase_gateway(torch, ops, serve):
    """Single-query clients through ``serve.py --gateway --autotune`` on the
    card in three runs (docstring phase 12). Returns the measured requests'
    launches of all three and their summaries."""
    t0 = time.perf_counter()
    launches, summary = collections.Counter(), {}
    got, summary["overload"] = gateway_run(
        torch, ops, serve, "overload", GATEWAY_RATE, GATEWAY_REQUESTS)
    launches.update(got)
    if summary["overload"]["full_flushes"] == 0:
        fail("gateway overload: no formed batch reached the top rung")
    if summary["overload"]["their_screen_select_launches"] == 0:  # (a)
        fail("gateway overload: no exact client sub-batch of 9 or more queries "
             f"launched screen_select (client launches "
             f"{summary['overload']['client_launches']}, "
             f"{summary['overload']['exact_sub_batches_of_9_or_more']} such "
             "sub-batches)")
    got, summary["steady"] = gateway_run(
        torch, ops, serve, "steady", GATEWAY_STEADY_RATE, GATEWAY_STEADY_REQUESTS)
    launches.update(got)
    got, summary["traced"] = gateway_run(
        torch, ops, serve, "traced", GATEWAY_RATE, GATEWAY_TRACED_REQUESTS,
        traced=True)
    launches.update(got)
    summary["seconds"] = time.perf_counter() - t0
    log(f"gateway: three runs in {summary['seconds']:.1f}s")
    return launches, summary


# ------------------------------------------------- the kernel backend's path
@contextlib.contextmanager
def record_shapes(ops, shapes):
    """Count the call shapes of topk_ed, paa and sax_pack while inside."""
    real = {n: getattr(ops, n) for n in ("topk_ed", "paa", "sax_and_keys")}

    def topk(q, x, k):
        shapes[("topk_ed", q.shape[0], x.shape[0], x.shape[1], k)] += 1
        return real["topk_ed"](q, x, k)

    def paa(x, cfg):
        shapes[("paa", x.shape[0], x.shape[1], cfg.n_segments)] += 1
        return real["paa"](x, cfg)

    def sax(p, cfg):
        shapes[("sax_pack", p.shape[0], cfg.n_segments, cfg.card_bits)] += 1
        return real["sax_and_keys"](p, cfg)

    ops.topk_ed, ops.paa, ops.sax_and_keys = topk, paa, sax
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


def timed_call(torch, ops, shapes, fn, trace=None):
    """One query call of the main path: launch counts set to 0 just before
    it and read just after it; returns (ids, ms/query, launches). With
    ``trace`` (a dict), the call runs under the profiler and adds its
    device time by name ("busy"), its wall seconds, its launches and one
    call to it."""
    from torch.profiler import ProfilerActivity, profile

    prof = None
    if trace is not None:
        prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
        prof.__enter__()
    ops.reset_launches()
    t0 = time.perf_counter()
    with record_shapes(ops, shapes):
        _, ids, _ = fn()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if prof is not None:
        prof.__exit__(None, None, None)
        trace.setdefault("busy", collections.Counter()).update(device_times(prof))
        trace.setdefault("launches", collections.Counter()).update(launches)
        trace["seconds"] = trace.get("seconds", 0.0) + wall
        trace["calls"] = trace.get("calls", 0) + 1
    return ids, wall / QUERY_BATCH * 1e3, launches


def report_traced(what, trace, kernel):
    """Log and return a traced mode's device busy share, H2D copy ms and
    device ms of ``kernel``'s own device kernels; fail if the calls launched
    the wrapper and the profiler saw none of them, or saw a two-launch
    topk_ed kernel."""
    busy = trace["busy"]
    busy_s = sum(busy.values()) / 1e6
    own = sum(us for k, us in busy.items() if any(n in k for n in DEVICE_KERNELS[kernel]))
    out = {"calls": trace["calls"], "seconds": trace["seconds"],
           "device_busy_seconds": busy_s, "busy_share": busy_s / trace["seconds"],
           "h2d_ms": sum(us for k, us in busy.items() if "HtoD" in k) / 1e3,
           f"{DEVICE_KERNELS[kernel][0]}_ms": own / 1e3,
           "launches": dict(trace["launches"])}
    top = ", ".join(f"{k[:48]} {us / 1e3:.2f} ms" for k, us in busy.most_common(4))
    log(f"{what}: traced {out['calls']} calls: device busy {busy_s:.4f}s of "
        f"{out['seconds']:.4f}s (share {out['busy_share']:.4f}); H2D {out['h2d_ms']:.2f} "
        f"ms; {DEVICE_KERNELS[kernel][0]} {own / 1e3:.3f} ms over "
        f"{trace['launches'][kernel]} launches; most device time: {top}")
    if trace["launches"][kernel] > 0 and own == 0:
        fail(f"{what}: the profiler saw no {DEVICE_KERNELS[kernel]} in the traced calls")
    if any(n in k for k in busy for n in TWO_LAUNCH_KERNELS):
        fail(f"{what}: the profiler saw a two-launch topk_ed kernel in the traced calls")
    return out


def near_breakpoint_rows(torch, x, p, bps):
    """Rows with a PAA value nearer a breakpoint than the f32 error of a
    segment mean in any summation order, 2 L u mean|x_segment| (u = 2^-24):
    only there may two orders give two symbols."""
    b, w = p.shape
    seg = x.shape[1] // w
    mag = x.abs().view(b, w, seg).mean(-1).double()
    bound = 2.0 * seg * 2.0 ** -24 * mag
    j = torch.searchsorted(bps, p.contiguous())
    last = bps.numel() - 1
    gap = torch.minimum((p.double() - bps[(j - 1).clamp(0, last)].double()).abs(),
                        (p.double() - bps[j.clamp(0, last)].double()).abs())
    return (gap <= bound).any(1)


def check_summarize(torch, ops, ref, X_host, cfg, what):
    """paa -> sax_pack on the card against the plain versions (bitwise) and
    against the host summarization (equal away from the breakpoints)."""
    import numpy as np

    from repro_torch.core.sortable import interleave
    from repro_torch.core.summarization import paa as host_paa, sax_from_paa

    x = torch.from_numpy(np.ascontiguousarray(X_host)).to(DEVICE)
    bps = ops.breakpoint_table(cfg.card_bits, x.device)
    p, sym, keys = ops.summarize(x, cfg)
    pp = ref.paa_ref(x, cfg.n_segments)
    psym, pkeys = ref.sax_pack_ref(pp, bps, cfg.card_bits, cfg.key_words)
    torch.cuda.synchronize()
    if not torch.equal(p.view(torch.int32), pp.view(torch.int32)):
        fail(f"{what}: paa differs from its plain version")
    if not (torch.equal(sym, psym) and torch.equal(keys, pkeys)):
        fail(f"{what}: sax_pack differs from its plain version")
    del pp, psym, pkeys
    hp = host_paa(X_host, cfg)
    hsym = sax_from_paa(hp, cfg)
    hkeys = interleave(hsym, cfg)
    near = near_breakpoint_rows(torch, x, p, bps)
    differ = ((sym != torch.from_numpy(hsym).to(DEVICE)).any(1)
              | (keys != torch.from_numpy(hkeys.astype(np.int64)).to(DEVICE)).any(1))
    rows = x.shape[0]
    n_near, n_differ = int(near.sum()), int(differ.sum())
    limit = max(1, int(NEAR_BREAKPOINT_LIMIT * rows))
    perr = float((p.double() - torch.from_numpy(hp).to(DEVICE).double()).abs().max())
    log(f"{what}: {rows} rows, paa/symbols/keys bitwise the plain versions; "
        f"{n_differ} rows differ from the host summarization, {n_near} rows lie "
        f"within the f32 error of a breakpoint (limit {limit}); max|paa - host "
        f"paa|={perr:.3e}")
    if bool((differ & ~near).any()):
        fail(f"{what}: {int((differ & ~near).sum())} rows away from every "
             "breakpoint differ from the host summarization")
    if n_near > limit:
        fail(f"{what}: {n_near} rows near a breakpoint, limit {limit}")
    return {"rows": rows, "near_breakpoint_rows": n_near,
            "rows_differing_from_host": n_differ, "max_abs_paa_vs_host": perr}


def pct(values):
    return {"p50_ms_per_query": float(percentile(values, 50)),
            "p95_ms_per_query": float(percentile(values, 95)),
            "calls": len(values)}


def phase_kernel_backend(torch, ops, kept, shapes):
    """Ask the exact f32 phase's index again, under backend="kernel": 16 of
    its served (query batch, window) pairs on the exact tier, whose answers
    must be the ids served (and the f64 brute force), and the approximate
    tier under "kernel" and "device", whose ids must agree wherever the
    query's keys do. The device backend runs the same calls beside it.
    Every TRACE_EVERY-th pair runs under the profiler (device busy share,
    H2D copies, the backend's kernel time); the latency percentiles come
    from the other pairs."""
    import numpy as np

    from repro_torch.core import SummarizationConfig
    from repro_torch.core.sortable import interleave
    from repro_torch.core.summarization import paa as host_paa, sax_from_paa

    out, X = kept
    idx, served = out["index"], out["served"]
    cfg = SummarizationConfig(series_len=SERIES_LEN, n_segments=16, card_bits=8)
    pick = np.unique(np.linspace(0, len(served) - 1, KERNEL_BACKEND_PAIRS).round()
                     .astype(int))
    if pick.size < KERNEL_BACKEND_PAIRS:
        fail(f"kernel backend: only {pick.size} served pairs to ask again")
    lat = collections.defaultdict(list)
    traces = collections.defaultdict(dict)
    launches = collections.Counter()
    key_differ = 0
    t0 = time.perf_counter()
    for t, j in enumerate(pick):
        b, t0b, t1b, qs, ids, _ = served[j]
        lo, hi = t0b * BATCH_SIZE, (t1b + 1) * BATCH_SIZE
        what = f"kernel backend batch {b + 1}"
        traced = t % TRACE_EVERY == TRACE_EVERY - 1

        def call(mode, fn):
            got, dt, ln = timed_call(torch, ops, shapes, fn,
                                     traces[mode] if traced else None)
            if not traced:
                lat[mode].append(dt)
            return got, ln

        for backend in ("kernel", "device"):
            got, ln = call(f"exact {backend}", lambda: idx.window_knn_batch(
                qs, t0b, t1b, k=K, backend=backend))
            if backend == "kernel":
                launches.update(ln)
                if ln["topk_ed"] == 0:
                    fail(f"{what}: the exact kernel backend never launched topk_ed")
                if not np.array_equal(got, ids):
                    fail(f"{what}: exact answers differ from the ids served")
                check_exact(torch, X[lo:hi], qs, torch.from_numpy(got).to(DEVICE) - lo,
                            what)
        approx = {}
        for backend in ("kernel", "device"):
            approx[backend], ln = call(f"approx {backend}",
                                       lambda: idx.window_knn_approx_batch(
                                           qs, t0b, t1b, k=K, n_blocks=N_BLOCKS,
                                           backend=backend))
            if backend == "kernel":
                launches.update(ln)
                missing = [n for n in ("topk_ed", "paa", "sax_pack") if ln[n] == 0]
                if missing:
                    fail(f"{what}: the approximate kernel backend never launched "
                         f"{missing}")
        host_keys = interleave(sax_from_paa(host_paa(qs, cfg), cfg), cfg)
        card_keys = ops.keys_to_host(ops.summarize(torch.from_numpy(qs).to(DEVICE),
                                                   cfg)[2])
        same_key = (host_keys == card_keys).all(1)
        key_differ += int((~same_key).sum())
        bad = (approx["kernel"] != approx["device"]).any(1) & same_key
        if bad.any():
            fail(f"{what}: {int(bad.sum())} approximate answers differ between "
                 "the backends for queries with equal keys")
    summary = {f"{mode}": pct(v) for mode, v in lat.items()}
    for mode, trace in traces.items():
        kernel = "topk_ed" if mode.endswith("kernel") else "screen_select"
        summary[f"traced {mode}"] = report_traced(f"kernel backend: {mode}", trace, kernel)
    summary["queries_with_differing_keys"] = key_differ
    summary["pairs"] = int(pick.size)
    summary["launches"] = dict(launches)
    summary["seconds"] = time.perf_counter() - t0
    for mode, v in summary.items():
        log(f"kernel backend: {mode}: {v}")
    return launches, summary


def phase_adsplus(torch, ops, X_host, X, served, shapes):
    """ADS+ over the same series: build on the host within ADS_BUILD_S, then
    exact and approximate 16-query batches under "device" and "kernel"."""
    import numpy as np

    from repro_torch.core import ADSConfig, ADSIndex, SummarizationConfig

    # why not the default 16 segments: the leaves the first 2^18 series give
    wide = ADSIndex(ADSConfig(summarization=SummarizationConfig(
        series_len=SERIES_LEN, n_segments=16, card_bits=8), device=DEVICE))
    m16 = min(ADS_CHUNK, X_host.shape[0])
    wide.insert_batch(X_host[:m16], np.arange(m16))
    n16 = len(wide._flat_blocks(wide._flat()))
    log(f"ADS+ at 16 segments: {m16} series fill {n16} leaves ({m16 / n16:.1f} "
        f"series a leaf, {wide.n_splits} splits): a round of 32 leaves holds "
        f"~{32 * m16 / n16:.0f} candidates, against the engine's device floor of "
        "1,024")
    del wide
    ads = ADSIndex(ADSConfig(summarization=SummarizationConfig(
        series_len=SERIES_LEN, n_segments=ADS_SEGMENTS, card_bits=8), device=DEVICE))
    t0 = time.perf_counter()
    n = 0
    while n < X_host.shape[0] and time.perf_counter() - t0 < ADS_BUILD_S:
        step = min(ADS_CHUNK, X_host.shape[0] - n)
        ads.insert_batch(X_host[n:n + step], np.arange(n, n + step))
        n += step
    build_s = time.perf_counter() - t0
    leaves = len(ads._flat_blocks(ads._flat()))
    log(f"ADS+: inserted {n} of {X_host.shape[0]} series in {build_s:.1f}s "
        f"({ads.n_splits} splits, {leaves} leaves; {ADS_SEGMENTS} segments, "
        f"leaves of {ads.cfg.leaf_size}, {ads.cfg.mode} mode)")
    lat = collections.defaultdict(list)
    launches = collections.Counter()
    per_mode = collections.defaultdict(collections.Counter)
    batches = [served[j][3] for j in np.linspace(0, len(served) - 1, ADS_BATCHES)
               .round().astype(int)]
    # the first device call builds the flat leaf arena: set-up, not latency
    timed_call(torch, ops, shapes, lambda: ads.knn_batch(batches[0], k=K))
    for i, qs in enumerate(batches):
        what = f"ADS+ batch {i + 1}"
        approx = {}
        for backend in ("device", "kernel"):
            got, dt, ln = timed_call(torch, ops, shapes, lambda: ads.knn_batch(
                qs, k=K, backend=backend))
            lat[f"exact {backend}"].append(dt)
            per_mode[f"exact {backend}"].update(ln)
            need = "screen_select" if backend == "device" else "topk_ed"
            if ln[need] == 0:
                fail(f"{what}: the exact tier under {backend} never launched {need}")
            check_exact(torch, X[:n], qs, torch.from_numpy(got).to(DEVICE),
                        f"{what} exact {backend}")
            approx[backend], dt, la = timed_call(
                torch, ops, shapes, lambda: ads.knn_approx_batch(qs, k=K,
                                                                 backend=backend))
            lat[f"approx {backend}"].append(dt)
            per_mode[f"approx {backend}"].update(la)
            if backend == "kernel":
                launches.update(ln)
                launches.update(la)
                if la["topk_ed"] == 0:
                    fail(f"{what}: the approximate kernel backend never launched topk_ed")
        if not np.array_equal(approx["device"], approx["kernel"]):
            fail(f"{what}: approximate answers differ between the backends")
    summary = {mode: pct(v) for mode, v in lat.items()}
    summary.update(series=n, build_seconds=build_s, splits=ads.n_splits, leaves=leaves,
                   leaves_at_16_segments={"series": m16, "leaves": n16},
                   launches={mode: {k: c for k, c in ln.items() if c}
                             for mode, ln in per_mode.items()})
    for mode, v in summary.items():
        log(f"ADS+: {mode}: {v}")
    del ads
    gc.collect()
    torch.cuda.empty_cache()
    return launches, summary


def phase_long_slates(torch, ops, kept):
    """One served exact f32 batch asked again at k = G1_K, a slate longer
    than one kernel pass, under backend="device" and "kernel": the ids must
    equal the f64 brute force, and the tier must have launched its kernel
    (counts set to 0 just before each call and read just after it)."""
    out, X = kept
    idx = out["index"]
    b, t0b, t1b, qs, _, _ = out["served"][-1]
    lo, hi = t0b * BATCH_SIZE, (t1b + 1) * BATCH_SIZE
    summary, launches = {}, collections.Counter()
    for backend, need in (("device", "screen_select"), ("kernel", "topk_ed")):
        what = f"long slates: batch {b + 1} at k={G1_K} under {backend}"
        got, dt, ln = timed_call(torch, ops, collections.Counter(), lambda: (
            idx.window_knn_batch(qs, t0b, t1b, k=G1_K, backend=backend)))
        if ln[need] == 0:
            fail(f"{what}: never launched {need}")
        check_exact(torch, X[lo:hi], qs, torch.from_numpy(got).to(DEVICE) - lo, what,
                    k=G1_K)
        launches.update(ln)
        summary[backend] = {"ms_per_query": dt, "launches": {k: c for k, c in ln.items() if c}}
        log(f"{what}: = f64 brute force, {dt:.4f} ms/query, launches "
            f"{summary[backend]['launches']}")
    return launches, summary


def phase_history_1nn(torch, ops, kept):
    """Exact 1-NN over the whole history: ops.min_ed of every served
    16-query batch against all 1,024,000 raw series on the card. Every id
    equals an f64 brute force (diff form, first minimum) except between
    rows whose f64 distances lie within the f32 bound of each other
    (counted); every answer equals topk_ed's k = 1. Returns the launches,
    the summary and the f64 distances of the last batch's queries."""
    import numpy as np

    out, X = kept
    served = out["served"]
    Q = torch.from_numpy(np.stack([s[3] for s in served])).to(DEVICE)
    ops.reset_launches()  # counts from 0 for this phase's own calls
    t0 = time.perf_counter()
    answers = [ops.min_ed(Q[j], X) for j in range(Q.shape[0])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches["min_ed"] == 0:
        fail("1-NN: min_ed never launched")
    Xd = X.double()
    xmax = float((Xd ** 2).sum(1).max().sqrt())
    near, worst_gap = 0, 0.0
    for j, (kv, ki) in enumerate(answers):
        tv, ti = ops.topk_ed(Q[j], X, 1)
        if not (torch.equal(ki, ti[:, 0]) and torch.equal(kv, tv[:, 0])):
            fail(f"1-NN batch {j + 1}: min_ed differs from topk_ed's k = 1 answer")
        Qd = Q[j].double()
        d2 = torch.stack([((Xd - Qd[i]) ** 2).sum(dim=1) for i in range(Qd.shape[0])])
        want = d2.argmin(dim=1)
        tol = 2.0 * 4.0 * SERIES_LEN * EPS32 * (Qd.norm(dim=1) + xmax) ** 2
        gap = (torch.gather(d2, 1, ki.long()[:, None])[:, 0]
               - torch.gather(d2, 1, want[:, None])[:, 0])
        swapped = ki.long() != want
        if bool((swapped & (gap > tol)).any()):
            fail(f"1-NN batch {j + 1}: {int(swapped.sum())} ids differ from the f64 "
                 "brute force beyond the bound")
        near += int(swapped.sum())
        worst_gap = max(worst_gap, float((gap / tol).max()))
    del Xd
    summary = {"queries": int(Q.shape[0] * Q.shape[1]), "rows": int(X.shape[0]),
               "seconds": wall, "near_ties_swapped": near,
               "max_gap_share_of_bound": worst_gap, "launches": launches["min_ed"]}
    log(f"1-NN over the history: {summary['queries']} queries x {X.shape[0]} series in "
        f"{wall:.4f}s ({launches['min_ed']} min_ed launches); ids = f64 brute force "
        f"except {near} near-ties within the bound; = topk_ed k=1")
    return launches, summary, d2


def phase_pruning_front(torch, ops, ref, kept, ed2):
    """The pruning front of exact search on the exact f32 index: the last
    served batch's PAA from ops.paa on the card, then ops.mindist (a)
    against the SAX region of every entry of the index's runs and (b)
    against every block zone map. Values are bitwise the plain version's and
    agree with the host's mindist_paa_sax2 / mindist_region2 (f64 sums) to
    rtol 1e-5, and every
    bound lies at or below the f64 squared ED (``ed2``, the 1-NN phase's
    brute force of these queries) of its entry, or of every entry of its
    block, up to f32 slack (rtol 1e-5). Returns launches, summary and the
    timing case (the entries' regions)."""
    import numpy as np

    from repro_torch.core import SummarizationConfig
    from repro_torch.core.lower_bounds import mindist_paa_sax2, mindist_region2
    from repro_torch.core.summarization import sax_region

    out, X = kept
    qs = out["served"][-1][3]
    cfg = SummarizationConfig(series_len=SERIES_LEN, n_segments=16, card_bits=8)
    runs = out["index"].lsm.runs_newest_first()
    sym = np.concatenate([r.sax for r in runs]).astype(np.int64)
    ids = torch.from_numpy(np.concatenate([r.ids for r in runs])).to(DEVICE)
    bmin = np.concatenate([r.bmin for r in runs]).astype(np.int64)
    bmax = np.concatenate([r.bmax for r in runs]).astype(np.int64)
    lo, hi = (torch.from_numpy(a).to(DEVICE) for a in sax_region(sym, cfg))
    zlo = torch.from_numpy(sax_region(bmin, cfg)[0]).to(DEVICE)
    zhi = torch.from_numpy(sax_region(bmax, cfg)[1]).to(DEVICE)
    ops.reset_launches()  # counts from 0 for this phase's own calls
    t0 = time.perf_counter()
    qp = ops.paa(torch.from_numpy(qs).to(DEVICE), cfg)
    entry_lb = [ops.mindist(qp[j], lo, hi, cfg) for j in range(qp.shape[0])]
    zone_lb = [ops.mindist(qp[j], zlo, zhi, cfg) for j in range(qp.shape[0])]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    if launches["mindist"] == 0 or launches["paa"] == 0:
        fail(f"pruning front: launches {launches}")
    qp_host = qp.cpu().numpy()
    pruned = 0
    for j in range(qp.shape[0]):
        what = f"pruning front query {j + 1}"
        for name, got, want, a, b in (
                ("entries", entry_lb[j], mindist_paa_sax2(qp_host[j], sym, cfg), lo, hi),
                ("zone maps", zone_lb[j], mindist_region2(qp_host[j], bmin, bmax, cfg),
                 zlo, zhi)):
            plain = ref.mindist_ref(qp[j], a, b, cfg.segment_len)
            if not torch.equal(got.view(torch.int32), plain.view(torch.int32)):
                fail(f"{what}: {name} bounds differ from the plain version's bits")
            want = torch.from_numpy(want).to(DEVICE).double()
            if bool(((got.double() - want).abs() > 1e-5 * want.abs()).any()):
                fail(f"{what}: {name} bounds differ from the host's beyond rtol 1e-5")
        ed = ed2[j][ids.long()]
        if bool((entry_lb[j].double() > ed * (1 + 1e-5)).any()):
            fail(f"{what}: an entry's bound exceeds its squared ED")
        pruned += int((entry_lb[j].double() > ed.min()).sum())
        start = 0
        for run, zl in zip(runs, torch.split(zone_lb[j], [r.n_blocks for r in runs])):
            seg = ed[start:start + run.n]
            start += run.n
            pad = run.n_blocks * run.block_size - run.n
            blk = torch.cat([seg, seg.new_full((pad,), math.inf)]).view(
                run.n_blocks, run.block_size).min(1).values
            if bool((zl.double() > blk * (1 + 1e-5)).any()):
                fail(f"{what}: a zone map's bound exceeds its block's least squared ED")
    summary = {"entries": int(lo.shape[0]), "blocks": int(zlo.shape[0]), "runs": len(runs),
               "queries": int(qp.shape[0]), "seconds": wall,
               "entries_above_the_1nn": pruned / qp.shape[0],
               "launches": {k: c for k, c in launches.items() if c}}
    log(f"pruning front: {summary['queries']} queries x {summary['entries']} entries and "
        f"{summary['blocks']} zone maps of {len(runs)} runs in {wall:.4f}s; = host bounds "
        f"(rtol 1e-5), every bound <= its f64 ED; {pruned / qp.shape[0]:.0f} entries a "
        f"query bound above its 1-NN distance (pruned); launches {summary['launches']}")
    return launches, summary, MindistCase(torch, ops, ref, qp[0].contiguous(), lo, hi, cfg)


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


def timed_entry(torch, case, shape, err, what=""):
    """Time one kernel case (kernel, call, plain, library, bound), log it
    and return its entry of the kernels line."""
    t = time_case(torch, case)
    bound_ms, bound_by = case.bound()
    log(f"timing: {case.name} at {what}{shape}: " + timing_text(t, bound_ms, bound_by)
        + f", max|error|={err:.3e}")
    return {"name": case.name, "route": "cuda", "source": SOURCES[case.name],
            "replaces": REPLACES[case.name], "ms": t["ms"], "call_ms": t["call_ms"],
            "plain_ms": t["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": t["library_ms"], "shape": shape}


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
        entries.append(timed_entry(
            torch, case, {"m": m, "n": n, "table_rows": cap, "d": SERIES_LEN,
                          "dtype": dtype, "s": s, "gather": gathered},
            err, f"the main path's shape ({count} calls) "))
        del table, scale, xn2, rows, case
        torch.cuda.empty_cache()
    for name in ("topk_ed", "paa", "sax_pack"):
        mine = [(c, key) for key, c in shapes.items() if key[0] == name]
        if not mine:
            fail(f"timing: the main path never called {name}")
        count, key = max(mine)
        case, shape = new_kernel_case(torch, ops, ref, key, gen)
        err = case_error(torch, case)
        worst[name] = max(worst[name], err)
        entries.append(timed_entry(torch, case, shape, err,
                                   f"the main path's shape ({count} calls) "))
        if name != "topk_ed":  # and over the whole seismic set
            big = ("paa", BATCHES * BATCH_SIZE, SERIES_LEN, 16) if name == "paa" \
                else ("sax_pack", BATCHES * BATCH_SIZE, 16, 8)
            case, shape = new_kernel_case(torch, ops, ref, big, gen)
            log(f"timing: {name} at {shape}: "
                + timing_text(time_case(torch, case, 20), *case.bound()))
        del case
        torch.cuda.empty_cache()
    return entries


def time_history_kernels(torch, ops, ref, kept, lb_case, worst):
    """min_ed at the 1-NN phase's shape (one served 16-query batch against
    the 1,024,000 series; and 64 queries, logged) and mindist at the
    pruning front's (one query against every entry's region). Returns
    their entries of the kernels line."""
    import numpy as np

    out, X = kept
    served = out["served"]
    entries = []
    for m in (16, 64):
        q = torch.from_numpy(np.concatenate([s[3] for s in served[-(m // QUERY_BATCH):]]))
        case = MinEdCase(torch, ops, ref, q.to(DEVICE).contiguous(), X)
        err = case.check()[0]
        worst["min_ed"] = max(worst["min_ed"], err)
        entry = timed_entry(torch, case, {"m": m, "n": int(X.shape[0]), "d": SERIES_LEN},
                            err, "the 1-NN phase's shape " if m == 16 else "")
        if m == QUERY_BATCH:
            entries.append(entry)
    got, want = lb_case.kernel(), lb_case.plain()
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        fail("mindist: the timing case differs from the plain version's bits")
    worst["mindist"] = max(worst["mindist"], float((got - want).abs().max()))
    b, w = lb_case.lo.shape
    entries.append(timed_entry(torch, lb_case, {"b": int(b), "w": int(w)},
                               worst["mindist"], "the pruning front's shape "))
    return entries


def new_kernel_case(torch, ops, ref, key, gen):
    """A topk_ed, paa or sax_pack call at a recorded shape, on seismic rows."""
    from repro_torch.core import SummarizationConfig

    dev = torch.device(DEVICE)
    if key[0] == "topk_ed":
        _, m, n, d, k = key
        x = seismic_table(torch, n, d, gen, dev).contiguous()
        q = x[:m] + 0.01 * torch.randn((m, d), generator=gen, device=dev)
        return (TopkCase(torch, ops, ref, q.contiguous(), x, k),
                {"m": m, "n": n, "d": d, "k": k})
    if key[0] == "paa":
        _, b, n, w = key
        cfg = SummarizationConfig(series_len=n, n_segments=w, card_bits=8)
        x = seismic_table(torch, b, n, gen, dev).contiguous()
        return SummarizeCase(torch, ops, ref, "paa", x, cfg), {"rows": b, "n": n, "w": w}
    _, b, w, c = key
    cfg = SummarizationConfig(series_len=SERIES_LEN, n_segments=w, card_bits=c)
    p = ref.paa_ref(seismic_table(torch, b, SERIES_LEN, gen, dev), w).contiguous()
    return (SummarizeCase(torch, ops, ref, "sax_pack", p, cfg),
            {"rows": b, "w": w, "card_bits": c, "key_words": cfg.key_words})


def case_error(torch, case):
    """The largest |kernel - plain| of a timing case (d2, PAA values, or
    symbols and key words)."""
    if isinstance(case, TopkCase):
        return case.check()[0]
    got, want = case.kernel(), case.plain()
    torch.cuda.synchronize()
    if case.name == "paa":
        return float((got - want).abs().max())
    return float(max((got[0] - want[0]).abs().max(), (got[1] - want[1]).abs().max()))


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
              if re.search(r"[1-9]\d* bytes spill", ln)]
    log(f"build: {time.perf_counter() - t0:.1f}s ({len(spills)} ptxas spill lines "
        "reporting non-zero spills)" if spills else
        f"build: {time.perf_counter() - t0:.1f}s, no register spills")

    worst = phase_kernels(torch, ops, ref)
    phase_topk_kernels(torch, ops, ref, worst)
    phase_min_ed_kernels(torch, ops, ref, worst)
    engine = get_engine(DEVICE)
    shapes = collections.Counter()
    launches = collections.Counter()
    summary = {}
    got, summary["exact-f32"], kept = phase_serve(
        torch, ops, serve, engine, "exact", "f32", shapes, keep=True)
    launches.update(got)
    # the kernel backend's path, on the exact f32 phase's index and series
    from repro_torch.core import SummarizationConfig

    out, X = kept
    X_host = out["index"].raw.scan()
    scfg = SummarizationConfig(series_len=SERIES_LEN, n_segments=16, card_bits=8)
    summary["summarize-seismic"] = check_summarize(
        torch, ops, ref, X_host, scfg, "summarize: the seismic set")
    summary["summarize-queries"] = check_summarize(
        torch, ops, ref, out["served"][-1][3], scfg, "summarize: a query batch")
    got, summary["kernel-backend"] = phase_kernel_backend(torch, ops, kept, shapes)
    launches.update(got)
    got, summary["long-slates"] = phase_long_slates(torch, ops, kept)
    launches.update(got)
    got, summary["history-1nn"], ed2 = phase_history_1nn(torch, ops, kept)
    launches.update(got)
    got, summary["pruning-front"], lb_case = phase_pruning_front(torch, ops, ref, kept, ed2)
    launches.update(got)
    history_entries = time_history_kernels(torch, ops, ref, kept, lb_case, worst)
    del ed2, lb_case
    got, summary["adsplus"] = phase_adsplus(torch, ops, X_host, X, out["served"],
                                            shapes)
    launches.update({n: c for n, c in got.items() if n == "topk_ed"})
    # what the exact f32 phase served, for the file storage phase
    model_served = [(b, t0b, t1b, ids, d2) for b, t0b, t1b, _, ids, d2 in out["served"]]
    del out, X, X_host, kept
    gc.collect()
    torch.cuda.empty_cache()
    for tier, dtype in (("exact", "int8"), ("approx", "f32")):
        got, summary[f"{tier}-{dtype}"], _ = phase_serve(
            torch, ops, serve, engine, tier, dtype, shapes)
        launches.update(got)
    got, summary["exact-int8-repeats"] = phase_repeats(torch, ops, engine, shapes)
    launches.update(got)
    got, summary["gateway"] = phase_gateway(torch, ops, serve)
    launches.update(got)
    got, summary["exact-f32-file"] = phase_file_storage(torch, ops, serve, engine,
                                                        shapes, model_served)
    launches.update(got)
    del model_served
    log("file storage: ms/query p50/p95 {:.4f}/{:.4f} against the model backend's "
        "{:.4f}/{:.4f}".format(summary["exact-f32-file"]["p50_ms_per_query"],
                               summary["exact-f32-file"]["p95_ms_per_query"],
                               summary["exact-f32"]["p50_ms_per_query"],
                               summary["exact-f32"]["p95_ms_per_query"]))
    for key, c in shapes.most_common(16):
        log(f"main path: call {key} x{c}")
    entries = phase_timing(torch, ops, ref, shapes, worst) + history_entries
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
