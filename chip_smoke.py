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
            events (100 ingest batches, 512,000 series, 20 served batches),
            where the int8 certificate holds, checked the same way.
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
            whole 1,024,000-series set, and topk_ed at the mesh phase's most
            frequent shape (logged); and the launch floor, the device time
            of a one-element elementwise kernel timed the same way (logged,
            and in every kernel's entry).
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

14. mesh:   run after the file storage phase and before the timing phase.
            (a) ``serve.py --shard mesh`` (``serve_coconut``, as the command
            line runs it) with the exact f32 phase's flags and seeds, on the
            one-rank NCCL mesh ``core.distributed`` makes ((1, 1): one card):
            every window's entries gathered, screened by one topk_ed launch a
            (query shard, runs shard) tile, re-ranked in f64 and certified.
            Fails unless the mesh is NCCL's, every one of the 40 served
            batches' ids and f32 d2 equal, bit for bit, the exact f32
            phase's and the f64 brute force over the window, every call
            launched topk_ed (counts set to 0 just before each call and read
            just after it), and the queries that fell back to the host exact
            screen stay under the exact f32 limit. Every fifth call runs
            under the profiler (busy share, H2D ms, topk_ed_kernel ms);
            p50/p95 ms/query come from the others. (b) ``make_build_fn`` /
            ``make_query_fn`` over the same 1,024,000 series on a 1-D
            one-rank mesh (the serving summarization, bucket slack
            MESH_SLACK): overflow 0, every id once among the valid entries,
            the valid keys globally sorted, the build bitwise that of the
            plain versions, paa and sax_pack launched; 16 queries (the last
            served batch) at a verification budget of MESH_VERIFY_BUDGET,
            paa and one mindist a query launched, answers equal to the plain
            versions' path up to f32 rounding, each d2 the f64 distance of
            its id up to f32 rounding, recall@5 against the f64 brute force
            logged; then ``mesh_topk_candidates`` over ``valid_entries`` of
            the build (centered), re-ranked in f64, must be the brute
            force's top 5. The group is torn down after. Logged: the wall
            time of each part and of the phase.
15. lm-serve: run after the mesh phase and before the timing phase; no
            Coconut kernel may launch in it (counts set to 0 at its start and
            read at its end). (a) ``serve.main(["--mode", "lm", "--arch", A])``
            on the card for the 8 archs whose ``serve_lm`` runs in the
            reference: each ``[serve-lm]`` line parsed and logged, every
            logit finite; llava-next-34b and hubert-xlarge must raise the
            reference's KeyError ('patches', 'features': serve_lm passes
            tokens only). (b) smollm-360m at full width (its CONFIG: 32
            layers, d 960, 15 heads, 5 KV heads, hd 64, d_ff 2560, vocab
            49,152; about 409M parameters, made on the card from a generator
            seeded ``--seed``): 16 requests of 4,096 tokens from the same
            generator, ``prefill`` with a cache of 4,096 + 32 slots (the auto
            route takes flash attention, 4 q-chunks), 32 greedy
            ``decode_step``s, timed. Fails unless every logit is finite; the
            prefill's and decode steps 1, 16 and 32's logits equal those of
            ``forward`` over prompt + generated tokens (4,128 tokens, naive
            attention, 4 requests a forward) within 0.35 with the argmax equal
            past twice that margin (LM_LOGIT_TOL); layer 0's flash attention
            at 4,096 tokens is the auto route's output and within 4 x 2^-8
            of the largest |v| of naive attention over the same q/k/v; the
            last 4 steps, run again under the profiler from a rolled-back
            cache, give the same logits; and one 128-token request gives the
            same last-token logits on the card and, the weights moved there,
            on the CPU (LM_LOGIT_TOL). Logged: prefill seconds, decode
            ms/step and tok/s, peak memory of serving and of the check, the
            busy share and device ops a step over the traced steps, each
            difference, and the bounds from the code's shapes: the prefill's
            operations over the dense bf16 rate, a decode step's bytes
            (weights, the K and V caches over all their slots) over the HBM
            rate.
16. lm-train: run after phase 15 and before the timing phase; no Coconut
            kernel may launch in (a)-(c) (counts set to 0 at the start of
            (a) and read at the end of (b); set to 0 again before (c), read
            after). (a) ``train.main([..."--arch", A,
            "--smoke", "--steps", "2", "--global-batch", "4", "--seq-len",
            "64", "--grad-accum", "2", "--device", "cuda"])`` for all ten
            archs, frontends included (the pipeline supplies patches and
            features): every loss and grad norm finite, the parameters moved
            from the seed's init. (b) smollm-360m at full width (409,007,040
            bf16 parameters): 16 sequences of 4,096 tokens a step in two
            microbatches of 8, remat on, warmup 20; 3 steps straight, then 3
            steps with ``--ckpt-dir`` (a fresh temp dir, 12 GiB free
            checked; its step-2 checkpoint is kept for phase 17, which
            removes it), ``--ckpt-every 2 --crash-at 2``, which must exit 17,
            and the relaunch, which must print ``resumed from step 2``: its
            metrics, parameters and AdamW m and v must be the straight
            run's bit for bit, every loss and grad norm finite. The resumed
            run's step runs under a device-only profile.
            (c) the straight run's weights and one 128-token request: loss
            and grad norm on the card and, the weights moved there, on the
            CPU within 0.02 and 2% (TRAIN_LOSS_TOL, TRAIN_GNORM_RTOL). Then
            the pipeline's Coconut hook: ``series_view(batch, 256)`` of
            (b)'s three batches (768 token traces) teed into a
            ``StreamingIndex`` on the card, one window kNN batch of 16
            queries (k = 5) whose distances must be an f64 brute force's and
            whose ids must be its ids away from ties; whether the pass
            reached the device engine is logged. Logged: s/step and tok/s
            over the straight run's last 2 steps beside the step's bound (its
            operations over the dense bf16 rate), the peak memory, the AdamW
            update's ms (CUDA events) beside its bytes over the HBM rate, the
            checkpoint's bytes and save and restore seconds, the busy share,
            device ops a step and top device ops of the traced step, and the
            phase's seconds. Depth cut for the script's time limit: 3 steps
            (was 4) and 2 smoke steps an arch (was 4).

17. lm-sharded: run after phase 16 and before the timing phase; no Coconut
            kernel may launch in (b)-(c). (a) the dry run, CPU work in
            eight niced subprocesses started first, which run beside (b)
            and (c): ``python -m repro_torch.launch.dryrun --arch
            smollm-360m`` for each variant (``--variant baseline``, ``opt``)
            and mesh (``--mesh single``, ``multi``), once with ``--shape
            train_4k`` and once with ``--shape prefill_32k,decode_32k``, the
            baseline single pod's second with ``--coconut`` (the three
            Coconut cells at 2^26 x 256 on (16, 16)); each is rank 0 of a
            "fake" process group of 256 or 512 ranks, its parameters, AdamW
            state, cache and batch ``DTensor``s of fake tensors on the card's
            device type. Fails on a FAIL line, unless every cell was written,
            unless each LM cell's ``args_bytes`` equals the local shard
            bytes of its inputs under the specs (computed here from the
            specs and the shapes), unless ``0 < useful_flops_ratio <=
            1.05``, and unless the single-pod baseline cells hold to the
            reference's own counts (``REF_*``, literals beside the command
            that gave them): decode_32k's memory per device at most 2x and
            its collective bytes within 2x, train_4k's all-reduce bytes at
            most 2x. Logged per cell: memory per device, FLOPs and bytes per
            device, collective bytes by kind, the roofline terms and the
            bottleneck. (b) smollm-360m at full width, phase 16's run (its
            seed, 16 x 4,096 tokens a step in two microbatches, remat,
            warmup 20, 3 total steps), its first 2 steps sharded on a
            one-rank NCCL mesh of shape (1, 1) over ("data", "model"):
            parameters, AdamW state and batch ``DTensor``s placed by
            ``launch/specs.py``, the ``opt`` variant's ZeRO-1 hooks, the
            sharding context installed, deterministic algorithms on as
            ``launch/train.py`` runs. Fails unless the losses and grad norms
            are bit for bit phase 16's first two steps', and every parameter
            and AdamW m and v bit for bit phase 16's step-2 checkpoint. (c)
            the sharded state saved as a checkpoint (every leaf gathered
            whole, rank 0 writing) and restored with ``shardings`` onto the
            mesh: every leaf bitwise, then step 3 on it, whose loss and grad
            norm must be phase 16's step 3's bit for bit. Logged: s/step and
            peak GiB beside phase 16's, the ops run replicated, the
            checkpoint's bytes and seconds.

18. sanitized: run after phase 17 and before the timing phase. The port's
            runtime sanitizer (``repro_torch.analysis.sanitize``: ranked
            registry and engine locks, the engine that already exists
            included, and sealed snapshots and plans) armed in this
            process, then the Coconut main path on the first cell's data:
            ``serve.py`` exact f32 with ``--ingest async`` (flush, external
            sort and merge on the background worker), 20 ingest batches of
            5,120 series of length 256 with a 16-query batch after every
            fifth, then ``serve.py --gateway`` over 12 batches (the last
            third ingested in the background) with 96 clients. Fails on a
            ``SanitizerError`` (an ingest worker's included), on a served
            batch that launched no ``screen_select``, on an exact answer
            that is not the f64 brute force, or on a gateway request left
            unanswered; the sanitizer is disarmed before the timing phase.
            Logged: its launches and seconds.

The profiler sometimes returns a trace with no device record of a call that
ran on the card (F5): every traced check (phases 6, 14 and 16) then traces a
repeat of the call, up to two times, before it fails, and logs how many it
needed.

Then one ``{"kernels": [...]}`` line, the card's ``nvidia-smi`` line, and as
the last line ``{"ok": true, "device": {...}}``. Any failed check exits
non-zero before the last line. f32 products run without TF32 throughout: the
certificate bound holds only for true f32 arithmetic. ``--seed`` (default 0)
seeds the LM phase's weights and prompts.
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
# ingest batches of the repeating events' stream: cut from BATCHES (200) to
# keep the script inside its time limit with phase 18
REPEATS_BATCHES = 100
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
# mesh phase: the distributed build's bucket capacity (slots a shard per
# entry it sends) and the distributed query's verification budget
MESH_SLACK = 2.0
MESH_VERIFY_BUDGET = 4096
# LM phase: the archs whose serve_lm runs in the reference (the two with a
# frontend raise its KeyError: serve_lm passes tokens only), and the
# full-width run of serve.py's default arch
LM_SERVE_ARCHS = ("rwkv6-3b", "smollm-360m", "gemma3-27b", "minicpm3-4b",
                  "granite-20b", "granite-moe-1b-a400m", "deepseek-moe-16b",
                  "recurrentgemma-9b")
LM_FRONTEND_ARCHS = {"llava-next-34b": "patches", "hubert-xlarge": "features"}
LM_ARCH = "smollm-360m"
LM_BATCH = 16  # requests
LM_PROMPT = 4096  # tokens a request: the flash route, 4 q-chunks
LM_DECODE = 32  # greedy steps; the cache holds LM_PROMPT + LM_DECODE slots
LM_CHECK_STEPS = (1, 16, 32)  # decode steps held to the full forward
LM_FORWARD_ROWS = 4  # requests a forward of the check (naive attention at 4,128)
LM_TRACE_STEPS = 4  # decode steps under the profiler
LM_CPU_PROMPT = 128  # the request run on the card and on the CPU
# logits, bf16 against bf16 along another path: tests/test_models.py's bound
LM_LOGIT_TOL = 0.35
# flash against naive attention over the same bf16 q/k/v: each rounds the
# probabilities to bf16 once and the output once (2^-8 relative each), so 4
# units of 2^-8 of the largest |v| bound their difference
LM_FLASH_TOL_ULPS = 4 * 2.0 ** -8
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 (tensor cores), 700 W
# LM training phase: every arch at smoke size through the command line,
# then serve.py's default arch at full width: SHAPES["train_4k"]'s 4,096-token
# sequences, its global batch of 256 cut to 16 (two microbatches of 8),
# remat on, as launch/train.py trains; 3 steps straight, then a crash at step
# 2 after the step-2 checkpoint and a resume (3 steps, and 2 a smoke arch,
# to keep the script inside its time limit with phase 17: that phase holds
# the same run's steps 1-3 again)
TRAIN_SMOKE = ["--smoke", "--steps", "2", "--global-batch", "4", "--seq-len", "64",
               "--grad-accum", "2"]
TRAIN_BATCH = 16
TRAIN_SEQ = 4096
TRAIN_ACCUM = 2
TRAIN_STEPS = 3
TRAIN_CRASH = 2  # == --ckpt-every: the crash follows the step-2 checkpoint
TRAIN_WARMUP = 20
TRAIN_TRACE_STEPS = 2  # steps after the runs, under the profiler
TRAIN_CPU_TOKENS = 128  # the request whose loss and grad norm the CPU computes too
# card against CPU in bf16: the loss (3x the bf16 loss gap between the two
# packages on the CPU, <= 0.0060, tests/test_torch_train.py) and the grad
# norm, relative
TRAIN_LOSS_TOL = 0.02
TRAIN_GNORM_RTOL = 0.02
# two checkpoints of ~4.1 GB side by side (phase 16's step 2, kept for phase
# 17, and phase 17's), with room
CKPT_FREE_BYTES = 12 << 30
# the dry run's cells: smollm-360m's three shapes on both meshes in both
# variants, in eight subprocesses (a (variant, mesh)'s train_4k cell in one,
# its prefill_32k and decode_32k in another), the Coconut cells with the
# baseline single pod's; a train_4k or prefill_32k cell traces in about a
# minute on the card machine's host, a decode cell in seconds (PERF.md)
DRYRUN_RUNS = tuple((variant, mesh, shapes, (variant, mesh, shapes) == (
    "baseline", "single", "prefill_32k,decode_32k"))
    for variant in ("baseline", "opt") for mesh in ("single", "multi")
    for shapes in ("train_4k", "prefill_32k,decode_32k"))
DRYRUN_TIMEOUT = 600  # seconds for the dry-run subprocesses
# the reference's own counts of smollm-360m's single-pod baseline cells, per
# device, which phase 17(a) holds the port's to (within 2x; the memory from
# above only: the reference's adds XLA's CPU temporaries of the whole cache).
# Each from `PYTHONPATH=src JAX_PLATFORMS=cpu python -m repro.launch.dryrun
# --arch smollm-360m --mesh single --shape <cell> --out DIR` (jax 0.4, CPU).
REF_DECODE_32K_TOTAL_GB = 2.418  # --shape decode_32k: mem_per_device.total_gb
REF_DECODE_32K_COLLECTIVE_BYTES = 73_625_600.0  # --shape decode_32k
REF_TRAIN_4K_ALL_REDUCE_BYTES = 67_510_106_216.0  # --shape train_4k
# phase 18, the sanitized run: ingest batches with a 16-query batch after
# every fifth, then a gateway run ingesting the last third in the background
SANITIZED_BATCHES = 20
SANITIZED_GATEWAY_BATCHES = 12
SANITIZED_GATEWAY_WINDOW = 6
SANITIZED_REQUESTS = 96
RETRACES = 2  # repeats traced when a trace came back with no device record
HOOK_SERIES_LEN = 256  # series_view's length for the Coconut hook
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
def probe_tier(torch, ops, engine, method, shapes, mesh=False):
    """Wrap the serving tier's query method of ``StreamingIndex`` (and only
    it) for one phase. Around each call: the launch counts are set to 0 just
    before it and read just after it (kept per call in ``calls``), and the
    engine's counters are read before and after, so a recall oracle that
    runs the other tier counts for nothing. Every TRACE_EVERY-th call also
    runs under the profiler, which gives the device's busy share, and
    records the screens' call shapes; the other calls run bare and are the
    ones the latency percentiles use. With ``mesh`` (``--shard mesh``, which
    screens through topk_ed and leaves the engine alone), every call records
    topk_ed's call shapes, and the queries that fall back to the host exact
    screen (``execute._screen_topk_exact``) are counted."""
    import importlib

    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.streaming import StreamingIndex

    # the module (``repro_torch.core`` re-exports its function ``execute``)
    execute = importlib.import_module("repro_torch.core.execute")
    real, real_exact = getattr(StreamingIndex, method), execute._screen_topk_exact
    kernels = {n: getattr(ops, n) for n in ("screen_select", "screen_select_quant")}
    rec = {"n": 0, "traced": [], "calls": [], "launches": collections.Counter(),
           "traced_launches": collections.Counter(), "engine": collections.Counter(),
           "traced_engine": collections.Counter(), "busy": collections.Counter(),
           "traced_s": 0.0, "fallback_queries": 0}

    def exact(Q, data, k):
        rec["fallback_queries"] += int(Q.shape[0])
        return real_exact(Q, data, k)

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
            rec["repeat"] = lambda: real(self, *args, **kwargs)
            for n in kernels:
                setattr(ops, n, recorder(n))
            prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
            prof.__enter__()
            t0 = time.perf_counter()
        ops.reset_launches()  # counts from 0 for this call of the main path
        try:
            with record_shapes(ops, shapes) if mesh else contextlib.nullcontext():
                return real(self, *args, **kwargs)
        finally:
            launches = dict(ops.LAUNCHES)
            rec["calls"].append(launches)
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
    if mesh:
        execute._screen_topk_exact = exact
    try:
        yield rec
    finally:
        setattr(StreamingIndex, method, real)
        execute._screen_topk_exact = real_exact
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
    bases = seismic(REPEATS_BATCHES * per, SERIES_LEN, seed=7, quake_frac=1.0)
    idx = StreamingIndex(StreamConfig(
        scheme="BTP", summarization=SummarizationConfig(
            series_len=SERIES_LEN, n_segments=16, card_bits=8),
        buffer_entries=4096, growth_factor=4, block_size=512,
        screen_dtype="int8", device=DEVICE))
    lat, served = [], []
    t0 = time.perf_counter()
    with probe_tier(torch, ops, engine, "window_knn_batch", shapes) as rec:
        for b in range(REPEATS_BATCHES):
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


# ------------------------------------------------------------------- the mesh
@contextlib.contextmanager
def plain_versions(ops, ref):
    """The kernel wrappers the distributed module calls, replaced by their
    plain versions (run on the same card tensors) while inside."""
    real = {n: getattr(ops, n) for n in ("paa", "sax_and_keys", "mindist", "topk_ed")}
    ops.paa = lambda x, cfg: ref.paa_ref(x, cfg.n_segments)
    ops.sax_and_keys = lambda p, cfg: ref.sax_pack_ref(
        p, ops.breakpoint_table(cfg.card_bits, p.device), cfg.card_bits, cfg.key_words)
    ops.mindist = lambda q, lo, hi, cfg: ref.mindist_ref(q, lo, hi, cfg.segment_len)
    ops.topk_ed = lambda q, x, k: ref.topk_ed_ref(q, x, min(k, x.shape[0]))
    try:
        yield
    finally:
        for n, fn in real.items():
            setattr(ops, n, fn)


def keys_sorted(torch, keys):
    """Whether the (N, nw) key words are in lexicographic order, on the card."""
    if keys.shape[0] < 2:
        return True
    d = keys[1:] - keys[:-1]
    first = (d != 0).int().argmax(1, keepdim=True)  # first differing word (0 if none)
    return bool((d.gather(1, first) >= 0).all())


def phase_mesh(torch, ops, ref, serve, engine, model_served):
    """(a) ``serve.py --shard mesh`` with the exact f32 phase's flags and
    seeds on a one-rank NCCL mesh: every served batch bitwise the exact f32
    phase's and the f64 brute force, topk_ed launched in every call, host
    fallbacks counted under a limit; (b) the distributed build and query
    (``make_build_fn`` / ``make_query_fn``) on the same series, held to the
    plain versions on the card (each query's mindist bit for bit at the
    query's own regions, whose zero bounds are counted), the f64 distances
    of their ids and the brute force; and ``mesh_topk_candidates`` over ``valid_entries`` of the
    build, re-ranked in f64, equal to the brute force (docstring phase 14).
    Returns (launches, summary, the mesh path's topk_ed shape)."""
    import numpy as np

    from repro_torch.core import SummarizationConfig, distributed
    from repro_torch.core.execute import _rerank_slate

    t_phase = time.perf_counter()
    launches = collections.Counter()
    summary = {}
    mesh_shapes = collections.Counter()
    argv = ["--scheme", "BTP", "--batches", str(BATCHES),
            "--batch-size", str(BATCH_SIZE), "--series-len", str(SERIES_LEN),
            "--query-batch", str(QUERY_BATCH), "--window", str(WINDOW),
            "--k", str(K), "--n-blocks", str(N_BLOCKS), "--screen-dtype", "f32",
            "--storage", "model", "--shard", "mesh", "--device", DEVICE]
    name = "serve exact f32 mesh"
    log(f"{name}: python -m repro_torch.launch.serve {' '.join(argv)}")
    args = serve.build_parser().parse_args(argv)
    t0 = time.perf_counter()
    with probe_tier(torch, ops, engine, "window_knn_batch", mesh_shapes, mesh=True) as rec:
        out = serve.serve_coconut(args)
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    mesh = distributed.default_batch_mesh(DEVICE)
    import torch.distributed as dist

    log(f"{name}: mesh {dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))} on "
        f"{dist.get_backend()}, world size {dist.get_world_size()}")
    if dist.get_backend() != ("nccl" if DEVICE == "cuda" else "gloo") or tuple(
            mesh.mesh.shape) != (1, 1):
        fail(f"{name}: the mesh is not a one-rank NCCL mesh")
    calls = rec["calls"]
    if len(calls) != len(model_served) or len(out["served"]) != len(model_served):
        fail(f"{name}: {len(calls)} probed calls, {len(out['served'])} served batches, "
             f"the exact f32 phase {len(model_served)}")
    no_kernel = [i for i, c in enumerate(calls) if c.get("topk_ed", 0) == 0]
    if no_kernel:
        fail(f"{name}: served calls {no_kernel} launched no topk_ed")
    for c in calls:
        launches.update(c)
    idx = out["index"]
    X = torch.from_numpy(idx.raw.scan()).to(DEVICE)
    for (b, t0b, t1b, qs, ids, d2), want in zip(out["served"], model_served):
        if (b, t0b, t1b) != want[:3] or not (
                np.array_equal(ids, want[3])
                and np.array_equal(d2.view(np.uint32), want[4].view(np.uint32))):
            fail(f"{name} batch {b + 1}: ids or f32 d2 differ from the exact f32 phase's")
        lo, hi = t0b * BATCH_SIZE, (t1b + 1) * BATCH_SIZE
        check_exact(torch, X[lo:hi], qs, torch.from_numpy(ids).to(DEVICE) - lo,
                    f"{name} batch {b + 1}")
    queries = len(calls) * QUERY_BATCH
    share = rec["fallback_queries"] / queries
    traced = set(rec["traced"])
    lat = [float(v) for i, v in enumerate(out["latency_ms"]) if i not in traced]
    summary["serve"] = {
        "p50_ms_per_query": float(percentile(lat, 50)),
        "p95_ms_per_query": float(percentile(lat, 95)), "untraced_batches": len(lat),
        "fallback_queries": rec["fallback_queries"], "fallback_share": share,
        "launches": dict(launches), "seconds": wall,
        "traced": report_traced(name, {"busy": rec["busy"], "seconds": rec["traced_s"],
                                       "launches": rec["traced_launches"],
                                       "calls": len(rec["traced"])}, "topk_ed",
                                lambda: trace_device(torch, ops, rec["repeat"]))}
    log(f"{name}: {len(calls)} served batches bitwise the exact f32 phase's and the "
        f"f64 brute force; topk_ed launched in every call ({launches['topk_ed']} in all); "
        f"{rec['fallback_queries']} of {queries} queries fell back to the host screen "
        f"(share {share:.4f}, limit {FALLBACK_LIMIT[('exact', 'f32')]}); ms/query "
        f"p50={summary['serve']['p50_ms_per_query']:.4f} "
        f"p95={summary['serve']['p95_ms_per_query']:.4f} over {len(lat)} untraced "
        f"batches; {wall:.1f}s")
    if share > FALLBACK_LIMIT[("exact", "f32")]:
        fail(f"{name}: {share:.4f} of the queries fell back to the host screen")
    qs = out["served"][-1][3]
    del out, idx
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the distributed build and query on the same series, one rank
    name = "distributed build and query"
    n_rows = X.shape[0]
    scfg = SummarizationConfig(series_len=SERIES_LEN, n_segments=16, card_bits=8)
    dcfg = distributed.DistBuildConfig(summarization=scfg, capacity_slack=MESH_SLACK)
    mesh1 = distributed.make_mesh((1,), ("data",), DEVICE)
    build = distributed.make_build_fn(mesh1, ("data",), dcfg)
    query = distributed.make_query_fn(mesh1, ("data",), dcfg, k=K,
                                      verify_budget=MESH_VERIFY_BUDGET)
    ids = torch.arange(n_rows, dtype=torch.int32, device=DEVICE)
    ops.reset_launches()  # counts from 0 for the build
    t0 = time.perf_counter()
    built = build(X, ids)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    launches.update(got)
    if got["paa"] == 0 or got["sax_pack"] == 0:
        fail(f"{name}: the build launched {got}")
    inval = built["invalid"] == 0
    overflow, n_valid = int(built["overflow"]), int(built["n_valid"].sum())
    if overflow != 0 or n_valid != n_rows:
        fail(f"{name}: overflow {overflow}, {n_valid} valid entries of {n_rows}")
    if not keys_sorted(torch, built["keys"][inval]):
        fail(f"{name}: the valid keys are not globally sorted")
    if not torch.equal(torch.sort(built["ids"][inval]).values, ids):
        fail(f"{name}: the valid ids are not the {n_rows} series, each once")
    with plain_versions(ops, ref):
        plain = build(X, ids)
    for key, t in built.items():
        if not torch.equal(t, plain[key]):
            fail(f"{name}: the build's {key} differ from the plain versions'")
    del plain
    log(f"{name}: built {n_rows} series on {dcfg} in {build_s:.2f}s "
        f"({built['invalid'].shape[0]} slots), launches {got}; overflow 0, every id once, "
        "keys globally sorted, bitwise the plain versions' build")
    Q = torch.from_numpy(qs).to(DEVICE)
    ops.reset_launches()  # counts from 0 for the query
    t0 = time.perf_counter()
    d2, qids = query(built, Q)
    torch.cuda.synchronize()
    query_s = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    launches.update(got)
    if got["paa"] == 0 or got["mindist"] != Q.shape[0]:
        fail(f"{name}: the query launched {got}")
    with plain_versions(ops, ref):
        pd2, pids = query(built, Q)
    torch.cuda.synchronize()
    # ids equal except between candidates whose d2 lie within f32 rounding
    rtol = (SERIES_LEN + 4) * EPS32
    differ = qids != pids
    if bool(((d2 - pd2).abs() > rtol * pd2.abs()).any()):
        fail(f"{name}: the query differs from the plain versions' path")
    # the pruning front at the query's own inputs: each query's mindist
    # against every region of the build (open edges at -+1e30), bit for bit
    # the plain version on the same card tensors; the share of zero bounds
    # among the valid regions (a zero bound prunes nothing, and the top V by
    # bound fall to key order) and of symbols at the outer edges
    lo, hi = distributed.sax_regions(built["sym"], scfg)
    qp = ops.paa(Q, scfg)
    zero = 0
    for i in range(Q.shape[0]):
        kb = ops.mindist(qp[i].contiguous(), lo, hi, scfg)
        pb = ref.mindist_ref(qp[i].contiguous(), lo, hi, scfg.segment_len)
        if not torch.equal(kb.view(torch.int32), pb.view(torch.int32)):
            fail(f"{name}: query {i}'s mindist over the build's {lo.shape[0]} regions "
                 "differs from the plain version's")
        zero += int((kb[inval] == 0).sum())
    zero_share = zero / (Q.shape[0] * n_valid)
    vsym = built["sym"][inval]
    edge_share = float(((vsym == 0) | (vsym == (1 << scfg.card_bits) - 1)).float().mean())
    bps = ops.breakpoint_table(scfg.card_bits, qp.device)
    q_edge = float(((qp < bps[0]) | (qp >= bps[-1])).float().mean())
    del lo, hi, vsym
    log(f"{name}: mindist at the query's own inputs ({Q.shape[0]} queries x "
        f"{built['sym'].shape[0]} regions) bitwise the plain version's; zero bounds "
        f"{zero_share:.4f} of the valid regions; symbols at the outer edges: "
        f"{edge_share:.4f} of the entries', {q_edge:.4f} of the queries'")
    Xd = X.double()
    Qd = Q.double()
    via = ((Xd[qids.long()] - Qd[:, None, :]) ** 2).sum(-1)
    err = float(((d2.double() - via).abs() / via.clamp_min(1e-30)).max())
    if err > rtol:
        fail(f"{name}: a returned d2 is {err:.3e} from the f64 distance of its id")
    full = torch.stack([((Xd - Qd[i]) ** 2).sum(1) for i in range(Q.shape[0])])
    want = torch.sort(full, dim=1, stable=True).indices[:, :K]
    hits = sum(len(set(a.tolist()) & set(b.tolist()))
               for a, b in zip(qids.long().cpu(), want.cpu()))
    recall = hits / want.numel()
    log(f"{name}: {Q.shape[0]} queries at V={MESH_VERIFY_BUDGET} in {query_s * 1e3:.1f} ms, "
        f"launches {got}; answers equal the plain versions' path ({int(differ.sum())} ids "
        f"differ within f32 rounding); max rel |d2 - f64 d2 of its id| {err:.3e} (limit "
        f"{rtol:.3e}); recall@{K} against the f64 brute force {recall:.4f}")
    del Xd, via
    series_v, gids_v = distributed.valid_entries(built)
    del built
    gc.collect()
    torch.cuda.empty_cache()
    mu = series_v.mean(axis=0)
    ops.reset_launches()  # counts from 0 for the mesh screen
    t0 = time.perf_counter()
    with record_shapes(ops, mesh_shapes):
        _, rows = distributed.mesh_topk_candidates(qs - mu, series_v - mu, K + 8,
                                                   device=DEVICE)
    screen_s = time.perf_counter() - t0
    got = dict(ops.LAUNCHES)
    launches.update(got)
    if got["topk_ed"] == 0:
        fail(f"{name}: mesh_topk_candidates launched no topk_ed")
    nv, nrows = _rerank_slate(qs, series_v, rows, K)
    sel = torch.from_numpy(gids_v[nrows]).to(DEVICE)
    bad = sel != want
    if bool(bad.any()):  # exact f64 ties may swap
        tie = torch.gather(full, 1, sel.clamp_min(0)) == torch.gather(full, 1, want)
        if bool((bad & ~tie).any()):
            fail(f"{name}: mesh_topk_candidates over the build's valid entries, "
                 "re-ranked in f64, differs from the brute force")
    log(f"{name}: mesh_topk_candidates over the {series_v.shape[0]} valid entries in "
        f"{screen_s * 1e3:.1f} ms, launches {got}; re-ranked in f64: the brute force's "
        f"top {K}")
    summary["build"] = {"seconds": build_s, "query_ms": query_s * 1e3,
                        "recall_at_k": recall, "max_rel_d2_err": err,
                        "ids_differing_from_plain": int(differ.sum()),
                        "zero_bound_share": zero_share, "edge_symbol_share": edge_share,
                        "query_edge_symbol_share": q_edge,
                        "mesh_screen_ms": screen_s * 1e3}
    del X, full, want, series_v
    distributed.teardown()
    gc.collect()
    torch.cuda.empty_cache()
    summary["launches"] = dict(launches)
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"mesh: phase {summary['phase_seconds']:.1f}s (serving {wall:.1f}s), "
        f"launches {dict(launches)}")
    top = max((c, key) for key, c in mesh_shapes.items() if key[0] == "topk_ed")[1]
    return launches, summary, top


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


def check_gateway_answers(torch, out, snaps, batches=BATCHES, window=WINDOW):
    """Gates (c)-(e): exact windowed answers against the f64 brute force
    over the window's rows; exact whole-history answers against the f64
    brute force over the rows their pinned epoch held; approximate answers
    inside their window (whole-history ones among their epoch's rows).
    ``batches`` and ``window``: the run's ``--batches`` and ``--window``.
    Returns the counts checked."""
    import numpy as np

    idx, Q = out["index"], out["queries"]
    X = torch.from_numpy(idx.raw.scan()).to(DEVICE)
    pre = max(1, (2 * batches) // 3)
    first = max(0, pre - window)
    lo, hi = first * BATCH_SIZE, pre * BATCH_SIZE
    groups = collections.defaultdict(list)  # (kind, epoch) -> request numbers
    for i, (kw, r) in enumerate(zip(out["requests"], out["responses"])):
        windowed = "window" in kw
        if windowed and kw["window"] != (first, pre - 1):
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


def trace_device(torch, ops, fn):
    """One call of ``fn`` under a device-only profile, in the form
    ``report_traced`` reads: device time by name (microseconds), the number
    of device ops, the wrappers' launches, the wall seconds and one call.
    The profiler's raw records are read as they come: a training step runs
    ~10^5 device ops, and building the profiler's Python events for them
    (``key_averages``) takes a minute."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    before = dict(ops.LAUNCHES)
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    busy = collections.Counter()
    n_ops = 0
    for e in prof.profiler.kineto_results.events():
        if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0:
            busy[e.name()] += e.duration_ns() / 1e3
            n_ops += 1
    launches = collections.Counter({k: v - before[k] for k, v in ops.LAUNCHES.items()})
    return {"busy": busy, "ops": n_ops, "launches": launches, "seconds": wall, "calls": 1}


def retraced(what, trace, seen, retrace):
    """The profiler sometimes returns no device records (F5): while
    ``seen(trace)`` is false, trace one repeat of the call (``retrace()``
    gives its trace), up to RETRACES times. Returns the trace that saw it
    (or the last one) and the number of repeats traced; the caller fails if
    the last one still did not see it."""
    n = 0
    while not seen(trace) and retrace is not None and n < RETRACES:
        n += 1
        log(f"{what}: the trace holds no device record of the call: tracing a "
            f"repeat ({n} of {RETRACES})")
        trace = retrace()
    return trace, n


def report_traced(what, trace, kernel, retrace=None):
    """Log and return a traced mode's device busy share, H2D copy ms and
    device ms of ``kernel``'s own device kernels; fail if the calls launched
    the wrapper and the profiler saw none of them after up to RETRACES
    traced repeats of a call (``retrace``), or saw a two-launch topk_ed
    kernel."""
    def own_us(t):
        return sum(us for k, us in t["busy"].items()
                   if any(n in k for n in DEVICE_KERNELS[kernel]))

    trace, n_retraced = retraced(
        what, trace, lambda t: t["launches"][kernel] == 0 or own_us(t) > 0, retrace)
    busy = trace["busy"]
    busy_s = sum(busy.values()) / 1e6
    own = own_us(trace)
    out = {"calls": trace["calls"], "seconds": trace["seconds"],
           "device_busy_seconds": busy_s, "busy_share": busy_s / trace["seconds"],
           "h2d_ms": sum(us for k, us in busy.items() if "HtoD" in k) / 1e3,
           f"{DEVICE_KERNELS[kernel][0]}_ms": own / 1e3,
           "launches": dict(trace["launches"]), "retraces": n_retraced}
    top = ", ".join(f"{k[:48]} {us / 1e3:.2f} ms" for k, us in busy.most_common(4))
    log(f"{what}: traced {out['calls']} calls: device busy {busy_s:.4f}s of "
        f"{out['seconds']:.4f}s (share {out['busy_share']:.4f}); H2D {out['h2d_ms']:.2f} "
        f"ms; {DEVICE_KERNELS[kernel][0]} {own / 1e3:.3f} ms over "
        f"{trace['launches'][kernel]} launches; most device time: {top}; "
        f"{n_retraced} repeats re-traced")
    if trace["launches"][kernel] > 0 and own == 0:
        fail(f"{what}: the profiler saw no {DEVICE_KERNELS[kernel]} in the traced calls "
             f"({n_retraced} repeats re-traced)")
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
    repeat = {}  # mode -> its last traced call
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
            if traced:
                repeat[mode] = fn
            else:
                lat[mode].append(dt)
            return got, ln

        for backend in ("kernel", "device"):
            got, ln = call(f"exact {backend}", lambda qs=qs, t0b=t0b, t1b=t1b, backend=backend:
                           idx.window_knn_batch(qs, t0b, t1b, k=K, backend=backend))
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
                                       lambda qs=qs, t0b=t0b, t1b=t1b, backend=backend:
                                       idx.window_knn_approx_batch(
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
        summary[f"traced {mode}"] = report_traced(
            f"kernel backend: {mode}", trace, kernel,
            lambda fn=repeat[mode]: trace_device(torch, ops, fn))
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


def lm_bounds(cfg, batch, prompt, cache_len, weight_bytes, embed_bytes):
    """The least times of the LM path on the card, from its shapes: the
    prefill's operations (the layers' matmuls over every token, causal flash
    attention's score and value products over the q-chunks it runs, the LM
    head on the last token) over the dense bf16 rate, and the bytes a
    decode step moves (every weight but the embedding table, a row of it a
    request, the K and V caches over all their slots, as decode_attention
    reads them, the logits written) over the HBM rate."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    per_token = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    layer_flops = 2.0 * batch * prompt * per_token
    qc = min(1024, prompt)
    nq = prompt // qc
    attn_flops = 4.0 * batch * h * hd * qc * qc * nq * (nq + 1) / 2
    head_flops = 2.0 * batch * d * cfg.vocab_padded
    flops = cfg.n_layers * (layer_flops + attn_flops) + head_flops
    kv_bytes = 2 * cfg.n_layers * batch * cache_len * kv * hd * 2
    step_bytes = (weight_bytes - embed_bytes + batch * d * 2 + kv_bytes
                  + batch * cfg.vocab_padded * 4)
    return {"prefill_tflop": flops / 1e12,
            "prefill_layer_tflop": cfg.n_layers * layer_flops / 1e12,
            "prefill_attention_tflop": cfg.n_layers * attn_flops / 1e12,
            "prefill_bound_ms": flops / BF16_FLOP_PER_S * 1e3,
            "decode_step_gb": step_bytes / 1e9, "kv_cache_gb": kv_bytes / 1e9,
            "decode_bound_ms": step_bytes / HBM_BYTES_PER_S * 1e3}


def logits_check(torch, cfg, got, want, what, tol=LM_LOGIT_TOL):
    """max |got - want| over the vocabulary within ``tol``, and the argmax
    equal wherever ``want``'s top-1/top-2 margin exceeds twice it."""
    got, want = got[..., :cfg.vocab].float(), want[..., :cfg.vocab].float()
    err = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    sure = (top2[..., 0] - top2[..., 1]) > 2 * tol
    agree = got.argmax(-1) == want.argmax(-1)
    if err > tol or not bool(agree[sure].all()):
        fail(f"{what}: max |delta logit| {err:.4f} (bound {tol}), argmax differs at "
             f"{int((sure & ~agree).sum())} of {int(sure.sum())} positions past the margin")
    return err


def phase_lm_serve(torch, ops, serve, seed):
    """``serve.py --mode lm`` on the card for every arch the reference serves,
    then the LM path at the full width of serve.py's default arch
    (docstring phase 15). Returns the phase's summary."""
    import io

    from repro_torch.configs import get_config
    from repro_torch.models import attention
    from repro_torch.models.common import rms_norm, rope
    from repro_torch.models.transformer import decode_step, forward, init_params, logits_fn, prefill

    t_phase = time.perf_counter()
    summary = {"serve": {}}
    ops.reset_launches()

    class Tee(io.StringIO):
        """Keeps what it is given and passes it on to ``out``."""

        def __init__(self, out):
            super().__init__()
            self.out = out

        def write(self, text):
            self.out.write(text)
            return super().write(text)

    # (a) the command line's LM mode, each arch's smoke config
    pattern = re.compile(r"^\[serve-lm\] (\d+) tokens x batch (\d+): ([\d.]+) ms/step, "
                         r"(\d+) tok/s$", re.M)
    for arch in LM_SERVE_ARCHS:
        buf = Tee(sys.stdout)
        with contextlib.redirect_stdout(buf):
            out = serve.main(["--mode", "lm", "--arch", arch])
        m = pattern.search(buf.getvalue())
        if m is None:
            fail(f"lm-serve {arch}: no [serve-lm] line in {buf.getvalue()!r}")
        if out["logits"].device.type != torch.device(DEVICE).type:
            fail(f"lm-serve {arch}: the logits are not on the card")
        if not bool(torch.isfinite(out["logits"]).all()):
            fail(f"lm-serve {arch}: non-finite logits")
        summary["serve"][arch] = {"ms_per_step": float(m.group(3)),
                                  "tok_per_s": int(m.group(4))}
        log(f"lm-serve {arch}: {m.group(0)}; logits {tuple(out['logits'].shape)} finite")
    for arch, key in LM_FRONTEND_ARCHS.items():
        try:
            serve.main(["--mode", "lm", "--arch", arch])
        except KeyError as exc:
            if exc.args != (key,):
                fail(f"lm-serve {arch}: KeyError{exc.args}, the reference raises KeyError('{key}')")
            log(f"lm-serve {arch}: KeyError({key!r}), as the reference's serve_lm "
                "(it passes tokens only)")
        else:
            fail(f"lm-serve {arch}: served; the reference's serve_lm raises KeyError('{key}')")
    del out
    gc.collect()
    torch.cuda.empty_cache()

    # (b) the full width of serve.py's default arch
    cfg = get_config(LM_ARCH)
    dev = torch.device(DEVICE)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=dev).manual_seed(seed)
    t0 = time.perf_counter()
    model = init_params(cfg, gen, dev)
    torch.cuda.synchronize()
    n_params = sum(p.numel() for p in model.parameters())
    weight_bytes = sum(p.numel() * p.element_size() for p in model.parameters())
    if n_params != cfg.n_params():
        fail(f"lm {LM_ARCH}: {n_params} parameters on the card, n_params() says {cfg.n_params()}")
    log(f"lm {LM_ARCH}: {cfg.n_layers} layers, d {cfg.d_model}, {cfg.n_heads} heads, "
        f"{cfg.n_kv} KV heads, hd {cfg.hd}, d_ff {cfg.d_ff}, vocab {cfg.vocab}: {n_params:,} "
        f"parameters, {weight_bytes / 1e9:.3f} GB, made on the card in "
        f"{time.perf_counter() - t0:.2f}s")
    B, P, T = LM_BATCH, LM_PROMPT, LM_DECODE
    cache_len = P + T
    toks = torch.randint(0, cfg.vocab, (B, P), generator=gen, device=dev)
    bounds = lm_bounds(cfg, B, P, cache_len, weight_bytes,
                       model.embed.numel() * model.embed.element_size())
    t0 = time.perf_counter()
    logits, cache = prefill(model, cfg, {"tokens": toks}, cache_len=cache_len)
    torch.cuda.synchronize()
    prefill_s = time.perf_counter() - t0
    seen = [logits]
    tok = logits.argmax(-1)[:, None]
    generated = [tok]
    t0 = time.perf_counter()
    for _ in range(T):
        logits, cache = decode_step(model, cfg, cache, tok)
        tok = logits.argmax(-1)[:, None]
        seen.append(logits)
        generated.append(tok)
    torch.cuda.synchronize()
    decode_s = time.perf_counter() - t0
    serve_peak = torch.cuda.max_memory_allocated()
    seen = torch.stack(seen, 1)  # (B, 1 + T, V): the prefill's, then each step's
    generated = torch.cat(generated, 1)  # (B, 1 + T)
    if not bool(torch.isfinite(seen).all()):
        fail(f"lm {LM_ARCH}: non-finite logits")
    ms_step = decode_s / T * 1e3
    log(f"lm {LM_ARCH}: {B} requests x {P} tokens: prefill {prefill_s:.4f}s "
        f"(bound {bounds['prefill_bound_ms']:.2f} ms: {bounds['prefill_tflop']:.2f} TFLOP = "
        f"{bounds['prefill_layer_tflop']:.2f} layers + {bounds['prefill_attention_tflop']:.2f} "
        f"attention); {T} greedy steps {ms_step:.3f} ms/step, {B * T / decode_s:.1f} tok/s "
        f"(bound {bounds['decode_bound_ms']:.4f} ms/step: {bounds['decode_step_gb']:.3f} GB "
        f"a step, {bounds['kv_cache_gb']:.3f} of K and V); peak "
        f"{serve_peak / 2**30:.3f} GiB; every logit finite")

    # busy share over the last LM_TRACE_STEPS steps again: the cache rolled
    # back, the same tokens fed (the slots are written with the same values)
    from torch.profiler import ProfilerActivity, profile

    cache["pos"] = P + T - LM_TRACE_STEPS
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(T - LM_TRACE_STEPS, T):
            again, cache = decode_step(model, cfg, cache, generated[:, i:i + 1])
        torch.cuda.synchronize()
        traced_s = time.perf_counter() - t0
    busy = device_times(prof)
    busy_s = sum(busy.values()) / 1e6
    n_kernels = sum(e.count for e in prof.key_averages()
                    if not str(getattr(e, "device_type", "")).endswith("CPU")
                    and e.self_device_time_total > 0)
    logits_check(torch, cfg, again, seen[:, T], f"lm {LM_ARCH}: the traced step {T} again")
    top = ", ".join(f"{k[:40]} {us / 1e3:.2f} ms" for k, us in busy.most_common(4))
    log(f"lm {LM_ARCH}: {LM_TRACE_STEPS} traced decode steps: device busy {busy_s:.5f}s of "
        f"{traced_s:.5f}s (share {busy_s / traced_s:.4f}), {n_kernels / LM_TRACE_STEPS:.0f} "
        f"device ops a step; most device time: {top}")

    # decode against the full forward over prompt + generated tokens (naive
    # attention at 4,128 tokens, a few requests at a time)
    seq = torch.cat([toks, generated[:, :T]], 1)
    at = [P - 1] + [P + i - 1 for i in LM_CHECK_STEPS]
    errs = collections.defaultdict(float)
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        for r in range(0, B, LM_FORWARD_ROWS):
            h = forward(model, cfg, {"tokens": seq[r:r + LM_FORWARD_ROWS]})[0]
            want = logits_fn(model, cfg, h[:, at])
            del h
            for j, step in enumerate((0,) + LM_CHECK_STEPS):
                errs[step] = max(errs[step], logits_check(
                    torch, cfg, seen[r:r + LM_FORWARD_ROWS, step], want[:, j],
                    f"lm {LM_ARCH}: {'prefill' if step == 0 else f'decode step {step}'} "
                    f"against the forward, requests {r}-{r + LM_FORWARD_ROWS - 1}"))
        check_peak = torch.cuda.max_memory_allocated()
        log(f"lm {LM_ARCH}: decode against the forward over {P + T} tokens: max |delta "
            "logit| " + ", ".join(f"{'prefill' if k == 0 else f'step {k}'} {v:.4f}"
                                  for k, v in errs.items())
            + f" (bound {LM_LOGIT_TOL}); the check's peak {check_peak / 2**30:.3f} GiB")

        # flash against naive attention, layer 0's q/k/v at the prompt length
        p0 = model.groups[0][0]
        flash_err = flash_tol = 0.0
        for r in range(0, B, LM_FORWARD_ROWS):
            x = model.embed[toks[r:r + LM_FORWARD_ROWS]]
            hin = rms_norm(x, p0.ln1, cfg.norm_eps)
            b = hin.shape[0]
            q = rope((hin @ p0.attn.wq).reshape(b, P, cfg.n_heads, cfg.hd), torch.arange(P, device=dev), cfg.rope_theta)
            k = rope((hin @ p0.attn.wk).reshape(b, P, cfg.n_kv, cfg.hd), torch.arange(P, device=dev), cfg.rope_theta)
            v = (hin @ p0.attn.wv).reshape(b, P, cfg.n_kv, cfg.hd)
            routed = attention.gqa_attention(q, k, v, causal=True)
            flash = attention.flash_attention(q, k, v, causal=True)
            if not torch.equal(routed, flash):
                fail(f"lm {LM_ARCH}: the auto route at {P} tokens is not the flash path")
            naive = attention.naive_attention(q, k, v, causal=True)
            flash_err = max(flash_err, float((flash.float() - naive.float()).abs().max()))
            flash_tol = max(flash_tol, LM_FLASH_TOL_ULPS * float(v.float().abs().max()))
            del x, hin, q, k, v, routed, flash, naive
        if flash_err > flash_tol:
            fail(f"lm {LM_ARCH}: flash against naive attention {flash_err:.5f} > {flash_tol:.5f}")
        log(f"lm {LM_ARCH}: layer 0 at {P} tokens: flash (the auto route) against naive "
            f"attention max |delta| {flash_err:.5f} (bound {flash_tol:.5f} = 4 x 2^-8 max|v|)")

        # the card against the CPU: the same weights, one request
        one = toks[:1, :LM_CPU_PROMPT]
        card, _ = prefill(model, cfg, {"tokens": one})
        card = card.cpu()
        del cache, seen
        model = model.to("cpu")
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        host, _ = prefill(model, cfg, {"tokens": one.cpu()})
        cpu_err = logits_check(torch, cfg, card, host,
                               f"lm {LM_ARCH}: the card against the CPU, {LM_CPU_PROMPT} tokens")
        log(f"lm {LM_ARCH}: one {LM_CPU_PROMPT}-token request, card against CPU: max |delta "
            f"logit| {cpu_err:.4f} (bound {LM_LOGIT_TOL}; CPU prefill "
            f"{time.perf_counter() - t0:.2f}s)")
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launched:
        fail(f"lm: the LM path launched Coconut kernels {launched}")
    summary.update({
        "arch": LM_ARCH, "params": n_params, "weight_gb": weight_bytes / 1e9,
        "requests": B, "prompt": P, "decode_steps": T, "prefill_s": prefill_s,
        "decode_ms_per_step": ms_step, "tok_per_s": B * T / decode_s,
        "peak_gib": serve_peak / 2**30, "check_peak_gib": check_peak / 2**30,
        "busy_share": busy_s / traced_s, "device_ops_per_step": n_kernels / LM_TRACE_STEPS,
        "decode_vs_forward": {str(k): v for k, v in errs.items()},
        "flash_vs_naive": flash_err, "flash_tol": flash_tol, "card_vs_cpu": cpu_err,
        **bounds})
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"lm: phase {summary['phase_seconds']:.1f}s; no Coconut kernel launched on the LM path")
    del model
    gc.collect()
    return summary


def train_bounds(cfg, tokens, seq, batch, n_params):
    """The least times of a training step on the card, from the code's
    shapes: its operations over the dense bf16 rate (the layers' matmuls
    forward, again in the remat forward and twice in the backward; the LM
    head forward and twice back; causal flash attention's products over the
    q-chunks it runs, four times likewise), and the AdamW update's bytes
    over the HBM rate (per parameter: bf16 weight read and written, f32
    gradient read, f32 m and v read and written: 24 bytes)."""
    d, h, kv, hd, f = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd, cfg.d_ff
    per_token = d * h * hd + 2 * d * kv * hd + h * hd * d + 3 * d * f
    qc = min(1024, seq)
    nq = seq // qc
    attn_fwd = 4.0 * batch * h * hd * qc * qc * nq * (nq + 1) / 2
    flops = (8.0 * tokens * cfg.n_layers * per_token + 6.0 * tokens * d * cfg.vocab_padded
             + 4.0 * cfg.n_layers * attn_fwd)
    adamw_bytes = 24 * n_params
    return {"step_tflop": flops / 1e12, "step_bound_s": flops / BF16_FLOP_PER_S,
            "adamw_gb": adamw_bytes / 1e9,
            "adamw_bound_ms": adamw_bytes / HBM_BYTES_PER_S * 1e3}


def dir_bytes(path) -> int:
    return sum(p.stat().st_size for p in Path(path).rglob("*") if p.is_file())


@contextlib.contextmanager
def instrument_training(torch, ops, train, ckpt, rec):
    """Time the checkpoint saves and restores and the AdamW updates of the
    ``train.main`` runs inside (CUDA events around each update; read after
    the run), count the bytes each save wrote, and, while ``rec["trace"]``
    is set, run each train step under ``trace_device`` (its trace appended
    to ``rec["traces"]``)."""
    real_save, real_restore, real_adamw = ckpt.save, ckpt.restore, train.AdamW
    real_factory = train.make_train_step

    def factory(*a, **kw):
        step = real_factory(*a, **kw)

        def traced_step(*args):
            if not rec.get("trace"):
                return step(*args)
            out = []
            rec["traces"].append(trace_device(torch, ops, lambda: out.append(step(*args))))
            return out[0]

        return traced_step

    def save(ckpt_dir, step, *a, **kw):
        t0 = time.perf_counter()
        out = real_save(ckpt_dir, step, *a, **kw)
        rec["saves"].append((time.perf_counter() - t0,
                             dir_bytes(Path(ckpt_dir) / f"step_{step:08d}")))
        return out

    def restore(*a, **kw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = real_restore(*a, **kw)
        torch.cuda.synchronize()
        rec["restores"].append(time.perf_counter() - t0)
        return out

    class TimedAdamW(real_adamw):
        def update(self, *a, **kw):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            ev[0].record()
            out = super().update(*a, **kw)
            ev[1].record()
            rec["updates"].append(ev)
            return out

    ckpt.save, ckpt.restore, train.AdamW = save, restore, TimedAdamW
    train.make_train_step = factory
    try:
        yield rec
    finally:
        ckpt.save, ckpt.restore, train.AdamW = real_save, real_restore, real_adamw
        train.make_train_step = real_factory


def phase_lm_train(torch, ops, train, seed):
    """``launch/train.py`` on the card: every arch at smoke size, then
    serve.py's default arch at full width, straight and crashed + resumed,
    then the card against the CPU, and the pipeline's Coconut hook over the
    full-width batches (docstring phase 16). Returns (the hook's launches,
    the phase's summary)."""
    import io
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.core import StreamConfig, StreamingIndex, SummarizationConfig
    from repro_torch.core.verify_engine import get_engine
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.models.steps import TrainConfig, make_loss_and_grad, make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamW, AdamWConfig

    t_phase = time.perf_counter()
    summary = {"smoke": {}}
    ops.reset_launches()
    dev = torch.device(DEVICE)

    def finite(out, what):
        bad = [i for i, m in enumerate(out["metrics"])
               if not (math.isfinite(m["loss"]) and math.isfinite(m["grad_norm"]))]
        if bad:
            fail(f"{what}: non-finite loss or grad norm at steps {bad}")

    def same_state(a, b, what):
        differ = [n for (n, x), (_, y) in zip(a["params"].named_parameters(),
                                              b["params"].named_parameters())
                  if not torch.equal(x, y)]
        differ += [f"opt.{k}.{n}" for k, tree in a["opt"].items()
                   for n, t in tree.items() if not torch.equal(t, b["opt"][k][n])]
        if differ:
            fail(f"{what}: {len(differ)} leaves differ, e.g. {differ[:4]}")

    # (a) every arch at smoke size, as the command line runs it
    for arch in ARCH_IDS:
        t0 = time.perf_counter()
        out = train.main(["--arch", arch, *TRAIN_SMOKE, "--seed", str(seed),
                          "--device", DEVICE])
        finite(out, f"lm-train {arch}")
        if out["params"].embed.device.type != dev.type:
            fail(f"lm-train {arch}: the parameters are not on the card")
        init = init_params(out["cfg"], torch.Generator(dev).manual_seed(seed), dev)
        moved = sum(not torch.equal(a, b) for a, b in zip(init.parameters(),
                                                           out["params"].parameters()))
        if moved == 0:
            fail(f"lm-train {arch}: no parameter changed")
        losses = [round(m["loss"], 4) for m in out["metrics"]]
        summary["smoke"][arch] = {"losses": losses, "seconds": time.perf_counter() - t0}
        log(f"lm-train {arch}: {TRAIN_SMOKE[2]} steps, losses {losses}, {moved} of "
            f"{sum(1 for _ in init.parameters())} parameter tensors moved; "
            f"{time.perf_counter() - t0:.2f}s")
        del out, init
    gc.collect()
    torch.cuda.empty_cache()

    # (b) full width: straight, crashed at step 2 after its checkpoint, resumed
    cfg = get_config(LM_ARCH)
    args = ["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--global-batch",
            str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--grad-accum", str(TRAIN_ACCUM),
            "--warmup", str(TRAIN_WARMUP), "--seed", str(seed), "--log-every", "1",
            "--device", DEVICE]
    log(f"lm-train {LM_ARCH}: python -m repro_torch.launch.train {' '.join(args)}")
    rec = {"saves": [], "restores": [], "updates": [], "traces": []}
    root = tempfile.mkdtemp(prefix="coconut-smoke-ckpt-")
    try:
        free = shutil.disk_usage(root).free
        log(f"lm-train: {root}, {free} bytes free (need {CKPT_FREE_BYTES})")
        if free < CKPT_FREE_BYTES:
            fail(f"lm-train: {root} has {free} bytes free, under {CKPT_FREE_BYTES}")
        ckpt_args = ["--ckpt-dir", root, "--ckpt-every", str(TRAIN_CRASH)]
        with instrument_training(torch, ops, train, ckpt, rec):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            straight = train.main(args)
            straight_s = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated()
            updates = [a.elapsed_time(b) for a, b in rec["updates"]]
            t0 = time.perf_counter()
            try:
                train.main(args + ckpt_args + ["--crash-at", str(TRAIN_CRASH)])
            except SystemExit as exc:
                if exc.code != 17:
                    fail(f"lm-train: the crashed run exited {exc.code!r}, not 17")
            else:
                fail("lm-train: the run with --crash-at returned instead of exiting 17")
            crash_s = time.perf_counter() - t0
            gc.collect()
            buf = io.StringIO()
            rec["trace"] = True  # the resumed run's steps run under the profiler
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                resumed = train.main(args + ckpt_args)
            resume_s = time.perf_counter() - t0
            rec["trace"] = False
        sys.stdout.write(buf.getvalue())
        if f"[train] resumed from step {TRAIN_CRASH}" not in buf.getvalue():
            fail(f"lm-train: the relaunch did not print 'resumed from step {TRAIN_CRASH}'")
    except BaseException:
        shutil.rmtree(root, ignore_errors=True)
        raise
    # phase 17 holds its sharded steps to this run's step-2 checkpoint (and
    # removes the directory)
    shutil.rmtree(Path(root) / f"step_{TRAIN_STEPS:08d}", ignore_errors=True)
    summary["ckpt_dir"] = root
    finite(straight, f"lm-train {LM_ARCH} straight")
    finite(resumed, f"lm-train {LM_ARCH} resumed")
    if resumed["start"] != TRAIN_CRASH or resumed["metrics"] != straight["metrics"][TRAIN_CRASH:]:
        fail(f"lm-train: the resumed steps' metrics {resumed['metrics']} are not the "
             f"straight run's {straight['metrics'][TRAIN_CRASH:]}")
    same_state(straight, resumed, "lm-train: crash + resume against the straight run")
    n_params = sum(p.numel() for p in straight["params"].parameters())
    tokens = TRAIN_BATCH * TRAIN_SEQ
    bounds = train_bounds(cfg, tokens, TRAIN_SEQ, TRAIN_BATCH // TRAIN_ACCUM, n_params)
    steady = straight["step_seconds"][1:]
    s_step = sum(steady) / len(steady)
    upd_ms = sum(updates[1:]) / len(updates[1:])
    (save_s, save_bytes), restore_s = rec["saves"][0], rec["restores"][-1]
    log(f"lm-train {LM_ARCH}: {n_params:,} parameters, {TRAIN_BATCH} x {TRAIN_SEQ} tokens a "
        f"step in {TRAIN_ACCUM} microbatches, remat: {s_step:.4f} s/step, "
        f"{tokens / s_step:.1f} tok/s over steps 2-{TRAIN_STEPS} (bound "
        f"{bounds['step_bound_s']:.4f} s: {bounds['step_tflop']:.2f} TFLOP; step 1 "
        f"{straight['step_seconds'][0]:.4f} s); peak {peak / 2**30:.3f} GiB; AdamW update "
        f"{upd_ms:.3f} ms (bound {bounds['adamw_bound_ms']:.3f} ms: "
        f"{bounds['adamw_gb']:.2f} GB); losses "
        f"{[round(m['loss'], 4) for m in straight['metrics']]}, grad norms "
        f"{[round(m['grad_norm'], 3) for m in straight['metrics']]}")
    log(f"lm-train {LM_ARCH}: checkpoint of step {TRAIN_CRASH}: {save_bytes:,} bytes saved in "
        f"{save_s:.2f}s ({save_bytes / save_s / 1e9:.2f} GB/s), restored in {restore_s:.2f}s; "
        f"runs: straight {straight_s:.1f}s, crashed {crash_s:.1f}s, resumed {resume_s:.1f}s; "
        f"the resumed run's parameters, m and v bit for bit the straight run's")
    summary.update({
        "arch": LM_ARCH, "params": n_params, "tokens_per_step": tokens,
        "s_per_step": s_step, "tok_per_s": tokens / s_step,
        "step_seconds": straight["step_seconds"], "peak_gib": peak / 2**30,
        "adamw_update_ms": upd_ms, "ckpt_bytes": save_bytes, "ckpt_save_s": save_s,
        "ckpt_restore_s": restore_s, "losses": [m["loss"] for m in straight["metrics"]],
        "grad_norms": [m["grad_norm"] for m in straight["metrics"]], **bounds})
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launched:
        fail(f"lm-train: the training runs launched Coconut kernels {launched}")

    # busy share and device ops over the resumed run's steps, each traced
    # (a step whose trace came back with no device record is traced again,
    # a further step of the resumed model, F5)
    model, state = resumed["params"], resumed["opt"]
    pipe = TokenPipeline(PipelineConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                        seed=seed), cfg)
    step_fn = make_train_step(cfg, TrainConfig(grad_accum=TRAIN_ACCUM, remat=True),
                              AdamW(AdamWConfig(warmup_steps=TRAIN_WARMUP,
                                                total_steps=TRAIN_STEPS)))
    at = [TRAIN_STEPS]

    def one_step():
        s = at[0]
        at[0] += 1
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(s).items()}
        step_fn(model, state, batch, s)

    if len(rec["traces"]) != TRAIN_STEPS - TRAIN_CRASH:
        fail(f"lm-train: {len(rec['traces'])} traced steps in the resumed run")
    trace = {"busy": collections.Counter(), "seconds": 0.0, "ops": 0, "retraces": 0}
    for t in rec["traces"]:
        t, n = retraced("lm-train traced step", t, lambda t: sum(t["busy"].values()) > 0,
                        lambda: trace_device(torch, ops, one_step))
        if not t["busy"]:
            fail(f"lm-train: a traced step held no device record after {n} repeats")
        trace["busy"].update(t["busy"])
        trace["seconds"] += t["seconds"]
        trace["ops"] += t["ops"]
        trace["retraces"] += n
    n_traced = len(rec["traces"])
    busy_s = sum(trace["busy"].values()) / 1e6
    top = ", ".join(f"{k[:40]} {us / 1e3:.1f} ms" for k, us in trace["busy"].most_common(5))
    log(f"lm-train {LM_ARCH}: {n_traced} traced steps (the resumed run's): device busy "
        f"{busy_s:.4f}s of {trace['seconds']:.4f}s (share {busy_s / trace['seconds']:.4f}), "
        f"{trace['ops'] / n_traced:.0f} device ops a step; {trace['retraces']} repeats "
        f"re-traced; most device time: {top}")
    summary.update({"busy_share": busy_s / trace["seconds"],
                    "device_ops_per_step": trace["ops"] / n_traced,
                    "traced_retraces": trace["retraces"],
                    "top_device_ops": {k: us / 1e3 for k, us in trace["busy"].most_common(8)}})
    del resumed, model, state, step_fn
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the card against the CPU: the straight run's weights, one request
    model = straight["params"]
    lg = make_loss_and_grad(cfg, TrainConfig(remat=True))
    one = {k: v[:1, :TRAIN_CPU_TOKENS] for k, v in pipe.batch(0).items()}

    def loss_and_norm(device):
        loss, _, grads = lg(model, {k: torch.from_numpy(v).to(device) for k, v in one.items()})
        gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in grads.values()))
        return float(loss), float(gnorm)

    ops.reset_launches()
    card = loss_and_norm(dev)
    model.to("cpu")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    host = loss_and_norm(torch.device("cpu"))
    loss_err = abs(card[0] - host[0])
    gnorm_err = abs(card[1] - host[1]) / host[1]
    log(f"lm-train {LM_ARCH}: one {TRAIN_CPU_TOKENS}-token request, card against CPU: loss "
        f"{card[0]:.5f} / {host[0]:.5f} (|delta| {loss_err:.5f}, bound {TRAIN_LOSS_TOL}), "
        f"grad norm {card[1]:.5f} / {host[1]:.5f} (relative {gnorm_err:.5f}, bound "
        f"{TRAIN_GNORM_RTOL}); CPU loss and grads {time.perf_counter() - t0:.2f}s")
    if loss_err > TRAIN_LOSS_TOL or gnorm_err > TRAIN_GNORM_RTOL:
        fail("lm-train: the card and the CPU disagree on the loss or the grad norm")
    summary.update({"card_vs_cpu_loss": loss_err, "card_vs_cpu_gnorm_rel": gnorm_err})
    del model, straight, lg
    gc.collect()
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launched:
        fail(f"lm-train: the card against the CPU launched Coconut kernels {launched}")

    # the pipeline's Coconut hook: series_view of the full-width batches teed
    # into a StreamingIndex on the card, one window kNN batch answered
    engine = get_engine(DEVICE)
    idx = StreamingIndex(StreamConfig(
        scheme="BTP", summarization=SummarizationConfig(
            series_len=HOOK_SERIES_LEN, n_segments=16, card_bits=8),
        buffer_entries=1024, block_size=64, device=DEVICE))
    rows = []
    for s in range(TRAIN_STEPS):
        view = pipe.series_view(pipe.batch(s), HOOK_SERIES_LEN).astype(np.float32)
        idx.ingest(view, np.full(len(view), s, np.int64))
        rows.append(view)
    qs = pipe.series_view(pipe.batch(TRAIN_STEPS), HOOK_SERIES_LEN)[:QUERY_BATCH].astype(
        np.float32)
    before = {k: engine.stats[k] for k in ENGINE_COUNTERS}
    ops.reset_launches()
    d2, ids, _ = idx.window_knn_batch(qs, 0, TRAIN_STEPS - 1, k=K)
    torch.cuda.synchronize()
    hook_launches = collections.Counter(ops.LAUNCHES)
    delta = {k: engine.stats[k] - before[k] for k in ("calls", "screened", "fallbacks")}
    X = torch.from_numpy(np.concatenate(rows)).to(dev).double()
    Q = torch.from_numpy(qs).to(dev).double()
    want = torch.sort(torch.stack([((X - q) ** 2).sum(1) for q in Q]), dim=1, stable=True)
    wd2, wids = want.values[:, :K + 1], want.indices[:, :K]
    got = torch.from_numpy(d2).to(dev).double()
    tol = 1e-5 * wd2[:, :K].abs() + 1e-3
    if bool(((got - wd2[:, :K]).abs() > tol).any()):
        fail(f"lm-train hook: window kNN distances differ from the f64 brute force by "
             f"{float((got - wd2[:, :K]).abs().max())}")
    gaps = torch.minimum(wd2[:, 1:] - wd2[:, :-1], torch.cat(
        [wd2[:, :1] * 0 + math.inf, (wd2[:, 1:K] - wd2[:, :K - 1])], 1))
    apart = gaps > tol
    gid = torch.from_numpy(ids).to(dev)
    if bool((apart & (gid != wids)).any()):
        fail("lm-train hook: ids away from ties differ from the f64 brute force")
    log(f"lm-train hook: {len(rows)} batches' series_view({HOOK_SERIES_LEN}) = "
        f"{X.shape[0]} series ingested; {QUERY_BATCH} queries, k = {K}, window 0-"
        f"{TRAIN_STEPS - 1}: distances the f64 brute force's, ids equal at "
        f"{int(apart.sum())} of {apart.numel()} ranks away from ties; engine "
        f"{delta} ({'reached' if delta['calls'] else 'did not reach'} the device engine), "
        f"launches {dict((k, v) for k, v in hook_launches.items() if v)}")
    summary["hook"] = {"series": int(X.shape[0]), "engine": delta,
                       "launches": {k: v for k, v in hook_launches.items() if v},
                       "ids_away_from_ties": int(apart.sum())}
    idx.close()
    del idx, X
    gc.collect()
    torch.cuda.empty_cache()
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"lm-train: phase {summary['phase_seconds']:.1f}s; no Coconut kernel launched on "
        "the training path")
    return hook_launches, summary


def spec_shard_bytes(torch, cfg, shape, variant, multi_pod):
    """The local shard bytes of a dry-run cell's inputs under the specs, from
    the shapes: each sharded dim divided by its mesh axes' sizes."""
    import types

    from repro_torch.configs import SHAPES
    from repro_torch.launch import specs
    from repro_torch.launch.dryrun import abstract_batch
    from repro_torch.models.transformer import init_params, make_cache

    sizes = {"pod": 2, "data": 16, "model": 16} if multi_pod else {"data": 16, "model": 16}
    mesh = types.SimpleNamespace(mesh_dim_names=tuple(sizes), shape=tuple(sizes.values()))
    shp = SHAPES[shape]
    model = init_params(cfg, None, "meta")
    pspecs = specs.param_specs(model, mesh)
    if variant == "opt" and shp.kind == "decode":
        pspecs = specs.drop_axis_specs(pspecs, "data")

    def shard(t, spec):
        n = t.numel() * t.element_size()
        for e in spec:
            for a in ((e,) if isinstance(e, str) else (e or ())):
                n //= sizes[a]
        return n

    named = dict(model.named_parameters())
    total = sum(shard(p, pspecs[k]) for k, p in named.items())
    if shp.kind == "train":
        total += sum(2 * shard(torch.empty(p.shape, dtype=torch.float32, device="meta"),
                               pspecs[k]) for k, p in named.items())
    if shp.kind in ("train", "prefill"):
        batch = abstract_batch(cfg, shp)
        bs = specs.batch_specs(batch, mesh, multi_pod)
        total += sum(shard(t, bs[k]) for k, t in batch.items())
    else:
        cache = make_cache(cfg, shp.global_batch, shp.seq_len, device="meta")
        cs = specs.cache_specs(cache, mesh, multi_pod)

        def walk(node, spec):
            if isinstance(node, dict):
                return sum(walk(node[k], spec[k]) for k in node)
            if isinstance(node, list):
                return sum(walk(v, s) for v, s in zip(node, spec))
            return shard(node, spec) if isinstance(node, torch.Tensor) else 0

        token = torch.empty((shp.global_batch, 1), dtype=torch.int32, device="meta")
        total += walk(cache, cs) + shard(token, specs.batch_specs(token, mesh, multi_pod))
    return total


def start_dryruns(out_dir):
    """The dry-run subprocesses of phase 17(a), started (CPU work)."""
    import os

    env = dict(os.environ, PYTHONPATH=str(SRC))
    runs = {}
    for variant, mesh, shapes, coconut in DRYRUN_RUNS:
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", LM_ARCH,
               "--shape", shapes, "--mesh", mesh, "--variant", variant,
               "--out", str(out_dir), "--device", DEVICE] + (["--coconut"] if coconut else [])
        log(f"lm-sharded dry run: {' '.join(cmd[1:])}")
        tag = f"{variant}-{mesh}-{shapes.split(',')[0]}"
        log_path = out_dir / f"{tag}.log"
        with open(log_path, "w") as f:
            # niced: the card's steps of (b) and (c) run beside them
            runs[tag] = (subprocess.Popen(
                cmd, env=env, cwd=str(ROOT), stdout=f, stderr=subprocess.STDOUT,
                preexec_fn=lambda: os.nice(10)), log_path)
    return runs


def check_reference_counts(res):
    """Phase 17(a)'s hold of a single-pod baseline cell to the reference's
    counts (``REF_*``): decode_32k's memory at most 2x the reference's and
    its collective bytes within 2x either way; train_4k's all-reduce bytes
    at most 2x."""
    tag = f"lm-sharded dry run {res['shape']} (16x16, baseline)"
    if res["shape"] == "decode_32k":
        gb, coll = res["mem_per_device"]["total_gb"], res["collective_bytes_per_device"]
        ratio = coll / REF_DECODE_32K_COLLECTIVE_BYTES
        log(f"{tag}: {gb} GB/device against the reference's {REF_DECODE_32K_TOTAL_GB}; "
            f"collective bytes {coll:.6g} against {REF_DECODE_32K_COLLECTIVE_BYTES:.6g} "
            f"(x{ratio:.4f})")
        if gb > 2 * REF_DECODE_32K_TOTAL_GB or not 0.5 <= ratio <= 2.0:
            fail(f"{tag}: {gb} GB/device or x{ratio:.4f} the reference's collective "
                 "bytes, past 2x")
    elif res["shape"] == "train_4k":
        ar = res["collectives"].get("all-reduce", {}).get("bytes", 0.0)
        log(f"{tag}: all-reduce bytes {ar:.6g} against the reference's "
            f"{REF_TRAIN_4K_ALL_REDUCE_BYTES:.6g} (x{ar / REF_TRAIN_4K_ALL_REDUCE_BYTES:.4f})")
        if ar > 2 * REF_TRAIN_4K_ALL_REDUCE_BYTES:
            fail(f"{tag}: all-reduce bytes {ar:.6g}, past 2x the reference's")


def finish_dryruns(torch, runs, out_dir, t_start):
    """Wait for the dry runs and check them (docstring phase 17(a))."""
    from repro_torch.configs import get_config
    from repro_torch.launch.dryrun import _pad_heads

    cells = {}
    for tag, (proc, log_path) in runs.items():
        try:
            rc = proc.wait(timeout=max(1.0, DRYRUN_TIMEOUT - (time.perf_counter() - t_start)))
        except subprocess.TimeoutExpired:
            for p, _ in runs.values():
                p.kill()
            fail(f"lm-sharded dry run ({tag}) ran past {DRYRUN_TIMEOUT} s")
        text = log_path.read_text()
        for line in text.splitlines():
            if line.startswith(("FAIL ", "SKIP ", "dry-run complete")):
                log(f"lm-sharded dry run ({tag}): {line}")
        if rc != 0 or "FAIL " in text:
            fail(f"lm-sharded dry run ({tag}) exited {rc}: {text[-2000:]}")
    for path in sorted(out_dir.glob("*.json")):
        res = json.loads(path.read_text())
        cells[path.stem] = res
        if "useful_flops_ratio" not in res:
            continue  # a Coconut cell
        variant = res["variant"]
        cfg = get_config(res["arch"])
        if variant == "opt":
            cfg = _pad_heads(cfg, 16)
        want = spec_shard_bytes(torch, cfg, res["shape"], variant, res["mesh"] == "2x16x16")
        got = res["mem_per_device"]["args_bytes"]
        if got != want:
            fail(f"lm-sharded dry run {path.stem}: args_bytes {got} != the specs' local "
                 f"shard bytes {want}")
        if not 0 < res["useful_flops_ratio"] <= 1.05:
            fail(f"lm-sharded dry run {path.stem}: useful_flops_ratio "
                 f"{res['useful_flops_ratio']} outside (0, 1.05]")
        if variant == "baseline" and res["mesh"] == "16x16":
            check_reference_counts(res)
    want_cells = sum(len(shapes.split(",")) for _, _, shapes, _ in DRYRUN_RUNS) + 3
    if len(cells) != want_cells:
        fail(f"lm-sharded dry run: {len(cells)} cells written, not {want_cells}")
    for tag, res in sorted(cells.items()):
        m, c, r = res["mem_per_device"], res["cost_per_device"], res["roofline_s"]
        colls = {k: v["bytes"] for k, v in sorted(res["collectives"].items())}
        log(f"lm-sharded dry run {tag}: traced {res['lower_s']} s; memory/device "
            f"{m['total_gb']} GB (args {m['args_bytes']}, temp {m['temp_bytes']}); "
            f"FLOPs/device {c['flops']:.6g}, bytes/device {c['bytes']:.6g}; collective "
            f"bytes/device {colls}; roofline compute {r['compute']:.6g} s, memory "
            f"{r['memory']:.6g} s, collective {r['collective']:.6g} s -> {res['bottleneck']}"
            + (f"; useful FLOPs ratio {res['useful_flops_ratio']}"
               if "useful_flops_ratio" in res else ""))
    return cells


def unsharded_reference(torch, train, seed):
    """Phase 16(b)'s straight run, for phase 17 run alone: its metrics and a
    directory holding its step-2 checkpoint."""
    import tempfile

    root = tempfile.mkdtemp(prefix="coconut-smoke-ckpt-")
    out = train.main(["--arch", LM_ARCH, "--steps", str(TRAIN_STEPS), "--global-batch",
                      str(TRAIN_BATCH), "--seq-len", str(TRAIN_SEQ), "--grad-accum",
                      str(TRAIN_ACCUM), "--warmup", str(TRAIN_WARMUP), "--seed", str(seed),
                      "--log-every", "1", "--device", DEVICE, "--ckpt-dir", root,
                      "--ckpt-every", str(TRAIN_CRASH)])
    return {"losses": [m["loss"] for m in out["metrics"]],
            "grad_norms": [m["grad_norm"] for m in out["metrics"]], "ckpt_dir": root}


def phase_lm_sharded(torch, ops, train, seed, reference=None):
    """smollm-360m sharded (docstring phase 17): the dry run's subprocesses,
    then 2 train steps sharded on a one-rank NCCL mesh held bit for bit to
    phase 16's unsharded run (``reference``: its summary, with its step-2
    checkpoint's directory, which this phase removes; None when the phase
    runs alone: that run is made here first), and an elastic restore.
    Returns the phase's summary."""
    import shutil
    import tempfile

    t_phase = time.perf_counter()
    out_dir = Path(tempfile.mkdtemp(prefix="coconut-dryrun-"))
    runs = start_dryruns(out_dir)
    try:
        return _lm_sharded(torch, ops, train, seed, reference, runs, out_dir, t_phase)
    finally:  # on a failed check too: no dry run outlives the phase
        for proc, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        shutil.rmtree(out_dir, ignore_errors=True)


def _lm_sharded(torch, ops, train, seed, reference, runs, out_dir, t_phase):
    """The body of :func:`phase_lm_sharded`, its dry runs started."""
    import shutil
    import tempfile

    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.configs import get_config
    from repro_torch.core import distributed as PD
    from repro_torch.data.pipeline import PipelineConfig, TokenPipeline
    from repro_torch.launch import specs
    from repro_torch.models import shardctx
    from repro_torch.models.steps import TrainConfig, make_train_step
    from repro_torch.models.transformer import init_params
    from repro_torch.train import checkpoint as ckpt
    from repro_torch.train.optimizer import AdamW, AdamWConfig

    if reference is None:
        reference = unsharded_reference(torch, train, seed)
    summary = {}
    dev = torch.device(DEVICE)
    cfg = get_config(LM_ARCH)
    pipe = TokenPipeline(PipelineConfig(global_batch=TRAIN_BATCH, seq_len=TRAIN_SEQ,
                                        seed=seed), cfg)
    was = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())

    def value(t):
        return float(t.full_tensor() if isinstance(t, DTensor) else t)

    def whole(t):
        return (t.full_tensor() if isinstance(t, DTensor) else t).detach()

    def steps(params, state, step_fn, first, n, mesh, refused):
        out, secs = [], []
        for s in range(first, first + n):
            b = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch(s).items()}
            batch = specs.distribute_tree(b, specs.batch_specs(b, mesh, False), mesh)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with shardctx.ctx(mesh, ("data",)), implicit_replication(), \
                    specs.ReplicateRefused() as mode:
                params, state, m = step_fn(params, state, batch, s)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            refused.update(mode.refused)
            out.append({k: value(v) for k, v in m.items()})
        return params, state, out, secs

    def same(want, params, state, what):
        """``want``: a restored tree {"params": {name: t}, "opt": {k: {name: t}}}."""
        differ = [n for n, p in params.named_parameters()
                  if not torch.equal(whole(p).cpu(), whole(want["params"][n]).cpu())]
        differ += [f"opt.{k}.{n}" for k, tree in state.items() for n, t in tree.items()
                   if not torch.equal(whole(t).cpu(), whole(want["opt"][k][n]).cpu())]
        if differ:
            fail(f"{what}: {len(differ)} leaves differ, e.g. {differ[:4]}")

    def metrics_of(i, j):
        return [(reference["losses"][s], reference["grad_norms"][s]) for s in range(i, j)]

    ref_dir = reference["ckpt_dir"]
    torch.use_deterministic_algorithms(True)
    try:
        mesh = PD.make_mesh((1, 1), ("data", "model"), DEVICE)
        if torch.distributed.get_backend() != ("nccl" if dev.type == "cuda" else "gloo"):
            fail(f"lm-sharded: the mesh's group is {torch.distributed.get_backend()}")
        ops.reset_launches()
        # (b) 2 steps sharded, held to phase 16's run and its step-2 checkpoint
        torch.cuda.reset_peak_memory_stats()
        model = init_params(cfg, torch.Generator(dev).manual_seed(seed), dev)
        pspecs = specs.param_specs(model, mesh)
        specs.distribute_model(model, pspecs, mesh)
        opt = AdamW(AdamWConfig(warmup_steps=TRAIN_WARMUP, total_steps=TRAIN_STEPS))
        state = opt.init(model)
        step_fn = make_train_step(cfg, TrainConfig(grad_accum=TRAIN_ACCUM, remat=True), opt,
                                  *specs.zero1_hooks(model, pspecs, mesh))
        refused = collections.Counter()
        model, state, got_m, secs = steps(model, state, step_fn, 0, TRAIN_CRASH, mesh, refused)
        peak = torch.cuda.max_memory_allocated()
        if not all(isinstance(p, DTensor) for p in model.parameters()):
            fail("lm-sharded: a parameter of the sharded run is not a DTensor")
        got = [(m["loss"], m["grad_norm"]) for m in got_m]
        if got != metrics_of(0, TRAIN_CRASH):
            fail(f"lm-sharded: sharded (loss, grad norm) {got}, unsharded "
                 f"{metrics_of(0, TRAIN_CRASH)}")
        unsharded, _ = ckpt.restore(ref_dir, TRAIN_CRASH, {"params": model, "opt": state},
                                    device="cpu")
        same(unsharded, model, state, "lm-sharded: sharded against the unsharded run")
        del unsharded
        log(f"lm-sharded {LM_ARCH}: {TRAIN_CRASH} steps of {TRAIN_BATCH} x {TRAIN_SEQ} tokens, "
            f"{TRAIN_ACCUM} microbatches, remat, on the one-rank "
            f"{torch.distributed.get_backend()} mesh {tuple(mesh.shape)} over "
            f"{mesh.mesh_dim_names}: s/step {secs} (unsharded "
            f"{reference.get('s_per_step')} over its steps 2-{TRAIN_STEPS}), peak "
            f"{peak / 2**30:.3f} GiB (unsharded {reference.get('peak_gib')}); losses and grad "
            f"norms {got}, bit for bit the unsharded run's; every parameter and AdamW m and v "
            f"bit for bit its step-{TRAIN_CRASH} checkpoint; ops run replicated "
            f"{dict(refused)}")
        summary.update({"s_per_step": secs, "peak_gib": peak / 2**30,
                        "losses": [m["loss"] for m in got_m],
                        "grad_norms": [m["grad_norm"] for m in got_m],
                        "replicated_ops": dict(refused)})

        # (c) the sharded state saved, restored with shardings, one more step
        root = tempfile.mkdtemp(prefix="coconut-smoke-sharded-ckpt-")
        try:
            t0 = time.perf_counter()
            ckpt.save(root, TRAIN_CRASH, {"params": model, "opt": state})
            save_s = time.perf_counter() - t0
            nbytes = dir_bytes(Path(root) / f"step_{TRAIN_CRASH:08d}")
            shardings = {
                "params": {n: (mesh, tuple(p.placements)) for n, p in model.named_parameters()},
                "opt": {k: {n: (mesh, tuple(t.placements)) for n, t in tree.items()}
                        for k, tree in state.items()}}
            t0 = time.perf_counter()
            tree, _ = ckpt.restore(root, TRAIN_CRASH, {"params": model, "opt": state},
                                   shardings=shardings)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
        finally:
            shutil.rmtree(root, ignore_errors=True)
        restored = specs.rebuild(model, lambda n, p: tree["params"][n])
        bad = [n for n, p in restored.named_parameters()
               if not isinstance(p, DTensor) or p.placements != model.get_parameter(n).placements]
        if bad:
            fail(f"lm-sharded: restored leaves not placed as saved, e.g. {bad[:4]}")
        same({"params": dict(model.named_parameters()), "opt": state}, restored, tree["opt"],
             "lm-sharded: the restored checkpoint")
        del model, state
        gc.collect()
        restored, rstate, r_m, r_s = steps(restored, tree["opt"], step_fn, TRAIN_CRASH, 1,
                                           mesh, refused)
        got = [(m["loss"], m["grad_norm"]) for m in r_m]
        if got != metrics_of(TRAIN_CRASH, TRAIN_CRASH + 1):
            fail(f"lm-sharded: step {TRAIN_CRASH + 1} on the restored state {got} != the "
                 f"unsharded run's {metrics_of(TRAIN_CRASH, TRAIN_CRASH + 1)}")
        log(f"lm-sharded {LM_ARCH}: checkpoint of the sharded state, {nbytes:,} bytes saved "
            f"in {save_s:.2f}s, restored with shardings onto the mesh in {restore_s:.2f}s, "
            f"every leaf bitwise; step {TRAIN_CRASH + 1} on it ({r_s[0]:.2f}s) {got}, bit for "
            f"bit the unsharded run's")
        summary.update({"ckpt_bytes": nbytes, "ckpt_save_s": save_s,
                        "ckpt_restore_s": restore_s, "step3": r_m})
        del restored, rstate, tree
        gc.collect()
        torch.cuda.empty_cache()
    finally:
        torch.use_deterministic_algorithms(was[0], warn_only=was[1])
        PD.teardown()
        shutil.rmtree(ref_dir, ignore_errors=True)
    launched = {k: v for k, v in ops.LAUNCHES.items() if v}
    if launched:
        fail(f"lm-sharded: the sharded training launched Coconut kernels {launched}")
    cells = finish_dryruns(torch, runs, out_dir, t_phase)
    summary["dryrun"] = {tag: {k: res[k] for k in ("mem_per_device", "cost_per_device",
                                                   "collective_bytes_per_device",
                                                   "roofline_s", "bottleneck", "lower_s")}
                         for tag, res in cells.items()}
    summary["phase_seconds"] = time.perf_counter() - t_phase
    log(f"lm-sharded: phase {summary['phase_seconds']:.1f}s")
    return summary


# ------------------------------------------------------ phase 18: sanitized
def _sanitizer_error(exc):
    """The ``SanitizerError`` in an exception's chain (an ingest worker's is
    re-raised as the cause of a ``RuntimeError``), or None."""
    from repro_torch.analysis.sanitize import SanitizerError

    seen = set()
    while exc is not None and id(exc) not in seen:
        if isinstance(exc, SanitizerError):
            return exc
        seen.add(id(exc))
        exc = exc.__cause__ or exc.__context__
    return None


def phase_sanitized(torch, ops, serve, engine, shapes):
    """The Coconut main path with the port's runtime sanitizer armed
    (docstring phase 18). Returns the phase's launches and summary."""
    from repro_torch.analysis import sanitize

    t0 = time.perf_counter()
    sanitize.install()
    try:
        if not isinstance(engine._lock, sanitize.RankedLock):
            fail("sanitized: the engine that predates install() kept a plain lock")
        launches, summary = _sanitized(torch, ops, serve, engine, shapes)
    except Exception as e:  # noqa: BLE001 - reported, then the phase fails
        err = _sanitizer_error(e)
        fail(f"sanitized: {type(err or e).__name__}: {err or e}")
    finally:
        sanitize.uninstall()
    if sanitize.installed():
        fail("sanitized: the sanitizer is still armed after the phase")
    summary["seconds"] = time.perf_counter() - t0
    log(f"sanitized: {summary['seconds']:.1f}s under the sanitizer, launches "
        f"{dict(launches)}; disarmed")
    return launches, summary


def _sanitized(torch, ops, serve, engine, shapes):
    """Phase 18's runs, the sanitizer armed: serve with async ingest, then a
    short gateway run with background ingest."""
    argv = ["--scheme", "BTP", "--batches", str(SANITIZED_BATCHES),
            "--batch-size", str(BATCH_SIZE), "--series-len", str(SERIES_LEN),
            "--query-batch", str(QUERY_BATCH), "--window", str(WINDOW),
            "--k", str(K), "--tier", "exact", "--n-blocks", str(N_BLOCKS),
            "--screen-dtype", "f32", "--storage", "model", "--ingest", "async",
            "--device", DEVICE]
    args = serve.build_parser().parse_args(argv)
    log(f"sanitized: python -m repro_torch.launch.serve {' '.join(argv)}")
    t0 = time.perf_counter()
    with probe_tier(torch, ops, engine, "window_knn_batch", shapes) as rec:
        out = serve.serve_coconut(args)
        torch.cuda.synchronize()
    idx = out["index"]
    try:
        idx.close()  # stops the ingest worker; a latched failure is raised here
        wall = time.perf_counter() - t0
        if idx.raw.n != SANITIZED_BATCHES * BATCH_SIZE:
            fail(f"sanitized: ingested {idx.raw.n} series")
        for i, calls in enumerate(rec["calls"]):
            if calls.get("screen_select", 0) == 0:
                fail(f"sanitized: served batch {i + 1} launched no screen ({calls})")
        X = torch.from_numpy(idx.raw.scan()).to(DEVICE)
        for b, t0b, t1b, qs, ids, _ in out["served"]:
            lo, hi = t0b * BATCH_SIZE, (t1b + 1) * BATCH_SIZE
            check_exact(torch, X[lo:hi], qs, torch.from_numpy(ids).to(DEVICE) - lo,
                        f"sanitized batch {b + 1}")
        del X
    finally:
        del out, idx
    launches = collections.Counter(rec["launches"])
    summary = {"served_batches": rec["n"], "serve_launches": dict(rec["launches"]),
               "serve_seconds": wall}
    log(f"sanitized: serve with async ingest, {rec['n']} served batches in {wall:.1f}s, "
        f"each launched screen_select, answers the f64 brute force; launches "
        f"{dict(rec['launches'])}")
    gargv = ["--gateway", "--scheme", "BTP", "--batches", str(SANITIZED_GATEWAY_BATCHES),
             "--batch-size", str(BATCH_SIZE), "--series-len", str(SERIES_LEN),
             "--query-batch", str(GATEWAY_RUNG), "--window", str(SANITIZED_GATEWAY_WINDOW),
             "--k", str(K), "--arrival-rate", str(GATEWAY_RATE),
             "--deadline-ms", str(GATEWAY_DEADLINE_MS), "--slo-p99-ms", str(GATEWAY_SLO_MS),
             "--requests", str(SANITIZED_REQUESTS), "--screen-dtype", "f32",
             "--no-prewarm", "--device", DEVICE]
    gargs = serve.build_parser().parse_args(gargv)
    log(f"sanitized: python -m repro_torch.launch.serve {' '.join(gargv)}")
    t0 = time.perf_counter()
    with probe_gateway(ops) as grec:
        gout = serve.serve_gateway(gargs)
    gwall = time.perf_counter() - t0
    if len(gout["responses"]) != SANITIZED_REQUESTS or \
            gout["index"].raw.n != SANITIZED_GATEWAY_BATCHES * BATCH_SIZE:
        fail(f"sanitized gateway: answered {len(gout['responses'])} of "
             f"{SANITIZED_REQUESTS}, ingested {gout['index'].raw.n}")
    checked = check_gateway_answers(torch, gout, grec["snaps"],
                                    batches=SANITIZED_GATEWAY_BATCHES,
                                    window=SANITIZED_GATEWAY_WINDOW)
    glaunches = collections.Counter(grec["client"])
    glaunches.update(grec["shadow"])
    launches.update(glaunches)
    summary.update({"gateway_requests": SANITIZED_REQUESTS, "gateway_checked": checked,
                    "gateway_launches": dict(glaunches), "gateway_seconds": gwall,
                    "gateway_epochs_pinned": len(grec["snaps"])})
    log(f"sanitized: gateway with background ingest, {SANITIZED_REQUESTS} requests in "
        f"{gwall:.1f}s over {len(grec['snaps'])} pinned epochs, answers checked {checked}, "
        f"measured launches {dict(glaunches)}")
    del gout, grec
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
    """Each kernel at the main path's most frequent shape; and the launch
    floor. Returns (the kernels' entries, the floor in ms or None)."""
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
    # the launch floor: a one-element elementwise kernel's device time, in
    # the same trace-based timing (what a launch costs whatever it does)
    one = torch.zeros(1, device=dev)
    floor_ms, _ = kernel_device_ms(torch, lambda: one.add_(1.0), 50, ("elementwise_kernel",))
    log(f"timing: launch floor (a one-element elementwise kernel, device trace) "
        f"{floor_ms if floor_ms is None else f'{floor_ms:.4f}'} ms")
    return entries, floor_ms


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


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="smoke run of the port on one NVIDIA card")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the LM phase's weights and prompts")
    args = ap.parse_args(argv)
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
    log("file storage: ms/query p50/p95 {:.4f}/{:.4f} against the model backend's "
        "{:.4f}/{:.4f}".format(summary["exact-f32-file"]["p50_ms_per_query"],
                               summary["exact-f32-file"]["p95_ms_per_query"],
                               summary["exact-f32"]["p50_ms_per_query"],
                               summary["exact-f32"]["p95_ms_per_query"]))
    got, summary["mesh"], mesh_topk = phase_mesh(torch, ops, ref, serve, engine,
                                                   model_served)
    launches.update(got)
    del model_served
    log("mesh: ms/query p50/p95 {:.4f}/{:.4f} against the single-device engine's "
        "{:.4f}/{:.4f}".format(summary["mesh"]["serve"]["p50_ms_per_query"],
                               summary["mesh"]["serve"]["p95_ms_per_query"],
                               summary["exact-f32"]["p50_ms_per_query"],
                               summary["exact-f32"]["p95_ms_per_query"]))
    gc.collect()
    torch.cuda.empty_cache()
    summary["lm"] = phase_lm_serve(torch, ops, serve, args.seed)
    gc.collect()
    torch.cuda.empty_cache()
    from repro_torch.launch import train

    got, summary["lm-train"] = phase_lm_train(torch, ops, train, args.seed)
    launches.update(got)
    gc.collect()
    torch.cuda.empty_cache()
    summary["lm-sharded"] = phase_lm_sharded(torch, ops, train, args.seed, summary["lm-train"])
    gc.collect()
    torch.cuda.empty_cache()
    got, summary["sanitized"] = phase_sanitized(torch, ops, serve, engine, shapes)
    launches.update(got)
    for key, c in shapes.most_common(16):
        log(f"main path: call {key} x{c}")
    timed, floor_ms = phase_timing(torch, ops, ref, shapes, worst)
    entries = timed + history_entries
    # topk_ed at the mesh path's own shape (logged)
    case, shape = new_kernel_case(torch, ops, ref, mesh_topk,
                                  torch.Generator(device=DEVICE).manual_seed(2))
    worst["topk_ed"] = max(worst["topk_ed"], case_error(torch, case))
    log(f"timing: topk_ed at the mesh path's shape {shape}: "
        + timing_text(time_case(torch, case), *case.bound()))
    del case
    torch.cuda.empty_cache()
    for e in entries:
        e["launches"] = launches[e["name"]]
        e["max_abs_err"] = worst[e["name"]]
        e["launch_floor_ms"] = floor_ms
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
