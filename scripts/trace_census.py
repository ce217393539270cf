#!/usr/bin/env python3
"""Count what the profiler keeps of kernel launches on one NVIDIA card.

Traces N back-to-back calls of a hand-written kernel's wrapper (``paa`` and
``sax_pack`` at the query path's 16 rows, ``topk_ed`` at 16 x 32,768, the
f32 ``screen_select`` at 16 queries over 16,384 gathered rows), each call
followed by a torch-native one-element ``add_``, several times at several N,
and puts side by side, per trace: the wrapper's launch count
(``ops.LAUNCHES``), the hand kernel's device records and the ``add_``
kernel's, read raw from ``prof.profiler.kineto_results.events()``, and the
runtime-API launch records (``cudaLaunchKernel`` and the like) the trace
holds, each matched to its device record by correlation id. Every call
runs inside a ``record_function`` range of its own, so a launch record
is placed in the call that made it.

The kernels are compiled once and linked twice, against a static copy of
the CUDA runtime and against the shared one, and each library is traced in
a process of its own; each session is taken bare and with 20 ms of idle
time after it starts and before it stops.

    python3 scripts/trace_census.py [--out FILE] [--reps 3] [--n 4,16,50]

Prints one line per trace and, last, a JSON object of all of them.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEVICE = "cuda"
KERNELS = {"paa": "paa_kernel", "sax_pack": "sax_pack_kernel",
           "topk_ed": "topk_ed_kernel", "screen_select": "screen_dense_kernel"}


def build(variants):
    """Compile the sources once and link one library per runtime variant."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    objs, log = _build.compile_objects("census")
    try:
        out = {}
        for v in variants:
            so = _build.BUILD_DIR / f"libcoconut_kernels-census-{v}.so"
            log += _build.link(objs, so, cudart=v)
            out[v] = so
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                          text=True).stdout.strip().splitlines()[-1]
    return out, nvcc


def cudart_maps():
    """The CUDA runtime libraries mapped into this process."""
    with open("/proc/self/maps") as f:
        return sorted({ln.split()[-1] for ln in f if "libcudart" in ln})


def calls(torch, ops):
    """One call of each wrapper at its shape, on the card."""
    from repro_torch.core import SummarizationConfig

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    cfg = SummarizationConfig(series_len=256, n_segments=16, card_bits=8)
    x16 = torch.randn((16, 256), generator=gen, device=dev)
    p16 = torch.randn((16, 16), generator=gen, device=dev)
    q = torch.randn((16, 256), generator=gen, device=dev)
    xt = torch.randn((32768, 256), generator=gen, device=dev)
    table = torch.randn((1 << 18, 256), generator=gen, device=dev)
    xn2 = (table * table).sum(1)
    rows = torch.randperm(1 << 18, generator=gen, device=dev)[:16384].int()
    return {"paa": lambda: ops.paa(x16, cfg),
            "sax_pack": lambda: ops.sax_and_keys(p16, cfg),
            "topk_ed": lambda: ops.topk_ed(q, xt, 13),
            "screen_select": lambda: ops.screen_select(q, table, xn2, 13, rows=rows)}


def trace(torch, ops, name, fn, n, pad_ms):
    """One profiling session of n calls of fn, each followed by a native
    add_; the counts of what the trace kept."""
    from torch.profiler import ProfilerActivity, profile, record_function

    one = torch.zeros(1, device=DEVICE)
    fn()
    one.add_(1.0)
    torch.cuda.synchronize()
    before = ops.LAUNCHES[name]
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(pad_ms / 1e3)
        for i in range(n):
            with record_function(f"census_ours_{i}"):
                fn()
            with record_function(f"census_native_{i}"):
                one.add_(1.0)
        torch.cuda.synchronize()
        time.sleep(pad_ms / 1e3)
    launches = ops.LAUNCHES[name] - before
    evs = list(prof.profiler.kineto_results.events())
    kname = KERNELS[name]
    ranges, runtime, device = [], [], []
    for e in evs:
        nm = e.name()
        if nm.startswith("census_"):
            _, who, i = nm.split("_")
            ranges.append((e.start_ns(), e.end_ns(), who, int(i)))
        elif str(e.device_type()).endswith("CUDA"):
            device.append(e)
        elif "Launch" in nm and ("cuda" in nm or nm.startswith("cu")):
            runtime.append(e)
    ours = [e for e in device if kname in e.name()]
    native = [e for e in device if "add" in e.name().lower() and kname not in e.name()]

    def ids(e):
        return {e.correlation_id(), e.linked_correlation_id()} - {0}

    by_corr = collections.defaultdict(list)
    for e in device:
        for c in ids(e):
            by_corr[c].append(e)

    def call_of(e):
        for s, t, who, i in ranges:
            if s <= e.start_ns() <= t:
                return who, i
        return None, None

    placed = collections.Counter()
    kept_ours, unmatched_ours = set(), []
    for r in runtime:
        who, i = call_of(r)
        got = [d for c in ids(r) for d in by_corr.get(c, [])]
        placed[who] += 1
        if who == "ours":
            if any(kname in d.name() for d in got):
                kept_ours.add(i)
            elif not got:
                unmatched_ours.append(i)
    corr_runtime = {c for r in runtime for c in ids(r)}
    orphans = sum(1 for e in ours if not ids(e) & corr_runtime)
    return {"kernel": name, "n": n, "pad_ms": pad_ms, "launches": launches,
            "kernel_records": len(ours), "native_records": len(native),
            "device_records": len(device), "runtime_records": len(runtime),
            "runtime_in_our_calls": placed["ours"],
            "runtime_in_native_calls": placed["native"],
            "our_calls_with_runtime_and_kernel": len(kept_ours),
            "our_runtime_without_device_record": len(unmatched_ours),
            "kernel_records_without_runtime_record": orphans,
            "calls_without_kernel_record": sorted(set(range(n)) - kept_ours)[:60]}


def census(lib, label, reps, ns):
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build, ops

    _build.load(Path(lib))
    fns = calls(torch, ops)
    torch.cuda.synchronize()
    out = {"label": label, "cudart_mapped": cudart_maps(), "traces": []}
    print(f"[{label}] runtimes mapped: {out['cudart_mapped']}", flush=True)
    for name, fn in fns.items():
        for pad in (0, 20):
            for n in ns:
                for rep in range(reps):
                    t = trace(torch, ops, name, fn, n, pad)
                    t["rep"] = rep
                    out["traces"].append(t)
                    print(f"[{label}] {name} n={n} pad={pad}ms rep={rep}: launches "
                          f"{t['launches']}, kernel records {t['kernel_records']}, native "
                          f"add records {t['native_records']}, runtime records "
                          f"{t['runtime_records']} ({t['runtime_in_our_calls']} in our "
                          f"calls), ours with runtime+kernel "
                          f"{t['our_calls_with_runtime_and_kernel']}, our runtime without "
                          f"device record {t['our_runtime_without_device_record']}, "
                          f"kernel records without runtime record "
                          f"{t['kernel_records_without_runtime_record']}, calls missing "
                          f"{t['calls_without_kernel_record'][:12]}", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=str(ROOT / "chiprun_out" / "trace_census.json"))
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--n", default="4,16,50")
    ap.add_argument("--variants", default="static,shared")
    ap.add_argument("--lib", default=None, help="(internal) trace this library")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    ns = [int(v) for v in args.n.split(",")]
    if args.lib:
        Path(args.out).write_text(json.dumps(census(args.lib, args.label, args.reps, ns)))
        return 0
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("trace_census: needs an NVIDIA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    print(f"{smi}; torch {torch.__version__}, CUDA {torch.version.cuda}", flush=True)
    t0 = time.perf_counter()
    libs, nvcc = build(args.variants.split(","))
    print(f"build: {time.perf_counter() - t0:.1f}s; {nvcc}", flush=True)
    result = {"device": smi, "torch": torch.__version__, "cuda": torch.version.cuda,
              "nvcc": nvcc, "variants": []}
    for label, so in libs.items():
        part = Path(args.out).with_suffix(f".{label}.json")
        part.parent.mkdir(parents=True, exist_ok=True)
        proc = subprocess.run([sys.executable, __file__, "--lib", str(so), "--label", label,
                               "--reps", str(args.reps), "--n", args.n, "--out", str(part)])
        if proc.returncode != 0:
            raise SystemExit(f"trace_census: the {label} process failed ({proc.returncode})")
        result["variants"].append(json.loads(part.read_text()))
    summary = collections.defaultdict(lambda: collections.Counter())
    for v in result["variants"]:
        for t in v["traces"]:
            key = f"{v['label']} {t['kernel']} pad={t['pad_ms']}"
            s = summary[key]
            s["traces"] += 1
            s["launches"] += t["launches"]
            s["kernel_records"] += t["kernel_records"]
            s["native_records"] += t["native_records"]
            s["native_calls"] += t["n"]
            s["runtime_in_our_calls"] += t["runtime_in_our_calls"]
            s["short_traces"] += int(t["kernel_records"] < t["launches"])
    for key, s in summary.items():
        print(f"summary {key}: {dict(s)}", flush=True)
    result["summary"] = {k: dict(s) for k, s in summary.items()}
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(result))
    print(json.dumps(result["summary"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
