"""Runs one cell of ``BENCHMARK.json``: set-up, the measured window, the
reading of the metrics and the comparison that decides ``correct``.

A cell names a configuration (``configs/<name>.json``) and a traffic mix
(``traffic/<name>.json``); the mix names its driver (``drivers/<kind>.py``,
with ``setup``, ``step``, ``release`` and ``judge``); every metric has its
reader (``metrics/<name>.py``, with ``read``). Nothing here knows a cell by
name, so a later cell, mix, driver or metric is new files and new entries.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import gc
import importlib.util
import json
import os
import resource
import sys
import time
from pathlib import Path

from . import judge
from .gen import RowStream

HERE = Path(__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")  # top-level module names


@dataclasses.dataclass
class Request:
    kind: str  # the index call, e.g. "knn_batch", "ingest"
    t0: float  # perf_counter at submission
    t1: float  # perf_counter at the answer
    items: int  # queries asked, or series ingested


@dataclasses.dataclass
class Readings:
    """What the metric readers read."""
    setup_s: float
    window_s: float  # from the first timed request to the last answer
    records: list  # [Request] of the window
    counts: dict  # driver counts, engine and launch counters over the window
    trace: object  # trace.Summary of the traced window, else None
    sizes: dict  # the configuration and the traffic mix, merged


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod  # dataclasses look their module up by name
    spec.loader.exec_module(mod)
    return mod


def metric(name: str):
    return load_module(HERE / "metrics" / f"{name}.py", f"palmbench_metric_{name}")


def driver(kind: str):
    return load_module(HERE / "drivers" / f"{kind}.py", f"palmbench_driver_{kind}")


def resolve(bench: dict, workload: str) -> tuple[dict, dict, dict]:
    """(cell, configuration, traffic mix) of a cell named in ``bench``."""
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"unknown workload {workload!r}: {sorted(cells)}")
    cell = cells[workload]
    cfg_entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]
    root = HERE.parent
    config = load_json(root / cfg_entry["file"])
    traffic = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, config, traffic


def cell_metrics(bench: dict, cell: str, traced: bool) -> list[dict]:
    """The metrics a cell reports: its end-to-end ones untraced, its
    per-layer ones traced."""
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if "workloads" not in m or cell in m["workloads"]]


class Context:
    """One run: sizes, seeds, the device, the window's records and counts."""

    def __init__(self, config, traffic, seed, trace, device, smoke=False):
        self.sizes = {**config, **traffic}
        if smoke:
            self.sizes.update(config.get("smoke", {}))
            self.sizes.update(traffic.get("smoke", {}))
        self.seed, self.trace, self.device = seed, trace, device
        self.records: list = []
        self.counts: dict = {}
        self.answers: list = []
        self.recording = False
        self.marks: list = []  # [(set-up phase, perf_counter at its end)]
        self.host: dict = {}  # the window's use of the host, by getrusage

    def stream(self, label: str, chunk_rows: int) -> RowStream:
        return RowStream(self.seed, label, self.sizes["series_len"],
                         self.device, chunk_rows,
                         self.sizes.get("quake_frac", 0.1))

    def call(self, kind: str, items: int, fn):
        """Time one call into the index; inside the window it is recorded
        (and, traced, marked as a ``palmbench.<kind>`` span)."""
        span = contextlib.nullcontext()
        if self.recording and self.trace:
            import torch

            span = torch.profiler.record_function(f"palmbench.{kind}")
        t0 = time.perf_counter()
        with span:
            out = fn()
        t1 = time.perf_counter()
        if self.recording:
            self.records.append(Request(kind, t0, t1, items))
        return out

    def mark(self, phase: str) -> None:
        """Close a phase of set-up (reported on standard error)."""
        self.marks.append((phase, time.perf_counter()))

    def count(self, **values) -> None:
        if self.recording:
            for k, v in values.items():
                self.counts[k] = self.counts.get(k, 0) + v

    def answer(self, item) -> None:
        if self.recording:
            self.answers.append(item)


def _counters(device) -> dict:
    """The program's own counters: the verify engine's and the kernels'."""
    from repro_torch.core.verify_engine import get_engine
    from repro_torch.kernels import ops

    st = get_engine(device).stats
    out = {f"engine.{k}": v for k, v in st.items() if isinstance(v, (int, float))}
    out.update({f"launch.{k}": v for k, v in ops.LAUNCHES.items()})
    return out


def _window(ctx: Context, drv, state, seconds: float):
    """One measured window: requests until ``seconds`` have passed, then
    the last answer; returns (window_s, counter changes, trace summary)."""
    import torch

    from . import trace as tr

    ctx.records, ctx.counts = [], {}
    before = _counters(ctx.device)
    prof = tr.start(torch, ctx.device) if ctx.trace else None
    usage = resource.getrusage(resource.RUSAGE_SELF)
    t_open_ns = time.time_ns()
    t_open = time.perf_counter()
    ctx.recording = True
    while time.perf_counter() - t_open < seconds:
        drv.step(ctx, state)
    ctx.recording = False
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
    t_close = time.perf_counter()
    t_close_ns = time.time_ns()
    ctx.host = _host_use(usage, resource.getrusage(resource.RUSAGE_SELF))
    after = _counters(ctx.device)
    delta = {k: after[k] - before.get(k, 0) for k in after}
    summary = None
    if prof is not None:
        tr.stop(torch, prof, ctx.device)
        launches = {k[len("launch."):]: v for k, v in delta.items()
                    if k.startswith("launch.")}
        summary = tr.read(prof, t_open_ns, t_close_ns, launches)
    return t_close - t_open, {**ctx.counts, **delta}, summary, t_open


def _host_use(a, b) -> dict:
    """CPU seconds the process took between two ``getrusage`` readings, in
    user and in system code (the card's machine reports no page faults or
    context switches)."""
    return {f[3:]: round(getattr(b, f) - getattr(a, f), 6)
            for f in ("ru_utime", "ru_stime")}


def _forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run(root: Path, workload: str, seed: int, seconds: float, trace: bool,
        t_start: float, smoke: bool = False, control: bool = False) -> tuple:
    """Run one cell; returns (result dict, checks dict, control readings).

    ``smoke`` runs on the CPU with torch on one thread: torch's first
    parallel CPU operations in a process can write a block of rows
    differently from later ones (seen in about one process in thirty), so
    the CPU inputs would not be a function of the seed alone."""
    import torch

    threads = torch.get_num_threads()
    if smoke:
        torch.set_num_threads(1)
    try:
        return _run(root, workload, seed, seconds, trace, t_start, smoke,
                    control)
    finally:
        torch.set_num_threads(threads)


def _run(root, workload, seed, seconds, trace, t_start, smoke, control):
    import torch

    bench = load_json(root / "BENCHMARK.json")
    _, config, traffic = resolve(bench, workload)
    device = torch.device("cpu" if smoke else "cuda", None if smoke else 0)
    ctx = Context(config, traffic, seed, trace, device, smoke)
    drv = driver(traffic["driver"])
    ctx.mark("imports")
    state = drv.setup(ctx)
    window_s, counts, summary, t_open = _window(ctx, drv, state, seconds)
    if summary is not None and summary.short:
        # F5: a trace that kept fewer kernel records than were launched is
        # never read; the window is traced once more
        print(f"palmbench: the trace kept {summary.short} (records, launches); "
              "tracing the window again", file=sys.stderr)
        window_s, counts, summary, t_open = _window(ctx, drv, state, seconds)
        if summary.short:
            print(f"palmbench: the second trace kept {summary.short}; "
                  "the device metrics are left out", file=sys.stderr)
    setup_s = t_open - t_start
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    records = list(ctx.records)
    drv.release(ctx, state)
    del state
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = drv.judge(ctx, ctx.answers)
    chk = judge.checks(values, ctx.sizes["limits"])
    ctrl = drv.judge(ctx, ctx.answers, control=True) if control else None
    readings = Readings(setup_s, window_s, records, counts,
                        None if summary is None or summary.short else summary,
                        ctx.sizes)
    metrics = {}
    for m in cell_metrics(bench, workload, trace):
        v = metric(m["name"]).read(readings)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev_info = {
        "platform": "gpu" if device.type == "cuda" else "cpu",
        "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
        "count": 1,
        "memory_peak_bytes": int(peak),
    }
    result = {"correct": judge.passed(chk),
              "attempted": len(records), "failed": 0,
              "metrics": metrics, "device": dev_info}
    if summary is not None:
        dev_info["busy_s"] = summary.busy_s
        dev_info["window_s"] = summary.window_s
        result["breakdown"] = {"device_ops": summary.device_ops,
                               "idle_gaps": summary.idle_gaps}
    result["checks"] = chk
    phases, last = [], t_start
    for phase, t in ctx.marks:
        phases.append(f"{phase} {t - last:.3f} s")
        last = t
    print("set-up: " + ", ".join(phases), file=sys.stderr)
    print(f"window host: {window_s:.3f} s, "
          + ", ".join(f"{k} {v}" for k, v in ctx.host.items()), file=sys.stderr)
    return result, chk, ctrl


def parse(argv):
    ap = argparse.ArgumentParser(prog="palmbench/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes on the CPU (tests only; no device numbers)")
    ap.add_argument("--control", action="store_true",
                    help="also judge the TF32 control against the reference")
    return ap.parse_args(argv)


def main(argv, t_start: float, root: Path) -> int:
    args = parse(argv)
    build = root / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    import torch

    if not args.smoke:
        bench = load_json(root / "BENCHMARK.json")
        chips = resolve(bench, args.workload)[0]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
            print(f"palmbench: {args.workload} needs {chips} CUDA card(s); "
                  f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
            return 2
    result, chk, ctrl = run(root, args.workload, args.seed, args.seconds,
                            bool(args.trace), t_start, args.smoke, args.control)
    bad = _forbidden_modules()
    if bad:
        print(f"palmbench: the run loaded {bad}, which the port must not use",
              file=sys.stderr)
        return 3
    if ctrl is not None:
        print("control " + json.dumps(ctrl), file=sys.stderr)
    for name, c in chk.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
