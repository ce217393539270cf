"""The metrics that read the port's host spans: a traced smoke run of each
cell reports each of them, and a program without spans reads nothing."""
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro_torch
from palmbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
SPAN_METRICS = [m for m in BENCH["per_layer"] if m["source"] == "program_span"]


def run(args, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "palmbench/run.py", *args], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("cell", CELLS)
def test_traced_smoke_reports_every_span_metric(cell):
    want = [m["name"] for m in SPAN_METRICS if cell in m["workloads"]]
    assert want
    # the smoke stream first extends its arena in its fourth step: a window
    # of several steps, even on a loaded host
    out = run(["--workload", cell, "--seed", "2147483659", "--seconds", "4",
               "--trace", "1", "--smoke"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    for name in want:
        assert res["metrics"][name]["value"] > 0, name


def test_a_program_without_spans_reads_nothing(monkeypatch):
    r = harness.Readings(setup_s=1.0, window_s=1.0,
                         records=[harness.Request("knn_batch", 0.0, 1.0, 1)],
                         counts={}, trace=None, sizes={})
    # as in a tree that has no spans module: the import fails
    monkeypatch.delattr(repro_torch, "spans", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    for m in SPAN_METRICS:
        assert harness.metric(m["name"]).read(r) is None, m["name"]
