"""The command end to end on the CPU at the configurations' smoke sizes:
the result line, the compared numbers last on standard error, and
no result without a card or without the program beside the benchmark."""
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]


def run(args, cwd=ROOT, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["CUDA_VISIBLE_DEVICES"] = ""
    return subprocess.run([sys.executable, "palmbench/run.py", *args], cwd=cwd,
                          env=env, capture_output=True, text=True, timeout=timeout)


@pytest.mark.parametrize("cell", CELLS)
def test_smoke_prints_the_result_line(cell):
    out = run(["--workload", cell, "--seed", "3000000019", "--seconds", "0.5",
               "--trace", "0", "--smoke"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["correct"] is True and res["attempted"] > 0 and res["failed"] == 0
    want = [m["name"] for m in BENCH["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]
    assert sorted(res["metrics"]) == sorted(want)
    for v in res["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    assert res["device"]["platform"] == "cpu"  # never a device number
    tail = out.stderr.strip().splitlines()[-len(res["checks"]):]
    assert [line.split()[1] for line in tail] == list(res["checks"])


def test_traced_smoke_reports_no_device_number_from_the_cpu():
    cell = CELLS[0]
    out = run(["--workload", cell, "--seed", "7", "--seconds", "0.5",
               "--trace", "1", "--smoke"])
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert "busy_s" in res["device"] and "breakdown" in res
    for name in res["metrics"]:
        m = next(x for x in BENCH["per_layer"] if x["name"] == name)
        assert m["source"] != "device_trace"


def test_real_command_fails_without_a_card():
    out = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "1",
               "--trace", "0"])
    assert out.returncode != 0
    assert not out.stdout.strip()


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "palmbench", tmp_path / "palmbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = run(["--workload", CELLS[0], "--seed", "1", "--seconds", "0.5",
               "--trace", "0", "--smoke"], cwd=tmp_path)
    assert out.returncode != 0
    assert not out.stdout.strip()
