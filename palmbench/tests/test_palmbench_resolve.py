"""Every cell, configuration, traffic mix, driver and metric of
BENCHMARK.json resolves by name, and the file keeps to its format."""
import json
import re
from pathlib import Path

import pytest

from palmbench import harness

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["palmbench"]
    assert BENCH["command"][1] == "palmbench/run.py"
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = ([c["name"] for c in BENCH["configs"]] + CELLS
             + [m["name"] for m in METRICS])
    assert len(set(CELLS)) == len(CELLS)
    assert len({m["name"] for m in METRICS}) == len(METRICS)
    for n in names:
        assert NAME.match(n), n


@pytest.mark.parametrize("cell", CELLS)
def test_cell_resolves(cell):
    w, config, traffic = harness.resolve(BENCH, cell)
    assert w["chips"] == 1
    assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    assert config["name"] == w["config"]
    drv = harness.driver(traffic["driver"])
    for fn in ("setup", "step", "release", "judge"):
        assert callable(getattr(drv, fn))
    assert set(traffic["limits"]) == {"dist_gap", "id_gap", "bad_ids"}
    assert config["storage"] == "model" and config["screen_dtype"] == "f32"
    e2e = [m["name"] for m in harness.cell_metrics(BENCH, cell, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = harness.cell_metrics(BENCH, cell, True)
    assert per_layer
    for m in per_layer:
        assert m["moves"] in e2e


@pytest.mark.parametrize("metric", [m["name"] for m in METRICS])
def test_metric_resolves_and_declares_itself(metric):
    m = next(x for x in METRICS if x["name"] == metric)
    mod = harness.metric(metric)
    assert callable(mod.read)
    assert (mod.UNIT, mod.BETTER, mod.SOURCE) == (m["unit"], m["better"], m["source"])
    assert UNIT.match(m["unit"])
    if m in BENCH["per_layer"]:
        assert (mod.LAYER, mod.MOVES) == (m["layer"], m["moves"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    else:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for cell in m.get("workloads", []):
        assert cell in CELLS


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_config_file_states_its_cuts(config):
    c = next(x for x in BENCH["configs"] if x["name"] == config)
    data = json.loads((ROOT / c["file"]).read_text())
    assert c["file"].startswith("palmbench/configs/")
    assert set(c["reduced"]) == set(data["reduced"])
    for key in ("source", "assumed", "guarantees", "published"):
        assert data[key]
    assert len(data["source"]) <= 200
    for key in c["reduced"]:
        assert NAME.match(key) and not key.endswith(("_dim", "_rank", "_len"))


def test_every_config_is_used_by_a_cell():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


def test_readers_skip_what_they_cannot_read():
    empty = harness.Readings(setup_s=1.0, window_s=1.0, records=[], counts={},
                             trace=None, sizes={"series_len": 256, "batch": 64,
                                                "block_size": 1024})
    for m in BENCH["per_layer"]:
        assert harness.metric(m["name"]).read(empty) is None, m["name"]
