"""``BENCHMARK.json`` against the benchmark's contract, and every piece a
cell names found by its name under ``portbench/``."""

import json
import math
import re
from pathlib import Path

import pytest

from portbench import harness

ROOT = Path(__file__).resolve().parent.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert isinstance(BENCH["run_seconds"], int) and 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_a_full_check_with_24_cells_fits_its_time():
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_units_and_one_line_texts():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_configs_files_exist_and_nothing_is_cut():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert c["reduced"] == []
        assert cfg["layers"] == [8, 256, 256, 256, 1]
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_is_found_by_its_name(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert w["chips"] == 1
    spec = json.loads((ROOT / "portbench" / "workloads" / f"{w['name']}.json").read_text())
    for key in ("name", "config", "traffic", "chips", "why"):
        assert spec[key] == w[key]
    assert (ROOT / "portbench" / "traffic" / f"{w['traffic']}.py").exists()
    module = harness.traffic_module(w["traffic"])
    assert all(callable(getattr(module, f)) for f in ("setup", "window", "check"))
    for limit in spec["limits"].values():
        assert isinstance(limit, float) and math.isfinite(limit) and limit > 0
    cell = harness.load_cell(w["name"])
    e2e = {m["name"] for m in cell.metrics("end_to_end")}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert cell.metrics("per_layer")


def test_end_to_end_bounds():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m["bound"] for m in BENCH["end_to_end"]}["setup_s"] == 0.25


@pytest.mark.parametrize("m", BENCH["per_layer"], ids=lambda m: m["name"])
def test_per_layer_metric_has_its_reader_and_moves_a_reported_metric(m):
    assert (ROOT / "portbench" / "metrics" / f"{m['name']}.py").exists()
    assert callable(harness.metric_reader(m["name"]).read)
    moved = [e for e in BENCH["end_to_end"] if e["name"] == m["moves"]]
    assert len(moved) == 1
    for cell in m["workloads"]:
        assert cell in {w["name"] for w in BENCH["workloads"]}
        assert "workloads" not in moved[0] or cell in moved[0]["workloads"]
    if m["name"].endswith("_roofline") or "roofline" in m["name"] or "mfu" in m["name"]:
        assert m["unit"] == "%"


def test_layers_named_alike():
    by_layer = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert "device" in by_layer and len(by_layer["device"]) == 2
