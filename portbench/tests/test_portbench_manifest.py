"""BENCHMARK.json against the benchmark's contract, and every file it
names found by name."""

import json
import re

import pytest

from portbench.lib import manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
M = manifest.load_manifest()
CELLS = [w["name"] for w in M["workloads"]]


def test_top_level_keys_and_size():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads",
                      "end_to_end", "per_layer"}
    assert len(manifest.MANIFEST.read_bytes()) <= 64 * 1024
    assert M["command"] == ["python3", "portbench/run.py"]
    assert M["paths"] == ["portbench"]
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_names_and_units():
    names = [c["name"] for c in M["configs"]] + CELLS
    names += [m["name"] for m in M["end_to_end"] + M["per_layer"]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in M["end_to_end"] + M["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in M["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    setup = [m for m in M["end_to_end"] if m["name"] == "setup_s"]
    assert setup and setup[0]["bound"] <= 0.25 and "workloads" not in setup[0]
    for m in M["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert 1 <= len(m["layer"]) <= 200
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_roofline_names():
    for m in M["per_layer"]:
        if "roofline" in m["name"]:
            assert m["name"].split(".")[0].endswith("_roofline") and m["unit"] == "%"


@pytest.mark.parametrize("cell", CELLS)
def test_cell_files_found_by_name(cell):
    c = manifest.load_cell(cell, M)
    assert c.config["name"] == c.workload["config"]
    driver = manifest.driver(c.mix["driver"])
    assert callable(driver.run) and callable(driver.control)
    assert c.limits and c.check and c.trace
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]))


@pytest.mark.parametrize("cell", CELLS)
def test_every_cell_reports_setup_another_e2e_and_a_layer(cell):
    c = manifest.load_cell(cell, M)
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer


def test_per_layer_cells_report_what_they_move():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    for m in M["per_layer"]:
        moved = e2e[m["moves"]]
        for cell in m["workloads"]:
            assert cell in CELLS
            assert manifest.reports(moved, cell), (m["name"], cell)


def test_configs_files_and_sources():
    files = [c["file"] for c in M["configs"]]
    assert len(files) == len(set(files))
    used = {w["config"] for w in M["workloads"]}
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"].startswith("portbench/")
        assert c["reduced"] == []
        assert 1 <= len(c["source"]) <= 200
        body = json.loads((manifest.ROOT / c["file"]).read_text())
        assert body["name"] == c["name"] and body["reduced"] == []


def test_layers_named_alike():
    # Metrics of one layer give it letter for letter.
    layers = {m["layer"] for m in M["per_layer"]}
    assert all(layer == layer.strip() and "\n" not in layer for layer in layers)
