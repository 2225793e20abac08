"""The benchmark's manifest and the files it names.

`BENCHMARK.json` at the root of the checkout lists the configurations, the
cells (`workloads`) and the metrics. Everything that belongs to one
configuration, one traffic mix, one driver, one per-layer metric, one
kernel's count or one cell sits in a file of its own, found by its name:

    portbench/configs/<config>.json    the deployment: pipeline settings,
                                       rig, scene, offline fusion batch
    portbench/mixes/<traffic>.json     the traffic mix: the driver it names
                                       and its parameters
    portbench/drivers/<driver>.py      a driver: `run(run)` drives the port
                                       with a mix, `control(case, ...)` puts
                                       the control in the program's place
    portbench/metrics/<metric>.py      a per-layer metric's reader
    portbench/counts/<kernel>.py       a kernel's roofline bound
    portbench/cells/<workload>.json    the cell's check: what it samples
                                       (`check`), what a traced run traces
                                       (`trace`), the limits (`numbers`)

A later change adds a configuration, a mix, a metric or a cell by adding
such files and entries; no file here needs an edit for it.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import NamedTuple

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
MANIFEST = ROOT / "BENCHMARK.json"


class Cell(NamedTuple):
    """One cell of the manifest with everything it names, loaded."""

    name: str
    workload: dict        # the manifest's entry
    config: dict          # configs/<config>.json
    mix: dict             # mixes/<traffic>.json
    limits: dict          # cells/<workload>.json `numbers`: name -> {"limit": ...}
    end_to_end: list      # the manifest's end-to-end metrics this cell reports
    per_layer: list       # the manifest's per-layer metrics this cell reports
    check: dict           # cells/<workload>.json `check`: what the check samples
    trace: dict           # cells/<workload>.json `trace`: what a traced run traces


def load_manifest(path: Path = MANIFEST) -> dict:
    with open(path) as f:
        return json.load(f)


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark names {path.relative_to(ROOT)}, which is missing")
    with open(path) as f:
        return json.load(f)


def reports(metric: dict, workload: str) -> bool:
    """Whether a metric of the manifest is reported in this cell: listed
    there by its `workloads`, or everywhere when it has none."""
    return "workloads" not in metric or workload in metric["workloads"]


def load_cell(name: str, manifest: dict | None = None) -> Cell:
    manifest = load_manifest() if manifest is None else manifest
    by_name = {w["name"]: w for w in manifest["workloads"]}
    if name not in by_name:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; it has {sorted(by_name)}")
    wl = by_name[name]
    configs = {c["name"]: c for c in manifest["configs"]}
    config = _json(ROOT / configs[wl["config"]]["file"])
    mix = _json(BENCH_DIR / "mixes" / f"{wl['traffic']}.json")
    cell = _json(BENCH_DIR / "cells" / f"{name}.json")
    e2e = [m for m in manifest["end_to_end"] if reports(m, name)]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in manifest["per_layer"]
                 if (name in m["workloads"] if "workloads" in m else m["moves"] in moved)]
    return Cell(name, wl, config, mix, cell["numbers"], e2e, per_layer, cell["check"],
                cell["trace"])


def driver(name: str):
    """The module portbench/drivers/<name>.py (its `run` and `control`)."""
    if not (BENCH_DIR / "drivers" / f"{name}.py").is_file():
        raise FileNotFoundError(f"a mix names the driver {name!r}: portbench/drivers/{name}.py "
                                "is missing")
    return importlib.import_module(f"portbench.drivers.{name}")


def load_module(path: Path, label: str):
    """A Python file of the benchmark loaded as a module of its own (metric
    readers and counts have dots in their names, so they are not imported
    by package path)."""
    if not path.is_file():
        raise FileNotFoundError(f"the benchmark names {path.relative_to(ROOT)}, which is missing")
    spec = importlib.util.spec_from_file_location(label, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """`read(ctx)` of portbench/metrics/<name>.py."""
    return load_module(BENCH_DIR / "metrics" / f"{name}.py", f"portbench_metric_{name}").read


def kernel_count(kernel: str):
    """The module portbench/counts/<kernel>.py (its `bound_ms` and `NAME`)."""
    return load_module(BENCH_DIR / "counts" / f"{kernel}.py", f"portbench_count_{kernel}")
