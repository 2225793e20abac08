"""One run of one cell: set-up, the measured window, the check against the
plain reference, and the result line.

The driver that the mix names (portbench/drivers/<driver>.py) runs the
program and returns an `Outcome`; this module turns it into the line the
benchmark prints: with `--trace 0` the cell's end-to-end metrics, with
`--trace 1` its per-layer metrics (each read by portbench/metrics/<name>.py
from the run's spans, counters and trace). The numbers compared with the
reference are printed last on standard error and last in the line.
"""

from __future__ import annotations

import ctypes
import json
import sys
import time
from typing import Callable, NamedTuple, Optional

import torch

from portbench.lib import manifest, scene as scene_lib

# Top-level module names a run must not have loaded (whole names: the
# port's package name begins with the JAX package's).
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "optax", "smartedgesensor3dhumanpose_tpu")


class Outcome(NamedTuple):
    attempted: int
    failed: int
    e2e: dict          # end-to-end metric name -> value
    layer: dict        # what the per-layer readers read
    case: object       # judge case: .check() -> (numbers, work)


class Run:
    """One run's settings and the helpers the drivers share."""

    def __init__(self, cell: manifest.Cell, seed: int, seconds: float, trace: bool,
                 t_start: float, device: torch.device, fault: Optional[Callable] = None):
        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.trace = trace
        self.t_start = t_start
        self.device = device
        self.fault = fault
        self.memory_peak = 0
        self._mark = t_start
        self.setup_split = {}

    def mark(self, stage: str) -> None:
        """Close a stage of set-up (host clock since the previous mark)."""
        now = time.perf_counter()
        self.setup_split[stage] = now - self._mark
        self._mark = now

    def pipeline(self):
        """The port's Pipeline of this cell, on the run's device, with the
        kernels and the native runtime built (a cell's first run in a
        checkout compiles them)."""
        from smartedgesensor3dhumanpose_tpu_torch import _kernels, config, pipeline, sync
        from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig

        cfg = self.cell.config
        self.mark("inputs")
        if self.device.type == "cuda":
            _kernels.library()
        sync.native_lib()
        self.mark("kernel and runtime libraries")
        rig = CameraRig(*(t.to(self.device) for t in scene_lib.rig_arrays(cfg)))
        pipe = pipeline.Pipeline(rig, scene_lib.make_config(config, cfg), device=self.device,
                                 fusion_batch=int(cfg["fusion_batch"]))
        if self.fault is not None:
            self.fault(pipe)
        return pipe

    def read_memory(self) -> None:
        """The device's peak memory so far (before the reference runs)."""
        if self.device.type == "cuda":
            self.memory_peak = torch.cuda.max_memory_allocated(self.device)


def note(line: str) -> None:
    print(line, file=sys.stderr, flush=True)


def graph_kernel_nodes(captured) -> Optional[int]:
    """Kernel nodes at the top level of a CapturedFunction's graph (the
    driver's cuGraphGetNodes and cuGraphNodeGetType); None off the card."""
    graphs = getattr(captured, "graphs", None)
    if not graphs:
        return None
    raw = ctypes.c_void_p(next(iter(graphs.values())).graph.raw_cuda_graph())
    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    if cu.cuGraphGetNodes(raw, None, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    nodes = (ctypes.c_void_p * n.value)()
    if cu.cuGraphGetNodes(raw, nodes, ctypes.byref(n)) != 0:
        raise RuntimeError("cuGraphGetNodes failed")
    kernels = 0
    for node in nodes:
        kind = ctypes.c_int(-1)
        cu.cuGraphNodeGetType(ctypes.c_void_p(node), ctypes.byref(kind))
        kernels += kind.value == 0  # CU_GRAPH_NODE_TYPE_KERNEL
    return kernels


def launches_per_replay(run: Run, mode: str, frames: int = 0) -> dict:
    """Launches of each hand-written kernel one replay holds, from the
    configuration's `launches`: per live step (`step`), per offline call
    per fusion chunk (`chunk`) and once (`call`)."""
    table = run.cell.config["launches"]
    if mode == "live":
        return dict(table["step"])
    chunks = -(-frames // int(run.cell.config["fusion_batch"]))
    out = {k: v * chunks for k, v in table["chunk"].items()}
    for k, v in table["call"].items():
        out[k] = out.get(k, 0) + v
    return out


def device_info(run: Run) -> dict:
    if run.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(run.device),
            "count": int(run.cell.workload["chips"]), "memory_peak_bytes": int(run.memory_peak)}


def forbidden_loaded() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN_MODULES))


def execute(run: Run) -> tuple:
    """Run the cell; returns (result dict, checks dict)."""
    driver = manifest.driver(run.cell.mix["driver"])
    run.mark("import")
    out = driver.run(run)
    note("set-up: " + ", ".join(f"{k} {v:.3f} s" for k, v in run.setup_split.items()))
    t0 = time.perf_counter()
    numbers, work = out.case.check()
    note(f"judge: the reference's check took {time.perf_counter() - t0:.2f} s")
    limits = run.cell.limits
    checks = {name: {"value": numbers[name], "limit": limit["limit"]}
              for name, limit in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    units = {m["name"]: m["unit"] for m in run.cell.end_to_end + run.cell.per_layer}
    metrics = {}
    result = {"correct": correct, "attempted": int(out.attempted), "failed": int(out.failed)}
    if run.trace:
        ctx = dict(out.layer, work=work, cell=run.cell)
        for m in run.cell.per_layer:
            value = manifest.metric_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": units[m["name"]]}
        device = device_info(run)
        tr = out.layer.get("trace")
        if tr is not None:
            device.update(busy_s=tr.busy_s, window_s=tr.window_s)
            result["breakdown"] = tr.breakdown
    else:
        for m in run.cell.end_to_end:
            metrics[m["name"]] = {"value": float(out.e2e[m["name"]]), "unit": m["unit"]}
        device = device_info(run)
    result["metrics"] = metrics
    result["device"] = device
    result["checks"] = checks
    return result, checks


def emit(result: dict, checks: dict) -> None:
    """The numbers compared, last on standard error; the result line, last
    on standard output."""
    for name, c in checks.items():
        note(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
