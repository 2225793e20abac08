"""The device trace of a traced phase: torch.profiler's CUPTI events, read
in memory (nothing is written to disk).

From the trace come the device's busy time (the union of its kernel,
copy and set intervals), each hand-written kernel's launch durations,
the idle gaps, each labelled by the benchmark's host range open at the
gap (`portbench.step`, `portbench.frame_build`, `portbench.call`; none
open: waiting for the next set, or between calls), and the breakdown the
result line carries.
"""

from __future__ import annotations

import collections
import time
from typing import NamedTuple

import numpy as np
import torch

RANGES = ("portbench.step", "portbench.frame_build", "portbench.call")
PHASE = "portbench.phase"


def kernel_names() -> dict:
    """Kernel key -> its trace names, from each portbench/counts/<key>.py
    (`TRACE_NAMES`)."""
    from portbench.lib import manifest

    return {p.stem: manifest.kernel_count(p.stem).TRACE_NAMES
            for p in sorted((manifest.BENCH_DIR / "counts").glob("*.py"))}


def kernel_of(name: str, names: dict):
    """The key of `names` whose function `name` (a demangled signature) is."""
    base = short(name)
    for key, fns in names.items():
        if any(base.endswith(n) or f"{n}<" in base for n in fns):
            return key
    return None


def short(name: str) -> str:
    """A device operation's name without its argument list."""
    name = name.replace("(anonymous namespace)", "{anonymous}").replace("operator()", "operator<call>")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


class TraceData(NamedTuple):
    busy_s: float
    window_s: float
    launches: dict        # kernel key -> [device seconds of each launch]
    expected: dict        # kernel key -> launches the replays hold
    spans: dict           # range name -> [(start_s, end_s)], trace clock
    busy: np.ndarray      # merged busy intervals [n, 2], seconds, trace clock
    breakdown: dict

    def complete(self) -> bool:
        """Whether every launch the replays hold is in the trace."""
        return all(len(self.launches.get(k, [])) >= v for k, v in self.expected.items())


def _merge(iv: np.ndarray) -> np.ndarray:
    if len(iv) == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0])]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


class Profiler:
    """torch.profiler over a traced phase: `with Profiler() as p:` around
    the phase, then `p.result(...)`."""

    def __enter__(self):
        acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.__enter__()
        self.range = torch.profiler.record_function(PHASE)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        self.range.__exit__(*exc)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.prof.__exit__(*exc)
        self.stop_s = time.perf_counter() - t0
        return False

    def result(self, replays: int, per_replay: dict) -> TraceData:
        t0 = time.perf_counter()
        events = self.prof.profiler.kineto_results.events()
        dev, spans, phase = [], collections.defaultdict(list), None
        for e in events:
            name = e.name()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                if name == PHASE or name in RANGES or getattr(e, "is_user_annotation", bool)():
                    continue
                dev.append((name, e.start_ns() * 1e-9, e.duration_ns() * 1e-9))
            elif name == PHASE:
                phase = (e.start_ns() * 1e-9, e.end_ns() * 1e-9)
            elif name in RANGES:
                spans[name].append((e.start_ns() * 1e-9, e.end_ns() * 1e-9))
        if phase is None:
            raise RuntimeError("the trace holds no phase range")
        lo, hi = phase
        dev = [d for d in dev if lo <= d[1] < hi]
        iv = np.asarray([(s, s + d) for _, s, d in dev], np.float64).reshape(-1, 2)
        busy = _merge(np.clip(iv, lo, hi))
        busy_s = float(np.sum(busy[:, 1] - busy[:, 0])) if len(busy) else 0.0
        launches = collections.defaultdict(list)
        names = kernel_names()
        by_name = collections.defaultdict(float)
        for name, _, d in dev:
            by_name[short(name)] += d
            key = kernel_of(name, names)
            if key is not None:
                launches[key].append(d)
        expected = {k: v * replays for k, v in per_replay.items()}
        # The longest idle gaps inside the phase, each labelled by the range
        # open at its middle.
        edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
        length = edges[:, 1] - edges[:, 0]
        labelled = []
        for i in np.argsort(-length)[:10]:
            if length[i] <= 0:
                break
            mid = 0.5 * (edges[i, 0] + edges[i, 1])
            label = "wait (generator, sync, slot) or between calls"
            for rname in RANGES:
                if any(a <= mid < b for a, b in spans[rname]):
                    label = rname.split(".", 1)[1]
                    break
            labelled.append((label, float(length[i])))
        breakdown = {
            "device_ops": [[n, s] for n, s in sorted(by_name.items(), key=lambda x: -x[1])[:10]],
            "idle_gaps": [[n, s] for n, s in labelled],
        }
        data = TraceData(busy_s, hi - lo, dict(launches), expected, dict(spans), busy, breakdown)
        read_s = time.perf_counter() - t0
        from portbench.lib.harness import note

        note(f"trace: {len(dev)} device operations in {hi - lo:.4f} s, busy {busy_s:.6f} s; "
             f"profiler stop {self.stop_s:.2f} s, read {read_s:.2f} s")
        for key, want in expected.items():
            note(f"trace: {key} traced {len(launches.get(key, []))} launches of the {want} "
                 f"the replayed graphs hold")
        return data
