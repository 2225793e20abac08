"""The program's own spans and counters (the port's tracing.py), for the
per-layer readers of a traced run.

The readers of these metrics call `program(ctx)`. Its first call runs one
more phase after the traced run's others and keeps what it read in `ctx`
(the harness hands every reader the same `ctx`); a later call, or a ctx
whose driver already put the records under "program", reads them there.
The phase runs in a process of its own (`python3 -m portbench.lib.spans
--workload <cell> --seed <n>`, its records pickled to standard output):
after the traced run's torch.profiler session, a graph's launch call in
that process took 2.1 ms a step instead of 0.11 and 13.5 ms a call instead
of 0.37 (H100), which would stretch every host span around a replay.

- Live: a second pipeline is built with `trace=True` as the run builds
  its own (the cell's configuration, rig and fusion batch), its step graph
  captured by stepping the cell's warm-up frames directly, off the clock.
  Then the live loop runs as in the window (portbench/drivers/live.py
  `run_phase`: the open-loop generator, the native synchronizer, the
  latest-wins slot, the frame builder) over `LIVE_FRAMES` more frames of
  the same scene, with the pipeline's tracer recording, no profiler.
- Offline: a traced pipeline replays `OFFLINE_CALLS` calls of the cell's
  recordings (captured and warmed first), each inside a host span `call`.

The scene comes from the run's `--seed`. What the phase gives (a dict):
`mode`, `records` (the drained tracing.Records), and live the loop's set
table (`sets`, online.OnlineSyncedReport.sets), the generator's lateness
and due times and the benchmark's own step records (`steps`); offline
`frames`, the frames of a call. Where the port has no tracer (a checkout
before it), `program` returns None and so does every reader.
"""

from __future__ import annotations

import argparse
import importlib.util
import pickle
import subprocess
import sys

import numpy as np
import torch

from portbench.lib import manifest, scene as scene_lib

# Frames of the live phase (8 s at 30 Hz: the p95 has 12 sets beyond it)
# and calls of the offline one; the phase's process is given CHILD_S.
LIVE_FRAMES = 240
OFFLINE_CALLS = 24
CHILD_S = 180
PORT = "smartedgesensor3dhumanpose_tpu_torch"


def traced_port() -> bool:
    """Whether the port has the recorder and the `trace` switch."""
    if importlib.util.find_spec(f"{PORT}.tracing") is None:
        return False
    import inspect

    from smartedgesensor3dhumanpose_tpu_torch import pipeline

    return "trace" in inspect.signature(pipeline.Pipeline.__init__).parameters


def run_seed(argv=None) -> int:
    """The run's `--seed` (portbench/run.py's command line), else 0."""
    argv = sys.argv[1:] if argv is None else argv
    for i, arg in enumerate(argv):
        if arg == "--seed" and i + 1 < len(argv):
            return int(argv[i + 1])
        if arg.startswith("--seed="):
            return int(arg.split("=", 1)[1])
    return 0


def program(ctx):
    """The records of the program's own tracing for this run (module
    docstring), or None where the port has no tracer."""
    if "program" not in ctx:
        ctx["program"] = None
        if traced_port() and ctx.get("mode") in ("live", "offline"):
            ctx["program"] = run_phase(ctx["cell"], run_seed())
    return ctx["program"]


def run_phase(cell, seed: int) -> dict:
    """The phase of `cell` in a process of its own (module docstring); its
    standard error is passed on."""
    from portbench.lib.harness import note

    cmd = [sys.executable, "-m", "portbench.lib.spans", "--workload", cell.name,
           "--seed", str(seed)]
    done = subprocess.run(cmd, cwd=manifest.ROOT, capture_output=True, timeout=CHILD_S)
    for line in done.stderr.decode(errors="replace").splitlines():
        note(line)
    if done.returncode != 0:
        raise RuntimeError(f"the traced phase's process exited with {done.returncode}")
    return pickle.loads(done.stdout)


def phase(cell, seed: int, frames: int = 0, calls: int = 0) -> dict:
    """The phase of `cell` in this process (`frames` / `calls`: 0 for the
    module's sizes)."""
    if cell.mix["driver"] == "live":
        return live_phase(cell, seed, frames or LIVE_FRAMES)
    return offline_phase(cell, seed, calls or OFFLINE_CALLS)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the traced phase of a cell; pickled records "
                                            "on standard output")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    prog = phase(manifest.load_cell(args.workload), args.seed)
    sys.stdout.buffer.write(pickle.dumps(prog))
    sys.stdout.buffer.flush()
    return 0


def _device() -> torch.device:
    return torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")


def traced_pipeline(cell, device):
    from smartedgesensor3dhumanpose_tpu_torch import config, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import CameraRig

    cfg = cell.config
    rig = CameraRig(*(t.to(device) for t in scene_lib.rig_arrays(cfg)))
    return pipeline.Pipeline(rig, scene_lib.make_config(config, cfg), device=device,
                             fusion_batch=int(cfg["fusion_batch"]), trace=True)


def live_phase(cell, seed: int, frames: int) -> dict:
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    from portbench.drivers import live
    from portbench.lib.harness import note

    mix = cell.mix
    warm = int(mix["warmup_frames"])
    data = scene_lib.scene(cell.config, mix, warm + frames, seed)
    dev = _device()
    pipe = traced_pipeline(cell, dev)
    state = pipe.init_state()
    host = {k: v for k, v in data.items() if k != "det_count"}
    for f in range(warm):
        state, _ = pipe.step(state, Frame.from_arrays({k: v[f] for k, v in host.items()}, dev))
    pipeline.synchronize(dev)
    with pipe.tracer:
        phase = live.run_phase(pipe, state, data, warm, warm + frames, set(), False,
                               float(mix["lead_s"]))
    out = {"mode": "live", "records": pipe.tracer.drain(), "sets": phase.report.sets,
           "late": phase.schedule.late, "due": phase.schedule.due,
           "steps": phase.consumer.steps}
    check_live(out, note)
    return out


def offline_phase(cell, seed: int, calls: int) -> dict:
    import time

    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    from portbench.lib.harness import note

    mix, cfg = cell.mix, cell.config
    frames, pool = int(mix["sequence_frames"]), int(mix["pool"])
    rng = scene_lib.seed_stream(seed, 2)
    dev = _device()
    seqs = [Frame.from_arrays(scene_lib.scene(cfg, mix, frames, int(s)), dev)
            for s in rng.integers(0, 2**62, size=pool)]
    pipe = traced_pipeline(cell, dev)
    state0 = pipe.init_state()
    for seq in seqs:
        pipe.run_offline(state0, seq)
    pipeline.synchronize(dev)
    with pipe.tracer as tr:
        for i in range(calls):
            span = tr.open("call", rid=i)
            pipe.run_offline(state0, seqs[i % pool])
            pipeline.synchronize(dev)
            tr.close(span, time.perf_counter_ns())
    out = {"mode": "offline", "records": pipe.tracer.drain(), "frames": frames}
    check_offline(out, note)
    return out


# ----------------------------------------------------------- reading --

def spans_of(prog) -> np.ndarray:
    return prog["records"].spans


def calls(prog, entry: str) -> np.ndarray:
    """Indices of the device spans of an entry point ("Pipeline.step" or
    "Pipeline.run_offline"), one per call."""
    spans = spans_of(prog)
    return np.flatnonzero(spans["name"] == entry)


def stage_ms(prog, entry: str, stage: str, self_time: bool = False) -> np.ndarray:
    """Each call's `stage` span (a stage of the call, or a child of one) in
    ms; with `self_time`, less the spans of its child stages."""
    spans = spans_of(prog)
    out = []
    for c in calls(prog, entry):
        stages = np.flatnonzero(spans["parent"] == c)
        inside = (spans["parent"] == c) | np.isin(spans["parent"], stages)
        mine = np.flatnonzero(inside & (spans["name"] == stage))
        if not len(mine):
            continue
        s = mine[0]
        ns = spans["end"][s] - spans["start"][s]
        if self_time:
            kids = (spans["parent"] == s) & spans["device"] & (spans["name"] != "loop")
            ns -= int(np.sum(spans["end"][kids] - spans["start"][kids]))
        out.append(ns * 1e-6)
    return np.asarray(out)


def counter(prog, scope: str, name: str):
    cs = prog["records"].counters
    hit = cs[(cs["scope"] == scope) & (cs["name"] == name)]
    return int(hit["value"][-1]) if len(hit) else None


def host_of(prog, c: int, name: str):
    """The host span named `name` that holds device span `c` (its replay's
    parent), or None."""
    spans = spans_of(prog)
    p = spans["parent"][c]
    while p >= 0 and spans["name"][p] != name:
        p = spans["parent"][p]
    return None if p < 0 else int(p)


def device_and_host_ms(prog, entry: str, host: str) -> tuple:
    """Per call: (the device span first mark -> last mark, the host span
    `host` holding it), ms."""
    spans = spans_of(prog)
    dev, hst = [], []
    for c in calls(prog, entry):
        h = host_of(prog, c, host)
        if h is None:
            continue
        dev.append((spans["end"][c] - spans["start"][c]) * 1e-6)
        hst.append((spans["end"][h] - spans["start"][h]) * 1e-6)
    return np.asarray(dev), np.asarray(hst)


def set_ms(prog, first: int, last: int) -> np.ndarray:
    """Per stepped set, ms from stamp `first` to stamp `last` of its row
    (online.OnlineSyncedReport.sets: 1 push, 2 pop, 3 packed, 4 taken,
    5 step entry, 6 done)."""
    sets = prog["sets"]
    return (sets[:, last] - sets[:, first]) * 1e-6


def check_live(prog, note) -> None:
    """The tiling the spans promise, on stderr: per stepped set, the
    benchmark's wait (due -> its step entry) less sync.hold, sync.pack,
    slot and frame.build, against the newest message's generator lateness;
    per step, the device span against the host `step` span."""
    sets, due, late = prog["sets"], prog["due"], prog["late"]
    gaps = []
    for row, step in zip(sets, prog["steps"]):
        newest = max(step.handles, key=lambda h: due[h - 1]) - 1
        wait_ns = (step.entry - due[newest]) * 1e9
        gaps.append(wait_ns - (row[5] - row[1]) - late[newest] * 1e9)
    dev, host = device_and_host_ms(prog, "Pipeline.step", "step")
    half = len(dev) // 2
    if half:
        note("spans: stage p50 ms, first / second half of the steps: " + ", ".join(
            "%s %.4f / %.4f" % (s, np.median(ms[:half]), np.median(ms[half:]))
            for s in ("fusion", "tracking", "prior", "feedback")
            for ms in [stage_ms(prog, "Pipeline.step", s)]))
    if gaps:
        note("spans: wait - (hold + pack + slot + build) - lateness: p50 %.1f us, p95 %.1f us, "
             "max %.1f us, min %.1f us, over 50 us %d of %d sets"
             % (np.median(gaps) * 1e-3, np.percentile(gaps, 95) * 1e-3, max(gaps) * 1e-3,
                min(gaps) * 1e-3, int(np.sum(np.asarray(gaps) > 5e4)), len(gaps)))
        names = ("sync.hold", "sync.pack", "slot", "frame.build", "step")
        note("spans: p50 / p95 ms: " + ", ".join(
            "%s %.4f / %.4f" % (n, *np.percentile(set_ms(prog, k + 1, k + 2), [50, 95]))
            for k, n in enumerate(names)))
    if len(dev):
        note("spans: %d steps, device span %.4f ms p50 of host step %.4f ms; longest over its "
             "host span by %.4f ms" % (len(dev), np.median(dev), np.median(host),
                                        float(np.max(dev - host))))


def check_offline(prog, note) -> None:
    dev, host = device_and_host_ms(prog, "Pipeline.run_offline", "call")
    if len(dev):
        note("spans: %d calls, device span %.4f ms p50 of host call %.4f ms; longest over its "
             "host span by %.4f ms" % (len(dev), np.median(dev), np.median(host),
                                        float(np.max(dev - host))))


def offline_stage(ctx, stage: str):
    """Median over the traced offline calls of a stage's device ms over the
    call's frames, or None."""
    prog = program(ctx)
    ms = None if prog is None else stage_ms(prog, "Pipeline.run_offline", stage)
    return None if ms is None or not len(ms) else float(np.median(ms)) / prog["frames"]


def offline_edges(ctx, before: bool):
    """Median over the traced offline calls of the host call's entry to the
    graph's first mark (`before`), or of its last mark to the call's end,
    ms; None without records."""
    prog = program(ctx)
    if prog is None:
        return None
    spans = spans_of(prog)
    gaps = []
    for c in calls(prog, "Pipeline.run_offline"):
        h = host_of(prog, c, "call")
        if h is not None:
            gaps.append(spans["start"][c] - spans["start"][h] if before
                        else spans["end"][h] - spans["end"][c])
    return float(np.median(gaps)) * 1e-6 if gaps else None


if __name__ == "__main__":
    sys.exit(main())
