"""The offline mix: recorded sequences replayed through the port's
captured `Pipeline.run_offline`, each call from the initial state, the
call ending in a device synchronize.

Set-up makes a pool of sequences from the seed and puts them on the
device, then replays each once (the first call captures the graph). The
window replays the pool in turn until `--seconds` have passed; the frames
replayed over the window's whole time give `offline_fps`. The call whose
outputs the reference checks is drawn from the seed among the window's
first pool-size calls. A traced run replays the cell's `trace.calls` more
calls under the profiler after the window.
"""

from __future__ import annotations

import contextlib
import time

import torch

from portbench.lib import precision, scene as scene_lib


def run(run):
    from smartedgesensor3dhumanpose_tpu_torch import pipeline
    from smartedgesensor3dhumanpose_tpu_torch.types import Frame

    from portbench.lib import harness, judge, trace as trace_lib

    mix, cfg = run.cell.mix, run.cell.config
    frames, pool = int(mix["sequence_frames"]), int(mix["pool"])
    rng = scene_lib.seed_stream(run.seed, 2)
    seeds = [int(s) for s in rng.integers(0, 2**62, size=pool)]
    host_data = [scene_lib.scene(cfg, mix, frames, s) for s in seeds]
    run.mark("scenes")
    pipe = run.pipeline()
    dev = pipe.device
    seqs = [Frame.from_arrays(d, dev) for d in host_data]
    state0 = pipe.init_state()
    if run.trace:
        pipe._offline.keep_graph = True
    run.mark("pipeline")
    pipe.run_offline(state0, seqs[0])
    pipeline.synchronize(dev)
    run.mark("graph capture")
    for seq in seqs[1:]:
        pipe.run_offline(state0, seq)
    pipeline.synchronize(dev)
    run.mark("warm-up")
    sample_call = int(rng.integers(0, pool))
    sample_frames = rng.choice(frames, size=min(int(run.cell.check["sample_frames"]), frames),
                               replace=False)

    def call(i, annotate):
        scope = torch.profiler.record_function("portbench.call") if annotate \
            else contextlib.nullcontext()
        with scope:
            state, out = pipe.run_offline(state0, seqs[i % pool])
            pipeline.synchronize(dev)
        return state, out

    t0 = time.perf_counter()
    setup_s = t0 - run.t_start
    calls, ends, kept = 0, [], None
    while True:
        state, out = call(calls, False)
        ends.append(time.perf_counter())
        if calls == sample_call:
            kept = (state, out)
        calls += 1
        if ends[-1] - t0 >= run.seconds:
            break
    elapsed = ends[-1] - t0
    harness.note(f"window: {calls} calls of {frames} frames in {elapsed:.4f} s")
    half = calls // 2
    harness.note("window halves: %.4f / %.4f frames/s"
                 % (half * frames / (ends[half - 1] - t0),
                    (calls - half) * frames / (ends[-1] - ends[half - 1])))
    e2e = {"setup_s": setup_s, "offline_fps": calls * frames / elapsed}
    layer = {"mode": "offline", "frames": frames}
    if run.trace:
        layer["graph_kernels"] = harness.graph_kernel_nodes(pipe._offline)
        n = int(run.cell.trace["calls"])
        with trace_lib.Profiler() as prof:
            for i in range(n):
                call(i, True)
        layer["trace"] = prof.result(
            replays=n, per_replay=harness.launches_per_replay(run, "offline", frames))
    run.read_memory()
    checked = judge.OfflineCase(run, host_data[sample_call], kept[1], kept[0], sample_frames)
    del pipe, seqs, kept
    return harness.Outcome(calls, 0, e2e, layer, checked)


def control(case, device, arith: str):
    """The offline case with the control's replay of the checked call in
    the program's place: the plain reference at `arith` (lib/precision.py)
    on the card."""
    from portbench.lib import judge
    from portbench.reference import pipeline as ref_pipeline
    from portbench.reference import replay

    with precision.arithmetic(arith):
        state, out = ref_pipeline.run_offline(
            precision.on(judge.ref_state0(case.cfg), device, arith),
            precision.on(replay.frame(case.frames, torch.float32, device), device, arith),
            precision.on(case.rig, device, arith), case.cfg, case.fusion_batch)
    case.out, case.state = judge.host(out), judge.host(state)
    return case
