"""The live mix: per-camera messages on an open-loop schedule through the
port's live loop, `online.run_online_synced` (native approximate-time
sync -> latest-wins slot -> frame builder -> `Pipeline.step`).

The scene's frames are split into phases, each one call of the loop with
a fresh synchronizer: a warm-up (graph capture, tracks published), the
measured window of `--seconds`, and, in a traced run, a traced phase.
In every phase a generator sleeps until each message's due time (its
stamp, on an absolute schedule from the phase's start) and records how
late it ran; the loop pushes each message as soon as the generator yields
it (`message_interval_s=0`). The benchmark wraps the loop's frame builder
and step function: they record each stepped set, its host spans and, for
the sets the seed samples, the program's state before and after.

A set's end-to-end latency runs from the due time of its newest message
to the return of the device synchronize after its step.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

import numpy as np
import torch

from portbench.lib import precision, scene as scene_lib


class Schedule:
    """The messages of frames [a, b) of a scene in stamp order, each due at
    `start + stamp - first stamp`; iterating sleeps until each is due and
    yields (camera, stamp_s, fb_delay, (kp2d, cov2d, score))."""

    def __init__(self, data: dict, a: int, b: int, lead_s: float):
        stamps = np.asarray(data["cam_stamp"][a:b], np.float64)
        order = np.argsort(stamps, axis=None, kind="stable")
        f_idx, c_idx = np.unravel_index(order, stamps.shape)
        self.data = data
        self.frame = f_idx + a
        self.camera = c_idx
        self.stamp = stamps.ravel()[order]
        self.lead_s = lead_s
        self.due = None
        self.late = np.zeros(len(order))

    def __len__(self):
        return len(self.stamp)

    def payload(self, i: int):
        """(fb_delay, kp2d, cov2d, score) of message i (handle i + 1)."""
        d, f, c = self.data, self.frame[i], self.camera[i]
        k = d["det_count"]
        return (float(d["fb_delay"][f, c]), d["kp2d"][f, c, :k], d["cov2d"][f, c, :k],
                d["det_score"][f, c, :k])

    def start(self) -> float:
        """Fix the schedule: the first message is due `lead_s` from now."""
        t0 = time.perf_counter() + self.lead_s
        self.due = t0 + (self.stamp - self.stamp[0])
        return t0

    def __iter__(self):
        for i in range(len(self.stamp)):
            wait = self.due[i] - time.perf_counter()
            if wait > 0:
                time.sleep(wait)
            self.late[i] = time.perf_counter() - self.due[i]
            fb, kp, cov, score = self.payload(i)
            yield int(self.camera[i]), float(self.stamp[i]), fb, (kp, cov, score)


class Step(NamedTuple):
    """One set the loop stepped."""

    handles: tuple     # the set's message handles, one per camera
    stamps_ns: tuple
    built: tuple       # frame builder (start, end), host clock
    entry: float       # step entry, host clock
    exit: float        # the synchronize after the step returned
    record: tuple      # (state before, StepOutput, state after) or ()


class Consumer:
    """The loop's frame builder and step function, wrapped: spans, the
    stepped sets and the sampled records."""

    def __init__(self, pipe, record: set, annotate: bool):
        from smartedgesensor3dhumanpose_tpu_torch import online, pipeline

        self.pipe = pipe
        self.record = record       # step positions whose records are kept
        self.annotate = annotate   # profiler ranges around each span
        self.steps: list = []
        self._build = online.default_frame_builder
        self._sync = pipeline.synchronize
        self._pending = None

    def _range(self, name):
        if not self.annotate:
            return contextlib.nullcontext()
        return torch.profiler.record_function(name)

    def frame_builder(self, fd: dict):
        t0 = time.perf_counter()
        with self._range("portbench.frame_build"):
            frame = self._build(fd, self.pipe.device)
        self._pending = (tuple(fd["handles"]), tuple(int(round(s * 1e9)) for s in fd["cam_stamp"]),
                         (t0, time.perf_counter()))
        return frame

    def step(self, state, frame):
        k = len(self.steps)
        t0 = time.perf_counter()
        with self._range("portbench.step"):
            new_state, out = self.pipe.step(state, frame)
            self._sync(self.pipe.device)
        t1 = time.perf_counter()
        handles, stamps, built = self._pending
        rec = (state, out, new_state) if k in self.record else ()
        self.steps.append(Step(handles, stamps, built, t0, t1, rec))
        return new_state, out


class Phase(NamedTuple):
    schedule: Schedule
    consumer: Consumer
    report: object        # online.OnlineSyncedReport
    start: float          # the first message's due time, host clock
    end: float            # the loop's return, host clock
    state0: object        # the state the phase started from
    state: object         # the state it left


def run_phase(pipe, state, data, a: int, b: int, record: set, annotate: bool,
              lead_s: float) -> Phase:
    from smartedgesensor3dhumanpose_tpu_torch import online

    sched = Schedule(data, a, b, lead_s)
    consumer = Consumer(pipe, record, annotate)
    f = pipe.config.fusion
    t0 = sched.start()
    new_state, _, report = online.run_online_synced(
        consumer.step, state, sched, f.num_cameras, f.max_dets_per_cam,
        message_interval_s=0.0, frame_builder=consumer.frame_builder,
    )
    return Phase(sched, consumer, report, t0, time.perf_counter(), state, new_state)


def set_due(phase: Phase, step: Step) -> float:
    """Due time of the newest message of a stepped set."""
    return max(phase.schedule.due[h - 1] for h in step.handles)


def frames_needed(cell, seconds: float, trace: bool) -> tuple:
    """Frame ranges (warm-up, window, traced) of a run."""
    rate = float(cell.mix["rate_hz"])
    warm = int(cell.mix["warmup_frames"])
    window = int(round(seconds * rate))
    traced = int(cell.trace["frames"]) if trace else 0
    return (0, warm), (warm, warm + window), (warm + window, warm + window + traced)


def sample_positions(check: dict, seed, window_frames: int) -> set:
    """Window steps whose records the reference checks, drawn from the seed."""
    rng = scene_lib.seed_stream(seed, 1)
    n = min(int(check["sample_steps"]), window_frames - 2)
    return set(int(i) for i in rng.choice(window_frames - 2, size=n, replace=False))


def run(run):
    """The live cell: warm-up, the measured window, in a traced run a traced
    phase; returns the harness's Outcome."""
    from portbench.lib import harness, judge, trace as trace_lib

    mix = run.cell.mix
    warm, window, traced = frames_needed(run.cell, run.seconds, run.trace)
    data = scene_lib.scene(run.cell.config, mix, traced[1], run.seed)
    run.mark("scene")
    pipe = run.pipeline()
    if run.trace:
        # Keep the step graph's node list for the kernel count.
        pipe._step.keep_graph = True
    lead = float(mix["lead_s"])
    start_steps = int(run.cell.check["start_steps"])
    run.mark("pipeline")
    warm_phase = run_phase(pipe, pipe.init_state(), data, *warm, set(range(start_steps)),
                           False, lead)
    run.mark("warm-up (graph capture, first tracks)")
    if len(warm_phase.consumer.steps) < start_steps:
        raise RuntimeError(f"the warm-up stepped {len(warm_phase.consumer.steps)} sets, "
                           f"fewer than the {start_steps} the start check needs")
    rep = warm_phase.report
    harness.note(f"warm-up: {rep.frames_synced} sets emitted, {rep.processed_frames} stepped, "
                 f"{rep.slot_dropped} overwritten")
    record = sample_positions(run.cell.check, run.seed, window[1] - window[0])
    win = run_phase(pipe, warm_phase.state, data, *window, record, False, lead)
    setup_s = win.start - run.t_start

    steps = win.consumer.steps
    due = np.array([set_due(win, s) for s in steps])
    entry = np.array([s.entry for s in steps])
    exit_ = np.array([s.exit for s in steps])
    e2e_ms = (exit_ - due) * 1e3
    rep = win.report
    harness.note(f"window: {rep.frames_synced} sets emitted, {rep.processed_frames} stepped, "
                 f"{rep.slot_dropped} overwritten, {rep.messages_unconsumed} messages unconsumed; "
                 f"generator late p50 {np.median(win.schedule.late) * 1e3:.4f} ms, "
                 f"max {win.schedule.late.max() * 1e3:.4f} ms; window {win.end - win.start:.3f} s")
    wait_ms, step_ms = (entry - due) * 1e3, (exit_ - entry) * 1e3
    harness.note("window: wait (due -> step entry) p50 %.4f p95 %.4f ms; step p50 %.4f p95 %.4f ms"
                 % (*np.percentile(wait_ms, [50, 95]), *np.percentile(step_ms, [50, 95])))
    half = len(e2e_ms) // 2
    harness.note("window halves: e2e p50 %.4f / %.4f ms, step p50 %.4f / %.4f ms"
                 % (np.median(e2e_ms[:half]), np.median(e2e_ms[half:]),
                    np.median(step_ms[:half]), np.median(step_ms[half:])))
    e2e = {
        "setup_s": setup_s,
        "live_e2e_ms_p50": float(np.percentile(e2e_ms, 50)),
        "live_e2e_ms_p95": float(np.percentile(e2e_ms, 95)),
    }
    layer = {
        "mode": "live",
        "wait_ms": wait_ms,
        "step_ms": step_ms,
    }
    if run.trace:
        layer["graph_kernels"] = harness.graph_kernel_nodes(pipe._step)
        with trace_lib.Profiler() as prof:
            tr = run_phase(pipe, win.state, data, *traced, set(), True, lead)
        layer["trace"] = prof.result(replays=len(tr.consumer.steps),
                                     per_replay=harness.launches_per_replay(run, "live"))
    run.read_memory()
    checked = judge.LiveCase(run, data, warm_phase, win)
    del pipe, warm_phase, win
    return harness.Outcome(rep.frames_synced, rep.frames_synced - rep.processed_frames,
                           e2e, layer, checked)


def control(case, device, arith: str):
    """The live case with the control in the program's place: the plain
    reference at `arith` (lib/precision.py) on the card, its own chain from
    the initial state over the start, and each sampled step from the
    program's state before it."""
    from portbench.lib import judge
    from portbench.reference import pipeline as ref_pipeline
    from portbench.reference.types import TrackerState

    rig, cfg = precision.on(case.rig, device, arith), case.cfg
    t = cfg.tracker
    with precision.arithmetic(arith):
        state = precision.on(TrackerState.initial(t.max_tracks, t.n_mov_avg, t.avg_delay,
                                                  dtype=torch.float32, device=device),
                             device, arith)
        start = []
        for handles, _, _ in case.start:
            frame = precision.on(judge.ref_frame(case.warm[0], handles, case.max_dets), device,
                                 arith)
            state, out = ref_pipeline.step(state, frame, rig, cfg)
            start.append((handles, judge.host(out), judge.host(state)))
        samples = []
        for handles, before, _, _ in case.samples:
            frame = precision.on(judge.ref_frame(case.win[0], handles, case.max_dets), device,
                                 arith)
            after, out = ref_pipeline.step(precision.on(TrackerState(*before), device, arith),
                                           frame, rig, cfg)
            samples.append((handles, before, judge.host(out), judge.host(after)))
    case.start, case.samples = start, samples
    return case
