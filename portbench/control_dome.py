"""The control of `correct` for the 480-camera dome's offline cell, and
the readings its limits are set from, within one card's memory.

    python3 portbench/control_dome.py --seeds 1,2,3 [--seconds <s>] \
        [--workload panoptic480_offline_replay] [--precision tf32,bf16]

control.py puts the plain reference's whole `run_offline` call in the
program's place; at 480 cameras and the cell's fusion_batch its fusion
does not fit the card. This script reads the same numbers stage by stage.
For each seed it runs the cell as a benchmark run does (the port on the
card, a window of `--seconds`) and computes the float64 reference's parts
of the check once, as lib/judge.py's OfflineCase.check does: the fusion
of the sampled frames, the smoothing and tracking of the program's fused
persons, the feedback of the candidate's predictions. Then each control
(portbench/lib/precision.py: the plain reference in TF32 on the card, or
with every float32 value rounded to bfloat16) runs on the card the stages
the check compares: the sampled frames' fusion one frame at a time, the
smoothing and tracking of the program's fused persons (the judge
re-smooths from the candidate's own; the program's are the same input for
every candidate here) and the feedback of its own predictions. Its
numbers must fail a limit (the upper ends). One JSON line per seed on
standard output, with the seconds of each stage of the float64 reference
(`reference_s`). The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="the control of the dome's offline check")
    p.add_argument("--workload", default="panoptic480_offline_replay")
    p.add_argument("--seeds", required=True, help="comma-separated")
    p.add_argument("--seconds", type=float, default=12.0)
    p.add_argument("--precision", default="tf32,bf16",
                   help="comma-separated; empty: the program's readings only")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from portbench.lib import harness, manifest

    cell = manifest.load_cell(args.workload)
    dev = torch.device("cuda", 0)
    torch.set_num_threads(1)
    driver = manifest.driver(cell.mix["driver"])
    for seed in (int(s) for s in args.seeds.split(",")):
        run = harness.Run(cell, seed, args.seconds, False, time.perf_counter(), dev)
        case = driver.run(run).case
        precisions = [a for a in args.precision.split(",") if a]
        print(json.dumps(readings(case, seed, precisions, dev)), flush=True)
        del case, run
        torch.cuda.empty_cache()
    return 0


def readings(case, seed: int, precisions, dev) -> dict:
    """The program's numbers and each control's against the float64
    reference of the case's check, and the reference stages' seconds."""
    import torch

    from portbench.lib import judge, precision
    from portbench.reference import pipeline as ref_pipeline
    from portbench.reference import replay
    from portbench.reference.ops import tracker as ref_tracker
    from portbench.reference.types import Frame, Persons3D, TrackerState

    f64 = judge.F64
    frames = replay.frame(case.frames)
    idx = [int(i) for i in case.sample]
    secs = {}
    t0 = time.perf_counter()
    sub = Frame(*(x[idx] for x in frames))
    ref_raw, _, ref_drop = ref_pipeline.fuse_offline(sub, case.rig, case.cfg, len(idx))
    secs["fusion"] = time.perf_counter() - t0
    raw = case.out.persons_raw
    _, pivots = ref_pipeline.mask_stale_cameras(frames, case.cfg.fusion.max_sync_diff)
    t0 = time.perf_counter()
    pre = ref_pipeline.smooth_offline(raw, case.cfg, case.fusion_batch)
    secs["smoothing"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref_state, track = ref_tracker.tracker_scan(
        judge.ref_state0(case.cfg), raw, pivots.to(f64), frames.fb_delay, pre, case.cfg.prior,
        case.cfg.tracker)
    secs["tracker"] = time.perf_counter() - t0

    def numbers(raw_s, drop_s, fused, pred, pred_dt, spawns, feedback, state):
        tally = judge.Tally(tuple(n for n in judge.NUMBERS if n != "sync_sets_wrong"))
        tally.fused(raw_s, ref_raw, drop_s, ref_drop)
        tally.persons(fused, track.fused, "fused_mm")
        tally.persons(pred, track.fused_pred, "pred_mm")
        tally.count("decisions_wrong", spawns, track.n_dropped_spawns, field="dropped spawns")
        t0 = time.perf_counter()
        ref_fb = ref_pipeline.offline_feedback(pred, pred_dt, frames.cam_stamp, case.rig,
                                               case.cfg)
        secs.setdefault("feedback", time.perf_counter() - t0)
        tally.feedback(feedback, ref_fb, judge.gate_margin(pred, case.rig, case.cfg),
                       case.gate_px)
        tally.state(state, ref_state)
        return dict(tally.v, **tally.medians())

    prog = case.out
    line = {"workload": "panoptic480_offline_replay", "seed": seed, "sampled_frames": idx}
    line["program"] = numbers(Persons3D(*(x[idx] for x in raw)), prog.n_dropped_hypotheses[idx],
                              prog.fused, prog.fused_pred, prog.pred_delta_t,
                              prog.n_dropped_track_spawns, prog.feedback,
                              TrackerState(*case.state))
    line["reference_s"] = dict(secs)
    for arith in precisions:
        t1 = time.perf_counter()
        with precision.arithmetic(arith):
            rig_c = precision.on(case.rig, dev, arith)
            sub_c = precision.on(replay.frame(
                {k: v[idx] for k, v in case.frames.items() if k != "det_count"},
                torch.float32, dev), dev, arith)
            raw_c, _, drop_c = ref_pipeline.fuse_offline(sub_c, rig_c, case.cfg, 1)
            raw_all = precision.on(raw, dev, arith)
            pre_c = ref_pipeline.smooth_offline(raw_all, case.cfg, case.fusion_batch)
            state_c, track_c = ref_tracker.tracker_scan(
                precision.on(judge.ref_state0(case.cfg), dev, arith), raw_all,
                precision.on(pivots.to(f64), dev, arith),
                precision.on(frames.fb_delay, dev, arith), pre_c, case.cfg.prior,
                case.cfg.tracker)
            fb_c = ref_pipeline.offline_feedback(
                track_c.fused_pred, track_c.pred_delta_t,
                precision.on(frames.cam_stamp, dev, arith), rig_c, case.cfg)
        h = judge.host
        line[f"control.{arith}"] = numbers(
            h(raw_c), h(drop_c), h(track_c.fused), h(track_c.fused_pred),
            h(track_c.pred_delta_t), h(track_c.n_dropped_spawns), h(fb_c), h(state_c))
        line[f"control.{arith}_s"] = time.perf_counter() - t1
    return line


if __name__ == "__main__":
    sys.exit(main())
