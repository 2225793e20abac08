"""Per-stage offline profiler.

The reference self-measures with per-node wall-time accumulators dumped at
shutdown (skeleton_3d_triang_mult_node.cpp:39-41,1234-1241 — reproduced by
`timing.TimingBuckets`). This module is the development-facing complement:
it times each OFFLINE pipeline stage in isolation on the pipeline's device
— fusion (association + triangulation), cold-start LM smoothing, the
sequential tracker, reprojection feedback — plus the whole `run_offline`,
dispatching all repetitions and synchronizing once, so work queued on the
card is counted and the host's dispatch of one call overlaps the device's
work of the previous one where the stage allows it.

The stage bodies are `Pipeline.run_offline`'s own calls (`fuse_offline`,
`smooth_offline`, `ops.tracker.tracker_scan` — kernel K3 on CUDA — and the
reprojection of `offline_outputs`); `full` is the real `run_offline`, so
`full` against the stage sum shows what is paid between the stages. On
CUDA each stage is a CUDA graph (graphs.CapturedFunction), captured by its
warm-up call, as `run_offline` is one and as the JAX package jits each
stage; on the CPU every stage runs eagerly.

CLI:
    python -m smartedgesensor3dhumanpose_tpu_torch.profiling            # 16-cam demo
    python -m smartedgesensor3dhumanpose_tpu_torch.profiling --big      # 64-cam hall
    python -m smartedgesensor3dhumanpose_tpu_torch.profiling --json
"""

from __future__ import annotations

import time
from typing import Dict

import torch

from smartedgesensor3dhumanpose_tpu_torch import graphs, reprojection
from smartedgesensor3dhumanpose_tpu_torch import pipeline as pl
from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu_torch.ops import tracker
from smartedgesensor3dhumanpose_tpu_torch.types import Frame


def _timeit(fn, *args, reps: int, device: torch.device) -> float:
    """Seconds per call: warm once, then dispatch `reps` calls and wait for
    all of them once."""
    fn(*args)
    pl.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(*args)
    pl.synchronize(device)
    return (time.perf_counter() - t0) / reps


def profile_stages(
    pipe: pl.Pipeline, frames: Frame, reps: int = 5
) -> Dict[str, float]:
    """Time each offline stage of `pipe` on `frames` (on the pipeline's
    device; on CUDA each stage replays a CUDA graph).

    Returns {stage: milliseconds per frame}; stages are `fuse`,
    `smooth_cold`, `tracker`, `reproj`, and `full` (= run_offline).
    """
    config = pipe.config
    rig = pipe.rig
    batch = pipe.fusion_batch
    device = pipe.device
    num_frames = int(frames.cam_stamp.shape[0])

    def stage_fuse(fr):
        return pl.fuse_offline(fr, rig, config, batch)

    def stage_smooth(p):
        return pl.smooth_offline(p, config, batch)

    def stage_track(s, p, pv, fb, pr):
        return tracker.tracker_scan(s, p, pv, fb, pr, config.prior, config.tracker)

    def stage_reproj(fused_pred, pred_dt, ts):
        return reprojection.reproject(
            fused_pred, rig, config.prior.pose_method, pred_dt,
            ut_kappa=config.fusion.ut_kappa, ts_per_cam=ts,
        )

    if device.type == "cuda":
        stage_fuse, stage_smooth, stage_track, stage_reproj = (
            graphs.CapturedFunction(fn, f"profile_stages.{fn.__name__}")
            for fn in (stage_fuse, stage_smooth, stage_track, stage_reproj)
        )

    state = pipe.init_state()
    per_frame_s = {}

    persons, pivots, _ = stage_fuse(frames)
    per_frame_s["fuse"] = _timeit(stage_fuse, frames, reps=reps, device=device)

    pre = stage_smooth(persons)
    per_frame_s["smooth_cold"] = _timeit(stage_smooth, persons, reps=reps, device=device)

    pivots = pivots.to(persons.xyz.dtype)
    _, track_outs = stage_track(state, persons, pivots, frames.fb_delay, pre)
    per_frame_s["tracker"] = _timeit(
        stage_track, state, persons, pivots, frames.fb_delay, pre,
        reps=reps, device=device,
    )

    per_frame_s["reproj"] = _timeit(
        stage_reproj, track_outs.fused_pred, track_outs.pred_delta_t, frames.cam_stamp,
        reps=reps, device=device,
    )

    per_frame_s["full"] = _timeit(
        pipe.run_offline, pipe.init_state(), frames, reps=reps, device=device
    )

    return {k: v / num_frames * 1e3 for k, v in per_frame_s.items()}


def _demo_inputs(big: bool, batch: int | None, num_frames: int | None, device):
    from smartedgesensor3dhumanpose_tpu_torch import cameras
    from smartedgesensor3dhumanpose_tpu_torch.config import (
        FusionConfig,
        TrackerConfig,
    )
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic

    if big:
        f = num_frames or 128
        cams, people = 64, 25
        config = PipelineConfig.scaled_64cam()
        batch = batch or 4
    else:
        f = num_frames or 256
        cams, people = 16, 6
        config = PipelineConfig(
            fusion=FusionConfig(
                num_cameras=16,
                max_dets_per_cam=6,
                max_hypotheses=12,
                max_epipolar_error=0.045,
            ),
            tracker=TrackerConfig(max_tracks=12),
        )
        batch = batch or 128
    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=cams, num_people=people, num_frames=f, seed=1
        )
    )
    data = synthetic.frames_from_scene(scene)
    frames = Frame.from_arrays(data, device)
    rig = cameras.hall_rig(cams, device=device)
    return pl.Pipeline(rig, config, device=device, fusion_batch=batch), frames


def main(argv=None) -> None:
    import argparse
    import json

    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--big", action="store_true",
                   help="64-camera x 25-person scaled hall")
    p.add_argument("--batch", type=int, default=None,
                   help="fusion chunk size (defaults per config)")
    p.add_argument("--frames", type=int, default=None)
    p.add_argument("--reps", type=int, default=5)
    p.add_argument("--json", action="store_true", help="one JSON line")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda unless asked otherwise)")
    args = p.parse_args(argv)

    pipe, frames = _demo_inputs(args.big, args.batch, args.frames, args.device)
    stages = profile_stages(pipe, frames, reps=args.reps)
    if args.json:
        print(json.dumps(
            {"config": "64x25" if args.big else "16x6", "device": str(pipe.device),
             "unit": "ms/frame", **{k: round(v, 4) for k, v in stages.items()}}
        ))
    else:
        for k, v in stages.items():
            print(f"{k:>12}: {v:8.4f} ms/frame")
        fps = 1e3 / stages["full"]
        print(f"{'throughput':>12}: {fps:8.1f} frames/s")


if __name__ == "__main__":
    main()
