"""Per-stage offline profiler.

The reference self-measures with per-node wall-time accumulators dumped at
shutdown (skeleton_3d_triang_mult_node.cpp:39-41,1234-1241 — reproduced by
`timing.TimingBuckets`). This module is the development-facing complement:
it splits the real `Pipeline.run_offline` into its stages — fusion
(association + triangulation), cold-start LM smoothing, the sequential
tracker (kernel K3 on CUDA), the reprojection feedback with the outputs'
boxes — and times the whole call too.

The stages are read from the tracer (tracing.py): a traced twin of the
pipeline (same rig, config and fusion batch, `trace=True`) replays the
real `run_offline` graph on CUDA (eagerly on the CPU), and its stage marks
give each stage's span on the device clock (the host clock on the CPU).
`full` times the pipeline's own untraced `run_offline`, dispatching all
repetitions and synchronizing once, so `full` against the stage sum shows
what the calls pay outside their stages.

CLI:
    python -m smartedgesensor3dhumanpose_tpu_torch.profiling            # 16-cam demo
    python -m smartedgesensor3dhumanpose_tpu_torch.profiling --big      # 64-cam hall
    python -m smartedgesensor3dhumanpose_tpu_torch.profiling --json
"""

from __future__ import annotations

import time
from typing import Dict

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch import pipeline as pl
from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu_torch.types import Frame

# profile_stages' keys -> the offline stage spans of tracing.py.
STAGES = {"fuse": "fusion", "smooth_cold": "smoothing", "tracker": "tracker",
          "reproj": "feedback"}


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
    device): the stage spans of `reps` calls of a traced twin's
    `run_offline` (a CUDA graph's replays on CUDA), and `full`, the
    untraced `run_offline`.

    Returns {stage: milliseconds per frame}; stages are `fuse`,
    `smooth_cold`, `tracker`, `reproj` (the feedback and the outputs'
    boxes), and `full` (= run_offline).
    """
    device = pipe.device
    num_frames = int(frames.cam_stamp.shape[0])
    twin = pl.Pipeline(pipe.rig, pipe.config, device=device, fusion_batch=pipe.fusion_batch,
                       trace=True)
    state = twin.init_state()
    twin.run_offline(state, frames)  # on CUDA: the capture
    pl.synchronize(device)
    with twin.tracer:
        for _ in range(reps):
            twin.run_offline(state, frames)
    spans = twin.tracer.drain().spans
    calls = np.flatnonzero(spans["name"] == "Pipeline.run_offline")
    inside = np.isin(spans["parent"], calls)
    per_frame_ms = {}
    for key, name in STAGES.items():
        mine = spans[inside & (spans["name"] == name)]
        per_frame_ms[key] = float(np.sum(mine["end"] - mine["start"])) / len(calls) * 1e-6
    per_frame_ms["full"] = _timeit(
        pipe.run_offline, pipe.init_state(), frames, reps=reps, device=device
    ) * 1e3
    return {k: v / num_frames for k, v in per_frame_ms.items()}


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
