"""Demo runner: the `roslaunch pose_prior pose_triangulate_demo.launch`
equivalent (README.md:40-49), on the card unless asked otherwise.

Replays the 16-camera / 6-person hall sequence (synthetic, or a recorded
JSONL via io.replay) through the full pipeline and reports the
per-detection-count timing buckets the reference prints at shutdown.

Usage:
  python -m smartedgesensor3dhumanpose_tpu_torch.demo                 # offline replay
  python -m smartedgesensor3dhumanpose_tpu_torch.demo --online        # per-frame
  python -m smartedgesensor3dhumanpose_tpu_torch.demo --jsonl f.jsonl # replay file
  python -m smartedgesensor3dhumanpose_tpu_torch.demo --viz out.png   # dashboard
  python -m smartedgesensor3dhumanpose_tpu_torch.demo --device cpu    # plain versions
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from smartedgesensor3dhumanpose_tpu_torch.pipeline import synchronize
from smartedgesensor3dhumanpose_tpu_torch.types import Frame


class DemoRun(NamedTuple):
    """What `main` ran, for a caller that checks it (`chip_smoke.py`)."""

    scene: dict
    config: object              # PipelineConfig
    pipe: object                # pipeline.Pipeline
    frames: object              # Frame with a leading time axis (the input)
    final_state: object         # TrackerState after the run
    outs: Optional[object]      # StepOutput over time (offline replay only)
    report: Optional[object]    # the online / closed-loop report
    seconds: Optional[float]    # wall time of the timed offline call or closed loop
    mpjpe_m: Optional[float]    # --eval
    pck_015: Optional[float]    # --eval, PCK@0.15 m


def build_demo(num_cameras: int, num_people: int, num_frames: int, seed: int,
               device="cuda"):
    """(scene, config, frames, pipeline) of the demo hall on `device`."""
    from smartedgesensor3dhumanpose_tpu_torch import cameras, pipeline
    from smartedgesensor3dhumanpose_tpu_torch.config import (
        FusionConfig,
        PipelineConfig,
        TrackerConfig,
    )
    from smartedgesensor3dhumanpose_tpu_torch.io import synthetic

    scene = synthetic.generate_scene(
        synthetic.SceneConfig(
            num_cameras=num_cameras,
            num_people=num_people,
            num_frames=num_frames,
            seed=seed,
        )
    )
    config = PipelineConfig(
        fusion=FusionConfig(
            num_cameras=num_cameras,
            max_dets_per_cam=num_people,
            max_hypotheses=2 * num_people,
            max_epipolar_error=0.045,
        ),
        tracker=TrackerConfig(max_tracks=2 * num_people),
    )
    data = synthetic.frames_from_scene(scene)
    frames = Frame.from_arrays(data, device)
    rig = cameras.hall_rig(num_cameras, device=device)
    return scene, config, frames, pipeline.Pipeline(rig, config, device=device)


def _frame_at(frames: Frame, i: int) -> Frame:
    return Frame(*(a[i] for a in frames))


def _last(outs):
    """The last frame of a StepOutput with a leading time axis."""
    if isinstance(outs, torch.Tensor):
        return outs[-1]
    return type(outs)(*(_last(x) for x in outs))


def main(argv=None) -> DemoRun:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--cameras", type=int, default=16)
    parser.add_argument("--people", type=int, default=6)
    parser.add_argument("--frames", type=int, default=128)
    parser.add_argument("--seed", type=int, default=42)
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on: the card unless asked "
                             "otherwise (cpu runs the kernels' plain versions)")
    parser.add_argument("--online", action="store_true",
                        help="latest-wins producer/consumer loop instead of "
                             "the offline replay")
    parser.add_argument("--feed-hz", type=float, default=30.0,
                        help="producer rate for --online (sensor frame rate)")
    parser.add_argument("--closed-loop", action="store_true",
                        help="close the semantic-feedback loop through "
                             "virtual edge sensors: fb_delay is MEASURED "
                             "from each frame's reprojection feedback "
                             "round-trip instead of the open-loop constant")
    parser.add_argument("--loop-network-latency", type=float, default=0.03,
                        help="sensor downlink latency (s) for --closed-loop")
    parser.add_argument("--loop-processing-latency", type=float, default=0.05,
                        help="capture->feedback-emission latency (s) for "
                             "--closed-loop")
    parser.add_argument("--jsonl", type=str, default=None,
                        help="replay a recorded JSONL through the native "
                             "approximate-time synchronizer")
    parser.add_argument("--record-jsonl", type=str, default=None,
                        help="record the (synthetic) scene as a JSONL "
                             "message stream (the bag-recording equivalent; "
                             "replay it with --jsonl)")
    parser.add_argument("--live", type=str, default=None,
                        help="write an animated operator dashboard of the "
                             "replay (.gif or scrubbable .html)")
    parser.add_argument("--viz", type=str, default=None,
                        help="write a dashboard PNG of the last frame")
    parser.add_argument("--save", type=str, default=None,
                        help="write fused outputs to this NPZ")
    parser.add_argument("--checkpoint", type=str, default=None,
                        help="save final tracker state here")
    parser.add_argument("--vis-cov", action="store_true",
                        help="track + report 3D sigma statistics (the "
                             "reference's vis_cov shutdown dump)")
    parser.add_argument("--eval", action="store_true",
                        help="report MPJPE / PCK vs the synthetic scene's "
                             "ground truth (offline synthetic replay only)")
    args = parser.parse_args(argv)

    from smartedgesensor3dhumanpose_tpu_torch import checkpoint, timing
    from smartedgesensor3dhumanpose_tpu_torch.convert import host

    if args.viz or args.live:
        from smartedgesensor3dhumanpose_tpu_torch import viz

        # Fail before the run, not after it, where matplotlib is missing.
        viz.require_matplotlib()

    scene, config, frames, pipe = build_demo(
        args.cameras, args.people, args.frames, args.seed, device=args.device
    )
    device = pipe.device

    if args.record_jsonl:
        from smartedgesensor3dhumanpose_tpu_torch.io import replay as replay_lib

        replay_lib.save_jsonl(args.record_jsonl, scene)
        print(f"scene recorded to {args.record_jsonl}")

    if args.jsonl and not os.path.exists(args.jsonl):
        parser.error(
            f"--jsonl: no such recording: {args.jsonl} "
            "(create one with --record-jsonl)"
        )

    if args.jsonl and not args.online:
        from smartedgesensor3dhumanpose_tpu_torch.io import replay as replay_lib

        packed = list(
            replay_lib.replay_jsonl(
                args.jsonl, args.cameras, args.people
            )
        )
        print(f"replayed {len(packed)} synchronized frames from {args.jsonl}")
        frames = Frame.from_arrays(
            {k: np.stack([f[k] for f in packed]) for k in Frame._fields}, device
        )

    n = frames.kp2d.shape[0]
    state = pipe.init_state()
    buckets = timing.TimingBuckets("Pipeline")
    report = None
    seconds = None

    if args.closed_loop:
        # Closed feedback loop: virtual edge sensors receive each frame's
        # Reprojection2D (with the echoed original stamps,
        # skeleton_reproj_mult_node.cpp:157-159,233-234), measure
        # fb_delay = arrival - orig_stamp, and feed it into the next frame:
        # the tracker's prediction horizon converges to the real loop
        # latency instead of assuming 0.1 s.
        from smartedgesensor3dhumanpose_tpu_torch.io import sensors as sensors_lib

        sensors = sensors_lib.VirtualSensorArray(
            args.cameras, network_latency=args.loop_network_latency
        )
        # Warm up (kernel build, device tables, and on CUDA the step's graph
        # capture) with a throwaway state, before the clock starts.
        pipe.step(pipe.init_state(), _frame_at(frames, 0))
        synchronize(device)
        t0 = time.perf_counter()
        final_state, last, report = sensors_lib.run_closed_loop(
            pipe.step,
            state,
            frames,
            sensors,
            processing_latency=args.loop_processing_latency,
        )
        synchronize(device)
        dt = seconds = time.perf_counter() - t0
        loop_latency = args.loop_processing_latency + args.loop_network_latency
        for _ in range(n):
            buckets.add(dt / n, 0)
        print(
            f"closed loop: {n} frames, {report.n_feedback_received} feedback "
            f"deliveries; injected loop latency "
            f"{loop_latency * 1e3:.0f} ms -> pred_delta_t converged to "
            f"{report.pred_delta_t[-1] * 1e3:.1f} ms "
            f"(start {report.pred_delta_t[0] * 1e3:.1f} ms)"
        )
        outs = None
    elif args.online and args.jsonl:
        # FULL live topology in one process (reference
        # skeleton_3d_triang_mult_node.cpp:999-1025,1216-1224): raw
        # per-camera JSONL messages -> native ApproximateTimeSync ->
        # latest-wins slot -> pipeline step, with sync-stage and slot-stage
        # drop accounting.
        from smartedgesensor3dhumanpose_tpu_torch import online
        from smartedgesensor3dhumanpose_tpu_torch.io import replay as replay_lib

        pipe.step(pipe.init_state(), _frame_at(frames, 0))
        synchronize(device)

        final_state, last, report = online.run_online_synced(
            pipe.step,
            state,
            list(replay_lib.load_jsonl_messages(args.jsonl)),
            num_cameras=args.cameras,
            max_dets=args.people,
            message_interval_s=1.0 / (args.feed_hz * args.cameras),
            frame_builder=lambda fd: online.default_frame_builder(fd, device),
        )
        for ms in report.step_ms:
            buckets.add(ms / 1e3, 0)
        print(
            f"online+sync: {report.produced_messages} messages -> "
            f"{report.frames_synced} synchronized frames "
            f"({report.messages_unconsumed} messages unconsumed at sync), "
            f"{report.processed_frames} stepped, {report.slot_dropped} "
            f"dropped at the slot (latest-wins); p50 step "
            f"{report.step_ms_p50:.2f} ms, p50 sync-input->output "
            f"{report.e2e_ms_p50:.2f} ms"
        )
        outs = None
    elif args.online:
        # Latest-wins producer/consumer loop (reference worker handoff,
        # skeleton_3d_triang_mult_node.cpp:999-1025): a producer thread
        # feeds synchronized frames at --feed-hz into the native LatestSlot;
        # the consumer drains the newest and steps the pipeline. Backlogged
        # frames are dropped, keeping output fresh under compute overload.
        from smartedgesensor3dhumanpose_tpu_torch import online

        pipe.step(pipe.init_state(), _frame_at(frames, 0))
        synchronize(device)

        final_state, last, report = online.run_online(
            pipe.step,
            state,
            frames,
            feed_interval_s=1.0 / args.feed_hz,
        )
        for ms in report.step_ms:
            buckets.add(ms / 1e3, 0)
        print(
            f"online: {len(report.processed_handles)}/{report.produced} "
            f"frames processed, {report.dropped} dropped (latest-wins), "
            f"p50 step {report.step_ms_p50:.2f} ms"
        )
        outs = None
    else:
        t0 = time.perf_counter()
        final_state, outs = pipe.run_offline(state, frames)
        synchronize(device)
        compile_and_run = time.perf_counter() - t0
        t0 = time.perf_counter()
        final_state, outs = pipe.run_offline(state, frames)
        synchronize(device)
        dt = seconds = time.perf_counter() - t0
        print(f"compile+first-run: {compile_and_run:.1f}s")
        print(f"offline replay: {n} frames in {dt*1e3:.1f} ms "
              f"-> {n / dt:.0f} fused frames/s")
        n_dets = host(outs.fused.valid.sum(dim=-1))
        for t in range(n):
            buckets.add(dt / n, int(n_dets[t]))
        last = _last(outs)

    print(buckets.report())
    if args.vis_cov and outs is not None:
        from smartedgesensor3dhumanpose_tpu_torch import viz

        stats = viz.SigmaStats()
        cov, score = host(outs.fused.cov), host(outs.fused.score)
        for t in range(n):
            stats.update(cov[t], score[t])
        print(stats.report())
    valid = host(last.fused.valid)
    ids = host(last.fused.person_id)[valid]
    print(f"last frame: {valid.sum()} fused persons published, ids={sorted(ids.tolist())}")

    # Ground truth exists only for the synthetic scene (a JSONL replay may
    # come from anywhere; the reference evaluates GT out-of-repo too).
    have_gt = not args.jsonl
    mpjpe_m = pck_015 = None
    if args.eval:
        if outs is None or not have_gt:
            print("--eval requires the offline synthetic replay (no GT here)")
        else:
            from smartedgesensor3dhumanpose_tpu_torch import metrics, skeleton

            # GT joints are in the configured input model's layout: derive
            # the 17->21 selection from the pipeline config.
            model = skeleton.input_model(config.fusion.pose_method)
            errs = metrics.sequence_joint_errors(
                outs.fused.xyz,
                outs.fused.score,
                outs.fused.valid,
                scene["gt_xyz"],
                to_fusion=np.asarray(model.to_fusion),
                start=n // 4,  # skip the tracker publish-gate warm-up
            )
            mpjpe_m, pck_015 = metrics.mpjpe(errs), metrics.pck(errs, 0.15)
            print(
                f"eval vs GT (frames {n // 4}-{n - 1}): "
                f"MPJPE {mpjpe_m * 1e3:.1f} mm, "
                f"PCK@0.15m {pck_015 * 100:.1f}%, "
                f"PCK@0.05m {metrics.pck(errs, 0.05) * 100:.1f}% "
                f"({errs.size} matched joints)"
            )

    if args.viz:
        viz.render_frame_summary(
            last,
            pipe.rig,
            args.viz,
            input_frame=_frame_at(frames, -1) if outs is not None else None,
            # GT layer only when the rendered output IS the last synthetic
            # frame (online modes publish whichever frame survived the
            # latest-wins slot).
            gt_xyz=(
                scene["gt_xyz"][n - 1] if have_gt and outs is not None
                else None
            ),
            pose_method=config.fusion.pose_method,
        )
        print(f"dashboard written to {args.viz}")
    if args.live and outs is not None:
        viz.render_live_dashboard(
            outs, pipe.rig, args.live, input_frames=frames
        )
        print(f"live dashboard written to {args.live}")
    elif args.live:
        print(
            "--live requires the offline replay outputs; it is not "
            "available with --online (no dashboard written)"
        )
    if args.save and outs is not None:
        np.savez_compressed(
            args.save,
            fused_xyz=host(outs.fused.xyz),
            fused_score=host(outs.fused.score),
            fused_valid=host(outs.fused.valid),
            person_id=host(outs.fused.person_id),
        )
        print(f"outputs written to {args.save}")
    if args.checkpoint:
        checkpoint.save_tracker_state(args.checkpoint, final_state)
        print(f"tracker state written to {args.checkpoint}")
    return DemoRun(scene, config, pipe, frames, final_state, outs, report,
                   seconds, mpjpe_m, pck_015)


if __name__ == "__main__":
    main()
