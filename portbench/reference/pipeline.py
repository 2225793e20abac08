"""The pipeline's two entry points, eagerly: `step` (one frame) and
`run_offline` (a stacked sequence). A frozen copy of the port's
`pipeline.py` without the CUDA-graph `Pipeline` class and its routes: the
same stages in the same order, on the plain versions of every kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from portbench.reference import fusion, reprojection, tracking
from portbench.reference.config import PipelineConfig
from portbench.reference.ops import tracker
from portbench.reference.types import (
    CameraRig,
    Frame,
    Persons3D,
    Reprojection2D,
    TrackerState,
    person_bbox3d,
)


class StepOutput(NamedTuple):
    persons_raw: Persons3D     # persons_3d (triangulation output)
    fused: Persons3D           # persons3d_fused
    fused_pred: Persons3D      # persons3d_fused_pred
    feedback: Reprojection2D   # cam_*/skel_pred
    pred_delta_t: torch.Tensor  # predicted feedback latency
    pivot_stamp: torch.Tensor   # frame timestamp (newest camera)
    ts_per_cam: torch.Tensor            # [C] original per-camera stamps
    fb_delay_per_cam_raw: torch.Tensor  # [C] measured (persons_3d)
    fb_delay_per_cam: torch.Tensor      # [C] predicted (persons3d_fused*)
    bbox3d_center: torch.Tensor         # [P, 3]
    bbox3d_size: torch.Tensor           # [P, 3]
    n_dropped_hypotheses: torch.Tensor   # [] int32
    n_dropped_track_spawns: torch.Tensor  # [] int32


def mask_stale_cameras(frame: Frame, max_sync_diff: float):
    """Drop cameras lagging the pivot (newest) stamp (:1029-1057). Leading
    axes (frames) pass through; returns (frame, pivot [...])."""
    pivot = frame.cam_stamp.amax(dim=-1)
    fresh = (pivot[..., None] - frame.cam_stamp) <= max_sync_diff
    return frame._replace(det_valid=frame.det_valid & fresh[..., None]), pivot


def step(state: TrackerState, frame: Frame, rig: CameraRig,
         config: PipelineConfig):
    """One full pipeline frame; returns (new state, StepOutput) and leaves
    `state` untouched."""
    frame, pivot = mask_stale_cameras(frame, config.fusion.max_sync_diff)
    persons_raw, n_dropped_hyp = fusion.fuse_frame(
        frame, rig, config.fusion, with_stats=True
    )
    state, track_out = tracking.step(
        state,
        persons_raw,
        pivot.to(persons_raw.xyz.dtype),
        frame.fb_delay,
        config.prior,
        config.tracker,
    )
    feedback = reprojection.reproject(
        track_out.fused_pred,
        rig,
        config.prior.pose_method,
        track_out.pred_delta_t,
        ut_kappa=config.fusion.ut_kappa,
        ts_per_cam=frame.cam_stamp,
    )
    c = frame.cam_stamp.shape[0]
    bbox_c, bbox_s = person_bbox3d(
        track_out.fused.xyz, track_out.fused.score, track_out.fused.valid
    )
    return state, StepOutput(
        persons_raw=persons_raw,
        fused=track_out.fused,
        fused_pred=track_out.fused_pred,
        feedback=feedback,
        pred_delta_t=track_out.pred_delta_t,
        pivot_stamp=pivot,
        ts_per_cam=frame.cam_stamp,
        fb_delay_per_cam_raw=frame.fb_delay,
        fb_delay_per_cam=track_out.pred_delta_t.expand(c),
        bbox3d_center=bbox_c,
        bbox3d_size=bbox_s,
        n_dropped_hypotheses=n_dropped_hyp,
        n_dropped_track_spawns=track_out.n_dropped_spawns,
    )


def _chunks(n: int, size: int):
    return [(lo, min(lo + size, n)) for lo in range(0, n, size)]


def _cat(parts):
    """Concatenate per-chunk results (tensors, tuples, NamedTuples) along
    the frame axis; a 0-d tensor (PriorResult's iteration count) keeps its
    largest."""
    first = parts[0]
    if isinstance(first, torch.Tensor):
        return torch.stack(parts).amax() if first.dim() == 0 else torch.cat(parts)
    values = [_cat(list(xs)) for xs in zip(*parts)]
    return type(first)(*values) if hasattr(first, "_fields") else tuple(values)


def fuse_offline(frames: Frame, rig: CameraRig, config: PipelineConfig,
                 fusion_batch: int):
    """Stale-camera masking and fusion of a stacked sequence, `fusion_batch`
    frames at a time (one association-fold launch per chunk). Returns
    (persons [F, H, ...], pivots [F], n_dropped_hypotheses [F])."""
    outs = []
    for lo, hi in _chunks(frames.kp2d.shape[0], fusion_batch):
        chunk, pivot = mask_stale_cameras(
            Frame(*(x[lo:hi] for x in frames)), config.fusion.max_sync_diff
        )
        persons, n_drop = fusion.fuse_frames(chunk, rig, config.fusion)
        outs.append((persons, pivot, n_drop))
    return _cat(outs)


def smooth_offline(persons: Persons3D, config: PipelineConfig, fusion_batch: int):
    """tracking.smooth_cold over a stacked sequence, `fusion_batch` frames
    at a time; returns the stacked `precomputed` tuple."""
    n = persons.xyz.shape[0]
    return _cat([
        tracking.smooth_cold(Persons3D(*(x[lo:hi] for x in persons)), config.prior)
        for lo, hi in _chunks(n, fusion_batch)
    ])


def offline_feedback(fused_pred: Persons3D, pred_delta_t, cam_stamp, rig: CameraRig,
                     config: PipelineConfig):
    """The reprojection feedback of a tracked sequence: the tracker scan's
    predictions, horizons and the frames' camera stamps, each with a
    leading time axis."""
    return reprojection.reproject(
        fused_pred, rig, config.prior.pose_method, pred_delta_t,
        ut_kappa=config.fusion.ut_kappa, ts_per_cam=cam_stamp,
    )


def offline_outputs(frames: Frame, persons, pivots, n_dropped_hyp, track,
                    rig: CameraRig, config: PipelineConfig, feedback=None) -> StepOutput:
    """Reprojection and bounding boxes of a tracked sequence: the
    StepOutput (leading time axis) of `run_offline` from the fusion's
    outputs and the tracker scan's stacked TrackStepOutput. `feedback`, if
    given, is `offline_feedback` computed elsewhere (the sharded replay
    splits it over the mesh)."""
    if feedback is None:
        feedback = offline_feedback(track.fused_pred, track.pred_delta_t,
                                    frames.cam_stamp, rig, config)
    bbox_c, bbox_s = person_bbox3d(track.fused.xyz, track.fused.score, track.fused.valid)
    return StepOutput(
        persons_raw=persons,
        fused=track.fused,
        fused_pred=track.fused_pred,
        feedback=feedback,
        pred_delta_t=track.pred_delta_t,
        pivot_stamp=pivots,
        ts_per_cam=frames.cam_stamp,
        fb_delay_per_cam_raw=frames.fb_delay,
        fb_delay_per_cam=track.pred_delta_t[:, None].expand(frames.cam_stamp.shape),
        bbox3d_center=bbox_c,
        bbox3d_size=bbox_s,
        n_dropped_hypotheses=n_dropped_hyp,
        n_dropped_track_spawns=track.n_dropped_spawns,
    )


def run_offline(state: TrackerState, frames: Frame, rig: CameraRig,
                config: PipelineConfig, fusion_batch: int):
    """The offline replay, eagerly (what `Pipeline.run_offline` captures):
    chunked fusion, chunked cold-start smoothing, one tracker scan,
    reprojection. Returns (final state, StepOutput with a leading time
    axis) and leaves `state` untouched."""
    persons, pivots, n_drop = fuse_offline(frames, rig, config, fusion_batch)
    pre = smooth_offline(persons, config, fusion_batch)
    state, track = tracker.tracker_scan(
        state, persons, pivots.to(persons.xyz.dtype), frames.fb_delay, pre,
        config.prior, config.tracker,
    )
    return state, offline_outputs(frames, persons, pivots, n_drop, track, rig, config)
