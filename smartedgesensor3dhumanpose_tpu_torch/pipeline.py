"""The closed-loop pipeline: online, one frame at a time, and offline
over a whole recorded sequence.

    step(tracker_state, frame) -> (tracker_state, StepOutput)

runs, in order: camera staleness masking (reference
skeleton_3d_triang_mult_node.cpp:1049-1057), fusion (association fold +
triangulation), prior smoothing + tracking + prediction, and per-camera
reprojection feedback — the reference's three-node ROS graph
(pose_triangulate_demo.launch:11-29) as one function.

`Pipeline.run_offline` (the bag-replay mode) computes the same outputs for
a stacked sequence with the frame-independent stages batched: fusion in
chunks of `fusion_batch` frames (one association-fold launch per chunk),
the LM smoothing cold-started and batched per chunk (tracking.smooth_cold),
then the sequential tracker as one kernel launch (ops.tracker), then
reprojection over all frames.

Both are functional: they return a new TrackerState and never write into
the one passed in, so a caller may keep or reuse any earlier state. (The
JAX package donates the state buffers on the TPU instead, and forbids
reuse.)

On CUDA the entry points of `Pipeline` replay CUDA graphs, as the JAX
package jits them (graphs.py): `Pipeline.step` a graph of `step`,
`Pipeline.run_per_frame_chain` that graph once per frame with the state
kept on the device (JAX's `lax.scan` of `step`), and `Pipeline.run_offline`
a graph of the whole replay per sequence shape. The module-level `step`
and `run_offline` stay eager, as JAX's raw `step` is unjitted. On the CPU
every entry point runs eagerly.

`Pipeline(..., trace=True)` marks the stages of both entry points on the
device clock (tracing.py): `step` as `fusion`, `tracking` (with `prior`,
the LM and its set-up, inside it) and `feedback`; `run_offline` as
`fusion`, `smoothing`, `tracker` and `feedback`. A pipeline built without
it captures no mark: its graphs are the graphs of the untraced functions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from smartedgesensor3dhumanpose_tpu_torch import (
    fusion,
    graphs,
    reprojection,
    skeleton,
    tracing,
    tracking,
)
from smartedgesensor3dhumanpose_tpu_torch.config import PipelineConfig
from smartedgesensor3dhumanpose_tpu_torch.ops import hungarian, linalg, tracker
from smartedgesensor3dhumanpose_tpu_torch.types import (
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


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on `device` (nothing to wait for on the
    CPU); a host clock stopped after it counts the device's work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
    tracing.stage("fusion")
    frame, pivot = mask_stale_cameras(frame, config.fusion.max_sync_diff)
    persons_raw, n_dropped_hyp = fusion.fuse_frame(
        frame, rig, config.fusion, with_stats=True
    )
    tracing.stage("tracking")
    state, track_out = tracking.step(
        state,
        persons_raw,
        pivot.to(persons_raw.xyz.dtype),
        frame.fb_delay,
        config.prior,
        config.tracker,
    )
    tracing.stage("feedback")
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
    frames at a time (one association launch and one triangulation launch
    per chunk, `fusion.fuse_chunks`, which a traced call marks as
    `fusion.associate` and `fusion.triangulate`). Returns (persons
    [F, H, ...], pivots [F], n_dropped_hypotheses [F])."""
    chunks, pivots = [], []
    for lo, hi in _chunks(frames.kp2d.shape[0], fusion_batch):
        chunk, pivot = mask_stale_cameras(
            Frame(*(x[lo:hi] for x in frames)), config.fusion.max_sync_diff
        )
        chunks.append(chunk)
        pivots.append(pivot)
    fused = fusion.fuse_chunks(chunks, rig, config.fusion, stage=tracing.child)
    return _cat([(persons, pivot, n_drop) for (persons, n_drop), pivot in zip(fused, pivots)])


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
    tracing.stage("fusion")
    persons, pivots, n_drop = fuse_offline(frames, rig, config, fusion_batch)
    tracing.stage("smoothing")
    pre = smooth_offline(persons, config, fusion_batch)
    tracing.stage("tracker")
    state, track = tracker.tracker_scan(
        state, persons, pivots.to(persons.xyz.dtype), frames.fb_delay, pre,
        config.prior, config.tracker,
    )
    tracing.stage("feedback")
    return state, offline_outputs(frames, persons, pivots, n_drop, track, rig, config)


class Routes(NamedTuple):
    """How a Pipeline runs its solvers, decided from the config, the shapes
    and the device only (never from a failure)."""

    association: str  # fusion.association_route: "fold", "scan" or "reference"
    tracker: str      # offline: "kernel" (K3), "steps" (per frame, K1) or
                      # "plain" (the CPU's plain version)


def routes(config: PipelineConfig, device: torch.device) -> Routes:
    """The solvers' routes of a Pipeline (see `Routes`); raises where the
    config names a route its shapes cannot take: "pallas_scan" outside K2's
    domain, or, on CUDA, an assignment wider than kernel K1 takes
    (hungarian.MAX_N_WIDE; the JAX package's XLA JV has no such limit)."""
    f, t = config.fusion, config.tracker
    association = fusion.association_route(f, f.num_cameras, f.max_dets_per_cam)
    if device.type != "cuda":
        return Routes(association, "plain")
    # Kernel K1's problems: the track assignment [H, T] and, on the scan,
    # each camera's [H, D].
    width = max(f.max_hypotheses, t.max_tracks)
    if association == "scan":
        width = max(width, f.max_dets_per_cam)
    if width > hungarian.MAX_N_WIDE:
        raise ValueError(
            f"the assignment kernel solves up to {hungarian.MAX_N_WIDE} rows/cols; "
            f"this config needs {width} (max_hypotheses={f.max_hypotheses}, "
            f"max_tracks={t.max_tracks}, max_dets_per_cam={f.max_dets_per_cam})"
        )
    takes = tracker.kernel_takes(f.max_hypotheses, t.max_tracks, skeleton.NUM_FUSION_JOINTS)
    return Routes(association, "kernel" if takes else "steps")


class Pipeline:
    """The rig and config with the online and offline entry points.

    `device` places every tensor the pipeline creates; the rig and the
    frames must already live there. It is the card unless the caller asks
    for the CPU. On CUDA the solvers run as kernels K1/K2/K3 and the hot path
    is float32; matrix products are pinned to IEEE fp32 (no TF32). Each
    route is a pure function of the config, the shapes, the device and the
    dtype, and each stage evaluates its own on every call
    (`fusion.pair_costs_route`, `fusion.association_route`,
    `fusion.triangulation_route`, `tracker.tracker_scan`,
    `lm_prior.takes`). `routes` evaluates the association's and the
    tracker's here, to refuse a config whose shapes no route takes. On CUDA
    `step`, `run_per_frame_chain` and `run_offline` replay CUDA graphs,
    captured at the first call of each input shape (graphs.py), which
    read the rig by address: the rig and config are fixed at construction.
    Each entry point keeps the graphs, and their memory, of its four most
    recently used input shapes (PERF.md lists the sizes).
    `fusion_batch` is the chunk size of the offline fusion and smoothing.
    `trace=True` marks each call's stages (module docstring) into rings that
    `self.tracer` (a tracing.Tracer on the pipeline's device) reads when it
    is drained; its captures record their loops there too.
    """

    def __init__(self, rig: CameraRig, config: PipelineConfig, device="cuda",
                 fusion_batch: int = 64, trace: bool = False):
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if self.device.index is None:
                self.device = torch.device("cuda", torch.cuda.current_device())
            linalg.require_ieee_fp32()
        if rig.P.device != self.device:
            raise ValueError(f"rig is on {rig.P.device}, pipeline on {self.device}")
        if fusion_batch < 1:
            raise ValueError(f"fusion_batch must be >= 1, got {fusion_batch}")
        self.routes = routes(config, self.device)
        self.rig = rig
        self.config = config
        self.fusion_batch = fusion_batch
        self.tracer = self._step_marks = self._offline_marks = None
        if trace:
            self.tracer = tracing.Tracer(self.device)
            self._step_marks = tracing.StageMarks("Pipeline.step", self.device, self.tracer)
            self._offline_marks = tracing.StageMarks("Pipeline.run_offline", self.device,
                                                     self.tracer)
        self._step = self._step_eager
        self._offline = self._offline_eager
        if self.device.type == "cuda":
            self._step = graphs.CapturedFunction(self._step_eager, "Pipeline.step",
                                                 self._step_marks)
            self._offline = graphs.CapturedFunction(self._offline_eager, "Pipeline.run_offline",
                                                    self._offline_marks)

    def init_state(self, dtype=torch.float32) -> TrackerState:
        t = self.config.tracker
        return TrackerState.initial(
            t.max_tracks, t.n_mov_avg, t.avg_delay, dtype=dtype, device=self.device
        )

    def _step_eager(self, state: TrackerState, frame: Frame):
        if self._step_marks is None:
            return step(state, frame, self.rig, self.config)
        with self._step_marks.call():
            return step(state, frame, self.rig, self.config)

    def step(self, state: TrackerState, frame: Frame):
        """The online path: one frame in, (new state, StepOutput) out; on
        CUDA a replay of the captured step."""
        return self._step(state, frame)

    def run_per_frame_chain(self, state: TrackerState, frames: Frame):
        """`step` over a stacked sequence (leading time axis on every Frame
        field); returns (final state, StepOutput with a leading time axis),
        as JAX's `lax.scan` of `step`. On CUDA the step's graph is replayed
        once per frame with the state threaded on the device, no host sync
        between frames."""
        n = frames.kp2d.shape[0]
        if n == 0:
            raise ValueError("run_per_frame_chain needs at least one frame")
        outs = []
        for i in range(n):
            state, out = self.step(state, Frame(*(f[i] for f in frames)))
            outs.append(out)
        return state, tracker.stack_frames(outs)

    def _offline_eager(self, state: TrackerState, frames: Frame):
        if self._offline_marks is None:
            return run_offline(state, frames, self.rig, self.config, self.fusion_batch)
        with self._offline_marks.call():
            return run_offline(state, frames, self.rig, self.config, self.fusion_batch)

    def run_offline(self, state: TrackerState, frames: Frame):
        """The offline replay of a stacked sequence (leading time axis on
        every Frame field): chunked fusion, chunked cold-start smoothing,
        one tracker scan, reprojection. Returns (final state, StepOutput
        with a leading time axis); `state` is left as it was. On CUDA a
        replay of the whole call's graph, captured once per sequence
        shape."""
        return self._offline(state, frames)
